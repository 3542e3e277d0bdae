"""Drive the PyTorch/CUDA port (tvc_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):
  1. card: name and power limit (nvidia-smi), device name;
  2. build: compile every CUDA kernel of the port from tvc_torch/csrc (one
     nvcc per source, all started together);
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the main paths' shapes and at ViT-L/14's vision shape (T=257),
     with kernel / plain times and the bound;
  4. slice: ViT-B/32 bf16 with the fused layers and seeded random weights,
     a 131,072 x 512 bank, an AdversarialDetector behind a ServingRuntime:
     warmup, requests through submit() and HTTP, then detect_batch at
     B=256 with V=6 real COCO caption variants; launch counts of every
     kernel on that path, the result held against the same path on the
     plain versions, and defended queries/s;
  5. int8: the same through ServingRuntime(ServingConfig(int8_serving=True))
     with no injected detector (what ``serve --int8`` builds): the W8A8
     layer kernels and the native BPE tokenizer, held against the same
     path on the plain versions;
  6. summary: one JSON line of per-kernel numbers, the card's nvidia-smi
     line, then the last line {"ok": true, "device": {...}}.

Imports nothing of JAX or of the JAX package ``tvc``.
"""

from __future__ import annotations

import gzip
import json
import math
import statistics
import subprocess
import sys
import time
import urllib.request
from contextlib import ExitStack, contextmanager
from pathlib import Path
from unittest import mock

import numpy as np

REPO = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12  # dense bf16 tensor-core rate
PEAK_INT8_OPS = 1979e12  # dense int8 tensor-core rate
PEAK_F32_FLOPS = 67e12  # f32 outside the tensor cores
LAYER_TOL = 3e-2  # relative to max(1, |plain|): see phase_kernels
CONSISTENCY_TOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


@contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    log(f"== phase {name}")
    yield
    log(f"== phase {name} ok ({time.perf_counter() - t0:.2f} s)")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of CUDA-event timings of ``fn`` after warm-up, in ms."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    """Least time for the work: bytes over the memory rate or operations
    over the peak rate of their type, whichever is larger."""
    return bound_ms_of(nbytes, flops / peak_flops)


def bound_ms_of(nbytes: float, t_ops: float):
    """The larger of bytes over the memory rate and ``t_ops`` seconds of
    operations (each kind already over its own peak rate)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------


def phase_card() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name} count {torch.cuda.device_count()}")
    # the plain versions are the reference: full f32, no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"smi": smi, "name": name, "count": torch.cuda.device_count()}


def phase_build() -> float:
    from tvc_torch.core.kernels import _build

    secs = _build.build_all()
    for name in _build.SIGNATURES:
        _build.load(name)
    log(f"build: {sorted(_build.SIGNATURES)} in {secs:.2f} s -> {_build.BUILD_DIR}")
    return secs


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _layer_inputs(rng, B, T, W, Wh, device):
    """Unit-scale bf16 activations, flax-init-scale bf16 weights, f32
    biases and LayerNorm parameters (numpy seed -> device)."""
    import torch

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a, np.float32)).to(device=device, dtype=dtype).contiguous()

    bf, f32 = torch.bfloat16, torch.float32
    x = t(rng.standard_normal((B, T, W)), bf)
    ln = (t(1.0 + 0.1 * rng.standard_normal(W), f32), t(0.1 * rng.standard_normal(W), f32))
    attn = (
        t(rng.standard_normal((W, 3 * W)) / math.sqrt(W), bf),
        t(0.02 * rng.standard_normal(3 * W), f32),
        t(rng.standard_normal((W, W)) / math.sqrt(W), bf),
        t(0.02 * rng.standard_normal(W), f32),
    )
    mlp = (
        t(rng.standard_normal((W, Wh)) / math.sqrt(W), bf),
        t(0.02 * rng.standard_normal(Wh), f32),
        t(rng.standard_normal((Wh, W)) / math.sqrt(Wh), bf),
        t(0.02 * rng.standard_normal(W), f32),
    )
    return x, ln, attn, mlp


def _layer_error(got, want) -> tuple:
    """(max |kernel - plain|, max of that scaled by max(1, |plain|)).

    Both sides round the same f32 value to bf16 at the same points; their
    f32 sums differ only in order (~1e-6 relative), so an output differs by
    at most one bf16 ulp (2^-7 |y|) where a sum lands on a rounding
    boundary, plus what one-ulp differences in the bf16 qkv / weights /
    hidden carry forward. The int8 layers add one more kind: their int32
    sums are exact on both sides, but an f32 LayerNorm, softmax or P.V sum
    taken in another order can move one activation across a .5 quantum and
    flip its int8 value by one, moving an output by row_scale * col_scale *
    |w_q| (about 1e-2 of max|y| at unit-scale inputs). 3e-2 of max(1, |y|)
    holds both with margin; a wrong index or a missed term is O(1)."""
    d = (got.float() - want.float()).abs()
    return float(d.max()), float((d / want.float().abs().clamp(min=1.0)).max())


def consistency_errors(got, want, vmask, rmask, weights) -> dict:
    """Max differences of the consistency stats, each held to 1e-5.

    variant_std is sqrt(max(E[x^2] - mean^2, 0)), the TPU kernel's formula.
    Where the variant sims nearly agree (std ~1e-3, or one valid variant)
    the sqrt turns an f32 rounding difference of ~1e-7 in the variance into
    up to ~3e-4 in the std: a property of the formula, which both sides
    share, not of either implementation. So the std is held as its square
    (the variance the kernel computes), and tv_score and aggregated, which
    are linear in the std (tv = 0.7 |orig - vmean| + 0.3 vstd), are held
    after taking out their exact std share; every other stat is held as is.
    """
    g = {k: v.double() for k, v in got.items() if k != "is_adversarial"}
    w = {k: v.double() for k, v in want.items() if k != "is_adversarial"}
    dstd = g["variant_std"] - w["variant_std"]
    wt = weights[0] * vmask.any(-1).double()
    total = wt + weights[1] * rmask.any(-1).double() + weights[2]
    diffs = {
        k: g[k] - w[k]
        for k in ("sd_score", "consistency_score", "orig_similarity", "variant_mean")
    }
    diffs["variant_var"] = g["variant_std"] ** 2 - w["variant_std"] ** 2
    diffs["tv_score - 0.3 std"] = g["tv_score"] - w["tv_score"] - 0.3 * dstd
    diffs["aggregated - w_tv 0.3 std / total_w"] = (
        g["aggregated"] - w["aggregated"] - wt / total * 0.3 * dstd
    )
    return {k: float(v.abs().max()) for k, v in diffs.items()}


def phase_kernels() -> dict:
    """Each kernel at the main path's shapes against its plain version."""
    import torch

    from tvc_torch.core.kernels import (
        attention_layer_i8_reference,
        attention_layer_reference,
        consistency_scores_reference,
        fused_attention_layer,
        fused_attention_layer_i8,
        fused_consistency_scores,
        fused_mlp_layer,
        fused_mlp_layer_i8,
        mlp_layer_i8_reference,
        mlp_layer_reference,
    )

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    results = {}

    # -- consistency: B=256, D=512, V=6, R=3, masked slots, one query with
    # no variants and one with no references
    B, D, V, R = 256, 512, 6, 3
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(dev)
    img = f(rng.standard_normal((B, D)))
    txt = f(img.cpu().numpy() + 0.8 * rng.standard_normal((B, D)))
    var = f(txt.cpu().numpy()[:, None] + 0.5 * rng.standard_normal((B, V, D)))
    refs = f(rng.standard_normal((B, R, D)))
    vmask_np = rng.random((B, V)) > 0.2
    vmask_np[0] = False
    rmask_np = rng.random((B, R)) > 0.1
    rmask_np[1] = False
    vmask = torch.as_tensor(vmask_np).to(dev)
    rmask = torch.as_tensor(rmask_np).to(dev)
    weights = torch.tensor([0.4, 0.4, 0.2], device=dev)
    thr = torch.tensor(0.5, device=dev)
    args = (img, txt, var, refs, vmask, rmask, weights, thr)
    got = fused_consistency_scores(*args)
    want = consistency_scores_reference(*args)
    torch.cuda.synchronize()
    errs = consistency_errors(got, want, vmask, rmask, (0.4, 0.4, 0.2))
    err = max(
        float((got[k].float() - want[k].float()).abs().max())
        for k in want if k != "is_adversarial"
    )
    away = (want["aggregated"] - thr).abs() > 1e-4
    flags_ok = bool((got["is_adversarial"] == want["is_adversarial"])[away].all())
    if not (max(errs.values()) <= CONSISTENCY_TOL and flags_ok):
        raise AssertionError(f"consistency kernel disagrees: errors {errs}, flags ok {flags_ok}")
    rows = 2 * B + int(vmask_np.sum()) + int(rmask_np.sum())
    nbytes = 4 * D * rows + B * (V + R) + 16 + 4 * 8 * B
    flops = 6 * D * (rows - B)  # three multiply-adds per element of each dot pair
    bms, by = bound_ms(nbytes, flops, PEAK_F32_FLOPS)
    k_ms = time_ms(lambda: fused_consistency_scores(*args), iters=50)
    p_ms = time_ms(lambda: consistency_scores_reference(*args), iters=50)
    results["fused_consistency_scores"] = {
        "shapes": [{"shape": f"B={B} D={D} V={V} R={R}", "ms": k_ms, "plain_ms": p_ms,
                    "bound_ms": bms, "bound_by": by, "max_abs_err": err}],
    }
    log(f"kernel fused_consistency_scores B={B} D={D} V={V} R={R}: kernel_ms={k_ms:.4f} "
        f"plain_ms={p_ms:.4f} bound_ms={bms:.5f} ({by}) max_abs_err={err:.3e} flags_ok={flags_ok} held={errs}")

    # -- attention and MLP layers, bf16 and int8: vision B=64 T=50 W=768
    # H=12; text rows=448 at T=16 and T=32, W=512 H=8, causal; and the
    # attention layers at ViT-L/14's vision shape B=8 T=257 W=1024 H=16
    rows = {k: [] for k in ("fused_attention_layer", "fused_mlp_layer",
                            "fused_attention_layer_i8", "fused_mlp_layer_i8")}
    for tag, B, T, W, H, causal in (
        ("vision", 64, 50, 768, 12, False),
        ("text", 448, 16, 512, 8, True),
        ("text", 448, 32, 512, 8, True),
        ("vit-l/14 vision", 8, 257, 1024, 16, False),
    ):
        x, ln, attn_w, mlp_w = _layer_inputs(rng, B, T, W, 4 * W, dev)
        M, Wh = B * T, 4 * W
        pairs = T * (T + 1) // 2 if causal else T * T
        attn_ops = 4 * B * pairs * W  # QK^T and PV over every head
        shape = f"{tag} B={B} T={T} W={W} H={H}" + (" causal" if causal else "")
        a_args = (x, *ln, *attn_w)
        a8_args = (x, *ln, *_quantized(attn_w))
        cases = [
            ("fused_attention_layer", fused_attention_layer, attention_layer_reference, a_args,
             dict(heads=H, causal=causal), shape,
             bound_ms(4 * M * W + 2 * 4 * W * W + 4 * 6 * W, 2 * M * W * 4 * W + attn_ops, PEAK_BF16_FLOPS)),
            ("fused_attention_layer_i8", fused_attention_layer_i8, attention_layer_i8_reference, a8_args,
             dict(heads=H, causal=causal), shape,
             bound_ms_of(4 * M * W + 4 * W * W + 4 * 10 * W,
                         2 * M * W * 4 * W / PEAK_INT8_OPS + attn_ops / PEAK_BF16_FLOPS)),
        ]
        if tag != "vit-l/14 vision":
            shape = f"{tag} B={B} T={T} W={W}"
            cases += [
                ("fused_mlp_layer", fused_mlp_layer, mlp_layer_reference, (x, *ln, *mlp_w), {}, shape,
                 bound_ms(4 * M * W + 2 * 2 * W * Wh + 4 * (Wh + 3 * W), 4 * M * W * Wh, PEAK_BF16_FLOPS)),
                ("fused_mlp_layer_i8", fused_mlp_layer_i8, mlp_layer_i8_reference, (x, *ln, *_quantized(mlp_w)),
                 {}, shape,
                 bound_ms_of(4 * M * W + 2 * W * Wh + 4 * (2 * Wh + 4 * W), 4 * M * W * Wh / PEAK_INT8_OPS)),
            ]
        for name, kernel, plain, args, kw, shape, (bms, by) in cases:
            run_k = lambda: kernel(*args, **kw)
            run_p = lambda: plain(*args, **kw)
            abs_err, rel_err = _layer_error(run_k(), run_p())
            if not rel_err <= LAYER_TOL:
                raise AssertionError(f"{name} {shape} disagrees: {abs_err:.3e} abs, {rel_err:.3e} scaled")
            k_ms, p_ms = time_ms(run_k), time_ms(run_p)
            rows[name].append({"shape": shape, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bms,
                               "bound_by": by, "max_abs_err": abs_err})
            log(f"kernel {name} {shape}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                f"bound_ms={bms:.5f} ({by}) max_abs_err={abs_err:.3e} scaled_err={rel_err:.3e}")
    for name, shapes in rows.items():
        results[name] = {"shapes": shapes}
    return results


def _quantized(weights):
    """(w, b, w, b) bf16 layer weights -> the int8 layer's (w_q, scale, b,
    w_q, scale, b), quantized from the same seeded values."""
    from tvc_torch.core.kernels import quantize_linear

    w1, b1, w2, b2 = weights
    return (*quantize_linear(w1), b1, *quantize_linear(w2), b2)


# ---------------------------------------------------------------------------
# phases 4-5: the serving paths, end to end
# ---------------------------------------------------------------------------

KERNEL_SOURCES = {
    "fused_consistency_scores": (
        "tvc_torch/csrc/consistency.cu", "tvc/core/pallas/consistency_kernel.py:149"),
    "fused_attention_layer": (
        "tvc_torch/csrc/attention_layer.cu", "tvc/core/pallas/attention_layer_kernel.py:194"),
    "fused_mlp_layer": (
        "tvc_torch/csrc/attention_layer.cu", "tvc/core/pallas/attention_layer_kernel.py:134"),
    "fused_attention_layer_i8": (
        "tvc_torch/csrc/quantized_layer.cu", "tvc/core/pallas/quantized_layer_kernel.py:173"),
    "fused_mlp_layer_i8": (
        "tvc_torch/csrc/quantized_layer.cu", "tvc/core/pallas/quantized_layer_kernel.py:235"),
}
#: the kernels each serving path launches; it launches no other
PATH_KERNELS = {
    "bf16": ("fused_consistency_scores", "fused_attention_layer", "fused_mlp_layer"),
    "int8": ("fused_consistency_scores", "fused_attention_layer_i8", "fused_mlp_layer_i8"),
}
B_DEFENDED, V_DEFENDED = 256, 6


def coco_variant_batch(B: int, V: int):
    """B real COCO val2017 captions (one per image) and, for each, the other
    captions of the same image repeated to V variants."""
    path = REPO / "tvc" / "assets" / "coco_captions_val2017.json.gz"
    with gzip.open(path, "rt") as f:
        pairs = json.load(f)
    by_img = {}
    for img_id, cap in pairs:
        by_img.setdefault(img_id, []).append(cap.strip())
    ids = sorted(i for i, caps in by_img.items() if len(caps) >= 2)
    order = np.random.default_rng(12345).permutation(len(ids))[:B]
    texts, variants = [], []
    for j in order:
        caps = by_img[ids[int(j)]]
        texts.append(caps[0])
        variants.append((caps[1:] * V)[:V])
    return texts, variants


def _local_http():
    """An opener that never goes through a proxy: requests stay on 127.0.0.1."""
    return urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _check_path_counts(counts: dict, path: str, what: str) -> None:
    """Every kernel of the path launched, and no kernel of another path."""
    missing = [k for k in PATH_KERNELS[path] if counts[k] <= 0]
    stray = [k for k, n in counts.items() if n and k not in PATH_KERNELS[path]]
    if missing or stray:
        raise AssertionError(f"{path} path, {what}: not launched {missing}, launched off the path {stray}: {counts}")


def drive_path(path: str, rt, det, plain_patches, card: dict) -> dict:
    """Serve a few requests through ``rt`` (submit and HTTP), then one
    defended batch through ``det`` at B=256, V=6, each with the launch
    counts set to 0 just before and read just after; hold the batch against
    the same path on the plain versions; defended queries/s; a profile."""
    import torch

    from tvc_torch.core.kernels import launch_counts, reset_launch_counts

    size = det.model.config.image_size
    rng = np.random.default_rng(2)
    texts, variants = coco_variant_batch(B_DEFENDED, V_DEFENDED)

    # -- serving: warmup, submit(), HTTP, /stats
    reset_launch_counts()
    rt.warmup()
    rt.start(http=True)
    try:
        imgs = rng.random((5, size, size, 3), dtype=np.float32)
        answers = [rt.submit(imgs[i : i + 2], texts[i : i + 2]) for i in (0, 2)]
        opener = _local_http()
        body = json.dumps({"images": imgs[4:5].tolist(), "texts": [texts[4]]}).encode()
        req = urllib.request.Request(
            rt.address + "/v1/detect", data=body, headers={"Content-Type": "application/json"}
        )
        with opener.open(req, timeout=120) as r:
            answers.append(json.load(r))
        with opener.open(rt.address + "/stats", timeout=30) as r:
            stats = json.load(r)
    finally:
        rt.stop()
    serve_counts = launch_counts()
    for a, n in zip(answers, (2, 2, 1)):
        if len(a["scores"]) != n or not np.all(np.isfinite(a["scores"])):
            raise AssertionError(f"bad serving answer {a}")
    log(f"[{path}] served: {answers}")
    log(f"[{path}] /stats: {json.dumps(stats)}")
    log(f"[{path}] launches while serving: {serve_counts}")
    _check_path_counts(serve_counts, path, "serving")

    # -- detect_batch at B=256, V=6 real caption variants
    B, V = B_DEFENDED, V_DEFENDED
    images = rng.random((B, size, size, 3), dtype=np.float32)
    reset_launch_counts()
    res = det.detect_batch(images, texts, variants)
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"[{path}] launches in one defended batch (B={B}, V={V}): {counts}")
    _check_path_counts(counts, path, "defended batch")
    agg = res.aggregated_score
    if agg.shape != (B,) or not np.all(np.isfinite(agg)):
        raise AssertionError(f"aggregated is not {B} finite values")

    # the same step with the plain versions, called in place of the kernels
    with ExitStack() as stack:
        for module, name, plain in plain_patches:
            stack.enter_context(mock.patch.object(module, name, plain))
        ref = det.detect_batch(images, texts, variants)
    torch.cuda.synchronize()
    if launch_counts() != counts:
        raise AssertionError("the plain run launched a kernel")
    same_refs = np.all(
        np.sort(res.details["ref_idx"][:, :3], -1) == np.sort(ref.details["ref_idx"][:, :3], -1), -1
    )
    d_agg = np.abs(agg - ref.aggregated_score)
    flag_agree = float(np.mean(res.is_adversarial == ref.is_adversarial))
    idx_agree = float(np.mean(res.details["ref_idx"] == ref.details["ref_idx"]))
    log(f"[{path}] kernel vs plain path: max |d agg| {d_agg.max():.3e} over all rows, "
        f"{d_agg[same_refs].max():.3e} over the {int(same_refs.sum())} rows with the same 3 references; "
        f"flag agreement {flag_agree:.4f}; ref_idx agreement {idx_agree:.4f}")
    # bf16 activations (and int8 quanta that flip where an f32 sum in
    # another order crosses a .5 boundary) move text features by ~1e-3,
    # which can reorder near-tied bank rows; a query scored against other
    # references has another sd_score, so the layer tolerance holds on the
    # rows whose scored references agree, and those must be nearly all
    if same_refs.mean() < 0.9 or d_agg[same_refs].max() > LAYER_TOL:
        raise AssertionError(f"{path} defended step disagrees with its plain version")

    # -- defended queries/s
    iters = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        det.detect_batch(images, texts, variants)
    torch.cuda.synchronize()
    qps = B * iters / (time.perf_counter() - t0)
    log(f"[{path}] defended queries/s at B={B}, V={V}: {qps:.1f} on {card['smi']}")
    profile_batch(path, lambda: det.detect_batch(images, texts, variants))
    return {"launches": counts, "qps": qps, "result": res, "inputs": (images, texts, variants),
            "flag_agreement": flag_agree, "ref_idx_agreement": idx_agree}


def phase_slice(card: dict) -> dict:
    """The bf16 path: ViT-B/32 with the fused bf16 layers, an injected
    detector over a 131,072-row bank."""
    import tvc_torch.models.clip as clip_mod
    import tvc_torch.parallel.steps as steps_mod
    from tvc_torch.core.kernels import (
        attention_layer_reference,
        consistency_scores_reference,
        mlp_layer_reference,
    )
    from tvc_torch.detector import AdversarialDetector, DetectorConfig
    from tvc_torch.models.clip import CLIPConfig, CLIPModel
    from tvc_torch.retrieval import MultiModalRetriever
    from tvc_torch.serving import ServingConfig, ServingRuntime

    t0 = time.perf_counter()
    cfg = CLIPConfig.vit_b32(fused_attention=True)
    model = CLIPModel(cfg, seed=0)
    n_params = sum(p.numel() for p in model.module.parameters())
    log(f"model: {cfg.model_name} {cfg.dtype} fused layers, {n_params} seeded random parameters "
        f"({time.perf_counter() - t0:.2f} s)")
    embs = np.random.default_rng(1).standard_normal((131072, cfg.embed_dim), dtype=np.float32)
    retriever = MultiModalRetriever(model)
    retriever.build_image_index(embeddings=embs)
    det = AdversarialDetector(
        model,
        DetectorConfig(num_text_variants=V_DEFENDED, num_reference_images=3, retrieval_top_k=10, text_bucket=32),
        retriever=retriever,
    )
    rt = ServingRuntime(ServingConfig(clip_model="ViT-B/32", batch_max_size=64), detector=det)
    patches = [
        (clip_mod, "fused_attention_layer", attention_layer_reference),
        (clip_mod, "fused_mlp_layer", mlp_layer_reference),
        (steps_mod, "fused_consistency_scores", consistency_scores_reference),
    ]
    out = drive_path("bf16", rt, det, patches, card)
    out["detector"] = det
    return out


def phase_int8(card: dict, bf16: dict) -> dict:
    """The int8 path as ``serve --int8`` builds it: ServingRuntime from its
    config alone (ViT-B/32, int8 W8A8 towers, 131,072-row bank, V=6)."""
    import tvc_torch.models.clip as clip_mod
    import tvc_torch.parallel.steps as steps_mod
    from tvc_torch.core.kernels import (
        attention_layer_i8_reference,
        consistency_scores_reference,
        mlp_layer_i8_reference,
    )
    from tvc_torch.detector import AdversarialDetector
    from tvc_torch.serving import ServingConfig, ServingRuntime

    t0 = time.perf_counter()
    rt = ServingRuntime(ServingConfig(
        clip_model="ViT-B/32", int8_serving=True, bank_size=131072, num_text_variants=V_DEFENDED,
        batch_max_size=64,
    ))
    det = rt.detector
    mcfg = det.model.config
    if not (mcfg.int8_serving and mcfg.fused_attention):
        raise AssertionError(f"ServingConfig(int8_serving=True) built {mcfg}")
    tok = det.model.tokenizer
    log(f"model: {mcfg.model_name} int8 W8A8 towers, built by ServingRuntime from its config "
        f"({time.perf_counter() - t0:.2f} s); tokenizer native={getattr(tok, 'native', None)}")
    native_before = tok.native_texts
    patches = [
        (clip_mod, "fused_attention_layer_i8", attention_layer_i8_reference),
        (clip_mod, "fused_mlp_layer_i8", mlp_layer_i8_reference),
        (steps_mod, "fused_consistency_scores", consistency_scores_reference),
    ]
    out = drive_path("int8", rt, det, patches, card)
    if tok.native_texts <= native_before:
        raise AssertionError("the native BPE tokenizer encoded no text on the int8 path")
    log(f"[int8] native BPE encoded {tok.native_texts - native_before} texts on this path")

    # informational, not held: the bf16 path on the same seed-0 weights,
    # bank and inputs
    images, texts, variants = out["inputs"]
    bf16_det = AdversarialDetector(bf16["detector"].model, det.config, retriever=det.retriever)
    other = bf16_det.detect_batch(images, texts, variants)
    log(f"[int8] informational: flag agreement int8 vs bf16 on the same weights and inputs "
        f"{float(np.mean(other.is_adversarial == out['result'].is_adversarial)):.4f}, "
        f"max |d agg| {float(np.abs(other.aggregated_score - out['result'].aggregated_score).max()):.3e}")
    return out


#: profiler names shortened to the kernel and its template arguments
#: (the first match wins, so longer names come first)
PROFILE_NAMES = (
    "ln_gemm_kernel<true, 0>", "ln_gemm_kernel<true, 1>", "ln_gemm_kernel<false, 2>",
    "i8_gemm_kernel<0>", "i8_gemm_kernel<1>", "i8_gemm_kernel<2>",
    "ln_quant_rows_kernel", "quant_rows_kernel",
    "head_attention_kernel<float>", "head_attention_kernel<__nv_bfloat16>", "consistency_kernel",
)


def profile_batch(path: str, run) -> None:
    """Where one defended batch's time goes: device time by kernel (from
    the profiler's device events) and the device's idle share of the
    batch's host wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log(f"[{path}] profile: batch wall {wall_ms:.3f} ms; device time not measured (no device events)")
        return
    by_name = {}
    for e in kernels:
        name = next((short for short in PROFILE_NAMES if short in e.name), e.name)
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    log(f"[{path}] profile: batch wall {wall_ms:.3f} ms (under the profiler), device busy {busy:.3f} ms, "
        f"idle share {1 - busy / wall_ms:.3f}")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]:
        log(f"[{path}] profile:   {ms:9.3f} ms {100 * ms / busy:5.1f}% x{n:<4d} {name[:110]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: chip_smoke.py needs a GPU", file=sys.stderr)
        return 1
    with phase("card"):
        card = phase_card()
    with phase("build"):
        phase_build()
    with phase("kernels"):
        kres = phase_kernels()
    with phase("slice"):
        bf16 = phase_slice(card)
    with phase("int8"):
        int8 = phase_int8(card, bf16)
    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        shapes = kres[name]["shapes"]
        first = shapes[0]
        by_path = {path: res["launches"][name] for path, res in (("bf16", bf16), ("int8", int8))}
        own = "int8" if name in PATH_KERNELS["int8"] else "bf16"
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": by_path[own], "launches_by_path": by_path,
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": None, "shape": first["shape"], "shapes": shapes,
        })
    log(f"defended queries/s at B={B_DEFENDED}, V={V_DEFENDED}: bf16 {bf16['qps']:.1f}, "
        f"int8 {int8['qps']:.1f} on {card['smi']}")
    print(json.dumps({"kernels": kernels}))
    print(card["smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card["name"], "count": card["count"]}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        import traceback

        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.exit(code)
