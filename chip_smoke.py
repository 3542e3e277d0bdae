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
  qwen: Qwen2-7B at full width (int8 W8A8, seeded random weights)
     paraphrasing 192 COCO captions x 3 with 16 new tokens through
     QwenModel.generate_paraphrases_batch (decode batch 576): launch counts
     of the W8A8 GEMM and decode attention kernels checked against the
     code, tok/s and ms/query, peak memory, a constrained (ASCII) call, the
     logits held against the same path on the plain versions under teacher
     forcing, a profile;
  pipeline: full TVC through MultiModalDetectionPipeline: Qwen2-1.5B
     (weight-only int8 "w8", seeded random weights, tied int8 head) in a
     TextAugmenter, the int8 ViT-B/32 detector and bank of phase 5, 192
     COCO captions x 5 variants (decode batch 960): launch counts against
     the code, the detection held against the plain CLIP kernels on the
     same variants, the teacher-forced logits against the plain w8 path,
     paraphrase tok/s, pipeline queries/s and stage times, the share of
     variant slots the LLM filled, peak memory, a profile, and
     process_stream over three batches equal to process_batch on each;
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
# decode attention, relative to max(1, |plain|): the kernel and the plain
# version round the same f32 softmax weights to bf16; a weight whose f32
# value is one ulp apart (exp and sums in another order) can round to the
# neighbouring bf16 value, moving an output by 2^-8 |w v|, and the output
# rounding adds one bf16 ulp (2^-8 |y|)
DECODE_TOL = 1e-2


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
            lib_ms = _int_mm_ms(M, args) if name.endswith("_i8") else _bf16_mm_ms(M, args)
            rows[name].append({"shape": shape, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bms,
                               "bound_by": by, "max_abs_err": abs_err, "library_ms": lib_ms})
            log(f"kernel {name} {shape}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                f"bound_ms={bms:.5f} ({by}) max_abs_err={abs_err:.3e} scaled_err={rel_err:.3e}"
                + f" library_ms(GEMM only, {'torch._int_mm' if name.endswith('_i8') else 'cuBLAS bf16'})={lib_ms:.4f}")
    for name, shapes in rows.items():
        results[name] = {"shapes": shapes}
    results.update(phase_qwen_kernels(rng, dev))
    results.update(phase_w8_kernels(dev))
    return results


def _int_mm_ms(M: int, args) -> float:
    """GEMM-only yardstick of an int8 layer: torch._int_mm on int8
    operands of its two GEMMs' shapes (the layer's int8 weights and
    random int8 activations), one after the other."""
    import torch

    w1, w2 = args[3], args[6]
    a1 = torch.randint(-127, 128, (M, w1.shape[0]), dtype=torch.int8, device=w1.device)
    a2 = torch.randint(-127, 128, (M, w2.shape[0]), dtype=torch.int8, device=w2.device)
    return time_ms(lambda: (torch._int_mm(a1, w1), torch._int_mm(a2, w2)))


def _bf16_mm_ms(M: int, args) -> float:
    """GEMM-only yardstick of a bf16 layer: cuBLAS on bf16 operands of its
    two GEMMs' shapes (the layer's weights and random activations), one
    after the other."""
    import torch

    w1, w2 = args[3], args[5]
    a1 = torch.randn((M, w1.shape[0]), dtype=torch.bfloat16, device=w1.device)
    a2 = torch.randn((M, w2.shape[0]), dtype=torch.bfloat16, device=w2.device)
    return time_ms(lambda: (a1 @ w1, a2 @ w2))


def _w8a8_bound(M, K, N, dtype_bytes=2):
    """Bytes: x in, int8 weights and f32 scales in, the output out;
    operations: 2 M K N int8."""
    return bound_ms_of(dtype_bytes * M * K + K * N + 4 * N + dtype_bytes * M * N,
                       2 * M * K * N / PEAK_INT8_OPS)


def _decode_bound(B, KV, R, S, D, dtype_bytes=2):
    """Bytes: q, k, v, the f32 mask in, the output out; operations: the
    two products (2 x 2 B KV R S D) at the bf16 tensor-core rate."""
    nbytes = dtype_bytes * (2 * B * KV * R * D + 2 * B * KV * S * D) + 4 * B * S
    return bound_ms(nbytes, 4 * B * KV * R * S * D, PEAK_BF16_FLOPS)


def phase_qwen_kernels(rng, dev) -> dict:
    """The Qwen2-7B decode's kernels against their plain versions: the W8A8
    GEMM at the five GEMM shapes of a decode step (M = 576) and at q|k|v
    of the suffix prefill (M = 192 x 24), held to equality; the decode
    attention at B = 576 (Qwen2-7B: KV = 4, R = 7, D = 128, S = 64 and
    512; Qwen2-0.5B: KV = 2, R = 7, D = 64), held to DECODE_TOL; each
    stacked wrapper on a 28-layer stack, held equal to the flat kernel on
    the layer's view."""
    import torch
    import torch.nn.functional as F

    from tvc_torch.core.kernels import (
        decode_gqa_attention,
        decode_gqa_attention_stacked,
        decode_gqa_reference,
        quantize_linear,
        w8a8_matmul,
        w8a8_matmul_reference,
        w8a8_matmul_stacked,
    )
    from tvc_torch.core.kernels.quantized_layer_kernel import _quant_rows

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(3)
    t = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    out = {k: {"shapes": []} for k in ("w8a8_matmul", "w8a8_matmul_stacked",
                                       "decode_gqa_attention", "decode_gqa_attention_stacked")}
    L, H, I, V = 28, 3584, 18944, 151936
    gemms = [("q|k|v", 576, H, 4608), ("o", 576, H, H), ("gate|up", 576, H, 2 * I), ("down", 576, I, H),
             ("lm_head", 576, H, V), ("q|k|v suffix prefill", 192 * 24, H, 4608)]
    for tag, M, K, N in gemms:
        x = t(M, K).to(bf)
        w_q, scale = quantize_linear(t(K, N) / math.sqrt(K))
        got, want = w8a8_matmul(x, w_q, scale), w8a8_matmul_reference(x, w_q, scale)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if err != 0.0:
            raise AssertionError(f"w8a8_matmul {tag} M={M} K={K} N={N} differs from its plain version by {err}")
        xq = _quant_rows(x.float())[0]  # the kernel's int8 operand
        k_ms = time_ms(lambda: w8a8_matmul(x, w_q, scale))
        p_ms = time_ms(lambda: w8a8_matmul_reference(x, w_q, scale), iters=5, warmup=1)
        lib_ms = time_ms(lambda: torch._int_mm(xq, w_q))
        bms, by = _w8a8_bound(M, K, N)
        shape = f"{tag} M={M} K={K} N={N}"
        out["w8a8_matmul"]["shapes"].append({"shape": shape, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bms,
                                             "bound_by": by, "max_abs_err": err, "library_ms": lib_ms})
        log(f"kernel w8a8_matmul {shape}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={bms:.5f} ({by}) "
            f"max_abs_err={err:.3e} library_ms(GEMM only, torch._int_mm)={lib_ms:.4f}")
        del w_q, scale, want
    # stacked: q|k|v of all 28 layers, layer 27
    M, K, N = 576, H, 4608
    x = t(M, K).to(bf)
    w_q = torch.randint(-127, 128, (L, K, N), dtype=torch.int8, device=dev)
    scale = (t(L, N).abs() * 1e-3).contiguous()
    got, flat = w8a8_matmul_stacked(x, w_q, scale, L - 1), w8a8_matmul(x, w_q[L - 1], scale[L - 1])
    want = w8a8_matmul_reference(x, w_q[L - 1], scale[L - 1])
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if not (torch.equal(got, flat) and err == 0.0):
        raise AssertionError(f"w8a8_matmul_stacked differs from the flat kernel / plain version ({err})")
    xq = _quant_rows(x.float())[0]
    k_ms = time_ms(lambda: w8a8_matmul_stacked(x, w_q, scale, L - 1))
    p_ms = time_ms(lambda: w8a8_matmul_reference(x, w_q[L - 1], scale[L - 1]), iters=5, warmup=1)
    lib_ms = time_ms(lambda: torch._int_mm(xq, w_q[L - 1]))
    bms, by = _w8a8_bound(M, K, N)
    shape = f"q|k|v layer {L - 1} of {L} M={M} K={K} N={N}"
    out["w8a8_matmul_stacked"]["shapes"].append({"shape": shape, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bms,
                                                 "bound_by": by, "max_abs_err": err, "library_ms": lib_ms})
    log(f"kernel w8a8_matmul_stacked {shape}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={bms:.5f} "
        f"({by}) max_abs_err={err:.3e} library_ms(GEMM only, torch._int_mm)={lib_ms:.4f}")
    del w_q, scale

    def decode_inputs(B, KV, R, S, D, L=None):
        cache = (B, KV, S, D) if L is None else (L, B, KV, S, D)
        mask = np.where(rng.random((B, S)) < 0.25, -np.inf, 0.0).astype(np.float32)
        mask[:, 0] = 0.0
        return t(B, KV, R, D).to(bf), t(*cache).to(bf), t(*cache).to(bf), torch.as_tensor(mask, device=dev)

    def sdpa_ms(q, k, v, mask):
        """One PyTorch call for the same function (GQA, additive mask)."""
        B, KV, R, D = q.shape
        qh, m = q.reshape(B, KV * R, 1, D), mask[:, None, None, :].to(q.dtype)
        try:
            return time_ms(lambda: F.scaled_dot_product_attention(qh, k, v, attn_mask=m, enable_gqa=True))
        except TypeError:  # a PyTorch without enable_gqa
            return None

    for tag, B, KV, R, S, D in (("Qwen2-7B", 576, 4, 7, 64, 128), ("Qwen2-7B", 576, 4, 7, 512, 128),
                                ("Qwen2-0.5B", 576, 2, 7, 64, 64), ("Qwen2-1.5B", 960, 2, 6, 64, 128)):
        q, k, v, mask = decode_inputs(B, KV, R, S, D)
        got, want = decode_gqa_attention(q, k, v, mask), decode_gqa_reference(q, k, v, mask)
        torch.cuda.synchronize()
        abs_err, rel_err = _layer_error(got, want)
        if not rel_err <= DECODE_TOL:
            raise AssertionError(f"decode_gqa_attention {tag} S={S} disagrees: {abs_err:.3e} abs, {rel_err:.3e} scaled")
        k_ms = time_ms(lambda: decode_gqa_attention(q, k, v, mask))
        p_ms = time_ms(lambda: decode_gqa_reference(q, k, v, mask))
        lib_ms = sdpa_ms(q, k, v, mask)
        bms, by = _decode_bound(B, KV, R, S, D)
        shape = f"{tag} B={B} KV={KV} R={R} S={S} D={D}"
        out["decode_gqa_attention"]["shapes"].append({"shape": shape, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bms,
                                                      "bound_by": by, "max_abs_err": abs_err, "library_ms": lib_ms})
        log(f"kernel decode_gqa_attention {shape}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={bms:.5f} "
            f"({by}) max_abs_err={abs_err:.3e} scaled_err={rel_err:.3e} library_ms(sdpa)={lib_ms}")
    B, KV, R, S, D = 576, 4, 7, 64, 128
    q, k, v, mask = decode_inputs(B, KV, R, S, D, L=L)
    got, flat = decode_gqa_attention_stacked(q, k, v, mask, L - 1), decode_gqa_attention(q, k[L - 1], v[L - 1], mask)
    want = decode_gqa_reference(q, k[L - 1], v[L - 1], mask)
    torch.cuda.synchronize()
    abs_err, rel_err = _layer_error(got, want)
    if not (torch.equal(got, flat) and rel_err <= DECODE_TOL):
        raise AssertionError(f"decode_gqa_attention_stacked differs from the flat kernel or its plain version ({rel_err})")
    k_ms = time_ms(lambda: decode_gqa_attention_stacked(q, k, v, mask, L - 1))
    p_ms = time_ms(lambda: decode_gqa_reference(q, k[L - 1], v[L - 1], mask))
    lib_ms = sdpa_ms(q, k[L - 1], v[L - 1], mask)
    bms, by = _decode_bound(B, KV, R, S, D)
    shape = f"Qwen2-7B layer {L - 1} of {L} B={B} KV={KV} R={R} S={S} D={D}"
    out["decode_gqa_attention_stacked"]["shapes"].append({"shape": shape, "ms": k_ms, "plain_ms": p_ms,
                                                          "bound_ms": bms, "bound_by": by, "max_abs_err": abs_err,
                                                          "library_ms": lib_ms})
    log(f"kernel decode_gqa_attention_stacked {shape}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
        f"bound_ms={bms:.5f} ({by}) max_abs_err={abs_err:.3e} library_ms(sdpa)={lib_ms}")
    return out


# The weight-only GEMM against its plain version, relative to max(1, |y|):
# both convert the same int8 weights exactly and sum the same exact bf16 x
# int8 products in f32, in another order (~1e-6 relative), scale in f32 and
# round once to bf16, so an output differs by at most one bf16 ulp (at most
# 2^-7 |y|) where the sum lands next to a rounding boundary.
W8_TOL = 1e-2


def _w8_bound(M, K, N):
    """Bytes: bf16 x in, int8 weights and f32 scales in, the bf16 output
    out; operations: 2 M K N at the bf16 tensor-core rate."""
    return bound_ms(2 * M * K + K * N + 4 * N + 2 * M * N, 2 * M * K * N, PEAK_BF16_FLOPS)


def phase_w8_kernels(dev) -> dict:
    """The Qwen2-1.5B weight-only GEMM against its plain version: the four
    layer GEMMs of a decode step at M = 960 (192 captions x 5 paraphrases),
    gate|up at the prefix prefill's M = 15, and the stacked wrapper on a
    28-layer q|k|v stack, held equal to the flat kernel on the layer's view.
    Library: cuBLAS x @ w on the weights dequantized to bf16 beforehand
    (GEMM only)."""
    import torch

    from tvc_torch.core.kernels import quantize_linear, w8_matmul, w8_matmul_plain, w8_matmul_stacked

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(4)
    t = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    out = {"w8_matmul": {"shapes": []}, "w8_matmul_stacked": {"shapes": []}}
    L, H, I = 28, 1536, 8960

    def hold(name, tag, run_k, run_p, run_lib, M, K, N):
        got, want = run_k(), run_p()
        torch.cuda.synchronize()
        abs_err, rel_err = _layer_error(got, want)
        if not rel_err <= W8_TOL:
            raise AssertionError(f"{name} {tag} disagrees with its plain version: {abs_err:.3e} abs, "
                                 f"{rel_err:.3e} scaled")
        k_ms, p_ms, lib_ms = time_ms(run_k), time_ms(run_p, iters=5, warmup=1), time_ms(run_lib)
        bms, by = _w8_bound(M, K, N)
        shape = f"{tag} M={M} K={K} N={N}"
        out[name]["shapes"].append({"shape": shape, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bms, "bound_by": by,
                                    "max_abs_err": abs_err, "library_ms": lib_ms})
        log(f"kernel {name} {shape}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={bms:.5f} ({by}) "
            f"max_abs_err={abs_err:.3e} scaled_err={rel_err:.3e} library_ms(GEMM only, cuBLAS bf16)={lib_ms:.4f}")

    for tag, M, K, N in (("q|k|v", 960, H, 2048), ("o", 960, H, H), ("gate|up", 960, H, 2 * I),
                         ("down", 960, I, H), ("gate|up prefix prefill", 15, H, 2 * I)):
        x = t(M, K).to(bf)
        w_q, scale = quantize_linear(t(K, N) / math.sqrt(K))
        w_bf = w_q.to(bf) * scale.to(bf)
        hold("w8_matmul", tag, lambda: w8_matmul(x, w_q, scale), lambda: w8_matmul_plain(x, w_q, scale),
             lambda: x @ w_bf, M, K, N)
        del w_q, scale, w_bf
    M, K, N = 960, H, 2048
    x = t(M, K).to(bf)
    w_q = torch.randint(-127, 128, (L, K, N), dtype=torch.int8, device=dev)
    scale = (t(L, N).abs() * 1e-3).contiguous()
    got, flat = w8_matmul_stacked(x, w_q, scale, L - 1), w8_matmul(x, w_q[L - 1], scale[L - 1])
    torch.cuda.synchronize()
    if not torch.equal(got, flat):
        raise AssertionError("w8_matmul_stacked differs from the flat kernel on the layer's view")
    w_bf = w_q[L - 1].to(bf) * scale[L - 1].to(bf)
    hold("w8_matmul_stacked", f"q|k|v layer {L - 1} of {L}", lambda: w8_matmul_stacked(x, w_q, scale, L - 1),
         lambda: w8_matmul_plain(x, w_q[L - 1], scale[L - 1]), lambda: x @ w_bf, M, K, N)
    return out


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
    # the stacked wrappers launch the flat kernels on the layer's view
    "decode_gqa_attention": (
        "tvc_torch/csrc/decode_attention.cu", "tvc/core/pallas/decode_attention_kernel.py:82"),
    "decode_gqa_attention_stacked": (
        "tvc_torch/csrc/decode_attention.cu", "tvc/core/pallas/decode_attention_kernel.py:149"),
    "w8a8_matmul": (
        "tvc_torch/csrc/quantized_layer.cu", "tvc/core/pallas/w8_matmul_kernel.py:190"),
    "w8a8_matmul_stacked": (
        "tvc_torch/csrc/quantized_layer.cu", "tvc/core/pallas/w8_matmul_kernel.py:288"),
    "w8_matmul": (
        "tvc_torch/csrc/w8_matmul.cu", "tvc/core/pallas/w8_matmul_kernel.py:101"),
    "w8_matmul_stacked": (
        "tvc_torch/csrc/w8_matmul.cu", "tvc/core/pallas/w8_matmul_kernel.py:340"),
}
#: the kernels each path launches; it launches no other
PATH_KERNELS = {
    "bf16": ("fused_consistency_scores", "fused_attention_layer", "fused_mlp_layer"),
    "int8": ("fused_consistency_scores", "fused_attention_layer_i8", "fused_mlp_layer_i8"),
    "qwen": ("w8a8_matmul", "w8a8_matmul_stacked", "decode_gqa_attention", "decode_gqa_attention_stacked"),
    "pipeline": ("fused_consistency_scores", "fused_attention_layer_i8", "fused_mlp_layer_i8", "w8_matmul",
                 "w8_matmul_stacked", "decode_gqa_attention", "decode_gqa_attention_stacked"),
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
    out["detector"] = det
    return out


# ---------------------------------------------------------------------------
# phase qwen: the Qwen2-7B paraphrase decode
# ---------------------------------------------------------------------------

N_PROMPTS, N_PARAPHRASES, MAX_NEW = 192, 3, 16
N_FORCED = 8  # decode steps held against the plain versions under teacher forcing
# Teacher-forced logits, kernel path vs the same path on the plain
# versions. The int8 GEMMs are bit-identical (phase 3), so the two runs
# part only at the decode attention, whose bf16 outputs differ by an ulp
# here and there (DECODE_TOL); such a difference changes a later layer's
# int8 quantum or bf16 rounding and travels through the remaining layers
# of a random-weight network. Held: the median |d logit| within 2e-2 of
# the logits' RMS (most logits untouched), the max within 0.5 of it (a
# few rows carry a flip), and top-1 agreement on >= 90 % of (row, step)
# pairs; a wrong index, layer or cache slot moves every logit by O(RMS).
QWEN_MEDIAN_TOL, QWEN_MAX_TOL, QWEN_TOP1 = 2e-2, 0.5, 0.9


def coco_captions(n: int):
    """The first n captions in the order of the JAX package's
    ``load_coco_captions()`` (one caption per image, the pairs permuted
    with default_rng(12345)), read from the bundled asset."""
    with gzip.open(REPO / "tvc" / "assets" / "coco_captions_val2017.json.gz", "rt") as f:
        pairs = json.load(f)
    seen, one = set(), []
    for img_id, cap in pairs:
        if img_id not in seen:
            seen.add(img_id)
            one.append(cap.strip())
    order = np.random.default_rng(12345).permutation(len(one))
    return [one[int(i)] for i in order[:n]]


def qwen_expected_launches(cfg, prefix_len: int, steps: int, prompts: int = 1, suffix_len: int = 1,
                           n_samples: int = 1) -> dict:
    """Launches of one generate_paraphrases_batch call that ran ``steps``
    decode steps, read off QwenModel.decode and _mm: 4 stacked GEMMs a
    layer in the prefix prefill (batch 1, when there is a prefix), in the
    suffix prefill (prompts x suffix_len rows) and in each decode step
    (prompts x n_samples rows); the untied head (a flat GEMM; a tied head
    is a plain matmul) after the suffix prefill (prompts rows) and after
    each step; one decode attention a layer in each step. Under "w8a8"
    every GEMM launches its kernel; under "w8" a block launches it only at
    most W8_MAX_ROWS rows (a larger one dequantizes, then matmuls)."""
    from tvc_torch.models.qwen import W8_MAX_ROWS

    w8a8 = cfg.quant_gemm == "w8a8"
    runs = lambda rows: int(rows > 0 and (w8a8 or rows <= W8_MAX_ROWS))
    L, decode_rows = cfg.num_layers, prompts * n_samples
    stacked = 4 * L * (runs(prefix_len) + runs(prompts * suffix_len) + steps * runs(decode_rows))
    head = 0 if cfg.tie_embeddings else runs(prompts) + steps * runs(decode_rows)
    gemm = "w8a8_matmul" if w8a8 else "w8_matmul"
    return {gemm: stacked + head, gemm + "_stacked": stacked,
            "decode_gqa_attention": L * steps, "decode_gqa_attention_stacked": L * steps}


def phase_qwen(card: dict) -> dict:
    """Qwen2-7B W8A8 at full width, seeded random weights, 192 COCO
    captions x 3 paraphrases x 16 new tokens."""
    import dataclasses

    import torch

    import tvc_torch.models.qwen as qwen_mod
    from tvc_torch.core.kernels import (
        decode_gqa_reference,
        launch_counts,
        reset_launch_counts,
        w8a8_matmul_reference,
    )
    from tvc_torch.models.qwen import PARAPHRASE_PREFIX, PARAPHRASE_PROMPT, QwenConfig, QwenModel

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = dataclasses.replace(QwenConfig.qwen2_7b(), quant_gemm="w8a8")
    model = QwenModel(cfg, seed=0, max_new_tokens=MAX_NEW, init_int8=True, decode_only=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"[qwen] model: {cfg.model_name} int8 W8A8, {cfg.num_layers} x {cfg.hidden_size}, seeded random "
        f"weights, init {init_s:.2f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated; "
        f"tokenizer {type(model.tokenizer).__name__}")
    texts = coco_captions(N_PROMPTS)
    n_rows = N_PROMPTS * N_PARAPHRASES

    # -- warm call through the entry point, launch counts checked
    reset_launch_counts()
    t0 = time.perf_counter()
    paras = model.generate_paraphrases_batch(texts, N_PARAPHRASES)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    counts = launch_counts()
    P = len(model._prefix_ids(PARAPHRASE_PREFIX))
    want = qwen_expected_launches(cfg, P, MAX_NEW)
    log(f"[qwen] launches in one call (prefix {P} tokens, {MAX_NEW} steps): {counts}")
    _check_path_counts(counts, "qwen", "one paraphrase batch")
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"[qwen] launch counts {counts}, expected {want}")
    if len(paras) != N_PROMPTS or any(len(p) > N_PARAPHRASES for p in paras):
        raise AssertionError("[qwen] paraphrase lists of the wrong shape")
    log(f"[qwen] warm call {warm_s:.2f} s; first paraphrases of {texts[0]!r}: {paras[0]}")

    # -- throughput
    times = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.generate_paraphrases_batch(texts, N_PARAPHRASES, seed=i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t_med = statistics.median(times)
    tok_s = n_rows * MAX_NEW / t_med
    ms_q = 1e3 * t_med / N_PROMPTS
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[qwen] paraphrase decode {N_PROMPTS} x {N_PARAPHRASES} x {MAX_NEW} new tokens: calls "
        f"{[round(x, 4) for x in times]} s, median {t_med:.4f} s: {tok_s:.1f} tok/s, {ms_q:.3f} ms/query; "
        f"peak memory {peak:.2f} GiB; on {card['smi']}")

    # -- constrained decoding: only printable-ASCII tokens
    mask = model.ascii_token_mask()
    t0 = time.perf_counter()
    ascii_paras = model.generate_paraphrases_batch(texts, N_PARAPHRASES, token_mask=mask)
    ascii_s = time.perf_counter() - t0
    bad = [o for ps in ascii_paras for o in ps if not (o.isascii() and o.isprintable())]
    if bad:
        raise AssertionError(f"[qwen] constrained decode emitted non-ASCII text: {bad[:3]}")
    log(f"[qwen] constrained (ASCII, {int(mask.sum())} of {mask.size} ids): {ascii_s:.2f} s; "
        f"first: {ascii_paras[0]}")

    # -- teacher-forced hold against the plain versions
    prompts = [PARAPHRASE_PROMPT.format(text=x) for x in texts]
    inp = model.prepare(prompts, N_PARAPHRASES, None, PARAPHRASE_PREFIX)
    kern_logits, plain_logits = [], []
    reset_launch_counts()
    toks = model.decode(inp, 0.8, seed=0,
                        on_logits=lambda i, lg: kern_logits.append(lg.clone()) if i < N_FORCED else None)
    counts = launch_counts()
    plain = [
        (qwen_mod, "w8a8_matmul", w8a8_matmul_reference),
        (qwen_mod, "w8a8_matmul_stacked", lambda x, w, s, l: w8a8_matmul_reference(x, w[l], s[l])),
        (qwen_mod, "decode_gqa_attention_stacked", lambda q, k, v, m, l: decode_gqa_reference(q, k[l], v[l], m)),
    ]
    with ExitStack() as stack:
        for module, name, fn in plain:
            stack.enter_context(mock.patch.object(module, name, fn))
        model.decode(inp, 0.8, seed=0, forced=toks.T[:N_FORCED], on_logits=lambda i, lg: plain_logits.append(lg))
    torch.cuda.synchronize()
    if launch_counts() != counts:
        raise AssertionError("[qwen] the plain run launched a kernel")
    a, b = torch.stack(kern_logits), torch.stack(plain_logits)
    if not bool(torch.isfinite(a).all()):
        raise AssertionError("[qwen] non-finite logits")
    d = (a - b).abs()
    rms = float(b.square().mean().sqrt())
    d_max, d_med = float(d.max()), float(d.median())
    top1 = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    log(f"[qwen] teacher-forced kernel vs plain, prefill + {N_FORCED - 1} steps x {n_rows} rows: "
        f"max |d logit| {d_max:.4e}, median {d_med:.4e} (logit RMS {rms:.4f}); top-1 agreement {top1:.4f}")
    if not (d_med <= QWEN_MEDIAN_TOL * rms and d_max <= QWEN_MAX_TOL * rms and top1 >= QWEN_TOP1):
        raise AssertionError("[qwen] the kernel path disagrees with its plain version")
    del a, b, kern_logits, plain_logits

    profile_batch("qwen", lambda: model.generate_paraphrases_batch(texts, N_PARAPHRASES))
    return {"launches": counts, "tok_s": tok_s, "ms_per_query": ms_q, "peak_gib": peak, "init_s": init_s,
            "top1": top1, "d_max": d_max, "d_median": d_med}


# ---------------------------------------------------------------------------
# phase pipeline: full TVC, Qwen2-1.5B w8 paraphrases into the int8 detector
# ---------------------------------------------------------------------------

PIPE_PROMPTS, PIPE_STREAM_BATCH = 192, 64


@contextmanager
def qwen_ranges(qwen_mod):
    """Profiler ranges around the weight-only route's dequant fallback and
    the tied head (both plain PyTorch), for a profile to report."""
    from torch.profiler import record_function

    fallback, head = qwen_mod.w8_matmul_reference, qwen_mod.QwenModel._head

    def ranged_fallback(*args):
        with record_function(RANGE_PREFIX + "w8 dequant fallback"):
            return fallback(*args)

    def ranged_head(self, non_layer, allowed):
        with record_function(RANGE_PREFIX + "tied head"):
            fn = head(self, non_layer, allowed)

        def run(x):
            with record_function(RANGE_PREFIX + "tied head"):
                return fn(x)

        return run

    with mock.patch.object(qwen_mod, "w8_matmul_reference", ranged_fallback), \
            mock.patch.object(qwen_mod.QwenModel, "_head", ranged_head):
        yield


def phase_pipeline(card: dict, int8: dict) -> dict:
    """Full TVC through MultiModalDetectionPipeline: Qwen2-1.5B built as the
    genref benchmark builds it (cast to bf16, then quantize_weights_int8,
    weight-only "w8"), its ParaphraseAdapter in a TextAugmenter as the
    experiment harness wires it, and phase int8's ViT-B/32 int8 model and
    131,072-row bank; 192 COCO captions with V = 5, R = 3, top-k 5."""
    import gc

    import torch

    import tvc_torch.models.clip as clip_mod
    import tvc_torch.models.qwen as qwen_mod
    import tvc_torch.parallel.steps as steps_mod
    from tvc_torch.augment import TextAugmentConfig, TextAugmenter
    from tvc_torch.core.kernels import (
        attention_layer_i8_reference,
        consistency_scores_reference,
        decode_gqa_reference,
        launch_counts,
        mlp_layer_i8_reference,
        reset_launch_counts,
        w8_matmul_plain,
    )
    from tvc_torch.models.qwen import PARAPHRASE_PREFIX, PARAPHRASE_PROMPT, QwenConfig, QwenModel
    from tvc_torch.pipeline import MultiModalDetectionPipeline, PipelineConfig

    gc.collect()
    torch.cuda.empty_cache()  # the 7B model of phase qwen is gone
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = QwenConfig.qwen2_1_5b()
    qwen = QwenModel(cfg, seed=0, max_new_tokens=MAX_NEW, cast_params_bf16=True)
    qwen.quantize_weights_int8()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    if cfg.quant_gemm != "w8":
        raise AssertionError(f"QwenConfig.qwen2_1_5b() routes quant_gemm={cfg.quant_gemm!r}")
    log(f"[pipeline] qwen: {cfg.model_name} weight-only int8 (w8), {cfg.num_layers} x {cfg.hidden_size}, "
        f"{cfg.num_heads} / {cfg.num_kv_heads} heads, tied int8 head, seeded random weights, cast + quantize "
        f"{init_s:.2f} s (peak {init_peak:.2f} GiB: the f32 init), {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated")
    det8 = int8["detector"]
    model, retriever = det8.model, det8.retriever
    V = PipelineConfig().num_text_variants

    def make_augmenter():
        return TextAugmenter(TextAugmentConfig(), paraphrase_generator=qwen.as_paraphrase_generator())

    pipe = MultiModalDetectionPipeline(model, PipelineConfig(), text_augmenter=make_augmenter(), retriever=retriever)
    texts = coco_captions(PIPE_PROMPTS)
    size = model.config.image_size
    images = np.random.default_rng(7).random((PIPE_PROMPTS, size, size, 3), dtype=np.float32)
    prompts = [PARAPHRASE_PROMPT.format(text=x) for x in texts]
    inp = qwen.prepare(prompts, V, None, PARAPHRASE_PREFIX)
    P, T = inp.P, inp.tokens.shape[1]
    n_rows = PIPE_PROMPTS * V

    # -- one batch through the entry point, launch counts checked
    reset_launch_counts()
    t0 = time.perf_counter()
    res = pipe.process_batch(images, texts)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    counts = launch_counts()
    steps = qwen.last_decode_steps
    want = qwen_expected_launches(cfg, P, steps, prompts=PIPE_PROMPTS, suffix_len=T, n_samples=V)
    log(f"[pipeline] launches in one process_batch (B={PIPE_PROMPTS}, V={V}; prefix {P} tokens, suffix "
        f"{PIPE_PROMPTS} x {T} rows, {steps} decode steps at {n_rows} rows): {counts}; Qwen expected {want}")
    _check_path_counts(counts, "pipeline", "one process_batch")
    if steps != MAX_NEW or any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"[pipeline] launch counts {counts}, expected {want} ({steps} steps)")
    if res.scores.shape != (PIPE_PROMPTS,) or not np.all(np.isfinite(res.scores)) or res.errors:
        raise AssertionError(f"[pipeline] bad result: scores {res.scores.shape}, errors {res.errors}")
    if len(res.variants) != PIPE_PROMPTS or any(not 0 < len(v) <= V for v in res.variants):
        raise AssertionError("[pipeline] variant lists of the wrong shape")
    if any(len(r) != 5 for r in res.retrieved):
        raise AssertionError("[pipeline] retrieved lists of the wrong length")
    log(f"[pipeline] first batch {warm_s:.2f} s; variants of {texts[0]!r}: {res.variants[0]}; retrieved "
        f"{res.retrieved[0]}; flagged {int(res.is_adversarial.sum())} of {PIPE_PROMPTS}")

    # -- the share of variant slots the paraphrase strategy filled (the
    # adapter's seed is a digest of the texts, so this decode repeats the
    # pipeline's)
    paras = qwen.as_paraphrase_generator().batch(texts, V)
    slots = sum(len(v) for v in res.variants)
    from_llm = sum(v in set(p) for vl, p in zip(res.variants, paras) for v in vl)
    log(f"[pipeline] variant slots from the paraphrase strategy: {from_llm} of {slots} "
        f"({from_llm / slots:.4f}); the host strategies fill the rest first and the augmenter skips the "
        f"later strategies once {V} variants survive; first paraphrases: {paras[0]}")

    # -- the detection on the plain CLIP kernels, given the same variants
    plain_clip = [
        (clip_mod, "fused_attention_layer_i8", attention_layer_i8_reference),
        (clip_mod, "fused_mlp_layer_i8", mlp_layer_i8_reference),
        (steps_mod, "fused_consistency_scores", consistency_scores_reference),
    ]
    before = launch_counts()
    with ExitStack() as stack:
        for module, name, fn in plain_clip:
            stack.enter_context(mock.patch.object(module, name, fn))
        ref = pipe._detect_and_retrieve(images, texts, res.variants, {}, [])
    torch.cuda.synchronize()
    if launch_counts() != before:
        raise AssertionError("[pipeline] the plain run launched a kernel")
    # the retrieved items are the fused step's top-5; its first R = 3 are
    # the scored references
    same_refs = np.array([sorted(a[:3]) == sorted(b[:3]) for a, b in zip(res.retrieved, ref.retrieved)])
    d_agg = np.abs(res.scores - ref.scores)
    thr = pipe.detector.threshold_manager.get_threshold()
    away = same_refs & (np.abs(ref.scores - thr) > LAYER_TOL)
    flag_agree = float(np.mean(res.is_adversarial == ref.is_adversarial))
    log(f"[pipeline] kernel vs plain CLIP kernels on the same variants: max |d score| {d_agg.max():.3e} over all "
        f"rows, {d_agg[same_refs].max():.3e} over the {int(same_refs.sum())} rows with the same 3 references; "
        f"flag agreement {flag_agree:.4f}")
    if same_refs.mean() < 0.9 or d_agg[same_refs].max() > LAYER_TOL or \
            not np.array_equal(res.is_adversarial[away], ref.is_adversarial[away]):
        raise AssertionError("[pipeline] the detection disagrees with its plain version")

    # -- teacher-forced logits: the w8 path vs the same path on the plain
    # versions, prefill + N_FORCED - 1 steps at decode batch 960
    kern_logits, plain_logits = [], []
    reset_launch_counts()
    toks = qwen.decode(inp, 0.8, seed=0,
                       on_logits=lambda i, lg: kern_logits.append(lg.clone()) if i < N_FORCED else None)
    counts_tf = launch_counts()
    plain_qwen = [
        (qwen_mod, "w8_matmul", w8_matmul_plain),
        (qwen_mod, "w8_matmul_stacked", lambda x, w, s, l: w8_matmul_plain(x, w[l], s[l])),
        (qwen_mod, "decode_gqa_attention_stacked", lambda q, k, v, m, l: decode_gqa_reference(q, k[l], v[l], m)),
    ]
    with ExitStack() as stack:
        for module, name, fn in plain_qwen:
            stack.enter_context(mock.patch.object(module, name, fn))
        qwen.decode(inp, 0.8, seed=0, forced=toks.T[:N_FORCED], on_logits=lambda i, lg: plain_logits.append(lg))
    torch.cuda.synchronize()
    if launch_counts() != counts_tf:
        raise AssertionError("[pipeline] the plain Qwen run launched a kernel")
    a, b = torch.stack(kern_logits), torch.stack(plain_logits)
    if not bool(torch.isfinite(a).all()):
        raise AssertionError("[pipeline] non-finite logits")
    d = (a - b).abs()
    rms = float(b.square().mean().sqrt())
    d_max, d_med = float(d.max()), float(d.median())
    top1 = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    log(f"[pipeline] teacher-forced w8 kernel path vs plain, prefill + {N_FORCED - 1} steps x {n_rows} rows: "
        f"max |d logit| {d_max:.4e}, median {d_med:.4e} (logit RMS {rms:.4f}); top-1 agreement {top1:.4f}")
    if not (d_med <= QWEN_MEDIAN_TOL * rms and d_max <= QWEN_MAX_TOL * rms and top1 >= QWEN_TOP1):
        raise AssertionError("[pipeline] the w8 kernel path disagrees with its plain version")
    del a, b, d, kern_logits, plain_logits, toks

    # -- paraphrase decode alone at batch 960
    times = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qwen.generate_paraphrases_batch(texts, V, seed=i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t_med = statistics.median(times)
    tok_s = n_rows * MAX_NEW / t_med
    ms_q = 1e3 * t_med / PIPE_PROMPTS
    log(f"[pipeline] paraphrase decode {PIPE_PROMPTS} x {V} x {MAX_NEW} new tokens (batch {n_rows}): calls "
        f"{[round(x, 4) for x in times]} s, median {t_med:.4f} s: {tok_s:.1f} tok/s, {ms_q:.3f} ms/query on "
        f"{card['smi']}")

    # -- full TVC queries/s, each timed batch with an empty variant cache
    pipe.profiler = type(pipe.profiler)(True)
    torch.cuda.reset_peak_memory_stats()
    q_times = []
    for _ in range(3):
        pipe.text_augmenter.clear_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.process_batch(images, texts)
        torch.cuda.synchronize()
        q_times.append(time.perf_counter() - t0)
    qps = PIPE_PROMPTS / statistics.median(q_times)
    stages = {k: round(v["mean"] * 1e3, 3) for k, v in pipe.profiler.get_stats().items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[pipeline] full TVC process_batch at B={PIPE_PROMPTS}: {[round(x, 4) for x in q_times]} s, "
        f"{qps:.2f} queries/s; PipelineProfiler mean ms {stages}; peak memory over these batches {peak:.2f} GiB; "
        f"on {card['smi']}")
    pipe.text_augmenter.clear_cache()
    with qwen_ranges(qwen_mod):
        profile_batch("pipeline", lambda: pipe.process_batch(images, texts))

    # -- process_stream over three batches of 64 equals process_batch on
    # each, both with a fresh augmenter (empty cache, synonym draws from
    # the seed)
    nb = PIPE_STREAM_BATCH
    batches = [(images[i : i + nb], texts[i : i + nb]) for i in range(0, PIPE_PROMPTS, nb)]
    pipe.text_augmenter = make_augmenter()
    reset_launch_counts()
    stream = pipe.process_stream(iter(batches))
    torch.cuda.synchronize()
    stream_counts = launch_counts()
    _check_path_counts(stream_counts, "pipeline", "process_stream")
    pipe.text_augmenter = make_augmenter()
    single = [pipe.process_batch(im, tx) for im, tx in batches]
    for k, (a, b) in enumerate(zip(stream, single)):
        if not (a.variants == b.variants and a.retrieved == b.retrieved
                and np.array_equal(a.scores, b.scores) and np.array_equal(a.is_adversarial, b.is_adversarial)):
            raise AssertionError(f"[pipeline] process_stream batch {k} differs from process_batch")
    log(f"[pipeline] process_stream over {len(batches)} batches of {nb} equals process_batch on each "
        f"(variants, items, scores, flags); launches {stream_counts}")
    return {"launches": counts, "qps": qps, "tok_s": tok_s, "ms_per_query": ms_q, "peak_gib": peak,
            "top1": top1, "d_max": d_max, "d_median": d_med, "llm_share": from_llm / slots, "stages_ms": stages}


#: profiler names shortened to the kernel and its template arguments
#: (the first match wins, so longer names come first)
PROFILE_NAMES = (
    "ln_gemm_kernel<true, 0>", "ln_gemm_kernel<true, 1>", "ln_gemm_kernel<false, 2>",
    "i8_gemm_kernel<0>", "i8_gemm_kernel<1>", "i8_gemm_kernel<2>", "i8_gemm_kernel<3>",
    "i8_gemm_kernel<4>", "ln_quant_rows_kernel", "quant_rows_kernel<float>",
    "quant_rows_kernel<__nv_bfloat16>", "decode_gqa_kernel<__nv_bfloat16, 128>",
    "decode_gqa_kernel<__nv_bfloat16, 64>",
    "head_attention_kernel<float>", "head_attention_kernel<__nv_bfloat16>", "consistency_kernel",
    "w8_gemm_kernel",
)
#: the prefix of the record_function ranges a profile reports by name
RANGE_PREFIX = "smoke:"


def profile_batch(path: str, run) -> None:
    """Where one batch's time goes: device time by kernel (from the
    profiler's device events), the device time under each RANGE_PREFIX
    range the run opens, and the device's idle share of the batch's host
    wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith(RANGE_PREFIX)]
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
    for avg in prof.key_averages():
        # the host-side range; its device time is that of the kernels it launched
        if avg.key.startswith(RANGE_PREFIX) and avg.device_type == torch.autograd.DeviceType.CPU:
            dev_us = getattr(avg, "device_time_total", None)
            dev_us = avg.cuda_time_total if dev_us is None else dev_us
            log(f"[{path}] profile: range {avg.key[len(RANGE_PREFIX):]!r}: device {dev_us / 1e3:.3f} ms "
                f"in {avg.count} calls")


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
    with phase("qwen"):
        qwen = phase_qwen(card)
    with phase("pipeline"):
        pipeline = phase_pipeline(card, int8)
    paths = {"bf16": bf16, "int8": int8, "qwen": qwen, "pipeline": pipeline}
    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        shapes = kres[name]["shapes"]
        first = shapes[0]
        by_path = {path: res["launches"][name] for path, res in paths.items()}
        own = next(path for path, names in PATH_KERNELS.items() if name in names)
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": by_path[own], "launches_by_path": by_path,
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first.get("library_ms"), "shape": first["shape"], "shapes": shapes,
        })
    log(f"defended queries/s at B={B_DEFENDED}, V={V_DEFENDED}: bf16 {bf16['qps']:.1f}, "
        f"int8 {int8['qps']:.1f} on {card['smi']}")
    log(f"qwen paraphrase decode: {qwen['tok_s']:.1f} tok/s, {qwen['ms_per_query']:.3f} ms/query, "
        f"peak {qwen['peak_gib']:.2f} GiB on {card['smi']}")
    log(f"full TVC pipeline (Qwen2-1.5B w8 + int8 ViT-B/32): {pipeline['qps']:.2f} queries/s, paraphrase decode "
        f"{pipeline['tok_s']:.1f} tok/s, {pipeline['ms_per_query']:.3f} ms/query, peak {pipeline['peak_gib']:.2f} "
        f"GiB on {card['smi']}")
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
