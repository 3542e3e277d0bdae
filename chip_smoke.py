"""Drive the PyTorch/CUDA port (tvc_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):
  1. card: name and power limit (nvidia-smi), device name;
  2. build: compile every CUDA kernel of the port from tvc_torch/csrc (one
     nvcc per source, all started together);
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the main paths' shapes (fused_consistency_scores at the seven
     CONSISTENCY_SHAPES, each also bit-equal over two calls and one device
     kernel a call by torch.profiler, the wrapper and the bare kernel
     timed), at ViT-L/14's vision shape (T=257), at head width 32 and,
     for the four layer kernels, in f32 at the tiny configurations'
     shapes, with kernel / plain / library times, the bound and the GEMMs'
     plans; and every kernel at the shapes the JAX kernels take that the
     tiled kernels do not ("F1" rows: head widths off 32 / 64, widths off
     the GEMMs' 16-byte rows, decode R > 8 and D off {16, 32, 64, 128},
     bank_topk D % 8 != 0 and k > 128), with the copies and launches a
     call makes; DeepSeek-V2-Lite's grouped w8 expert GEMM (5,760 rows over
     64 experts, unevenly) and latent decode attention (B 960, S 64) at
     the tvc-dsv2-lite-w8.fresh decode step's shapes, bounds from
     perfbench/work_moe.py; Kimi-Linear's KDA kernels (the preparation,
     the recurrence on the f32 state, the gated norm), its sigmoid routing
     over 256 experts and its 32-head latent attention at the
     tvc-kimi-linear-48b-w8.fresh96 cell's shapes (480 decode rows, a
     prefill of 96, the prefix at batch 1), bounds from perfbench/work_kda.py;
     Nemotron-H's own kernels at the tvc-nemotron3-nano-30b-w8.fresh128
     cell's shapes (640 decode rows, a prefill of 128 with real lengths,
     the prefix at batch 1; 64 heads of 64, a 64 x 128 f32 state, 8
     groups): ssm_prepare, ssm_recurrent and ssm_gated_norm against their
     plain versions, relu2 at the routed and shared experts' widths and
     qkv_cache at 16 query heads a KV head bit-equal to theirs, its sigmoid
     routing over 128 experts bit-equal and its decode attention at 16
     query heads a KV head (the tail kernel), bounds from
     perfbench/work_ssm.py;
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
  tiny: the tiny configurations (f32, W=64, two heads: head width 32) on
     the card: ServingRuntime(ServingConfig(clip_model="tiny",
     int8_serving=True)) through the int8 layer kernels, and a detector
     over CLIPConfig.from_name("tiny", fused_attention=True) through the
     bf16-layer kernels in f32, each serving a few requests through
     submit(), held against the same runtime on the plain versions;
  attack: detect under attack. PGD standard (eps 8/255, 10 steps) on 64
     seeded 224 px images against the slice phase's ViT-B/32 (gradients
     through the einsum module), attacked images/s, peak memory and a
     profile, then that detector on the clean + attacked batch held against
     its plain versions, queries/s; then the trained tiny_coco fixture: its
     evaluation held to the recorded metrics, PGD / FGSM and C&W / FSTA /
     SMA / hubness fast on the rendered images of the first 64 held-out
     COCO captions (the eps-ball and the clamp checked), the clean and attacked images served
     by ServingRuntime(ServingConfig(clip_model="tiny_coco_trained")) and
     by an injected detector over tiny_coco with fused_attention (the f32
     layer kernels), each held against its plain route, AUROC and TPR at
     5 % FPR per attack (reported, not gated); the adaptive (defense-aware)
     attack: AdaptiveAttacker (pgd base, eps 8/255, 10 steps) at B=64
     against the slice phase's detector calibrated two-sided on the clean
     images (attacked images/s, peak memory), run_adaptive_evaluation
     scored by that detector's detect_batch over lambda (0, 2, 5) and a
     20-step strong pass (attack success, detection rate and band AUROC
     per lambda, the eps-ball and the clamp on every attacked batch), the
     clean and the lambda-0 batch held against the plain versions, the
     same evaluation on the fixture's two routes, and the alt-stack
     MultiModalDefenseDetector's AUROC on the fixture's clean vs PGD images;
  sd: StableDiffusionModel(SDConfig()) (the SD-1.5 shape class: bf16,
     512 px, 20 DDIM steps, CFG 7.5, seeded random weights initialized on
     the card) behind SDReferenceGenerator(SDReferenceConfig()) with the
     slice phase's ViT-B/32 as its CLIP, feeding an AdversarialDetector
     with no retriever on 8 COCO captions (24 references, a CFG batch of
     48): SD reference images/s, ms per CFG UNet call, VAE decode ms, the
     detector's queries/s, peak memory, a profile; generation bit-equal
     over two calls, images on the 1/255 grid in [0, 1], one UNet call
     bf16 against f32 in direction and relative L2 beside three bf16
     slips (the limits must catch the timestep-embedding one), the
     references' vision encode and the detector on the same references
     against their plain versions; the model freed before qwen;
  weights: the model lifecycle. (a) make_train_step on the slice phase's
     ViT-B/32 (bf16 compute, f32 parameters and AdamW state), 20 steps at
     lr 1e-4 on one batch of 256 rendered 224 px COCO pairs: training
     pairs/s (CUDA events after 2 warm-up steps), peak memory, a profile,
     the loss finite and falling, the first step's loss against an f32
     recomputation (TRAIN_LOSS_TOL); the trained weights installed and
     detect_batch at B=256, V=6 held against the plain versions; (b)
     train_clip_fixture_coco() at its defaults to its stop rule (retrieval
     >= 0.92, cross_text_cos >= 0.45), its metrics beside the recorded
     asset's, saved under build/weights and read back bit-equal, served
     through the f32 layer kernels against plain; (c) published layouts
     written under build/weights with seeded values: an HF CLIPModel
     ViT-B/32 as model.safetensors and as pytorch_model.bin (both loaded by
     load_clip_weights, bit-equal trees, the load seconds, served against
     plain), a diffusers SD-1.5 checkout (f16 unet/ and vae/) through
     load_sd_weights driven as the sd phase (drive_sd), and an HF
     Qwen2-1.5B (BF16 safetensors) through load_qwen_weights, w8, its
     teacher-forced logits against the plain w8 path; the files deleted;
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
  dsv2: DeepSeek-V2-Lite at its published shape (w8, seeded random
     weights) decoding 192 COCO paraphrase prompts x 5 samples (decode
     batch 960): the launches of one decode step, counted in that step
     under set_sync_debug_mode("error"), checked against the code,
     paraphrase tok/s and peak memory;
  kimi: Kimi-Linear-48B-A3B at its published shape (w8, seeded random
     weights) decoding 96 COCO paraphrase prompts x 5 samples (decode
     batch 480), as dsv2;
  nemotron: NVIDIA-Nemotron-3-Nano-30B-A3B at its published shape (w8,
     seeded random weights) decoding 128 COCO paraphrase prompts x 5
     samples (decode batch 640), as dsv2;
  mha: CLIPModel(CLIPConfig.vit_b32(fused_attention=True)) through
     inference_module.encode_image at B=256 (one fused_mha launch a vision
     layer, held against the einsum module on the same parameters), the
     images/s of three vision paths, and ViT-L/14 at B=64;
  retrieval: the retriever over that model: a text index of all 25,014
     COCO captions, an image index of 1,024 seeded PIL photos of mixed
     sizes (the native resize), 256 queries each way, the similarity
     matrix, bank_topk over the text bank against text_bank.search,
     detect_adversarial twice (a cache hit), and the order of exact ties
     (raw torch.topk, EmbeddingBank.search, the serving step's top-k);
  harness: the experiment harness and the command line (python -m
     tvc_torch.cli, in-process): defense --experiment-mode four_scenarios at
     ViT-B/32 (seeded random weights, 64 samples, the bank cut to 1,024,
     PGD and hubness): set-up, attack and stage seconds, AUROC and detection
     rate per attack, the staged overhead, fused_consistency_scores launches
     checked against the protocol, the clean batch held against the plain
     consistency version; every mode but comprehensive on the trained
     tiny_coco fixture (32 samples): seconds, the result JSON and report,
     the profiler trace, figures consistent with matplotlib's presence;
     measure_serving_overhead() at its defaults (int8 ViT-B/32, B=256, a
     131,072-row bank): defended / baseline ms and overhead, the launches
     of a defended step against the code, peak memory, the defended step
     against the plain versions; hardware-detect --probe, config-gen
     --no-write (and a DynamicConfigManager on a temporary directory read
     back through the port's YAML reader), deploy --detect-only, build-bank
     at ViT-B/32 (256 samples), analyze over the phase's results; configs/
     untouched;
  large bank: bank_topk at B=256 over a 4,194,304 x 512 f32 bank against
     its plain version, the wrapper's and the phase's peak memory, a
     profile;
  mesh: the mesh paths on torch.distributed, in child processes: (a) world
     size 1 over NCCL (initialize_multihost with a 127.0.0.1 coordinator):
     bf16 and int8 ViT-B/32 detect_batch (B=256, V=6, top-k 10) through a
     mesh-built retriever over the 131,072 x 512 bank against the
     single-device detector (flags and ref_idx equal, aggregated within
     MESH1_AGG_TOL), defended q/s of both, the collectives' ms a batch; (b)
     two gloo ranks sharing the card (left out on an exclusive compute
     mode, the reason printed): the same serving at data = 2 over a bank
     sharded two ways (each rank's launches checked), data-parallel
     ViT-B/32 training (B=256, 3 steps), Qwen2-7B W8A8 at TP = 2
     (teacher-forced logits against the single-device module path, a
     greedy decode of 64 captions x 3) and the SD-1.5 sampler at data = 2
     (8 captions x 3, MESH_SD_STEPS steps), each held by rank 0 against the
     single-device run; throughputs labelled as two ranks sharing one card;
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
# the bf16-layer kernels in f32 against their plain versions, relative to
# max(1, |plain|): the same f32 function summed in another order
# (LayerNorm, GEMM, softmax, P.V), ~1e-6; a wrong index or term is O(1)
F32_LAYER_TOL = 1e-4
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


#: cycles of the spin kernel queued ahead of each timed call (~0.5 ms)
SPIN_CYCLES = 1_000_000


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of CUDA-event timings of ``fn`` after warm-up, in ms: device
    time. A spin kernel queued ahead of each call keeps the card busy while
    the host enqueues the call, so a wrapper's host time is not counted
    where it exceeds its kernels'."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
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
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}; compute mode {mode}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name} count {torch.cuda.device_count()}")
    # the plain versions are the reference: full f32, no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"smi": smi, "name": name, "count": torch.cuda.device_count(), "compute_mode": mode}


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


#: the consistency phase's shapes: (what, B, D, V, R, kind). masked: slots
#: dropped at random, one query without variants, one without references,
#: weights and threshold as device tensors (the serving step); valid: all
#: slots valid, weights and threshold as Python numbers (the detector);
#: bf16: refs and variants bf16, img and txt f32; ragged: int32 masks and
#: variants a non-contiguous slice (copied by the wrapper, counted). The
#: first shape is the one the kernel's row has been timed at since it came.
CONSISTENCY_SHAPES = (
    ("int8 serving step (K=3)", 256, 512, 6, 3, "masked"),
    ("bf16 detector (K=10)", 256, 512, 6, 10, "valid"),
    ("full TVC process_batch", 192, 512, 5, 3, "valid"),
    ("retrieval-scale batch", 4096, 512, 6, 10, "valid"),
    ("bf16 refs and variants", 256, 512, 6, 3, "bf16"),
    ("ragged: D=30, int32 masks, strided variants", 37, 30, 6, 3, "ragged"),
    ("tiny configs' width", 256, 32, 6, 3, "valid"),
)


def device_kernels(fn) -> list:
    """Names of the device activities (kernels, copies) one call of ``fn``
    runs, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def consistency_inputs(dev, rng, B: int, D: int, V: int, R: int, kind: str):
    """One CONSISTENCY_SHAPES call's inputs, made from ``rng``: (args of
    fused_consistency_scores, the same with f32 embeddings for the plain
    version, the valid-slot masks as numpy)."""
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    t = lambda a, dt=f32: torch.as_tensor(np.asarray(a, np.float32)).to(dev, dt)
    img_np = rng.standard_normal((B, D))
    txt_np = img_np + 0.8 * rng.standard_normal((B, D))
    img, txt = t(img_np), t(txt_np)
    low = bf16 if kind == "bf16" else f32
    var = t(txt_np[:, None] + 0.5 * rng.standard_normal((B, V, D)), low)
    refs = t(rng.standard_normal((B, R, D)), low)
    vmask_np = rng.random((B, V)) > (0.2 if kind in ("masked", "ragged") else -1.0)
    rmask_np = rng.random((B, R)) > (0.1 if kind in ("masked", "ragged") else -1.0)
    if kind == "masked":
        vmask_np[0] = False
        rmask_np[1] = False
    mask_dt = torch.int32 if kind == "ragged" else torch.bool
    vmask, rmask = (torch.as_tensor(m).to(dev, mask_dt) for m in (vmask_np, rmask_np))
    if kind == "ragged":  # the same values, a view with a row stride of D + 2
        var = torch.cat([var, torch.zeros_like(var[..., :2])], dim=-1)[..., :D]
    w = (0.4, 0.4, 0.2)
    weights, thr = (torch.tensor(w, device=dev), torch.tensor(0.5, device=dev)) if kind == "masked" else (w, 0.5)
    args = (img, txt, var, refs, vmask, rmask, weights, thr)
    plain_args = (img.float(), txt.float(), var.float(), refs.float(), vmask, rmask, weights, thr)
    return args, plain_args, vmask_np, rmask_np


def consistency_bound(args, vmask_np, rmask_np) -> tuple:
    """(bytes, bound ms, bound by) of one call: img, txt and the valid slot
    rows in their stored dtype (the kernel reads no masked row), every mask
    element, tensor weights and threshold, the outputs."""
    img, txt, var, refs, vmask, rmask, weights, thr = args
    B, D = img.shape
    V, R = var.shape[1], refs.shape[1]
    nv, nr = int(vmask_np.sum()), int(rmask_np.sum())
    per_column = B * (img.element_size() + txt.element_size()) + var.element_size() * nv + refs.element_size() * nr
    nbytes = (D * per_column
              + vmask.element_size() * B * V + rmask.element_size() * B * R
              + sum(4 * x.numel() for x in (weights, thr) if hasattr(x, "numel")) + (4 * 7 + 1) * B)
    flops = 6 * D * (B + nv + nr)  # three multiply-adds per element of each dot pair
    return (nbytes, *bound_ms(nbytes, flops, PEAK_F32_FLOPS))


def consistency_shape(dev, rng, what: str, B: int, D: int, V: int, R: int, kind: str) -> dict:
    """fused_consistency_scores at one shape against the plain version on
    the f32 values: held by consistency_errors at CONSISTENCY_TOL, flags equal
    away from the threshold, two calls bit-equal, one kernel a call (and one
    copy kernel per operand the wrapper copies); the wrapper's time, the bare
    kernel's and the plain version's (device time), and the bound."""
    import torch

    from tvc_torch.core.kernels import consistency_scores_reference, fused_consistency_scores
    from tvc_torch.core.kernels.consistency_kernel import consistency_launch

    args, plain_args, vmask_np, rmask_np = consistency_inputs(dev, rng, B, D, V, R, kind)
    vmask, rmask, w = args[4], args[5], (0.4, 0.4, 0.2)
    copies = fused_consistency_scores.copies
    got = fused_consistency_scores(*args)
    copies = fused_consistency_scores.copies - copies
    again = fused_consistency_scores(*args)
    want = consistency_scores_reference(*plain_args)
    torch.cuda.synchronize()
    errs = consistency_errors(got, want, vmask.bool(), rmask.bool(), w)
    err = max(float((got[k].float() - want[k].float()).abs().max()) for k in want if k != "is_adversarial")
    away = (want["aggregated"] - 0.5).abs() > 1e-4
    flags_ok = bool((got["is_adversarial"] == want["is_adversarial"])[away].all())
    bit_equal = all(torch.equal(got[k], again[k]) for k in got)
    dtypes_ok = got["is_adversarial"].dtype == torch.bool and all(
        got[k].dtype == torch.float32 and got[k].shape == (B,) for k in got if k != "is_adversarial")
    if not (max(errs.values()) <= CONSISTENCY_TOL and flags_ok and bit_equal and dtypes_ok):
        raise AssertionError(f"consistency kernel at {what} B={B} D={D} V={V} R={R}: errors {errs}, flags ok "
                             f"{flags_ok}, bit-equal {bit_equal}, dtypes ok {dtypes_ok}")
    names = device_kernels(lambda: fused_consistency_scores(*args))
    kernels = sum("consistency_kernel" in n for n in names)
    if kernels != 1 or len(names) != 1 + copies or copies != (kind == "ragged"):
        raise AssertionError(f"consistency at {what}: {kernels} kernels, device activities {names}, "
                             f"{copies} operand copies a call")

    launch, _ = consistency_launch(*args)
    w_ms = time_ms(lambda: fused_consistency_scores(*args), iters=50)
    k_ms = time_ms(launch, iters=50)
    p_ms = time_ms(lambda: consistency_scores_reference(*plain_args), iters=50)
    nbytes, bms, by = consistency_bound(args, vmask_np, rmask_np)
    shape = f"{what}: B={B} D={D} V={V} R={R}"
    log(f"kernel fused_consistency_scores {shape}: wrapper_ms={w_ms:.4f} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
        f"bound_ms={bms:.5f} ({by}, {nbytes / 1e6:.3f} MB) kernel at {100 * bms / k_ms:.1f}% of the bound, "
        f"max_abs_err={err:.3e} flags_ok={flags_ok} bit_equal={bit_equal} device activities a call "
        f"{len(names)} ({copies} copies) held={errs}")
    return {"shape": shape, "ms": w_ms, "kernel_ms": k_ms, "plain_ms": p_ms, "bound_ms": bms, "bound_by": by,
            "max_abs_err": err, "device_kernels_per_call": len(names), "copies_per_call": copies}


def phase_kernels() -> dict:
    """Each kernel at the main path's shapes against its plain version."""
    import torch

    from tvc_torch.core.kernels import (
        attention_layer_i8_reference,
        attention_layer_reference,
        fused_attention_layer,
        fused_attention_layer_i8,
        fused_mlp_layer,
        fused_mlp_layer_i8,
        mlp_layer_i8_reference,
        mlp_layer_reference,
    )

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    results = {}

    # the first shape draws from the phase's generator, as before the other
    # shapes came, so that the layers below keep their inputs
    more = np.random.default_rng(10)
    results["fused_consistency_scores"] = {"shapes": [consistency_shape(dev, rng if i == 0 else more, *shape)
                                                      for i, shape in enumerate(CONSISTENCY_SHAPES)]}

    # -- attention and MLP layers, bf16 and int8: vision B=64 T=50 W=768
    # H=12; text rows=448 at T=16 and T=32, W=512 H=8, causal; the
    # attention layers at ViT-L/14's vision shape B=8 T=257 W=1024 H=16,
    # at B=4 T=300 W=768 H=12 and at head width 32 (B=64 T=50 W=768 H=24);
    # then the tiny configurations' f32 layers (W=64, two heads: head width
    # 32) at a serving batch of 256 images (T=5) and 256 captions (T=16)
    rows = {k: [] for k in ("fused_attention_layer", "fused_mlp_layer",
                            "fused_attention_layer_i8", "fused_mlp_layer_i8")}
    bf16, f32 = torch.bfloat16, torch.float32
    for tag, B, T, W, H, causal, dt in (
        ("vision", 64, 50, 768, 12, False, bf16),
        ("text", 448, 16, 512, 8, True, bf16),
        ("text", 448, 32, 512, 8, True, bf16),
        ("vit-l/14 vision", 8, 257, 1024, 16, False, bf16),
        ("T=300", 4, 300, 768, 12, False, bf16),
        ("D=32", 64, 50, 768, 24, False, bf16),
        ("tiny vision f32", 256, 5, 64, 2, False, f32),
        ("tiny text f32", 256, 16, 64, 2, True, f32),
    ):
        x, ln, attn_w, mlp_w = _layer_inputs(rng, B, T, W, 4 * W, dev)
        cast = lambda ts: tuple(t.to(dt) if t.dtype == bf16 else t for t in ts)  # the weights, not the biases
        x, attn_w, mlp_w = x.to(dt), cast(attn_w), cast(mlp_w)
        el, peak = (4, PEAK_F32_FLOPS) if dt == f32 else (2, PEAK_BF16_FLOPS)
        M, Wh = B * T, 4 * W
        pairs = T * (T + 1) // 2 if causal else T * T
        attn_ops = 4 * B * pairs * W  # QK^T and PV over every head
        shape = f"{tag} B={B} T={T} W={W} H={H}" + (" causal" if causal else "")
        a_args = (x, *ln, *attn_w)
        a8_args = (x, *ln, *_quantized(attn_w))
        cases = [
            ("fused_attention_layer", fused_attention_layer, attention_layer_reference, a_args,
             dict(heads=H, causal=causal), shape,
             bound_ms(2 * el * M * W + el * 4 * W * W + 4 * 6 * W, 2 * M * W * 4 * W + attn_ops, peak)),
            ("fused_attention_layer_i8", fused_attention_layer_i8, attention_layer_i8_reference, a8_args,
             dict(heads=H, causal=causal), shape,
             bound_ms_of(2 * el * M * W + 4 * W * W + 4 * 10 * W,
                         2 * M * W * 4 * W / PEAK_INT8_OPS + attn_ops / peak)),
        ]
        if tag not in ("vit-l/14 vision", "T=300", "D=32"):
            shape = f"{tag} B={B} T={T} W={W}"
            cases += [
                ("fused_mlp_layer", fused_mlp_layer, mlp_layer_reference, (x, *ln, *mlp_w), {}, shape,
                 bound_ms(2 * el * M * W + el * 2 * W * Wh + 4 * (Wh + 3 * W), 4 * M * W * Wh, peak)),
                ("fused_mlp_layer_i8", fused_mlp_layer_i8, mlp_layer_i8_reference, (x, *ln, *_quantized(mlp_w)),
                 {}, shape,
                 bound_ms_of(2 * el * M * W + 2 * W * Wh + 4 * (2 * Wh + 4 * W), 4 * M * W * Wh / PEAK_INT8_OPS)),
            ]
        for name, kernel, plain, args, kw, shape, (bms, by) in cases:
            run_k = lambda: kernel(*args, **kw)
            run_p = lambda: plain(*args, **kw)
            abs_err, rel_err = _layer_error(run_k(), run_p())
            tol = F32_LAYER_TOL if dt == f32 and not name.endswith("_i8") else LAYER_TOL
            if not rel_err <= tol:
                raise AssertionError(f"{name} {shape} disagrees: {abs_err:.3e} abs, {rel_err:.3e} scaled (tol {tol})")
            k_ms, p_ms = time_ms(run_k), time_ms(run_p)
            row = {"shape": shape, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bms, "bound_by": by,
                   "max_abs_err": abs_err}
            if name.endswith("_i8"):
                lib_ms, layout, both = _int_mm_ms(M, args)
                row.update(library_ms=lib_ms, library_layout=layout, library_ms_by_layout=both,
                           plans=_i8_plans(M, args))
                lib = (f"library_ms(GEMM only, torch._int_mm, weight {layout})={lib_ms:.4f} "
                       f"[by layout {both}] plans(int8 GEMMs)={row['plans']}")
            else:
                lib_ms = row["library_ms"] = _mm_ms(M, args)
                row["plans"] = _bf16_plans(M, args) if dt == bf16 else "f32 CUDA-core GEMM"
                lib = (f"library_ms(GEMM only, cuBLAS {'f32' if dt == f32 else 'bf16'})={lib_ms:.4f} "
                       f"plans(GEMMs)={row['plans']}")
            rows[name].append(row)
            log(f"kernel {name} {shape}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                f"bound_ms={bms:.5f} ({by}) max_abs_err={abs_err:.3e} scaled_err={rel_err:.3e} " + lib)
    for name, shapes in rows.items():
        results[name] = {"shapes": shapes}
    results.update(phase_qwen_kernels(rng, dev))
    results.update(phase_w8_kernels(dev))
    results.update(phase_dsv2_kernels(dev))
    results.update(phase_decode_fused_kernels(dev))
    results.update(phase_dsv2_fused_kernels(dev))
    kimi = phase_kda_kernels(dev)
    for name in ("moe_route", "mla_decode_attention"):  # beside DeepSeek-V2's shapes
        results[name]["shapes"] += kimi.pop(name)["shapes"]
    results.update(kimi)
    nemotron = phase_nemotron_kernels(dev)
    for name in ("moe_route", "decode_gqa_attention_stacked"):  # beside DeepSeek-V2's and Qwen2's shapes
        results[name]["shapes"] += nemotron.pop(name)["shapes"]
    results.update(nemotron)
    results.update(phase_mha_topk_kernels(dev))
    for name, shapes in phase_f1_shapes(dev).items():
        results[name]["shapes"] += shapes
    return results


# Shapes the JAX kernels take that the tiled kernels do not (head widths
# off 32 / 64, widths off a multiple of 8 / 16, decode R > 8 and head
# widths off {16, 32, 64, 128}, bank_topk D % 8 != 0 and k > 128): each
# wrapper fits them to its kernels (the attention's tail path, zero-padded
# GEMM operands, k in passes) and is held to its plain
# version: f32 to F1_F32_TOL of max(1, |plain|) (sums in another order),
# bf16 to 1e-2 (one bf16 ulp), the int8 layers to LAYER_TOL, the W8A8
# GEMM and the top-k exactly (small-integer top-k operands: exact scores).
F1_F32_TOL = 2e-5


# Nemotron-H's kernels against their plain versions, each tolerance the card
# test's (tests/test_torch_nemotron_cuda.py): ssm_prepare's window
# bit-equal, its steps within f32 rounding and x | B | C within one bf16
# step; ssm_recurrent's state within SSM_STATE_TOL of values of scale ~0.3
# and its bf16 output within one bf16 step (SSM_BF16_TOL relative);
# ssm_gated_norm within one bf16 step; relu2 and qkv_cache bit-equal. A
# dropped decay, a head reading another group or a missed pad moves them
# by O(0.1). The routing at 128 experts bit-equal; the decode attention at
# 16 query heads a KV head (the tail kernel) DECODE_TOL's.
NEMOTRON_ROWS, NEMOTRON_PROMPTS, NEMOTRON_SUFFIX, NEMOTRON_PREFIX = 640, 128, 24, 14
SSM_STATE_TOL, SSM_BF16_TOL = 1e-5, 2 ** -7


def phase_nemotron_kernels(dev) -> dict:
    """Nemotron-H's own kernels at the tvc-nemotron3-nano-30b-w8.fresh128
    cell's shapes, each held against its plain version on the same card
    inputs and timed beside the bound from perfbench/work_ssm.py (bytes, or
    the f32 products at 67 TF/s: the larger): ssm_prepare and ssm_recurrent
    at a decode step (640 rows, one token), the prompts' suffixes (128 rows
    of up to 24 tokens, real lengths 1..24) and the shared prefix (one row
    of 14), 64 heads of 64, a 64 x 128 f32 state and 8 groups;
    ssm_gated_norm at 640 and 128 x 24 rows; relu2 over the routed experts'
    3,840 x 1,856 and the shared expert's 640 x 3,712; qkv_cache at 640
    rows, 2 KV heads of 128 and 32 query heads; the sigmoid routing with the
    correction bias and renormalisation at 128 experts, top 6, hidden 2,688
    (640 rows and a prefill's 3,072), every output bit-equal; the decode
    attention over the stacked cache at 640 rows, 2 KV heads of 16 query
    heads, D 128, S 64."""
    import torch

    from perfbench import work_ssm
    from tvc_torch.core.kernels import decode_fused_kernel as fk
    from tvc_torch.core.kernels import dsv2_fused_kernel as dk
    from tvc_torch.core.kernels import ssm_kernel as sk
    from tvc_torch.core.kernels.decode_attention_kernel import decode_gqa_attention_stacked, decode_gqa_reference
    from tvc_torch.models.nemotron_h import NemotronHConfig

    c = NemotronHConfig.nemotron3_nano_30b()
    nh, P, N, G, K = c.mamba_heads, c.mamba_head_dim, c.ssm_state, c.ssm_groups, c.conv_size
    I, C = c.ssm_width, c.conv_channels
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(27)
    t = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    out = {n: {"shapes": []} for n in (*NEMOTRON, "moe_route", "decode_gqa_attention_stacked")}

    for tag, (B, T, ragged) in {"decode": (NEMOTRON_ROWS, 1, False),
                                "suffix": (NEMOTRON_PROMPTS, NEMOTRON_SUFFIX, True),
                                "prefix": (1, NEMOTRON_PREFIX, False)}.items():
        y = t(B, T, c.ssm_in_width)
        y[..., I + C :] -= 2.0
        y = y.to(bf)
        conv_w, conv_b, dt_bias = 0.5 * t(C, K), 0.1 * t(C), 0.5 * t(nh)
        a_log, d = torch.log(1 + 15 * torch.rand(nh, generator=gen, device=dev)), 1 + 0.1 * t(nh)
        window, state = t(B, K - 1, C).to(bf), 0.1 * t(B, nh, P, N)
        lengths = torch.randint(1, T + 1, (B,), generator=gen, device=dev) if ragged else None
        shape = f"{tag}: rows={B} T={T}{' real lengths 1..' + str(T) if ragged else ''} heads {nh} of {P}, N {N}"
        n = int(lengths.sum()) if ragged else B * T
        w_k, w_p = window.clone(), window.clone()
        got = sk.ssm_prepare(y, conv_w, conv_b, dt_bias, w_k, lengths, I, I + C)
        want = sk.ssm_prepare_reference(y, conv_w, conv_b, dt_bias, w_p, lengths, I, I + C)
        torch.cuda.synchronize()
        if not torch.equal(w_k, w_p):
            raise AssertionError(f"ssm_prepare {shape}: the window differs from the plain version")
        err = max(close("ssm_prepare", shape + " (x | B | C)", got[0], want[0], SSM_BF16_TOL, 1e-6),
                  close("ssm_prepare", shape + " (dt)", got[1], want[1], 1e-6, 1e-7))
        w_t = window.clone()
        record_kernel(out, "ssm_prepare", shape,
                      lambda: sk.ssm_prepare(y, conv_w, conv_b, dt_bias, w_t, lengths, I, I + C),
                      lambda: sk.ssm_prepare_reference(y, conv_w, conv_b, dt_bias, w_t, lengths, I, I + C),
                      work_ssm.prepare(B, T, C, nh, K, n), err)
        xbc, dt = want
        s_k, s_p = state.clone(), state.clone()
        o_k = sk.ssm_recurrent(xbc, dt, a_log, d, s_k, lengths, G, bf)
        o_p = sk.ssm_recurrent_reference(xbc, dt, a_log, d, s_p, lengths, G, bf)
        torch.cuda.synchronize()
        err = max(close("ssm_recurrent", shape + " (y)", o_k, o_p, SSM_BF16_TOL, 1e-5),
                  close("ssm_recurrent", shape + " (state)", s_k, s_p, 0.0, SSM_STATE_TOL))
        if ragged and o_k[torch.arange(T, device=dev)[None] >= lengths[:, None]].any():
            raise AssertionError(f"ssm_recurrent {shape}: a pad's output is not zero")
        s_t = state.clone()
        record_kernel(out, "ssm_recurrent", shape, lambda: sk.ssm_recurrent(xbc, dt, a_log, d, s_t, lengths, G, bf),
                      lambda: sk.ssm_recurrent_reference(xbc, dt, a_log, d, s_t, lengths, G, bf),
                      work_ssm.recurrent(B, T, nh, P, N, G, n), err)
        if tag != "prefix":
            o, w = t(B, T, I).to(bf), 1 + 0.1 * t(I)
            err = close("ssm_gated_norm", shape, sk.ssm_gated_norm(o, y, w, G, c.rms_eps),
                        sk.ssm_gated_norm_reference(o, y, w, G, c.rms_eps), SSM_BF16_TOL, 1e-6)
            record_kernel(out, "ssm_gated_norm", shape, lambda: sk.ssm_gated_norm(o, y, w, G, c.rms_eps),
                          lambda: sk.ssm_gated_norm_reference(o, y, w, G, c.rms_eps), work_ssm.gated_norm(B, T, I), err)
        del y, window, state, xbc, dt, s_k, s_p, s_t, o_k, o_p
    k = c.num_experts_per_tok
    for rows, width, tag in ((NEMOTRON_ROWS * k, c.moe_intermediate_size, "routed experts"),
                             (NEMOTRON_ROWS, c.shared_intermediate_size, "shared expert")):
        u = t(rows, width).to(bf)
        hold_bit_equal(out, "relu2", f"{tag}: {rows} x {width} bf16", lambda: fk.relu2(u),
                       lambda: fk.relu2_reference(u), work_ssm.relu2(rows * width)[1])
    B, L, kv, D, S = NEMOTRON_ROWS, len(c.blocks("*")), c.num_kv_heads, c.head_dim, 64
    qkv = t(B, 1, (c.num_heads + 2 * kv) * D).to(bf)
    ck, cv = t(L, B, kv, S, D).to(bf), t(L, B, kv, S, D).to(bf)
    hold_bit_equal(out, "qkv_cache", f"rows={B} heads {c.num_heads} / {kv} of {D}, block {L - 1} of {L}, slot 40 of "
                   f"{S} bf16", lambda: fk.qkv_cache(qkv, ck, cv, L - 1, 40),
                   lambda: fk.qkv_cache_reference(qkv, ck.clone(), cv.clone(), L - 1, 40),
                   2 * 2 * B * (c.num_heads + 2 * kv) * D)
    R = c.num_heads // kv
    q = t(B, kv, R, D).to(bf)
    mask = torch.zeros((B, S), device=dev)
    mask[:, 48:60] = float("-inf")
    got = decode_gqa_attention_stacked(q, ck, cv, mask, L - 1)
    want = decode_gqa_reference(q, ck[L - 1], cv[L - 1], mask)
    again = decode_gqa_attention_stacked(q, ck, cv, mask, L - 1)
    torch.cuda.synchronize()
    abs_err, rel_err = _layer_error(got, want)
    if not (rel_err <= DECODE_TOL and torch.equal(got, again)):
        raise AssertionError(f"decode_gqa_attention_stacked at R {R} disagrees with its plain version or itself: "
                             f"{abs_err:.3e} abs, {rel_err:.3e} scaled (tol {DECODE_TOL})")
    shape = f"Nemotron-H block {L - 1} of {L} B={B} KV={kv} R={R} S={S} D={D}"
    record_kernel(out, "decode_gqa_attention_stacked", shape,
                  lambda: decode_gqa_attention_stacked(q, ck, cv, mask, L - 1),
                  lambda: decode_gqa_reference(q, ck[L - 1], cv[L - 1], mask),
                  work_ssm.gqa_decode(B, S, kv, R, D), abs_err)
    H, E = c.hidden_size, c.n_routed_experts
    for n in (NEMOTRON_ROWS, NEMOTRON_PROMPTS * NEMOTRON_SUFFIX):
        lg, x, bias = 2 * t(n, E), t(n, H).to(bf), 0.1 * t(E)
        hold_bit_equal(out, "moe_route", f"rows={n} experts {E} top {k} hidden {H} sigmoid, bias, renormalised bf16",
                       lambda: dk.moe_route(lg, x, k, None, "sigmoid", bias, True),
                       lambda: dk.moe_route_reference(lg, x, k, None, "sigmoid", bias, True),
                       4 * n * E + 4 * E + 2 * n * H + 2 * n * k * H + 16 * n * k)
    return out


def phase_f1_shapes(dev) -> dict:
    """The repaired shapes, each launched, held to its plain version and
    timed, with the copies and launches a call makes."""
    import torch

    from tvc_torch.core import kernels as tk

    rng = np.random.default_rng(11)
    f32, bf16 = torch.float32, torch.bfloat16

    def t(*shape, dtype=f32, scale=1.0):
        return (torch.as_tensor(rng.standard_normal(shape).astype(np.float32)) * scale).to(dev, dtype)

    def layer(W, Wh, dt):
        ln = (1 + 0.1 * t(W), 0.1 * t(W))
        attn = (t(W, 3 * W, dtype=dt, scale=W ** -0.5), 0.02 * t(3 * W), t(W, W, dtype=dt, scale=W ** -0.5),
                0.02 * t(W))
        mlp = (t(W, Wh, dtype=dt, scale=W ** -0.5), 0.02 * t(Wh), t(Wh, W, dtype=dt, scale=Wh ** -0.5), 0.02 * t(W))
        return ln, attn, mlp

    out = {}

    def hold(name, owner, shape, run_k, run_p, tol, nbytes, t_ops):
        copies, launches = getattr(owner, "copies", 0), owner.launches
        got = run_k()
        torch.cuda.synchronize()
        copies, launches = getattr(owner, "copies", 0) - copies, owner.launches - launches
        want = run_p()
        if isinstance(got, tuple):  # top-k: values and indices exactly
            abs_err = float((got[0] - want[0]).abs().max())
            ok = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            rel_err = abs_err
        else:
            abs_err, rel_err = _layer_error(got, want)
            ok = torch.equal(got, want) if tol == 0 else rel_err <= tol
        if not ok:
            raise AssertionError(f"{name} {shape} disagrees with its plain version: {abs_err:.3e} abs, "
                                 f"{rel_err:.3e} scaled (tol {tol})")
        k_ms, p_ms = time_ms(run_k), time_ms(run_p)
        bms, by = bound_ms_of(nbytes, t_ops)
        row = {"shape": f"F1 {shape}", "ms": k_ms, "plain_ms": p_ms, "bound_ms": bms, "bound_by": by,
               "max_abs_err": abs_err, "copies_per_call": copies, "launches_per_call": launches}
        out.setdefault(name, []).append(row)
        log(f"kernel {name} F1 {shape}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={bms:.5f} ({by}) "
            f"max_abs_err={abs_err:.3e} scaled_err={rel_err:.3e} copies/call={copies} launches/call={launches}")

    # fused_mha: head width 48 (the JAX-checked case) in f32, 96 in bf16
    for B, T, H, D, dt in ((2, 7, 3, 48, f32), (16, 77, 8, 96, bf16)):
        q, k, v = (t(B, T, H, D, dtype=dt) for _ in range(3))
        el, peak = (4, PEAK_F32_FLOPS) if dt == f32 else (2, PEAK_BF16_FLOPS)
        hold("fused_mha", tk.fused_mha, f"{'f32' if dt == f32 else 'bf16'} B={B} T={T} H={H} D={D}",
             lambda: tk.fused_mha(q, k, v), lambda: tk.mha_reference(q, k, v),
             F1_F32_TOL if dt == f32 else 1e-2, 4 * el * B * T * H * D, 4 * B * H * T * T * D / peak)
    # the four layer kernels: W = 36, three heads of 12 (bf16 GEMM widths
    # off a multiple of 8: padded), W = 40 two heads of 20 (int8 GEMM
    # widths off a multiple of 16: padded), f32 and bf16
    for W, H, Wh, dt in ((36, 3, 60, bf16), (36, 3, 60, f32), (40, 2, 24, bf16)):
        B, T = 4, 16
        ln, attn, mlp = layer(W, Wh, dt)
        x = t(B, T, W, dtype=dt)
        el, peak = (4, PEAK_F32_FLOPS) if dt == f32 else (2, PEAK_BF16_FLOPS)
        tol = F1_F32_TOL if dt == f32 else 1e-2
        tag = f"{'f32' if dt == f32 else 'bf16'} B={B} T={T} W={W}"
        M, attn_ops = B * T, 4 * B * T * T * W
        hold("fused_attention_layer", tk.fused_attention_layer, f"{tag} H={H}",
             lambda: tk.fused_attention_layer(x, *ln, *attn, heads=H),
             lambda: tk.attention_layer_reference(x, *ln, *attn, heads=H), tol,
             2 * el * M * W + el * 4 * W * W + 4 * 6 * W, (2 * M * W * 4 * W + attn_ops) / peak)
        hold("fused_mlp_layer", tk.fused_mlp_layer, f"{tag} Wh={Wh}", lambda: tk.fused_mlp_layer(x, *ln, *mlp),
             lambda: tk.mlp_layer_reference(x, *ln, *mlp), tol,
             2 * el * M * W + el * 2 * W * Wh + 4 * (Wh + 3 * W), 4 * M * W * Wh / peak)
        if dt == bf16:  # the GEMMs at the int8 rate, the attention at the operands' rate
            a8, m8 = _quantized(attn), _quantized(mlp)
            hold("fused_attention_layer_i8", tk.fused_attention_layer_i8, f"{tag} H={H}",
                 lambda: tk.fused_attention_layer_i8(x, *ln, *a8, heads=H),
                 lambda: tk.attention_layer_i8_reference(x, *ln, *a8, heads=H), LAYER_TOL,
                 2 * el * M * W + 4 * W * W + 4 * 10 * W, 2 * M * W * 4 * W / PEAK_INT8_OPS + attn_ops / peak)
            hold("fused_mlp_layer_i8", tk.fused_mlp_layer_i8, f"{tag} Wh={Wh}",
                 lambda: tk.fused_mlp_layer_i8(x, *ln, *m8), lambda: tk.mlp_layer_i8_reference(x, *ln, *m8),
                 LAYER_TOL, 2 * el * M * W + 2 * W * Wh + 4 * (2 * Wh + 4 * W), 4 * M * W * Wh / PEAK_INT8_OPS)
    # the decode attention on its tail path: R = 9, head width 48, the
    # JAX-checked case, in bf16 and f32; head width 200 at R = 12
    for (B, KV, R, S, D), dt in (((2, 2, 9, 20, 48), bf16), ((2, 2, 9, 20, 48), f32), ((2, 2, 12, 70, 200), bf16)):
        q, k, v = t(B, KV, R, D, dtype=dt), t(B, KV, S, D, dtype=dt), t(B, KV, S, D, dtype=dt)
        mask = torch.zeros((B, S), device=dev)
        el, peak = (4, PEAK_F32_FLOPS) if dt == f32 else (2, PEAK_BF16_FLOPS)
        hold("decode_gqa_attention", tk.decode_gqa_attention,
             f"{'f32' if dt == f32 else 'bf16'} B={B} KV={KV} R={R} S={S} D={D}",
             lambda: tk.decode_gqa_attention(q, k, v, mask), lambda: tk.decode_gqa_reference(q, k, v, mask),
             F1_F32_TOL if dt == f32 else DECODE_TOL, el * (2 * B * KV * R * D + 2 * B * KV * S * D) + 4 * B * S,
             4 * B * KV * R * S * D / peak)
    # bank_topk: D = 12 (padded to 16), k = 130 (passes of 128 and 2), the
    # JAX-checked case; small integers, so every score is exact
    B, N, D, K = 3, 500, 12, 130
    q = torch.as_tensor(rng.integers(-3, 4, (B, D)).astype(np.float32), device=dev)
    bank = torch.as_tensor(rng.integers(-3, 4, (N, D)).astype(np.float32), device=dev)
    hold("bank_topk", tk.bank_topk, f"B={B} N={N} D={D} k={K} small-integer operands",
         lambda: tk.bank_topk(q, bank, K, normalize=False),
         lambda: tk.bank_topk_reference(q, bank, K, normalize=False), 0, 4 * (B * D + N * D) + 8 * B * K,
         2 * B * N * D / PEAK_F32_FLOPS)
    # the int8 GEMMs at K = 40, N = 24 (the JAX-checked case): K and N
    # zero-padded to 48 and 32
    for dt in (bf16, f32):
        M, K_, N_ = 6, 40, 24
        x = t(M, K_, dtype=dt)
        w_q, sc = tk.quantize_linear(t(K_, N_))
        el = 4 if dt == f32 else 2
        tag = f"{'f32' if dt == f32 else 'bf16'} M={M} K={K_} N={N_}"
        hold("w8a8_matmul", tk.w8a8_matmul, tag, lambda: tk.w8a8_matmul(x, w_q, sc),
             lambda: tk.w8a8_matmul_reference(x, w_q, sc), 0, el * (M * K_ + M * N_) + K_ * N_ + 4 * N_,
             2 * M * K_ * N_ / PEAK_INT8_OPS)
        if dt == bf16:
            hold("w8_matmul", tk.w8_matmul, tag, lambda: tk.w8_matmul(x, w_q, sc),
                 lambda: tk.w8_matmul_plain(x, w_q, sc), 1e-2, el * (M * K_ + M * N_) + K_ * N_ + 4 * N_,
                 2 * M * K_ * N_ / PEAK_BF16_FLOPS)
    return out


def _int_mm_layouts_ms(pairs) -> tuple:
    """``torch._int_mm`` on each (a [M, K], w [K, N] row-major) pair, one
    after the other, with w as it lies and with w K-major (a column-major
    view of an [N, K] contiguous copy, made outside the timed call: the
    layout cuBLASLt's int8 kernels take). Returns (the faster ms, its
    layout's name, {layout: ms}); a layout PyTorch refuses counts as None."""
    import torch

    kmajor = [(a, w.t().contiguous().t()) for a, w in pairs]
    times = {}
    for layout, ops in (("row-major", pairs), ("K-major", kmajor)):
        try:
            times[layout] = time_ms(lambda: [torch._int_mm(a, w) for a, w in ops])
        except RuntimeError:
            times[layout] = None
    best = min((t, layout) for layout, t in times.items() if t is not None)
    return best[0], best[1], times


def _int_mm_ms(M: int, args) -> tuple:
    """GEMM-only yardstick of an int8 layer: torch._int_mm on int8
    operands of its two GEMMs' shapes (the layer's int8 weights and
    random int8 activations), one after the other, in both weight
    layouts (:func:`_int_mm_layouts_ms`)."""
    import torch

    w1, w2 = args[3], args[6]
    a1 = torch.randint(-127, 128, (M, w1.shape[0]), dtype=torch.int8, device=w1.device)
    a2 = torch.randint(-127, 128, (M, w2.shape[0]), dtype=torch.int8, device=w2.device)
    return _int_mm_layouts_ms([(a1, w1), (a2, w2)])


def _i8_plans(M: int, args) -> str:
    """The int8 GEMM's plan for each of an int8 layer's two GEMMs."""
    from tvc_torch.core.kernels.w8_matmul_kernel import i8_plan

    w1, w2 = args[3], args[6]
    return " / ".join(_plan_str(i8_plan(M, w.shape[1], w.shape[0])) for w in (w1, w2))


def _plan_str(plan, depth: int = 128) -> str:
    bm, bn, splits, per = plan
    return f"{bm}x{bn} tiles, {splits} split{'s' if splits > 1 else ''} of {per} {depth}-deep k-tiles"


def _mm_ms(M: int, args) -> float:
    """GEMM-only yardstick of a bf16 or f32 layer: cuBLAS on operands of
    its two GEMMs' shapes and dtype (the layer's weights and random
    activations; f32 without TF32), one after the other."""
    import torch

    w1, w2 = args[3], args[5]
    a1 = torch.randn((M, w1.shape[0]), dtype=w1.dtype, device=w1.device)
    a2 = torch.randn((M, w2.shape[0]), dtype=w2.dtype, device=w2.device)
    return time_ms(lambda: (a1 @ w1, a2 @ w2))


def _bf16_plans(M: int, args) -> str:
    """The bf16 GEMM's plan for each of a bf16 layer's two GEMMs."""
    from tvc_torch.core.kernels.attention_layer_kernel import bf16_plan

    w1, w2 = args[3], args[5]
    return " / ".join(_plan_str(bf16_plan(M, w.shape[1], w.shape[0]), 64) for w in (w1, w2))


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
    of the suffix prefill (M = 192 x 24), held to equality (two calls
    bit-equal), each printed with its i8_plan tile and split and timed
    beside torch._int_mm in both weight layouts; the decode
    attention at B = 576 (Qwen2-7B: KV = 4, R = 7, D = 128, S = 64 and
    512; Qwen2-0.5B: KV = 2, R = 7, D = 64), at Qwen2-1.5B's B = 960, at
    one caption's 5 rows (B = 5) and over a long cache (B = 4, S = 16,384:
    S split across blocks), held to DECODE_TOL, two calls bit-equal; each
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
    from tvc_torch.core.kernels.decode_attention_kernel import decode_splits
    from tvc_torch.core.kernels.quantized_layer_kernel import _quant_rows
    from tvc_torch.core.kernels.w8_matmul_kernel import i8_plan

    bf = torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
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
        again = w8a8_matmul(x, w_q, scale)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if err != 0.0:
            raise AssertionError(f"w8a8_matmul {tag} M={M} K={K} N={N} differs from its plain version by {err}")
        if not torch.equal(got, again):
            raise AssertionError(f"w8a8_matmul {tag} M={M} K={K} N={N}: two calls differ")
        xq = _quant_rows(x.float())[0]  # the kernel's int8 operand
        k_ms = time_ms(lambda: w8a8_matmul(x, w_q, scale))
        p_ms = time_ms(lambda: w8a8_matmul_reference(x, w_q, scale), iters=5, warmup=1)
        lib_ms, layout, both = _int_mm_layouts_ms([(xq, w_q)])
        bms, by = _w8a8_bound(M, K, N)
        shape = f"{tag} M={M} K={K} N={N}"
        plan = _plan_str(i8_plan(M, N, K))
        out["w8a8_matmul"]["shapes"].append({"shape": shape, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bms,
                                             "bound_by": by, "max_abs_err": err, "library_ms": lib_ms,
                                             "library_layout": layout, "library_ms_by_layout": both,
                                             "plan": plan})
        log(f"kernel w8a8_matmul {shape}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={bms:.5f} ({by}) "
            f"max_abs_err={err:.3e} library_ms(GEMM only, torch._int_mm, weight {layout})={lib_ms:.4f} "
            f"[by layout {both}] plan={plan}")
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
    lib_ms, layout, both = _int_mm_layouts_ms([(xq, w_q[L - 1])])
    bms, by = _w8a8_bound(M, K, N)
    shape = f"q|k|v layer {L - 1} of {L} M={M} K={K} N={N}"
    plan = _plan_str(i8_plan(M, N, K))
    out["w8a8_matmul_stacked"]["shapes"].append({"shape": shape, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bms,
                                                 "bound_by": by, "max_abs_err": err, "library_ms": lib_ms,
                                                 "library_layout": layout, "library_ms_by_layout": both,
                                                 "plan": plan})
    log(f"kernel w8a8_matmul_stacked {shape}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={bms:.5f} "
        f"({by}) max_abs_err={err:.3e} library_ms(GEMM only, torch._int_mm, weight {layout})={lib_ms:.4f} "
        f"[by layout {both}] plan={plan}")
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
                                ("Qwen2-0.5B", 576, 2, 7, 64, 64), ("Qwen2-1.5B", 960, 2, 6, 64, 128),
                                ("one caption's rows, Qwen2-1.5B", 5, 2, 6, 64, 128),
                                ("long cache", 4, 4, 7, 16384, 128)):
        q, k, v, mask = decode_inputs(B, KV, R, S, D)
        got, want = decode_gqa_attention(q, k, v, mask), decode_gqa_reference(q, k, v, mask)
        again = decode_gqa_attention(q, k, v, mask)
        torch.cuda.synchronize()
        abs_err, rel_err = _layer_error(got, want)
        if not rel_err <= DECODE_TOL:
            raise AssertionError(f"decode_gqa_attention {tag} S={S} disagrees: {abs_err:.3e} abs, {rel_err:.3e} scaled")
        if not torch.equal(got, again):
            raise AssertionError(f"decode_gqa_attention {tag} S={S}: two calls differ")
        k_ms = time_ms(lambda: decode_gqa_attention(q, k, v, mask))
        p_ms = time_ms(lambda: decode_gqa_reference(q, k, v, mask))
        lib_ms = sdpa_ms(q, k, v, mask)
        bms, by = _decode_bound(B, KV, R, S, D)
        shape = f"{tag} B={B} KV={KV} R={R} S={S} D={D}"
        out["decode_gqa_attention"]["shapes"].append({"shape": shape, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bms,
                                                      "bound_by": by, "max_abs_err": abs_err, "library_ms": lib_ms})
        log(f"kernel decode_gqa_attention {shape}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={bms:.5f} "
            f"({by}) max_abs_err={abs_err:.3e} scaled_err={rel_err:.3e} library_ms(sdpa)={lib_ms} "
            f"splits={decode_splits(B * KV, S, sms)} two calls bit-equal")
        del q, k, v, mask, got, want, again
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


# f32 activations: both sides sum f32 products in f32 in another order
# (~1e-7 relative) and scale in f32; nothing rounds to bf16.
W8_F32_TOL = 1e-5


def _w8_bound(M, K, N, elem=2):
    """Bytes: x in, int8 weights and f32 scales in, the output out;
    operations: 2 M K N at the bf16 tensor-core rate (bf16 x) or the f32
    rate (f32 x, on the CUDA cores)."""
    return bound_ms(elem * (M * K + M * N) + K * N + 4 * N, 2 * M * K * N,
                    PEAK_BF16_FLOPS if elem == 2 else PEAK_F32_FLOPS)


def phase_w8_kernels(dev) -> dict:
    """The Qwen2-1.5B weight-only GEMM against its plain version: the four
    layer GEMMs of a decode step at M = 960 (192 captions x 5 paraphrases),
    the prefix prefill's M = 15 (gate|up; q|k|v and down split K), two
    calls held bit-equal; f32 activations at QwenConfig.tiny()'s layer
    shapes; the stacked wrapper on a 28-layer q|k|v stack, held equal to the
    flat kernel on the layer's view; and the tiny f32 Qwen decode through
    the kernel (qwen_tiny_f32). Library: cuBLAS x @ w on the weights
    dequantized to x's dtype beforehand (GEMM only)."""
    import torch

    from tvc_torch.core.kernels import quantize_linear, w8_matmul, w8_matmul_plain, w8_matmul_stacked

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(4)
    t = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    out = {"w8_matmul": {"shapes": []}, "w8_matmul_stacked": {"shapes": []}}
    L, H, I = 28, 1536, 8960

    def hold(name, tag, run_k, run_p, run_lib, M, K, N, tol=W8_TOL, elem=2):
        got, want = run_k(), run_p()
        again = run_k()
        torch.cuda.synchronize()
        abs_err, rel_err = _layer_error(got, want)
        if not rel_err <= tol:
            raise AssertionError(f"{name} {tag} disagrees with its plain version: {abs_err:.3e} abs, "
                                 f"{rel_err:.3e} scaled")
        if not torch.equal(got, again):
            raise AssertionError(f"{name} {tag}: two calls differ")
        k_ms, p_ms, lib_ms = time_ms(run_k), time_ms(run_p, iters=5, warmup=1), time_ms(run_lib)
        bms, by = _w8_bound(M, K, N, elem)
        shape = f"{tag} M={M} K={K} N={N}"
        out[name]["shapes"].append({"shape": shape, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bms, "bound_by": by,
                                    "max_abs_err": abs_err, "library_ms": lib_ms})
        log(f"kernel {name} {shape}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={bms:.5f} ({by}) "
            f"max_abs_err={abs_err:.3e} scaled_err={rel_err:.3e} library_ms(GEMM only, cuBLAS bf16)={lib_ms:.4f}")

    for tag, M, K, N, dt in (
        ("q|k|v", 960, H, 2048, bf), ("o", 960, H, H, bf), ("gate|up", 960, H, 2 * I, bf),
        ("down", 960, I, H, bf), ("gate|up prefix prefill", 15, H, 2 * I, bf),
        ("q|k|v prefix prefill", 15, H, 2048, bf), ("down prefix prefill", 15, I, H, bf),
        ("tiny f32 q|k|v", 64, 64, 128, torch.float32), ("tiny f32 o", 64, 64, 64, torch.float32),
        ("tiny f32 gate|up", 64, 64, 256, torch.float32), ("tiny f32 down", 64, 128, 64, torch.float32),
    ):
        x = t(M, K).to(dt)
        w_q, scale = quantize_linear(t(K, N) / math.sqrt(K))
        w_dq = w_q.to(dt) * scale.to(dt)
        f32 = dt == torch.float32
        hold("w8_matmul", tag, lambda: w8_matmul(x, w_q, scale), lambda: w8_matmul_plain(x, w_q, scale),
             lambda: x @ w_dq, M, K, N, tol=W8_F32_TOL if f32 else W8_TOL, elem=4 if f32 else 2)
        del w_q, scale, w_dq
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
    del x, w_q, scale, w_bf
    qwen_tiny_f32()
    return out


# DeepSeek-V2's grouped expert GEMM against its plain version: W8_TOL's
# reasoning holds for each expert's rows (the same exact products summed in
# f32 in another order, rounded once to bf16); a row sent through another
# expert's weights, or a tile that drops its rows, is O(1). The latent
# attention: DECODE_TOL's (the kernel rounds the softmax weights to bf16
# before the product); a missed rope term or a wrong scale moves the
# weights by O(1).
DSV2_ROWS, DSV2_TOPK, DSV2_EXPERTS = 960, 6, 64
DSV2_BUSIEST = 650  # rows of the busiest expert of a layer-step in the cell (expert_load.moe ~7.25)
MOE_PREFIX = 16  # about the tokens of the paraphrase prompts' shared prefix, prefilled once at batch 1


def moe_spread(case: str):
    """Rows an expert (numpy int64) of a grouped-GEMM case, from the seed 0:
    DeepSeek-V2's decode step as the cell routes it (5,760 rows over 64
    experts: DSV2_BUSIEST in one, two empty, the rest even; ``dsv2_step``),
    a rougher decode spread (empty experts, one with 1,000 more;
    ``dsv2_decode``) and a prefill (18,432 rows, two empty); Kimi-Linear's
    decode (3,840 rows over 256 experts: empty experts, one-row experts, one
    of 240 rows) and prefill (18,432 rows); Nemotron-H's decode (3,840 rows
    over 128 experts: empty experts, one-row experts, one of 120 rows) and
    prefill (18,432 rows); and each model's prefill of the shared
    paraphrase prefix (``*_prefix``: MOE_PREFIX tokens, each to its
    top-k distinct experts, most experts empty)."""
    rng = np.random.default_rng(0)
    if case.endswith("_prefix"):
        E, k = {"dsv2_prefix": (DSV2_EXPERTS, DSV2_TOPK), "nemotron_prefix": (128, 6)}.get(case, (256, 8))
        counts = np.zeros(E, np.int64)
        for _ in range(MOE_PREFIX):
            counts[rng.choice(E, k, replace=False)] += 1
        return counts
    if case == "dsv2_step":
        M = DSV2_ROWS * DSV2_TOPK
        counts = np.zeros(DSV2_EXPERTS, np.int64)
        counts[0] = DSV2_BUSIEST
        rest = [e for e in range(1, DSV2_EXPERTS) if e not in (17, 40)]
        counts[rest] = np.random.default_rng(21).multinomial(M - DSV2_BUSIEST, np.full(len(rest), 1 / len(rest)))
    elif case == "dsv2_decode":
        counts = rng.multinomial(4760, rng.dirichlet(np.full(64, 0.5)))
        counts[[3, 17]] = 0
        counts[40] += 1000
    elif case == "dsv2_prefill":
        counts = rng.multinomial(18432, rng.dirichlet(np.full(64, 2.0)))
        counts[[5, 60]] = 0
    elif case == "kimi_decode":
        counts = rng.multinomial(3840 - 240 - 8, rng.dirichlet(np.full(256, 0.7)))
        counts[[7, 77, 177]] = 0
        counts[[1, 2, 100, 200, 255]] = 1
        counts[3] = 240
        counts[0] += 3840 - int(counts.sum())
    elif case == "kimi_prefill":
        counts = rng.multinomial(18432, rng.dirichlet(np.full(256, 1.0)))
        counts[[9, 99]] = 0
    elif case == "nemotron_decode":
        counts = rng.multinomial(3840 - 120, rng.dirichlet(np.full(128, 1.0)))
        counts[[5, 50]] = 0
        counts[[1, 127]] = 1
        counts[2] = 120
        counts[0] += 3840 - int(counts.sum())
    else:  # nemotron_prefill
        counts = rng.multinomial(18432, rng.dirichlet(np.full(128, 1.0)))
        counts[[9, 99]] = 0
    return counts


#: the grouped GEMM's shapes the kernel phase times: (spread, tag, E, K, N);
#: between them they run every row tile moe_plan picks
MOE_CASES = (
    ("dsv2_step", "dsv2 decode gate|up", 64, 2048, 2816), ("dsv2_step", "dsv2 decode down", 64, 1408, 2048),
    ("dsv2_prefill", "dsv2 prefill gate|up", 64, 2048, 2816),
    ("dsv2_prefix", "dsv2 prefix prefill gate|up", 64, 2048, 2816),
    ("kimi_decode", "kimi decode gate|up", 256, 2304, 2048), ("kimi_decode", "kimi decode down", 256, 1024, 2304),
    ("kimi_prefill", "kimi prefill gate|up", 256, 2304, 2048),
    ("kimi_prefix", "kimi prefix prefill gate|up", 256, 2304, 2048),
    ("nemotron_decode", "nemotron decode up", 128, 2688, 1856),
    ("nemotron_decode", "nemotron decode down", 128, 1856, 2688),
    ("nemotron_prefill", "nemotron prefill up", 128, 2688, 1856),
    ("nemotron_prefix", "nemotron prefix prefill up", 128, 2688, 1856),
)


def phase_dsv2_kernels(dev) -> dict:
    """DeepSeek-V2-Lite's two kernels at the tvc-dsv2-lite-w8.fresh decode
    step's shapes, each held against its plain version on the same card
    inputs, two calls bit-equal, timed beside the bound from
    perfbench/work_moe.py's counts: the grouped w8 expert GEMM (MOE_CASES:
    DeepSeek-V2-Lite's gate|up, K 2,048, N 2,816, and down, K 1,408, N
    2,048, over 5,760 decode rows as ``moe_spread("dsv2_step")`` splits
    them, and gate|up over a prefill's 18,432 and over the shared prefix's
    96; Kimi-Linear's gate|up, K 2,304, N 2,048, and down, K 1,024, N
    2,304, over 3,840 decode rows and 256 experts, and gate|up over a
    prefill's 18,432 and over the shared prefix's 128); the latent
    decode attention at B 960, S 64 over layer 26 of a 27-layer cache, 12
    slots masked."""
    import torch

    from perfbench import work, work_moe
    from tvc_torch.core.kernels import (
        mla_decode_attention,
        mla_decode_reference,
        moe_w8_grouped_gemm,
        moe_w8_grouped_reference,
        quantize_linear,
    )
    from tvc_torch.core.kernels.moe_kernel import moe_plan
    from tvc_torch.models.deepseek_v2 import DeepseekV2Config

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(21)
    t = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    out = {"moe_w8_grouped_gemm": {"shapes": []}, "mla_decode_attention": {"shapes": []}}

    def hold(name, shape, run_k, run_p, tol, ops, nbytes):
        got, want = run_k(), run_p()
        again = run_k()
        torch.cuda.synchronize()
        abs_err, rel_err = _layer_error(got, want)
        if not rel_err <= tol:
            raise AssertionError(f"{name} {shape} disagrees with its plain version: {abs_err:.3e} abs, "
                                 f"{rel_err:.3e} scaled (tol {tol})")
        if not torch.equal(got, again):
            raise AssertionError(f"{name} {shape}: two calls differ")
        k_ms, p_ms = time_ms(run_k), time_ms(run_p, iters=5, warmup=1)
        bms, by = bound_ms_of(nbytes, work.peak_seconds(ops))
        out[name]["shapes"].append({"shape": shape, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bms, "bound_by": by,
                                    "max_abs_err": abs_err})
        log(f"kernel {name} {shape}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={bms:.5f} ({by}) "
            f"kernel at {100 * bms / k_ms:.1f}% of the bound, max_abs_err={abs_err:.3e} scaled_err={rel_err:.3e}")

    for case, tag, E, K, N in MOE_CASES:
        counts = moe_spread(case)
        M, busy = int(counts.sum()), int((counts > 0).sum())
        offsets = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32, device=dev)
        x = t(M, K).to(bf)
        w_q, scale = quantize_linear(t(E, K, N) / math.sqrt(K))
        plan = moe_plan(M, E, N, K)
        hold("moe_w8_grouped_gemm", f"{tag} M={M} K={K} N={N} E={E} (rows {int(counts.max())} to "
             f"{int(counts.min())} an expert; plan swap{plan.rows}, {plan.stages} stages)",
             lambda: moe_w8_grouped_gemm(x, w_q, scale, offsets),
             lambda: moe_w8_grouped_reference(x, w_q, scale, offsets), W8_TOL, *work_moe.expert_gemm(M, K, N, busy))
        del x, w_q, scale
    B, S, L = DSV2_ROWS, 64, 27
    q_lat, q_pe = t(B, 16, 512).to(bf), t(B, 16, 64).to(bf)
    cache = t(L, B, S, 576).to(bf)
    mask = torch.zeros((B, S), device=dev)
    mask[:, 48:60] = float("-inf")
    sm = DeepseekV2Config.deepseek_v2_lite().softmax_scale
    hold("mla_decode_attention", f"B={B} S={S} H=16 latent 512 rope 64, layer {L - 1} of {L}",
         lambda: mla_decode_attention(q_lat, q_pe, cache, mask, L - 1, sm),
         lambda: mla_decode_reference(q_lat, q_pe, cache, mask, L - 1, sm), DECODE_TOL, *work_moe.mla_decode(B, S))
    del q_lat, q_pe, cache
    return out


def record_kernel(out: dict, name: str, shape: str, run_k, run_p, ops_bytes, err: float) -> None:
    """A kernel and its plain version timed, beside the bound of ``ops_bytes``
    (``(operations, bytes)`` from ``perfbench``'s work models: bytes at 3.35
    TB/s or the operations at their peak, the larger), into ``out[name]``."""
    from perfbench import work

    k_ms, p_ms = time_ms(run_k), time_ms(run_p, iters=5, warmup=1)
    bms, by = bound_ms_of(ops_bytes[1], work.peak_seconds(ops_bytes[0]))
    out[name]["shapes"].append({"shape": shape, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bms, "bound_by": by,
                                "max_abs_err": err})
    log(f"kernel {name} {shape}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={bms:.5f} ({by}) "
        f"kernel at {100 * bms / k_ms:.1f}% of the bound, max_abs_err={err:.3e}")


def close(name: str, shape: str, got, want, rtol: float, atol: float) -> float:
    """``got`` within ``atol + rtol |want|`` of ``want`` everywhere, or raise;
    returns the largest absolute difference."""
    diff = (got.float() - want.float()).abs()
    bad = diff > atol + rtol * want.float().abs()
    if bad.any():
        raise AssertionError(f"{name} {shape}: {int(bad.sum())} elements beyond rtol {rtol} atol {atol}, max |d| "
                             f"{float(diff.max()):.3e}")
    return float(diff.max())


def hold_bit_equal(out: dict, name: str, shape: str, run_k, run_p, nbytes: float) -> None:
    """A kernel against its plain version on the same card inputs: every
    output bit-equal (an int64 output of the plain version, such as
    torch.topk's ids, against the kernel's int32), two calls bit-equal;
    then both timed, beside the bound from ``nbytes`` at 3.35 TB/s, into
    ``out[name]``."""
    import torch

    as_tuple = lambda r: r if isinstance(r, tuple) else (r,)  # noqa: E731
    got, want = as_tuple(run_k()), as_tuple(run_p())
    again = as_tuple(run_k())
    torch.cuda.synchronize()
    abs_err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
    if not all(torch.equal(a, b.to(a.dtype)) for a, b in zip(got, want)):
        raise AssertionError(f"{name} {shape} disagrees with its plain version: max |d| {abs_err:.3e}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name} {shape}: two calls differ")
    k_ms, p_ms = time_ms(run_k), time_ms(run_p)
    bms, by = bound_ms_of(nbytes, 0.0)
    out[name]["shapes"].append({"shape": shape, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bms, "bound_by": by,
                                "max_abs_err": abs_err})
    log(f"kernel {name} {shape}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={bms:.5f} ({by}) "
        f"kernel at {100 * bms / k_ms:.1f}% of the bound, bit-equal")


def phase_decode_fused_kernels(dev) -> dict:
    """The fused elementwise kernels of the decoder layers at the decode
    step's shapes (960 rows), each against its plain version on the same
    card inputs: the norms (Qwen2-1.5B's hidden 1,536, DeepSeek-V2-Lite's
    2,048 and its latent norm over a strided slice of the q|kv_a output,
    with the residual stream), the q|k|v epilogue (Qwen2-1.5B: 12 / 2
    heads of 128, layer 27 of a 28-layer cache of 64 slots) and the
    SiLU-gated products (Qwen2-1.5B's 8,960; DeepSeek-V2-Lite's 1,408 over
    5,760 routed rows, its 2,816 shared and 10,944 dense), every output
    bit-equal; two calls bit-equal; timed beside the bound from their
    bytes at 3.35 TB/s."""
    import torch

    import tvc_torch.models.qwen as qwen_mod
    from tvc_torch.core.kernels import decode_fused_kernel as fused

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(22)
    t = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    out = {n: {"shapes": []} for n in DECODE_FUSED}
    hold = lambda *a: hold_bit_equal(out, *a)  # noqa: E731

    R, eps = DSV2_ROWS, 1e-6
    for W in (1536, 2048):
        x, y, sc = (4 * t(R, W)).to(bf), t(R, W).to(bf), 1 + 0.1 * t(W)
        hold("rmsnorm", f"rows={R} W={W} bf16", lambda: fused.rmsnorm(x, sc, eps),
             lambda: fused.rmsnorm_reference(x, sc, eps), 2 * 2 * R * W + 4 * W)
        hold("add_rmsnorm", f"rows={R} W={W} bf16", lambda: fused.add_rmsnorm(x, y, sc, eps),
             lambda: fused.add_rmsnorm_reference(x, y, sc, eps), 4 * 2 * R * W + 4 * W)
    qa, sc = (4 * t(R, 3648)).to(bf), 1 + 0.1 * t(512)
    lat = qa[:, 3072:3584]
    hold("rmsnorm", f"rows={R} W=512 bf16, rows 3,648 apart (the latent norm)", lambda: fused.rmsnorm(lat, sc, eps),
         lambda: fused.rmsnorm_reference(lat, sc, eps), 2 * 2 * R * 512 + 4 * 512)

    nh, kv, D, L, S = 12, 2, 128, 28, 64
    Wq = (nh + 2 * kv) * D
    qkv, bias = (3 * t(R, 1, Wq)).to(bf), t(Wq)
    cos, sin = qwen_mod.rope_tables((torch.arange(R, device=dev)[:, None] % 61) + 3, D, 1_000_000.0)
    ck, cv = t(L, R, kv, S, D).to(bf), t(L, R, kv, S, D).to(bf)
    rk, rv = ck.clone(), cv.clone()

    def qkv_kernel():
        return fused.qkv_rope_cache(qkv, bias, cos, sin, ck, cv, L - 1, 40), ck[L - 1, :, :, 40], cv[L - 1, :, :, 40]

    def qkv_plain():
        q = fused.qkv_rope_cache_reference(qkv, bias, cos, sin, rk, rv, L - 1, 40)
        return q, rk[L - 1, :, :, 40], rv[L - 1, :, :, 40]

    hold("qkv_rope_cache", f"rows={R} heads {nh} / {kv} of {D}, layer {L - 1} of {L}, slot 40 of {S} bf16",
         qkv_kernel, qkv_plain, 2 * 2 * R * Wq + 4 * Wq + 2 * 4 * R * D // 2)
    del ck, cv, rk, rv
    for tag, rows, I in (("Qwen2-1.5B", R, 8960), ("DeepSeek-V2-Lite routed", R * DSV2_TOPK, 1408),
                         ("DeepSeek-V2-Lite shared", R, 2816), ("DeepSeek-V2-Lite dense", R, 10944)):
        gu = (3 * t(rows, 2 * I)).to(bf)
        hold("silu_mul", f"{tag} rows={rows} I={I} bf16", lambda: fused.silu_mul(gu, I),
             lambda: fused.silu_mul_reference(gu, I), 3 * 2 * rows * I)
    return out


def phase_dsv2_fused_kernels(dev) -> dict:
    """DeepSeek-V2-Lite's own decode-layer kernels at the
    tvc-dsv2-lite-w8.fresh decode step's shapes (960 rows), each against
    its plain version on the same card inputs, every output bit-equal, two
    calls bit-equal, timed beside the bound from their bytes at 3.35 TB/s:
    the q|kv_a epilogue (16 heads, latent 512, rope 64, cache layer 26 of
    27, slot 40 of 64), the output scales (16 heads of 128), the routing at
    960 rows and at a prefill's 3,072 (64 experts, top 6, hidden 2,048;
    logits drawn at unit scale) and the combine."""
    import torch

    from tvc_torch.core.kernels import dsv2_fused_kernel as dk
    from tvc_torch.models.deepseek_v2 import DeepseekV2Config, yarn_inv_freq, yarn_tables

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(24)
    t = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    out = {n: {"shapes": []} for n in DSV2_FUSED}
    hold = lambda *a: hold_bit_equal(out, *a)  # noqa: E731

    c = DeepseekV2Config.deepseek_v2_lite()
    R, nh, dn, dr, dv, r, H, E, k = (DSV2_ROWS, c.num_heads, c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim,
                                     c.kv_lora_rank, c.hidden_size, c.n_routed_experts, c.num_experts_per_tok)
    L, S, slot = c.num_layers, 64, 40
    W = nh * (dn + dr) + r + dr
    qa, suk, kvn = (3 * t(R, 1, W)).to(bf), 1e-2 * t(nh, dn).abs(), 1 + 0.1 * t(r)
    cos, sin = yarn_tables((torch.arange(R, device=dev)[:, None] % 61) + 3, c, yarn_inv_freq(c).to(dev))
    ck = t(L, R, S, r + dr).to(bf)
    cp = ck.clone()

    def rope_k():
        qn, qpe = dk.mla_rope_cache(qa, cos, sin, suk, kvn, c.rms_eps, ck, L - 1, slot)
        return qn, qpe, ck[L - 1, :, slot]

    def rope_p():
        qn, qpe = dk.mla_rope_cache_reference(qa, cos, sin, suk, kvn, c.rms_eps, cp, L - 1, slot)
        return qn, qpe, cp[L - 1, :, slot]

    hold("mla_rope_cache", f"rows={R} heads {nh} nope {dn} rope {dr} latent {r}, layer {L - 1} of {L}, slot {slot} "
         f"of {S} bf16", rope_k, rope_p, 2 * 2 * R * W + 4 * (nh * dn + r + dr))
    del ck, cp
    o, suv = (3 * t(nh, R, dv)).to(bf), 1e-2 * t(nh, dv).abs()
    hold("mla_out", f"rows={R} heads {nh} of {dv} bf16", lambda: dk.mla_out(o, suv),
         lambda: dk.mla_out_reference(o, suv), 2 * 2 * R * nh * dv + 4 * nh * dv)
    for N in (R, 3072):
        lg, x = t(N, E), t(N, H).to(bf)
        hold("moe_route", f"rows={N} experts {E} top {k} hidden {H} bf16", lambda: dk.moe_route(lg, x, k),
             lambda: dk.moe_route_reference(lg, x, k), 4 * N * E + 2 * N * H + 2 * N * k * H + 16 * N * k)
    topv, _, pos, _, _ = dk.moe_route_reference(t(R, E), t(R, H).to(bf), k)
    yd, sh = t(R * k, H).to(bf), t(R, H).to(bf)
    hold("moe_combine", f"rows={R} top {k} hidden {H} bf16", lambda: dk.moe_combine(yd, pos, topv, sh, 1.0),
         lambda: dk.moe_combine_reference(yd, pos, topv, sh, 1.0), 2 * (R * k * H + 2 * R * H) + 8 * R * k)
    return out


# Kimi-Linear's kernels against their plain versions, each tolerance the
# card test's (tests/test_torch_kimi_cuda.py): kda_prepare's window and
# beta bit-equal, q, k, v, g within f32 rounding (KDA_PREP_TOL: the L2 norms
# summed in another order); kda_recurrent's state within KDA_STATE_TOL of
# values of scale ~1 (its two products over 128 summed in another order,
# ~1e-7 a token) and its bf16 output within one bf16 step (KDA_BF16_TOL
# relative); kda_gated_norm within one bf16 step. A dropped decay, a
# wrong beta or a missed pad moves them by O(0.1). The routing at 256
# experts bit-equal; the latent attention at 32 heads DECODE_TOL's.
KIMI_ROWS, KIMI_PROMPTS, KIMI_SUFFIX, KIMI_PREFIX = 480, 96, 24, 14
KDA_PREP_TOL, KDA_STATE_TOL, KDA_BF16_TOL = (2e-6, 1e-6), 2e-5, 2 ** -7


def phase_kda_kernels(dev) -> dict:
    """Kimi-Linear's kernels at the tvc-kimi-linear-48b-w8.fresh96 cell's
    shapes, each held against its plain version on the same card inputs
    and timed beside the bound from perfbench/work_kda.py (bytes, or the
    f32 products at 67 TF/s: the larger): kda_prepare and kda_recurrent at
    a decode step (480 rows, one token), the prompts' suffixes (96 rows of
    up to 24 tokens, real lengths 1..24) and the shared prefix (one row of
    14), 32 heads of 128 and a 128 x 128 f32 state; kda_gated_norm at 480
    and 96 x 24 rows; the sigmoid routing with the correction bias and
    renormalisation at 256 experts, top 8, hidden 2,304 (480 rows and a
    prefill's 2,304), every output bit-equal; the latent attention at 32
    heads, B 480, S 64."""
    import torch

    from perfbench import work, work_kda, work_moe
    from tvc_torch.core.kernels import dsv2_fused_kernel as dk
    from tvc_torch.core.kernels import kda_kernel as kk
    from tvc_torch.core.kernels import mla_decode_attention, mla_decode_reference
    from tvc_torch.models.kimi_linear import KimiLinearConfig

    c = KimiLinearConfig.kimi_linear_48b()
    nh, d, K, H = c.kda_heads, c.kda_head_dim, c.conv_size, c.hidden_size
    HD = nh * d
    b_col = 3 * HD + 2 * d
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(25)
    t = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    out = {n: {"shapes": []} for n in (*KDA, "moe_route", "mla_decode_attention")}

    for tag, (B, T, ragged) in {"decode": (KIMI_ROWS, 1, False), "suffix": (KIMI_PROMPTS, KIMI_SUFFIX, True),
                                "prefix": (1, KIMI_PREFIX, False)}.items():
        y = t(B, T, b_col + nh).to(bf)
        f = (t(B, T, 2 * HD) - 3.0).to(bf)
        conv_w, a_log, dt_bias = 0.5 * t(3 * HD, K), torch.log(1 + 15 * torch.rand(nh, generator=gen, device=dev)), \
            0.5 * t(HD)
        window, state = t(B, K - 1, 3 * HD).to(bf), 0.05 * t(B, nh, d, d)
        lengths = torch.randint(1, T + 1, (B,), generator=gen, device=dev) if ragged else None
        shape = f"{tag}: rows={B} T={T}{' real lengths 1..' + str(T) if ragged else ''} heads {nh} of {d}"
        n = int(lengths.sum()) if ragged else B * T
        w_k, w_p = window.clone(), window.clone()
        got = kk.kda_prepare(y, f, conv_w, a_log, dt_bias, w_k, lengths, nh, b_col)
        want = kk.kda_prepare_reference(y, f, conv_w, a_log, dt_bias, w_p, lengths, nh, b_col)
        torch.cuda.synchronize()
        if not (torch.equal(w_k, w_p) and torch.equal(got[1], want[1])):
            raise AssertionError(f"kda_prepare {shape}: the window or beta differs from the plain version")
        err = close("kda_prepare", shape, got[0], want[0], *KDA_PREP_TOL)
        w_t = window.clone()
        record_kernel(out, "kda_prepare", shape,
                      lambda: kk.kda_prepare(y, f, conv_w, a_log, dt_bias, w_t, lengths, nh, b_col),
                      lambda: kk.kda_prepare_reference(y, f, conv_w, a_log, dt_bias, w_t, lengths, nh, b_col),
                      work_kda.prepare(B, T, nh, 3 * HD, K, n), err)
        qkvg, beta = want
        s_k, s_p = state.clone(), state.clone()
        o_k = kk.kda_recurrent(qkvg, beta, s_k, lengths, bf)
        o_p = kk.kda_recurrent_reference(qkvg, beta, s_p, lengths, bf)
        torch.cuda.synchronize()
        err = max(close("kda_recurrent", shape + " (o)", o_k, o_p, KDA_BF16_TOL, 1e-6),
                  close("kda_recurrent", shape + " (state)", s_k, s_p, 0.0, KDA_STATE_TOL))
        if ragged and o_k[torch.arange(T, device=dev)[None] >= lengths[:, None]].any():
            raise AssertionError(f"kda_recurrent {shape}: a pad's output is not zero")
        s_t = state.clone()
        record_kernel(out, "kda_recurrent", shape, lambda: kk.kda_recurrent(qkvg, beta, s_t, lengths, bf),
                      lambda: kk.kda_recurrent_reference(qkvg, beta, s_t, lengths, bf),
                      work_kda.recurrent(B, T, nh, d, n), err)
        if tag != "prefix":
            o, fg, w = t(B, T, nh, d).to(bf), t(B, T, 2 * HD).to(bf), 1 + 0.1 * t(d)
            gate = fg[..., HD:]
            err = close("kda_gated_norm", shape, kk.kda_gated_norm(o, gate, w, c.rms_eps),
                        kk.kda_gated_norm_reference(o, gate, w, c.rms_eps), KDA_BF16_TOL, 1e-6)
            record_kernel(out, "kda_gated_norm", shape, lambda: kk.kda_gated_norm(o, gate, w, c.rms_eps),
                          lambda: kk.kda_gated_norm_reference(o, gate, w, c.rms_eps), work_kda.gated_norm(B, T, nh, d),
                          err)
        del y, f, window, state, qkvg, beta, s_k, s_p, s_t, o_k, o_p
    E, k = c.n_routed_experts, c.num_experts_per_tok
    for N in (KIMI_ROWS, KIMI_PROMPTS * KIMI_SUFFIX):
        lg, x, bias = 2 * t(N, E), t(N, H).to(bf), 0.1 * t(E)
        hold_bit_equal(out, "moe_route", f"rows={N} experts {E} top {k} hidden {H} sigmoid, bias, renormalised bf16",
                       lambda: dk.moe_route(lg, x, k, None, "sigmoid", bias, True),
                       lambda: dk.moe_route_reference(lg, x, k, None, "sigmoid", bias, True),
                       4 * N * E + 4 * E + 2 * N * H + 2 * N * k * H + 16 * N * k)
    B, S, L = KIMI_ROWS, 64, len(c.mla_layers)
    q_lat, q_pe = t(B, c.num_heads, c.kv_lora_rank).to(bf), t(B, c.num_heads, c.qk_rope_head_dim).to(bf)
    cache = t(L, B, S, c.latent_width).to(bf)
    mask = torch.zeros((B, S), device=dev)
    mask[:, 48:60] = float("-inf")
    got = mla_decode_attention(q_lat, q_pe, cache, mask, L - 1, c.softmax_scale)
    want = mla_decode_reference(q_lat, q_pe, cache, mask, L - 1, c.softmax_scale)
    abs_err, rel_err = _layer_error(got, want)
    if not rel_err <= DECODE_TOL:
        raise AssertionError(f"mla_decode_attention at {c.num_heads} heads disagrees with its plain version: "
                             f"{abs_err:.3e} abs, {rel_err:.3e} scaled (tol {DECODE_TOL})")
    ops, nbytes = work_moe.mla_decode(B, S, c.num_heads, c.kv_lora_rank, c.qk_rope_head_dim)
    k_ms = time_ms(lambda: mla_decode_attention(q_lat, q_pe, cache, mask, L - 1, c.softmax_scale))
    p_ms = time_ms(lambda: mla_decode_reference(q_lat, q_pe, cache, mask, L - 1, c.softmax_scale), iters=5, warmup=1)
    bms, by = bound_ms_of(nbytes, work.peak_seconds(ops))
    shape = (f"B={B} S={S} H={c.num_heads} latent {c.kv_lora_rank} rope {c.qk_rope_head_dim}, layer {L - 1} of {L} "
             f"(NoPE)")
    out["mla_decode_attention"]["shapes"].append({"shape": shape, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bms,
                                                     "bound_by": by, "max_abs_err": abs_err})
    log(f"kernel mla_decode_attention {shape}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={bms:.5f} ({by}) "
        f"kernel at {100 * bms / k_ms:.1f}% of the bound, max_abs_err={abs_err:.3e} scaled_err={rel_err:.3e}")
    return out


class _WordTokenizer:
    """A word-level tokenizer for QwenConfig.tiny()'s 512-token vocabulary
    (each word hashed to an id; 0 pads, 511 ends a sequence)."""

    def __init__(self, vocab_size=512, context_length=48):
        self.vocab_size, self.context_length, self.pad_id, self.eot_id = vocab_size, context_length, 0, vocab_size - 1

    def __call__(self, texts):
        from tvc_torch.models.qwen import _stable_seed

        out = np.full((len(texts), self.context_length), self.pad_id, np.int32)
        for i, text in enumerate(texts):
            words = "".join(c if c.isalnum() else " " for c in text.lower()).split()
            ids = [1 + _stable_seed(w) % (self.vocab_size - 3) for w in words][: self.context_length]
            out[i, : len(ids)] = ids
        return out

    def decode(self, ids):
        return " ".join(f"w{int(i)}" for i in ids if i not in (self.pad_id, self.eot_id))


# The tiny f32 Qwen's teacher-forced logits, kernel route vs the same model
# on the plain versions: f32 everywhere (the w8 kernel's f32 path, the
# decode attention in f32), sums in another order only, relative to
# max(1, |logit|).
QWEN_TINY_TOL = 1e-4


def qwen_tiny_f32() -> dict:
    """QwenModel(QwenConfig.tiny()) (f32, quant_gemm "w8") with
    quantize_weights_int8() on the card: 16 COCO captions x 2 samples
    decoded 8 tokens through the w8 kernel's f32 path and the decode
    attention at head width 16, then teacher-forced against the same model
    with the plain versions."""
    import torch

    import tvc_torch.models.qwen as qwen_mod
    from tvc_torch.core.kernels import decode_gqa_reference, launch_counts, reset_launch_counts, w8_matmul_plain
    from tvc_torch.models.qwen import QwenConfig, QwenModel

    cfg = QwenConfig.tiny()
    model = QwenModel(cfg, seed=0, max_new_tokens=8, tokenizer=_WordTokenizer())
    model.quantize_weights_int8()
    if cfg.dtype != torch.float32 or cfg.quant_gemm != "w8" or model.device.type != "cuda":
        raise AssertionError(f"[qwen tiny] {cfg.dtype} {cfg.quant_gemm} on {model.device}")
    inp = model.prepare(coco_captions(16), 2)
    kern, plain = [], []
    reset_launch_counts()
    toks = model.decode(inp, 0.8, seed=0, on_logits=lambda i, lg: kern.append(lg.clone()))
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts["w8_matmul"] <= 0 or counts["decode_gqa_attention"] <= 0:
        raise AssertionError(f"[qwen tiny] the f32 decode missed the kernels: {counts}")
    patches = [
        (qwen_mod, "w8_matmul", w8_matmul_plain),
        (qwen_mod, "w8_matmul_stacked", lambda x, w, s, l: w8_matmul_plain(x, w[l], s[l])),
        (qwen_mod, "decode_gqa_attention_stacked", lambda q, k, v, m, l: decode_gqa_reference(q, k[l], v[l], m)),
        *plain_fused(qwen_mod),
    ]
    with ExitStack() as stack:
        for module, name, fn in patches:
            stack.enter_context(mock.patch.object(module, name, fn))
        model.decode(inp, 0.8, seed=0, forced=toks.T, on_logits=lambda i, lg: plain.append(lg))
    torch.cuda.synchronize()
    a, b = torch.stack(kern), torch.stack(plain)
    abs_err, rel_err = _layer_error(a, b)
    log(f"[qwen tiny] QwenConfig.tiny() f32 w8, {a.shape[1]} rows x {a.shape[0]} steps: launches {counts}; "
        f"teacher-forced logits vs plain max |d| {abs_err:.3e}, scaled {rel_err:.3e} (tol {QWEN_TINY_TOL})")
    if not (bool(torch.isfinite(a).all()) and rel_err <= QWEN_TINY_TOL):
        raise AssertionError("[qwen tiny] the f32 w8 decode disagrees with its plain version")
    return {"launches": counts, "max_abs_err": abs_err}


# The multi-head attention kernel against its plain version, relative to
# max(1, |y|): in bf16 both round the same f32 softmax weights to bf16 (a
# weight one f32 ulp apart, from exp and sums in another order, can round
# to the neighbouring value) and round the output once, as DECODE_TOL says;
# in f32 nothing rounds to bf16 and the sums differ only in order.
MHA_TOL = {"bfloat16": DECODE_TOL, "float32": 1e-5}
# The bank top-k against its plain version: f32 sums of the same products
# in another order than cuBLAS's (~1e-7 at unit-norm scores), so values
# agree to 1e-5 and rows whose scores lie within 1e-5 may swap.
TOPK_TOL = 1e-5


def _mha_bound(B, T, H, D, causal, elem):
    """Bytes: q, k, v in and the output out; operations: the two products
    over every (query, key) pair, at the bf16 tensor-core rate for bf16
    operands and the f32 rate for f32."""
    pairs = T * (T + 1) // 2 if causal else T * T
    peak = PEAK_BF16_FLOPS if elem == 2 else PEAK_F32_FLOPS
    return bound_ms(4 * B * T * H * D * elem, 4 * B * H * pairs * D, peak)


def _topk_bound(B, N, D, k, bank_elem=4, q_elem=4):
    """Bytes: queries and bank in, (score, index) pairs out; operations:
    2 B N D f32 multiply-adds (bf16 operands convert exactly to f32)."""
    return bound_ms(q_elem * B * D + bank_elem * N * D + 8 * B * k, 2 * B * N * D, PEAK_F32_FLOPS)


def topk_agreement(got, want, q, bank, tol=TOPK_TOL) -> dict:
    """Hold the kernel's (scores, rows) against the plain version's on the
    same (already normalized) operands: values within tol; every returned
    row's plain score (q . bank_row in f64) within tol of the kernel's value;
    the same set of rows wherever the plain k-th and (k+1)-th scores differ
    by more than tol. Raises on a miss; returns the counts."""
    import torch

    (gv, gi), (wv, wi) = got, want[:2]
    if gi.dtype != torch.int32 or tuple(gi.shape) != tuple(wi.shape):
        raise AssertionError(f"bank_topk returned {gi.dtype} {tuple(gi.shape)}")
    d_val = float((gv - wv).abs().max())
    exact = (q.double()[:, None, :] * bank[gi.long()].double()).sum(-1)
    d_row = float((exact - gv.double()).abs().max())
    k = gi.shape[1]
    nxt = want[2] if len(want) > 2 else None
    clear = torch.ones(gi.shape[0], dtype=torch.bool, device=gi.device) if nxt is None else (wv[:, -1] - nxt) > tol
    same_set = bool(torch.equal(gi[clear].sort(-1).values, wi[clear].sort(-1).values))
    same_list = float((gi == wi).all(-1).float().mean())
    if not (d_val <= tol and d_row <= tol and same_set):
        raise AssertionError(f"bank_topk disagrees: values {d_val:.3e}, rows {d_row:.3e}, same sets {same_set}")
    return {"max_abs_err": d_val, "row_err": d_row, "clear_rows": int(clear.sum()), "same_lists": same_list, "k": k}


def phase_mha_topk_kernels(dev) -> dict:
    """fused_mha at ViT-B/32's vision shape, ViT-L/14's (T = 257), the
    text tower's causal shape, one f32 D = 32 shape and ViT-L/14 at 336 px
    (T = 577, bf16 and f32), and f32 at T = 300 causal; bank_topk at the
    serving bank's shape (f32, normalize=True: the wrapper and the kernel
    alone on the normalized operands), with a bf16 bank and
    normalize=False, a bf16 bank with normalize=True (the kernel divides
    by the bf16 rows' norms), and with n_valid < N. Library yardsticks:
    scaled_dot_product_attention, and torch.topk(q @ bank.T, k) in f32
    without TF32."""
    import torch
    import torch.nn.functional as F

    from tvc_torch.core.kernels import bank_topk, bank_topk_reference, fused_mha, mha_reference
    from tvc_torch.core.similarity import l2_normalize

    gen = torch.Generator(device=dev).manual_seed(5)
    out = {"fused_mha": {"shapes": []}, "bank_topk": {"shapes": []}}
    for tag, B, T, H, D, dtype, causal in (
        ("ViT-B/32 vision", 256, 50, 12, 64, torch.bfloat16, False),
        ("ViT-L/14 vision", 64, 257, 16, 64, torch.bfloat16, False),
        ("text", 448, 32, 8, 64, torch.bfloat16, True),
        ("W=768 in 24 heads", 256, 50, 24, 32, torch.float32, False),
        ("ViT-L/14 336 px vision", 16, 577, 16, 64, torch.bfloat16, False),
        ("ViT-L/14 336 px vision", 16, 577, 16, 64, torch.float32, False),
        ("T=300", 4, 300, 12, 64, torch.float32, True),
    ):
        q, k, v = (torch.randn((B, T, H, D), generator=gen, device=dev).to(dtype) for _ in range(3))
        abs_err, rel_err = _layer_error(fused_mha(q, k, v, causal), mha_reference(q, k, v, causal))
        tol = MHA_TOL[str(dtype).split(".")[-1]]
        if not rel_err <= tol:
            raise AssertionError(f"fused_mha {tag} disagrees: {abs_err:.3e} abs, {rel_err:.3e} scaled (tol {tol})")
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        k_ms = time_ms(lambda: fused_mha(q, k, v, causal))
        p_ms = time_ms(lambda: mha_reference(q, k, v, causal))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal))
        bms, by = _mha_bound(B, T, H, D, causal, q.element_size())
        shape = f"{tag} B={B} T={T} H={H} D={D} {str(dtype).split('.')[-1]}" + (" causal" if causal else "")
        out["fused_mha"]["shapes"].append({"shape": shape, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bms,
                                           "bound_by": by, "max_abs_err": abs_err, "library_ms": lib_ms})
        log(f"kernel fused_mha {shape}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={bms:.5f} ({by}) "
            f"max_abs_err={abs_err:.3e} scaled_err={rel_err:.3e} library_ms(sdpa)={lib_ms:.4f}")
        del q, k, v, qh, kh, vh

    B, N, D, K = 256, 131072, 512, 10
    q = torch.randn((B, D), generator=gen, device=dev)
    bank = torch.randn((N, D), generator=gen, device=dev)
    qn, bn = l2_normalize(q), l2_normalize(bank)

    def plain_next(qq, bb, **kw):
        v, i = bank_topk_reference(qq, bb, K + 1, **kw)
        return v[:, :K], i[:, :K], v[:, K]

    bank_bf = bank.to(torch.bfloat16)
    # (tag, wrapper operands, keywords, the kernel alone, exact operands, bound): "the kernel alone" is the
    # same call without the wrapper's query normalize (normalize=True on a bf16 bank normalizes inside)
    cases = [
        ("f32 normalize=True", (q, bank), {}, lambda: bank_topk(qn, bn, K, normalize=False), (qn, bn),
         _topk_bound(B, N, D, K)),
        ("bf16 bank normalize=False", (qn, bn.to(torch.bfloat16)), {"normalize": False}, None,
         (qn, bn.to(torch.bfloat16).float()), _topk_bound(B, N, D, K, bank_elem=2)),
        ("bf16 bank normalize=True", (q, bank_bf), {}, None, (qn, l2_normalize(bank_bf.float())),
         _topk_bound(B, N, D, K, bank_elem=2)),
        ("f32 n_valid=100000 normalize=False", (qn, bn), {"normalize": False, "n_valid": 100000}, None,
         (qn, bn[:100000]), _topk_bound(B, 100000, D, K)),
    ]
    for tag, (qq, bb), kw, alone, (q_exact, b_exact), (bms, by) in cases:
        got = bank_topk(qq, bb, K, **kw)
        again = bank_topk(qq, bb, K, **kw)
        want = plain_next(qq, bb, **kw)
        agree = topk_agreement(got, want, q_exact, b_exact)
        if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
            raise AssertionError(f"bank_topk {tag}: two calls differ")
        run = lambda: bank_topk(qq, bb, K, **kw)
        k_ms = time_ms(alone or run, iters=10)
        w_ms = time_ms(run, iters=10)  # with the wrapper's query normalize
        p_ms = time_ms(lambda: bank_topk_reference(qq, bb, K, **kw), iters=5, warmup=1)
        qk, bk = q_exact, (b_exact if "n_valid" not in kw else bn)
        lib_ms = time_ms(lambda: torch.topk(qk @ bk.T, K), iters=10)
        shape = f"{tag} B={B} N={N} D={D} k={K}"
        out["bank_topk"]["shapes"].append({"shape": shape, "ms": k_ms, "wrapper_ms": w_ms, "plain_ms": p_ms,
                                           "bound_ms": bms, "bound_by": by, "max_abs_err": agree["max_abs_err"],
                                           "library_ms": lib_ms})
        log(f"kernel bank_topk {shape}: kernel_ms={k_ms:.4f} wrapper_ms(with normalize)={w_ms:.4f} "
            f"plain_ms={p_ms:.4f} bound_ms={bms:.5f} ({by}) library_ms(torch.topk(q @ bank.T), f32)={lib_ms:.4f} "
            f"agreement {agree}; two calls bit-equal")
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
    "fused_mha": (
        "tvc_torch/csrc/mha.cu", "tvc/core/pallas/attention_kernel.py:58"),
    "bank_topk": (
        "tvc_torch/csrc/bank_topk.cu", "tvc/core/pallas/topk_kernel.py:103"),
    # no TPU kernel: the JAX package runs no mixture of experts or latent attention
    "moe_w8_grouped_gemm": ("tvc_torch/csrc/moe_w8.cu", None),
    "mla_decode_attention": ("tvc_torch/csrc/mla_decode.cu", None),
    # no TPU kernel: the JAX package leaves a layer's elementwise steps to XLA
    "mla_rope_cache": ("tvc_torch/csrc/dsv2_fused.cu", None),
    "mla_out": ("tvc_torch/csrc/dsv2_fused.cu", None),
    "moe_route": ("tvc_torch/csrc/dsv2_fused.cu", None),
    "moe_combine": ("tvc_torch/csrc/dsv2_fused.cu", None),
    # no TPU kernel: the JAX package runs no linear attention
    "kda_prepare": ("tvc_torch/csrc/kda.cu", None),
    "kda_recurrent": ("tvc_torch/csrc/kda.cu", None),
    "kda_gated_norm": ("tvc_torch/csrc/kda.cu", None),
    # no TPU kernel: the JAX package runs no state-space layer
    "ssm_prepare": ("tvc_torch/csrc/ssm.cu", None),
    "ssm_recurrent": ("tvc_torch/csrc/ssm.cu", None),
    "ssm_gated_norm": ("tvc_torch/csrc/ssm.cu", None),
    "relu2": ("tvc_torch/csrc/decode_fused.cu", None),
    "qkv_cache": ("tvc_torch/csrc/decode_fused.cu", None),
    "rmsnorm": ("tvc_torch/csrc/decode_fused.cu", None),
    "add_rmsnorm": ("tvc_torch/csrc/decode_fused.cu", None),
    "qkv_rope_cache": ("tvc_torch/csrc/decode_fused.cu", None),
    "silu_mul": ("tvc_torch/csrc/decode_fused.cu", None),
}
#: the fused elementwise kernels of the decoder layers
DECODE_FUSED = ("rmsnorm", "add_rmsnorm", "qkv_rope_cache", "silu_mul")
#: DeepSeek-V2's own: the latent attention's and the MoE block's glue
DSV2_FUSED = ("mla_rope_cache", "mla_out", "moe_route", "moe_combine")
#: Kimi-Linear's own: Kimi Delta Attention's preparation, recurrence and gated norm
KDA = ("kda_prepare", "kda_recurrent", "kda_gated_norm")
#: Nemotron-H's own: the Mamba-2 blocks' kernels, the non-gated experts' and the no-rotary attention's
SSM = ("ssm_prepare", "ssm_recurrent", "ssm_gated_norm")
NEMOTRON = (*SSM, "relu2", "qkv_cache")
#: the kernels each path launches; it launches no other
PATH_KERNELS = {
    "bf16": ("fused_consistency_scores", "fused_attention_layer", "fused_mlp_layer"),
    "int8": ("fused_consistency_scores", "fused_attention_layer_i8", "fused_mlp_layer_i8"),
    "qwen": ("w8a8_matmul", "w8a8_matmul_stacked", "decode_gqa_attention", "decode_gqa_attention_stacked",
             *DECODE_FUSED),
    "pipeline": ("fused_consistency_scores", "fused_attention_layer_i8", "fused_mlp_layer_i8", "w8_matmul",
                 "w8_matmul_stacked", "decode_gqa_attention", "decode_gqa_attention_stacked", *DECODE_FUSED),
    "dsv2": ("w8_matmul", "moe_w8_grouped_gemm", "mla_decode_attention", "rmsnorm", "add_rmsnorm", "silu_mul",
             *DSV2_FUSED),
    "kimi": ("w8_matmul", "moe_w8_grouped_gemm", "mla_decode_attention", "rmsnorm", "add_rmsnorm", "silu_mul",
             *DSV2_FUSED, *KDA),
    "nemotron": ("w8_matmul", "moe_w8_grouped_gemm", "decode_gqa_attention", "decode_gqa_attention_stacked",
                 "rmsnorm", "add_rmsnorm", "moe_route", "moe_combine", *NEMOTRON),
    "mha": ("fused_mha",),
    "retrieval": ("fused_consistency_scores", "fused_attention_layer", "fused_mlp_layer", "bank_topk"),
    "tiny int8": ("fused_consistency_scores", "fused_attention_layer_i8", "fused_mlp_layer_i8"),
    "tiny f32 layers": ("fused_consistency_scores", "fused_attention_layer", "fused_mlp_layer"),
    "attack": ("fused_consistency_scores", "fused_attention_layer", "fused_mlp_layer"),
    "fixture serving": ("fused_consistency_scores",),
    "fixture f32 layers": ("fused_consistency_scores", "fused_attention_layer", "fused_mlp_layer"),
    "adaptive": ("fused_consistency_scores", "fused_attention_layer", "fused_mlp_layer"),
    "sd": ("fused_consistency_scores", "fused_attention_layer", "fused_mlp_layer"),
    "weights trained": ("fused_consistency_scores", "fused_attention_layer", "fused_mlp_layer"),
    "weights fixture": ("fused_consistency_scores", "fused_attention_layer", "fused_mlp_layer"),
    "weights clip": ("fused_consistency_scores", "fused_attention_layer", "fused_mlp_layer"),
    "weights sd": ("fused_consistency_scores", "fused_attention_layer", "fused_mlp_layer"),
    "harness": ("fused_consistency_scores",),
    "harness fixture": ("fused_consistency_scores",),
    "serving overhead": ("fused_consistency_scores", "fused_attention_layer_i8", "fused_mlp_layer_i8"),
    "mesh bf16": ("fused_consistency_scores", "fused_attention_layer", "fused_mlp_layer"),
    "mesh int8": ("fused_consistency_scores", "fused_attention_layer_i8", "fused_mlp_layer_i8"),
}
B_DEFENDED, V_DEFENDED = 256, 6


def coco_variant_batch(B: int, V: int, order: str = "variants"):
    """B real COCO val2017 captions (the first of one image each) and, for
    each, the other captions of the same image repeated to V variants (the
    caption itself where the image has no other). ``order="variants"``: the
    images with two or more captions, by id, permuted with
    default_rng(12345); ``order="captions"``: every image in the order of
    its first caption, permuted the same way, which is the order of the JAX
    package's ``load_coco_captions()``."""
    with gzip.open(REPO / "tvc" / "assets" / "coco_captions_val2017.json.gz", "rt") as f:
        pairs = json.load(f)
    by_img = {}
    for img_id, cap in pairs:
        by_img.setdefault(img_id, []).append(cap.strip())
    if order == "captions":
        caps = list(by_img.values())
    elif order == "variants":
        caps = [by_img[i] for i in sorted(i for i, c in by_img.items() if len(c) >= 2)]
    else:
        raise ValueError(f"order {order!r}")
    pick = [caps[int(j)] for j in np.random.default_rng(12345).permutation(len(caps))[:B]]
    return [c[0] for c in pick], [((c[1:] or c) * V)[:V] for c in pick]


def _local_http():
    """An opener that never goes through a proxy: requests stay on 127.0.0.1."""
    return urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _check_path_counts(counts: dict, path: str, what: str) -> None:
    """Every kernel of the path launched, and no kernel of another path."""
    missing = [k for k in PATH_KERNELS[path] if counts[k] <= 0]
    stray = [k for k, n in counts.items() if n and k not in PATH_KERNELS[path]]
    if missing or stray:
        raise AssertionError(f"{path} path, {what}: not launched {missing}, launched off the path {stray}: {counts}")


def plain_fused(module) -> list:
    """(module, name, plain version) of each fused decode kernel the model
    module calls, and the final norm's in ``decoding`` (``CausalDecoder``
    writes it once for both models), for a run on the plain versions."""
    from tvc_torch.core.kernels import decode_fused_kernel as fused
    from tvc_torch.models import decoding

    return [(m, n, getattr(fused, n + "_reference")) for m in (module, decoding) for n in DECODE_FUSED
            if hasattr(m, n)]


def hold_defended_batch(path: str, det, images, texts, variants, plain_patches) -> dict:
    """One ``det.detect_batch`` with the launch counts set to 0 just before
    and read just after (every kernel of ``path`` launched, no other, no
    operand copied by the consistency wrapper), then the same batch with
    the kernels patched to their plain versions, held as the module notes
    say: the aggregated scores to LAYER_TOL on the rows whose three scored
    references agree, which must be >= 90 % of the rows."""
    import torch

    from tvc_torch.core.kernels import fused_consistency_scores, launch_counts, reset_launch_counts

    B, V = len(texts), len(variants[0])
    reset_launch_counts()
    copies = fused_consistency_scores.copies
    res = det.detect_batch(images, texts, variants)
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"[{path}] launches in one defended batch (B={B}, V={V}): {counts}")
    _check_path_counts(counts, path, "defended batch")
    if fused_consistency_scores.copies != copies:
        raise AssertionError(f"{path}: the consistency wrapper copied an operand of the defended batch")
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
    return {"result": res, "launches": counts, "flag_agreement": flag_agree, "ref_idx_agreement": idx_agree,
            "max_abs_d_aggregated_same_refs": float(d_agg[same_refs].max())}


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
    held = hold_defended_batch(path, det, images, texts, variants, plain_patches)

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
    return {"launches": held["launches"], "qps": qps, "result": held["result"], "inputs": (images, texts, variants),
            "flag_agreement": held["flag_agreement"], "ref_idx_agreement": held["ref_idx_agreement"]}


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
# phase tiny: the tiny configurations (f32, head width 32) served on the card
# ---------------------------------------------------------------------------

#: requests of the tiny phase: (queries) each, submitted one after another
#: so that the kernel and the plain runs batch them alike
TINY_REQUESTS = (4, 4, 2)


def _serve_tiny(rt, images, texts, requests=TINY_REQUESTS) -> list:
    """The requests through ``rt.submit`` one after another."""
    rt.start(http=False)
    try:
        out, i = [], 0
        for n in requests:
            out.append(rt.submit(images[i : i + n], texts[i : i + n]))
            i += n
    finally:
        rt.stop()
    return out


def _drive_tiny(path: str, rt, patches, tol: float, images=None, texts=None, requests=TINY_REQUESTS) -> dict:
    """Requests through ``rt`` (by default seeded images and COCO
    captions) with the launch counts set to 0 just before and read just
    after, then the same requests with the kernels patched to their plain
    versions; the aggregated scores held to ``tol`` and the flags equal
    wherever the plain score is more than ``tol`` from the threshold."""
    import torch

    from tvc_torch.core.kernels import launch_counts, reset_launch_counts

    det = rt.detector
    cfg = det.model.config
    size = cfg.image_size
    n = sum(requests)
    if images is None:
        images = np.random.default_rng(5).random((n, size, size, 3), dtype=np.float32)
        texts, _ = coco_variant_batch(n, 1)
    reset_launch_counts()
    got = _serve_tiny(rt, images, texts, requests)
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"[{path}] launches while serving {len(requests)} requests: {counts}")
    _check_path_counts(counts, path, "serving")
    with ExitStack() as stack:
        for module, name, plain in patches:
            stack.enter_context(mock.patch.object(module, name, plain))
        want = _serve_tiny(rt, images, texts, requests)
    torch.cuda.synchronize()
    if launch_counts() != counts:
        raise AssertionError(f"[{path}] the plain run launched a kernel")
    g = np.concatenate([a["scores"] for a in got])
    w = np.concatenate([a["scores"] for a in want])
    gf = np.concatenate([a["is_adversarial"] for a in got])
    wf = np.concatenate([a["is_adversarial"] for a in want])
    thr = det.config.detection_threshold
    away = np.abs(w - thr) > tol
    d = np.abs(g - w)
    log(f"[{path}] {cfg.model_name} {cfg.dtype} W={cfg.vision_width} heads={cfg.vision_heads} "
        f"(head width {cfg.vision_width // cfg.vision_heads}): kernel vs plain max |d aggregated| {d.max():.3e} "
        f"(tol {tol}); flags equal {int((gf == wf)[away].sum())} of the {int(away.sum())} scores more than tol "
        f"from the threshold; scores {np.round(g[:16], 4).tolist()}{' ...' if n > 16 else ''}")
    if g.shape != (n,) or not np.all(np.isfinite(g)) or d.max() > tol or not np.all((gf == wf)[away]):
        raise AssertionError(f"[{path}] the served results disagree with the plain path")
    return {"launches": counts, "max_abs_d_aggregated": float(d.max()), "scores": g, "flags": gf}


def phase_tiny(card: dict) -> dict:
    """The tiny configurations, f32 with head width 32 (W = 64, two heads),
    on the card: ServingRuntime(ServingConfig(clip_model="tiny",
    int8_serving=True)), as ``serve --int8`` builds it by default, through
    the int8 layer kernels; and a detector over
    CLIPConfig.from_name("tiny", fused_attention=True) behind a
    ServingRuntime through the bf16-layer kernels in f32. Each held against
    the same runtime with the layer kernels (and the consistency kernel)
    patched to their plain versions: int8 to LAYER_TOL (an int8 quantum
    flipped by an f32 sum in another order), f32 to F32_LAYER_TOL."""
    import tvc_torch.models.clip as clip_mod
    import tvc_torch.parallel.steps as steps_mod
    from tvc_torch.core.kernels import (
        attention_layer_i8_reference,
        attention_layer_reference,
        consistency_scores_reference,
        mlp_layer_i8_reference,
        mlp_layer_reference,
    )
    from tvc_torch.detector import AdversarialDetector, DetectorConfig
    from tvc_torch.models.clip import CLIPConfig, CLIPModel
    from tvc_torch.retrieval import MultiModalRetriever, RetrievalConfig
    from tvc_torch.serving import ServingConfig, ServingRuntime

    consistency = (steps_mod, "fused_consistency_scores", consistency_scores_reference)
    rt = ServingRuntime(ServingConfig(clip_model="tiny", int8_serving=True, drift_window=0, batch_max_size=4))
    mcfg = rt.detector.model.config
    if not (mcfg.int8_serving and mcfg.fused_attention and mcfg.vision_width // mcfg.vision_heads == 32):
        raise AssertionError(f"ServingConfig(clip_model='tiny', int8_serving=True) built {mcfg}")
    out = {"tiny int8": _drive_tiny("tiny int8", rt, [
        (clip_mod, "fused_attention_layer_i8", attention_layer_i8_reference),
        (clip_mod, "fused_mlp_layer_i8", mlp_layer_i8_reference), consistency], LAYER_TOL)}

    model = CLIPModel(CLIPConfig.from_name("tiny", fused_attention=True), seed=0)
    retriever = MultiModalRetriever(model, RetrievalConfig())
    embs = np.random.default_rng(0).standard_normal((1024, model.config.embed_dim), dtype=np.float32)
    retriever.build_image_index(embeddings=embs / np.linalg.norm(embs, axis=-1, keepdims=True))
    det = AdversarialDetector(model, retriever=retriever, config=DetectorConfig(text_bucket=32))
    rt = ServingRuntime(ServingConfig(clip_model="tiny", drift_window=0, batch_max_size=4), detector=det)
    out["tiny f32 layers"] = _drive_tiny("tiny f32 layers", rt, [
        (clip_mod, "fused_attention_layer", attention_layer_reference),
        (clip_mod, "fused_mlp_layer", mlp_layer_reference), consistency], F32_LAYER_TOL)
    return out


# ---------------------------------------------------------------------------
# phase attack: detect under attack
# ---------------------------------------------------------------------------

B_ATTACK = 64  # attacked images of each part of the phase
#: the ε-ball within one f32 rounding of orig + δ, the [0, 1] clamp exactly
EPS_ROUNDING = 1e-7


def _check_ball(name: str, adv: np.ndarray, orig: np.ndarray, eps: float) -> float:
    linf = float(np.abs(adv - orig).max())
    if adv.min() < 0.0 or adv.max() > 1.0 or linf > eps + EPS_ROUNDING:
        raise AssertionError(f"{name}: the adversarial images leave the eps-ball or [0, 1] "
                             f"(linf {linf:.6f}, eps {eps:.6f}, range [{adv.min()}, {adv.max()}])")
    return linf


def _attack_full_width(card: dict, det) -> dict:
    """PGD ``standard`` (eps 8/255, 10 steps, random start) on B_ATTACK
    seeded 224 px images against ViT-B/32 bf16 with seeded random weights,
    the gradient through the einsum module; then the bf16 detector of the
    slice phase (fused layer kernels, consistency kernel) on the clean and
    the attacked batch together, held against the same detector on the
    plain versions."""
    import torch

    import tvc_torch.models.clip as clip_mod
    import tvc_torch.parallel.steps as steps_mod
    from tvc_torch.attacks import PGDAttacker, PGDAttackPresets
    from tvc_torch.attacks.common import make_encoder
    from tvc_torch.core.kernels import attention_layer_reference, consistency_scores_reference, mlp_layer_reference

    model = det.model
    size = model.config.image_size
    images = np.random.default_rng(21).random((B_ATTACK, size, size, 3), dtype=np.float32)
    texts, variants = coco_variant_batch(B_ATTACK, V_DEFENDED)
    attacker = PGDAttacker(model, PGDAttackPresets.standard())
    attacker.attack(images[:2], texts[:2])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = attacker.attack(images, texts)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    linf = _check_ball("PGD ViT-B/32", res.adv_images, images, attacker.config.epsilon)
    with torch.no_grad():
        tf = model.encode_text(texts)
        enc = make_encoder(model)
        clean = torch.sum(enc(model.params, torch.as_tensor(images, device=model.device)) * tf, -1).float()
    clean = clean.cpu().numpy()
    if not np.all(np.isfinite(res.final_similarity)) or not res.final_similarity.mean() < clean.mean():
        raise AssertionError(f"PGD did not lower the similarity: {res.final_similarity.mean()} vs clean "
                             f"{clean.mean()}")
    log(f"[attack] PGD standard on {model.config.model_name} {model.config.dtype}, B={B_ATTACK}, {size} px: "
        f"{B_ATTACK / secs:.1f} "
        f"attacked images/s ({secs:.3f} s), peak {peak:.2f} GiB, linf {linf:.6f}, mean cos(image, text) "
        f"{clean.mean():.4f} -> {res.final_similarity.mean():.4f}, success rate {res.success_rate:.3f} "
        f"on {card['smi']}")
    profile_batch("attack", lambda: attacker.attack(images, texts))

    mixed = np.concatenate([images, res.adv_images])
    patches = [
        (clip_mod, "fused_attention_layer", attention_layer_reference),
        (clip_mod, "fused_mlp_layer", mlp_layer_reference),
        (steps_mod, "fused_consistency_scores", consistency_scores_reference),
    ]
    held = hold_defended_batch("attack", det, mixed, texts + texts, variants + variants, patches)
    iters = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        det.detect_batch(mixed, texts + texts, variants + variants)
    torch.cuda.synchronize()
    qps = 2 * B_ATTACK * iters / (time.perf_counter() - t0)
    agg = held["result"].aggregated_score
    labels = np.r_[np.zeros(B_ATTACK), np.ones(B_ATTACK)]
    from tvc_torch.metrics import DetectionEvaluator

    log(f"[attack] detector on the clean + attacked batch (B={2 * B_ATTACK}, V={V_DEFENDED}): {qps:.1f} queries/s; "
        f"flags clean {int(held['result'].is_adversarial[:B_ATTACK].sum())} / attacked "
        f"{int(held['result'].is_adversarial[B_ATTACK:].sum())} of {B_ATTACK}; AUROC (random weights, "
        f"reported only) {DetectionEvaluator.auroc(labels, agg):.4f} on {card['smi']}")
    return {"launches": held["launches"], "images_per_s": B_ATTACK / secs, "peak_gib": peak, "qps": qps,
            "flag_agreement": held["flag_agreement"]}


def _detection_report(tag: str, scores: np.ndarray, n: int, names) -> dict:
    """AUROC and TPR at 5 % FPR of each attack's scores against the clean
    ones (the first n), with tvc_torch.metrics."""
    from tvc_torch.metrics import DetectionEvaluator

    out = {}
    clean = scores[:n]
    for i, name in enumerate(names):
        adv = scores[n * (i + 1): n * (i + 2)]
        labels = np.r_[np.zeros(n), np.ones(n)]
        s = np.r_[clean, adv]
        fpr, tpr, _ = DetectionEvaluator.roc_curve(labels, s)
        out[name] = {"auroc": DetectionEvaluator.auroc(labels, s), "tpr_at_5pct_fpr": float(tpr[fpr <= 0.05].max()),
                     "mean_score": float(adv.mean())}
        log(f"[{tag}] {name}: AUROC {out[name]['auroc']:.4f}, TPR at 5 % FPR {out[name]['tpr_at_5pct_fpr']:.4f}, "
            f"mean aggregated {adv.mean():.4f} (clean {clean.mean():.4f})")
    return out


def _attack_fixture(card: dict, tmp: Path) -> dict:
    """The trained tiny_coco fixture on the card: its evaluation held to the
    recorded metrics; PGD, FGSM, C&W / FSTA / SMA / hubness ``fast`` on
    the rendered images of held-out COCO captions [0:B_ATTACK] (the
    eps-ball and the clamp checked); the clean and attacked
    images detected through ServingRuntime(ServingConfig(clip_model=
    "tiny_coco_trained")) (einsum towers, consistency kernel) and through
    an injected detector over tiny_coco with fused_attention (the f32
    layer kernels at head width 32), each held against its plain route."""
    import torch

    import tvc_torch.models.clip as clip_mod
    import tvc_torch.parallel.steps as steps_mod
    from tvc_torch.attacks import (
        CWAttacker, CWAttackPresets, FGSMAttacker, FGSMAttackPresets, FSTAAttacker, FSTAAttackPresets,
        HubnessAttacker, HubnessAttackPresets, PGDAttacker, PGDAttackPresets, SMAAttacker, SMAAttackPresets,
    )
    from tvc_torch.core.kernels import attention_layer_reference, consistency_scores_reference, mlp_layer_reference
    from tvc_torch.data.loaders import COCOCaptionsDataset, DataConfig, load_coco_captions, render_caption_image
    from tvc_torch.detector import AdversarialDetector, DetectorConfig
    from tvc_torch.fixtures import EVAL_HOLDOUT, FIXTURE_COCO_META_PATH, evaluate_fixture_coco, load_trained_tiny_coco
    from tvc_torch.models.clip import CLIPConfig, CLIPModel
    from tvc_torch.retrieval import MultiModalRetriever, RetrievalConfig
    from tvc_torch.serving import ServingConfig, ServingRuntime

    model = load_trained_tiny_coco()
    metrics = evaluate_fixture_coco(model)
    meta = json.loads(FIXTURE_COCO_META_PATH.read_text())
    diffs = {k: abs(metrics[k] - meta[k]) for k in metrics}
    log(f"[fixture] tiny_coco evaluation on the card: {json.dumps(metrics)}; |d| to the recorded "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in diffs.items()})}")
    if metrics["retrieval_accuracy"] != meta["retrieval_accuracy"] or \
            max(v for k, v in diffs.items() if k != "retrieval_accuracy") > 1e-3:
        raise AssertionError("the fixture's evaluation on the card parts from its recorded metrics")

    n = B_ATTACK
    size = model.config.image_size
    batch = next(COCOCaptionsDataset(DataConfig(image_size=size, max_samples=n)).batches(batch_size=n))
    images, texts = batch["images"], list(batch["texts"])
    held_out = load_coco_captions()[:EVAL_HOLDOUT]
    if texts != [c for _, c in held_out[:n]]:
        raise AssertionError("the attacked captions are not the first held-out captions")
    # the reference-image bank: the rendered images of the other held-out captions
    bank_caps = held_out[n:]
    bank_imgs = np.stack([render_caption_image(c, size, noise_seed=int(i) % 2**31) for i, c in bank_caps])
    retriever = MultiModalRetriever(model, RetrievalConfig())
    retriever.build_image_index(embeddings=model.encode_image(bank_imgs).float().cpu().numpy())
    retriever.save(str(tmp / "fixture_bank"))

    adv = {}
    for name, attacker in (("pgd", PGDAttacker(model, PGDAttackPresets.standard())),
                           ("fgsm", FGSMAttacker(model, FGSMAttackPresets.standard())),
                           ("cw", CWAttacker(model, CWAttackPresets.fast())),
                           ("fsta", FSTAAttacker(model, FSTAAttackPresets.fast())),
                           ("sma", SMAAttacker(model, SMAAttackPresets.fast()))):
        t0 = time.perf_counter()
        res = attacker.attack(images, texts)
        torch.cuda.synchronize()
        # C&W bounds no norm (it minimizes L2 through tanh): the clamp only
        linf = _check_ball(name, res.adv_images, images, getattr(attacker.config, "epsilon", 1.0))
        adv[name] = res.adv_images
        log(f"[fixture] {name}: {time.perf_counter() - t0:.3f} s, linf {linf:.6f}, mean cos(image, text) "
            f"{res.final_similarity.mean():.4f}, success rate {res.success_rate:.3f}")
    hub = HubnessAttacker(model, HubnessAttackPresets.fast())
    hub.build_reference_database(images=images, texts=[c for _, c in bank_caps[:100]])
    t0 = time.perf_counter()
    res = hub.attack(images)
    torch.cuda.synchronize()
    linf = _check_ball("hubness", res.adv_images, images, hub.config.epsilon)
    adv["hubness"] = res.adv_images
    hijack = float(np.mean(res.info["hubness_scores"]))
    log(f"[fixture] hubness fast ({hub.config.num_iterations} iterations, {res.info['num_queries']} queries of a "
        f"100-caption pool, gallery: the {n} clean images): {time.perf_counter() - t0:.3f} s, linf {linf:.6f}, "
        f"hijack mean {hijack:.4f} (recorded beside the fixture, another setting: "
        f"{meta['hubness_hijack_mean']:.4f})")

    all_images = np.concatenate([images] + [adv[k] for k in adv])
    all_texts = texts * (1 + len(adv))
    requests = (n,) * (1 + len(adv))
    cfg = ServingConfig(clip_model="tiny_coco_trained", bank_path=str(tmp / "fixture_bank"), drift_window=0,
                        batch_max_size=n)
    rt = ServingRuntime(cfg)
    mcfg = rt.detector.model.config
    if mcfg.fused_attention or mcfg.int8_serving:
        raise AssertionError(f"ServingConfig(clip_model='tiny_coco_trained') built {mcfg}")
    consistency = (steps_mod, "fused_consistency_scores", consistency_scores_reference)
    serving = _drive_tiny("fixture serving", rt, [consistency], F32_LAYER_TOL, all_images, all_texts, requests)
    fused = CLIPModel(CLIPConfig.from_name("tiny_coco", fused_attention=True), params=model.params)
    retriever2 = MultiModalRetriever(fused, RetrievalConfig())
    retriever2.load(str(tmp / "fixture_bank"))
    det2 = AdversarialDetector(fused, retriever=retriever2, config=DetectorConfig(
        num_text_variants=cfg.num_text_variants, text_bucket=cfg.text_bucket))
    rt2 = ServingRuntime(cfg, detector=det2)
    layers = _drive_tiny("fixture f32 layers", rt2, [
        (clip_mod, "fused_attention_layer", attention_layer_reference),
        (clip_mod, "fused_mlp_layer", mlp_layer_reference), consistency], F32_LAYER_TOL,
        all_images, all_texts, requests)
    d = float(np.abs(serving["scores"] - layers["scores"]).max())
    log(f"[fixture] the two routes (einsum towers vs f32 layer kernels) part by max |d aggregated| {d:.3e}")
    serving["detection"] = _detection_report("fixture serving", serving["scores"], n, list(adv))
    layers["detection"] = _detection_report("fixture f32 layers", layers["scores"], n, list(adv))

    # the adaptive evaluation on both routes: the attacker differentiates the
    # einsum module; each route's detect_batch scores (no variants: the
    # served detector has no variant source)
    refs = retriever.retrieve_reference_embeddings(texts, top_k=rt.detector.config.num_reference_images)
    no_variants = [[] for _ in texts]
    adaptive = {}
    for path, det in (("fixture serving", rt.detector), ("fixture f32 layers", det2)):
        adaptive[path] = _adaptive_evaluation(
            f"{path} adaptive", path, model, det, images, texts, no_variants, refs,
            lambda x, d=det: d.detect_batch(x, texts).aggregated_score)

    # the alt stack (MultiModalDefenseDetector: retrieval references from the
    # fixture bank) on the clean and the PGD images
    from tvc_torch.defenses import DetectionConfig, MultiModalDefenseDetector
    from tvc_torch.metrics import DetectionEvaluator

    alt = MultiModalDefenseDetector(model, DetectionConfig(), retrieval_generator=lambda t, k: (
        retriever.retrieve_reference_embeddings(t, top_k=k)))
    clean_overall = alt.detect(images, texts)["overall_score"]
    pgd_overall = alt.detect(adv["pgd"], texts)["overall_score"]
    # the alt stack's direction: LOW consistency = adversarial
    alt_auroc = DetectionEvaluator.auroc(np.r_[np.zeros(n), np.ones(n)], -np.r_[clean_overall, pgd_overall])
    log(f"[fixture] MultiModalDefenseDetector (alt stack, retrieval refs) clean vs PGD: AUROC {alt_auroc:.4f}, "
        f"mean overall score clean {clean_overall.mean():.4f} / PGD {pgd_overall.mean():.4f}")
    return {"fixture serving": serving, "fixture f32 layers": layers, "metrics": metrics, "hijack_mean": hijack,
            "fixture adaptive": adaptive, "alt_auroc": alt_auroc}


#: the adaptive evaluation of the attack phase: AdaptiveAttackConfig's
#: pgd base at eps 8/255 and its own alpha (1/255), ADAPTIVE_STEPS steps a
#: sweep point, the sweep ADAPTIVE_SWEEP, then the strong pass at the best
#: lambda with ADAPTIVE_STRONG_STEPS steps (the JAX default of 500 would be
#: 50 sweep points' work at full width)
ADAPTIVE_EPS, ADAPTIVE_STEPS, ADAPTIVE_SWEEP, ADAPTIVE_STRONG_STEPS = 8 / 255, 10, (0.0, 2.0, 5.0), 20


def _adaptive_evaluation(tag: str, path: str, model, det, images, texts, variants, refs, score_batch) -> dict:
    """run_adaptive_evaluation against ``det`` with ``score_batch`` (the
    detector's own detect_batch) as the production scoring path: the
    launch counts set to 0 just before the clean scores and read after the
    strong pass (every kernel of ``path``, no other), the eps-ball and
    [0, 1] checked on every attacked batch it scores (each lambda and the
    strong pass), each row reported. Returns the first attacked batch
    (lambda ADAPTIVE_SWEEP[0]) under ``first_attacked``."""
    import torch

    from tvc_torch.attacks import AdaptiveAttackConfig, run_adaptive_evaluation
    from tvc_torch.core.kernels import launch_counts, reset_launch_counts

    balls, first = [], []

    def scored(adv):
        balls.append(_check_ball(f"[{tag}]", adv, images, ADAPTIVE_EPS))
        if not first:
            first.append(adv)
        return score_batch(adv)

    reset_launch_counts()
    t0 = time.perf_counter()
    clean = np.asarray(score_batch(images))
    out = run_adaptive_evaluation(
        model, det, images, texts, variants, refs, clean, sweep=ADAPTIVE_SWEEP,
        attack_config=AdaptiveAttackConfig(epsilon=ADAPTIVE_EPS, num_steps=ADAPTIVE_STEPS), score_batch=scored,
        strong_steps=ADAPTIVE_STRONG_STEPS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    _check_path_counts(counts, path, "adaptive evaluation")
    if len(balls) != len(ADAPTIVE_SWEEP) + 1:
        raise AssertionError(f"[{tag}] scored {len(balls)} attacked batches, expected {len(ADAPTIVE_SWEEP) + 1}")
    lo, hi = out["band"]
    log(f"[{tag}] band [{lo:.4f}, {hi:.4f}] from {len(clean)} clean scores; {ADAPTIVE_STEPS} steps a sweep point, "
        f"strong pass {ADAPTIVE_STRONG_STEPS} steps; {secs:.3f} s; max linf {max(balls):.6f}; launches {counts}")
    for name, row in [*((f"lambda {k}", v) for k, v in out["sweep"].items()),
                      (f"strong (lambda {out['strong']['penalty_weight']})", out["strong"])]:
        log(f"[{tag}] {name}: attack_success_rate {row['attack_success_rate']:.4f}, detection_rate "
            f"{row['detection_rate']:.4f}, auroc_band {row['auroc_band']:.4f}, evasion_success_rate "
            f"{row['evasion_success_rate']:.4f}, mean aggregated {row['mean_aggregated']:.4f}")
    return {"evaluation": out, "launches": counts, "seconds": secs, "max_linf": max(balls),
            "first_attacked": first[0]}


def _adaptive_full_width(card: dict, det) -> dict:
    """The defense-aware attack on the slice phase's ViT-B/32 bf16 (B_ATTACK
    seeded 224 px images, real COCO variants): the detector calibrated
    two-sided on the clean images, AdaptiveAttacker(base="pgd") timed at
    lambda 2, then run_adaptive_evaluation scored by that detector's
    detect_batch (the fused step: consistency and layer kernels); the
    clean batch and the evaluation's lambda-0 batch, the shapes that
    evaluation scores, held against the same detector on the plain
    versions."""
    import torch

    import tvc_torch.models.clip as clip_mod
    import tvc_torch.parallel.steps as steps_mod
    from tvc_torch.attacks import AdaptiveAttackConfig, AdaptiveAttacker
    from tvc_torch.core.kernels import attention_layer_reference, consistency_scores_reference, mlp_layer_reference

    model = det.model
    size = model.config.image_size
    images = np.random.default_rng(21).random((B_ATTACK, size, size, 3), dtype=np.float32)
    texts, variants = coco_variant_batch(B_ATTACK, V_DEFENDED)
    R = det.config.num_reference_images
    refs = det.retriever.retrieve_reference_embeddings(texts, top_k=R)  # the text-retrieved bank rows
    lo, hi = det.calibrate_two_sided(det.detect_batch(images, texts, variants).aggregated_score)
    cfg = AdaptiveAttackConfig(epsilon=ADAPTIVE_EPS, num_steps=ADAPTIVE_STEPS, band_lower=lo, band_upper=hi)
    attacker = AdaptiveAttacker(model, cfg)
    attacker.attack(images[:2], texts[:2], variants[:2], refs[:2], penalty_weight=2.0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = attacker.attack(images, texts, variants, refs, penalty_weight=2.0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    linf = _check_ball("adaptive ViT-B/32", res.adv_images, images, cfg.epsilon)
    log(f"[adaptive] AdaptiveAttacker pgd base, lambda 2, {ADAPTIVE_STEPS} steps, eps 8/255 on "
        f"{model.config.model_name} {model.config.dtype}, B={B_ATTACK}, V={V_DEFENDED}, R={R}: "
        f"{B_ATTACK / secs:.1f} attacked images/s ({secs:.3f} s), peak {peak:.2f} GiB, linf {linf:.6f}, "
        f"inside the band (self-scored) {float(np.mean(res.info['inside_band'])):.4f}, mean cos(image, text) "
        f"{res.final_similarity.mean():.4f} on {card['smi']}")
    ev = _adaptive_evaluation("adaptive", "adaptive", model, det, images, texts, variants, refs,
                              lambda x: det.detect_batch(x, texts, variants).aggregated_score)
    patches = [
        (clip_mod, "fused_attention_layer", attention_layer_reference),
        (clip_mod, "fused_mlp_layer", mlp_layer_reference),
        (steps_mod, "fused_consistency_scores", consistency_scores_reference),
    ]
    held = {what: hold_defended_batch("adaptive", det, batch, texts, variants, patches)
            for what, batch in (("clean", images), (f"lambda {ADAPTIVE_SWEEP[0]}", ev.pop("first_attacked")))}
    log(f"[adaptive] held against the plain versions at B={B_ATTACK}: " + ", ".join(
        f"{what} flag agreement {h['flag_agreement']:.4f}, max |d aggregated| {h['max_abs_d_aggregated_same_refs']:.3e}"
        for what, h in held.items()))
    return {**ev, "images_per_s": B_ATTACK / secs, "peak_gib": peak,
            "held": {what: {k: v for k, v in h.items() if k != "result"} for what, h in held.items()}}


def phase_attack(card: dict, bf16: dict) -> dict:
    """Detect under attack: the full-width PGD and detection, the
    full-width adaptive evaluation, then the trained fixture."""
    import tempfile

    out = {"attack": _attack_full_width(card, bf16["detector"])}
    out["adaptive"] = _adaptive_full_width(card, bf16["detector"])
    with tempfile.TemporaryDirectory() as tmp:
        out.update(_attack_fixture(card, Path(tmp)))
    return out


# ---------------------------------------------------------------------------
# phase sd: the generative references
# ---------------------------------------------------------------------------

N_SD = 8  # captions of the sd phase: x 3 references, a CFG batch of 48 in each UNet call
# One UNet call, bf16 against f32 on the same inputs and parameters, the
# largest over rows of the output of 1 - cos and of the relative L2. On
# the H100 the sound UNet reads 1.298e-4 and 1.612e-2 (bf16 rounds every
# activation and weight to 2^-9, ~150 operations deep); with its timestep
# embedding taken in bf16 (a control run beside it every time, which the
# limits must catch) 1.246e-2 and 1.607e-1. Each limit sits near the
# geometric mean of the two. GroupNorm statistics or attention logits
# taken in bf16 move the reading by 2 %, inside bf16's own noise: no limit
# on the whole UNet sees them, tests/test_torch_sd.py's bf16 block tests do.
SD_DIRECTION_TOL, SD_REL_L2_TOL = 1e-3, 5e-2
SD_CAUGHT_CONTROL = "timestep embedding in bf16"


def _gn_bf16_statistics(self, x):
    """A bf16 slip: GroupNorm statistics taken in bf16."""
    import torch

    import tvc_torch.models.sd as sd_mod

    B_, C = x.shape[0], x.shape[-1]
    xg = x.to(torch.bfloat16).reshape(B_, -1, self.groups, C // self.groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = torch.clamp(torch.square(xg).mean(dim=(1, 3), keepdim=True) - torch.square(mean), min=0.0)
    y = sd_mod._normalize(xg, mean.float(), var.float(), self.scale.reshape(self.groups, -1),
                          self.bias.reshape(self.groups, -1), self.eps)
    return y.reshape(x.shape).to(self.dtype)


def _mha_bf16_logits(self, q_in, kv_in, name):
    """A bf16 slip in the native UNet: attention logits in the compute dtype."""
    import torch

    B_, _, C = q_in.shape
    hd = C // self.heads
    q, k, v = (getattr(self, f"{name}_{part}")(t).reshape(B_, -1, self.heads, hd).transpose(1, 2)
               for part, t in (("q", q_in), ("k", kv_in), ("v", kv_in)))
    logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)  # in the compute dtype
    w = torch.softmax(logits.float(), dim=-1).to(self.dtype)
    return getattr(self, f"{name}_o")(torch.matmul(w, v).transpose(1, 2).reshape(B_, -1, C))


def _attend_bf16_logits(q, k, v, heads, dtype):
    """The same slip in the diffusers-layout mirror's attention."""
    import torch

    B_, _, C = q.shape
    hd = C // heads
    q, k, v = (x.reshape(B_, -1, heads, hd).transpose(1, 2) for x in (q, k, v))
    w = torch.softmax((torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)).float(), dim=-1).to(dtype)
    return torch.matmul(w, v).transpose(1, 2).reshape(B_, -1, C)


def _timestep_embedding_bf16(t, dim):
    """A bf16 slip: the sinusoidal timestep embedding's arguments in bf16."""
    import torch

    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.to(torch.bfloat16)[:, None] * freqs.to(torch.bfloat16)[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1).float()


def phase_sd(card: dict, bf16: dict) -> dict:
    """The generative references at full width: StableDiffusionModel at
    the SD-1.5 shape class (seeded random weights, bf16, 512 px, 20 DDIM
    steps, CFG 7.5), driven by :func:`drive_sd`."""
    import dataclasses

    import torch

    import tvc_torch.models.sd as sd_mod
    from tvc_torch.models.sd import SDConfig, StableDiffusionModel, UNet

    cfg = SDConfig()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sd = StableDiffusionModel(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (sd.unet, sd.vae_enc, sd.vae_dec) for p in m.parameters())
    log(f"[sd] StableDiffusionModel(SDConfig()): {cfg.image_size} px, UNet base {cfg.unet_base} mults "
        f"{cfg.unet_mults}, VAE base {cfg.vae_base}, {cfg.dtype}, {cfg.num_inference_steps} DDIM steps, CFG "
        f"{cfg.guidance_scale}: {n_params} seeded random parameters initialized on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    controls = (("GroupNorm statistics in bf16", sd_mod.GroupNorm, "forward", _gn_bf16_statistics),
                ("attention logits in bf16", sd_mod.AttnBlock, "_mha", _mha_bf16_logits),
                ("timestep embedding in bf16", sd_mod, "timestep_embedding", _timestep_embedding_bf16))
    return drive_sd("sd", sd, card, bf16,
                    lambda dev: UNet(dataclasses.replace(cfg, dtype=torch.float32), device=dev), controls)


def drive_sd(path: str, sd, card: dict, bf16: dict, make_f32_unet, controls) -> dict:
    """``sd`` behind SDReferenceGenerator(SDReferenceConfig()) with the
    slice phase's ViT-B/32 bf16 as its CLIP, feeding an
    AdversarialDetector with no retriever (R = 3, V = 6; the staged path:
    the vision encode of the queries and of the generated images and the
    text towers through the layer kernels, then the consistency kernel) on
    N_SD COCO captions and N_SD of the slice phase's images. Held:
    generation bit-equal over two calls, images in [0, 1] on the 1/255
    grid, one UNet call bf16 against the f32 UNet ``make_f32_unet(device)``
    on the same parameters in direction and relative L2 (SD_DIRECTION_TOL,
    SD_REL_L2_TOL; with each of ``controls`` (name, owner, attribute,
    slip) patched in, the SD_CAUGHT_CONTROL slip must part by more), the
    detector on the same SD reference vectors against its plain versions
    (LAYER_TOL, flags equal away from the threshold), and the references'
    vision encode against its plain version (MHA_COS_TOL). Frees ``sd``."""
    import torch

    import tvc_torch.detector as det_mod
    import tvc_torch.models.clip as clip_mod
    from tvc_torch.core.kernels import (
        attention_layer_reference, consistency_scores_reference, launch_counts, mlp_layer_reference,
        reset_launch_counts,
    )
    from tvc_torch.detector import AdversarialDetector, DetectorConfig
    from tvc_torch.models.sd import compute_params, load_params
    from tvc_torch.sd_ref import SDReferenceConfig, SDReferenceGenerator

    model = bf16["detector"].model
    cfg = sd.config
    ref_cfg = SDReferenceConfig()
    gen = SDReferenceGenerator(sd, ref_cfg, clip_model=model)
    if gen.cache is not None:
        raise AssertionError(f"the {path} phase generates with no cache")
    n = ref_cfg.num_images
    texts, variants = coco_variant_batch(N_SD, V_DEFENDED, order="captions")
    images = bf16["inputs"][0][:N_SD]

    # -- generation: images/s, determinism, range
    sd.generate_images_batch(texts[:1], 1, seed=ref_cfg.base_seed, num_inference_steps=2)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = sd.generate_images_batch(texts, n, seed=ref_cfg.base_seed)
    gen_secs = time.perf_counter() - t0
    second = sd.generate_images_batch(texts, n, seed=ref_cfg.base_seed)
    a, b = (np.stack([np.stack(p) for p in x]) for x in (first, second))
    if a.shape != (N_SD, n, cfg.image_size, cfg.image_size, 3) or not np.array_equal(a, b):
        raise AssertionError(f"SD generation is not deterministic per seed (shape {a.shape})")
    if a.min() < 0.0 or a.max() > 1.0 or not np.array_equal(a * 255.0, np.round(a * 255.0)):
        raise AssertionError("SD images leave [0, 1] or the 1/255 grid")
    log(f"[{path}] {N_SD} captions x {n} images (CFG batch {2 * N_SD * n}): {N_SD * n / gen_secs:.2f} SD reference "
        f"images/s ({gen_secs:.3f} s), bit-equal over two calls, pixel mean {a.mean():.4f} std {a.std():.4f} on "
        f"{card['smi']}")

    # -- one CFG UNet step and the VAE decode, device time
    B = N_SD * n
    lat = sd.initial_latents(B, ref_cfg.base_seed)
    with torch.no_grad():
        ctx = torch.cat([sd._text_encoder([""] * N_SD), sd._text_encoder(texts)]).repeat_interleave(n, dim=0)
    lat2, tvec = torch.cat([lat, lat]), torch.full((2 * B,), 951.0, device=lat.device)
    step_ms = time_ms(lambda: sd._apply("unet", lat2, tvec, ctx), iters=3, warmup=1)
    dec_ms = time_ms(lambda: sd._apply("vae_dec", lat / cfg.vae_scale), iters=3, warmup=1)
    log(f"[{path}] one CFG UNet call at B={2 * B}: {step_ms:.3f} ms; VAE decode at B={B}: {dec_ms:.3f} ms "
        f"(CUDA events) on {card['smi']}")

    # -- one UNet call, bf16 against f32 on the same inputs, in direction and
    # in relative L2; then the same call with each bf16 slip of ``controls``,
    # which the limits must catch (SD_CAUGHT_CONTROL)
    f32_unet = make_f32_unet(lat.device)
    load_params(f32_unet, sd.params["unet"])
    rows = slice(B - 2, B + 2)  # two unconditional and two conditional rows
    with torch.no_grad():
        want = torch.func.functional_call(f32_unet, compute_params(f32_unet),
                                          (lat2[rows], tvec[rows], ctx[rows])).flatten(1)
    del f32_unet

    def unet_error() -> tuple:
        with torch.no_grad():
            got = sd._apply("unet", lat2[rows], tvec[rows], ctx[rows]).flatten(1).float()
        cos = 1 - torch.nn.functional.cosine_similarity(got, want, dim=-1)
        rel = torch.linalg.vector_norm(got - want, dim=-1) / torch.linalg.vector_norm(want, dim=-1)
        return float(cos.max()), float(rel.max())

    one_minus_cos, rel = unet_error()
    errors = {}
    for what, owner, name, slip in controls:
        with mock.patch.object(owner, name, slip):
            errors[what] = unet_error()
    log(f"[{path}] one UNet call, bf16 vs f32 on the same inputs: 1 - cos {one_minus_cos:.3e} (tol "
        f"{SD_DIRECTION_TOL}), relative L2 {rel:.3e} (tol {SD_REL_L2_TOL}); controls (1 - cos, relative L2): "
        + ", ".join(f"{k} ({c:.3e}, {r:.3e})" for k, (c, r) in errors.items()))
    if one_minus_cos > SD_DIRECTION_TOL or rel > SD_REL_L2_TOL:
        raise AssertionError(f"[{path}] the bf16 UNet parts from the f32 UNet")
    if not all(v > tol for v, tol in zip(errors[SD_CAUGHT_CONTROL], (SD_DIRECTION_TOL, SD_REL_L2_TOL))):
        raise AssertionError(f"[{path}] the limits no longer catch the control '{SD_CAUGHT_CONTROL}'")

    # -- the detector with SD references (no retriever: the staged path)
    dcfg = DetectorConfig(num_text_variants=V_DEFENDED, num_reference_images=n)
    recorded = []

    def references(t, k):
        recorded.append(gen.generate_reference_vectors(t, k))
        return recorded[-1]

    det = AdversarialDetector(model, dcfg, reference_generator=references)
    # warm-up of the references' resize to the CLIP size (the native
    # library builds at its first use)
    model.encode_image([np.zeros((cfg.image_size, cfg.image_size, 3), np.uint8)])
    reset_launch_counts()
    t0 = time.perf_counter()
    res = det.detect_batch(images, texts, variants)
    torch.cuda.synchronize()
    det_secs = time.perf_counter() - t0
    counts = launch_counts()
    log(f"[{path}] detector with SD references (B={N_SD}, V={V_DEFENDED}, R={n}): {N_SD / det_secs:.3f} queries/s "
        f"({det_secs:.3f} s, generation included); launches {counts} on {card['smi']}")
    _check_path_counts(counts, path, "detector with SD references")
    refs = recorded[-1]
    norms = np.linalg.norm(refs, axis=-1)
    if refs.shape != (N_SD, n, model.config.embed_dim) or not np.allclose(norms[norms > 0], 1.0, atol=1e-3) \
            or not np.all(np.isfinite(res.aggregated_score)):
        raise AssertionError(f"bad SD reference vectors {refs.shape} or scores")
    log(f"[{path}] generator stats {gen.get_stats()}: {int((norms > 0).sum())} of {N_SD * n} references kept by "
        f"the quality filter")

    # held against the plain versions, the same SD reference vectors passed in
    fixed = AdversarialDetector(model, dcfg, reference_generator=lambda t, k: refs)
    got = fixed.detect_batch(images, texts, variants)
    with ExitStack() as stack:
        for module, name, plain in ((clip_mod, "fused_attention_layer", attention_layer_reference),
                                    (clip_mod, "fused_mlp_layer", mlp_layer_reference),
                                    (det_mod, "fused_consistency_scores", consistency_scores_reference)):
            stack.enter_context(mock.patch.object(module, name, plain))
        want = fixed.detect_batch(images, texts, variants)
    thr = fixed.threshold_manager.get_threshold()
    d = np.abs(got.aggregated_score - want.aggregated_score)
    away = np.abs(want.aggregated_score - thr) > LAYER_TOL
    log(f"[{path}] kernel vs plain path on the same SD references: max |d aggregated| {d.max():.3e} (tol "
        f"{LAYER_TOL}); flags equal {int((got.is_adversarial == want.is_adversarial)[away].sum())} of the "
        f"{int(away.sum())} scores more than tol from the threshold {thr}; aggregated "
        f"{np.round(got.aggregated_score, 4).tolist()}")
    if d.max() > LAYER_TOL or not np.all((got.is_adversarial == want.is_adversarial)[away]):
        raise AssertionError(f"[{path}] the detector with SD references disagrees with its plain version")

    # the references' vision encode (N_SD * n resized 8-bit 512 px images, a
    # batch only this path encodes) against the same encode on the plain
    # versions, held by direction as phase mha holds a bf16 tower; with no
    # image filtered it is the batch the detector encoded, bit for bit
    pixels = [np.round(im * 255.0).astype(np.uint8) for im in a.reshape(-1, *a.shape[2:])]
    reset_launch_counts()
    with torch.no_grad():
        emb = model.encode_image(pixels).float()
    torch.cuda.synchronize()
    enc_counts = launch_counts()
    if {k for k, v in enc_counts.items() if v} != {"fused_attention_layer", "fused_mlp_layer"}:
        raise AssertionError(f"the references' encode launched {enc_counts}")
    with ExitStack() as stack:
        for name, plain in (("fused_attention_layer", attention_layer_reference),
                            ("fused_mlp_layer", mlp_layer_reference)):
            stack.enter_context(mock.patch.object(clip_mod, name, plain))
        with torch.no_grad():
            plain_emb = model.encode_image(pixels).float()
    if launch_counts() != enc_counts:
        raise AssertionError("the plain encode launched a kernel")
    enc_cos = float((1 - torch.nn.functional.cosine_similarity(emb, plain_emb, dim=-1)).max())
    same = np.array_equal(emb.cpu().numpy(), refs.reshape(-1, refs.shape[-1]))
    log(f"[{path}] the references' encode (B={len(pixels)}, {cfg.image_size} px resized to "
        f"{model.config.image_size}): launches {enc_counts}; kernel vs plain 1 - cos {enc_cos:.3e} (tol "
        f"{MHA_COS_TOL}), max |d| {float((emb - plain_emb).abs().max()):.3e}; equal to the detector's reference "
        f"vectors: {same}")
    if enc_cos > MHA_COS_TOL or not bool(torch.isfinite(emb).all()) \
            or (gen.stats["filtered_out"] == 0 and not same):
        raise AssertionError("the references' encode disagrees with its plain version or with the detector's")
    profile_batch(path, lambda: det.detect_batch(images, texts, variants))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{path}] peak memory over the phase {peak:.2f} GiB on {card['smi']}")
    out = {"launches": counts, "images_per_s": N_SD * n / gen_secs, "unet_step_ms": step_ms,
           "vae_decode_ms": dec_ms, "qps": N_SD / det_secs, "peak_gib": peak,
           "one_minus_cos": one_minus_cos, "relative_l2": rel, "controls": errors,
           "encode_one_minus_cos": enc_cos}
    del sd, gen, det, fixed
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase weights: train on the card, save and load published layouts
# ---------------------------------------------------------------------------

#: the full-width trainer: ViT-B/32 (bf16 compute, f32 parameters and
#: optimizer state) on one fixed batch of N_TRAIN rendered 224 px COCO
#: pairs, TRAIN_STEPS steps at TRAIN_LR, the first TRAIN_WARMUP untimed
N_TRAIN, TRAIN_STEPS, TRAIN_WARMUP, TRAIN_LR = 256, 20, 2, 1e-4
# The first step's loss (bf16 compute) against an f32 recomputation of the
# same forward on the same parameters, relative. bf16 rounds each
# activation to 2^-9 relative; the 512-d cosines then move by ~1e-3, the
# logits (x exp(logit_scale) = 14.3) by ~1e-2, and a cross entropy near
# log(256) = 5.5 by ~2e-3 relative. A wrong label, sign, scale or missing
# term moves it by O(1).
TRAIN_LOSS_TOL = 1e-2
#: the fixture's stop rule (train_clip_fixture_coco's defaults)
FIXTURE_RETRIEVAL, FIXTURE_CROSS_TEXT = 0.92, 0.45
#: prompts of the loaded Qwen2-1.5B's teacher-forced hold (x 5 variants)
N_WEIGHTS_PROMPTS = 64
WEIGHTS_DIR = REPO / "build" / "weights"
_SAFETENSORS_DTYPES = {"float32": "F32", "float16": "F16", "bfloat16": "BF16", "int64": "I64", "bool": "BOOL"}


def write_safetensors(path: Path, tensors: dict) -> None:
    """A ``.safetensors`` file (the card's machine has no safetensors
    package): the header's length as 8 little-endian bytes, the JSON
    header, then each tensor's bytes in order."""
    import torch

    path.parent.mkdir(parents=True, exist_ok=True)
    header, offset, raws = {}, 0, []
    for name, t in tensors.items():
        raw = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()
        header[name] = {"dtype": _SAFETENSORS_DTYPES[str(t.dtype).removeprefix("torch.")],
                        "shape": list(t.shape), "data_offsets": [offset, offset + raw.nbytes]}
        offset += raw.nbytes
        raws.append(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for raw in raws:
            f.write(raw)


def seeded_state_dict(shapes: dict, seed: int, dtype) -> dict:
    """Seeded values at the published names and shapes, drawn on the card
    and returned on the host in ``dtype``: weights of two or more axes (and
    the class embedding) N(0, 1 / fan_in) with fan_in the product of the
    axes after the first, norm weights 1 + N(0, 0.02^2), biases N(0, 0.02^2),
    ``position_ids`` 0..n-1 (int64), ``logit_scale`` log(1 / 0.07)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for name, shape in shapes.items():
        if name.endswith("position_ids"):
            out[name] = torch.arange(math.prod(shape), dtype=torch.int64).reshape(shape)
            continue
        if name == "logit_scale":
            out[name] = torch.tensor(math.log(1 / 0.07), dtype=dtype)
            continue
        t = torch.randn(shape, generator=gen, device="cuda")
        if len(shape) >= 2 or name.endswith("class_embedding"):
            t *= (math.prod(shape[1:]) if len(shape) >= 2 else shape[0]) ** -0.5
        else:
            t = t * 0.02 + (1.0 if name.endswith(".weight") else 0.0)
        out[name] = t.to(dtype).cpu()
    return out


def _trees_equal(a: dict, b: dict) -> bool:
    import torch

    from tvc_torch.models.clip import _flatten

    fa, fb = _flatten(a), _flatten(b)
    return set(fa) == set(fb) and all(torch.equal(torch.as_tensor(fa[k]).cpu(), torch.as_tensor(fb[k]).cpu())
                                      for k in fa)


def _weights_train(card: dict, bf16: dict) -> dict:
    """(a) make_train_step on the slice phase's ViT-B/32 at full width, then
    the trained weights installed and served through the layer kernels."""
    import dataclasses

    import torch

    import tvc_torch.models.clip as clip_mod
    import tvc_torch.parallel.steps as steps_mod
    from tvc_torch.core.kernels import attention_layer_reference, consistency_scores_reference, mlp_layer_reference
    from tvc_torch.data.loaders import render_caption_image
    from tvc_torch.models.clip import CLIPModule, _flatten, normalize_pixels
    from tvc_torch.parallel.steps import make_train_step

    det = bf16["detector"]
    model = det.model
    cfg, dev = model.config, model.device
    captions, _ = coco_variant_batch(N_TRAIN, 1)
    px = torch.as_tensor(np.stack([render_caption_image(c, cfg.image_size, noise_seed=i)
                                   for i, c in enumerate(captions)]), device=dev)
    tok = torch.as_tensor(model.tokenize(captions), dtype=torch.long, device=dev)
    step, state = make_train_step(model, None, TRAIN_LR)
    params0 = model.params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    p, s, losses = params0, state, []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for i in range(TRAIN_STEPS):
        if i == TRAIN_WARMUP:
            start.record()
        p, s, loss = step(p, s, px, tok)
        losses.append(loss)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    pairs_s = (TRAIN_STEPS - TRAIN_WARMUP) * N_TRAIN / (ms / 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(x) for x in losses]
    n_params = sum(v.numel() for v in _flatten(params0).values())
    log(f"[weights train] make_train_step on {cfg.model_name} ({n_params} parameters, {cfg.dtype} compute, f32 "
        f"parameters and AdamW state), B={N_TRAIN} rendered {cfg.image_size} px COCO pairs, lr {TRAIN_LR}: losses "
        f"{[round(x, 4) for x in losses]}; {pairs_s:.1f} training pairs/s over steps {TRAIN_WARMUP + 1}-"
        f"{TRAIN_STEPS} ({ms / (TRAIN_STEPS - TRAIN_WARMUP):.3f} ms a step, CUDA events), peak {peak:.2f} GiB on "
        f"{card['smi']}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError("[weights train] the loss is not finite or did not fall")
    f32 = CLIPModule(dataclasses.replace(cfg, dtype=torch.float32, fused_attention=False), device=dev)
    with torch.no_grad():
        _, _, logits = torch.func.functional_call(f32, _flatten(params0), (normalize_pixels(px), tok))
        labels = torch.arange(N_TRAIN, device=dev)
        want = float(0.5 * (torch.nn.functional.cross_entropy(logits, labels)
                            + torch.nn.functional.cross_entropy(logits.T, labels)))
    del f32
    rel = abs(losses[0] - want) / abs(want)
    log(f"[weights train] first step's loss {losses[0]:.6f} vs the f32 forward {want:.6f}: relative {rel:.3e} "
        f"(tol {TRAIN_LOSS_TOL})")
    if rel > TRAIN_LOSS_TOL:
        raise AssertionError("[weights train] the bf16 training loss parts from the f32 loss")
    profile_batch("weights train", lambda: step(p, s, px, tok))

    model.params = p
    images, texts, variants = bf16["inputs"]
    patches = [(clip_mod, "fused_attention_layer", attention_layer_reference),
               (clip_mod, "fused_mlp_layer", mlp_layer_reference),
               (steps_mod, "fused_consistency_scores", consistency_scores_reference)]
    held = hold_defended_batch("weights trained", det, images, texts, variants, patches)
    moved = float(np.abs(held["result"].aggregated_score - bf16["result"].aggregated_score).max())
    log(f"[weights train] the trained weights served: max |d aggregated| to the untrained batch {moved:.3e}")
    del p, s, state, params0
    return {"weights trained": {"launches": held["launches"], "pairs_per_s": pairs_s, "peak_gib": peak,
                                "losses": losses, "loss_f32_rel": rel}}


def _weights_fixture(card: dict) -> dict:
    """(b) train_clip_fixture_coco at its defaults to its stop rule, saved
    and read back bit-equal, served through the f32 layer kernels."""
    import torch

    import tvc_torch.models.clip as clip_mod
    import tvc_torch.parallel.steps as steps_mod
    from tvc_torch._flax_msgpack import read_state_dict
    from tvc_torch.core.kernels import attention_layer_reference, consistency_scores_reference, mlp_layer_reference
    from tvc_torch.data.loaders import COCOCaptionsDataset, DataConfig, load_coco_captions, render_caption_image
    from tvc_torch.detector import AdversarialDetector, DetectorConfig
    from tvc_torch.fixtures import EVAL_HOLDOUT, FIXTURE_COCO_META_PATH, save_fixture, train_clip_fixture_coco
    from tvc_torch.models.clip import CLIPConfig, CLIPModel, params_from_jax
    from tvc_torch.retrieval import MultiModalRetriever, RetrievalConfig
    from tvc_torch.serving import ServingConfig, ServingRuntime

    t0 = time.perf_counter()
    model, metrics = train_clip_fixture_coco(log=lambda m: log(f"[weights fixture] {m}"))
    total = time.perf_counter() - t0
    meta = json.loads(FIXTURE_COCO_META_PATH.read_text())
    keys = ("retrieval_accuracy", "pair_similarity", "variant_similarity", "cross_text_cos", "galmax_mean",
            "hub_feasible_frac", "step")
    log(f"[weights fixture] train_clip_fixture_coco() on the card: stopped at step {metrics['step']} after "
        f"{metrics['seconds']:.2f} s of training ({total:.2f} s with the corpus); port "
        + ", ".join(f"{k} {metrics[k]:.4f}" for k in keys[:-1])
        + "; the recorded JAX asset " + ", ".join(f"{k} {meta[k]}" for k in keys if k in meta)
        + f" on {card['smi']}")
    if not (metrics["retrieval_accuracy"] >= FIXTURE_RETRIEVAL and metrics["cross_text_cos"] >= FIXTURE_CROSS_TEXT):
        raise AssertionError("[weights fixture] the port did not reach the fixture's stop rule")
    path = WEIGHTS_DIR / "clip_tiny_coco.msgpack"
    save_fixture(model, metrics, path=path)
    tree = read_state_dict(path)
    if not _trees_equal(tree, model.params) or json.loads(path.with_suffix(".json").read_text())["step"] != \
            metrics["step"]:
        raise AssertionError("[weights fixture] the saved fixture does not read back bit-equal")
    log(f"[weights fixture] saved {path.stat().st_size} bytes of flax msgpack, read back bit-equal")

    n = B_ATTACK
    size = model.config.image_size
    batch = next(COCOCaptionsDataset(DataConfig(image_size=size, max_samples=n)).batches(batch_size=n))
    images, texts = batch["images"], list(batch["texts"])
    bank_caps = load_coco_captions()[n:EVAL_HOLDOUT]
    bank_imgs = np.stack([render_caption_image(c, size, noise_seed=int(i) % 2**31) for i, c in bank_caps])
    fused = CLIPModel(CLIPConfig.from_name("tiny_coco", fused_attention=True),
                      params=params_from_jax(tree, CLIPConfig.tiny_coco()))
    retriever = MultiModalRetriever(fused, RetrievalConfig())
    retriever.build_image_index(embeddings=model.encode_image(bank_imgs).float().cpu().numpy())
    cfg = ServingConfig(clip_model="tiny_coco_trained", drift_window=0, batch_max_size=n)
    det = AdversarialDetector(fused, retriever=retriever, config=DetectorConfig(
        num_text_variants=cfg.num_text_variants, text_bucket=cfg.text_bucket))
    served = _drive_tiny("weights fixture", ServingRuntime(cfg, detector=det), [
        (clip_mod, "fused_attention_layer", attention_layer_reference),
        (clip_mod, "fused_mlp_layer", mlp_layer_reference),
        (steps_mod, "fused_consistency_scores", consistency_scores_reference)], F32_LAYER_TOL,
        images, texts, (n // 2, n // 2))
    torch.cuda.empty_cache()
    return {"weights fixture": {"launches": served["launches"], "metrics": {k: metrics[k] for k in keys},
                                "seconds": metrics["seconds"], "total_seconds": total}}


def _weights_clip(card: dict, bf16: dict) -> dict:
    """(c) an HF CLIPModel-layout ViT-B/32 (openai/clip-vit-base-patch32's
    names and shapes, seeded) as model.safetensors and as
    pytorch_model.bin, each loaded by load_clip_weights; the trees
    bit-equal; the model served through the kernels."""
    import torch

    import tvc_torch.models.clip as clip_mod
    import tvc_torch.parallel.steps as steps_mod
    from tvc_torch.core.kernels import attention_layer_reference, consistency_scores_reference, mlp_layer_reference
    from tvc_torch.detector import AdversarialDetector, DetectorConfig
    from tvc_torch.models.clip import CLIPConfig
    from tvc_torch.models.loaders import clip_state_dict_shapes, load_clip_weights
    from tvc_torch.retrieval import MultiModalRetriever

    cfg = CLIPConfig.vit_b32(fused_attention=True)
    sd = seeded_state_dict(clip_state_dict_shapes(cfg), 11, torch.float32)
    n_params = sum(v.numel() for k, v in sd.items() if not k.endswith("position_ids"))
    root = WEIGHTS_DIR / "clip"
    write_safetensors(root / "safetensors" / "model.safetensors", sd)
    (root / "bin").mkdir(parents=True)
    torch.save(sd, root / "bin" / "pytorch_model.bin")
    del sd
    models, secs = {}, {}
    for fmt in ("safetensors", "bin"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        models[fmt] = load_clip_weights(cfg, str(root / fmt))
        torch.cuda.synchronize()
        secs[fmt] = time.perf_counter() - t0
        if models[fmt] is None:
            raise AssertionError(f"[weights clip] load_clip_weights found no checkpoint under {root / fmt}")
    same = _trees_equal(models["safetensors"].params, models["bin"].params)
    log(f"[weights clip] HF CLIPModel layout, {cfg.model_name}, {n_params} seeded parameters: load_clip_weights "
        f"{secs['safetensors']:.2f} s from model.safetensors, {secs['bin']:.2f} s from pytorch_model.bin; trees "
        f"bit-equal: {same} on {card['smi']}")
    if not same:
        raise AssertionError("[weights clip] the two formats load different trees")
    model = models.pop("safetensors")
    del models
    embs = np.random.default_rng(1).standard_normal((131072, cfg.embed_dim), dtype=np.float32)
    retriever = MultiModalRetriever(model)
    retriever.build_image_index(embeddings=embs)
    det = AdversarialDetector(model, DetectorConfig(num_text_variants=V_DEFENDED, num_reference_images=3,
                                                    retrieval_top_k=10, text_bucket=32), retriever=retriever)
    images, texts, variants = bf16["inputs"]
    held = hold_defended_batch("weights clip", det, images, texts, variants, [
        (clip_mod, "fused_attention_layer", attention_layer_reference),
        (clip_mod, "fused_mlp_layer", mlp_layer_reference),
        (steps_mod, "fused_consistency_scores", consistency_scores_reference)])
    del det, retriever, model
    torch.cuda.empty_cache()
    return {"weights clip": {"launches": held["launches"], "load_s": secs}}


def _weights_sd(card: dict, bf16: dict) -> dict:
    """(c) a diffusers-layout SD-1.5 checkout (unet/ and vae/, f16
    diffusion_pytorch_model.safetensors, seeded) through load_sd_weights,
    driven as the sd phase drives the native model."""
    import dataclasses

    import torch

    import tvc_torch.models.sd as sd_mod
    import tvc_torch.models.sd_hf as sd_hf_mod
    from tvc_torch.models.loaders import load_sd_weights, sd_unet_state_dict_shapes, sd_vae_state_dict_shapes
    from tvc_torch.models.sd_hf import HFUNet, HFUNetConfig

    root = WEIGHTS_DIR / "sd"
    n_params = 0
    for sub, shapes, seed in (("unet", sd_unet_state_dict_shapes(), 12), ("vae", sd_vae_state_dict_shapes(), 13)):
        sd = seeded_state_dict(shapes, seed, torch.float16)
        n_params += sum(v.numel() for v in sd.values())
        write_safetensors(root / sub / "diffusion_pytorch_model.safetensors", sd)
        del sd
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = load_sd_weights(str(root))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if model is None:
        raise AssertionError(f"[weights sd] load_sd_weights found no checkout under {root}")
    log(f"[weights sd] diffusers layout, SD-1.5 shapes, {n_params} seeded f16 parameters: load_sd_weights "
        f"{load_s:.2f} s into {type(model.unet).__name__} / {type(model.vae_enc).__name__} / "
        f"{type(model.vae_dec).__name__} ({model.config.image_size} px) on {card['smi']}")
    controls = (("GroupNorm statistics in bf16", sd_mod.GroupNorm, "forward", _gn_bf16_statistics),
                ("attention logits in bf16", sd_hf_mod, "_attend", _attend_bf16_logits),
                ("timestep embedding in bf16", sd_hf_mod, "hf_timestep_embedding", _timestep_embedding_bf16))
    res = drive_sd("weights sd", model, card, bf16,
                   lambda dev: HFUNet(dataclasses.replace(HFUNetConfig(), dtype=torch.float32), device=dev), controls)
    del model
    torch.cuda.empty_cache()
    res["load_s"] = load_s
    return {"weights sd": res}


def _weights_qwen(card: dict) -> dict:
    """(c) an HF Qwen2ForCausalLM-layout Qwen2-1.5B (the pipeline's model;
    BF16 safetensors, seeded) through load_qwen_weights, cast to bf16 and
    quantized to w8 as the pipeline phase builds it, its teacher-forced
    logits held against the plain w8 path."""
    import gc

    import torch

    from tvc_torch.models.loaders import load_qwen_weights, qwen_state_dict_shapes
    from tvc_torch.models.qwen import PARAPHRASE_PREFIX, PARAPHRASE_PROMPT, QwenConfig
    from tvc_torch.pipeline import PipelineConfig

    cfg = QwenConfig.qwen2_1_5b()
    path = WEIGHTS_DIR / "qwen" / "model.safetensors"
    sd = seeded_state_dict(qwen_state_dict_shapes(cfg), 14, torch.bfloat16)
    n_params = sum(v.numel() for v in sd.values())
    write_safetensors(path, sd)
    del sd
    gc.collect()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qwen = load_qwen_weights(cfg, str(path.parent), max_new_tokens=MAX_NEW, cast_params_bf16=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if qwen is None:
        raise AssertionError(f"[weights qwen] load_qwen_weights found no checkpoint under {path.parent}")
    qwen.quantize_weights_int8()
    log(f"[weights qwen] HF Qwen2ForCausalLM layout, {cfg.model_name} shapes, {n_params} seeded BF16 parameters "
        f"({path.stat().st_size / 2**30:.2f} GiB): load_qwen_weights {load_s:.2f} s, then w8 on {card['smi']}")
    texts = coco_captions(N_WEIGHTS_PROMPTS)
    inp = qwen.prepare([PARAPHRASE_PROMPT.format(text=x) for x in texts], PipelineConfig().num_text_variants, None,
                       PARAPHRASE_PREFIX)
    held = hold_w8_forced("weights qwen", qwen, inp)
    launched = {k for k, v in held["launches"].items() if v}
    qwen_kernels = {k for k in PATH_KERNELS["pipeline"] if k.startswith(("w8_", "decode_")) or k in DECODE_FUSED}
    if not launched or not launched <= qwen_kernels or not {"w8_matmul_stacked", "decode_gqa_attention_stacked"} \
            <= launched:
        raise AssertionError(f"[weights qwen] the decode launched {sorted(launched)}")
    del qwen, inp
    gc.collect()
    torch.cuda.empty_cache()
    held["load_s"] = load_s
    return {"weights qwen": held}


def phase_weights(card: dict, bf16: dict) -> dict:
    """The model lifecycle on the card: (a) make_train_step at full width
    and the trained weights through the kernels; (b) the tiny_coco fixture
    trained from scratch to its stop rule, saved, read back, served; (c)
    published layouts written under build/weights (HF CLIP in both formats,
    diffusers SD-1.5, HF Qwen2-1.5B), loaded and held. The files are
    deleted at the end."""
    import shutil

    out = {}
    try:
        with phase("weights: train"):
            out.update(_weights_train(card, bf16))
        with phase("weights: fixture"):
            out.update(_weights_fixture(card))
        with phase("weights: clip"):
            out.update(_weights_clip(card, bf16))
        with phase("weights: sd"):
            out.update(_weights_sd(card, bf16))
        with phase("weights: qwen"):
            out.update(_weights_qwen(card))
    finally:
        shutil.rmtree(WEIGHTS_DIR, ignore_errors=True)
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
    ``load_coco_captions()``, read from the bundled asset."""
    return coco_variant_batch(n, 0, order="captions")[0]


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
    most W8_MAX_ROWS rows (a larger one dequantizes, then matmuls). The
    fused kernels, in every run of the layers (the prefix prefill, the
    suffix prefill, each step): the first layer's norm (rmsnorm), every
    other norm after its residual add (add_rmsnorm: 2 L - 1, and the
    final norm's after the suffix prefill and each step), a SiLU-gated
    product a layer; and in each step a q|k|v epilogue a layer."""
    from tvc_torch.models.qwen import W8_MAX_ROWS

    w8a8 = cfg.quant_gemm == "w8a8"
    runs = lambda rows: int(rows > 0 and (w8a8 or rows <= W8_MAX_ROWS))
    L, decode_rows = cfg.num_layers, prompts * n_samples
    stacked = 4 * L * (runs(prefix_len) + runs(prompts * suffix_len) + steps * runs(decode_rows))
    head = 0 if cfg.tie_embeddings else runs(prompts) + steps * runs(decode_rows)
    gemm = "w8a8_matmul" if w8a8 else "w8_matmul"
    runs_of_layers = int(prefix_len > 0) + 1 + steps
    return {gemm: stacked + head, gemm + "_stacked": stacked,
            "decode_gqa_attention": L * steps, "decode_gqa_attention_stacked": L * steps,
            "rmsnorm": runs_of_layers, "add_rmsnorm": (2 * L - 1) * runs_of_layers + 1 + steps,
            "qkv_rope_cache": L * steps, "silu_mul": L * runs_of_layers}


def dsv2_step_launches(cfg, rows: int) -> dict:
    """Launches of one DeepseekV2Model decode step at ``rows`` rows, read
    off its _attention, _layer, _moe and _head: in every layer the q|kv_a
    and o GEMMs and one latent attention; the dense layers' gate|up and
    down, the MoE layers' shared gate|up and down and their two grouped
    expert GEMMs; the untied head. A w8 GEMM launches its kernel only at
    most W8_MAX_ROWS rows (a larger block dequantizes, then matmuls). The
    fused kernels: the first layer's norm (rmsnorm), every other norm
    after its residual add, the final one too (add_rmsnorm), the dense
    layers' SiLU-gated products and the MoE layers' two (routed, shared);
    in every layer the q|kv_a epilogue (mla_rope_cache: rope, the latent
    norm, the cache writes) and the output scales (mla_out); in every MoE
    layer the routing (moe_route) and the combine (moe_combine)."""
    from tvc_torch.models.deepseek_v2 import W8_MAX_ROWS

    L, n_moe = cfg.num_layers, cfg.n_moe_layers
    w8 = (4 * L + 1) if rows <= W8_MAX_ROWS else 0
    return {"w8_matmul": w8, "moe_w8_grouped_gemm": 2 * n_moe, "mla_decode_attention": L,
            "rmsnorm": 1, "add_rmsnorm": 2 * L, "silu_mul": cfg.first_k_dense + 2 * n_moe,
            "mla_rope_cache": L, "mla_out": L, "moe_route": n_moe, "moe_combine": n_moe}


def kimi_step_launches(cfg, rows: int) -> dict:
    """Launches of one KimiLinearModel decode step at ``rows`` rows, read
    off its _layer, _kda and DeepSeek-V2's _attention, _ffn, _moe and
    _head: DeepSeek-V2's (dsv2_step_launches) in the latent layers; in each
    KDA layer three w8 GEMMs (q|k|v|f_a|g_a|b, f_b|g_b, o) and its three
    kernels (kda_prepare, kda_recurrent, kda_gated_norm) in place of the
    latent attention's two GEMMs and three kernels; the norms, FFNs, MoE
    blocks and head as DeepSeek-V2's."""
    from tvc_torch.models.deepseek_v2 import W8_MAX_ROWS

    L, nk, n_moe = cfg.num_layers, len(cfg.kda_layers), cfg.n_moe_layers
    nm = L - nk
    w8 = (2 * nm + 3 * nk + 2 * L + 1) if rows <= W8_MAX_ROWS else 0
    return {"w8_matmul": w8, "moe_w8_grouped_gemm": 2 * n_moe, "mla_decode_attention": nm,
            "rmsnorm": 1, "add_rmsnorm": 2 * L, "silu_mul": cfg.first_k_dense + 2 * n_moe,
            "mla_rope_cache": nm, "mla_out": nm, "moe_route": n_moe, "moe_combine": n_moe,
            **dict.fromkeys(KDA, nk)}


def nemotron_step_launches(cfg, rows: int) -> dict:
    """Launches of one NemotronHModel decode step at ``rows`` rows, read
    off its _run_layers, _ssm, _gqa, DeepSeek-V2's _moe and the head: in
    each Mamba-2 block its W_in and W_out GEMMs and its three kernels
    (ssm_prepare, ssm_recurrent, ssm_gated_norm); in each attention block
    its q|k|v and W_o GEMMs, the cache write (qkv_cache) and one decode
    attention (the stacked wrapper launches the flat kernel); in each MoE
    block the routing, the two grouped expert GEMMs, the shared expert's
    two GEMMs, the squared ReLU of the routed and of the shared expert and
    the combine; the untied head. A w8 GEMM launches its kernel only at
    most W8_MAX_ROWS rows (a larger block dequantizes, then matmuls). The
    norms: the first block's (rmsnorm), every other block's after its
    residual add and the final one (add_rmsnorm)."""
    from tvc_torch.models.deepseek_v2 import W8_MAX_ROWS

    nm, na, ne = (len(cfg.blocks(kind)) for kind in "M*E")
    w8 = (2 * (nm + na + ne) + 1) if rows <= W8_MAX_ROWS else 0
    return {"w8_matmul": w8, "moe_w8_grouped_gemm": 2 * ne, "decode_gqa_attention": na,
            "decode_gqa_attention_stacked": na, "rmsnorm": 1, "add_rmsnorm": cfg.num_layers, "moe_route": ne,
            "moe_combine": ne, "relu2": 2 * ne, "qkv_cache": na, **dict.fromkeys(SSM, nm)}


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
        *plain_fused(qwen_mod),
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


def hold_w8_forced(path: str, qwen, inp) -> dict:
    """Teacher-forced logits of the w8 decode (weight-only int8 GEMMs and
    the decode attention kernels) against the same decode on the plain
    versions, prefill + N_FORCED - 1 steps over ``inp``'s rows, held to
    QWEN_MEDIAN_TOL / QWEN_MAX_TOL of the logits' RMS and QWEN_TOP1."""
    import torch

    import tvc_torch.models.qwen as qwen_mod
    from tvc_torch.core.kernels import decode_gqa_reference, launch_counts, reset_launch_counts, w8_matmul_plain

    kern_logits, plain_logits = [], []
    reset_launch_counts()
    toks = qwen.decode(inp, 0.8, seed=0,
                       on_logits=lambda i, lg: kern_logits.append(lg.clone()) if i < N_FORCED else None)
    counts_tf = launch_counts()
    plain_qwen = [
        (qwen_mod, "w8_matmul", w8_matmul_plain),
        (qwen_mod, "w8_matmul_stacked", lambda x, w, s, l: w8_matmul_plain(x, w[l], s[l])),
        (qwen_mod, "decode_gqa_attention_stacked", lambda q, k, v, m, l: decode_gqa_reference(q, k[l], v[l], m)),
        *plain_fused(qwen_mod),
    ]
    with ExitStack() as stack:
        for module, name, fn in plain_qwen:
            stack.enter_context(mock.patch.object(module, name, fn))
        qwen.decode(inp, 0.8, seed=0, forced=toks.T[:N_FORCED], on_logits=lambda i, lg: plain_logits.append(lg))
    torch.cuda.synchronize()
    if launch_counts() != counts_tf:
        raise AssertionError(f"[{path}] the plain Qwen run launched a kernel")
    a, b = torch.stack(kern_logits), torch.stack(plain_logits)
    if not bool(torch.isfinite(a).all()):
        raise AssertionError(f"[{path}] non-finite logits")
    d = (a - b).abs()
    rms = float(b.square().mean().sqrt())
    d_max, d_med = float(d.max()), float(d.median())
    top1 = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    log(f"[{path}] teacher-forced w8 kernel path vs plain, prefill + {N_FORCED - 1} steps x {a.shape[1]} rows: "
        f"max |d logit| {d_max:.4e}, median {d_med:.4e} (logit RMS {rms:.4f}); top-1 agreement {top1:.4f}; "
        f"launches {counts_tf}")
    if not (d_med <= QWEN_MEDIAN_TOL * rms and d_max <= QWEN_MAX_TOL * rms and top1 >= QWEN_TOP1):
        raise AssertionError(f"[{path}] the w8 kernel path disagrees with its plain version")
    return {"launches": counts_tf, "max_abs_d_logit": d_max, "median_abs_d_logit": d_med, "logit_rms": rms,
            "top1": top1}


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
        launch_counts,
        mlp_layer_i8_reference,
        reset_launch_counts,
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

    # -- one decode step at n_rows rows: its launches, no host sync
    step = step_launches("[pipeline]", qwen, inp)
    want_step = {k: n - qwen_expected_launches(cfg, P, 0, prompts=PIPE_PROMPTS, suffix_len=T, n_samples=V)[k]
                 for k, n in qwen_expected_launches(cfg, P, 1, prompts=PIPE_PROMPTS, suffix_len=T,
                                                    n_samples=V).items()}
    log(f"[pipeline] launches in decode step 1 at {n_rows} rows, no host synchronisation: {step}; expected "
        f"{want_step}")
    if any(step[k] != n for k, n in want_step.items()) or any(n for k, n in step.items() if k not in want_step):
        raise AssertionError(f"[pipeline] step launch counts {step}, expected {want_step}")

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
    forced = hold_w8_forced("pipeline", qwen, inp)

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
    return {"launches": counts, "step_launches": step, "qps": qps, "tok_s": tok_s, "ms_per_query": ms_q,
            "peak_gib": peak, "top1": forced["top1"], "d_max": forced["max_abs_d_logit"],
            "d_median": forced["median_abs_d_logit"], "llm_share": from_llm / slots, "stages_ms": stages}


def step_launches(tag: str, model, inp) -> dict:
    """The launches of decode step 1 of ``model.decode(inp)``: the counts
    reset as the step opens and read as step 2 opens, the step under
    set_sync_debug_mode("error") (a host synchronisation inside raises)."""
    import torch

    from tvc_torch.core.kernels import launch_counts, reset_launch_counts

    step = {}

    def at_step(i, logits):
        if i == 1:
            reset_launch_counts()
            torch.cuda.set_sync_debug_mode("error")
        elif i == 2:
            torch.cuda.set_sync_debug_mode("default")
            step.update(launch_counts())

    try:
        model.decode(inp, seed=0, on_logits=at_step)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if not step:
        raise AssertionError(f"{tag} the decode ran {model.last_decode_steps} steps: no second step to count")
    return step


def hold_dsv2_fused(model, inp, steps: int = 4) -> int:
    """``steps`` sampled decode steps of ``inp`` through DeepSeek-V2's own
    fused kernels, then the same tokens teacher-forced with each of them
    patched to its plain version: every step's logits bit-equal (the
    kernels return their plain versions' bits, so the layers' outputs
    agree exactly). Returns the steps held."""
    import torch

    import tvc_torch.models.deepseek_v2 as ds_mod
    from tvc_torch.core.kernels import dsv2_fused_kernel as dk

    got, plain = [], []
    toks = model.decode(inp, seed=0, forced=None, on_logits=lambda i, lg: got.append(lg.clone()))[:, :steps]
    with ExitStack() as stack:
        for n in DSV2_FUSED:
            stack.enter_context(mock.patch.object(ds_mod, n, getattr(dk, n + "_reference")))
        model.decode(inp, seed=0, forced=toks.T, on_logits=lambda i, lg: plain.append(lg))
    torch.cuda.synchronize()
    bad = [i for i in range(steps) if not torch.equal(got[i], plain[i])]
    log(f"[dsv2] {steps} decode steps at {toks.shape[0]} rows, fused kernels against their plain versions "
        f"(teacher-forced): logits bit-equal in {steps - len(bad)} of {steps} steps")
    if bad:
        worst = max(float((got[i].float() - plain[i].float()).abs().max()) for i in bad)
        raise AssertionError(f"[dsv2] steps {bad} differ from the plain versions (max |d| {worst:.3e})")
    return steps


def phase_dsv2(card: dict) -> dict:
    """DeepSeek-V2-Lite as the tvc-dsv2-lite-w8.fresh cell builds it
    (DeepseekV2Config.deepseek_v2_lite(), w8, seeded random weights drawn on
    the card a part at a time), decoding 192 COCO paraphrase prompts x 5
    samples: the launches of its second decode step, reset as the step
    opens and read as the next one opens, with the step under
    set_sync_debug_mode("error"), against dsv2_step_launches; then the
    paraphrase decode's tok/s and the peak memory. The model is freed."""
    import gc

    import torch

    from tvc_torch.models.decoding import PARAPHRASE_PREFIX, PARAPHRASE_PROMPT
    from tvc_torch.models.deepseek_v2 import DeepseekV2Config, DeepseekV2Model
    from tvc_torch.pipeline import PipelineConfig

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = DeepseekV2Config.deepseek_v2_lite()
    model = DeepseekV2Model(cfg, seed=0, max_new_tokens=MAX_NEW)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"[dsv2] model: {cfg.model_name} w8, {cfg.num_layers} x {cfg.hidden_size}, {cfg.n_routed_experts} routed "
        f"experts (top {cfg.num_experts_per_tok}) + {cfg.n_shared_experts} shared, seeded random weights, init "
        f"{init_s:.2f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    V = PipelineConfig().num_text_variants
    texts = coco_captions(PIPE_PROMPTS)
    rows = PIPE_PROMPTS * V
    inp = model.prepare([PARAPHRASE_PROMPT.format(text=x) for x in texts], V, None, PARAPHRASE_PREFIX)
    step = step_launches("[dsv2]", model, inp)
    want = dsv2_step_launches(cfg, rows)
    log(f"[dsv2] launches in decode step 1 at {rows} rows (prefix {inp.P} tokens, prompt {inp.plen} slots), no "
        f"host synchronisation: {step}; expected {want}")
    _check_path_counts(step, "dsv2", "one decode step")
    if any(step[k] != n for k, n in want.items()):
        raise AssertionError(f"[dsv2] launch counts {step}, expected {want}")
    held = hold_dsv2_fused(model, inp)

    times = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.generate_paraphrases_batch(texts, V, seed=i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t_med = statistics.median(times)
    tok_s = rows * MAX_NEW / t_med
    ms_q = 1e3 * t_med / PIPE_PROMPTS
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[dsv2] paraphrase decode {PIPE_PROMPTS} x {V} x {MAX_NEW} new tokens (batch {rows}): calls "
        f"{[round(x, 4) for x in times]} s, median {t_med:.4f} s: {tok_s:.1f} tok/s, {ms_q:.3f} ms/query; peak "
        f"memory {peak:.2f} GiB on {card['smi']}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": step, "rows": rows, "init_s": init_s, "tok_s": tok_s, "ms_per_query": ms_q,
            "peak_gib": peak, "fused_held_steps": held}


def phase_kimi(card: dict) -> dict:
    """Kimi-Linear-48B-A3B as the tvc-kimi-linear-48b-w8.fresh96 cell
    builds it (KimiLinearConfig.kimi_linear_48b(), w8, seeded random
    weights drawn on the card a part at a time), decoding 96 COCO
    paraphrase prompts x 5 samples (decode batch 480): the launches of its
    second decode step, reset as the step opens and read as the next one
    opens, with the step under set_sync_debug_mode("error"), against
    kimi_step_launches; then the paraphrase decode's tok/s and the peak
    memory (the f32 KDA state of 480 rows beside 46 GiB of weights). The
    model is freed."""
    import gc

    import torch

    from tvc_torch.models.decoding import PARAPHRASE_PREFIX, PARAPHRASE_PROMPT
    from tvc_torch.models.kimi_linear import KimiLinearConfig, KimiLinearModel
    from tvc_torch.pipeline import PipelineConfig

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = KimiLinearConfig.kimi_linear_48b()
    model = KimiLinearModel(cfg, seed=0, max_new_tokens=MAX_NEW)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"[kimi] model: {cfg.model_name} w8, {cfg.num_layers} x {cfg.hidden_size} ({len(cfg.kda_layers)} KDA, "
        f"{len(cfg.mla_layers)} latent), {cfg.n_routed_experts} routed experts (top {cfg.num_experts_per_tok}) + "
        f"{cfg.n_shared_experts} shared, seeded random weights, init {init_s:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    V = PipelineConfig().num_text_variants
    texts = coco_captions(KIMI_PROMPTS)
    rows = KIMI_PROMPTS * V
    inp = model.prepare([PARAPHRASE_PROMPT.format(text=x) for x in texts], V, None, PARAPHRASE_PREFIX)
    step = step_launches("[kimi]", model, inp)
    want = kimi_step_launches(cfg, rows)
    log(f"[kimi] launches in decode step 1 at {rows} rows (prefix {inp.P} tokens, prompt {inp.plen} slots), no "
        f"host synchronisation: {step}; expected {want}")
    _check_path_counts(step, "kimi", "one decode step")
    if any(step[k] != n for k, n in want.items()):
        raise AssertionError(f"[kimi] launch counts {step}, expected {want}")

    times = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.generate_paraphrases_batch(texts, V, seed=i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t_med = statistics.median(times)
    tok_s = rows * MAX_NEW / t_med
    ms_q = 1e3 * t_med / KIMI_PROMPTS
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[kimi] paraphrase decode {KIMI_PROMPTS} x {V} x {MAX_NEW} new tokens (batch {rows}): calls "
        f"{[round(x, 4) for x in times]} s, median {t_med:.4f} s: {tok_s:.1f} tok/s, {ms_q:.3f} ms/query; peak "
        f"memory {peak:.2f} GiB on {card['smi']}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": step, "rows": rows, "init_s": init_s, "tok_s": tok_s, "ms_per_query": ms_q,
            "peak_gib": peak}


def phase_nemotron(card: dict) -> dict:
    """NVIDIA-Nemotron-3-Nano-30B-A3B as the
    tvc-nemotron3-nano-30b-w8.fresh128 cell builds it
    (NemotronHConfig.nemotron3_nano_30b(), w8, seeded random weights drawn
    on the card a part at a time), decoding 128 COCO paraphrase prompts x 5
    samples (decode batch 640): the launches of its second decode step,
    reset as the step opens and read as the next one opens, with the step
    under set_sync_debug_mode("error"), against nemotron_step_launches; then
    the paraphrase decode's tok/s and the peak memory (the f32 Mamba-2
    state of 640 rows beside 30 GiB of weights). The model is freed."""
    import gc

    import torch

    from tvc_torch.models.decoding import PARAPHRASE_PREFIX, PARAPHRASE_PROMPT
    from tvc_torch.models.nemotron_h import NemotronHConfig, NemotronHModel
    from tvc_torch.pipeline import PipelineConfig

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = NemotronHConfig.nemotron3_nano_30b()
    model = NemotronHModel(cfg, seed=0, max_new_tokens=MAX_NEW)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"[nemotron] model: {cfg.model_name} w8, {cfg.num_layers} blocks x {cfg.hidden_size} "
        f"({len(cfg.blocks('M'))} Mamba-2, {len(cfg.blocks('*'))} attention, {cfg.n_moe_layers} MoE), "
        f"{cfg.n_routed_experts} routed experts (top {cfg.num_experts_per_tok}) + {cfg.n_shared_experts} shared, "
        f"seeded random weights, init {init_s:.2f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    V = PipelineConfig().num_text_variants
    texts = coco_captions(NEMOTRON_PROMPTS)
    rows = NEMOTRON_PROMPTS * V
    inp = model.prepare([PARAPHRASE_PROMPT.format(text=x) for x in texts], V, None, PARAPHRASE_PREFIX)
    step = step_launches("[nemotron]", model, inp)
    want = nemotron_step_launches(cfg, rows)
    log(f"[nemotron] launches in decode step 1 at {rows} rows (prefix {inp.P} tokens, prompt {inp.plen} slots), "
        f"no host synchronisation: {step}; expected {want}")
    _check_path_counts(step, "nemotron", "one decode step")
    if any(step[k] != n for k, n in want.items()):
        raise AssertionError(f"[nemotron] launch counts {step}, expected {want}")

    times = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.generate_paraphrases_batch(texts, V, seed=i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t_med = statistics.median(times)
    tok_s = rows * MAX_NEW / t_med
    ms_q = 1e3 * t_med / NEMOTRON_PROMPTS
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[nemotron] paraphrase decode {NEMOTRON_PROMPTS} x {V} x {MAX_NEW} new tokens (batch {rows}): calls "
        f"{[round(x, 4) for x in times]} s, median {t_med:.4f} s: {tok_s:.1f} tok/s, {ms_q:.3f} ms/query; peak "
        f"memory {peak:.2f} GiB on {card['smi']}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": step, "rows": rows, "init_s": init_s, "tok_s": tok_s, "ms_per_query": ms_q,
            "peak_gib": peak}


# ---------------------------------------------------------------------------
# phase mha: the module vision tower through fused_mha
# ---------------------------------------------------------------------------

B_MHA, B_MHA_L14 = 256, 64


def _images_per_s(run, B: int, iters: int = 5) -> float:
    import torch

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    torch.cuda.synchronize()
    return B * iters / (time.perf_counter() - t0)


# The module tower with fused_mha against the einsum module on the same
# parameters. Both are bf16 towers whose attention agrees to an ulp, but
# an ulp of one layer's bf16 activations moves later layers' roundings,
# and through 12-24 random-weight layers the features of two correct bf16
# paths part by 3-5e-2 of max(1, |y|) element by element (each as far from
# the same tower in f32), while their directions agree to ~1e-4. So the
# features are held by direction (1 - cos <= MHA_COS_TOL for every image)
# and by accuracy: their distance from the f32 module on the same
# parameters within MHA_F32_RATIO times the einsum module's. A wrong head,
# row or scale moves every feature by O(1).
MHA_COS_TOL, MHA_F32_RATIO = 1e-3, 2.0


def _mha_encode(model, px, path: str):
    """One inference-module encode with the launch counts set to 0 just
    before and read just after: one fused_mha launch per vision layer
    (Attention calls it whenever it has no mask, and only the vision tower
    has none) and no other kernel; the features held against the einsum
    module and the f32 module on the same parameters."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from tvc_torch.core.kernels import launch_counts, reset_launch_counts
    from tvc_torch.models.clip import CLIPModel

    reset_launch_counts()
    with torch.no_grad():
        feats = model.inference_module.encode_image(px)
    torch.cuda.synchronize()
    counts = launch_counts()
    _check_path_counts(counts, path, "one inference_module.encode_image")
    if counts["fused_mha"] != model.config.vision_layers:
        raise AssertionError(f"[{path}] {counts['fused_mha']} fused_mha launches, expected one a vision layer "
                             f"({model.config.vision_layers})")
    f32 = CLIPModel(dataclasses.replace(model.config, dtype=torch.float32), params=model.params)
    with torch.no_grad():
        ref = model.module.encode_image(px)  # the einsum path, bf16
        truth = f32.module.encode_image(px)  # the einsum path in f32
    del f32
    errs = {
        "fused_mha vs einsum": _layer_error(feats, ref)[1],
        "fused_mha vs f32": _layer_error(feats, truth)[1],
        "einsum vs f32": _layer_error(ref, truth)[1],
        "1 - cos(fused_mha, einsum)": float((1 - F.cosine_similarity(feats.float(), ref.float())).max()),
    }
    if feats.shape != ref.shape or not bool(torch.isfinite(feats).all()) \
            or errs["1 - cos(fused_mha, einsum)"] > MHA_COS_TOL \
            or errs["fused_mha vs f32"] > MHA_F32_RATIO * errs["einsum vs f32"]:
        raise AssertionError(f"[{path}] the fused_mha tower disagrees: {errs} (scaled by max(1, |y|))")
    return feats, counts, errs


def phase_mha(card: dict) -> dict:
    """CLIPModel(CLIPConfig.vit_b32(fused_attention=True)) with seeded
    weights: inference_module.encode_image at B=256, 224 px, held against
    the einsum module on the same parameters (bf16 layers on both sides:
    LAYER_TOL); images/s of the einsum module, the module with fused_mha and
    the layer kernels (infer_image_features); then ViT-L/14 once at B=64."""
    import gc

    import torch

    from tvc_torch.models.clip import CLIPConfig, CLIPModel, normalize_pixels

    gc.collect()
    torch.cuda.empty_cache()
    model = CLIPModel(CLIPConfig.vit_b32(fused_attention=True), seed=0)
    size = model.config.image_size
    gen = torch.Generator(device="cuda").manual_seed(21)
    px = normalize_pixels(torch.rand((B_MHA, size, size, 3), generator=gen, device="cuda"))
    feats, counts, errs = _mha_encode(model, px, "mha")
    log(f"[mha] ViT-B/32 inference_module.encode_image B={B_MHA}: launches {counts}; features (max over "
        f"elements of |d| / max(1, |y|)) {errs}")
    with torch.no_grad():
        rates = {
            "einsum module": _images_per_s(lambda: model.module.encode_image(px), B_MHA),
            "module with fused_mha": _images_per_s(lambda: model.inference_module.encode_image(px), B_MHA),
            "layer kernels (infer_image_features)": _images_per_s(
                lambda: model.infer_image_features(model.params, px), B_MHA),
        }
    log(f"[mha] ViT-B/32 vision images/s at B={B_MHA}: "
        + ", ".join(f"{k} {v:.1f}" for k, v in rates.items()) + f" on {card['smi']}")
    with torch.no_grad():
        profile_batch("mha", lambda: model.inference_module.encode_image(px))

    large = CLIPModel(CLIPConfig.vit_l14(fused_attention=True), seed=0)
    px_l = normalize_pixels(torch.rand((B_MHA_L14, size, size, 3), generator=gen, device="cuda"))
    _, counts_l, errs_l = _mha_encode(large, px_l, "mha")
    with torch.no_grad():
        rate_l = _images_per_s(lambda: large.inference_module.encode_image(px_l), B_MHA_L14, iters=3)
    log(f"[mha] ViT-L/14 inference_module.encode_image B={B_MHA_L14}: launches {counts_l}; features {errs_l}; "
        f"{rate_l:.1f} images/s")
    del large, px_l
    return {"launches": counts, "model": model, "images_per_s": rates, "l14_images_per_s": rate_l,
            "errs": errs, "l14_errs": errs_l, "l14_launches": counts_l["fused_mha"]}


# ---------------------------------------------------------------------------
# phase retrieval: text and image indexes, both directions, bank_topk
# ---------------------------------------------------------------------------

N_RETRIEVAL_IMAGES, N_RETRIEVAL_QUERIES = 1024, 256
PHOTO_SIZES = ((640, 480), (500, 375), (320, 240))  # (width, height) of COCO-like photos


def coco_all_captions():
    """All 25,014 bundled COCO val2017 captions, in file order."""
    with gzip.open(REPO / "tvc" / "assets" / "coco_captions_val2017.json.gz", "rt") as f:
        return [cap.strip() for _, cap in json.load(f)]


def _photos(n: int, seed: int):
    """n seeded PIL RGB images cycling through PHOTO_SIZES."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        w, h = PHOTO_SIZES[i % len(PHOTO_SIZES)]
        out.append(Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)))
    return out


def _tied_unit_rows(rng, n_base: int, D: int):
    """n_base unit vectors of +-0.5 on four coordinates: every inner
    product of two of them is a multiple of 0.25, exact in any order."""
    base = np.zeros((n_base, D), np.float32)
    for r in base:
        r[rng.choice(D, 4, replace=False)] = rng.choice([-0.5, 0.5], 4)
    return base


def _first_members(group_of: np.ndarray, idx: np.ndarray) -> bool:
    """Each row of idx is the first len(row) members (ascending) of the
    group its first entry belongs to: exact ties ordered lower index first."""
    for row in idx:
        members = np.flatnonzero(group_of == group_of[row[0]])[: len(row)]
        if not np.array_equal(row, members):
            return False
    return True


def check_tie_order(model) -> dict:
    """Equal scores come out lower index first on the card: raw torch.topk
    (recorded, not held), EmbeddingBank.search and the serving step's bank
    top-k (held) over a 131,072-row bank of six repeated unit rows, where
    the top-k of every query is an exact tie."""
    import torch

    from tvc_torch.bank import EmbeddingBank
    from tvc_torch.parallel.steps import make_serving_step

    rng = np.random.default_rng(31)
    D, N, K = model.config.embed_dim, 131072, 10
    base = _tied_unit_rows(rng, 6, D)
    group_of = rng.integers(0, 6, N)
    bank = base[group_of]
    q = torch.as_tensor(base[rng.integers(0, 6, 32)], device="cuda")
    bank_t = torch.as_tensor(bank, device="cuda")
    raw = torch.topk(q @ bank_t.T, K).indices.cpu().numpy()
    raw_ok = _first_members(group_of, raw)
    _, idx = EmbeddingBank(D).build(bank).search(q, K)
    search_ok = _first_members(group_of, idx.cpu().numpy())
    step = make_serving_step(model, top_k=K, num_refs=3)
    B, V = 32, 2
    caps = coco_all_captions()[: B * (V + 1)]
    tokens = np.asarray(model.tokenize(caps))
    out = step(model.params, np.random.default_rng(3).random((B, 224, 224, 3), dtype=np.float32), tokens[:B],
               tokens[B:].reshape(B, V, -1), np.ones((B, V), bool), bank_t, np.ones(N, bool),
               np.asarray([0.4, 0.4, 0.2], np.float32), np.float32(-np.inf), np.float32(0.5))
    step_ok = _first_members(group_of, out["ref_idx"].cpu().numpy().astype(np.int64))
    res = {"raw torch.topk": raw_ok, "EmbeddingBank.search": search_ok, "serving step": step_ok}
    log(f"[retrieval] exact ties ordered lower index first on the card: {res}")
    if not (search_ok and step_ok):
        raise AssertionError(f"tie order differs from lax.top_k's: {res}")
    return res


def phase_retrieval(card: dict, mha: dict) -> dict:
    """The retriever over phase mha's ViT-B/32 bf16 fused_attention model:
    a text index of all 25,014 bundled COCO captions, an image index of
    1,024 seeded PIL photos of mixed sizes (resized natively), 256 queries
    each way, the similarity matrix, bank_topk over the text bank (the same
    rows as text_bank.search except at ties within 1e-5), detect_adversarial
    on one photo twice (the second a cache hit), and the tie-order check.
    The launch counts cover the whole phase."""
    import torch

    from tvc_torch.core.kernels import bank_topk, launch_counts, reset_launch_counts
    from tvc_torch.core.similarity import l2_normalize
    from tvc_torch.detector import AdversarialDetector, DetectorConfig
    from tvc_torch.models.clip import preprocess_images
    from tvc_torch.retrieval import MultiModalRetriever

    model = mha["model"]
    caps = coco_all_captions()
    photos = _photos(N_RETRIEVAL_IMAGES, seed=41)
    t0 = time.perf_counter()
    preprocess_images(photos[:256], model.config.image_size)
    host_ms = 1e3 * (time.perf_counter() - t0) / 256
    log(f"[retrieval] native resize + normalize of 256 photos ({PHOTO_SIZES} px): {host_ms:.3f} host ms per image")

    reset_launch_counts()
    retriever = MultiModalRetriever(model)
    t0 = time.perf_counter()
    retriever.build_text_index(caps)
    torch.cuda.synchronize()
    text_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    retriever.build_image_index(photos)
    torch.cuda.synchronize()
    image_s = time.perf_counter() - t0
    log(f"[retrieval] text index: {retriever.text_bank.size} captions in {text_s:.2f} s; image index: "
        f"{retriever.image_bank.size} photos in {image_s:.2f} s")

    nq = N_RETRIEVAL_QUERIES
    t0 = time.perf_counter()
    by_image = retriever.retrieve_texts_by_image(photos[:nq])
    by_text = retriever.retrieve_images_by_text(caps[:nq])
    sim = retriever.compute_similarity_matrix(caps[:nq])
    torch.cuda.synchronize()
    query_s = time.perf_counter() - t0
    for name, res in (("texts by image", by_image), ("images by text", by_text)):
        if res.indices.shape != (nq, 10) or not np.all(np.isfinite(res.scores)) or len(res.items) != nq:
            raise AssertionError(f"[retrieval] bad {name} result")
    if sim.shape != (nq, N_RETRIEVAL_IMAGES) or not np.all(np.isfinite(sim)):
        raise AssertionError(f"[retrieval] similarity matrix {sim.shape}")
    # the query images' features: bank_topk's queries over the text bank
    img = l2_normalize(torch.as_tensor(np.asarray(retriever._encode_images_batched(photos[:nq])), device="cuda"))
    if float(np.abs(np.take_along_axis(sim, by_text.indices, 1) - by_text.scores).max()) > TOPK_TOL:
        raise AssertionError("[retrieval] similarity matrix and t2i scores disagree")
    log(f"[retrieval] {nq} queries each way + the {sim.shape} similarity matrix in {query_s:.2f} s; first image's "
        f"captions {by_image.items[0][:3]}")

    # bank_topk over the text bank against text_bank.search
    tb = retriever.text_bank
    got = bank_topk(img, tb._bank, 10, n_valid=tb.size, normalize=False)
    sv, si = tb.search(img, 11)
    agree = topk_agreement(got, (sv[:, :10], si[:, :10].to(torch.int32), sv[:, 10]), img, tb._bank)
    log(f"[retrieval] bank_topk over the {tb.size}-caption text bank vs text_bank.search: {agree}")

    # detect_adversarial on one photo, twice
    det = AdversarialDetector(model, DetectorConfig(num_text_variants=V_DEFENDED), retriever=retriever)
    photo = _photos(1, seed=43)[0]
    first = det.detect_adversarial(photo, caps[0])
    second = det.detect_adversarial(photo, caps[0])
    if det.stats["cache_hits"] != 1 or second != first or not np.isfinite(first["aggregated_score"]):
        raise AssertionError(f"[retrieval] detect_adversarial cache: {det.stats}, {first} vs {second}")
    torch.cuda.synchronize()
    counts = launch_counts()
    _check_path_counts(counts, "retrieval", "the retrieval phase")
    log(f"[retrieval] detect_adversarial({photo.size} photo): {first['aggregated_score']:.4f}, flagged "
        f"{first['is_adversarial']}, second call a cache hit; launches over the phase {counts}")
    ties = check_tie_order(model)
    return {"launches": counts, "host_ms_per_image": host_ms, "text_index_s": text_s, "image_index_s": image_s,
            "topk": agree, "ties": ties}


# ---------------------------------------------------------------------------
# phase harness: the experiment harness and the command line
# ---------------------------------------------------------------------------

HARNESS_DIR = REPO / "build" / "harness"
#: the full-width four-scenarios run: 64 samples; the retrieval bank is cut
#: from the harness default of 4,096 to 1,024 rendered 224 px images (host
#: render time, ~12 ms an image)
N_HARNESS, HARNESS_BANK = 64, 1024
HARNESS_ATTACKS = ("pgd", "hubness")
#: every harness mode but comprehensive (which chains the others) on the
#: trained tiny_coco fixture, the harness default model
N_HARNESS_FIXTURE = 32
HARNESS_FIXTURE_MODES = ("four_scenarios", "defense_effectiveness", "baseline_comparison", "ablation_study",
                         "efficiency_analysis", "retrieval_quality", "cross_dataset", "adaptive_attack")
#: the modes that draw figures (emit_figures or their own)
HARNESS_FIGURE_MODES = ("four_scenarios", "defense_effectiveness", "baseline_comparison", "ablation_study")
#: the protocol's stages, each timed by the host clock around it (each ends
#: on host numpy)
HARNESS_STAGES = ("scenario_1_attack_no_defense", "scenario_2_clean_no_defense", "scenario_3_clean_with_defense",
                  "scenario_4_attack_with_defense", "epsilon_sweep")


def run_cli(argv) -> tuple:
    """One ``python -m tvc_torch.cli`` command in-process: (its standard
    output, the ExperimentHarness objects it built, host seconds)."""
    import contextlib
    import io

    from tvc_torch import cli
    from tvc_torch.experiments.harness import ExperimentHarness

    built = []
    init = ExperimentHarness.__init__

    def record(self, config):
        init(self, config)
        built.append(self)

    buf = io.StringIO()
    t0 = time.perf_counter()
    with mock.patch.object(ExperimentHarness, "__init__", record), contextlib.redirect_stdout(buf):
        cli._module_main([str(a) for a in argv])
    return buf.getvalue(), built, time.perf_counter() - t0


@contextmanager
def timed_methods(cls, names, into: dict, key=None):
    """Add the host seconds of each call of ``cls.<name>`` into
    ``into[key(name, args)]`` (default: the name)."""
    with ExitStack() as stack:
        for name in names:
            orig = getattr(cls, name)

            def wrapped(self, *args, _orig=orig, _name=name, **kw):
                t0 = time.perf_counter()
                try:
                    return _orig(self, *args, **kw)
                finally:
                    k = key(_name, args) if key else _name
                    into[k] = into.get(k, 0.0) + time.perf_counter() - t0

            stack.enter_context(mock.patch.object(cls, name, wrapped))
        yield


def _harness_full_width(card: dict) -> dict:
    """``defense --experiment-mode four_scenarios --clip-model ViT-B/32``
    through the CLI, then the clean scenario's batch held against the same
    harness pipeline on the plain consistency version."""
    import torch

    import tvc_torch.parallel.steps as steps_mod
    from tvc_torch.core.kernels import consistency_scores_reference, launch_counts, reset_launch_counts
    from tvc_torch.experiments.four_scenarios import FourScenariosConfig, FourScenariosExperiment

    argv = ["defense", "--experiment-mode", "four_scenarios", "--clip-model", "ViT-B/32", "--num-samples", N_HARNESS,
            "--bank-size", HARNESS_BANK, "--attacks", *HARNESS_ATTACKS, "--output-dir", HARNESS_DIR / "vitb32"]
    stages, attacks = {}, {}
    reset_launch_counts()
    with timed_methods(FourScenariosExperiment, HARNESS_STAGES, stages), \
            timed_methods(FourScenariosExperiment, ("_generate_adversarial_resumable",), attacks,
                          key=lambda _, args: args[2]):
        text, built, secs = run_cli(argv)
    torch.cuda.synchronize()
    counts = launch_counts()
    h = built[0]
    path = Path(json.loads(text)["output_path"])
    res = json.loads(path.read_text())
    if not path.with_suffix(".md").exists() or res["num_samples"] != N_HARNESS:
        raise AssertionError(f"harness result incomplete: {path}")
    # the protocol's detection batches (four_scenarios.run): the threshold
    # calibration (clean, first attack), scenario 3, scenario 4 (clean + one
    # per attack), one per sweep epsilon and gradient attack; one
    # fused_consistency_scores launch each (one pipeline batch of 64)
    fs = FourScenariosConfig()
    n_sweep = len(fs.sweep_epsilons) * sum(a in FourScenariosExperiment.SWEEP_ATTACKS for a in HARNESS_ATTACKS)
    want = 2 + 1 + (1 + len(HARNESS_ATTACKS)) + n_sweep
    log(f"[harness] launches in the four-scenarios run: {counts} (fused_consistency_scores expected {want})")
    _check_path_counts(counts, "harness", "four scenarios")
    if counts["fused_consistency_scores"] != want:
        raise AssertionError(f"harness: {counts['fused_consistency_scores']} consistency launches, expected {want}")
    summ = res["summary"]
    log(f"[harness] ViT-B/32 (seeded random weights) four scenarios, n={N_HARNESS}, bank {HARNESS_BANK} (cut from "
        f"4,096): {secs:.2f} s in all; set-up " + ", ".join(f"{k} {v:.2f} s" for k, v in h.setup_seconds.items())
        + "; attacks " + ", ".join(f"{k} {v:.2f} s" for k, v in attacks.items())
        + "; stages " + ", ".join(f"{k} {v:.2f} s" for k, v in stages.items()) + f" on {card['smi']}")
    log(f"[harness] AUROC {summ['auroc']}, detection rate {summ['detection_rate']}, clean FPR "
        f"{summ['false_positive_rate']:.4f}, staged defense overhead {summ['defense_overhead']:.4f} "
        f"(scenario 3 {res['scenario_3_defense_no_attack']['defense_time']:.4f} s vs scenario 2 "
        f"{res['scenario_2_no_defense_no_attack']['baseline_time']:.4f} s)")
    for name in HARNESS_ATTACKS:
        if not math.isfinite(summ["auroc"][name]):
            raise AssertionError(f"harness: AUROC of {name} is not finite")

    # the clean scenario's batch on the same harness pipeline, kernel vs plain
    pipe = h.make_pipeline()
    got = pipe.process_batch(h.images, h.texts)
    with mock.patch.object(steps_mod, "fused_consistency_scores", consistency_scores_reference):
        ref = pipe.process_batch(h.images, h.texts)
    d = np.abs(got.scores - ref.scores)
    thr = pipe.detector.threshold_manager.get_threshold()
    far = np.abs(ref.scores - thr) > CONSISTENCY_TOL
    log(f"[harness] clean batch kernel vs plain: max |d aggregated| {d.max():.3e}; flags equal on "
        f"{int(np.sum(got.is_adversarial[far] == ref.is_adversarial[far]))} / {int(far.sum())} rows off the threshold")
    if got.scores.shape != (N_HARNESS,) or d.max() > CONSISTENCY_TOL or np.any(
            got.is_adversarial[far] != ref.is_adversarial[far]):
        raise AssertionError("harness: the clean batch disagrees with its plain version")
    return {"launches": counts, "seconds": secs, "setup_s": dict(h.setup_seconds), "attack_s": attacks,
            "stage_s": stages, "auroc": summ["auroc"], "detection_rate": summ["detection_rate"],
            "defense_overhead": summ["defense_overhead"], "max_abs_d_aggregated": float(d.max())}


def _harness_fixture(card: dict) -> dict:
    """Every mode but comprehensive on the trained tiny_coco fixture, each
    through the CLI; the launch counts cover all of them."""
    import importlib.util

    import torch

    from tvc_torch.core.kernels import launch_counts, reset_launch_counts

    has_mpl = importlib.util.find_spec("matplotlib") is not None
    log(f"[harness fixture] matplotlib {'present' if has_mpl else 'missing'}: figures "
        f"{'drawn' if has_mpl else 'skipped, each result records figures: []'}")
    out = {"seconds": {}, "launches_by_mode": {}}
    reset_launch_counts()
    for mode in HARNESS_FIXTURE_MODES:
        before = launch_counts()
        text, built, secs = run_cli(["defense", "--experiment-mode", mode, "--num-samples", N_HARNESS_FIXTURE,
                                     "--output-dir", HARNESS_DIR / "fixture" / mode])
        torch.cuda.synchronize()
        h = built[0]
        path = Path(json.loads(text)["output_path"])
        res = json.loads(path.read_text())
        if not path.with_suffix(".md").exists():
            raise AssertionError(f"{mode}: no markdown report beside {path}")
        if mode in HARNESS_FIGURE_MODES:
            figs = res.get("figures")
            if has_mpl and not figs:
                raise AssertionError(f"{mode}: matplotlib is present but no figure was drawn ({h.figure_error})")
            if not has_mpl and (figs != [] or h.figure_error is None):
                raise AssertionError(f"{mode}: matplotlib is missing but figures are {figs}")
        if mode == "efficiency_analysis":
            trace = res["profiler_trace_dir"]
            if trace is None or not (Path(trace) / "trace.json.gz").exists():
                raise AssertionError(f"efficiency_analysis: no profiler trace ({trace})")
        extra = ""
        if mode == "four_scenarios":
            out["auroc"] = res["summary"]["auroc"]
            extra = f"; AUROC {res['summary']['auroc']}, detection rate {res['summary']['detection_rate']}"
        counts = launch_counts()
        out["launches_by_mode"][mode] = {k: counts[k] - before[k] for k in counts if counts[k] != before[k]}
        out["seconds"][mode] = secs
        log(f"[harness fixture] {mode}: {secs:.2f} s (set-up " + ", ".join(
            f"{k} {v:.2f}" for k, v in h.setup_seconds.items()) + f"), launches {out['launches_by_mode'][mode]}"
            + extra)
    out["launches"] = launch_counts()
    _check_path_counts(out["launches"], "harness fixture", "every mode")
    return out


def _harness_serving_overhead(card: dict) -> dict:
    """``measure_serving_overhead()`` at its defaults (ViT-B/32 int8 W8A8,
    B=256, a 131,072 x 512 bank, V=6, top-k 10), its launches against the
    code, then one defended step against the same step on the plain
    versions."""
    import torch

    import tvc_torch.experiments.four_scenarios as fs_mod
    import tvc_torch.models.clip as clip_mod
    from tvc_torch.core.kernels import (
        attention_layer_i8_reference,
        consistency_scores_reference,
        launch_counts,
        mlp_layer_i8_reference,
        reset_launch_counts,
    )

    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fs_mod.measure_serving_overhead()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    _check_path_counts(counts, "serving overhead", "measure_serving_overhead")

    steps = fs_mod.serving_overhead_steps()
    cfg = steps["model"].config
    reset_launch_counts()
    got = steps["defended"]()
    torch.cuda.synchronize()
    per_step = launch_counts()
    layers = cfg.vision_layers + cfg.text_layers * steps["text_passes"]
    want = {"fused_consistency_scores": 1, "fused_attention_layer_i8": layers, "fused_mlp_layer_i8": layers}
    base = {"fused_consistency_scores": 0, "fused_attention_layer_i8": cfg.vision_layers + cfg.text_layers,
            "fused_mlp_layer_i8": cfg.vision_layers + cfg.text_layers}
    calls = fs_mod.SERVING_WARMUP + fs_mod.SERVING_REPEATS  # each step's calls in the measurement
    log(f"[serving overhead] launches in one defended step: {per_step} (expected {want}; text passes "
        f"{steps['text_passes']}); in the whole measurement: {counts}")
    if any(per_step[k] != v for k, v in want.items()) or any(
            counts[k] != calls * (want[k] + base[k]) for k in want):
        raise AssertionError("serving overhead: launches differ from the code's")
    with ExitStack() as stack:
        for module, name, plain in ((fs_mod, "fused_consistency_scores", consistency_scores_reference),
                                    (clip_mod, "fused_attention_layer_i8", attention_layer_i8_reference),
                                    (clip_mod, "fused_mlp_layer_i8", mlp_layer_i8_reference)):
            stack.enter_context(mock.patch.object(module, name, plain))
        ref = steps["defended"]()
    torch.cuda.synchronize()
    same = np.all(np.sort(got["ref_idx"].cpu().numpy(), -1) == np.sort(ref["ref_idx"].cpu().numpy(), -1), -1)
    d = (got["aggregated"] - ref["aggregated"]).abs().cpu().numpy()
    flags = float((got["is_adversarial"] == ref["is_adversarial"]).float().mean())
    log(f"[serving overhead] defended {1e3 * out['defense_time_serving']:.3f} ms / baseline "
        f"{1e3 * out['baseline_time_serving']:.3f} ms a step at B={out['serving_batch_size']} (CUDA events, "
        f"{out['serving_chained_steps']} repetitions after {fs_mod.SERVING_WARMUP} warm-up), overhead {out['defense_overhead_serving']:.4f}; "
        f"peak {peak:.2f} GiB; {secs:.2f} s in all on {card['smi']}")
    log(f"[serving overhead] kernel vs plain: max |d aggregated| {d[same].max():.3e} over the {int(same.sum())} rows "
        f"with the same 10 references ({d.max():.3e} over all); flag agreement {flags:.4f}")
    # int8 quanta that flip where an f32 sum in another order crosses a .5
    # move the text features by ~1e-3, which can swap near-tied bank rows;
    # the layer tolerance holds on the rows scored against the same rows
    if same.mean() < 0.5 or d[same].max() > LAYER_TOL:
        raise AssertionError("serving overhead: the defended step disagrees with its plain version")
    return {**out, "launches": counts, "per_step": per_step, "peak_gib": peak, "seconds": secs,
            "same_refs": float(same.mean()), "max_abs_d_aggregated": float(d[same].max())}


def _harness_cli(card: dict) -> dict:
    """hardware-detect --probe, config-gen --no-write and a
    DynamicConfigManager on a temporary directory read back through the
    port's YAML reader, deploy --detect-only, build-bank at ViT-B/32 and
    analyze over every result the phase wrote."""
    import importlib.util
    import tempfile

    from tvc_torch import _yaml
    from tvc_torch.analysis.run_analysis import load_results, parse_results
    from tvc_torch.utils import DynamicConfigManager

    hw = json.loads(run_cli(["hardware-detect", "--probe"])[0])
    health = hw["health"]
    log(f"[harness cli] hardware-detect --probe: {json.dumps(hw)}")
    if not health["healthy"] or hw["platform"] != "gpu" or health["device"] != card["name"]:
        raise AssertionError(f"hardware-detect: {hw}")
    gen = json.loads(run_cli(["config-gen", "--no-write"])[0])
    with tempfile.TemporaryDirectory() as tmp:
        cfg = DynamicConfigManager(config_dir=tmp).auto_configure_system()
        back = _yaml.load((Path(tmp) / "dynamic" / "auto_generated_config.yaml").read_text())
    log(f"[harness cli] config-gen --no-write: profile {gen['profile']}; written to a temporary config_dir and "
        f"read back equal: {back == cfg}")
    if gen["profile"] != "gpu_single_card" or back != cfg or cfg["profile"] != "gpu_single_card":
        raise AssertionError(f"config-gen: {gen['profile']}, read back {back}")
    dep = run_cli(["deploy", "--detect-only"])[0]
    if not dep.startswith("hardware: "):
        raise AssertionError(f"deploy --detect-only printed {dep!r}")
    text, _, secs = run_cli(["build-bank", "--clip-model", "ViT-B/32", "--max-samples", 256,
                             "--output", HARNESS_DIR / "bank"])
    bank = json.loads(text.strip().splitlines()[-1])
    log(f"[harness cli] build-bank ViT-B/32: {bank} in {secs:.2f} s")
    if bank["image_bank"] != 256 or bank["text_bank"] != 256:
        raise AssertionError(f"build-bank: {bank}")
    charts = importlib.util.find_spec("matplotlib") is not None
    index = json.loads(run_cli(["analyze", "--results-dir", HARNESS_DIR] + ([] if charts else ["--no-charts"]))[0])
    parsed = parse_results(load_results(str(HARNESS_DIR)))
    log(f"[harness cli] analyze: {index['num_experiments']} results, families {index['families']}, "
        f"{len(parsed)} tables, {len(index['charts'])} charts; key findings {index['key_findings']}")
    missing = {"four_scenarios", "defense_effectiveness", "baseline_comparison", "ablation_study",
               "efficiency_analysis", "adaptive_attack"} - set(index["families"])
    if missing:
        raise AssertionError(f"analyze found no table of {missing}")
    return {"profile": gen["profile"], "bank": bank, "families": index["families"]}


def phase_harness(card: dict) -> dict:
    """The experiment harness and the CLI on the card; configs/ untouched."""
    auto = REPO / "configs" / "dynamic" / "auto_generated_config.yaml"
    before = auto.read_bytes()
    out = {"harness": _harness_full_width(card)}
    out["harness fixture"] = _harness_fixture(card)
    out["serving overhead"] = _harness_serving_overhead(card)
    out["cli"] = _harness_cli(card)
    if auto.read_bytes() != before:
        raise AssertionError("the harness phase wrote configs/dynamic/auto_generated_config.yaml")
    return out


# ---------------------------------------------------------------------------
# phase large bank: bank_topk where the [B, N] scores would not fit in L2
# ---------------------------------------------------------------------------

N_LARGE = 4_194_304


def phase_large_bank(card: dict) -> dict:
    """bank_topk at B=256 over a 4,194,304 x 512 f32 bank (8 GiB; the
    plain version's normalized copy another 8 GiB and its [B, N] scores 4
    GiB; the wrapper normalizes the bank rows inside the kernel and copies
    nothing) against its plain version: the wrapper's own peak memory, the
    phase's peak, a profile (partial and merge kernels)."""
    import gc

    import torch

    from tvc_torch.core.kernels import bank_topk, bank_topk_reference, launch_counts, reset_launch_counts
    from tvc_torch.core.similarity import l2_normalize

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    B, D, K = 256, 512, 10
    gen = torch.Generator(device="cuda").manual_seed(51)
    q = torch.randn((B, D), generator=gen, device="cuda")
    bank = torch.randn((N_LARGE, D), generator=gen, device="cuda")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    got = bank_topk(q, bank, K)
    torch.cuda.synchronize()
    counts = launch_counts()
    wrapper_extra = (torch.cuda.max_memory_allocated() - before) / 2**30  # beyond q and the bank
    wrapper_peak = torch.cuda.max_memory_allocated() / 2**30
    if counts["bank_topk"] != 1:
        raise AssertionError(f"[large bank] launches {counts}")
    v, i = bank_topk_reference(q, bank, K + 1)
    qn, bn = l2_normalize(q), l2_normalize(bank)
    agree = topk_agreement(got, (v[:, :K], i[:, :K], v[:, K]), qn, bn)
    del v, i
    k_ms = time_ms(lambda: bank_topk(qn, bn, K, normalize=False), iters=5, warmup=1)
    w_ms = time_ms(lambda: bank_topk(q, bank, K), iters=3, warmup=1)
    p_ms = time_ms(lambda: bank_topk_reference(qn, bn, K, normalize=False), iters=3, warmup=1)
    lib_ms = time_ms(lambda: torch.topk(qn @ bn.T, K), iters=3, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    bms, by = _topk_bound(B, N_LARGE, D, K)
    log(f"[large bank] bank_topk B={B} N={N_LARGE} D={D} k={K} f32: kernel_ms={k_ms:.4f} "
        f"wrapper_ms(with normalize)={w_ms:.4f} plain_ms={p_ms:.4f} library_ms(torch.topk(q @ bank.T))={lib_ms:.4f} "
        f"bound_ms={bms:.5f} ({by}); {agree}; the wrapper's peak memory {wrapper_peak:.2f} GiB ({wrapper_extra:.3f} "
        f"GiB beyond q and the bank), the phase's {peak:.2f} GiB (the plain version's copies) on {card['smi']}")
    merge_ms = _topk_merge_ms(qn, bn, K)
    log(f"[large bank] of the kernel's {k_ms:.4f} ms the merge kernel takes {merge_ms:.4f} ms "
        f"({100 * merge_ms / k_ms:.2f} %)")
    profile_batch("large bank", lambda: bank_topk(q, bank, K))  # the wrapper: the query normalize, then the kernels
    del bank, bn
    return {"launches": counts, "shape": {
        "shape": f"large bank B={B} N={N_LARGE} D={D} k={K} f32", "ms": k_ms, "wrapper_ms": w_ms, "plain_ms": p_ms,
        "bound_ms": bms, "bound_by": by, "max_abs_err": agree["max_abs_err"], "library_ms": lib_ms},
        "peak_gib": peak, "wrapper_peak_gib": wrapper_peak, "merge_ms": merge_ms}


def _topk_merge_ms(q, bank, k: int) -> float:
    """Device time of bank_topk's merge kernel alone, on the partial lists
    the partial kernel leaves for (q, bank) (the wrapper's split plan; the
    library's own calls, which count no launch)."""
    import torch

    from tvc_torch.core.kernels import _build
    from tvc_torch.core.kernels.topk_kernel import split_plan

    B, D = q.shape
    N = bank.shape[0]
    splits, rows = split_plan(B, N, torch.cuda.get_device_properties(q.device).multi_processor_count)
    pv = torch.empty((B, splits, k), dtype=torch.float32, device=q.device)
    pi = torch.empty((B, splits, k), dtype=torch.int32, device=q.device)
    vals = torch.empty((B, k), dtype=torch.float32, device=q.device)
    idx = torch.empty((B, k), dtype=torch.int32, device=q.device)
    lib = _build.load("bank_topk")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check(lib.tvc_bank_topk_partial(q.data_ptr(), bank.data_ptr(), None, None, None, pv.data_ptr(),
                                           pi.data_ptr(), B, N, D, k, rows, splits, 0, 0, 0, stream),
                 "tvc_bank_topk_partial")
    return time_ms(lambda: _build.check(lib.tvc_bank_topk_merge(pv.data_ptr(), pi.data_ptr(), vals.data_ptr(),
                                                                 idx.data_ptr(), B, splits, k, 0, stream),
                                        "tvc_bank_topk_merge"), iters=20)


#: profiler names shortened to the kernel and its template arguments
#: (the first match wins, so longer names come first)
# ---------------------------------------------------------------------------
# phase mesh: the mesh paths on torch.distributed
# ---------------------------------------------------------------------------

#: (b)'s sampler steps: the SD-1.5 shapes at 10 of the config's 20 DDIM
#: steps (the sd phase runs all 20; here both rank programs and the
#: single-device reference sample the same batch)
MESH_SD_STEPS = 10
#: world size 1 over NCCL: the same kernels as one device, the text rows
#: bucketed per shard (quantum 64) where one device buckets by 256 rows
MESH1_AGG_TOL = 1e-6
#: two ranks: each encodes half the batch, so the layer kernels run at
#: other row counts (other tiles and splits), which moves bf16 features by
#: rounding; int8 GEMMs sum exactly
MESH_AGG_TOL = 1e-3
#: ref_idx is held on the rows whose single-device k-th and (k+1)-th
#: scores differ by more than this
MESH_GAP_TOL = 1e-5
#: the DP steps against the single-device steps on the same batch (3 steps
#: at TRAIN_LR, ViT-B/32 bf16, B = 256), each limit about 3-4x the gap
#: measured on the H100 (the ranks' bf16 partial gradients round apart
#: from one device's whole-batch sums): every loss, relative (3.4e-5);
#: each leaf's AdamW first moment, an average of the gradients that keeps
#: their scale where Adam's update hides it, as the L2 norm of the
#: difference over the single device's (worst leaf 2.3e-2, the token
#: embedding; a gradient off by the data axis's 2 reads >= 0.5); the
#: parameter change since the start over all parameters, the same norm
#: (2.8e-2; a skipped or doubled update reads 1). The worst leaf's change is
#: printed, not held: the key biases' gradients are 0 (softmax ignores a
#: shift of every score), so Adam moves them by the sign of rounding noise
#: and they read ~0.5 on any two runs.
MESH_LOSS_TOL = 1e-4
MESH_MU_TOL = 0.1
MESH_UPDATE_TOL = 0.1


def _free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def mesh_spec(device=None) -> dict:
    """The mesh phase's configurations and sizes (full width on the card)."""
    import dataclasses

    from tvc_torch.models.clip import CLIPConfig
    from tvc_torch.models.qwen import QwenConfig
    from tvc_torch.models.sd import SDConfig

    return {
        "device": device, "check_counts": True,
        "clip": {"bf16": CLIPConfig.vit_b32(fused_attention=True),
                 "int8": CLIPConfig.vit_b32(fused_attention=True, int8_serving=True)},
        "bank": 131072, "B": B_DEFENDED, "V": V_DEFENDED, "train_B": N_TRAIN, "train_steps": 3,
        "qwen": dataclasses.replace(QwenConfig.qwen2_7b(), quant_gemm="w8a8"), "qwen_captions": 64,
        "qwen_new": MAX_NEW, "forced_rows": 64, "forced_steps": N_FORCED,
        "sd": SDConfig(), "sd_captions": N_SD, "sd_images": 3, "sd_steps": MESH_SD_STEPS,
    }


def _mesh_detector(spec: dict, kind: str, mesh, model=None):
    """(detector, model) over a 131,072-row bank built from the slice
    phase's seeded rows, sharded over ``mesh`` (None: one device)."""
    from tvc_torch.detector import AdversarialDetector, DetectorConfig
    from tvc_torch.models.clip import CLIPModel
    from tvc_torch.retrieval import MultiModalRetriever

    cfg = spec["clip"][kind]
    model = model or CLIPModel(cfg, seed=0, device=spec["device"])
    embs = np.random.default_rng(1).standard_normal((spec["bank"], cfg.embed_dim), dtype=np.float32)
    retriever = MultiModalRetriever(model, mesh=mesh)
    retriever.build_image_index(embeddings=embs)
    det = AdversarialDetector(
        model, DetectorConfig(num_text_variants=spec["V"], num_reference_images=3, retrieval_top_k=10,
                              text_bucket=32),
        retriever=retriever, device=model.device,
    )
    return det, model


def _mesh_batch(spec: dict, size: int):
    texts, variants = coco_variant_batch(spec["B"], spec["V"])
    images = np.random.default_rng(2).random((spec["B"], size, size, 3), dtype=np.float32)
    return images, texts, variants


def _safe_threshold(agg: np.ndarray) -> float:
    """The midpoint of the widest gap between neighbouring scores in the
    middle 80 % of the batch: a threshold as far from every score as the
    batch allows, so a small score difference flips no flag."""
    s = np.sort(np.asarray(agg, np.float64))
    lo, hi = len(s) // 10, len(s) - len(s) // 10
    i = lo + int(np.argmax(np.diff(s[lo:hi])))
    return float((s[i] + s[i + 1]) / 2)


def _mesh_detect(det, batch, spec: dict, path: str) -> tuple:
    """One detect_batch with the launch counts set to 0 just before and read
    just after (checked against ``path`` on the card)."""
    from tvc_torch.core.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    res = det.detect_batch(*batch)
    _sync(det.model.device)
    counts = launch_counts()
    if spec["check_counts"]:
        _check_path_counts(counts, path, "one mesh defended batch")
    return res, counts


def _timed_collectives():
    """Patches that time every all_gather / all_reduce of the serving step
    and the sharded bank (synchronized before and after), and the record."""
    import tvc_torch.bank.index as bank_index
    import tvc_torch.parallel.steps as steps_mod
    from tvc_torch.parallel import mesh as mesh_mod

    rec = {"all_gather": [0, 0.0], "all_reduce": [0, 0.0]}

    def timed(name):
        fn = getattr(mesh_mod, name)

        def run(x, *a, **kw):
            _sync(x.device)
            t0 = time.perf_counter()
            out = fn(x, *a, **kw)
            _sync(x.device)
            rec[name][0] += 1
            rec[name][1] += 1e3 * (time.perf_counter() - t0)
            return out
        return run

    patches = [mock.patch.object(mod, name, timed(name))
               for mod in (steps_mod, bank_index) for name in ("all_gather", "all_reduce") if hasattr(mod, name)]
    return patches, rec


def _mesh_world1(rank: int, n: int, spec: dict) -> dict:
    """(a): world size 1 over NCCL. Each path's detect_batch through a
    mesh-built retriever against the single-device detector on the same
    model and batch: flags and ref_idx equal, aggregated within
    MESH1_AGG_TOL; defended q/s of both; the collectives' ms a batch."""
    import torch

    from tvc_torch.parallel.mesh import create_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = create_mesh(device=spec["device"])
    out = {}
    for kind in ("bf16", "int8"):
        path = f"mesh {kind}"
        det_m, model = _mesh_detector(spec, kind, mesh)
        det_s, _ = _mesh_detector(spec, kind, None, model)
        batch = _mesh_batch(spec, model.config.image_size)
        thr = _safe_threshold(det_s.detect_batch(*batch).aggregated_score)
        for d in (det_m, det_s):
            d.threshold_manager.update(thr)
        res_m, counts = _mesh_detect(det_m, batch, spec, path)
        res_s = det_s.detect_batch(*batch)
        d_agg = float(np.abs(res_m.aggregated_score - res_s.aggregated_score).max())
        same_flags = bool(np.array_equal(res_m.is_adversarial, res_s.is_adversarial))
        same_idx = bool(np.array_equal(res_m.details["ref_idx"], res_s.details["ref_idx"]))
        log(f"[mesh world 1 {kind}] detect_batch B={spec['B']} V={spec['V']} top-k 10 over a {spec['bank']}-row "
            f"mesh bank vs the single-device detector: max |d aggregated| {d_agg:.3e} (tol {MESH1_AGG_TOL}), "
            f"flags equal {same_flags}, ref_idx equal {same_idx}, mesh {res_m.details['mesh']}; launches {counts}")
        if not (d_agg <= MESH1_AGG_TOL and same_flags and same_idx and res_m.details["mesh"]):
            raise AssertionError(f"[mesh world 1 {kind}] the mesh path parts from the single-device path")
        qps = {}
        for name, d in (("single", det_s), ("mesh", det_m), ("mesh", det_m), ("single", det_s)):
            _sync(model.device)
            t0 = time.perf_counter()
            for _ in range(3):
                d.detect_batch(*batch)
            _sync(model.device)
            qps.setdefault(name, []).append(3 * spec["B"] / (time.perf_counter() - t0))
        qps = {k: max(v) for k, v in qps.items()}
        patches, rec = _timed_collectives()
        with ExitStack() as stack:
            for p in patches:
                stack.enter_context(p)
            det_m.detect_batch(*batch)
        log(f"[mesh world 1 {kind}] defended queries/s: single device {qps['single']:.1f}, mesh at world 1 "
            f"{qps['mesh']:.1f} (x{qps['mesh'] / qps['single']:.4f}); collectives in one batch: "
            + ", ".join(f"{k} x{c} {ms:.3f} ms" for k, (c, ms) in rec.items()))
        out[kind] = {"launches": counts, "max_abs_d_aggregated": d_agg, "qps": qps,
                     "collectives": {k: {"calls": c, "ms": ms} for k, (c, ms) in rec.items()}}
        del det_m, det_s, model
        torch.cuda.empty_cache() if torch.cuda.is_available() else None
    return out


def _topk_recorder(store: list):
    """A stand-in for the serving step's top-k that also records the
    (k+1)-th score of every row."""
    from tvc_torch.core.kernels.topk_kernel import topk_index_order

    def run(sims, k):
        vals, idx = topk_index_order(sims, k + 1)
        store.append(vals.float().cpu().numpy())
        return vals[:, :k], idx[:, :k]
    return run


def _mesh_two_ranks(rank: int, n: int, spec: dict) -> dict:
    """(b): two gloo ranks sharing the card. Mesh serving (bf16, int8) at
    data = 2 over a bank sharded two ways, data-parallel ViT-B/32 training,
    Qwen2-7B W8A8 at TP = 2 and the SD-1.5 sampler at data = 2; then rank 0
    alone runs each single-device reference and holds the mesh results."""
    import dataclasses

    import torch

    import tvc_torch.parallel.steps as steps_mod
    from tvc_torch.data.loaders import render_caption_image
    from tvc_torch.models.clip import _flatten
    from tvc_torch.models.qwen import PARAPHRASE_PREFIX, PARAPHRASE_PROMPT, DecodeInputs, QwenModel
    from tvc_torch.models.sd import StableDiffusionModel
    from tvc_torch.parallel.mesh import MeshConfig, create_mesh
    from tvc_torch.parallel.steps import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = spec["device"]
    mesh = create_mesh(device=dev)
    tp_mesh = create_mesh(MeshConfig(axes=("model",)), device=dev)
    tag = f"[mesh 2 ranks, rank {rank}]"
    out, keep = {}, {}

    # -- mesh serving, data = 2 (128 queries a rank), bank sharded two ways
    for kind in ("bf16", "int8"):
        det, model = _mesh_detector(spec, kind, mesh)
        batch = _mesh_batch(spec, model.config.image_size)
        det.threshold_manager.update(_safe_threshold(det.detect_batch(*batch).aggregated_score))
        res, counts = _mesh_detect(det, batch, spec, f"mesh {kind}")
        _sync(model.device)
        t0 = time.perf_counter()
        for _ in range(3):
            det.detect_batch(*batch)
        _sync(model.device)
        qps = 3 * spec["B"] / (time.perf_counter() - t0)
        log(f"{tag} mesh {kind}: launches {counts}; {qps:.1f} defended queries/s (two ranks sharing one card)")
        out[kind] = {"launches": counts, "qps_shared_card": qps}
        keep[kind] = (res, det.threshold_manager.get_threshold(), model, batch)
        del det

    # -- data-parallel training, global B, a few steps
    model = keep["bf16"][2]
    captions, _ = coco_variant_batch(spec["train_B"], 1)
    size = model.config.image_size
    px = np.stack([render_caption_image(c, size, noise_seed=i) for i, c in enumerate(captions)])
    tok = np.asarray(model.tokenize(captions))
    step, state = make_train_step(model, mesh, TRAIN_LR)
    p, s, losses = model.params, state, []
    _sync(dev or "cuda")
    t0 = time.perf_counter()
    for _ in range(spec["train_steps"]):
        p, s, loss = step(p, s, px, tok)
        losses.append(float(loss))
    train_s = time.perf_counter() - t0
    pairs_s = spec["train_steps"] * spec["train_B"] / train_s
    log(f"{tag} DP training B={spec['train_B']}: losses {losses}, {pairs_s:.1f} pairs/s (first step included; two "
        f"ranks sharing one card)")
    out["train"] = {"losses": losses, "pairs_per_s_shared_card": pairs_s}
    keep["train"] = (p, s) if rank == 0 else None
    del p, s, state, step

    # -- Qwen2-7B W8A8 at TP = 2
    qcfg = spec["qwen"]
    t0 = time.perf_counter()
    tp = QwenModel(qcfg, seed=0, max_new_tokens=spec["qwen_new"], init_int8=True, mesh=tp_mesh)
    _sync(tp.device)
    init_s = time.perf_counter() - t0
    cap = coco_captions(spec["qwen_captions"])
    rows = np.asarray(tp.tokenizer(cap[: spec["forced_rows"]]))
    L = min(int((r != getattr(tp.tokenizer, "pad_id", 0)).sum()) for r in rows)
    ids = torch.as_tensor(rows[:, :L], dtype=torch.long, device=tp.device)
    forced = torch.as_tensor(np.random.default_rng(3).integers(1, min(32000, qcfg.vocab_size),
                                                                (spec["forced_steps"], len(ids))), device=tp.device)
    inp = DecodeInputs(prefix=torch.zeros(0, dtype=torch.long, device=tp.device), tokens=ids,
                       lengths=torch.full((len(ids),), L, device=tp.device), plen=L, n_samples=1, allowed=None,
                       n_real=0)
    seen = []
    tp.decode(inp, temperature=0.0, forced=forced, on_logits=lambda i, lg: seen.append(lg.float().cpu()))
    prompts = [PARAPHRASE_PROMPT.format(text=t) for t in cap]
    greedy_inp = tp.prepare(prompts, 3, shared_prefix=PARAPHRASE_PREFIX)
    tp.decode(greedy_inp, temperature=0.0)  # warm
    _sync(tp.device)
    t0 = time.perf_counter()
    tp_rows = tp.decode(greedy_inp, temperature=0.0).cpu().numpy()
    _sync(tp.device)
    tok_s = tp_rows.size / (time.perf_counter() - t0)
    log(f"{tag} Qwen TP=2 ({qcfg.model_name} int8, init {init_s:.2f} s): greedy decode of {len(cap)} captions x 3 "
        f"x {spec['qwen_new']} tokens {tok_s:.1f} tok/s (two ranks sharing one card)")
    out["qwen"] = {"tok_per_s_shared_card": tok_s, "init_s": init_s}
    keep["qwen"] = (ids.cpu(), forced.cpu(), torch.stack(seen), greedy_inp, tp_rows)
    del tp
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    # -- the SD sampler at data = 2
    sd = StableDiffusionModel(spec["sd"], seed=0, mesh=mesh)
    sd_caps = coco_captions(spec["sd_captions"])
    sd.generate_images_batch(sd_caps[:2], 1, seed=0, num_inference_steps=2)  # warm
    _sync(sd.device)
    t0 = time.perf_counter()
    imgs = sd.generate_images_batch(sd_caps, spec["sd_images"], seed=0, num_inference_steps=spec["sd_steps"])
    _sync(sd.device)
    n_img = len(sd_caps) * spec["sd_images"]
    img_s = n_img / (time.perf_counter() - t0)
    log(f"{tag} SD at data = 2: {n_img} images at {spec['sd'].image_size} px, {spec['sd_steps']} steps, "
        f"{img_s:.3f} images/s (two ranks sharing one card)")
    out["sd"] = {"images_per_s_shared_card": img_s}
    keep["sd"] = np.stack([np.stack(p) for p in imgs])
    del sd
    if rank:
        return out

    # ---- rank 0: the single-device references, after every collective;
    # every hold is read and printed before the first failure raises
    failed = []
    for kind in ("bf16", "int8"):
        res, thr, model, batch = keep[kind]
        det, _ = _mesh_detector(spec, kind, None, model)
        det.threshold_manager.update(thr)
        scores = []
        with mock.patch.object(steps_mod, "topk_index_order", _topk_recorder(scores)):
            ref = det.detect_batch(*batch)
        top = scores[-1]  # [B, k + 1] single-device scores
        clear = (top[:, -2] - top[:, -1]) > MESH_GAP_TOL
        gi, wi = res.details["ref_idx"], ref.details["ref_idx"]
        same_set = bool(np.array_equal(np.sort(gi[clear], -1), np.sort(wi[clear], -1)))
        lists = float(np.mean(np.all(gi == wi, -1)))
        d_agg = float(np.abs(res.aggregated_score - ref.aggregated_score).max())
        flags = bool(np.array_equal(res.is_adversarial, ref.is_adversarial))
        log(f"[mesh 2 ranks {kind}] vs the single-device detector: max |d aggregated| {d_agg:.3e} (tol "
            f"{MESH_AGG_TOL}); flags equal {flags} (threshold {thr:.6f}); ref_idx the same rows on the "
            f"{int(clear.sum())} of {len(clear)} rows whose k-th and (k+1)-th scores differ by > {MESH_GAP_TOL}: "
            f"{same_set}; whole lists equal on {lists:.4f} of the rows")
        if not (d_agg <= MESH_AGG_TOL and flags and same_set):
            failed.append(f"[mesh 2 ranks {kind}] the mesh path parts from the single-device path")
        out[kind].update(max_abs_d_aggregated=d_agg, ref_idx_lists_equal=lists, clear_rows=int(clear.sum()))
        del det

    model = keep["bf16"][2]
    step, state = make_train_step(model, None, TRAIN_LR, device=model.device)
    sp, ss, want = model.params, state, []
    for _ in range(spec["train_steps"]):
        sp, ss, loss = step(sp, ss, px, tok)
        want.append(float(loss))
    mp, ms = keep.pop("train")
    start, mp, sp = _flatten(model.params), _flatten(mp), _flatten(sp)
    m_mu, s_mu = _flatten(ms["mu"]), _flatten(ss["mu"])

    def _gap(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))

    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    mu_gap = max((_gap(m_mu[n], s_mu[n]), n) for n in s_mu)
    up_m = torch.cat([(mp[n] - start[n]).reshape(-1) for n in start])
    up_s = torch.cat([(sp[n] - start[n]).reshape(-1) for n in start])
    up_gap = _gap(up_m, up_s)
    leaves = sorted(((_gap(mp[n] - start[n], sp[n] - start[n]), n) for n in start), reverse=True)[:3]
    log(f"[mesh 2 ranks train] {spec['train_steps']} DP steps vs {spec['train_steps']} single-device steps on the "
        f"same batch: losses {losses} vs {want}, worst relative {loss_rel:.3e} (tol {MESH_LOSS_TOL}); AdamW first "
        f"moment, worst leaf |d| / |single| {mu_gap[0]:.3e} ({mu_gap[1]}; tol {MESH_MU_TOL}); parameter change "
        f"since the start, all parameters {up_gap:.3e} (tol {MESH_UPDATE_TOL}), worst leaves, not held: "
        + ", ".join(f"{n} {g:.3e}" for g, n in leaves))
    if not (loss_rel <= MESH_LOSS_TOL and mu_gap[0] <= MESH_MU_TOL and up_gap <= MESH_UPDATE_TOL):
        failed.append("[mesh 2 ranks train] the data-parallel steps part from the single-device steps")
    out["train"].update(single_losses=want, loss_rel=loss_rel, mu_gap=mu_gap[0], update_gap=up_gap,
                        worst_update_leaves=leaves)
    del up_m, up_s
    del step, state, sp, ss, mp, ms, m_mu, s_mu, start, keep["bf16"], keep["int8"], model
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    ids, forced, tp_logits, greedy_inp, tp_rows = keep["qwen"]
    single = QwenModel(qcfg, seed=0, max_new_tokens=spec["qwen_new"], init_int8=True, device=dev)
    seq = torch.cat([ids, forced.T[:, :-1]], dim=1).to(single.device)
    T = seq.shape[1]
    causal = torch.zeros((1, 1, T, T), device=single.device).masked_fill(
        ~torch.ones((T, T), dtype=torch.bool, device=single.device).tril(), float("-inf"))
    with torch.no_grad():
        logits, _ = single.module.apply(single.params, seq, torch.arange(T, device=single.device)[None].expand_as(seq),
                                        causal)
    # the decode's head computes in the model dtype (the JAX decode's
    # lm_head), the module's untied head in f32: held at bf16 logits, the
    # f32 reading printed beside it
    want_f32 = logits[:, ids.shape[1] - 1:].transpose(0, 1).float().cpu()
    del logits
    reads = {}
    for name, want in (("bf16", want_f32.to(qcfg.dtype).float()), ("f32", want_f32)):
        d = (tp_logits - want).abs()
        reads[name] = {"max_abs_d_logit": float(d.max()), "median_abs_d_logit": float(d.median()),
                       "logit_rms": float(want.square().mean().sqrt()),
                       "top1": float((tp_logits.argmax(-1) == want.argmax(-1)).float().mean())}
        del d, want
    rows_single = single.decode(greedy_inp, temperature=0.0).cpu().numpy()
    same_rows = float(np.mean(np.all(rows_single == tp_rows, -1)))
    r = reads["bf16"]
    log(f"[mesh 2 ranks qwen] TP=2 teacher-forced logits ({len(ids)} rows x {forced.shape[0]} steps = "
        f"{len(ids) * forced.shape[0]} pairs) vs the single-device module path, its head rounded to bf16: max |d| "
        f"{r['max_abs_d_logit']:.4e} (tol {QWEN_MAX_TOL * r['logit_rms']:.4e}), median {r['median_abs_d_logit']:.4e} "
        f"(tol {QWEN_MEDIAN_TOL * r['logit_rms']:.4e}), RMS {r['logit_rms']:.4f}, top-1 {r['top1']:.4f} (tol "
        f"{QWEN_TOP1}); its f32 head, not held: max |d| {reads['f32']['max_abs_d_logit']:.4e}, median "
        f"{reads['f32']['median_abs_d_logit']:.4e}, top-1 {reads['f32']['top1']:.4f}; greedy rows identical to the "
        f"single-device decode: {same_rows:.4f}")
    if not (r["median_abs_d_logit"] <= QWEN_MEDIAN_TOL * r["logit_rms"]
            and r["max_abs_d_logit"] <= QWEN_MAX_TOL * r["logit_rms"] and r["top1"] >= QWEN_TOP1):
        failed.append("[mesh 2 ranks qwen] the TP logits part from the single-device module path")
    out["qwen"].update(**r, f32_head=reads["f32"], identical_greedy_rows=same_rows)
    del single
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    sd = StableDiffusionModel(spec["sd"], seed=0, device=dev)
    want = np.stack([np.stack(p) for p in sd.generate_images_batch(
        sd_caps, spec["sd_images"], seed=0, num_inference_steps=spec["sd_steps"])])
    got = keep["sd"]
    g, w = got.reshape(n_img, -1).astype(np.float64), want.reshape(n_img, -1).astype(np.float64)
    cos = 1 - (g * w).sum(-1) / (np.linalg.norm(g, axis=-1) * np.linalg.norm(w, axis=-1))
    rel = np.linalg.norm(g - w, axis=-1) / np.linalg.norm(w, axis=-1)
    log(f"[mesh 2 ranks sd] images at data = 2 vs the single-device sampler on the same latents: 1 - cos "
        f"{cos.max():.3e} (tol {SD_DIRECTION_TOL}), relative L2 {rel.max():.3e} (tol {SD_REL_L2_TOL}); identical "
        f"images {float(np.mean(np.all(g == w, -1))):.4f}")
    if cos.max() > SD_DIRECTION_TOL or rel.max() > SD_REL_L2_TOL:
        failed.append("[mesh 2 ranks sd] the sharded sampler parts from the single-device sampler")
    out["sd"].update(one_minus_cos=float(cos.max()), rel_l2=float(rel.max()))
    if failed:
        raise AssertionError("; ".join(failed))
    return out


def phase_mesh(card: dict, spec: dict = None) -> dict:
    """The mesh paths: (a) world size 1 over NCCL, (b) two gloo ranks
    sharing the card (left out, with the reason printed, when the card is
    in an exclusive compute mode), each in child processes."""
    import torch

    from tvc_torch.parallel.launch import run_ranks

    spec = spec or mesh_spec()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    one = run_ranks(_mesh_world1, 1, spec, coordinator=f"127.0.0.1:{_free_port()}", device=spec["device"],
                    timeout=600)[0]
    log(f"[mesh] (a) world size 1 over NCCL: {time.perf_counter() - t0:.2f} s")
    out = {"world1": one, "mesh bf16": {"launches": one["bf16"]["launches"]},
           "mesh int8": {"launches": one["int8"]["launches"]}}
    if "exclusive" in card.get("compute_mode", "").lower():
        log(f"[mesh] (b) two ranks sharing the card left out: the card's compute mode is "
            f"{card['compute_mode']!r}, which admits one process")
        return out
    t0 = time.perf_counter()
    two = run_ranks(_mesh_two_ranks, 2, spec, coordinator=f"127.0.0.1:{_free_port()}", device=spec["device"],
                    backend="gloo", timeout=900)
    log(f"[mesh] (b) two gloo ranks sharing the card: {time.perf_counter() - t0:.2f} s")
    out["two"] = two
    for kind in ("bf16", "int8"):
        out[f"mesh {kind}"] = {"launches": two[0][kind]["launches"], "launches_rank1": two[1][kind]["launches"]}
    return out


PROFILE_NAMES = (
    "bf16_gemm_kernel<2, 256, 4>", "bf16_gemm_kernel<2, 192, 4>", "bf16_gemm_kernel<2, 128, 3>",
    "bf16_gemm_kernel<1, 128, 4>", "bf16_splitk_reduce_kernel", "layernorm_rows_kernel<__nv_bfloat16>",
    "layernorm_rows_kernel<float>", "f32_gemm_kernel",
    "i8_gemm_kernel<3, 256, 3, 2>", "i8_gemm_kernel<2, 256, 4, 2>", "i8_gemm_kernel<3, 128, 4, 2>",
    "i8_gemm_kernel<2, 128, 2, 2>", "i8_gemm_kernel<1, 128, 4, 2>", "i8_splitk_reduce_kernel",
    "ln_quant_rows_kernel<__nv_bfloat16>", "ln_quant_rows_kernel<float>", "quant_rows_kernel<float>",
    "quant_rows_kernel<__nv_bfloat16>", "decode_gqa_kernel<__nv_bfloat16, 128>",
    "decode_gqa_kernel<__nv_bfloat16, 64>", "decode_reduce_kernel",
    "head_attention_tc_kernel<float, 64>", "head_attention_tc_kernel<float, 32>",
    "head_attention_tc_kernel<__nv_bfloat16, 64>", "head_attention_tc_kernel<__nv_bfloat16, 32>",
    "head_attention_kernel<64>", "head_attention_kernel<32>",
    "consistency_kernel", "w8_gemm_kernel<2, 2, 192, 4>", "w8_gemm_kernel<2, 2, 128, 4>",
    "w8_gemm_kernel<1, 1, 64, 6>", "w8_splitk_reduce_kernel", "w8_gemm_f32_kernel",
    "bank_topk_partial_kernel<float, float>", "bank_topk_partial_kernel<float, __nv_bfloat16>",
    "bank_topk_merge_kernel",
)
#: the prefix of the record_function ranges a profile reports by name
RANGE_PREFIX = "smoke:"
#: kernel families a profile also sums: (what, name prefix)
PROFILE_FAMILIES = (("bf16 layer GEMM", "bf16_"), ("int8 GEMM", "i8_"), ("w8 GEMM", "w8_"),
                    ("per-head attention", "head_attention"))


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
    for family, prefix in PROFILE_FAMILIES:
        ms, n = (sum(v[i] for k, v in by_name.items() if k.startswith(prefix)) for i in (0, 1))
        if n:
            log(f"[{path}] profile: all {family} kernels ({prefix}*): {ms:.3f} ms, {100 * ms / busy:.1f}% of busy, "
                f"x{n}")
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
    with phase("tiny"):
        tiny = phase_tiny(card)
    with phase("attack"):
        attack = phase_attack(card, bf16)
    with phase("sd"):
        sd = phase_sd(card, bf16)
    with phase("weights"):
        weights = phase_weights(card, bf16)
    with phase("qwen"):
        qwen = phase_qwen(card)
    with phase("pipeline"):
        pipeline = phase_pipeline(card, int8)
    del bf16["detector"], int8["detector"]  # their models and banks
    with phase("dsv2"):
        dsv2 = phase_dsv2(card)
    with phase("kimi"):
        kimi = phase_kimi(card)
    with phase("nemotron"):
        nemotron = phase_nemotron(card)
    with phase("mha"):
        mha = phase_mha(card)
    with phase("retrieval"):
        retrieval = phase_retrieval(card, mha)
    del mha["model"]
    with phase("harness"):
        harness = phase_harness(card)
    with phase("large bank"):
        large = phase_large_bank(card)
    kres["bank_topk"]["shapes"].append(large["shape"])
    with phase("mesh"):
        mesh = phase_mesh(card)
    paths = {"bf16": bf16, "int8": int8, "qwen": qwen, "pipeline": pipeline, "dsv2": dsv2, "kimi": kimi,
             "nemotron": nemotron, "mha": mha, "retrieval": retrieval,
             **tiny, **{k: v for k, v in attack.items() if k in PATH_KERNELS}, "sd": sd,
             **{k: v for k, v in weights.items() if k in PATH_KERNELS},
             **{k: v for k, v in harness.items() if k in PATH_KERNELS},
             **{k: v for k, v in mesh.items() if k in PATH_KERNELS}}
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
    log(f"DeepSeek-V2-Lite w8 paraphrase decode (batch {dsv2['rows']}): {dsv2['tok_s']:.1f} tok/s, "
        f"{dsv2['ms_per_query']:.3f} ms/query, peak {dsv2['peak_gib']:.2f} GiB on {card['smi']}")
    log(f"Kimi-Linear-48B-A3B w8 paraphrase decode (batch {kimi['rows']}): {kimi['tok_s']:.1f} tok/s, "
        f"{kimi['ms_per_query']:.3f} ms/query, peak {kimi['peak_gib']:.2f} GiB on {card['smi']}")
    log(f"Nemotron-3-Nano-30B-A3B w8 paraphrase decode (batch {nemotron['rows']}): {nemotron['tok_s']:.1f} tok/s, "
        f"{nemotron['ms_per_query']:.3f} ms/query, peak {nemotron['peak_gib']:.2f} GiB on {card['smi']}")
    log(f"ViT-B/32 vision images/s at B={B_MHA}: " + ", ".join(f"{k} {v:.1f}" for k, v in mha["images_per_s"].items())
        + f"; ViT-L/14 with fused_mha at B={B_MHA_L14}: {mha['l14_images_per_s']:.1f} on {card['smi']}")
    full = attack["attack"]
    log(f"detect under attack: PGD standard on ViT-B/32 {full['images_per_s']:.1f} attacked images/s, peak "
        f"{full['peak_gib']:.2f} GiB; the detector on the clean + attacked batch {full['qps']:.1f} queries/s; "
        f"tiny_coco fixture AUROC / TPR at 5 % FPR " + ", ".join(
            f"{k} {v['auroc']:.4f} / {v['tpr_at_5pct_fpr']:.4f}"
            for k, v in attack["fixture serving"]["detection"].items())
        + f"; hubness hijack mean {attack['hijack_mean']:.4f} on {card['smi']}")
    adaptive = attack["adaptive"]
    log(f"adaptive attack on ViT-B/32: {adaptive['images_per_s']:.1f} attacked images/s, peak "
        f"{adaptive['peak_gib']:.2f} GiB; per lambda (attack_success_rate / detection_rate / auroc_band) " + ", ".join(
            f"{k}: {v['attack_success_rate']:.4f} / {v['detection_rate']:.4f} / {v['auroc_band']:.4f}"
            for k, v in adaptive["evaluation"]["sweep"].items())
        + f"; tiny_coco fixture alt-stack AUROC clean vs PGD {attack['alt_auroc']:.4f} on {card['smi']}")
    log(f"SD references (SD-1.5 shape, bf16, 512 px, 20 steps, CFG batch {2 * N_SD * 3}): {sd['images_per_s']:.2f} "
        f"images/s, {sd['unet_step_ms']:.3f} ms per CFG UNet call, VAE decode {sd['vae_decode_ms']:.3f} ms, "
        f"detector with SD references {sd['qps']:.3f} queries/s, peak {sd['peak_gib']:.2f} GiB on {card['smi']}")
    wt, wf, wsd = weights["weights trained"], weights["weights fixture"], weights["weights sd"]
    log(f"weights: ViT-B/32 training {wt['pairs_per_s']:.1f} pairs/s (B={N_TRAIN}, peak {wt['peak_gib']:.2f} GiB); "
        f"tiny_coco fixture to its stop rule at step {wf['metrics']['step']} in {wf['seconds']:.2f} s "
        f"(retrieval {wf['metrics']['retrieval_accuracy']:.4f}, cross_text_cos {wf['metrics']['cross_text_cos']:.4f}); "
        f"load_clip_weights {weights['weights clip']['load_s']['safetensors']:.2f} s (safetensors) / "
        f"{weights['weights clip']['load_s']['bin']:.2f} s (bin); HF SD-1.5 {wsd['images_per_s']:.2f} images/s, "
        f"{wsd['unet_step_ms']:.3f} ms per CFG HFUNet call, load {wsd['load_s']:.2f} s; Qwen2-1.5B load "
        f"{weights['weights qwen']['load_s']:.2f} s on {card['smi']}")
    log(f"retrieval: native resize {retrieval['host_ms_per_image']:.3f} host ms per image; text index "
        f"{retrieval['text_index_s']:.2f} s; tie order {retrieval['ties']}; large bank_topk peak memory: the "
        f"wrapper's {large['wrapper_peak_gib']:.2f} GiB, the phase's {large['peak_gib']:.2f} GiB")
    hf, hso, hfx = harness["harness"], harness["serving overhead"], harness["harness fixture"]
    log(f"harness: ViT-B/32 four scenarios (n={N_HARNESS}, bank {HARNESS_BANK}) {hf['seconds']:.2f} s (set-up "
        + ", ".join(f"{k} {v:.2f} s" for k, v in hf["setup_s"].items()) + "), AUROC " + ", ".join(
            f"{k} {v:.4f}" for k, v in hf["auroc"].items()) + f", staged overhead {hf['defense_overhead']:.4f}; "
        f"measure_serving_overhead defended {1e3 * hso['defense_time_serving']:.3f} ms / baseline "
        f"{1e3 * hso['baseline_time_serving']:.3f} ms, overhead {hso['defense_overhead_serving']:.4f}; fixture modes "
        + ", ".join(f"{k} {v:.1f} s" for k, v in hfx["seconds"].items()) + f" on {card['smi']}")
    w1 = mesh["world1"]
    log("mesh (a) world size 1 over NCCL, defended queries/s single device / mesh: " + ", ".join(
        f"{k} {w1[k]['qps']['single']:.1f} / {w1[k]['qps']['mesh']:.1f}" for k in ("bf16", "int8"))
        + "; collectives a batch: " + ", ".join(
            f"{k} " + " ".join(f"{c} x{v['calls']} {v['ms']:.3f} ms" for c, v in w1[k]["collectives"].items())
            for k in ("bf16", "int8")) + f" on {card['smi']}")
    if "two" in mesh:
        r0 = mesh["two"][0]
        log(f"mesh (b) two gloo ranks sharing one card (not scaling): defended queries/s bf16 "
            f"{r0['bf16']['qps_shared_card']:.1f}, int8 {r0['int8']['qps_shared_card']:.1f}; DP training "
            f"{r0['train']['pairs_per_s_shared_card']:.1f} pairs/s; Qwen2-7B TP=2 "
            f"{r0['qwen']['tok_per_s_shared_card']:.1f} tok/s; sharded SD {r0['sd']['images_per_s_shared_card']:.3f} "
            f"images/s on {card['smi']}")
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
