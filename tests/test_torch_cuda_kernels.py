"""The port's CUDA kernels against their plain versions on the card, at
ragged shapes the main path does not give them (partial tiles, K not a
multiple of the k-tile, T from 1 to 577, one-token sequences) and at the
Qwen2-7B and Qwen2-1.5B decodes' shapes, and the operands they refuse.

Marked ``cuda``: each test skips without a GPU. On the card:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import math

import numpy as np
import pytest
import torch

from tvc_torch.core.kernels import (
    attention_layer_i8_reference,
    bank_topk,
    bank_topk_reference,
    fused_mha,
    mha_reference,
    attention_layer_reference,
    consistency_scores_reference,
    decode_gqa_attention,
    decode_gqa_attention_stacked,
    decode_gqa_reference,
    fused_attention_layer,
    fused_attention_layer_i8,
    fused_consistency_scores,
    fused_mlp_layer,
    fused_mlp_layer_i8,
    mlp_layer_i8_reference,
    mlp_layer_reference,
    quantize_linear,
    w8_matmul,
    w8_matmul_plain,
    w8_matmul_stacked,
    w8a8_matmul,
    w8a8_matmul_reference,
    w8a8_matmul_stacked,
)
from tvc_torch.core.kernels import _build, w8_matmul_kernel
from tvc_torch.core.kernels import attention_layer_kernel as alk
from tvc_torch.core.kernels.quantized_layer_kernel import _i8_gemm, _mm_i32
from tvc_torch.core.similarity import l2_normalize

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _layer(rng, B, T, W, Wh, dev):
    t = lambda a, dt: torch.as_tensor(np.asarray(a, np.float32)).to(dev, dt).contiguous()
    bf, f32 = torch.bfloat16, torch.float32
    return dict(
        x=t(rng.standard_normal((B, T, W)), bf),
        ln=(t(1 + 0.1 * rng.standard_normal(W), f32), t(0.1 * rng.standard_normal(W), f32)),
        attn=(t(rng.standard_normal((W, 3 * W)) / math.sqrt(W), bf), t(0.02 * rng.standard_normal(3 * W), f32),
              t(rng.standard_normal((W, W)) / math.sqrt(W), bf), t(0.02 * rng.standard_normal(W), f32)),
        mlp=(t(rng.standard_normal((W, Wh)) / math.sqrt(W), bf), t(0.02 * rng.standard_normal(Wh), f32),
             t(rng.standard_normal((Wh, W)) / math.sqrt(Wh), bf), t(0.02 * rng.standard_normal(W), f32)),
    )


def _scaled_err(got, want):
    """|kernel - plain| / max(1, |plain|): one bf16 ulp is 2^-7 of |y|."""
    d = (got.float() - want.float()).abs() / want.float().abs().clamp(min=1.0)
    return float(d.max())


@pytest.mark.parametrize("B,T,H,causal", [(3, 77, 2, True), (5, 50, 2, False), (7, 1, 2, True), (130, 3, 2, False),
                                         (2, 197, 12, False), (3, 257, 2, False), (2, 257, 2, True)])
def test_attention_layer_ragged(dev, B, T, H, causal):
    p = _layer(np.random.default_rng(B * T), B, T, 64 * H, 4 * 64 * H, dev)
    args = (p["x"], *p["ln"], *p["attn"])
    before = fused_attention_layer.launches
    got = fused_attention_layer(*args, heads=H, causal=causal)
    want = attention_layer_reference(*args, heads=H, causal=causal)
    torch.cuda.synchronize()
    assert fused_attention_layer.launches == before + 1
    assert _scaled_err(got, want) <= 3e-2


@pytest.mark.parametrize("B,T,W,Wh", [(3, 7, 64, 200), (130, 1, 72, 136), (2, 77, 128, 512)])
def test_mlp_layer_ragged(dev, B, T, W, Wh):
    p = _layer(np.random.default_rng(W + Wh), B, T, W, Wh, dev)
    args = (p["x"], *p["ln"], *p["mlp"])
    got = fused_mlp_layer(*args)
    want = mlp_layer_reference(*args)
    torch.cuda.synchronize()
    assert _scaled_err(got, want) <= 3e-2


def _i8(weights):
    """(w, b, w, b) bf16 weights -> the int8 layer's (w_q, scale, b, w_q, scale, b)."""
    w1, b1, w2, b2 = weights
    return (*quantize_linear(w1), b1, *quantize_linear(w2), b2)


# Tolerance of the int8 layers: as the bf16 layers', 3e-2 of max(1, |y|).
# Kernel and plain quantize the same f32 values wherever both compute them
# identically; a LayerNorm or softmax sum taken in another order can flip
# one int8 activation by one quantum, which moves an output by row_scale *
# col_scale * |w_q| (~1e-2 of max|y| at unit-scale inputs), and the bf16
# output adds one ulp (2^-7 |y|). A wrong index or a missed term is O(1).
@pytest.mark.parametrize("B,T,H,causal", [(3, 77, 2, True), (5, 50, 2, False), (7, 1, 2, True), (130, 3, 2, False),
                                         (2, 197, 12, False), (3, 257, 2, False), (2, 257, 2, True)])
def test_attention_layer_i8_ragged(dev, B, T, H, causal):
    p = _layer(np.random.default_rng(B * T + 1), B, T, 64 * H, 4 * 64 * H, dev)
    args = (p["x"], *p["ln"], *_i8(p["attn"]))
    before = fused_attention_layer_i8.launches
    got = fused_attention_layer_i8(*args, heads=H, causal=causal)
    want = attention_layer_i8_reference(*args, heads=H, causal=causal)
    torch.cuda.synchronize()
    assert fused_attention_layer_i8.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == p["x"].shape
    assert _scaled_err(got, want) <= 3e-2


@pytest.mark.parametrize("B,T,W,Wh", [(3, 7, 64, 208), (130, 1, 80, 144), (2, 77, 128, 512), (1, 257, 64, 256)])
def test_mlp_layer_i8_ragged(dev, B, T, W, Wh):
    p = _layer(np.random.default_rng(W + Wh + 1), B, T, W, Wh, dev)
    args = (p["x"], *p["ln"], *_i8(p["mlp"]))
    before = fused_mlp_layer_i8.launches
    got = fused_mlp_layer_i8(*args)
    want = mlp_layer_i8_reference(*args)
    torch.cuda.synchronize()
    assert fused_mlp_layer_i8.launches == before + 1
    assert _scaled_err(got, want) <= 3e-2


CONSISTENCY_KEYS = ("orig_similarity", "variant_mean", "sd_score", "consistency_score")


def _consistency_inputs(rng, B, V, R, D, dev, dtypes=(torch.float32,) * 4):
    f = lambda dt, *s: torch.as_tensor(rng.standard_normal(s).astype(np.float32), device=dev).to(dt)
    return f(dtypes[0], B, D), f(dtypes[1], B, D), f(dtypes[2], B, V, D), f(dtypes[3], B, R, D)


def _held_to_plain(got, want):
    """The stats within 1e-5 of the plain version on the f32 values (random
    variants: sims near 0, so the std is well conditioned here)."""
    for k in (*CONSISTENCY_KEYS, "variant_std"):
        assert got[k].dtype == torch.float32, k
        assert float((got[k] - want[k]).abs().max()) <= 1e-5, k
    assert got["is_adversarial"].dtype == torch.bool


@pytest.mark.parametrize("B,V,R,D", [(1, 1, 1, 4), (37, 6, 0, 516), (300, 2, 10, 512), (5, 3, 2, 1), (37, 6, 3, 30),
                                     (64, 40, 3, 64), (8, 0, 3, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, "mixed"])
@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.int32])
def test_consistency_ragged(dev, B, V, R, D, dtype, mask_dtype):
    """Any D (scalar tails, rows off 16-byte boundaries), f32 / bf16 / f16
    embeddings in any mix (held against the plain version on their f32
    values), integer masks, more slots than a block has warps; one launch a
    call and two calls bit-equal."""
    rng = np.random.default_rng(D)
    dtypes = (torch.float32, torch.float32, torch.float16, torch.bfloat16) if dtype == "mixed" else (dtype,) * 4
    img, txt, var, refs = _consistency_inputs(rng, B, V, R, D, dev, dtypes)
    vmask = torch.as_tensor(rng.random((B, V)) > 0.3, device=dev)
    rmask = torch.as_tensor(rng.random((B, R)) > 0.3, device=dev)
    before = fused_consistency_scores.launches, fused_consistency_scores.copies
    args = (img, txt, var, refs, vmask.to(mask_dtype), rmask.to(mask_dtype), (0.4, 0.4, 0.2), 0.3)
    got = fused_consistency_scores(*args)
    again = fused_consistency_scores(*args)
    want = consistency_scores_reference(img.float(), txt.float(), var.float(), refs.float(), vmask, rmask,
                                        (0.4, 0.4, 0.2), 0.3)
    torch.cuda.synchronize()
    assert (fused_consistency_scores.launches, fused_consistency_scores.copies) == (before[0] + 2, before[1])
    _held_to_plain(got, want)
    for k in got:
        assert torch.equal(got[k], again[k]), k


def test_consistency_one_valid_variant_has_std_zero_and_takes_strided_operands(dev):
    """One valid variant: variant_std exactly 0 (ROADMAP 3). A strided
    variants slice and a transposed refs view are copied (counted) and give
    the contiguous operands' bits; weights and threshold as device tensors."""
    rng = np.random.default_rng(7)
    B, V, R, D = 33, 4, 3, 512
    img, txt, var, refs = _consistency_inputs(rng, B, V, R, D, dev)
    vmask = torch.zeros((B, V), dtype=torch.bool, device=dev)
    vmask[torch.arange(B), torch.as_tensor(rng.integers(0, V, B), device=dev)] = True
    w, thr = torch.tensor([0.4, 0.4, 0.2], device=dev), torch.tensor(0.3, device=dev)
    got = fused_consistency_scores(img, txt, var, refs, vmask, None, w, thr)
    assert bool((got["variant_std"] == 0).all())
    wide = torch.cat([var, var], dim=-1)[..., :D]
    refs_t = refs.transpose(0, 1).contiguous().transpose(0, 1)
    copies = fused_consistency_scores.copies
    strided = fused_consistency_scores(img, txt, wide, refs_t, vmask, None, w, thr)
    torch.cuda.synchronize()
    assert fused_consistency_scores.copies == copies + 2
    for k in got:
        assert torch.equal(got[k], strided[k]), k
    want = consistency_scores_reference(img, txt, var, refs, vmask, None, w, thr)
    _held_to_plain(got, want)


def test_kernels_refuse_what_they_do_not_take(dev):
    p = _layer(np.random.default_rng(0), 2, 4, 64, 256, dev)
    with pytest.raises(ValueError):  # 3 heads do not split width 64
        fused_attention_layer(p["x"], *p["ln"], *p["attn"], heads=3)
    with pytest.raises(ValueError):  # f32 activations with bf16 weights
        fused_attention_layer(p["x"].float(), *p["ln"], *p["attn"], heads=1)
    with pytest.raises(ValueError):  # non-contiguous weight
        fused_mlp_layer(p["x"], *p["ln"], p["mlp"][0].t().contiguous().t(), *p["mlp"][1:])
    x = torch.zeros((2, 8), device=dev)
    with pytest.raises(ValueError):  # integer embeddings (bf16 and f16 are taken, as the JAX kernel takes them)
        fused_consistency_scores(x.int(), x.int(), x[:, None].int(), x[:, None].int())


def _cast(p, dtype):
    """The layer operands with x and the weights in ``dtype`` (the compute
    dtype), biases and LayerNorm parameters f32."""
    c = lambda t: t.to(dtype) if t.dtype == torch.bfloat16 else t
    return {k: (c(v) if isinstance(v, torch.Tensor) else tuple(c(t) for t in v)) for k, v in p.items()}


# Tolerances of the four layer kernels at the tiny configurations' shapes
# (W = 64, two heads: head width 32; x f32) and at head width 32 in bf16,
# relative to max(1, |plain|). f32 bf16-layer kernels: the same f32
# function in another summation order (LayerNorm, GEMM, softmax, P.V), so
# ~1e-6; 1e-4 holds it, and a wrong index or missed term is O(1). The int8
# layers and bf16 operands: 3e-2, as the ragged tests above (an int8
# quantum flipped by an f32 sum in another order, a bf16 ulp).
F32_LAYER_TOL = 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["attention", "mlp", "attention_i8", "mlp_i8"])
@pytest.mark.parametrize("B,T,W,H,causal", [(8, 5, 64, 2, False), (12, 17, 64, 2, False), (24, 16, 64, 2, True),
                                            (24, 32, 64, 2, True), (3, 77, 128, 2, True)])
def test_layer_kernels_take_f32_and_head_width_32(dev, dtype, kind, B, T, W, H, causal):
    """Each layer kernel in f32 (the tiny configurations' compute dtype) and
    at head width 32 (tiny: W = 64, two heads) against its plain version;
    the output keeps x's dtype and two calls give the same bits."""
    p = _cast(_layer(np.random.default_rng(B * T + W), B, T, W, 4 * W, dev), dtype)
    kernel, plain, args, kw = {
        "attention": (fused_attention_layer, attention_layer_reference, (p["x"], *p["ln"], *p["attn"]),
                      dict(heads=H, causal=causal)),
        "mlp": (fused_mlp_layer, mlp_layer_reference, (p["x"], *p["ln"], *p["mlp"]), {}),
        "attention_i8": (fused_attention_layer_i8, attention_layer_i8_reference,
                         (p["x"], *p["ln"], *_i8(p["attn"])), dict(heads=H, causal=causal)),
        "mlp_i8": (fused_mlp_layer_i8, mlp_layer_i8_reference, (p["x"], *p["ln"], *_i8(p["mlp"])), {}),
    }[kind]
    before = kernel.launches
    got = kernel(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.dtype == dtype and got.shape == p["x"].shape
    tol = F32_LAYER_TOL if dtype == torch.float32 and not kind.endswith("_i8") else 3e-2
    assert _scaled_err(got, want) <= tol
    assert torch.equal(got, kernel(*args, **kw))


def _gemm_plain(a, w, bias, res, epilogue):
    """The bf16 GEMM's function in PyTorch: f32 sums, + bias, then nothing,
    quick_gelu or + the residual in f32, rounded once to bf16."""
    v = a.float() @ w.float() + bias
    if epilogue == alk.EPI_GELU:
        v = v * torch.sigmoid(1.702 * v)
    if epilogue == alk.EPI_RESIDUAL:
        v = res.float() + v
    return v.bfloat16()


# The bf16 layer GEMM at every tile of BF16_TILES and splits of K, under
# each epilogue, at ragged shapes (partial tiles, K past a 64-deep k-tile,
# N not a multiple of 64), against the plain version: both sum the same
# bf16 products in f32 in another order, so an output may differ by one
# bf16 ulp where a sum lands near a rounding boundary: 1e-2 of max(1, |y|)
# (GELU and residual add less). Two calls give the same bits.
@pytest.mark.parametrize("tile", list(alk.BF16_TILES))
@pytest.mark.parametrize("M,N,K,splits", [(130, 136, 72, 1), (130, 136, 72, 2), (21, 200, 64, 1),
                                          (577, 2320, 784, 1), (577, 2320, 784, 2), (577, 2320, 784, 3),
                                          (577, 2320, 784, 7)])
def test_bf16_gemm_at_every_tile_and_split(dev, tile, M, N, K, splits):
    rng = np.random.default_rng(M + N + K + splits)
    f = lambda *shape, scale=1.0: torch.as_tensor((scale * rng.standard_normal(shape)).astype(np.float32)).to(dev)
    a, w = f(M, K).bfloat16(), f(K, N, scale=K ** -0.5).bfloat16()
    bias, res = f(N, scale=0.02), f(M, N).bfloat16()
    nk = -(-K // alk.BF16_BK)
    per = -(-nk // splits)
    plan = (*tile, -(-nk // per), per)
    lib = _build.load("attention_layer")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for epilogue in (alk.EPI_BIAS, alk.EPI_GELU, alk.EPI_RESIDUAL):
        r = res if epilogue == alk.EPI_RESIDUAL else None
        got = alk._gemm(lib, a, w, bias, r, epilogue, stream, plan=plan)
        again = alk._gemm(lib, a, w, bias, r, epilogue, stream, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert _scaled_err(got, _gemm_plain(a, w, bias, res, epilogue)) <= 1e-2, (epilogue, plan)


@pytest.mark.parametrize("M,N,K,epilogue", [(37, 200, 72, 0), (130, 136, 72, 1), (257, 64, 256, 2)])
def test_f32_gemm_matches_plain(dev, M, N, K, epilogue):
    """The f32 layer GEMM (CUDA cores, no TF32) against the same function in
    f32 PyTorch: sums in another order only, 1e-5 of max(1, |y|)."""
    rng = np.random.default_rng(M * N + epilogue)
    f = lambda *shape: torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to(dev)
    a, w, bias, res = f(M, K), f(K, N) / K ** 0.5, f(N), f(M, N)
    lib = _build.load("attention_layer")
    got = alk._gemm(lib, a, w, bias, res if epilogue == alk.EPI_RESIDUAL else None, epilogue,
                    torch.cuda.current_stream(dev).cuda_stream)
    v = a @ w + bias
    want = v * torch.sigmoid(1.702 * v) if epilogue == alk.EPI_GELU else (res + v if epilogue == alk.EPI_RESIDUAL else v)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert _scaled_err(got, want) <= 1e-5


@pytest.mark.parametrize("causal", [False, True])
def test_layer_kernels_take_t_above_257(dev, causal):
    """The tensor-core attention has no cap on T: both layer kernels at
    T = 300 match their plain versions, and two calls give the same bits."""
    p = _layer(np.random.default_rng(1), 2, 300, 128, 512, dev)
    for kernel, plain, args in (
        (fused_attention_layer, attention_layer_reference, (p["x"], *p["ln"], *p["attn"])),
        (fused_attention_layer_i8, attention_layer_i8_reference, (p["x"], *p["ln"], *_i8(p["attn"]))),
    ):
        got = kernel(*args, heads=2, causal=causal)
        want = plain(*args, heads=2, causal=causal)
        torch.cuda.synchronize()
        assert _scaled_err(got, want) <= 3e-2
        assert torch.equal(got, kernel(*args, heads=2, causal=causal))


def test_int8_kernels_refuse_what_they_do_not_take(dev):
    p = _layer(np.random.default_rng(2), 2, 4, 64, 256, dev)
    a, m = _i8(p["attn"]), _i8(p["mlp"])
    with pytest.raises(ValueError):  # f64 activations
        fused_attention_layer_i8(p["x"].double(), *p["ln"], *a, heads=1)
    with pytest.raises(ValueError):  # bf16 weights where int8 are taken
        fused_attention_layer_i8(p["x"], *p["ln"], *p["attn"][:1], a[1], *a[2:], heads=1)
    with pytest.raises(ValueError):  # f64 scales
        fused_mlp_layer_i8(p["x"], *p["ln"], m[0], m[1].double(), *m[2:])
    with pytest.raises(ValueError):  # non-contiguous weight
        fused_mlp_layer_i8(p["x"], *p["ln"], m[0].t().contiguous().t(), *m[1:])
    with pytest.raises(ValueError):  # 3 heads do not split width 64
        fused_attention_layer_i8(p["x"], *p["ln"], *a, heads=3)


def _w8a8_operands(rng, M, K, N, dtype, dev):
    x = torch.as_tensor(rng.standard_normal((M, K)).astype(np.float32)).to(dev, dtype)
    w = torch.as_tensor((rng.standard_normal((K, N)) / math.sqrt(K)).astype(np.float32)).to(dev)
    return (x, *quantize_linear(w))


# The W8A8 GEMM is held to equality: kernel and plain quantize the same f32
# values with the same IEEE division and rounding, sum int8 products
# exactly (int32 on the tensor cores, float64 in the plain version) and
# dequantize in the same f32 order, rounding once to the output dtype.
@pytest.mark.parametrize("M,K,N,dtype", [
    (1, 16, 16, torch.bfloat16), (37, 208, 144, torch.float32), (130, 64, 272, torch.bfloat16),
    (15, 3584, 4608, torch.bfloat16), (576, 3584, 4608, torch.bfloat16), (576, 3584, 3584, torch.bfloat16),
    (576, 3584, 37888, torch.bfloat16), (576, 18944, 3584, torch.bfloat16), (576, 3584, 151936, torch.bfloat16),
    (4608, 3584, 4608, torch.bfloat16), (257, 896, 9728, torch.float32),
])
def test_w8a8_matmul_equals_plain(dev, M, K, N, dtype):
    x, w_q, s = _w8a8_operands(np.random.default_rng(M + K + N), M, K, N, dtype, dev)
    before = w8a8_matmul.launches
    got = w8a8_matmul(x, w_q, s)
    want = w8a8_matmul_reference(x, w_q, s)
    torch.cuda.synchronize()
    assert w8a8_matmul.launches == before + 1
    assert got.dtype == dtype and got.shape == (M, N)
    assert torch.equal(got, want), float((got.float() - want.float()).abs().max())


def test_w8a8_matmul_stacked_is_the_flat_kernel_on_the_layer(dev):
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((33, 128)).astype(np.float32)).to(dev, torch.bfloat16)
    qs = [quantize_linear(torch.as_tensor(rng.standard_normal((128, 96)).astype(np.float32)).to(dev))
          for _ in range(3)]
    w_q, s = torch.stack([q for q, _ in qs]), torch.stack([c for _, c in qs])
    before = (w8a8_matmul.launches, w8a8_matmul_stacked.launches)
    got = w8a8_matmul_stacked(x, w_q, s, 2)
    torch.cuda.synchronize()
    assert (w8a8_matmul.launches, w8a8_matmul_stacked.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, w8a8_matmul_reference(x, *qs[2]))


def _i8_operands(rng, M, N, K, dev):
    """int8 a [M, K] and w [K, N], row scales, column scales, bias and a
    bf16 residual, from a seeded numpy generator."""
    i8 = lambda *shape: torch.as_tensor(rng.integers(-127, 128, shape).astype(np.int8)).to(dev)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(dev)
    return (i8(M, K), f(rng.random(M) * 1e-2 + 1e-4), i8(K, N), f(rng.random(N) * 1e-2 + 1e-4),
            f(rng.standard_normal(N)), f(rng.standard_normal((M, N))).bfloat16())


def _i8_epilogue_plain(epilogue, a, rs, w, cs, bias, res):
    """The int8 GEMM's epilogues in PyTorch, in the kernel's f32 order:
    (acc . rs) . cs (+ bias); quick_gelu as h / (1 + exp(-1.702 h)) written
    h * (1 / (1 + exp(-(1.702 h)))); the residual added in f32; one
    rounding to the output dtype."""
    v = _mm_i32(a, w) * rs[:, None] * cs
    if epilogue in (0, 1, 2):
        v = v + bias
    if epilogue == 1:
        v = v * (1.0 / (1.0 + torch.exp(-(1.702 * v))))
    if epilogue == 2:
        v = res.float() + v
    return v if epilogue in (1, 4) else v.bfloat16()


# The int8 GEMM under each epilogue (0 bias bf16, 1 quick_gelu f32, 2
# residual bf16, 3 dequantize bf16, 4 dequantize f32) at ragged M, N and K
# (partial tiles, K past the 128-deep k-tile's edge), at its default plan,
# held to the plain version bit for bit: int32 sums are exact in any order
# and the epilogue's f32 steps are the same IEEE operations in the same
# order. Two calls are bit-equal.
@pytest.mark.parametrize("epilogue", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("M", [1, 15, 577])
@pytest.mark.parametrize("N", [16, 144, 2320])
@pytest.mark.parametrize("K", [48, 784])
def test_i8_gemm_epilogues_equal_plain(dev, epilogue, M, N, K):
    a, rs, w, cs, bias, res = _i8_operands(np.random.default_rng(M * N + K + epilogue), M, N, K, dev)
    out = torch.empty((M, N), dtype=torch.float32 if epilogue in (1, 4) else torch.bfloat16, device=dev)
    lib = _build.load("quantized_layer")
    stream = torch.cuda.current_stream(dev).cuda_stream
    _i8_gemm(lib, a, rs, w, cs, bias, res, out, epilogue, stream)
    torch.cuda.synchronize()
    first = out.clone()
    _i8_gemm(lib, a, rs, w, cs, bias, res, out, epilogue, stream)
    torch.cuda.synchronize()
    want = _i8_epilogue_plain(epilogue, a, rs, w, cs, bias, res)
    assert torch.equal(first, out)
    assert torch.equal(out, want), float((out.float() - want.float()).abs().max())


@pytest.mark.parametrize("tile", list(w8_matmul_kernel.I8_TILES))
@pytest.mark.parametrize("splits", [1, 2, 3, 7])
def test_w8a8_matmul_at_every_tile_and_split(dev, monkeypatch, tile, splits):
    """Every tile the plan can pick, with K (784: seven 128-deep k-tiles)
    whole or split into ranges whose int32 sums the reduce kernel adds:
    bit-equal to the plain version, and two calls bit-equal."""
    M, K, N = 577, 784, 2320
    per = -(-7 // splits)
    plan = (*tile, -(-7 // per), per)
    monkeypatch.setattr(w8_matmul_kernel, "i8_plan", lambda *shape: plan)
    x, w_q, s = _w8a8_operands(np.random.default_rng(splits), M, K, N, torch.bfloat16, dev)
    got, again = w8a8_matmul(x, w_q, s), w8a8_matmul(x, w_q, s)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, w8a8_matmul_reference(x, w_q, s))


def test_w8a8_matmul_stacked_at_the_last_of_28_layers(dev):
    """The stacked wrapper on layer 27 of a 28-layer stack reads that
    layer's zero-copy view (TMA from its offset) and equals the plain
    version on it."""
    rng = np.random.default_rng(27)
    L, M, K, N = 28, 192, 512, 640
    x = torch.as_tensor(rng.standard_normal((M, K)).astype(np.float32)).to(dev, torch.bfloat16)
    w_q = torch.as_tensor(rng.integers(-127, 128, (L, K, N)).astype(np.int8)).to(dev)
    s = torch.as_tensor((rng.random((L, N)) * 1e-2).astype(np.float32)).to(dev)
    got = w8a8_matmul_stacked(x, w_q, s, L - 1)
    torch.cuda.synchronize()
    assert torch.equal(got, w8a8_matmul_reference(x, w_q[L - 1], s[L - 1]))
    assert torch.equal(got, w8a8_matmul_stacked(x, w_q, s, L - 1))


def _decode_operands(rng, B, KV, R, S, D, dtype, dev, L=None):
    t = lambda *shape: torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
    cache = (B, KV, S, D) if L is None else (L, B, KV, S, D)
    mask = np.where(rng.random((B, S)) < 0.3, -np.inf, 0.0).astype(np.float32)
    mask[:, 0] = 0.0  # every row attends to at least one slot
    return t(B, KV, R, D), t(*cache), t(*cache), torch.as_tensor(mask, device=dev)


def _decode_err(got, want):
    d = (got.float() - want.float()).abs() / want.float().abs().clamp(min=1.0)
    return float(d.max())


# Tolerance of the decode attention, relative to max(1, |y|): f32 1e-5 (sums
# in another order, ~1e-7 relative); bf16 1e-2: the kernel and the plain
# version round the same f32 softmax weights to bf16, and a weight whose
# f32 value differs by an ulp (exp and sums in another order) can round to
# the neighbouring bf16 value, moving an output by 2^-8 |w v|; the output
# rounding adds one bf16 ulp (2^-8 |y|).
@pytest.mark.parametrize("B,KV,R,S,D,dtype", [
    (3, 2, 7, 1, 64, torch.bfloat16), (5, 4, 7, 63, 128, torch.bfloat16), (2, 1, 8, 512, 128, torch.float32),
    (7, 2, 2, 33, 64, torch.float32), (576, 4, 7, 64, 128, torch.bfloat16), (576, 4, 7, 512, 128, torch.bfloat16),
    (576, 2, 7, 64, 64, torch.bfloat16), (4, 4, 1, 2000, 128, torch.bfloat16), (960, 2, 6, 64, 128, torch.bfloat16),
    (6, 2, 2, 40, 16, torch.float32), (5, 2, 3, 33, 32, torch.bfloat16),
    # one caption's 5 rows, a cache above the old shared-memory cap (S split
    # across blocks), R = 1 in f32, S % 16 != 0 on the split path
    (5, 2, 6, 64, 128, torch.bfloat16), (1, 4, 8, 8192, 128, torch.bfloat16), (2, 2, 1, 3, 16, torch.float32),
    (3, 2, 5, 1001, 64, torch.bfloat16),
])
def test_decode_gqa_attention_matches_plain(dev, B, KV, R, S, D, dtype):
    q, k, v, mask = _decode_operands(np.random.default_rng(B * S + D), B, KV, R, S, D, dtype, dev)
    before = decode_gqa_attention.launches
    got = decode_gqa_attention(q, k, v, mask)
    want = decode_gqa_reference(q, k, v, mask)
    torch.cuda.synchronize()
    assert decode_gqa_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert _decode_err(got, want) <= (1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("B,KV,R,S,D,dtype", [
    (576, 4, 7, 64, 128, torch.bfloat16), (5, 2, 6, 64, 128, torch.bfloat16), (1, 4, 8, 8192, 128, torch.bfloat16),
    (6, 2, 2, 40, 16, torch.float32),
])
def test_decode_gqa_attention_two_calls_are_bit_equal(dev, B, KV, R, S, D, dtype):
    """Every sum in a fixed order, on one block or split across blocks."""
    q, k, v, mask = _decode_operands(np.random.default_rng(S), B, KV, R, S, D, dtype, dev)
    assert torch.equal(decode_gqa_attention(q, k, v, mask), decode_gqa_attention(q, k, v, mask))


@pytest.mark.parametrize("S,slot", [(64, 37), (3000, 2999)])
def test_decode_gqa_attention_one_unmasked_slot(dev, S, slot):
    """Every slot but one masked: the weight is exactly 1 and the output
    that slot's value row, as in the plain version."""
    q, k, v, mask = _decode_operands(np.random.default_rng(7), 3, 2, 7, S, 128, torch.bfloat16, dev)
    mask = torch.full_like(mask, float("-inf"))
    mask[:, slot] = 0.0
    got, want = decode_gqa_attention(q, k, v, mask), decode_gqa_reference(q, k, v, mask)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, v[:, :, slot : slot + 1].expand_as(got))


def test_decode_gqa_attention_stacked_is_the_flat_kernel_on_the_layer(dev):
    q, k, v, mask = _decode_operands(np.random.default_rng(9), 6, 2, 7, 40, 128, torch.bfloat16, dev, L=3)
    before = (decode_gqa_attention.launches, decode_gqa_attention_stacked.launches)
    got = decode_gqa_attention_stacked(q, k, v, mask, 1)
    flat = decode_gqa_attention(q, k[1], v[1], mask)
    torch.cuda.synchronize()
    assert (decode_gqa_attention.launches, decode_gqa_attention_stacked.launches) == (before[0] + 2, before[1] + 1)
    assert torch.equal(got, flat)


def test_qwen_kernels_refuse_what_they_do_not_take(dev):
    x, w_q, s = _w8a8_operands(np.random.default_rng(1), 4, 64, 32, torch.bfloat16, dev)
    with pytest.raises(ValueError):  # f16 activations
        w8a8_matmul(x.half(), w_q, s)
    with pytest.raises(ValueError):  # float weights where int8 are taken
        w8a8_matmul(x, w_q.float(), s)
    with pytest.raises(ValueError):  # scale of the wrong width
        w8a8_matmul(x, w_q, s[:16])
    with pytest.raises(ValueError):  # 3-d x
        w8a8_matmul(x[None], w_q, s)
    with pytest.raises(ValueError):  # layer out of range
        w8a8_matmul_stacked(x, w_q[None], s[None], 1)
    q, k, v, mask = _decode_operands(np.random.default_rng(3), 2, 2, 7, 16, 128, torch.bfloat16, dev)
    with pytest.raises(ValueError):  # bf16 mask
        decode_gqa_attention(q, k, v, mask.bfloat16())
    with pytest.raises(ValueError):  # f32 cache under bf16 queries
        decode_gqa_attention(q, k.float(), v, mask)
    with pytest.raises(ValueError):  # non-contiguous cache
        decode_gqa_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3), v, mask)
    with pytest.raises(ValueError):  # a cache of another head width
        decode_gqa_attention(q, k[..., :64].contiguous(), v[..., :64].contiguous(), mask)


# The weight-only GEMM, relative to max(1, |y|): kernel and plain convert the
# same int8 weights exactly and sum the same exact bf16 products in f32 in
# another order, then scale in f32 and round once to bf16: one bf16 ulp
# (at most 2^-7 |y|) apart where a sum lands next to a rounding boundary.
@pytest.mark.parametrize("M,K,N", [
    (1, 16, 16), (37, 208, 144), (130, 64, 272), (15, 1536, 17920), (15, 1536, 2048),
    (960, 1536, 2048), (960, 1536, 1536), (960, 1536, 17920), (960, 8960, 1536), (1024, 1536, 2048),
    (1, 1536, 2048), (1, 8960, 1536), (15, 8960, 1536), (64, 1536, 17920), (64, 8960, 1536), (200, 1552, 4112),
    (65, 1536, 2048), (128, 64, 272),
])
def test_w8_matmul_matches_plain(dev, M, K, N):
    x, w_q, s = _w8a8_operands(np.random.default_rng(M + K + N + 1), M, K, N, torch.bfloat16, dev)
    before = w8_matmul.launches
    got = w8_matmul(x, w_q, s)
    want = w8_matmul_plain(x, w_q, s)
    torch.cuda.synchronize()
    assert w8_matmul.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert _scaled_err(got, want) <= 1e-2
    assert torch.equal(got, w8_matmul(x, w_q, s))  # fixed-order sums, no atomics: the same bits every run


# f32 activations (the tiny and f32 configurations), at QwenConfig.tiny()'s
# layer shapes: f32 products summed in f32 in another order than cuBLAS's
# (~1e-7 relative), then the same f32 scaling: 1e-5 of max(1, |y|).
@pytest.mark.parametrize("M,K,N", [(7, 64, 128), (7, 64, 64), (7, 64, 256), (7, 128, 64), (130, 64, 128),
                                   (1, 128, 64), (960, 1536, 2048)])
def test_w8_matmul_f32_matches_plain(dev, M, K, N):
    x, w_q, s = _w8a8_operands(np.random.default_rng(M + K + N + 2), M, K, N, torch.float32, dev)
    before = w8_matmul.launches
    got = w8_matmul(x, w_q, s)
    want = w8_matmul_plain(x, w_q, s)
    torch.cuda.synchronize()
    assert w8_matmul.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert _scaled_err(got, want) <= 1e-5
    assert torch.equal(got, w8_matmul(x, w_q, s))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_w8_matmul_takes_unaligned_operands(dev, dtype):
    """x as an [M, K] view one element into a flat buffer, a transposed
    (non-contiguous) x, and w_q one byte into a flat buffer: the wrapper
    copies them and matches the plain version."""
    x, w_q, s = _w8a8_operands(np.random.default_rng(11), 33, 128, 96, dtype, dev)
    flat = torch.zeros(x.numel() + 1, dtype=dtype, device=dev)
    flat[1:].copy_(x.reshape(-1))
    x_off = flat[1:].view(33, 128)
    wflat = torch.zeros(w_q.numel() + 1, dtype=torch.int8, device=dev)
    wflat[1:].copy_(w_q.reshape(-1))
    w_off = wflat[1:].view(128, 96)
    assert x_off.data_ptr() % 16 and w_off.data_ptr() % 16
    want = w8_matmul_plain(x, w_q, s)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    for xx, ww in ((x_off, w_q), (x, w_off), (x_off, w_off), (x.t().contiguous().t(), w_q)):
        got = w8_matmul(xx, ww, s)
        torch.cuda.synchronize()
        assert _scaled_err(got, want) <= tol


def test_w8_matmul_stacked_is_the_flat_kernel_on_the_layer(dev):
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.standard_normal((33, 128)).astype(np.float32)).to(dev, torch.bfloat16)
    qs = [quantize_linear(torch.as_tensor(rng.standard_normal((128, 96)).astype(np.float32)).to(dev))
          for _ in range(3)]
    w_q, s = torch.stack([q for q, _ in qs]), torch.stack([c for _, c in qs])
    before = (w8_matmul.launches, w8_matmul_stacked.launches)
    got = w8_matmul_stacked(x, w_q, s, 2)
    torch.cuda.synchronize()
    assert (w8_matmul.launches, w8_matmul_stacked.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, w8_matmul(x, *qs[2]))
    assert _scaled_err(got, w8_matmul_plain(x, *qs[2])) <= 1e-2


def test_w8_matmul_refuses_what_it_does_not_take(dev):
    x, w_q, s = _w8a8_operands(np.random.default_rng(7), 4, 64, 32, torch.bfloat16, dev)
    with pytest.raises(ValueError):  # f16 activations
        w8_matmul(x.half(), w_q, s)
    with pytest.raises(ValueError):  # float weights where int8 are taken
        w8_matmul(x, w_q.float(), s)
    with pytest.raises(ValueError):  # scale of the wrong width
        w8_matmul(x, w_q, s[:16])
    with pytest.raises(ValueError):  # 3-d x
        w8_matmul(x[None], w_q, s)
    with pytest.raises(ValueError):  # layer out of range
        w8_matmul_stacked(x, w_q[None], s[None], 1)


# -- fused_mha ------------------------------------------------------------------


@pytest.mark.parametrize("B,T,H,D,dtype,causal", [
    (256, 50, 12, 64, torch.bfloat16, False), (64, 257, 16, 64, torch.bfloat16, False),
    (448, 32, 8, 64, torch.bfloat16, True), (5, 17, 2, 32, torch.bfloat16, False), (3, 1, 2, 64, torch.bfloat16, True),
    (6, 257, 4, 64, torch.float32, False), (7, 17, 2, 32, torch.float32, True), (2, 77, 3, 32, torch.float32, False),
    (2, 577, 4, 64, torch.bfloat16, False), (3, 300, 2, 64, torch.bfloat16, True), (2, 129, 3, 32, torch.bfloat16, True),
    (16, 577, 16, 64, torch.bfloat16, False), (4, 300, 12, 64, torch.float32, True),
    (2, 577, 4, 64, torch.float32, False), (3, 130, 5, 32, torch.float32, False),
])
def test_fused_mha_matches_plain(dev, B, T, H, D, dtype, causal):
    """bf16: 1e-2 of max(1, |y|) (a softmax weight one f32 ulp apart can
    round to the neighbouring bf16 value, and the output rounds once);
    f32: 1e-5 (sums in another order)."""
    g = torch.Generator(device=dev).manual_seed(B * T + D)
    q, k, v = (torch.randn((B, T, H, D), generator=g, device=dev).to(dtype) for _ in range(3))
    got, want = fused_mha(q, k, v, causal=causal), mha_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, T, H, D)
    assert _scaled_err(got, want) <= (1e-2 if dtype == torch.bfloat16 else 1e-5)
    assert torch.equal(got, fused_mha(q, k, v, causal=causal))


def test_fused_mha_reads_views_of_a_packed_projection(dev):
    """q, k, v as views of one [B, T, 3W] projection (row stride 3W) give
    what their contiguous copies give."""
    B, T, H, D = 4, 50, 12, 64
    qkv = torch.randn((B, T, 3 * H * D), device=dev).to(torch.bfloat16)
    views = [t.reshape(B, T, H, D) for t in qkv.split(H * D, dim=-1)]
    got = fused_mha(*views)
    want = fused_mha(*(t.contiguous() for t in views))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_fused_mha_refuses_what_it_does_not_take(dev):
    x = torch.zeros((2, 8, 2, 128), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="must be a"):  # k of another shape
        fused_mha(x, x[:, :4], x)
    y = torch.randn((1, 258, 2, 64), device=dev, dtype=torch.float32)
    assert _scaled_err(fused_mha(y, y, y), mha_reference(y, y, y)) <= 1e-5  # f32 takes any T
    z = torch.zeros((1, 8, 2, 64), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="bf16 or float32"):
        fused_mha(z, z, z)


# -- bank_topk --------------------------------------------------------------------


def _topk_check(got, want, q, bank, normalize=True, tol=1e-5):
    """Kernel values within tol of the plain values; every returned row's
    plain score within tol of the kernel's value; where the k-th and
    (k+1)-th plain scores differ by more than tol, the same rows."""
    (gv, gi), (wv, wi) = got, want
    assert gi.dtype == torch.int32 and gv.dtype == torch.float32
    assert float((gv - wv).abs().max()) <= tol
    qq, bb = (l2_normalize(t.float()) if normalize else t.float() for t in (q, bank))
    plain_of = (qq[:, None, :] * bb[gi.long()]).sum(-1)
    assert float((plain_of - gv).abs().max()) <= tol
    k = gi.shape[1]
    nxt = bank_topk_reference(q, bank, k + 1, normalize=normalize)[0][:, k] if k < bank.shape[0] else None
    rows = torch.ones(gi.shape[0], dtype=torch.bool, device=gi.device) if nxt is None else (wv[:, -1] - nxt) > tol
    assert torch.equal(gi[rows].sort(-1).values, wi[rows].sort(-1).values)


@pytest.mark.parametrize("B,N,D,k", [(256, 131072, 512, 10), (3, 1000, 64, 128), (70, 4097, 32, 1), (1, 64, 8, 64)])
def test_bank_topk_matches_plain(dev, B, N, D, k):
    g = torch.Generator(device=dev).manual_seed(N)
    q = torch.randn((B, D), generator=g, device=dev)
    bank = torch.randn((N, D), generator=g, device=dev)
    got, want = bank_topk(q, bank, k), bank_topk_reference(q, bank, k)
    torch.cuda.synchronize()
    _topk_check(got, want, q, bank)


def test_bank_topk_bf16_bank_and_n_valid(dev):
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((40, 128), generator=g, device=dev)
    bank = torch.randn((9000, 128), generator=g, device=dev).to(torch.bfloat16)
    _topk_check(bank_topk(q, bank, 16, normalize=False), bank_topk_reference(q, bank, 16, normalize=False),
                q, bank, normalize=False, tol=1e-4)
    for nv in (5000, torch.tensor(5000, device=dev)):
        gv, gi = bank_topk(q, bank.float(), 16, n_valid=nv)
        wv, wi = bank_topk_reference(q, bank.float(), 16, n_valid=nv)
        assert int(gi.max()) < 5000 and float((gv - wv).abs().max()) <= 1e-5


@pytest.mark.parametrize("n_valid,k,block_n", [(3, 5, 2048), (3, 5, 128), (10, 12, 128), (0, 4, 128), (100, 120, 128)])
def test_bank_topk_surplus_slots_equal_plain(dev, n_valid, k, block_n):
    """Fewer valid rows than k: the surplus slots' (-inf, index) exactly."""
    g = torch.Generator(device=dev).manual_seed(k)
    q = torch.randn((9, 16), generator=g, device=dev)
    bank = torch.randn((600, 16), generator=g, device=dev)
    gv, gi = bank_topk(q, bank, k, n_valid=n_valid, block_n=block_n)
    wv, wi = bank_topk_reference(q, bank, k, n_valid=n_valid, block_n=block_n)
    n = min(n_valid, k)
    assert torch.equal(gi[:, n:], wi[:, n:]) and bool(torch.isneginf(gv[:, n:]).all())
    if n:
        assert float((gv[:, :n] - wv[:, :n]).abs().max()) <= 1e-5


def test_bank_topk_orders_exact_ties_by_index(dev):
    """Duplicated rows of +-0.5 unit vectors: every score is exact, so the
    kernel's lists equal the plain version's (lower index first) exactly."""
    rng = np.random.default_rng(9)
    base = np.zeros((6, 64), np.float32)
    for r in base:
        r[rng.choice(64, 4, replace=False)] = rng.choice([-0.5, 0.5], 4)
    bank = torch.as_tensor(base[rng.integers(0, 6, 20000)], device=dev)
    q = torch.as_tensor(base[rng.integers(0, 6, 33)], device=dev)
    for k in (10, 128):
        gv, gi = bank_topk(q, bank, k)
        wv, wi = bank_topk_reference(q, bank, k)
        assert torch.equal(gi, wi) and torch.equal(gv, wv)


@pytest.mark.parametrize("normalize,bank_dtype", [(True, torch.float32), (True, torch.bfloat16),
                                                  (False, torch.bfloat16)])
def test_bank_topk_two_calls_are_bit_equal(dev, normalize, bank_dtype):
    g = torch.Generator(device=dev).manual_seed(13)
    q = torch.randn((200, 256), generator=g, device=dev)
    bank = torch.randn((50000, 256), generator=g, device=dev).to(bank_dtype)
    a, b = bank_topk(q, bank, 10, normalize=normalize), bank_topk(q, bank, 10, normalize=normalize)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_bank_topk_normalize_bf16_bank(dev):
    """normalize=True on a bf16 bank: the kernel divides by the norms of
    the bf16 rows (converted exactly), no normalized f32 copy."""
    g = torch.Generator(device=dev).manual_seed(17)
    q = torch.randn((70, 128), generator=g, device=dev)
    bank = torch.randn((20000, 128), generator=g, device=dev).to(torch.bfloat16)
    _topk_check(bank_topk(q, bank, 16), bank_topk_reference(q, bank, 16), q, bank)


def test_bank_topk_normalize_rows_of_very_different_norms(dev):
    """Rows scaled from 1e-3 to 1e3: the scores are cosines, so the row's
    norm must divide its score (a large row would win otherwise)."""
    g = torch.Generator(device=dev).manual_seed(19)
    q = torch.randn((33, 64), generator=g, device=dev)
    bank = torch.randn((9000, 64), generator=g, device=dev)
    bank *= torch.logspace(-3, 3, 9000, device=dev)[torch.randperm(9000, generator=g, device=dev)][:, None]
    _topk_check(bank_topk(q, bank, 10), bank_topk_reference(q, bank, 10), q, bank)


def test_bank_topk_refuses_what_it_does_not_take(dev):
    q = torch.zeros((2, 64), device=dev)
    with pytest.raises(ValueError, match="k >= 1"):
        bank_topk(q, torch.zeros((300, 64), device=dev), 0)
    with pytest.raises(ValueError, match="float32 or bf16"):
        bank_topk(q.half(), torch.zeros((30, 64), device=dev), 3)
    with pytest.raises(ValueError, match="width"):
        bank_topk(q, torch.zeros((30, 32), device=dev), 3)


# -- shapes the TPU kernels take that the tiled kernels do not -------------------
#
# Head widths other than 32 / 64 run the attention's tail path; widths the
# GEMMs' 16-byte rows do not take are zero-padded around them (counted in
# ``<wrapper>.copies``); the decode attention takes head widths off its
# tiled kernel's and R > 8 on the tail path; bank_topk pads D and runs
# k > 128 in passes. Tolerances
# as in the tests above: f32 2e-5 of max(1, |y|) (sums in another order),
# bf16 1e-2 (one bf16 ulp), int8 3e-2 (one quantum), W8A8 exact.


@pytest.mark.parametrize("B,T,H,D,dtype,causal", [
    (2, 7, 3, 48, torch.float32, False), (2, 7, 3, 48, torch.bfloat16, True), (3, 70, 2, 96, torch.bfloat16, False),
    (2, 33, 2, 128, torch.float32, True), (1, 5, 1, 300, torch.float32, False), (2, 9, 4, 16, torch.bfloat16, False),
])
def test_fused_mha_takes_any_head_width(dev, B, T, H, D, dtype, causal):
    g = torch.Generator(device=dev).manual_seed(T * D)
    q, k, v = (torch.randn((B, T, H, D), generator=g, device=dev).to(dtype) for _ in range(3))
    before = fused_mha.launches
    got, want = fused_mha(q, k, v, causal=causal), mha_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fused_mha.launches == before + 1 and got.shape == q.shape and got.dtype == dtype
    assert _scaled_err(got, want) <= (2e-5 if dtype == torch.float32 else 1e-2)
    assert torch.equal(got, fused_mha(q, k, v, causal=causal))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["attention", "mlp", "attention_i8", "mlp_i8"])
@pytest.mark.parametrize("B,T,W,Wh,H,causal", [(2, 5, 36, 60, 3, False), (3, 9, 40, 24, 2, True),
                                               (2, 6, 35, 70, 5, False), (2, 50, 96, 384, 2, True)])
def test_layer_kernels_take_any_width_and_head_width(dev, dtype, kind, B, T, W, Wh, H, causal):
    p = _cast(_layer(np.random.default_rng(B * T + W), B, T, W, Wh, dev), dtype)
    kernel, plain, args, kw = {
        "attention": (fused_attention_layer, attention_layer_reference, (p["x"], *p["ln"], *p["attn"]),
                      dict(heads=H, causal=causal)),
        "mlp": (fused_mlp_layer, mlp_layer_reference, (p["x"], *p["ln"], *p["mlp"]), {}),
        "attention_i8": (fused_attention_layer_i8, attention_layer_i8_reference,
                         (p["x"], *p["ln"], *_i8(p["attn"])), dict(heads=H, causal=causal)),
        "mlp_i8": (fused_mlp_layer_i8, mlp_layer_i8_reference, (p["x"], *p["ln"], *_i8(p["mlp"])), {}),
    }[kind]
    before = kernel.launches, kernel.copies
    got = kernel(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before[0] + 1
    # a bf16 GEMM pads widths off a multiple of 8, an int8 GEMM off 16
    grain = 16 if kind.endswith("_i8") else (8 if dtype == torch.bfloat16 else None)
    widths = (W,) if kind.startswith("attention") else (W, Wh)
    assert (kernel.copies > before[1]) == bool(grain and any(n % grain for n in widths))
    assert got.dtype == dtype and got.shape == p["x"].shape
    tol = 2e-5 if dtype == torch.float32 and not kind.endswith("_i8") else (
        1e-2 if not kind.endswith("_i8") else 3e-2)
    assert _scaled_err(got, want) <= tol
    assert torch.equal(got, kernel(*args, **kw))


@pytest.mark.parametrize("M,K,N,dtype", [(6, 40, 24, torch.bfloat16), (6, 40, 24, torch.float32),
                                         (33, 100, 30, torch.bfloat16)])
def test_int8_gemms_take_any_width(dev, M, K, N, dtype):
    x, w_q, s = _w8a8_operands(np.random.default_rng(K * N), M, K, N, dtype, dev)
    before = w8a8_matmul.copies
    got = w8a8_matmul(x, w_q, s)
    torch.cuda.synchronize()
    assert w8a8_matmul.copies > before
    assert torch.equal(got, w8a8_matmul_reference(x, w_q, s))
    got8 = w8_matmul(x, w_q, s)
    torch.cuda.synchronize()
    assert got8.shape == (M, N)
    assert _scaled_err(got8, w8_matmul_plain(x, w_q, s)) <= (2e-5 if dtype == torch.float32 else 1e-2)


def test_gemms_pad_without_an_owner(dev):
    """``_gemm`` and ``_i8_gemm`` called bare (as the sweep scripts call
    them) at widths off their grain count their copies on themselves."""
    rng = np.random.default_rng(36)
    f = lambda *shape: torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to(dev)
    a, w, bias = f(20, 36).bfloat16(), (f(36, 60) / 6).bfloat16(), f(60)
    before = alk._gemm.copies
    got = alk._gemm(_build.load("attention_layer"), a, w, bias, None, alk.EPI_BIAS,
                    torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    assert alk._gemm.copies > before and got.shape == (20, 60)
    assert _scaled_err(got, _gemm_plain(a, w, bias, None, alk.EPI_BIAS)) <= 1e-2
    a8, rs, w8, cs, bias8, res = _i8_operands(rng, 20, 24, 40, dev)
    out = torch.empty((20, 24), dtype=torch.bfloat16, device=dev)
    before = _i8_gemm.copies
    _i8_gemm(_build.load("quantized_layer"), a8, rs, w8, cs, bias8, res, out, 2,
             torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    assert _i8_gemm.copies > before
    assert torch.equal(out, _i8_epilogue_plain(2, a8, rs, w8, cs, bias8, res))


@pytest.mark.parametrize("B,KV,R,S,D,dtype", [(2, 2, 9, 20, 48, torch.bfloat16), (2, 2, 9, 20, 48, torch.float32),
                                              (3, 2, 20, 300, 40, torch.bfloat16), (1, 4, 3, 1500, 96, torch.float32),
                                              (2, 2, 12, 70, 200, torch.bfloat16), (2, 1, 3, 17, 300, torch.float32)])
def test_decode_gqa_attention_takes_any_head_width_and_r(dev, B, KV, R, S, D, dtype):
    q, k, v, mask = _decode_operands(np.random.default_rng(R * D), B, KV, R, S, D, dtype, dev)
    before = decode_gqa_attention.launches
    got, want = decode_gqa_attention(q, k, v, mask), decode_gqa_reference(q, k, v, mask)
    torch.cuda.synchronize()
    assert decode_gqa_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert _decode_err(got, want) <= (2e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("B,N,D,k,n_valid", [(3, 500, 12, 130, None), (5, 700, 64, 300, None),
                                             (4, 600, 20, 257, 200), (2, 3000, 8, 129, 2100)])
def test_bank_topk_takes_any_width_and_k(dev, B, N, D, k, n_valid):
    """Small-integer operands without normalization: every score is an
    exact integer in any summation order, so ties abound and the indices
    (ties by index) and the surplus slots must equal the plain version's."""
    g = torch.Generator(device=dev).manual_seed(N + k)
    q = torch.randint(-3, 4, (B, D), generator=g, device=dev).float()
    bank = torch.randint(-3, 4, (N, D), generator=g, device=dev).float()
    got = bank_topk(q, bank, k, n_valid=n_valid, normalize=False)
    want = bank_topk_reference(q, bank, k, n_valid=n_valid, normalize=False)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    qn = torch.randn((B, D), generator=g, device=dev)
    bn = torch.randn((N, D), generator=g, device=dev)
    _topk_check(bank_topk(qn, bn, k), bank_topk_reference(qn, bn, k), qn, bn)
