"""The port's CUDA kernels against their plain versions on the card, at
ragged shapes the main path does not give them (partial tiles, K not a
multiple of the k-tile, T from 1 to 257, one-token sequences) and at the
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


@pytest.mark.parametrize("B,V,R,D", [(1, 1, 1, 4), (37, 6, 0, 516), (300, 2, 10, 512)])
def test_consistency_ragged(dev, B, V, R, D):
    rng = np.random.default_rng(D)
    f = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(np.float32), device=dev)
    img, txt, var, refs = f(B, D), f(B, D), f(B, V, D), f(B, R, D)
    vmask = torch.as_tensor(rng.random((B, V)) > 0.3, device=dev)
    rmask = torch.as_tensor(rng.random((B, R)) > 0.3, device=dev)
    got = fused_consistency_scores(img, txt, var, refs, vmask, rmask, (0.4, 0.4, 0.2), 0.3)
    want = consistency_scores_reference(img, txt, var, refs, vmask, rmask, (0.4, 0.4, 0.2), 0.3)
    torch.cuda.synchronize()
    for k in ("orig_similarity", "variant_mean", "sd_score", "consistency_score"):
        assert float((got[k] - want[k]).abs().max()) <= 1e-5, k
    # random variants: sims near 0, so the std is well conditioned here
    assert float((got["variant_std"] - want["variant_std"]).abs().max()) <= 1e-5


def test_kernels_refuse_what_they_do_not_take(dev):
    p = _layer(np.random.default_rng(0), 2, 4, 64, 256, dev)
    with pytest.raises(ValueError):  # f32 activations
        fused_attention_layer(p["x"].float(), *p["ln"], *p["attn"], heads=1)
    with pytest.raises(ValueError):  # head width 32
        fused_attention_layer(p["x"], *p["ln"], *p["attn"], heads=2)
    with pytest.raises(ValueError):  # non-contiguous weight
        fused_mlp_layer(p["x"], *p["ln"], p["mlp"][0].t().contiguous().t(), *p["mlp"][1:])
    x = torch.zeros((2, 8), device=dev)
    with pytest.raises(ValueError):  # bf16 embeddings
        fused_consistency_scores(x.bfloat16(), x.bfloat16(), x[:, None].bfloat16(), x[:, None].bfloat16())


def test_layer_kernels_refuse_t_above_257(dev):
    p = _layer(np.random.default_rng(1), 1, 258, 64, 256, dev)
    with pytest.raises(ValueError, match="T <= 257"):
        fused_attention_layer(p["x"], *p["ln"], *p["attn"], heads=1)
    with pytest.raises(ValueError, match="T <= 257"):
        fused_attention_layer_i8(p["x"], *p["ln"], *_i8(p["attn"]), heads=1)


def test_int8_kernels_refuse_what_they_do_not_take(dev):
    p = _layer(np.random.default_rng(2), 2, 4, 64, 256, dev)
    a, m = _i8(p["attn"]), _i8(p["mlp"])
    with pytest.raises(ValueError):  # f32 activations
        fused_attention_layer_i8(p["x"].float(), *p["ln"], *a, heads=1)
    with pytest.raises(ValueError):  # bf16 weights where int8 are taken
        fused_attention_layer_i8(p["x"], *p["ln"], *p["attn"][:1], a[1], *a[2:], heads=1)
    with pytest.raises(ValueError):  # f64 scales
        fused_mlp_layer_i8(p["x"], *p["ln"], m[0], m[1].double(), *m[2:])
    with pytest.raises(ValueError):  # non-contiguous weight
        fused_mlp_layer_i8(p["x"], *p["ln"], m[0].t().contiguous().t(), *m[1:])
    with pytest.raises(ValueError):  # head width 32
        fused_attention_layer_i8(p["x"], *p["ln"], *a, heads=2)
    q = _layer(np.random.default_rng(3), 2, 4, 72, 144, dev)
    with pytest.raises(ValueError):  # width 72: not a multiple of 16
        fused_mlp_layer_i8(q["x"], *q["ln"], *_i8(q["mlp"]))


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
    with pytest.raises(ValueError):  # K = 72: not a multiple of 16
        w8a8_matmul(*_w8a8_operands(np.random.default_rng(2), 4, 72, 32, torch.bfloat16, dev))
    with pytest.raises(ValueError):  # layer out of range
        w8a8_matmul_stacked(x, w_q[None], s[None], 1)
    q, k, v, mask = _decode_operands(np.random.default_rng(3), 2, 2, 7, 16, 128, torch.bfloat16, dev)
    with pytest.raises(ValueError):  # bf16 mask
        decode_gqa_attention(q, k, v, mask.bfloat16())
    with pytest.raises(ValueError):  # f32 cache under bf16 queries
        decode_gqa_attention(q, k.float(), v, mask)
    with pytest.raises(ValueError):  # non-contiguous cache
        decode_gqa_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3), v, mask)
    with pytest.raises(ValueError):  # R = 9 query heads per KV head
        decode_gqa_attention(torch.cat([q, q[:, :, :2]], 2), k, v, mask)
    q2, k2, v2, m2 = _decode_operands(np.random.default_rng(4), 2, 2, 7, 16, 96, torch.bfloat16, dev)
    with pytest.raises(ValueError):  # head dim 96
        decode_gqa_attention(q2, k2, v2, m2)


# The weight-only GEMM, relative to max(1, |y|): kernel and plain convert the
# same int8 weights exactly and sum the same exact bf16 products in f32 in
# another order, then scale in f32 and round once to bf16: one bf16 ulp
# (at most 2^-7 |y|) apart where a sum lands next to a rounding boundary.
@pytest.mark.parametrize("M,K,N", [
    (1, 16, 16), (37, 208, 144), (130, 64, 272), (15, 1536, 17920), (15, 1536, 2048),
    (960, 1536, 2048), (960, 1536, 1536), (960, 1536, 17920), (960, 8960, 1536), (1024, 1536, 2048),
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
    assert torch.equal(got, w8_matmul(x, w_q, s))  # no split-K, no atomics: the same bits every run


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
    with pytest.raises(ValueError, match="bf16 activations"):  # f32 activations: not ported
        w8_matmul(x.float(), w_q, s)
    with pytest.raises(ValueError):  # f16 activations
        w8_matmul(x.half(), w_q, s)
    with pytest.raises(ValueError):  # float weights where int8 are taken
        w8_matmul(x, w_q.float(), s)
    with pytest.raises(ValueError):  # scale of the wrong width
        w8_matmul(x, w_q, s[:16])
    with pytest.raises(ValueError):  # K = 72: not a multiple of 16
        w8_matmul(*_w8a8_operands(np.random.default_rng(8), 4, 72, 32, torch.bfloat16, dev))
    with pytest.raises(ValueError):  # x off a 16-byte boundary
        w8_matmul(torch.zeros(4 * 64 + 1, dtype=torch.bfloat16, device=dev)[1:].view(4, 64), w_q, s)
    with pytest.raises(ValueError):  # layer out of range
        w8_matmul_stacked(x, w_q[None], s[None], 1)
