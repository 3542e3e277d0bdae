"""tvc_torch's Qwen decode kernels (plain versions, as the wrappers compute
them on the CPU) against the JAX package's Pallas kernels in interpret mode:
the W8A8 GEMM (flat and stacked) and the GQA decode attention (flat and
stacked), with the same seeded numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvc.core.pallas.decode_attention_kernel import (
    decode_gqa_attention as j_decode,
    decode_gqa_attention_stacked as j_decode_stacked,
    decode_gqa_reference as j_decode_reference,
)
from tvc.core.pallas.quantized_layer_kernel import quantize_linear as j_quantize
from tvc.core.pallas.w8_matmul_kernel import w8a8_matmul as j_w8a8, w8a8_matmul_stacked as j_w8a8_stacked
from tvc_torch.core.kernels.decode_attention_kernel import (
    MAX_CHUNK,
    MIN_SPLIT,
    decode_gqa_attention,
    decode_gqa_attention_stacked,
    decode_gqa_reference,
    decode_splits,
)
from tvc_torch.core.kernels.quantized_layer_kernel import _quant_rows
from tvc_torch.core.kernels.w8_matmul_kernel import (
    I8_BK,
    I8_MAX_SPLITS,
    I8_TILES,
    i8_plan,
    w8a8_matmul,
    w8a8_matmul_reference,
    w8a8_matmul_stacked,
)

M, K, N, L = 24, 64, 96, 3


@pytest.fixture(scope="module")
def gemm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[3] = 0.0  # an all-zero row: the 1e-12 clamp
    x[5, :4] = [127.0, 0.5, 1.5, -2.5]  # exact .5 quanta at scale 1
    ws = [j_quantize(jnp.asarray(0.1 * rng.standard_normal((K, N)).astype(np.float32))) for _ in range(L)]
    w_q = np.stack([np.asarray(w) for w, _ in ws])
    scale = np.stack([np.asarray(s) for _, s in ws])
    return x, w_q, scale


def _ulps_bf16(got: np.ndarray, want: np.ndarray) -> int:
    """The largest distance in bf16 steps (bf16 bit patterns as integers)."""
    g = torch.as_tensor(np.array(got)).to(torch.bfloat16).view(torch.int16).int()
    w = torch.as_tensor(np.array(want)).to(torch.bfloat16).view(torch.int16).int()
    return int((g - w).abs().max())


def test_w8a8_row_quantization_equals_jax(gemm):
    """The port's int8 operand is the TPU kernel's (w8_matmul_kernel.py:225-227)."""
    x = gemm[0]
    xf = jnp.asarray(x)
    rs = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-12) / 127.0
    xq = jnp.clip(jnp.round(xf / rs), -127, 127).astype(jnp.int8)
    tq, ts = _quant_rows(torch.as_tensor(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(xq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
    assert list(tq.numpy()[5, :4]) == [127, 0, 2, -2] and not tq.numpy()[3].any()


@pytest.mark.parametrize("port_fn", [w8a8_matmul, w8a8_matmul_reference], ids=["wrapper", "plain"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a8_matmul_matches_pallas(gemm, port_fn, dtype):
    """f32: within 1e-6 of max(1, |y|) (one rounding of the same f32
    dequant, XLA may take 1/127 as a reciprocal product); bf16: one ulp."""
    x, w_q, scale = gemm
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(j_w8a8(jx, jnp.asarray(w_q[1]), jnp.asarray(scale[1]), interpret=True).astype(jnp.float32))
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    got = port_fn(tx, torch.as_tensor(w_q[1]), torch.as_tensor(scale[1]))
    assert got.dtype == tx.dtype and got.shape == (M, N)
    got = got.float().numpy()
    if dtype == "float32":
        assert np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))) <= 1e-6
    else:
        assert _ulps_bf16(got, want) <= 1


@pytest.mark.parametrize("layer", [0, 2])
def test_w8a8_matmul_stacked_matches_pallas(gemm, layer):
    x, w_q, scale = gemm
    want = np.asarray(j_w8a8_stacked(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(scale), layer, interpret=True))
    got = w8a8_matmul_stacked(torch.as_tensor(x), torch.as_tensor(w_q), torch.as_tensor(scale), layer)
    assert np.max(np.abs(got.numpy() - want) / np.maximum(1.0, np.abs(want))) <= 1e-6
    flat = w8a8_matmul(torch.as_tensor(x), torch.as_tensor(w_q[layer]), torch.as_tensor(scale[layer]))
    assert torch.equal(got, flat)


def test_w8a8_matmul_refuses_bad_stacks(gemm):
    x, w_q, scale = (torch.as_tensor(a) for a in gemm)
    with pytest.raises(ValueError):
        w8a8_matmul_stacked(x, w_q, scale, L)
    with pytest.raises(ValueError):
        w8a8_matmul_stacked(x, w_q[0], scale[0], 0)


B, KV, R, S, D = 5, 2, 7, 20, 64


@pytest.fixture(scope="module")
def attn():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, KV, R, D)).astype(np.float32)
    k = rng.standard_normal((L, B, KV, S, D)).astype(np.float32)
    v = rng.standard_normal((L, B, KV, S, D)).astype(np.float32)
    mask = np.where(rng.random((B, S)) < 0.3, -np.inf, 0.0).astype(np.float32)
    mask[:, 0] = 0.0
    mask[2, 1:] = -np.inf  # a row that sees one slot only
    return q, k, v, mask


def _err(got, want):
    return float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))))


@pytest.mark.parametrize("port_fn", [decode_gqa_attention, decode_gqa_reference], ids=["wrapper", "plain"])
def test_decode_gqa_matches_pallas_f32(attn, port_fn):
    q, k, v, mask = attn
    args = [jnp.asarray(a) for a in (q, k[0], v[0], mask)]
    want = np.asarray(j_decode(*args, block_b=8, interpret=True))
    oracle = np.asarray(j_decode_reference(*args))
    got = port_fn(*(torch.as_tensor(a) for a in (q, k[0], v[0], mask))).numpy()
    assert _err(got, want) <= 2e-5 and _err(got, oracle) <= 2e-5
    # the one-slot row returns that slot's value exactly (weight 1)
    np.testing.assert_allclose(got[2], np.broadcast_to(v[0][2, :, :1], (KV, R, D)), atol=2e-6)


def test_decode_gqa_matches_pallas_bf16(attn):
    """bf16 operands: the weights are rounded to bf16 before AV as in the
    TPU kernel; an f32 weight one ulp apart (exp and sums in another order)
    can round to the neighbouring bf16 value, so 1e-2 of max(1, |y|)."""
    q, k, v, mask = attn
    jargs = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k[0], v[0])] + [jnp.asarray(mask)]
    want = np.asarray(j_decode(*jargs, block_b=8, interpret=True).astype(jnp.float32))
    targs = [torch.as_tensor(a).to(torch.bfloat16) for a in (q, k[0], v[0])] + [torch.as_tensor(mask)]
    got = decode_gqa_attention(*targs)
    assert got.dtype == torch.bfloat16
    assert _err(got.float().numpy(), want) <= 1e-2


@pytest.mark.parametrize("layer", [1, 2])
def test_decode_gqa_stacked_matches_pallas(attn, layer):
    q, k, v, mask = attn
    want = np.asarray(j_decode_stacked(*(jnp.asarray(a) for a in (q, k, v, mask)), layer, block_b=8, interpret=True))
    got = decode_gqa_attention_stacked(*(torch.as_tensor(a) for a in (q, k, v, mask)), layer)
    assert _err(got.numpy(), want) <= 2e-5
    flat = decode_gqa_attention(*(torch.as_tensor(a) for a in (q, k[layer], v[layer], mask)))
    assert torch.equal(got, flat)


@pytest.mark.parametrize("B,KV,R,S,D", [(1, 1, 8, 7000, 16), (3, 2, 1, 50, 32)])
@pytest.mark.parametrize("port_fn", [decode_gqa_attention, decode_gqa_reference], ids=["wrapper", "plain"])
def test_decode_gqa_matches_pallas_long_cache_and_one_head(port_fn, B, KV, R, S, D):
    """Shapes the CUDA kernel now takes: S = 7,000 (past the 6,600 slots
    whose R = 8 logits used to fit one block's shared memory; split across
    blocks now) and R = 1, f32 to 2e-5."""
    rng = np.random.default_rng(S)
    q = rng.standard_normal((B, KV, R, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, KV, S, D)).astype(np.float32) for _ in range(2))
    mask = np.where(rng.random((B, S)) < 0.3, -np.inf, 0.0).astype(np.float32)
    mask[:, 0] = 0.0
    want = np.asarray(j_decode(*(jnp.asarray(a) for a in (q, k, v, mask)), block_b=8, interpret=True))
    got = port_fn(*(torch.as_tensor(a) for a in (q, k, v, mask))).numpy()
    assert _err(got, want) <= 2e-5


@pytest.mark.parametrize("bkv,S", [(2304, 64), (2304, 512), (1920, 64), (10, 64), (16, 16384), (4, 8192), (1, 3),
                                   (1, 7000), (264, 5000)])
def test_decode_splits_cover_the_cache(bkv, S):
    """The CUDA wrapper's cut of S across blocks: chunks of a multiple of
    16 slots, at most MAX_CHUNK, covering S with no empty split; one split
    when B * KV gives two blocks a SM of 132 and S fits a block, or when S
    is too short to cut (<= MIN_SPLIT); else the blocks fill at least half
    of the two a SM, or give each split about MIN_SPLIT slots."""
    splits, chunk = decode_splits(bkv, S)
    assert chunk % 16 == 0 and 16 <= chunk <= MAX_CHUNK
    assert (splits - 1) * chunk < S <= splits * chunk
    if bkv >= 264 and S <= MAX_CHUNK:
        assert splits == 1
    if S <= MIN_SPLIT:
        assert splits == 1
    if bkv < 264:
        assert bkv * splits >= min(132, bkv * (S // MIN_SPLIT))
    assert bkv * splits <= max(264, bkv * -(-S // MAX_CHUNK))


# The int8 GEMM's shapes in the table (Qwen2-7B W8A8 at M = 576 and the
# suffix prefill's 4,608 rows; the int8 CLIP layers' GEMMs at the vision,
# text T=16 / T=32, ViT-L/14 and T=300 shapes) and odd ones.
I8_SHAPES = [
    (576, 4608, 3584), (576, 3584, 3584), (576, 37888, 3584), (576, 3584, 18944), (576, 151936, 3584),
    (4608, 4608, 3584), (3200, 2304, 768), (3200, 768, 768), (3200, 3072, 768), (3200, 768, 3072),
    (7168, 1536, 512), (7168, 512, 512), (7168, 2048, 512), (7168, 512, 2048), (14336, 1536, 512),
    (14336, 512, 2048), (2056, 3072, 1024), (2056, 1024, 1024), (1200, 2304, 768), (1200, 768, 768),
    (1, 16, 16), (15, 144, 48), (577, 2320, 784), (20, 4608, 3584), (15, 3584, 18944), (1, 151936, 3584),
    (130, 272, 64), (100000, 16, 16),
]


@pytest.mark.parametrize("M,N,K", I8_SHAPES)
def test_i8_plan_covers_k_once(M, N, K):
    """The int8 kernel's plan: one of its tiles, and split ranges of ``per``
    128-deep k-tiles (the kernel's ``n = min(per, nk - kt0)`` for split z,
    ``kt0 = z per``) that are none empty and cover the k-tiles exactly
    once, as the C entry point checks."""
    bm, bn, splits, per = i8_plan(M, N, K)
    assert (bm, bn) in I8_TILES
    nk = -(-K // I8_BK)
    assert 1 <= splits <= I8_MAX_SPLITS and per >= 1
    covered = []
    for z in range(splits):
        n = min(per, nk - z * per)
        assert n >= 1
        covered += range(z * per, z * per + n)
    assert covered == list(range(nk))


def test_i8_plan_takes_192_rows_at_the_decode_batch():
    """M = 576 is three 192-row blocks (128-row blocks would leave half of
    the fifth empty); the weight-heavy decode GEMMs take them."""
    for N, K in ((4608, 3584), (3584, 3584), (37888, 3584), (3584, 18944), (151936, 3584)):
        assert i8_plan(576, N, K)[0] == 192


def test_decode_gqa_wrappers_raise_off_cpu(attn):
    """A non-CPU tensor goes to the kernel path, which checks its operands
    and raises; there is no fallback to the plain version."""
    q, k, v, mask = (torch.as_tensor(a).to("meta") for a in attn)
    with pytest.raises(ValueError):
        decode_gqa_attention(q, k[0], v[0], mask)  # f32 mask fine, but meta is no CUDA device
    with pytest.raises(ValueError):
        decode_gqa_attention_stacked(q, k, v, mask, 3)
    with pytest.raises(ValueError):
        w8a8_matmul(torch.zeros((2, 16), device="meta"), torch.zeros((16, 16), dtype=torch.int8, device="meta"),
                    torch.zeros(16, device="meta"))
