"""DeepSeek-V2's fused decode-layer kernels on the CPU
(``tvc_torch/core/kernels/dsv2_fused_kernel.py``; the card tests are in
``tests/test_torch_dsv2_cuda.py``).

Each wrapper's plain version equals, bit for bit, the expressions
``DeepseekV2Model._attention`` / ``_moe`` ran before the kernels (the tiny
configuration's widths and the published ones, f32 and bf16);
``mla_rope_cache`` writes exactly one slot of one layer; ``moe_route``'s
positions invert the stable sort by expert and its counts add into the
given row; the CPU wrappers launch nothing, and a tensor off the CPU never
takes the plain version.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import tvc_torch.models.deepseek_v2 as ds
from chip_smoke import DSV2_FUSED
from tvc_torch.core.kernels import (
    launch_counts,
    mla_out,
    mla_out_reference,
    mla_rope_cache,
    mla_rope_cache_reference,
    moe_combine,
    moe_combine_reference,
    moe_route,
    moe_route_reference,
    reset_launch_counts,
)
from tvc_torch.core.kernels.decode_fused_kernel import rmsnorm_reference

DTYPES = (torch.bfloat16, torch.float32)
CONFIGS = {"tiny": ds.DeepseekV2Config.tiny(), "lite": ds.DeepseekV2Config.deepseek_v2_lite()}


def _rows(shape, dtype, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(dtype)


# -- the expressions the model ran before the kernels ------------------------------------
def _old_rope(x, cos, sin):
    d, half = x.shape[-1], x.shape[-1] // 2
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _old_attention_glue(c, qa, cos, sin, suk, kv_norm, cache, l, idx):
    """The decode step's rope, latent norm, cache writes and q_nope scales."""
    dt = qa.dtype
    B, T, _ = qa.shape
    nh, dn, r = c.num_heads, c.qk_nope_head_dim, c.kv_lora_rank
    nq = nh * c.q_head_dim
    q = qa[..., :nq].reshape(B, T, nh, c.q_head_dim)
    q_pe = _old_rope(q[..., dn:], cos, sin)
    x32 = qa[..., nq : nq + r].float()
    lat = (x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + c.rms_eps) * kv_norm).to(dt)
    cache[l, :, idx : idx + T, :r] = lat
    cache[l, :, idx : idx + T, r:] = _old_rope(qa[..., None, nq + r :], cos, sin)[:, :, 0]
    qn = (q[..., :dn][:, 0].float() * suk).to(dt).transpose(0, 1)
    return qn, q_pe[:, 0].contiguous()


def _old_route(logits, xf, k, counts):
    N, E = logits.shape
    topv, topi = torch.topk(torch.softmax(logits, dim=-1), k, dim=-1)
    ids = topi.reshape(-1)
    counts.scatter_add_(0, ids, torch.ones(N * k, dtype=torch.int32))
    offsets = F.pad(torch.cumsum(counts, 0, dtype=torch.int32), (1, 0))
    order = torch.argsort(ids, stable=True)
    xs = xf.index_select(0, torch.div(order, k, rounding_mode="floor")).contiguous()
    return topv, topi, order, xs, offsets


def _old_combine(yd, order, topv, shared, scale):
    N, k = topv.shape
    y = torch.empty_like(yd)
    y[order] = yd
    routed = (y.view(N, k, -1).float() * (topv * scale)[:, :, None]).sum(dim=1)
    return (routed + shared.float()).to(shared.dtype)


def _attention_operands(c, dtype, B=5, L=3, S=9, seed=0):
    W = c.num_heads * c.q_head_dim + c.latent_width
    qa = _rows((B, 1, W), dtype, seed, 3.0)
    pos = torch.arange(B)[:, None] * 7 + 3
    cos, sin = ds.yarn_tables(pos, c, ds.yarn_inv_freq(c))
    suk = _rows((c.num_heads, c.qk_nope_head_dim), torch.float32, seed + 1).abs() * 1e-2
    kv_norm = 1 + 0.1 * _rows((c.kv_lora_rank,), torch.float32, seed + 2)
    cache = _rows((L, B, S, c.latent_width), dtype, seed + 3)
    return qa, cos, sin, suk, kv_norm, cache


# -- the plain versions ------------------------------------------------------------------
@pytest.mark.parametrize("cfg", CONFIGS, ids=CONFIGS)
@pytest.mark.parametrize("dtype", DTYPES, ids=("bf16", "f32"))
def test_plain_mla_rope_cache_equals_the_replaced_expressions(dtype, cfg):
    c = CONFIGS[cfg]
    qa, cos, sin, suk, kv_norm, cache = _attention_operands(c, dtype)
    want_cache = cache.clone()
    want = _old_attention_glue(c, qa, cos, sin, suk, kv_norm, want_cache, 2, 4)
    for fn in (mla_rope_cache_reference, mla_rope_cache):
        got_cache = cache.clone()
        got = fn(qa, cos, sin, suk, kv_norm, c.rms_eps, got_cache, 2, 4)
        assert got[0].shape == (c.num_heads, qa.shape[0], c.qk_nope_head_dim)
        assert got[1].shape == (qa.shape[0], c.num_heads, c.qk_rope_head_dim) and got[1].is_contiguous()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert torch.equal(got_cache, want_cache)


def test_mla_rope_cache_writes_exactly_its_slot():
    """Every slot but ``cache_index`` of layer ``layer`` keeps its bits;
    that slot holds the normed latent, then the roped k_pe."""
    c = CONFIGS["lite"]
    qa, cos, sin, suk, kv_norm, cache = _attention_operands(c, torch.bfloat16, B=3, L=4, S=16)
    before = cache.clone()
    mla_rope_cache(qa, cos, sin, suk, kv_norm, c.rms_eps, cache, 1, 13)
    changed = (cache != before).any(dim=(1, 3))  # [L, S]
    assert changed[1, 13] and int(changed.sum()) == 1
    nq, r = c.num_heads * c.q_head_dim, c.kv_lora_rank
    assert torch.equal(cache[1, :, 13, :r], rmsnorm_reference(qa[:, 0, nq : nq + r], kv_norm, c.rms_eps))
    assert torch.equal(cache[1, :, 13, r:], ds.rope_interleaved(qa[:, :, None, nq + r :], cos, sin)[:, 0, 0])


@pytest.mark.parametrize("cfg", CONFIGS, ids=CONFIGS)
@pytest.mark.parametrize("dtype", DTYPES, ids=("bf16", "f32"))
def test_plain_mla_out_equals_the_replaced_expression(dtype, cfg):
    c = CONFIGS[cfg]
    B, nh, dv = 5, c.num_heads, c.v_head_dim
    o, suv = _rows((nh, B, dv), dtype, 0, 3.0), _rows((nh, dv), torch.float32, 1).abs() * 1e-2
    want = (o.float() * suv[:, None, :]).to(dtype).transpose(0, 1).reshape(B, 1, nh * dv)
    assert torch.equal(mla_out_reference(o, suv), want) and torch.equal(mla_out(o, suv), want)


@pytest.mark.parametrize("N", [1, 7, 40])
@pytest.mark.parametrize("cfg", CONFIGS, ids=CONFIGS)
@pytest.mark.parametrize("dtype", DTYPES, ids=("bf16", "f32"))
def test_plain_moe_route_and_combine_equal_the_replaced_expressions(dtype, cfg, N):
    """Routing ids, weights, counts, offsets and the sorted rows as before;
    the positions invert the stable order; the combine through them equals
    the unsort-then-sum it replaced."""
    c = CONFIGS[cfg]
    E, k, H = c.n_routed_experts, c.num_experts_per_tok, c.hidden_size
    logits, x = _rows((N, E), torch.float32, 0), _rows((N, H), dtype, 1)
    prior = torch.arange(E, dtype=torch.int32) % 3
    c_old, c_new = prior.clone(), prior.clone()
    topv, topi, order, xs, offsets = _old_route(logits, x, k, c_old)
    got = moe_route(logits, x, k, c_new)
    assert torch.equal(got[0], topv) and torch.equal(got[1], topi) and torch.equal(got[3], xs)
    assert torch.equal(got[4], offsets) and torch.equal(c_new, c_old)
    pos = got[2]
    assert pos.shape == (N, k) and pos.dtype == torch.int32
    assert torch.equal(pos.reshape(-1)[order], torch.arange(N * k, dtype=torch.int32))
    yd, shared = _rows((N * k, H), dtype, 2), _rows((N, H), dtype, 3)
    want = _old_combine(yd, order, topv, shared, c.routed_scaling_factor)
    assert torch.equal(moe_combine_reference(yd, pos, topv, shared, c.routed_scaling_factor), want)
    assert torch.equal(moe_combine(yd, pos, topv, shared, c.routed_scaling_factor), want)


def test_moe_route_without_counts_starts_from_zero():
    """The prefill's routing (no counter row): offsets are the cumulative
    counts of this call alone; the sorted rows group each expert's rows in
    row order."""
    E, k, N, H = 16, 6, 12, 64
    logits, x = _rows((N, E), torch.float32, 4), _rows((N, H), torch.float32, 5)
    topv, topi, pos, xs, offsets = moe_route(logits, x, k)
    counts = torch.bincount(topi.reshape(-1), minlength=E)
    assert torch.equal(offsets, F.pad(torch.cumsum(counts, 0, dtype=torch.int32), (1, 0)))
    for e in range(E):
        rows = [n for n in range(N) if e in topi[n].tolist()]
        lo = int(offsets[e])
        assert torch.equal(xs[lo : lo + len(rows)], x[rows])
        assert sorted(int(pos[n, topi[n].tolist().index(e)]) for n in rows) == list(range(lo, lo + len(rows)))


def test_combine_scales_the_routed_weights():
    """``scale`` multiplies the routing weights before the products (the
    published routed_scaling_factor)."""
    N, k, H = 3, 2, 8
    yd, shared = _rows((N * k, H), torch.float32, 6), torch.zeros(N, H)
    topv = torch.rand(N, k, generator=torch.Generator().manual_seed(7))
    pos = torch.arange(N * k, dtype=torch.int32).view(N, k)
    got = moe_combine(yd, pos, topv, shared, 2.5)
    want = (yd.view(N, k, H) * (topv * 2.5)[:, :, None]).sum(dim=1)
    assert torch.equal(got, want)


def test_cpu_wrappers_launch_nothing():
    reset_launch_counts()
    c = CONFIGS["tiny"]
    qa, cos, sin, suk, kv_norm, cache = _attention_operands(c, torch.float32)
    mla_rope_cache(qa, cos, sin, suk, kv_norm, c.rms_eps, cache, 0, 0)
    mla_out(_rows((4, 3, 16), torch.float32, 0), torch.ones(4, 16))
    topv, _, pos, xs, _ = moe_route(_rows((3, 16), torch.float32, 1), _rows((3, 64), torch.float32, 2), 6)
    moe_combine(xs, pos, topv, _rows((3, 64), torch.float32, 3), 1.0)
    assert all(launch_counts()[n] == 0 for n in DSV2_FUSED)


def test_off_cpu_calls_raise():
    """A tensor off the CPU never takes the plain version: a dtype the
    kernels do not take raises, and a device other than CUDA raises."""
    meta = lambda shape, dt=torch.bfloat16: torch.empty(shape, dtype=dt, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="unsupported device"):
        mla_out(meta((16, 4, 128)), torch.ones(16, 128))
    with pytest.raises(ValueError, match="unsupported device"):
        moe_route(meta((4, 64), torch.float32), meta((4, 2048)), 6)
    with pytest.raises(ValueError, match="unsupported device"):
        moe_combine(meta((24, 2048)), meta((4, 6), torch.int32), meta((4, 6), torch.float32), meta((4, 2048)), 1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        mla_rope_cache(meta((4, 1, 3648)), torch.zeros(4, 1, 1, 32), torch.zeros(4, 1, 1, 32), torch.ones(16, 128),
                       torch.ones(512), 1e-6, meta((2, 4, 8, 576)), 0, 0)


def test_routing_reference_matches_numpy_softmax_top_k():
    """The routing weights are the f32 softmax's top k by value (not
    renormalised), ids by descending weight."""
    logits = _rows((5, 16), torch.float32, 8, 2.0)
    topv, topi, *_ = moe_route_reference(logits, torch.zeros(5, 4), 3)
    p = np.exp(logits.double().numpy() - logits.double().numpy().max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    assert np.array_equal(topi.numpy(), np.argsort(-p, axis=-1, kind="stable")[:, :3])
    np.testing.assert_allclose(topv.numpy(), np.take_along_axis(p, topi.numpy(), -1), rtol=1e-6)
