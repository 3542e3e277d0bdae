"""The fused elementwise kernels of the decoder layers
(``tvc_torch/core/kernels/decode_fused_kernel.py``, ``csrc/decode_fused.cu``).

On the CPU: each wrapper's plain version equals the expression the models
ran before it, bit for bit (bf16 and f32, the configurations' widths);
``qkv_rope_cache`` writes exactly one slot of one layer of both caches;
tiny Qwen2 and DeepSeek-V2 decodes through the fused layer loops give the
tokens and logits of the unfused loops they replaced (DeepSeek-V2's with its
own fused kernels, ``dsv2_fused_kernel``, too); one decode step of each
calls each wrapper as often as the card counts its launches; a call
off the CPU with a dtype the kernels do not take raises.

Marked ``cuda`` (each skips without a GPU; on the card, without JAX):
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_decode_fused.py
each kernel against its plain version at the decode's shapes, one
Qwen2-1.5B-width decode step at 960 rows under
``torch.cuda.set_sync_debug_mode("error")`` with its launches counted, and
a 28-layer teacher-forced decode at Qwen2-1.5B widths against the
benchmark's f32 reference.
"""

import contextlib
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
import tvc_torch.models.decoding as decoding
import tvc_torch.models.deepseek_v2 as ds
import tvc_torch.models.qwen as tq
from tvc_torch.core.kernels import (
    add_rmsnorm,
    add_rmsnorm_reference,
    launch_counts,
    qkv_rope_cache,
    qkv_rope_cache_reference,
    reset_launch_counts,
    rmsnorm,
    rmsnorm_reference,
    silu_mul,
    silu_mul_reference,
)
from tvc_torch.models.decoding import PARAPHRASE_PREFIX, PARAPHRASE_PROMPT, _stable_seed

WIDTHS = (64, 512, 1536, 2048)
DTYPES = (torch.bfloat16, torch.float32)
#: (nh, kv, D): QwenConfig.tiny(), Qwen2-0.5B, Qwen2-1.5B, Qwen2-7B
HEADS = ((4, 2, 16), (14, 2, 64), (12, 2, 128), (28, 4, 128))
FUSED = ("rmsnorm", "add_rmsnorm", "qkv_rope_cache", "silu_mul")


# -- the expressions the models ran before the fused kernels ----------------------------
def _old_rmsnorm(x, scale, eps):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _old_rope(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _old_qwen_layers(self, stacked, x, positions, mask, caches, cache_index, ctx=0, step=None, lengths=None):
    """QwenModel's layer loop before the fused kernels (each residual add
    done in the layer)."""
    c = self.config
    cos, sin = tq.rope_tables(positions, c.hidden_size // c.num_heads, c.rope_theta)
    ck, cv = caches
    for l in range(c.num_layers):
        h = x
        B, T, _ = h.shape
        Dh = c.hidden_size // c.num_heads
        nq, nkv, R = c.num_heads * Dh, c.num_kv_heads * Dh, c.num_heads // c.num_kv_heads
        x = _old_rmsnorm(h, stacked["ln_attn"][l], c.rms_eps)
        qkv = self._mm(x, stacked["wqkv"], l) + stacked["bqkv"][l].to(c.dtype)
        q = _old_rope(qkv[..., :nq].reshape(B, T, c.num_heads, Dh), cos, sin)
        k = _old_rope(qkv[..., nq : nq + nkv].reshape(B, T, c.num_kv_heads, Dh), cos, sin)
        v = qkv[..., nq + nkv :].reshape(B, T, c.num_kv_heads, Dh)
        k_t, v_t = k.transpose(1, 2), v.transpose(1, 2)
        ck[l, :, :, cache_index : cache_index + T] = k_t
        cv[l, :, :, cache_index : cache_index + T] = v_t
        if T == 1:
            out = tq.decode_gqa_attention_stacked(q.reshape(B, c.num_kv_heads, R, Dh).contiguous(), ck, cv, mask, l)
            out = out.reshape(B, 1, nq)
        else:
            kk, vv = (ck[l, :, :, : ctx + T], cv[l, :, :, : ctx + T]) if ctx else (k_t, v_t)
            qg = q.reshape(B, T, c.num_kv_heads, R, Dh)
            out = tq._gqa_attention(qg, kk, vv, mask[:, 0, :, : ctx + T], c.dtype).reshape(B, T, nq)
        h = h + self._mm(out, stacked["wo"], l)
        gu = self._mm(_old_rmsnorm(h, stacked["ln_mlp"][l], c.rms_eps), stacked["wgu"], l)
        act = F.silu(gu[..., : c.intermediate_size]) * gu[..., c.intermediate_size :]
        x = h + self._mm(act.to(c.dtype), stacked["wd"], l)
    return x, None


def _old_rope_interleaved(x, cos, sin):
    d = x.shape[-1]
    return _old_rope(x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2), cos, sin)


def _old_ds_attention(self, L, l, x, cos, sin, mask, cache, cache_index, ctx):
    """DeepseekV2Model._attention before the fused kernels."""
    c, dt = self.config, self.config.dtype
    B, T, _ = x.shape
    nh, dn, dv, r = c.num_heads, c.qk_nope_head_dim, c.v_head_dim, c.kv_lora_rank
    nq = nh * c.q_head_dim
    qa = self._mm(x, L["wqa"])
    q = qa[..., :nq].reshape(B, T, nh, c.q_head_dim)
    q_nope = q[..., :dn]
    q_pe = _old_rope_interleaved(q[..., dn:], cos, sin)
    cache[l, :, cache_index : cache_index + T, :r] = _old_rmsnorm(qa[..., nq : nq + r], L["kv_norm"], c.rms_eps)
    cache[l, :, cache_index : cache_index + T, r:] = _old_rope_interleaved(qa[..., None, nq + r :], cos, sin)[:, :, 0]
    if T == 1:
        qn = (q_nope[:, 0].float() * L["suk"]).to(dt).transpose(0, 1)
        q_lat = torch.bmm(qn, L["wuk"]).transpose(0, 1).contiguous()
        o_lat = ds.mla_decode_attention(q_lat, q_pe[:, 0].contiguous(), cache, mask, l, c.softmax_scale)
        o = torch.bmm(o_lat.transpose(0, 1), L["wuv"])
        out = (o.float() * L["suv"][:, None, :]).to(dt).transpose(0, 1).reshape(B, 1, nh * dv)
    else:
        lat = cache[l, :, : ctx + T]
        kv = self._mm(lat[..., :r], L["wkb"]).reshape(B, ctx + T, nh, dn + dv)
        lg = (torch.einsum("bthd,bshd->bhts", q_nope.float(), kv[..., :dn].float())
              + torch.einsum("bthd,bsd->bhts", q_pe.float(), lat[..., r:].float())) * c.softmax_scale
        w = torch.softmax(lg + mask[:, :, :, : ctx + T], dim=-1).to(dt)
        out = torch.einsum("bhts,bshd->bthd", w.float(), kv[..., dn:].float()).to(dt).reshape(B, T, nh * dv)
    return self._mm(out, L["wo"])


def _old_ds_moe(self, L, x, step):
    """DeepseekV2Model._moe before the fused kernels."""
    c, dt = self.config, self.config.dtype
    B, T, H = x.shape
    N, k, E, Ie = B * T, c.num_experts_per_tok, c.n_routed_experts, c.moe_intermediate_size
    xf = x.reshape(N, H)
    topv, topi = torch.topk(torch.softmax(xf.float() @ L["router"], dim=-1), k, dim=-1)
    ids = topi.reshape(-1)
    counts = self._counts[step, L["moe_index"]] if step is not None else torch.zeros(E, dtype=torch.int32)
    counts.scatter_add_(0, ids, torch.ones(N * k, dtype=torch.int32))
    offsets = F.pad(torch.cumsum(counts, 0, dtype=torch.int32), (1, 0))
    order = torch.argsort(ids, stable=True)
    xs = xf.index_select(0, torch.div(order, k, rounding_mode="floor")).contiguous()
    gu = ds.moe_w8_grouped_gemm(xs, L["egu"]["int8"], L["egu"]["scale"], offsets)
    act = (F.silu(gu[..., :Ie]) * gu[..., Ie:]).to(dt)
    yd = ds.moe_w8_grouped_gemm(act, L["ed"]["int8"], L["ed"]["scale"], offsets)
    y = torch.empty_like(yd)
    y[order] = yd
    routed = (y.view(N, k, H).float() * (topv * c.routed_scaling_factor)[:, :, None]).sum(dim=1)
    sgu = self._mm(xf, L["sgu"])
    Is = sgu.shape[-1] // 2
    shared = self._mm((F.silu(sgu[..., :Is]) * sgu[..., Is:]).to(dt), L["sd"])
    return (routed + shared.float()).to(dt).reshape(B, T, H)


def _old_ds_layers(self, layers, x, positions, mask, cache, cache_index, ctx=0, step=None, lengths=None):
    """DeepseekV2Model's layer loop before the fused kernels: the norms,
    the rope, the latent norm, the absorbed scales, the routing and the
    combine as the plain expressions they replaced."""
    c, dt = self.config, self.config.dtype
    cos, sin = ds.yarn_tables(positions, c, self._inv_freq)
    for l, L in enumerate(layers):
        h = x
        x = _old_rmsnorm(h, L["ln_attn"], c.rms_eps)
        h = h + _old_ds_attention(self, L, l, x, cos, sin, mask, cache, cache_index, ctx)
        x = _old_rmsnorm(h, L["ln_mlp"], c.rms_eps)
        if "wgu" in L:
            gu = self._mm(x, L["wgu"])
            I = gu.shape[-1] // 2
            x = h + self._mm((F.silu(gu[..., :I]) * gu[..., I:]).to(dt), L["wd"])
        else:
            x = h + _old_ds_moe(self, L, x, step)
    return x, None


class WordTok:
    """Word-level tokenizer without BOS / EOS (the prefix split engages)."""

    def __init__(self, vocab_size=512, context_length=48):
        self.vocab_size, self.context_length, self.pad_id, self.eot_id = vocab_size, context_length, 0, vocab_size - 1

    def __call__(self, texts):
        out = np.full((len(texts), self.context_length), self.pad_id, np.int32)
        for i, t in enumerate(texts):
            ws = "".join(c if c.isalnum() else " " for c in t.lower()).split()
            ids = [1 + (_stable_seed(w) % (self.vocab_size - 3)) for w in ws][: self.context_length]
            out[i, : len(ids)] = ids
        return out

    def decode(self, ids):
        return " ".join(f"w{int(i)}" for i in ids if i not in (self.pad_id, self.eot_id))


PROMPTS = [PARAPHRASE_PROMPT.format(text=t) for t in ("a dog runs in the park", "two cats on a mat near the window")]


def _rows(shape, dtype, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(dtype)


def _qkv_operands(nh, kv, D, dtype, B=5, L=3, S=9, seed=0):
    W = (nh + 2 * kv) * D
    qkv = _rows((B, 1, W), dtype, seed, 3.0)
    bias = _rows((W,), torch.float32, seed + 1)
    pos = torch.arange(B)[:, None] * 7 + 3
    cos, sin = tq.rope_tables(pos, D, 1_000_000.0)
    ck, cv = _rows((L, B, kv, S, D), dtype, seed + 2), _rows((L, B, kv, S, D), dtype, seed + 3)
    return qkv, bias, cos, sin, ck, cv


# -- CPU ---------------------------------------------------------------------------------
@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES, ids=("bf16", "f32"))
def test_plain_norms_and_silu_mul_equal_the_replaced_expressions(dtype, W):
    x, y = _rows((3, 2, W), dtype, 0, 4.0), _rows((3, 2, W), dtype, 1)
    scale = 1 + 0.1 * _rows((W,), torch.float32, 2)
    want = _old_rmsnorm(x, scale, 1e-6)
    assert torch.equal(rmsnorm_reference(x, scale, 1e-6), want) and torch.equal(rmsnorm(x, scale, 1e-6), want)
    h, n = add_rmsnorm(x, y, scale, 1e-6)
    assert h.dtype == n.dtype == dtype
    assert torch.equal(h, x + y) and torch.equal(n, _old_rmsnorm(x + y, scale, 1e-6))
    gu = _rows((3, 2, 2 * W), dtype, 3, 3.0)
    want = (F.silu(gu[..., :W]) * gu[..., W:]).to(dtype)
    assert torch.equal(silu_mul_reference(gu, W), want) and torch.equal(silu_mul(gu, W), want)


@pytest.mark.parametrize("nh,kv,D", HEADS)
@pytest.mark.parametrize("dtype", DTYPES, ids=("bf16", "f32"))
def test_plain_qkv_rope_cache_equals_the_replaced_expressions(dtype, nh, kv, D):
    qkv, bias, cos, sin, ck, cv = _qkv_operands(nh, kv, D, dtype)
    B, nq = qkv.shape[0], nh * D
    ck0, cv0 = ck.clone(), cv.clone()
    x = qkv + bias.to(dtype)
    q = _old_rope(x[..., :nq].reshape(B, 1, nh, D), cos, sin)
    k = _old_rope(x[..., nq : nq + kv * D].reshape(B, 1, kv, D), cos, sin)
    v = x[..., nq + kv * D :].reshape(B, 1, kv, D)
    ck0[2, :, :, 4:5], cv0[2, :, :, 4:5] = k.transpose(1, 2), v.transpose(1, 2)
    got = qkv_rope_cache(qkv, bias, cos, sin, ck, cv, 2, 4)
    assert got.shape == (B, kv, nh // kv, D) and got.is_contiguous()
    assert torch.equal(got, q.reshape(B, kv, nh // kv, D))
    assert torch.equal(ck, ck0) and torch.equal(cv, cv0)


def test_qkv_rope_cache_writes_exactly_its_slot():
    """Every slot but ``cache_index`` of layer ``layer`` keeps its bits in
    both caches; that slot holds the roped k and the biased v."""
    nh, kv, D = 12, 2, 128
    qkv, bias, cos, sin, ck, cv = _qkv_operands(nh, kv, D, torch.bfloat16, L=4, S=16)
    before = ck.clone(), cv.clone()
    qkv_rope_cache_reference(qkv, bias, cos, sin, ck, cv, 1, 13)
    for cache, old in zip((ck, cv), before):
        changed = (cache != old).any(dim=(1, 2, 4))  # [L, S]
        assert changed[1, 13] and int(changed.sum()) == 1
    x = (qkv + bias.to(torch.bfloat16))[:, 0]
    v = x[:, (nh + kv) * D :].reshape(-1, kv, D)
    assert torch.equal(cv[1, :, :, 13], v)
    k = tq.apply_rope(x[:, nh * D : (nh + kv) * D].reshape(-1, 1, kv, D), cos, sin)[:, 0]
    assert torch.equal(ck[1, :, :, 13], k)


def test_add_rmsnorm_returns_the_stream_and_its_norm():
    h, y = _rows((4, 1536), torch.bfloat16, 5, 2.0), _rows((4, 1536), torch.bfloat16, 6)
    scale = torch.ones(1536)
    out = add_rmsnorm(h, y, scale, 1e-6)
    assert isinstance(out, tuple) and len(out) == 2
    assert torch.equal(out[0], h + y) and torch.equal(out[1], rmsnorm(h + y, scale, 1e-6))
    assert not torch.equal(out[0], h)


def _decode_both(model, cls, old, n_samples=2):
    """Tokens and per-step logits of the fused layer loop, then of ``old``
    in its place, on the same prompts and seed."""
    inp = model.prepare(PROMPTS, n_samples=n_samples, shared_prefix=PARAPHRASE_PREFIX)
    runs = []
    for patch in (False, True):
        logits = []
        with mock.patch.object(cls, "_run_layers", old) if patch else contextlib.nullcontext():
            toks = model.decode(inp, temperature=0.8, seed=3, on_logits=lambda i, lg: logits.append(lg.clone()))
        runs.append((toks, torch.stack(logits)))
    return runs


@pytest.mark.parametrize("dtype", DTYPES, ids=("bf16", "f32"))
def test_tiny_qwen_decode_equals_the_unfused_layer_loop(dtype):
    cfg = dataclasses.replace(tq.QwenConfig.tiny(), dtype=dtype)
    m = tq.QwenModel(cfg, seed=0, max_new_tokens=8, init_int8=True, tokenizer=WordTok(), device="cpu")
    (t_new, lg_new), (t_old, lg_old) = _decode_both(m, tq.QwenModel, _old_qwen_layers)
    assert m.last_decode_steps == 8
    assert torch.equal(t_new, t_old) and torch.equal(lg_new, lg_old)


@pytest.mark.parametrize("dtype", DTYPES, ids=("bf16", "f32"))
def test_tiny_deepseek_v2_decode_equals_the_unfused_layer_loop(dtype):
    cfg = dataclasses.replace(ds.DeepseekV2Config.tiny(), dtype=dtype)
    m = ds.DeepseekV2Model(cfg, seed=0, tokenizer=WordTok(), max_new_tokens=8, device="cpu")
    (t_new, lg_new), (t_old, lg_old) = _decode_both(m, ds.DeepseekV2Model, _old_ds_layers)
    assert torch.equal(t_new, t_old) and torch.equal(lg_new, lg_old)


def _spied_step_calls(model, modules, forced_steps=3, names=FUSED):
    """Calls of each fused wrapper in decode step 1 (spied on the CPU,
    where they compute their plain versions)."""
    calls, at = dict.fromkeys(names, 0), {}

    def spy(name, fn):
        def f(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return f

    inp = model.prepare(PROMPTS, n_samples=2, shared_prefix=PARAPHRASE_PREFIX)
    with contextlib.ExitStack() as stack:
        for mod in modules:
            for n in names:
                if hasattr(mod, n):
                    stack.enter_context(mock.patch.object(mod, n, spy(n, getattr(mod, n))))
        model.decode(inp, forced=torch.full((forced_steps, 4), 5),
                     on_logits=lambda i, lg: at.__setitem__(i, dict(calls)))
    return {n: at[2][n] - at[1][n] for n in names}


def test_one_qwen_step_calls_each_fused_wrapper_as_the_card_counts():
    """At 28 layers: 1 rmsnorm, 56 add_rmsnorm (57 norms), 28 q|k|v
    epilogues, 28 SiLU-gated products a step, as chip_smoke's launch
    formula counts a step."""
    cfg = dataclasses.replace(tq.QwenConfig.tiny(), num_layers=28)
    m = tq.QwenModel(cfg, seed=0, max_new_tokens=8, init_int8=True, tokenizer=WordTok(), device="cpu")
    step = _spied_step_calls(m, [tq, decoding])  # the final norm is CausalDecoder's
    assert step == {"rmsnorm": 1, "add_rmsnorm": 56, "qkv_rope_cache": 28, "silu_mul": 28}
    want = chip_smoke.qwen_expected_launches(cfg, 5, 1)
    assert {n: want[n] - chip_smoke.qwen_expected_launches(cfg, 5, 0)[n] for n in FUSED} == step


def test_one_deepseek_v2_step_calls_each_fused_wrapper_as_the_card_counts():
    """The first layer's norm, per layer two norms after residual adds,
    the q|kv_a epilogue (the latent norm in it) and the output scales; the
    dense layer's and each MoE layer's two SiLU-gated products; each MoE
    layer's routing and combine; as chip_smoke's launch formula counts a
    step."""
    cfg = ds.DeepseekV2Config.tiny()
    m = ds.DeepseekV2Model(cfg, seed=0, tokenizer=WordTok(), max_new_tokens=8, device="cpu")
    names = FUSED + chip_smoke.DSV2_FUSED
    step = _spied_step_calls(m, [ds, decoding], names=names)
    L, n_moe = cfg.num_layers, cfg.n_moe_layers
    assert step == {"rmsnorm": 1, "add_rmsnorm": 2 * L, "qkv_rope_cache": 0,
                    "silu_mul": cfg.first_k_dense + 2 * n_moe, "mla_rope_cache": L, "mla_out": L,
                    "moe_route": n_moe, "moe_combine": n_moe}
    want = chip_smoke.dsv2_step_launches(cfg, 4)
    assert {n: want[n] for n in names if n != "qkv_rope_cache"} == \
        {n: step[n] for n in names if n != "qkv_rope_cache"}


def test_cpu_wrappers_launch_nothing():
    reset_launch_counts()
    qkv, bias, cos, sin, ck, cv = _qkv_operands(4, 2, 16, torch.float32)
    x = _rows((3, 64), torch.float32, 0)
    rmsnorm(x, torch.ones(64), 1e-6)
    add_rmsnorm(x, x, torch.ones(64), 1e-6)
    qkv_rope_cache(qkv, bias, cos, sin, ck, cv, 0, 0)
    silu_mul(_rows((3, 64), torch.float32, 1), 32)
    assert all(launch_counts()[n] == 0 for n in FUSED)


def test_off_cpu_calls_with_other_dtypes_raise():
    """A tensor off the CPU never takes the plain version: a dtype the
    kernels do not take raises before any device check, and a device other
    than CUDA raises."""
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")  # noqa: E731
    f16, bf = torch.float16, torch.bfloat16
    with pytest.raises(ValueError, match="bf16 or float32"):
        rmsnorm(meta((4, 64), f16), torch.ones(64), 1e-6)
    with pytest.raises(ValueError, match="bf16 or float32"):
        add_rmsnorm(meta((4, 64), f16), meta((4, 64), f16), torch.ones(64), 1e-6)
    with pytest.raises(ValueError, match="bf16 or float32"):
        silu_mul(meta((4, 64), f16), 32)
    with pytest.raises(ValueError, match="bf16 or float32"):
        qkv_rope_cache(meta((4, 1, 128), f16), torch.zeros(128), torch.zeros(4, 8), torch.zeros(4, 8),
                       meta((1, 4, 2, 8, 16), f16), meta((1, 4, 2, 8, 16), f16), 0, 0)
    with pytest.raises(ValueError, match="share dtype"):
        add_rmsnorm(meta((4, 64), bf), meta((4, 64), torch.float32), torch.ones(64), 1e-6)
    with pytest.raises(ValueError, match="unsupported device"):
        rmsnorm(meta((4, 64), bf), torch.ones(64), 1e-6)


# -- the card ----------------------------------------------------------------------------
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _card(shape, dtype, dev, seed, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,W,ld,off", [(960, 1536, 1536, 0), (960, 2048, 2048, 0), (960, 512, 3648, 3072),
                                           (576, 3584, 3584, 0), (6144, 1536, 1536, 0), (15, 1536, 1536, 0),
                                           (7, 3584, 3584, 0), (2, 2048, 2048, 0), (1, 3584, 3584, 0), (4, 64, 64, 0),
                                           (960, 64, 64, 0), (5, 96, 100, 2)])
@pytest.mark.parametrize("dtype", DTYPES, ids=("bf16", "f32"))
def test_norms_bit_equal_on_the_card(dev, dtype, rows, W, ld, off):
    """The norms the models run (Qwen2-1.5B and DeepSeek-V2-Lite at 960
    decode rows, the latent norm over a strided slice, Qwen2-7B at 576,
    a prefill block, the prefix's 15 rows, a few rows and one, the tiny
    width, a width and stride off 8 bytes): the residual stream and the
    norm bit-equal to the plain version on the card, whose mean sums in
    the order the kernel follows; two calls the same bits."""
    base = _card((rows, ld), dtype, dev, 0, 4.0)
    x = base[:, off : off + W]
    y = _card((rows, W), dtype, dev, 1)
    scale = 1 + 0.1 * _card((W,), torch.float32, dev, 2)
    before = (rmsnorm.launches, add_rmsnorm.launches)
    got = rmsnorm(x, scale, 1e-6)
    assert torch.equal(got, rmsnorm_reference(x, scale, 1e-6))
    assert torch.equal(got, rmsnorm(x, scale, 1e-6))
    h = x.contiguous()
    h_new, n = add_rmsnorm(h, y, scale, 1e-6)
    h_ref, n_ref = add_rmsnorm_reference(h, y, scale, 1e-6)
    assert torch.equal(h_new, h_ref) and torch.equal(n, n_ref)
    assert (rmsnorm.launches, add_rmsnorm.launches) == (before[0] + 2, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("nh,kv,D", HEADS)
@pytest.mark.parametrize("dtype", DTYPES, ids=("bf16", "f32"))
def test_qkv_rope_cache_bit_equal_on_the_card(dev, dtype, nh, kv, D):
    """960 rows (Qwen2-1.5B's q|k|v 960 x 2048 among them), layer 27 of
    28, slot 40 of 64: q and both caches bit-equal to the plain version."""
    B, L, S, W = 960, 28, 64, (nh + 2 * kv) * D
    qkv = _card((B, 1, W), dtype, dev, 0, 3.0)
    bias = _card((W,), torch.float32, dev, 1)
    cos, sin = tq.rope_tables((torch.arange(B, device=dev)[:, None] % 61) + 3, D, 1_000_000.0)
    ck, cv = _card((L, B, kv, S, D), dtype, dev, 2), _card((L, B, kv, S, D), dtype, dev, 3)
    rk, rv = ck.clone(), cv.clone()
    before = qkv_rope_cache.launches
    got = qkv_rope_cache(qkv, bias, cos, sin, ck, cv, L - 1, 40)
    want = qkv_rope_cache_reference(qkv, bias, cos, sin, rk, rv, L - 1, 40)
    assert qkv_rope_cache.launches == before + 1
    assert torch.equal(got, want) and torch.equal(ck, rk) and torch.equal(cv, rv)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,I", [(960, 8960), (5760, 1408), (960, 2816), (960, 10944), (5, 100)])
@pytest.mark.parametrize("dtype", DTYPES, ids=("bf16", "f32"))
def test_silu_mul_bit_equal_on_the_card(dev, dtype, rows, I):
    """Qwen2-1.5B's gate|up (960 x 17,920), DeepSeek-V2-Lite's routed
    experts (5,760 x 2,816), shared experts and dense layer, and a width
    off 16 bytes: bit-equal to the plain version."""
    gu = _card((rows, 2 * I), dtype, dev, 0, 3.0)
    before = silu_mul.launches
    got = silu_mul(gu, I)
    assert silu_mul.launches == before + 1
    assert torch.equal(got, silu_mul_reference(gu, I))


@pytest.mark.cuda
def test_kernels_refuse_other_dtypes_on_the_card(dev):
    x = _card((4, 64), torch.float16, dev, 0)
    with pytest.raises(ValueError, match="bf16 or float32"):
        rmsnorm(x, torch.ones(64, device=dev), 1e-6)
    with pytest.raises(ValueError, match="bf16 or float32"):
        silu_mul(x, 32)
    with pytest.raises(ValueError, match="bf16 or float32"):
        add_rmsnorm(x, x, torch.ones(64, device=dev), 1e-6)


def _bench_qwen(dev):
    """The tvc-qwen2-1.5b-w8 configuration's model on its seeded weights, as
    the benchmark builds it, and its f32 reference."""
    import json
    from pathlib import Path

    from perfbench import weights
    from perfbench.drivers.pipeline_stream import qwen_config

    cfg = json.loads((Path(__file__).resolve().parents[1] / "perfbench/configs/tvc-qwen2-1.5b-w8.json").read_text())
    p = weights.qwen_params(cfg["qwen"], 0, dev)
    model = tq.QwenModel(qwen_config(cfg), params=weights.nest(p), max_new_tokens=8, cast_params_bf16=True,
                         device=dev)
    model.quantize_weights_int8()
    return cfg, model, p


@pytest.fixture(scope="module")
def qwen15(request):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return _bench_qwen(torch.device("cuda", 0))


@pytest.mark.cuda
def test_one_qwen_step_at_960_rows_launches_the_fused_kernels_and_syncs_nothing(qwen15):
    """Decode step 1 of 192 prompts x 5 samples: 57 norms, 28 q|k|v
    epilogues, 28 SiLU-gated products, no host synchronisation, and at most
    450 device kernels in all (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    _, m, _ = qwen15
    caps = [f"caption number {i} of a man riding a wave" for i in range(192)]
    inp = m.prepare([PARAPHRASE_PROMPT.format(text=t) for t in caps], 5, None, PARAPHRASE_PREFIX)
    at, prof = {}, profile(activities=[ProfilerActivity.CUDA])

    def start(i, lg):
        if i == 1:
            torch.cuda.synchronize()
            prof.__enter__()
            reset_launch_counts()
            torch.cuda.set_sync_debug_mode("error")

    try:
        m.decode(inp, forced=torch.full((2, 960), 100, device=m.device), on_logits=start)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    at.update(launch_counts())
    torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
    print(f"one decode step at 960 rows: {len(kernels)} device kernels, launch counts {at}")
    assert {n: at[n] for n in FUSED} == {"rmsnorm": 1, "add_rmsnorm": 56, "qkv_rope_cache": 28, "silu_mul": 28}
    assert at["w8_matmul_stacked"] == 4 * 28 and at["decode_gqa_attention_stacked"] == 28
    assert len(kernels) <= 450


#: the largest logit gap allowed between the 28-layer w8 decode at
#: Qwen2-1.5B widths (bf16 activations and residual stream) and the f32
#: reference on the same int8 weights, teacher forced; the int4 control's
#: gap lies far above it (both read on the card, PERF.md)
QWEN_LOGIT_GAP = 0.5


@pytest.mark.cuda
def test_28_layer_teacher_forced_decode_holds_to_the_f32_reference(qwen15):
    """Four prompts (one shared prefix), 6 teacher-forced steps: every
    position's logits against the benchmark's f32 reference within
    QWEN_LOGIT_GAP; the int4 control lies beyond it."""
    from perfbench.reference import qwen2 as qref

    cfg, m, p = qwen15
    dev = m.device
    texts = ("A man riding a wave on top of a surfboard.", "Two dogs play in the snow.",
             "A plate of food with broccoli.", "A red double decker bus on a street.")
    inp = m.prepare([PARAPHRASE_PROMPT.format(text=t) for t in texts], shared_prefix=PARAPHRASE_PREFIX)
    steps = 6
    forced = torch.as_tensor(np.random.default_rng(0).integers(0, 150000, (steps, 4)), device=dev)
    seen = {}
    m.decode(inp, forced=forced, on_logits=lambda i, lg: seen.__setitem__(i, lg.float().cpu()))
    lengths = inp.lengths.tolist()
    ids = [np.concatenate([inp.prefix.cpu().numpy(), inp.tokens[j].cpu().numpy()])[: lengths[j]].tolist()
           for j in range(4)]
    gap = ctl = 0.0
    ref8, ref4 = qref.Qwen2(cfg["qwen"], p, bits=8), qref.Qwen2(cfg["qwen"], p, bits=4)
    for j in range(4):
        seq, n = ids[j] + forced[: steps - 1, j].tolist(), lengths[j]
        want = ref8.logits(seq)[n - 1 : n - 1 + steps].cpu()
        low = ref4.logits(seq)[n - 1 : n - 1 + steps].cpu()
        got = torch.stack([seen[i][j] for i in range(steps)])
        gap = max(gap, float((got - want).abs().max()))
        ctl = max(ctl, float((low - want).abs().max()))
    print(f"Qwen2-1.5B widths, 28 layers: program gap {gap:.4f}, int4 control gap {ctl:.4f}, limit {QWEN_LOGIT_GAP}")
    assert gap <= QWEN_LOGIT_GAP < ctl
