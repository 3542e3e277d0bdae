"""Nemotron-H's kernels and decode on the card: the three SSM kernels
(``ssm_kernel``) against their plain versions at the cell's shapes (640
decode rows, a prefill of 128 rows with real lengths, the prefix at batch
1; 64 heads of 64, a 64 x 128 f32 state, 8 groups); ``relu2`` and the
no-rotary cache write (``qkv_cache``) bit-equal to theirs; the grouped
expert GEMM at the up (N 1,856: the kernel's N tail) and down (K 1,856)
shapes; ``moe_route`` at 128 experts top 6 by sigmoid, bit-equal; the
decode attention at 16 query heads a KV head; one decode step with no host
synchronisation; and four prompts' prefill and teacher-forced decode
through one period of the published blocks (``MEMEM*E`` at the published
widths) against the plain reference (``reference_nemotron_h.py``), whose
int4 control the tolerance refuses.

Marked ``cuda``: each test skips without a GPU. On the card:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_nemotron_cuda.py
"""

import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tvc_torch.core.kernels import decode_fused_kernel as fk
from tvc_torch.core.kernels import dsv2_fused_kernel as dk
from tvc_torch.core.kernels import launch_counts, moe_w8_grouped_gemm, moe_w8_grouped_reference
from tvc_torch.core.kernels import ssm_kernel as sk
from tvc_torch.core.kernels.decode_attention_kernel import decode_gqa_attention, decode_gqa_reference
from tvc_torch.models import nemotron_h as nh
from tvc_torch.models.decoding import PARAPHRASE_PREFIX, PARAPHRASE_PROMPT

sys.path.insert(0, str(Path(__file__).resolve().parent))
import reference_nemotron_h as ref  # noqa: E402

from chip_smoke import moe_spread  # noqa: E402
from perfbench.drivers.pipeline_stream_kimi import decode_routes  # noqa: E402

pytestmark = pytest.mark.cuda

#: one period of the published blocks' largest logit gap allowed between
#: the w8 decode (bf16 activations, 7 blocks, the f32 SSM state, the grouped
#: GEMM) and the f32 reference on the same int8 weights, routed alike: bf16
#: rounding of the residual stream and of every GEMM's and the
#: convolution's output (read on the card: 0.073); the int4 control reads
#: 3.26 (PERF.md)
LOGIT_GAP = 0.5
#: how far below the reference's 6th choice value (sigmoid + correction
#: bias) the weakest expert the program chose may lie: the bf16 stream's
#: drift moves near-ties (read on the card: 0.0058 here, 0.020-0.025 in the
#: cell's checks over 32 sequences); a wrong route lies far below (the int4
#: control: 0.33 here, 0.71-0.78 in the cell)
ROUTE_GAP = 0.05


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _ssm_operands(dev, B, T, nh_=64, P=64, N=128, G=8, K=4, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    I = nh_ * P
    C = I + 2 * G * N
    y = torch.randn((B, T, I + C + nh_), generator=g, device=dev)
    y[..., I + C :] -= 2.0
    y = y.to(torch.bfloat16)
    conv_w = torch.randn((C, K), generator=g, device=dev) * 0.5
    conv_b = torch.randn(C, generator=g, device=dev) * 0.1
    a_log = torch.log(1 + 15 * torch.rand(nh_, generator=g, device=dev))
    dt_bias = torch.randn(nh_, generator=g, device=dev) * 0.5
    d = 1 + 0.1 * torch.randn(nh_, generator=g, device=dev)
    window = torch.randn((B, K - 1, C), generator=g, device=dev).to(torch.bfloat16)
    state = torch.randn((B, nh_, P, N), generator=g, device=dev) * 0.1
    return y, conv_w, conv_b, a_log, dt_bias, d, window, state, I, C


#: the cell's shapes: a decode step (640 rows, one token), the suffix
#: prefill (128 rows of up to 24 tokens, real lengths 1..24), the shared
#: prefix (one row of 14)
SHAPES = {"decode": (640, 1, False), "prefill": (128, 24, True), "prefix": (1, 14, False)}


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPES)
def test_ssm_prepare_and_recurrent_match_plain(dev, shape):
    """The preparation: the window bit-equal (copies), the steps within f32
    rounding (the same softplus), x | B | C within one bf16 step (SiLU of
    the same f32 sum, its exp may differ in the last bit and tip the
    rounding). The recurrence on the plain version's operands: the state
    within 1e-5 of values of scale ~0.3 (the same elementwise products; exp
    may differ in its last bit, ~1e-7 a token over at most 24 tokens); y,
    rounded to bf16, within one bf16 step (the sum over N = 128 in another
    order). Pads past a row's length write zeros and leave its state
    alone."""
    B, T, ragged = SHAPES[shape]
    y, conv_w, conv_b, a_log, dt_bias, d, window, state, I, C = _ssm_operands(dev, B, T)
    lengths = torch.randint(1, T + 1, (B,), generator=torch.Generator(device=dev).manual_seed(1),
                            device=dev) if ragged else None
    w_k, w_p = window.clone(), window.clone()
    before = sk.ssm_prepare.launches
    xbc, dt = sk.ssm_prepare(y, conv_w, conv_b, dt_bias, w_k, lengths, I, I + C)
    assert sk.ssm_prepare.launches == before + 1
    xbc_p, dt_p = sk.ssm_prepare_reference(y, conv_w, conv_b, dt_bias, w_p, lengths, I, I + C)
    assert torch.equal(w_k, w_p)
    torch.testing.assert_close(dt, dt_p, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(xbc.float(), xbc_p.float(), rtol=2 ** -7, atol=1e-6)
    s_k, s_p = state.clone(), state.clone()
    o_k = sk.ssm_recurrent(xbc_p, dt_p, a_log, d, s_k, lengths, 8, torch.bfloat16)
    o_p = sk.ssm_recurrent_reference(xbc_p, dt_p, a_log, d, s_p, lengths, 8, torch.bfloat16)
    torch.testing.assert_close(o_k.float(), o_p.float(), rtol=2 ** -7, atol=1e-5)
    torch.testing.assert_close(s_k, s_p, rtol=0, atol=1e-5)
    if lengths is not None:
        pad = torch.arange(T, device=dev)[None] >= lengths[:, None]
        assert not o_k[pad].any() and not xbc[pad].any()
    assert float(o_p.float().abs().max()) > 0.5 and float(s_p.abs().max()) > 0.1


@pytest.mark.parametrize("rows", [640, 128 * 24])
def test_ssm_gated_norm_matches_plain(dev, rows):
    """f32 statistics and products, one rounding to bf16: within one bf16
    step (the sum of squares over a group of 512 in another order moves an
    output by ~1e-7 relative, which can tip a rounding)."""
    g = torch.Generator(device=dev).manual_seed(3)
    y = torch.randn((rows, 1, 4096), generator=g, device=dev).to(torch.bfloat16)
    proj = torch.randn((rows, 1, 10304), generator=g, device=dev).to(torch.bfloat16)
    w = 1 + 0.1 * torch.randn(4096, generator=g, device=dev)
    got = sk.ssm_gated_norm(y, proj, w, 8, 1e-5)
    want = sk.ssm_gated_norm_reference(y, proj, w, 8, 1e-5)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("shape", [(3840, 1856), (640, 3712), (7, 13)], ids=["routed", "shared", "odd"])
def test_relu2_bit_equal(dev, shape):
    g = torch.Generator(device=dev).manual_seed(4)
    u = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    before = fk.relu2.launches
    assert torch.equal(fk.relu2(u), fk.relu2_reference(u)) and fk.relu2.launches == before + 1
    u32 = u.float()
    assert torch.equal(fk.relu2(u32), fk.relu2_reference(u32))


@pytest.mark.parametrize("B", [640, 3])
def test_no_rotary_cache_write_bit_equal(dev, B):
    g = torch.Generator(device=dev).manual_seed(5)
    L, kv, R, D, S = 6, 2, 16, 128, 40
    qkv = torch.randn((B, 1, (kv * R + 2 * kv) * D), generator=g, device=dev).to(torch.bfloat16)
    ck, cv = (torch.randn((L, B, kv, S, D), generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
    ck2, cv2 = ck.clone(), cv.clone()
    q = fk.qkv_cache(qkv, ck, cv, 4, 17)
    q2 = fk.qkv_cache_reference(qkv, ck2, cv2, 4, 17)
    assert torch.equal(q, q2) and torch.equal(ck, ck2) and torch.equal(cv, cv2)


@pytest.mark.parametrize("case,K,N", [("nemotron_decode", 2688, 1856), ("nemotron_decode", 1856, 2688),
                                      ("nemotron_prefill", 2688, 1856), ("nemotron_prefill", 1856, 2688),
                                      ("nemotron_prefix", 2688, 1856)],
                         ids=["up", "down", "prefill-up", "prefill-down", "prefix-up"])
def test_grouped_gemm_at_the_non_gated_shapes(dev, case, K, N):
    """The up GEMM's N 1,856 ends in a column tile of 64 channels (the
    kernel's N tail) and the down GEMM's K 1,856 is 29 k-tiles: against the
    per-expert plain version, one bf16 step apart (or the f32 sums'
    reordering error where a sum nearly cancels), two calls the same bits."""
    counts = moe_spread(case)
    E, M = len(counts), int(counts.sum())
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randint(-127, 128, (E, K, N), generator=g, device=dev, dtype=torch.int8)
    s = torch.rand((E, N), generator=g, device=dev) * 1e-3
    off = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32, device=dev)
    got = moe_w8_grouped_gemm(x, w, s, off)
    want = moe_w8_grouped_reference(x, w, s, off)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7, atol=3e-5)
    assert torch.equal(got, moe_w8_grouped_gemm(x, w, s, off))
    assert got[:, -64:].abs().max() > 0  # the tail's channels were written


@pytest.mark.parametrize("N", [640, 3072])
def test_sigmoid_route_at_128_experts_bit_equal(dev, N):
    g = torch.Generator(device=dev).manual_seed(7)
    lg, x, bias = 2 * torch.randn((N, 128), generator=g, device=dev), \
        torch.randn((N, 2688), generator=g, device=dev).to(torch.bfloat16), 0.1 * torch.randn(128, generator=g,
                                                                                             device=dev)
    lg[3, [5, 9, 70]] = lg[3].max() + 1  # a tie inside the top k
    got = dk.moe_route(lg, x, 6, None, "sigmoid", bias, True)
    want = dk.moe_route_reference(lg, x, 6, None, "sigmoid", bias, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("B,S", [(640, 64), (5, 97)])
def test_decode_attention_at_16_query_heads_a_kv_head(dev, B, S):
    g = torch.Generator(device=dev).manual_seed(8)
    q = torch.randn((B, 2, 16, 128), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((B, 2, S, 128), generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
    mask = torch.zeros((B, S), device=dev)
    mask[:, S - 9 : S - 3] = float("-inf")
    got = decode_gqa_attention(q, k, v, mask)
    torch.testing.assert_close(got.float(), decode_gqa_reference(q, k, v, mask).float(), atol=1e-2, rtol=1e-2)


# -- the model at its published widths --------------------------------------------------


def _part(cfg, name, dev):
    """A part's seeded weights, bf16 matrices (the configuration's cast
    before the int8 quantization), from (seed, part)."""
    g = torch.Generator(device=dev).manual_seed(3000 + nh.NemotronHModel.part_names(cfg).index(name))
    out = nh.draw_part(cfg, name, g, dev)
    return {n: t.to(torch.bfloat16) if t.ndim >= 2 else t for n, t in out.items()}


@pytest.fixture(scope="module")
def period():
    """One period of the published blocks at the published widths."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(nh.NemotronHConfig.nemotron3_nano_30b(), num_layers=7, pattern="MEMEM*E")
    model = nh.NemotronHModel(cfg, params=lambda p: _part(cfg, p, dev), max_new_tokens=8, device=dev)
    return cfg, model, dev


def test_one_decode_step_syncs_nothing_and_launches_the_kernels_once_a_block(period):
    cfg, m, dev = period
    inp = m.prepare([PARAPHRASE_PROMPT.format(text=t) for t in ("A man riding a wave.", "Two dogs play.")],
                    n_samples=3, shared_prefix=PARAPHRASE_PREFIX)
    at = {}

    def start(i, lg):
        if i == 1:
            at.update(launch_counts())
            torch.cuda.set_sync_debug_mode("error")

    try:
        m.decode(inp, forced=torch.full((2, 6), 100, device=dev), on_logits=start)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = {k: v - at[k] for k, v in launch_counts().items()}
    ns, na, ne = (len(cfg.blocks(k)) for k in "M*E")
    assert {n: got[n] for n in ("ssm_prepare", "ssm_recurrent", "ssm_gated_norm")} == dict.fromkeys(
        ("ssm_prepare", "ssm_recurrent", "ssm_gated_norm"), ns)
    assert got["qkv_cache"] == na and got["decode_gqa_attention"] == na and got["qkv_rope_cache"] == 0
    assert got["moe_route"] == ne and got["moe_combine"] == ne and got["moe_w8_grouped_gemm"] == 2 * ne
    assert got["relu2"] == 2 * ne and got["silu_mul"] == 0
    print(f"one Nemotron-H decode step over MEMEM*E: launch counts {got}")


def _cfg_dict(c):
    return {
        "vocab_size": c.vocab_size, "hidden_size": c.hidden_size, "hybrid_override_pattern": c.pattern,
        "num_attention_heads": c.num_heads, "num_key_value_heads": c.num_kv_heads, "head_dim": c.head_dim,
        "n_routed_experts": c.n_routed_experts, "num_experts_per_tok": c.num_experts_per_tok,
        "routed_scaling_factor": c.routed_scaling_factor, "norm_topk_prob": c.norm_topk_prob,
        "layer_norm_epsilon": c.rms_eps, "mamba_num_heads": c.mamba_heads, "mamba_head_dim": c.mamba_head_dim,
        "ssm_state_size": c.ssm_state, "n_groups": c.ssm_groups, "conv_kernel": c.conv_size,
    }


def test_published_widths_prefill_and_decode_match_the_reference(period):
    """Four prompts (one shared prefix, right-padded to the longest), 6
    teacher-forced steps through ``MEMEM*E`` at the published widths: every
    position's logits against the f32 reference's full forward over the
    same int8 weights within LOGIT_GAP, the reference routing each token
    through the experts the program chose, which lie within ROUTE_GAP of its
    own choice; the int4 control (routing as it chooses) lies beyond
    both."""
    cfg, m, dev = period
    texts = ("A man riding a wave on top of a surfboard.", "Two dogs play in the snow.",
             "A plate of food with broccoli.", "A red double decker bus on a street.")
    inp = m.prepare([PARAPHRASE_PROMPT.format(text=t) for t in texts], shared_prefix=PARAPHRASE_PREFIX)
    steps = 6
    forced = torch.as_tensor(np.random.default_rng(0).integers(0, 131000, (steps, 4)), device=dev)
    seen = {}
    m.decode(inp, forced=forced, on_logits=lambda i, lg: seen.__setitem__(i, lg.float().cpu()))
    lengths = inp.lengths.tolist()
    ids = [np.concatenate([inp.prefix.cpu().numpy(), inp.tokens[j].cpu().numpy()])[: lengths[j]].tolist()
           for j in range(4)]
    seqs = [ids[j] + forced[: steps - 1, j].tolist() for j in range(4)]
    routes = decode_routes(m, list(texts), 1, forced.T, list(range(4)))
    rcfg = _cfg_dict(cfg)
    part = lambda name: _part(cfg, name, dev)  # noqa: E731
    low_model = ref.NemotronH(rcfg, part, bits=4, device=dev)
    low = [w.cpu() for w in low_model.logits(seqs)]
    low_routes = [{li: r[j][0] for li, r in low_model.routes.items()} for j in range(4)]
    ref8 = ref.NemotronH(rcfg, part, bits=8, device=dev)
    want = [w.cpu() for w in ref8.logits(seqs, routes)]
    ref8_low = ref.NemotronH(rcfg, part, bits=8, device=dev)
    want_low = [w.cpu() for w in ref8_low.logits(seqs, low_routes)]
    gap = ctl = 0.0
    for j in range(4):
        n = lengths[j]
        got = torch.stack([seen[i][j] for i in range(steps)])
        gap = max(gap, float((got - want[j][n - 1 : n - 1 + steps]).abs().max()))
        ctl = max(ctl, float((low[j][n - 1 : n - 1 + steps] - want_low[j][n - 1 : n - 1 + steps]).abs().max()))
    print(f"published widths MEMEM*E: program gap {gap:.4f} route gap {ref8.route_gap:.4f}; int4 control gap "
          f"{ctl:.4f} route gap {ref8_low.route_gap:.4f}; limits {LOGIT_GAP} {ROUTE_GAP}")
    assert gap <= LOGIT_GAP < ctl and ref8.route_gap <= ROUTE_GAP < ref8_low.route_gap
    assert math.isfinite(gap)
