"""Kimi-Linear's kernels and decode on the card: the three KDA kernels
(``kda_kernel``) against their plain versions at the cell's shapes (480
decode rows, a prefill of 96 rows with real lengths, the prefix at batch
1; 32 heads of 128, a 128 x 128 f32 state); ``moe_route`` at 256 experts
with sigmoid scoring, the correction bias and renormalisation (ties
included) against plain torch, and DeepSeek-V2's 64-expert softmax route
still bit-equal to its plain version; ``mla_decode_attention`` at 32 heads
against plain torch, and each head of it bit-equal to the 16-head kernel's;
one decode step with no host synchronisation; and four prompts' prefill
and teacher-forced decode through all 27 layers of Kimi-Linear-48B-A3B
against the plain reference (``reference_kimi_linear.py``), whose int4
control the tolerance refuses.

Marked ``cuda``: each test skips without a GPU. On the card:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kimi_cuda.py
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tvc_torch.core.kernels import dsv2_fused_kernel as dk
from tvc_torch.core.kernels import kda_kernel as kk
from tvc_torch.core.kernels import launch_counts, mla_decode_attention, mla_decode_reference
from tvc_torch.models import kimi_linear as kl
from tvc_torch.models.decoding import PARAPHRASE_PREFIX, PARAPHRASE_PROMPT

sys.path.insert(0, str(Path(__file__).resolve().parent))
import reference_kimi_linear as ref  # noqa: E402

from perfbench.drivers.pipeline_stream_kimi import decode_routes  # noqa: E402

pytestmark = pytest.mark.cuda

#: the published widths' largest logit gap allowed between the w8 decode
#: (bf16 activations, 27 layers, the f32 KDA state, the absorbed latent
#: attention, the grouped GEMM) and the f32 reference on the same int8
#: weights, routed alike: bf16 rounding of the residual stream and of every
#: GEMM's and the convolution's output compounds over 27 layers (read on
#: the card: 0.287); the int4 control reads 6.21 (PERF.md)
LOGIT_GAP = 1.0
#: how far below the reference's 8th choice value (sigmoid + correction
#: bias) the weakest expert the program chose may lie: the program's bf16
#: residual stream moves near-ties by its drift (read on the card: 0.031
#: here, 0.036-0.051 in the cell's checks); a wrong route lies far below
#: (the int4 control: 0.80-0.88)
ROUTE_GAP = 0.2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _kda_operands(dev, B, T, nh=32, d=128, K=4, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    HD = nh * d
    y = (torch.randn((B, T, 3 * HD + 2 * d + nh), generator=g, device=dev)).to(torch.bfloat16)
    f = (torch.randn((B, T, 2 * HD), generator=g, device=dev) - 3.0).to(torch.bfloat16)
    conv_w = torch.randn((3 * HD, K), generator=g, device=dev) * 0.5
    a_log = torch.log(1 + 15 * torch.rand(nh, generator=g, device=dev))
    dt_bias = torch.randn(HD, generator=g, device=dev) * 0.5
    window = torch.randn((B, K - 1, 3 * HD), generator=g, device=dev).to(torch.bfloat16)
    state = torch.randn((B, nh, d, d), generator=g, device=dev) * 0.05
    return y, f, conv_w, a_log, dt_bias, window, state


#: the cell's shapes: a decode step (480 rows, one token), the suffix
#: prefill (96 rows of up to 24 tokens, real lengths 1..24), the shared
#: prefix (one row of 14)
SHAPES = {"decode": (480, 1, False), "prefill": (96, 24, True), "prefix": (1, 14, False)}


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPES)
def test_kda_prepare_and_recurrent_match_plain(dev, shape):
    """The preparation: the window and beta bit-equal (copies, one sigmoid
    each), q, k, v, g within f32 rounding (the L2 norms sum in another
    order: ~1e-7 relative; v rounded to bf16 on both sides). The
    recurrence on the same operands: the state within 2e-5 of values of
    scale ~1 (each of the two products over d_k = 128 summed in another
    order, ~1e-7 a token, over at most 24 tokens; read on the card:
    2.4e-7); o, rounded to bf16, within one bf16 step (2^-7 of the value
    where its mantissa is near 1: an f32 difference of 1e-8 before the
    rounding, 4.5e-8 read on the card, can tip it). Pads past a row's
    length write zeros and leave its state alone."""
    B, T, ragged = SHAPES[shape]
    nh, b_col = 32, 3 * 4096 + 256
    y, f, conv_w, a_log, dt_bias, window, state = _kda_operands(dev, B, T)
    lengths = torch.randint(1, T + 1, (B,), generator=torch.Generator(device=dev).manual_seed(1),
                            device=dev) if ragged else None
    w_k, w_p = window.clone(), window.clone()
    before = kk.kda_prepare.launches
    got = kk.kda_prepare(y, f, conv_w, a_log, dt_bias, w_k, lengths, nh, b_col)
    assert kk.kda_prepare.launches == before + 1
    want = kk.kda_prepare_reference(y, f, conv_w, a_log, dt_bias, w_p, lengths, nh, b_col)
    assert torch.equal(w_k, w_p) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=2e-6, atol=1e-6)
    qkvg, beta = want
    s_k, s_p = state.clone(), state.clone()
    o_k = kk.kda_recurrent(qkvg, beta, s_k, lengths, torch.bfloat16)
    o_p = kk.kda_recurrent_reference(qkvg, beta, s_p, lengths, torch.bfloat16)
    torch.testing.assert_close(o_k.float(), o_p.float(), rtol=2 ** -7, atol=1e-6)
    torch.testing.assert_close(s_k, s_p, rtol=0, atol=2e-5)
    if lengths is not None:
        pad = torch.arange(T, device=dev)[None] >= lengths[:, None]
        assert not o_k[pad].any()
    assert float(o_p.float().abs().max()) > 0.05  # outputs of scale ~0.1: the tolerances are far below them


@pytest.mark.parametrize("rows", [480 * 1, 96 * 24])
def test_kda_gated_norm_matches_plain(dev, rows):
    """f32 statistics and products, one rounding to bf16: within one bf16
    step (2^-7 of the value at worst; the sum of squares in another order
    moves an output by ~1e-7 relative, which can tip a rounding)."""
    g = torch.Generator(device=dev).manual_seed(3)
    o = torch.randn((rows, 1, 32, 128), generator=g, device=dev).to(torch.bfloat16)
    fg = torch.randn((rows, 1, 8192), generator=g, device=dev).to(torch.bfloat16)
    w = 1 + 0.1 * torch.randn(128, generator=g, device=dev)
    got = kk.kda_gated_norm(o, fg[..., 4096:], w, 1e-5)
    want = kk.kda_gated_norm_reference(o, fg[..., 4096:], w, 1e-5)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7, atol=1e-6)


def _logits_256(dev):
    g = torch.Generator(device=dev).manual_seed(4)
    E = 256
    base = torch.randn((64, E), generator=g, device=dev)
    rows = [base[i] for i in range(40)]
    for a, b in ((3, 40), (255, 0), (5, 6)):
        r = base[40 + a % 8].clone()
        r[[a, b]] = r.max() + 1
        rows.append(r)
    r = base[50].clone()
    top = torch.topk(r, 10).indices
    r[top[7:]] = r[top[7]].clone()
    rows += [r, torch.zeros(E, device=dev), torch.arange(E, device=dev).float().remainder(4),
             torch.arange(E, device=dev).float().div(2).floor()]
    return torch.stack(rows).contiguous()


@pytest.mark.parametrize("N", [480, 2304, 5])
def test_moe_route_at_256_experts_with_sigmoid_scoring_bit_equal(dev, N):
    """Kimi-Linear's routing: sigmoid, the correction bias in the choice,
    top 8, the unbiased weights renormalised: weights, ids (torch.topk's
    order, ties too), positions, sorted rows and offsets identical to the
    plain version's, the counter row incremented identically."""
    E, k, H = 256, 8, 2304
    g = torch.Generator(device=dev).manual_seed(5)
    logits = torch.randn((N, E), generator=g, device=dev) * 2
    if N == 480:
        logits[: 47] = _logits_256(dev)
    bias = torch.randn(E, generator=g, device=dev) * 0.1
    x = (torch.randn((N, H), generator=g, device=dev)).to(torch.bfloat16)
    c_k = torch.arange(E, dtype=torch.int32, device=dev) % 5
    c_p = c_k.clone()
    got = dk.moe_route(logits, x, k, c_k, "sigmoid", bias, True)
    want = dk.moe_route_reference(logits, x, k, c_p, "sigmoid", bias, True)
    assert torch.equal(got[1].long(), want[1]), "ids"
    assert torch.equal(got[0], want[0]), "weights"
    assert all(torch.equal(a, b.to(a.dtype)) for a, b in zip(got, want)) and torch.equal(c_k, c_p)
    assert torch.equal(dk.moe_route(logits, x, k, None, "sigmoid", bias, True)[0], got[0])


@pytest.mark.parametrize("E,k", [(64, 6), (256, 8)])
def test_softmax_route_bit_equal(dev, E, k):
    """DeepSeek-V2's softmax route (64 experts) as before, and the softmax
    at 256 experts, bit-equal to the plain version."""
    g = torch.Generator(device=dev).manual_seed(6)
    logits = torch.randn((960, E), generator=g, device=dev)
    x = torch.randn((960, 2048), generator=g, device=dev).to(torch.bfloat16)
    got, want = dk.moe_route(logits, x, k), dk.moe_route_reference(logits, x, k)
    assert all(torch.equal(a, b.to(a.dtype)) for a, b in zip(got, want))


@pytest.mark.parametrize("B,S", [(480, 64), (7, 97)])
def test_latent_attention_at_32_heads(dev, B, S):
    """32 heads against the f32 plain version (the weights and output
    rounded to bf16: within 1e-2 on unit-scale latents), and each group of
    16 heads bit-equal to the 16-head kernel on those heads."""
    g = torch.Generator(device=dev).manual_seed(7)
    bf = torch.bfloat16
    q_lat = torch.randn((B, 32, 512), generator=g, device=dev).to(bf)
    q_pe = torch.randn((B, 32, 64), generator=g, device=dev).to(bf)
    cache = torch.randn((2, B, S, 576), generator=g, device=dev).to(bf)
    valid = torch.randint(1, S + 1, (B,), generator=g, device=dev)
    mask = torch.zeros((B, S), device=dev).masked_fill(torch.arange(S, device=dev)[None] >= valid[:, None],
                                                       float("-inf"))
    scale = kl.KimiLinearConfig().softmax_scale
    got = mla_decode_attention(q_lat, q_pe, cache, mask, 1, scale)
    want = mla_decode_reference(q_lat, q_pe, cache, mask, 1, scale)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1e-2)
    for h in (0, 16):
        half = mla_decode_attention(q_lat[:, h : h + 16], q_pe[:, h : h + 16].contiguous(), cache, mask, 1, scale)
        assert torch.equal(half, got[:, h : h + 16])


# -- the model at its published widths --------------------------------------------------


def _part(cfg, name, dev):
    """A part's seeded weights, bf16 matrices (the configuration's cast
    before the int8 quantization), from (seed, part)."""
    g = torch.Generator(device=dev).manual_seed(2000 + kl.KimiLinearModel.part_names(cfg).index(name))
    out = kl.draw_part(cfg, name, g, dev)
    return {n: t.to(torch.bfloat16) if t.ndim >= 2 else t for n, t in out.items()}


@pytest.fixture(scope="module")
def kimi():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    cfg = kl.KimiLinearConfig.kimi_linear_48b()
    model = kl.KimiLinearModel(cfg, params=lambda p: _part(cfg, p, dev), max_new_tokens=8, device=dev)
    return cfg, model, dev


def test_one_decode_step_syncs_nothing_and_launches_the_kernels_once_a_layer(kimi):
    cfg, m, dev = kimi
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
    nk, nm, n_moe = len(cfg.kda_layers), len(cfg.mla_layers), cfg.n_moe_layers
    assert {n: got[n] for n in ("kda_prepare", "kda_recurrent", "kda_gated_norm")} == dict.fromkeys(
        ("kda_prepare", "kda_recurrent", "kda_gated_norm"), nk)
    assert got["mla_decode_attention"] == nm and got["mla_rope_cache"] == nm and got["mla_out"] == nm
    assert got["moe_route"] == n_moe and got["moe_combine"] == n_moe and got["moe_w8_grouped_gemm"] == 2 * n_moe
    print(f"one Kimi-Linear decode step: launch counts {got}")


def _cfg_dict(c):
    return {
        "vocab_size": c.vocab_size, "hidden_size": c.hidden_size, "intermediate_size": c.intermediate_size,
        "moe_intermediate_size": c.moe_intermediate_size, "num_hidden_layers": c.num_layers,
        "first_k_dense_replace": c.first_k_dense, "num_attention_heads": c.num_heads, "kv_lora_rank": c.kv_lora_rank,
        "qk_nope_head_dim": c.qk_nope_head_dim, "qk_rope_head_dim": c.qk_rope_head_dim, "v_head_dim": c.v_head_dim,
        "num_experts": c.n_routed_experts, "num_shared_experts": c.n_shared_experts,
        "num_experts_per_token": c.num_experts_per_tok, "routed_scaling_factor": c.routed_scaling_factor,
        "moe_renormalize": c.norm_topk_prob, "rms_norm_eps": c.rms_eps,
        "linear_attn_config": {"kda_layers": [i + 1 for i in c.kda_layers], "num_heads": c.kda_heads,
                               "head_dim": c.kda_head_dim, "short_conv_kernel_size": c.conv_size},
    }


def test_published_widths_prefill_and_decode_match_the_reference(kimi):
    """Four prompts (one shared prefix, right-padded to the longest), 6
    teacher-forced steps: every position's logits against the f32
    reference's full forward over the same int8 weights within LOGIT_GAP,
    the reference routing each token through the experts the program
    chose, which lie within ROUTE_GAP of its own choice; the int4 control
    (routing as it chooses) lies beyond both. With seeded routers the
    8th and 9th choices of 256 often lie within the bf16 stream's drift, and
    a swapped expert carries ~0.3 of the routed output: routed as the
    reference chooses, such a swap alone moves a logit by O(1)."""
    cfg, m, dev = kimi
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
    seqs = [ids[j] + forced[: steps - 1, j].tolist() for j in range(4)]
    routes = decode_routes(m, list(texts), 1, forced.T, list(range(4)))
    rcfg = _cfg_dict(cfg)
    part = lambda name: _part(cfg, name, dev)  # noqa: E731
    low_model = ref.KimiLinear(rcfg, part, bits=4, device=dev)
    low = [w.cpu() for w in low_model.logits(seqs)]
    low_routes = [{li: r[j][0] for li, r in low_model.routes.items()} for j in range(4)]
    ref8 = ref.KimiLinear(rcfg, part, bits=8, device=dev)
    want = [w.cpu() for w in ref8.logits(seqs, routes)]
    ref8_low = ref.KimiLinear(rcfg, part, bits=8, device=dev)
    want_low = [w.cpu() for w in ref8_low.logits(seqs, low_routes)]
    gap = ctl = 0.0
    for j in range(4):
        n = lengths[j]
        got = torch.stack([seen[i][j] for i in range(steps)])
        gap = max(gap, float((got - want[j][n - 1 : n - 1 + steps]).abs().max()))
        ctl = max(ctl, float((low[j][n - 1 : n - 1 + steps] - want_low[j][n - 1 : n - 1 + steps]).abs().max()))
    print(f"published widths: program gap {gap:.4f} route gap {ref8.route_gap:.4f}; int4 control gap {ctl:.4f} "
          f"route gap {ref8_low.route_gap:.4f}; limits {LOGIT_GAP} {ROUTE_GAP}")
    assert gap <= LOGIT_GAP < ctl and ref8.route_gap <= ROUTE_GAP < ref8_low.route_gap
    assert math.isfinite(gap)
