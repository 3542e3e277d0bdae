"""DeepSeek-V2's kernels and decode on the card: the grouped w8 expert GEMM
and the latent decode attention against their plain versions at the
published widths with uneven offsets, one decode step under
``torch.cuda.set_sync_debug_mode("error")`` with its launches counted, and
four prompts' prefill and teacher-forced decode through all 27 layers of
DeepSeek-V2-Lite against the plain reference (``reference_deepseek_v2.py``),
whose int4 control the tolerance refuses.

Marked ``cuda``: each test skips without a GPU. On the card:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_dsv2_cuda.py
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tvc_torch.core.kernels import (
    launch_counts,
    mla_decode_attention,
    mla_decode_reference,
    moe_w8_grouped_gemm,
    moe_w8_grouped_reference,
)
from tvc_torch.models import deepseek_v2 as ds
from tvc_torch.models.decoding import PARAPHRASE_PREFIX, PARAPHRASE_PROMPT

sys.path.insert(0, str(Path(__file__).resolve().parent))
import reference_deepseek_v2 as ref  # noqa: E402

pytestmark = pytest.mark.cuda

#: the published widths' largest logit gap allowed between the w8 decode
#: (bf16 activations, 27 layers, the absorbed MLA, the grouped GEMM) and
#: the f32 reference on the same int8 weights: bf16 rounding of the
#: residual stream and of every GEMM's output compounds over 27 layers;
#: the int4 control's gap is far above it (both read on the card, PERF.md)
LOGIT_GAP = 0.35


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _offsets(counts, dev):
    return torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32, device=dev)


@pytest.mark.parametrize("K,N", [(2048, 2816), (1408, 2048)], ids=["gate_up", "down"])
def test_grouped_gemm_matches_plain_at_published_widths(dev, K, N):
    """5,760 rows over 64 experts, unevenly (empty experts, one with 1,000
    rows, tails of every length), against the per-expert plain version.
    Both sum in f32 in other orders and round to bf16 once: one bf16 step
    (2^-8 of the value) apart, or, where the sum nearly cancels, the f32
    sums' own reordering error (~K 2^-24 sum|x w s|, ~1e-5 here)."""
    rng = np.random.default_rng(0)
    counts = rng.multinomial(4760, rng.dirichlet(np.full(64, 0.5)))
    counts[[3, 17]] = 0
    counts[40] += 1000
    M = int(counts.sum())
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randint(-127, 128, (64, K, N), generator=g, device=dev, dtype=torch.int8)
    s = torch.rand((64, N), generator=g, device=dev) * 1e-3
    off = _offsets(counts, dev)
    before = moe_w8_grouped_gemm.launches
    got = moe_w8_grouped_gemm(x, w, s, off)
    assert moe_w8_grouped_gemm.launches == before + 1
    want = moe_w8_grouped_reference(x, w, s, off)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7, atol=3e-5)
    assert torch.equal(got, moe_w8_grouped_gemm(x, w, s, off))  # a fixed order: the same bits


@pytest.mark.parametrize("B,S", [(960, 64), (7, 97), (3, 1)])
def test_latent_attention_matches_plain(dev, B, S):
    """Rows of every length masked at the tail. The kernel rounds each
    tile's softmax weights to bf16 (2^-9 of each) and its output to bf16
    (2^-9): within 1e-2 of the f32 plain version on unit-scale latents."""
    g = torch.Generator(device=dev).manual_seed(2)
    bf = torch.bfloat16
    q_lat = torch.randn((B, 16, 512), generator=g, device=dev).to(bf)
    q_pe = torch.randn((B, 16, 64), generator=g, device=dev).to(bf)
    cache = torch.randn((2, B, S, 576), generator=g, device=dev).to(bf)
    valid = torch.randint(1, S + 1, (B,), generator=g, device=dev)
    mask = torch.zeros((B, S), device=dev).masked_fill(torch.arange(S, device=dev)[None] >= valid[:, None],
                                                       float("-inf"))
    scale = ds.DeepseekV2Config().softmax_scale
    got = mla_decode_attention(q_lat, q_pe, cache, mask, 1, scale)
    want = mla_decode_reference(q_lat, q_pe, cache, mask, 1, scale)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1e-2)


def _cfg_dict():
    c = ds.DeepseekV2Config.deepseek_v2_lite()
    return {
        "vocab_size": c.vocab_size, "hidden_size": c.hidden_size, "intermediate_size": c.intermediate_size,
        "moe_intermediate_size": c.moe_intermediate_size, "num_hidden_layers": c.num_layers,
        "first_k_dense_replace": c.first_k_dense, "num_attention_heads": c.num_heads, "kv_lora_rank": c.kv_lora_rank,
        "qk_nope_head_dim": c.qk_nope_head_dim, "qk_rope_head_dim": c.qk_rope_head_dim, "v_head_dim": c.v_head_dim,
        "n_routed_experts": c.n_routed_experts, "n_shared_experts": c.n_shared_experts,
        "num_experts_per_tok": c.num_experts_per_tok, "routed_scaling_factor": c.routed_scaling_factor,
        "rope_theta": c.rope_theta, "rms_norm_eps": c.rms_eps,
        "rope_scaling": {"factor": c.rope_factor, "original_max_position_embeddings": c.rope_original_max_positions,
                         "beta_fast": c.rope_beta_fast, "beta_slow": c.rope_beta_slow, "mscale": c.rope_mscale,
                         "mscale_all_dim": c.rope_mscale_all_dim},
    }


def _part(cfg, name, dev):
    """A part's seeded weights, bf16 matrices (the configuration's cast
    before the int8 quantization), from (seed, part)."""
    g = torch.Generator(device=dev).manual_seed(1000 + ds.part_names(cfg).index(name))
    out = {}
    for n, shape, kind, std in ds.part_shapes(cfg, name):
        t = torch.randn(shape, generator=g, device=dev) * std
        out[n] = t.to(torch.bfloat16) if len(shape) >= 2 else (t + 1.0 if kind == "ln" else t)
    return out


@pytest.fixture(scope="module")
def lite():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    cfg = ds.DeepseekV2Config.deepseek_v2_lite()
    model = ds.DeepseekV2Model(cfg, params=lambda p: _part(cfg, p, dev), max_new_tokens=8, device=dev)
    return cfg, model, dev


def test_one_decode_step_syncs_nothing_and_launches_the_kernels_once_a_layer(lite):
    cfg, m, dev = lite
    inp = m.prepare([PARAPHRASE_PROMPT.format(text=t) for t in ("A man riding a wave.", "Two dogs play.")],
                    n_samples=3, shared_prefix=PARAPHRASE_PREFIX)
    at_step = {}

    def start(i, lg):  # the step's span is open: from here on, no host synchronisation
        if i == 1:
            at_step.update(launch_counts())
            torch.cuda.set_sync_debug_mode("error")

    try:
        m.decode(inp, forced=torch.full((2, 6), 100, device=dev), on_logits=start)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = launch_counts()
    assert got["moe_w8_grouped_gemm"] - at_step["moe_w8_grouped_gemm"] == 2 * cfg.n_moe_layers
    assert got["mla_decode_attention"] - at_step["mla_decode_attention"] == cfg.num_layers
    fused = {k: got[k] - at_step[k] for k in ("rmsnorm", "add_rmsnorm", "silu_mul")}
    assert fused == {"rmsnorm": 1 + cfg.num_layers, "add_rmsnorm": 2 * cfg.num_layers,
                     "silu_mul": cfg.first_k_dense + 2 * cfg.n_moe_layers}


def test_published_widths_prefill_and_decode_match_the_reference(lite):
    """Four prompts (one shared prefix), 6 teacher-forced steps: every
    position's logits against the f32 reference's full forward over the
    same int8 weights within LOGIT_GAP; the int4 control lies beyond it."""
    cfg, m, dev = lite
    texts = ("A man riding a wave on top of a surfboard.", "Two dogs play in the snow.",
             "A plate of food with broccoli.", "A red double decker bus on a street.")
    inp = m.prepare([PARAPHRASE_PROMPT.format(text=t) for t in texts], shared_prefix=PARAPHRASE_PREFIX)
    steps = 6
    forced = torch.as_tensor(np.random.default_rng(0).integers(0, 100000, (steps, 4)), device=dev)
    seen = {}
    m.decode(inp, forced=forced, on_logits=lambda i, lg: seen.__setitem__(i, lg.float().cpu()))
    lengths = inp.lengths.tolist()
    ids = [np.concatenate([inp.prefix.cpu().numpy(), inp.tokens[j].cpu().numpy()])[: lengths[j]].tolist()
           for j in range(4)]
    seqs = [ids[j] + forced[: steps - 1, j].tolist() for j in range(4)]
    rcfg = _cfg_dict()
    part = lambda name: _part(cfg, name, dev)  # noqa: E731
    want = [w.cpu() for w in ref.DeepseekV2(rcfg, part, bits=8, device=dev).logits(seqs)]
    low = [w.cpu() for w in ref.DeepseekV2(rcfg, part, bits=4, device=dev).logits(seqs)]
    gap = ctl = 0.0
    for j in range(4):
        n = lengths[j]
        got = torch.stack([seen[i][j] for i in range(steps)])
        gap = max(gap, float((got - want[j][n - 1 : n - 1 + steps]).abs().max()))
        ctl = max(ctl, float((low[j][n - 1 : n - 1 + steps] - want[j][n - 1 : n - 1 + steps]).abs().max()))
    print(f"published widths: program gap {gap:.4f}, int4 control gap {ctl:.4f}, limit {LOGIT_GAP}")
    assert gap <= LOGIT_GAP < ctl
    assert math.isfinite(gap)
