"""tvc_torch's Nemotron-H (``tvc_torch/models/nemotron_h.py``) against the
plain reference ``tests/reference_nemotron_h.py`` on ``NemotronHConfig.tiny()``
(one full period of the block kinds, ``MEM*E``: two Mamba-2 blocks, an
attention block, two MoE blocks of 16 relu2 experts chosen by sigmoid +
bias) in f32 with w8 weights: the prefix-shared prefill and the decode
through the cache, teacher forced, against the reference's full forward;
rows of different real lengths in one right-padded batch; the prefix then
tiled state against each row's own prefill; the selective scan against the
token loop, with a state kept in bf16 as the control; pads that neither
decay nor update a state; ``relu2`` and the no-rotary cache write against
their plain versions; the published configuration; ``process_stream``
with the tiny model as full TVC's paraphraser. On the CPU the kernel
wrappers compute their plain versions and launch nothing."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import tests.reference_nemotron_h as ref
import tvc_torch.models.nemotron_h as nh
from tvc_torch.core.kernels import launch_counts
from tvc_torch.core.kernels.decode_fused_kernel import (
    qkv_cache,
    qkv_cache_reference,
    qkv_rope_cache_reference,
    relu2,
    relu2_reference,
)
from tvc_torch.core.kernels.ssm_kernel import ssm_gated_norm, ssm_prepare, ssm_recurrent
from tvc_torch.models.decoding import PARAPHRASE_PREFIX, PARAPHRASE_PROMPT
from tvc_torch.utils import tracing

ROOT = Path(__file__).resolve().parents[1]
PROMPTS = [PARAPHRASE_PROMPT.format(text=t) for t in ("a dog runs in the park",
                                                      "two cats sleep on a soft mat near the open kitchen window")]
#: the program (f32, w8) against the reference (f32, the same int8 values
#: dequantized): the two sum the same products in other orders (the w8
#: GEMM scales after its sum, the reference before; the scan's einsums; the
#: convolution's taps), ~1e-7 relative a sum, compounded over 5 blocks and
#: a 20-token scan to ~1e-6 of logits of unit scale. A dropped pad check, a
#: wrong tap, a head reading another group's B or a state read at the wrong
#: row moves them by O(1e-1).
ATOL = 2e-5


class WordTok:
    """Word-level tokenizer without BOS / EOS, so a prompt split at a space
    is token-exact and the prefix-shared prefill engages."""

    def __init__(self, vocab_size=512, context_length=48):
        self.vocab_size, self.context_length, self.pad_id, self.eot_id = vocab_size, context_length, 0, vocab_size - 1

    def __call__(self, texts):
        from tvc_torch.models.decoding import _stable_seed

        out = np.full((len(texts), self.context_length), self.pad_id, np.int32)
        for i, t in enumerate(texts):
            ws = "".join(c if c.isalnum() else " " for c in t.lower()).split()
            ids = [1 + (_stable_seed(w) % (self.vocab_size - 3)) for w in ws][: self.context_length]
            out[i, : len(ids)] = ids
        return out

    def decode(self, ids):
        return " ".join(f"w{int(i)}" for i in ids if i not in (self.pad_id, self.eot_id))


def published(c: nh.NemotronHConfig) -> dict:
    """A configuration's numbers under the published ``config.json`` keys."""
    return {
        "vocab_size": c.vocab_size, "hidden_size": c.hidden_size,
        "moe_intermediate_size": c.moe_intermediate_size,
        "moe_shared_expert_intermediate_size": c.shared_intermediate_size, "num_hidden_layers": c.num_layers,
        "hybrid_override_pattern": c.pattern, "num_attention_heads": c.num_heads,
        "num_key_value_heads": c.num_kv_heads, "head_dim": c.head_dim, "n_routed_experts": c.n_routed_experts,
        "n_shared_experts": c.n_shared_experts, "num_experts_per_tok": c.num_experts_per_tok,
        "routed_scaling_factor": c.routed_scaling_factor, "norm_topk_prob": c.norm_topk_prob, "n_group": 1,
        "topk_group": 1, "mlp_hidden_act": "relu2", "layer_norm_epsilon": c.rms_eps,
        "mamba_num_heads": c.mamba_heads, "mamba_head_dim": c.mamba_head_dim, "ssm_state_size": c.ssm_state,
        "n_groups": c.ssm_groups, "conv_kernel": c.conv_size,
    }


@pytest.fixture(scope="module")
def tiny():
    """Seeded f32 weights (one draw a part), the program on them (w8) and
    the reference's part function on the same weights."""
    cfg = nh.NemotronHConfig.tiny()
    gen = torch.Generator().manual_seed(3)
    weights = {}
    for part in nh.NemotronHModel.part_names(cfg):
        weights.update(nh.draw_part(cfg, part, gen, "cpu"))
    model = nh.NemotronHModel(cfg, params=weights, tokenizer=WordTok(), max_new_tokens=8, device="cpu")

    def part(name):
        return {n: weights[n] for n, *_ in nh.part_shapes(cfg, name)}

    return cfg, model, part


def _forced_run(m, inp, forced):
    seen = {}
    m.decode(inp, forced=forced, on_logits=lambda i, lg: seen.__setitem__(i, lg.clone()))
    return torch.stack([seen[i] for i in range(forced.shape[0])], dim=1)  # [rows, steps, vocab]


def _prompt_ids(inp):
    lengths = inp.lengths.tolist()
    return [np.concatenate([inp.prefix.numpy(), inp.tokens[j].numpy()])[: lengths[j]].tolist()
            for j in range(len(lengths))]


def test_published_config_reads_the_catalog_keys():
    """The benchmark's configuration file (the catalog's keys whole) gives
    the published shape: 23 M, 23 E and 6 * blocks, and the SSM's widths
    (inner 4,096, x | B | C 6,144, W_in 10,304)."""
    cfg = json.loads((ROOT / "perfbench/configs/tvc-nemotron3-nano-30b-w8.json").read_text())
    c = nh.published_config(cfg)
    assert c == nh.NemotronHConfig.nemotron3_nano_30b()
    assert (len(c.blocks("M")), len(c.blocks("E")), len(c.blocks("*"))) == (23, 23, 6)
    assert (c.ssm_width, c.conv_channels, c.ssm_in_width, c.n_moe_layers) == (4096, 6144, 10304, 23)
    assert nh.published_config(published(nh.NemotronHConfig.tiny()), max_seq_len=64, dtype=torch.float32,
                               model_name="tiny") == nh.NemotronHConfig.tiny()
    with pytest.raises(ValueError, match="pattern"):
        nh.NemotronHConfig(pattern="MEM")


def test_prefix_prefill_then_decode_matches_reference(tiny):
    """Two prompts of different lengths (one right-padded), a shared
    prefix, 2 samples each, 6 teacher-forced steps: every position's
    logits against the reference's full forward."""
    cfg, m, part = tiny
    inp = m.prepare(PROMPTS, n_samples=2, shared_prefix=PARAPHRASE_PREFIX)
    assert inp.P > 0 and len(set(inp.lengths.tolist())) == 2  # prefix-shared, one row padded
    steps = 6
    forced = torch.as_tensor(np.random.default_rng(0).integers(1, 500, (steps, 4)))
    before = launch_counts()
    got = _forced_run(m, inp, forced)
    assert launch_counts() == before  # CPU tensors: the plain versions, no kernel
    ids = _prompt_ids(inp)
    seqs = [ids[j // 2] + forced[:, j].tolist()[: steps - 1] for j in range(4)]
    want = ref.NemotronH(published(cfg), part).logits(seqs)
    lengths = inp.lengths.tolist()
    for j in range(4):
        n = lengths[j // 2]
        torch.testing.assert_close(got[j], want[j][n - 1 : n - 1 + steps], atol=ATOL, rtol=0)


@pytest.mark.parametrize("shared", [True, False], ids=["prefix", "plain"])
def test_a_padded_row_decodes_as_it_does_alone(tiny, shared):
    """The short prompt, right-padded beside the long one, gives the logits
    it gives alone (no pad): a pad left no trace in its SSM state, its
    window or its KV slots."""
    cfg, m, _ = tiny
    pre = PARAPHRASE_PREFIX if shared else None
    forced = torch.as_tensor(np.random.default_rng(1).integers(1, 500, (4, 2)))
    both = _forced_run(m, m.prepare(PROMPTS, shared_prefix=pre), forced)
    alone = _forced_run(m, m.prepare(PROMPTS[:1], shared_prefix=pre), forced[:, :1])
    torch.testing.assert_close(both[0], alone[0], atol=ATOL, rtol=0)


def test_prefix_then_tiled_state_equals_each_rows_own_prefill(tiny, monkeypatch):
    """The cache the decode starts from (the prefix at batch 1 put into
    every row, the suffixes at their lengths, then each row tiled 3 times)
    against each prompt prefilled alone and whole: the SSM states, windows
    and KV slots agree row for row."""
    cfg, m, _ = tiny
    tiled = []
    tile = nh.NemotronHModel._tile_cache

    def keep(cache, n):
        out = tile(cache, n)
        tiled.append(nh.NemotronCache(*(t.clone() for t in (out.k, out.v, out.state, out.conv))))
        return out

    monkeypatch.setattr(nh.NemotronHModel, "_tile_cache", staticmethod(keep))
    forced = torch.full((1, 6), 5)
    m.decode(m.prepare(PROMPTS, n_samples=3, shared_prefix=PARAPHRASE_PREFIX), forced=forced)
    for j, p in enumerate(PROMPTS):
        inp = m.prepare([p], n_samples=3)
        assert inp.P == 0
        m.decode(inp, forced=forced[:, :3])
        both, alone = tiled[0], tiled[-1]
        n = int(inp.lengths[0])
        for r in range(3):
            torch.testing.assert_close(both.state[:, 3 * j + r], alone.state[:, r], atol=1e-6, rtol=0)
            torch.testing.assert_close(both.conv[:, 3 * j + r], alone.conv[:, r], atol=ATOL, rtol=0)
            torch.testing.assert_close(both.k[:, 3 * j + r, :, :n], alone.k[:, r, :, :n], atol=ATOL, rtol=0)
            torch.testing.assert_close(both.v[:, 3 * j + r, :, :n], alone.v[:, r, :, :n], atol=ATOL, rtol=0)
        assert both.state[:, 3 * j].abs().max() > 0.01  # states of ~0.1: 1e-6 is ~1e-5 of them
    assert len(tiled) == 3


def _ssm_operands(T=64, B=2, nh_=4, P=8, N=16, G=2, K=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    I = nh_ * P
    C = I + 2 * G * N
    y = torch.randn((B, T, I + C + nh_), generator=g)
    y[..., I + C :] -= 2.0  # steps of ~0.1
    conv_w = torch.randn((C, K), generator=g) * 0.5
    conv_b = torch.randn(C, generator=g) * 0.1
    a_log = torch.log(1 + 15 * torch.rand(nh_, generator=g))
    dt_bias = torch.randn(nh_, generator=g) * 0.5
    d = 1 + 0.1 * torch.randn(nh_, generator=g)
    return y, conv_w, conv_b, a_log, dt_bias, d, I, C


def _reference_ssm(y, conv_w, conv_b, a_log, dt_bias, d, nh_, G, state_dtype=torch.float32):
    """The reference's formulas on one row (its scan, the state rounded to
    ``state_dtype`` after every token); y before the gated norm."""
    import torch.nn.functional as F

    T = y.shape[0]
    C, K = conv_w.shape
    I = y.shape[1] - C - nh_
    N = (C - I) // (2 * G)
    xbc = F.silu(F.conv1d(F.pad(y[:, I : I + C].T[None], (K - 1, 0)), conv_w[:, None, :], conv_b, groups=C)[0].T)
    x = xbc[:, :I].view(T, nh_, I // nh_)
    b = xbc[:, I : I + G * N].view(T, G, N).repeat_interleave(nh_ // G, dim=1)
    c = xbc[:, I + G * N :].view(T, G, N).repeat_interleave(nh_ // G, dim=1)
    dt = F.softplus(y[:, I + C :] + dt_bias)
    return ref.ssm_scan(x, b, c, dt, a_log, d, state_dtype).reshape(T, I)


def test_ssm_over_64_tokens_holds_to_the_token_loop_and_a_bf16_state_does_not():
    """The program's preparation and recurrence (f32 state) over 64 tokens
    against the reference's convolution and token loop: within 1e-5 of
    outputs of scale ~1 (sums in other orders, ~1e-7 relative a token,
    compounding slowly under the decay). A state rounded to bf16 after
    every token (2^-9 relative) parts from the loop by far more: the
    tolerance would catch a bf16 state."""
    nh_, G = 4, 2
    y, conv_w, conv_b, a_log, dt_bias, d, I, C = _ssm_operands(nh_=nh_, G=G)
    B = y.shape[0]
    window = torch.zeros((B, 3, C))
    state = torch.zeros((B, nh_, 8, 16))
    xbc, dt = ssm_prepare(y, conv_w, conv_b, dt_bias, window, None, I, I + C)
    got = ssm_recurrent(xbc, dt, a_log, d, state, None, G, torch.float32)
    tol = 1e-5
    for b in range(B):
        want = _reference_ssm(y[b], conv_w, conv_b, a_log, dt_bias, d, nh_, G)
        assert want.abs().max() > 0.5
        assert (got[b] - want).abs().max() < tol
        low = _reference_ssm(y[b], conv_w, conv_b, a_log, dt_bias, d, nh_, G, torch.bfloat16)
        assert (low - want).abs().max() > 10 * tol


@pytest.mark.parametrize("n", [0, 1, 5, 64])
def test_a_pad_neither_decays_nor_updates_the_state(n):
    """Row 0 runs its first n tokens of 64 (the rest pads), row 1 all: row
    0's state and window equal a run over just its n tokens, its outputs
    past n are zeros, and row 1 is as it is alone."""
    nh_, G = 4, 2
    y, conv_w, conv_b, a_log, dt_bias, d, I, C = _ssm_operands(nh_=nh_, G=G, seed=4)
    g = torch.Generator().manual_seed(5)
    cs0, st0 = torch.randn((2, 3, C), generator=g), torch.randn((2, nh_, 8, 16), generator=g) * 0.1
    cs, st = cs0.clone(), st0.clone()
    lengths = torch.tensor([n, 64])
    xbc, dt = ssm_prepare(y, conv_w, conv_b, dt_bias, cs, lengths, I, I + C)
    o = ssm_recurrent(xbc, dt, a_log, d, st, lengths, G, torch.float32)
    cs1, st1 = cs0[:1].clone(), st0[:1].clone()
    if n:
        xbc1, dt1 = ssm_prepare(y[:1, :n], conv_w, conv_b, dt_bias, cs1, None, I, I + C)
        o1 = ssm_recurrent(xbc1, dt1, a_log, d, st1, None, G, torch.float32)[0]
        torch.testing.assert_close(o[0, :n], o1, atol=1e-6, rtol=0)  # y's einsum may block a batch of 2 apart
    assert torch.equal(cs[0], cs1[0])
    torch.testing.assert_close(st[0], st1[0], atol=1e-6, rtol=0)  # the CPU's exp may round a batch of 2 apart
    assert not o[0, n:].any() and not xbc[0, n:].any() and not dt[0, n:].any()
    cs2, st2 = cs0[1:].clone(), st0[1:].clone()
    xbc2, dt2 = ssm_prepare(y[1:], conv_w, conv_b, dt_bias, cs2, None, I, I + C)
    torch.testing.assert_close(o[1], ssm_recurrent(xbc2, dt2, a_log, d, st2, None, G, torch.float32)[0], atol=1e-6,
                               rtol=0)
    torch.testing.assert_close(st[1], st2[0], atol=1e-6, rtol=0)


def test_gated_norm_groups_the_channels():
    """Each group of I / groups channels is normed on its own: scaling one
    group's inputs leaves the other groups' outputs as they were, and one
    group equals the whole-width norm of its channels."""
    g = torch.Generator().manual_seed(8)
    y, z, w = torch.randn((2, 3, 64), generator=g), torch.randn((2, 3, 80), generator=g), 1 + torch.rand(64)
    out = ssm_gated_norm(y, z, w, 4, 1e-5)
    y2 = y.clone()
    y2[..., 16:32] *= 7.0
    out2 = ssm_gated_norm(y2, z, w, 4, 1e-5)
    assert torch.equal(out[..., :16], out2[..., :16]) and torch.equal(out[..., 32:], out2[..., 32:])
    torch.testing.assert_close(out[..., 16:32], ssm_gated_norm(y[..., 16:32].contiguous(), z[..., 16:32],
                                                                w[16:32], 1, 1e-5), atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_relu2_and_the_no_rotary_cache_write_match_their_plain_versions(dtype):
    """relu2 is ``relu(u) * relu(u)`` rounded once (the plain version's
    bits); qkv_cache writes k and v and returns q as the rotary epilogue
    does with no bias and an identity rotation (cos 1, sin 0), bit for
    bit."""
    g = torch.Generator().manual_seed(9)
    u = torch.randn((5, 37), generator=g).to(dtype)
    r = torch.where(u > 0, u, torch.zeros_like(u))
    assert torch.equal(relu2(u), (r.float() * r.float()).to(dtype)) and torch.equal(relu2(u), relu2_reference(u))
    L, B, kv, S, D, R = 3, 4, 2, 9, 16, 4
    qkv = torch.randn((B, 1, (kv * R + 2 * kv) * D), generator=g).to(dtype)
    caches = [torch.zeros((L, B, kv, S, D), dtype=dtype) for _ in range(4)]
    q = qkv_cache(qkv, caches[0], caches[1], 1, 5)
    ones = torch.ones((B, 1, 1, D // 2))
    q2 = qkv_rope_cache_reference(qkv, torch.zeros(qkv.shape[-1]), ones, 0 * ones, caches[2], caches[3], 1, 5)
    assert torch.equal(q, q2) and torch.equal(caches[0], caches[2]) and torch.equal(caches[1], caches[3])
    assert torch.equal(q, qkv_cache_reference(qkv, caches[2], caches[3], 1, 5))
    assert caches[0][1, :, :, 5].any() and not caches[0][0].any() and not caches[0][1, :, :, :5].any()


def test_counters_and_spans_are_read_back_with_the_tokens(tiny):
    cfg, m, _ = tiny
    names = ("ssm.token_updates", "moe.layer_steps")
    before = tracing.counters()
    handle = m.generate_async(PROMPTS, temperature=0.8, seed=3, n_samples=2, shared_prefix=PARAPHRASE_PREFIX)
    assert {k: tracing.counters().get(k, 0) for k in names} == {k: before.get(k, 0) for k in names}
    handle()
    after = tracing.counters()
    d = {k: after.get(k, 0) - before.get(k, 0) for k in names}
    inp = m.prepare(PROMPTS, n_samples=2, shared_prefix=PARAPHRASE_PREFIX)
    assert d["ssm.token_updates"] == inp.P + int((inp.lengths - inp.P).sum())
    assert d["moe.layer_steps"] == m.last_decode_steps * cfg.n_moe_layers == m.last_decode_steps * 2
    names = {s.name for s in tracing.spans()[-64:]}
    assert {"nemotron.prepare", "nemotron.prefill", "nemotron.decode_step", "nemotron.readback"} <= names


@pytest.mark.parametrize("max_rows", [1024, 2])
def test_chip_smoke_step_launch_formula_matches_the_decode(tiny, max_rows):
    """chip_smoke's launches of one Nemotron-H decode step, read off the
    code, equal the calls one step makes to the wrappers (spied on the CPU,
    where they compute their plain versions), also under a row limit the
    step's rows exceed; and give 105 w8 GEMMs, 46 grouped GEMMs, 6 decode
    attentions and cache writes, 23 of each SSM kernel, 23 routings and
    combines and 46 squared ReLUs a step at the cell's 640 rows."""
    import contextlib
    from unittest import mock

    import chip_smoke
    from tvc_torch.models import decoding
    from tvc_torch.models import deepseek_v2 as ds

    cfg, m, _ = tiny
    names = ("w8_matmul", "moe_w8_grouped_gemm", "decode_gqa_attention_stacked", "rmsnorm", "add_rmsnorm",
             "moe_route", "moe_combine", *chip_smoke.NEMOTRON)
    calls, at = dict.fromkeys(names + ("w8_matmul_reference",), 0), {}

    def spy(name, fn):
        def f(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return f

    inp = m.prepare(PROMPTS, n_samples=2, shared_prefix=PARAPHRASE_PREFIX)
    rows = 2 * len(PROMPTS)
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(decoding, "W8_MAX_ROWS", max_rows))
        stack.enter_context(mock.patch.object(ds, "W8_MAX_ROWS", max_rows))
        for mod in (ds, decoding, nh):  # the final norm is CausalDecoder's, the blocks' norms Nemotron-H's
            for n in names + ("w8_matmul_reference",):
                if hasattr(mod, n):
                    stack.enter_context(mock.patch.object(mod, n, spy(n, getattr(mod, n))))
        m.decode(inp, forced=torch.full((3, rows), 5), on_logits=lambda i, lg: at.__setitem__(i, dict(calls)))
        want = chip_smoke.nemotron_step_launches(cfg, rows)
    step = {n: at[2][n] - at[1][n] for n in calls}
    # on the card the stacked wrapper launches the flat kernel once a call; on the CPU neither runs
    assert want.pop("decode_gqa_attention") == want["decode_gqa_attention_stacked"]
    assert {n: step[n] for n in names} == want
    n_w8 = 2 * cfg.num_layers + 1
    assert want["w8_matmul"] == (0 if max_rows < rows else n_w8)
    assert step["w8_matmul_reference"] == n_w8 - want["w8_matmul"]
    assert chip_smoke.nemotron_step_launches(nh.NemotronHConfig.nemotron3_nano_30b(), 640) == \
        {"w8_matmul": 105, "moe_w8_grouped_gemm": 46, "decode_gqa_attention": 6, "decode_gqa_attention_stacked": 6,
         "rmsnorm": 1, "add_rmsnorm": 52, "moe_route": 23, "moe_combine": 23, "relu2": 46, "qkv_cache": 6,
         "ssm_prepare": 23, "ssm_recurrent": 23, "ssm_gated_norm": 23}


def test_process_stream_with_the_tiny_model_as_paraphraser():
    from tvc_torch.augment import TextAugmentConfig, TextAugmenter
    from tvc_torch.models.clip import CLIPConfig, CLIPModel
    from tvc_torch.pipeline import MultiModalDetectionPipeline, PipelineConfig
    from tvc_torch.retrieval import MultiModalRetriever

    clip = CLIPModel(CLIPConfig.tiny(), seed=0, device="cpu")
    retriever = MultiModalRetriever(clip)
    retriever.build_image_index(embeddings=np.random.default_rng(1).standard_normal((40, clip.config.embed_dim))
                                .astype(np.float32))
    images = np.random.default_rng(2).random((4, 32, 32, 3)).astype(np.float32)
    lm = nh.NemotronHModel(nh.NemotronHConfig.tiny(), seed=0, max_new_tokens=8, device="cpu")
    augmenter = TextAugmenter(TextAugmentConfig(enable_template=False, enable_synonym_replacement=False,
                                                max_variants=3), paraphrase_generator=lm.as_paraphrase_generator())
    pipe = MultiModalDetectionPipeline(
        clip, PipelineConfig(num_text_variants=3, retrieval_top_k=4, num_reference_images=2), retriever=retriever,
        device="cpu", text_augmenter=augmenter,
    )
    texts = ["a dog runs in the park", "two cats on a mat", "a red bus", "a man on a horse"]
    results = pipe.process_stream([(images[:2], texts[:2]), (images[2:], texts[2:])])
    assert len(results) == 2 and all(not r.errors and all(len(v) for v in r.variants) for r in results)


def test_the_cut_bpe_fits_the_vocabulary():
    """vocab 131072 picks the Qwen2 BPE cut below its last two rows: every
    id of a COCO-like caption below 131,070, a BOS opening it, EOS the last
    row."""
    from tvc_torch.models.tokenizer import NemotronQwenBPETokenizer, get_tokenizer

    tok = get_tokenizer(vocab_size=131072, context_length=32)
    assert isinstance(tok, NemotronQwenBPETokenizer) and tok.eot_id == 131071 and tok.bos_id == 131070
    row = tok(["A man riding a wave on top of a surfboard."])[0]
    ids = row[row != tok.pad_id]
    assert ids[0] == 131070 and (ids[1:] < 131070).all() and len(ids) > 5


@pytest.mark.parametrize("path", ["tests/reference_nemotron_h.py", "perfbench/reference/nemotron_h.py"])
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse((ROOT / path).read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert not {m.split(".")[0] for m in names} & {"tvc_torch", "tvc", "jax", "flax"}, names
