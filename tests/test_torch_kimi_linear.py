"""tvc_torch's Kimi-Linear (``tvc_torch/models/kimi_linear.py``) against the
plain reference ``tests/reference_kimi_linear.py`` on ``KimiLinearConfig.tiny()``
(three KDA layers, then a latent one; 16 experts chosen by sigmoid + bias)
in f32 with w8 weights: the prefix-shared prefill and the decode through
the hybrid cache, teacher forced, against the reference's full forward;
rows of different real lengths in one right-padded batch; the
prefix-shared prefill against the plain one; ``n_samples`` tiling; the KDA
recurrence against the token loop, with a state kept in bf16 as the
control; the sigmoid routing, ties included; ``process_batch`` and
``process_stream`` with the tiny model as full TVC's paraphraser. On the CPU
the kernel wrappers compute their plain versions and launch nothing."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import tests.reference_kimi_linear as ref
import tvc_torch.models.kimi_linear as kl
from tvc_torch.core.kernels import launch_counts
from tvc_torch.core.kernels.dsv2_fused_kernel import moe_route, moe_route_reference
from tvc_torch.core.kernels.kda_kernel import kda_prepare, kda_recurrent
from tvc_torch.models.decoding import PARAPHRASE_PREFIX, PARAPHRASE_PROMPT, _stable_seed
from tvc_torch.utils import tracing

PROMPTS = [PARAPHRASE_PROMPT.format(text=t) for t in ("a dog runs in the park",
                                                      "two cats sleep on a soft mat near the open kitchen window")]
#: the program (f32, w8) against the reference (f32, the same int8 values
#: dequantized): the two sum the same products in other orders (the w8
#: GEMM scales after its sum, the reference before; the recurrence's
#: einsums; the convolution's taps), ~1e-7 relative a sum, compounded over
#: 4 layers and a 20-token recurrence to ~1e-6 of logits of unit scale. A
#: dropped pad check, a wrong tap or a state read at the wrong row moves
#: them by O(1e-1).
ATOL = 2e-5


class WordTok:
    """Word-level tokenizer without BOS / EOS, so a prompt split at a space
    is token-exact and the prefix-shared prefill engages."""

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


def published(c: kl.KimiLinearConfig) -> dict:
    """A configuration's numbers under the published ``config.json`` keys."""
    return {
        "vocab_size": c.vocab_size, "hidden_size": c.hidden_size, "intermediate_size": c.intermediate_size,
        "moe_intermediate_size": c.moe_intermediate_size, "num_hidden_layers": c.num_layers,
        "first_k_dense_replace": c.first_k_dense, "num_attention_heads": c.num_heads, "kv_lora_rank": c.kv_lora_rank,
        "qk_nope_head_dim": c.qk_nope_head_dim, "qk_rope_head_dim": c.qk_rope_head_dim, "v_head_dim": c.v_head_dim,
        "num_experts": c.n_routed_experts, "num_shared_experts": c.n_shared_experts,
        "num_experts_per_token": c.num_experts_per_tok, "routed_scaling_factor": c.routed_scaling_factor,
        "moe_renormalize": c.norm_topk_prob, "moe_router_activation_func": c.scoring_func,
        "mla_use_nope": not c.use_rope, "rope_theta": c.rope_theta, "rms_norm_eps": c.rms_eps,
        "linear_attn_config": {"kda_layers": [i + 1 for i in c.kda_layers], "num_heads": c.kda_heads,
                               "head_dim": c.kda_head_dim, "short_conv_kernel_size": c.conv_size,
                               "full_attn_layers": [i + 1 for i in c.mla_layers]},
    }


@pytest.fixture(scope="module")
def tiny():
    """Seeded f32 weights (one draw a part), the program on them (w8) and
    the reference's part function on the same weights."""
    cfg = kl.KimiLinearConfig.tiny()
    gen = torch.Generator().manual_seed(3)
    weights = {}
    for part in kl.KimiLinearModel.part_names(cfg):
        weights.update(kl.draw_part(cfg, part, gen, "cpu"))
    model = kl.KimiLinearModel(cfg, params=weights, tokenizer=WordTok(), max_new_tokens=8, device="cpu")

    def part(name):
        return {n: weights[n] for n, *_ in kl.part_shapes(cfg, name)}

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
    c = kl.KimiLinearConfig.kimi_linear_48b()
    assert kl.published_config(published(c)) == c
    assert c.mla_layers == (3, 7, 11, 15, 19, 23, 26) and len(c.kda_layers) == 20
    assert c.softmax_scale == pytest.approx(192 ** -0.5, rel=1e-12)
    assert (c.kda_width, c.n_moe_layers, c.latent_width) == (4096, 26, 576)


def test_prefix_prefill_then_hybrid_decode_matches_reference(tiny):
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
    want = ref.KimiLinear(published(cfg), part).logits(seqs)
    lengths = inp.lengths.tolist()
    for j in range(4):
        n = lengths[j // 2]
        torch.testing.assert_close(got[j], want[j][n - 1 : n - 1 + steps], atol=ATOL, rtol=0)


@pytest.mark.parametrize("shared", [True, False], ids=["prefix", "plain"])
def test_a_padded_row_decodes_as_it_does_alone(tiny, shared):
    """The short prompt, right-padded beside the long one, gives the logits
    it gives alone (no pad): a pad left no trace in its KDA state or
    window."""
    cfg, m, _ = tiny
    pre = PARAPHRASE_PREFIX if shared else None
    forced = torch.as_tensor(np.random.default_rng(1).integers(1, 500, (4, 2)))
    both = _forced_run(m, m.prepare(PROMPTS, shared_prefix=pre), forced)
    alone = _forced_run(m, m.prepare(PROMPTS[:1], shared_prefix=pre), forced[:, :1])
    torch.testing.assert_close(both[0], alone[0], atol=ATOL, rtol=0)


def test_prefix_shared_prefill_equals_the_plain_prefill(tiny):
    cfg, m, _ = tiny
    forced = torch.as_tensor(np.random.default_rng(2).integers(1, 500, (5, 2)))
    split = m.prepare(PROMPTS, shared_prefix=PARAPHRASE_PREFIX)
    whole = m.prepare(PROMPTS)
    assert split.P > 0 and whole.P == 0 and split.lengths.tolist() == whole.lengths.tolist()
    torch.testing.assert_close(_forced_run(m, split, forced), _forced_run(m, whole, forced), atol=ATOL, rtol=0)


def test_n_samples_tiling_repeats_each_prompts_cache(tiny):
    """Three samples a prompt, all forced to the same tokens: each sample's
    logits equal the one-sample decode's (the tiled rows are copies of the
    prefilled ones; a GEMM of 6 rows and one of 2 may block their sums
    apart on the CPU, hence ATOL and not bit for bit), and the three
    samples of a prompt equal each other bit for bit."""
    cfg, m, _ = tiny
    forced = torch.as_tensor(np.random.default_rng(3).integers(1, 500, (4, 2)))
    one = _forced_run(m, m.prepare(PROMPTS, n_samples=1, shared_prefix=PARAPHRASE_PREFIX), forced)
    three = _forced_run(m, m.prepare(PROMPTS, n_samples=3, shared_prefix=PARAPHRASE_PREFIX),
                        forced.repeat_interleave(3, dim=1))
    torch.testing.assert_close(three, one.repeat_interleave(3, dim=0), atol=ATOL, rtol=0)
    assert torch.equal(three[0], three[1]) and torch.equal(three[3], three[5])


def _kda_operands(T=64, B=2, nh=2, d=16, K=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    HD = nh * d
    y = torch.randn((B, T, 3 * HD + 2 * d + nh), generator=g)
    f = torch.randn((B, T, 2 * HD), generator=g) - 3.0
    conv_w = torch.randn((3 * HD, K), generator=g) * 0.5
    a_log = torch.log(1 + 15 * torch.rand(nh, generator=g))
    dt_bias = torch.randn(HD, generator=g) * 0.5
    return y, f, conv_w, a_log, dt_bias


def _reference_kda(y, f, conv_w, a_log, dt_bias, nh, b_col, state_dtype=torch.float32):
    """The reference's formulas on one row (the recurrence in
    ``reference_kimi_linear``, the state rounded to ``state_dtype`` after
    every token)."""
    import torch.nn.functional as F

    T = y.shape[0]
    C, K = conv_w.shape
    d = C // 3 // nh
    x = y[:, :C]
    conv = F.conv1d(F.pad(x.T[None], (K - 1, 0)), conv_w[:, None, :], groups=C)[0].T
    q, k, v = F.silu(conv).view(T, 3, nh, d).unbind(1)
    q = q * torch.rsqrt(q.square().sum(-1, keepdim=True) + ref.L2_EPS) * d ** -0.5
    k = k * torch.rsqrt(k.square().sum(-1, keepdim=True) + ref.L2_EPS)
    g = -torch.exp(a_log)[:, None] * F.softplus((f[:, : nh * d] + dt_bias).view(T, nh, d))
    beta = torch.sigmoid(y[:, b_col : b_col + nh])
    if state_dtype == torch.float32:
        return ref.kda_recurrence(q, k, v, g, beta)
    S = torch.zeros((nh, d, d))
    out = []
    for t in range(T):
        S = S * torch.exp(g[t])[..., None]
        u = v[t] - torch.einsum("hkv,hk->hv", S, k[t])
        S = (S + beta[t][:, None, None] * k[t][..., None] * u[:, None, :]).to(state_dtype).float()
        out.append(torch.einsum("hkv,hk->hv", S, q[t]))
    return torch.stack(out)


def test_kda_over_64_tokens_holds_to_the_token_loop_and_a_bf16_state_does_not():
    """The program's preparation and recurrence (f32 state) over 64 tokens
    against the reference's convolution and token loop: within 1e-5 of
    outputs of scale ~0.3 (sums in other orders, ~1e-7 relative a token,
    compounding slowly under the decay). A state rounded to bf16 after
    every token (2^-9 relative) parts from the loop by far more: the
    tolerance would catch a bf16 state."""
    nh, d = 2, 16
    y, f, conv_w, a_log, dt_bias = _kda_operands(nh=nh, d=d)
    B, T, _ = y.shape
    b_col = 3 * nh * d + 2 * d
    conv_state = torch.zeros((B, 3, 3 * nh * d))
    state = torch.zeros((B, nh, d, d))
    qkvg, beta = kda_prepare(y, f, conv_w, a_log, dt_bias, conv_state, None, nh, b_col)
    got = kda_recurrent(qkvg, beta, state, None, torch.float32)
    tol = 1e-5
    for b in range(B):
        want = _reference_kda(y[b], f[b], conv_w, a_log, dt_bias, nh, b_col)
        assert want.abs().max() > 0.1
        assert (got[b] - want).abs().max() < tol
        low = _reference_kda(y[b], f[b], conv_w, a_log, dt_bias, nh, b_col, torch.bfloat16)
        assert (low - want).abs().max() > 10 * tol


@pytest.mark.parametrize("n", [0, 1, 5, 64])
def test_a_pad_leaves_state_and_window_untouched(n):
    """Row 0 runs its first n tokens of 64 (the rest pads), row 1 all: row
    0's state and window equal a run over just its n tokens, its outputs
    past n are zeros, and row 1 is as it is alone."""
    nh, d = 2, 16
    y, f, conv_w, a_log, dt_bias = _kda_operands(nh=nh, d=d, seed=4)
    b_col = 3 * nh * d + 2 * d
    g = torch.Generator().manual_seed(5)
    cs0, st0 = torch.randn((2, 3, 3 * nh * d), generator=g), torch.randn((2, nh, d, d), generator=g) * 0.1
    cs, st = cs0.clone(), st0.clone()
    qkvg, beta = kda_prepare(y, f, conv_w, a_log, dt_bias, cs, torch.tensor([n, 64]), nh, b_col)
    o = kda_recurrent(qkvg, beta, st, torch.tensor([n, 64]), torch.float32)
    cs1, st1 = cs0[:1].clone(), st0[:1].clone()
    qkvg1, beta1 = kda_prepare(y[:1, :n], f[:1, :n], conv_w, a_log, dt_bias, cs1, None, nh, b_col) if n else (None, None)
    if n:
        o1 = kda_recurrent(qkvg1, beta1, st1, None, torch.float32)
        assert torch.equal(o[0, :n], o1[0])
    assert torch.equal(cs[0], cs1[0]) and torch.equal(st[0], st1[0])
    assert not o[0, n:].any() and not qkvg[0, n:].any() and not beta[0, n:].any()
    cs2, st2 = cs0[1:].clone(), st0[1:].clone()
    q2, b2 = kda_prepare(y[1:], f[1:], conv_w, a_log, dt_bias, cs2, None, nh, b_col)
    assert torch.equal(o[1], kda_recurrent(q2, b2, st2, None, torch.float32)[0]) and torch.equal(st[1], st2[0])


def _routing_logits():
    g = torch.Generator().manual_seed(6)
    E = 256
    rows = [torch.randn(E, generator=g) for _ in range(4)]
    r = torch.randn(E, generator=g)
    r[[3, 40, 200]] = r.max() + 1  # a tie inside the top k
    rows.append(r)
    r = torch.randn(E, generator=g)
    top = torch.topk(r, 10).indices
    r[top[7:]] = r[top[7]].clone()  # ties at the k-th place
    rows += [r, torch.zeros(E), torch.arange(E).float().remainder(4), -torch.arange(E).float().div(3).floor()]
    return torch.stack(rows)


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no-bias"])
def test_sigmoid_routing_matches_topk_on_the_biased_scores(with_bias):
    """256 experts, top 8: the ids ``torch.topk`` gives the biased scores
    (ties in its order: whole rows equal, ties at the boundary), weighted
    by the unbiased sigmoids over their sum; the combine's scale stays
    outside. The softmax route is DeepSeek-V2's, unchanged."""
    logits = _routing_logits()
    N, E = logits.shape
    bias = (torch.arange(E) % 7 - 3).float() * 0.01 if with_bias else None
    x = torch.randn((N, 16), generator=torch.Generator().manual_seed(7))
    topv, topi, pos, xs, offsets = moe_route(logits, x, 8, None, "sigmoid", bias, True)
    scores = torch.sigmoid(logits)
    choice = scores + bias if with_bias else scores
    want_i = torch.topk(choice, 8, dim=-1).indices
    assert torch.equal(topi, want_i)
    w = scores.gather(1, want_i)
    torch.testing.assert_close(topv, w / (w.sum(-1, keepdim=True) + 1e-20), atol=1e-7, rtol=0)
    assert torch.equal(xs, x.index_select(0, torch.argsort(topi.reshape(-1), stable=True) // 8))
    assert offsets[-1] == N * 8 and torch.equal(xs[pos.reshape(-1).long()], x.repeat_interleave(8, dim=0))
    sm = moe_route(logits, x, 6)
    assert all(torch.equal(a, b) for a, b in zip(sm, moe_route_reference(logits, x, 6)))
    assert torch.equal(sm[1], torch.topk(torch.softmax(logits, -1), 6, dim=-1).indices)


def test_routed_sets_match_the_reference(tiny):
    """Each prompt's prefill routes, layer by layer, against the
    reference's wherever its 4th and 5th biased scores are apart."""
    from unittest import mock

    cfg, m, part = tiny
    got, route = [], kl.ds.moe_route

    def spy(logits, x, k, counts=None, *a):
        out = route(logits, x, k, counts, *a)
        if x.shape[0] > 1:
            got.append(out[1])
        return out

    seqs = []
    with mock.patch.object(kl.ds, "moe_route", spy):
        for p in PROMPTS:
            inp = m.prepare([p])
            seqs.append(inp.tokens[0, : int(inp.lengths[0])].tolist())
            m.decode(inp, forced=torch.full((1, 1), 5))
    rf = ref.KimiLinear(published(cfg), part)
    rf.logits(seqs)
    n_moe, k = cfg.n_moe_layers, cfg.num_experts_per_tok
    for j, s in enumerate(seqs):
        for li in range(n_moe):
            ref_topi, choice = rf.routes[li + cfg.first_k_dense][j]
            srt = torch.sort(choice, dim=-1, descending=True).values
            clear = (srt[:, k - 1] - srt[:, k]) > 1e-6
            prog = got[j * n_moe + li][: len(s)]
            for t in range(len(s)):
                if clear[t]:
                    assert set(prog[t].tolist()) == set(ref_topi[t].tolist())


def test_counters_and_spans_are_read_back_with_the_tokens(tiny):
    cfg, m, _ = tiny
    names = ("kda.token_updates", "moe.layer_steps")
    before = tracing.counters()
    handle = m.generate_async(PROMPTS, temperature=0.8, seed=3, n_samples=2, shared_prefix=PARAPHRASE_PREFIX)
    assert {k: tracing.counters().get(k, 0) for k in names} == {k: before.get(k, 0) for k in names}
    handle()
    after = tracing.counters()
    d = {k: after.get(k, 0) - before.get(k, 0) for k in names}
    inp = m.prepare(PROMPTS, n_samples=2, shared_prefix=PARAPHRASE_PREFIX)
    assert d["kda.token_updates"] == inp.P + int((inp.lengths - inp.P).sum())
    assert d["moe.layer_steps"] == m.last_decode_steps * cfg.n_moe_layers
    names = {s.name for s in tracing.spans()[-64:]}
    assert {"kimi.prepare", "kimi.prefill", "kimi.decode_step", "kimi.readback"} <= names


@pytest.mark.parametrize("max_rows", [1024, 2])
def test_chip_smoke_step_launch_formula_matches_the_decode(tiny, max_rows):
    """chip_smoke's launches of one Kimi-Linear decode step, read off the
    code, equal the calls one step makes to the wrappers (spied on the CPU,
    where they compute their plain versions), also under a row limit the
    step's rows exceed; and give 129 w8 GEMMs, 52 grouped GEMMs, 7 latent
    attentions and epilogues, 20 of each KDA kernel, 26 routings and
    combines a step at the cell's 480 rows."""
    import contextlib
    from unittest import mock

    import chip_smoke
    from tvc_torch.models import decoding
    from tvc_torch.models import deepseek_v2 as ds

    cfg, m, _ = tiny
    names = ("w8_matmul", "moe_w8_grouped_gemm", "mla_decode_attention", "rmsnorm", "add_rmsnorm", "silu_mul",
             *chip_smoke.DSV2_FUSED, *chip_smoke.KDA)
    calls, at = dict.fromkeys(names + ("w8_matmul_reference",), 0), {}

    def spy(name, fn):
        def f(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return f

    inp = m.prepare(PROMPTS, n_samples=2, shared_prefix=PARAPHRASE_PREFIX)
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(decoding, "W8_MAX_ROWS", max_rows))
        stack.enter_context(mock.patch.object(ds, "W8_MAX_ROWS", max_rows))
        for mod in (ds, decoding, kl):  # the final norm is CausalDecoder's, the KDA layers' norms Kimi-Linear's
            for n in names + ("w8_matmul_reference",):
                if hasattr(mod, n):
                    stack.enter_context(mock.patch.object(mod, n, spy(n, getattr(mod, n))))
        m.decode(inp, forced=torch.full((3, 4), 5), on_logits=lambda i, lg: at.__setitem__(i, dict(calls)))
        want = chip_smoke.kimi_step_launches(cfg, 4)
    step = {n: at[2][n] - at[1][n] for n in calls}
    assert {n: step[n] for n in names} == want
    n_w8 = 2 * len(cfg.mla_layers) + 3 * len(cfg.kda_layers) + 2 * cfg.num_layers + 1
    assert want["w8_matmul"] == (0 if max_rows < 4 else n_w8) and step["w8_matmul_reference"] == n_w8 - want["w8_matmul"]
    assert chip_smoke.kimi_step_launches(kl.KimiLinearConfig.kimi_linear_48b(), 480) == \
        {"w8_matmul": 129, "moe_w8_grouped_gemm": 52, "mla_decode_attention": 7, "rmsnorm": 1, "add_rmsnorm": 54,
         "silu_mul": 53, "mla_rope_cache": 7, "mla_out": 7, "moe_route": 26, "moe_combine": 26, "kda_prepare": 20,
         "kda_recurrent": 20, "kda_gated_norm": 20}


def test_process_batch_and_stream_with_the_tiny_model_as_paraphraser():
    from tvc_torch.augment import TextAugmentConfig, TextAugmenter
    from tvc_torch.models.clip import CLIPConfig, CLIPModel
    from tvc_torch.pipeline import MultiModalDetectionPipeline, PipelineConfig
    from tvc_torch.retrieval import MultiModalRetriever

    clip = CLIPModel(CLIPConfig.tiny(), seed=0, device="cpu")
    retriever = MultiModalRetriever(clip)
    retriever.build_image_index(embeddings=np.random.default_rng(1).standard_normal((40, clip.config.embed_dim))
                                .astype(np.float32))
    images = np.random.default_rng(2).random((4, 32, 32, 3)).astype(np.float32)
    lm = kl.KimiLinearModel(kl.KimiLinearConfig.tiny(), seed=0, max_new_tokens=8, device="cpu")
    augmenter = TextAugmenter(TextAugmentConfig(enable_template=False, enable_synonym_replacement=False,
                                                max_variants=3), paraphrase_generator=lm.as_paraphrase_generator())
    pipe = MultiModalDetectionPipeline(
        clip, PipelineConfig(num_text_variants=3, retrieval_top_k=4, num_reference_images=2), retriever=retriever,
        device="cpu", text_augmenter=augmenter,
    )
    texts = ["a dog runs in the park", "two cats on a mat", "a red bus", "a man on a horse"]
    one = pipe.process_batch(images[:2], texts[:2])
    assert not one.errors and len(one.scores) == 2 and all(len(v) for v in one.variants)
    results = pipe.process_stream([(images[:2], texts[:2]), (images[2:], texts[2:])])
    assert len(results) == 2 and all(not r.errors for r in results)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_tiny_model_decodes_in_both_dtypes(dtype):
    cfg = dataclasses.replace(kl.KimiLinearConfig.tiny(), dtype=dtype)
    m = kl.KimiLinearModel(cfg, seed=1, tokenizer=WordTok(), max_new_tokens=8, device="cpu")
    toks = m.decode(m.prepare(PROMPTS, n_samples=2, shared_prefix=PARAPHRASE_PREFIX), temperature=0.8, seed=2)
    assert toks.shape == (4, 8) and m.last_decode_steps == 8


@pytest.mark.parametrize("path", ["tests/reference_kimi_linear.py", "perfbench/reference/kimi_linear.py"])
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse((Path(__file__).resolve().parents[1] / path).read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert not {m.split(".")[0] for m in names} & {"tvc_torch", "tvc", "jax", "flax"}, names
