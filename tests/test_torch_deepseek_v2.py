"""tvc_torch's DeepSeek-V2 (``tvc_torch/models/deepseek_v2.py``) against the
plain reference ``tests/reference_deepseek_v2.py`` on ``DeepseekV2Config.tiny()``
in f32 with w8 weights: the prefix-shared prefill and the absorbed decode
through the latent cache, teacher forced, against the reference's full
forward; absorbed against decompressed MLA; the routed top-k sets; the
grouped expert GEMM's plain version; the YaRN tables at the published
widths; the cut BPE; the checkpoint name map; ``process_stream`` with the
tiny model as full TVC's paraphraser. On the CPU the kernel wrappers compute
their plain versions and launch nothing."""

import contextlib
import gzip
import json
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import tests.reference_deepseek_v2 as ref
import tvc_torch.models.decoding as decoding
import tvc_torch.models.deepseek_v2 as ds
from tvc_torch.core.kernels import launch_counts, mla_decode_attention, moe_w8_grouped_gemm, moe_w8_grouped_reference
from tvc_torch.models.decoding import PARAPHRASE_PREFIX, PARAPHRASE_PROMPT, _stable_seed
from tvc_torch.utils import tracing

PROMPTS = [PARAPHRASE_PROMPT.format(text=t) for t in ("a dog runs in the park", "two cats on a mat near the window")]
CAPTIONS = Path(__file__).resolve().parents[1] / "perfbench" / "data" / "coco_captions_val2017.json.gz"


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


def published(cfg: ds.DeepseekV2Config) -> dict:
    """A configuration's numbers under the published ``config.json`` keys."""
    return {
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size, "intermediate_size": cfg.intermediate_size,
        "moe_intermediate_size": cfg.moe_intermediate_size, "num_hidden_layers": cfg.num_layers,
        "first_k_dense_replace": cfg.first_k_dense, "num_attention_heads": cfg.num_heads,
        "kv_lora_rank": cfg.kv_lora_rank, "qk_nope_head_dim": cfg.qk_nope_head_dim,
        "qk_rope_head_dim": cfg.qk_rope_head_dim, "v_head_dim": cfg.v_head_dim,
        "n_routed_experts": cfg.n_routed_experts, "n_shared_experts": cfg.n_shared_experts,
        "num_experts_per_tok": cfg.num_experts_per_tok, "routed_scaling_factor": cfg.routed_scaling_factor,
        "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_eps,
        "rope_scaling": {"factor": cfg.rope_factor, "original_max_position_embeddings": cfg.rope_original_max_positions,
                         "beta_fast": cfg.rope_beta_fast, "beta_slow": cfg.rope_beta_slow,
                         "mscale": cfg.rope_mscale, "mscale_all_dim": cfg.rope_mscale_all_dim, "type": "yarn"},
    }


@pytest.fixture(scope="module")
def tiny():
    """Seeded f32 weights (one draw a part), the program on them (w8) and
    the reference on the same weights."""
    cfg = ds.DeepseekV2Config.tiny()
    gen = torch.Generator().manual_seed(3)
    weights = {}
    for part in ds.part_names(cfg):
        weights.update(ds.draw_part(cfg, part, gen, "cpu"))
    model = ds.DeepseekV2Model(cfg, params=weights, tokenizer=WordTok(), max_new_tokens=8, device="cpu")

    def part(name):
        return {n: weights[n] for n, *_ in ds.part_shapes(cfg, name)}

    return cfg, model, part


def test_prefix_prefill_then_latent_decode_matches_reference(tiny):
    cfg, m, part = tiny
    inp = m.prepare(PROMPTS, n_samples=2, shared_prefix=PARAPHRASE_PREFIX)
    assert inp.P > 0  # the prefix-shared prefill engaged
    steps = 6
    forced = torch.as_tensor(np.random.default_rng(0).integers(1, 500, (steps, 4)))
    seen = {}
    before = launch_counts()
    m.decode(inp, forced=forced, on_logits=lambda i, lg: seen.__setitem__(i, lg.clone()))
    assert launch_counts() == before  # CPU tensors: the plain versions, no kernel
    lengths = inp.lengths.tolist()
    prompt_ids = [np.concatenate([inp.prefix.numpy(), inp.tokens[j].numpy()])[: lengths[j]].tolist() for j in range(2)]
    seqs = [prompt_ids[j // 2] + forced[:, j].tolist()[: steps - 1] for j in range(4)]
    want = ref.DeepseekV2(published(cfg), part).logits(seqs)
    for j in range(4):
        n = lengths[j // 2]
        got = torch.stack([seen[i][j] for i in range(steps)])
        torch.testing.assert_close(got, want[j][n - 1 : n - 1 + steps], atol=2e-5, rtol=0)


def test_absorbed_mla_equals_decompressed(tiny):
    """One position against a cache of 9 slots (6 of them valid), the
    latent kernel's absorbed form against the decompressed one."""
    cfg, m, _ = tiny
    _, layers = m._decode_state()
    B, S, l = 3, 9, 1
    g = torch.Generator().manual_seed(5)
    cache = torch.randn((cfg.num_layers, B, S, cfg.latent_width), generator=g)
    x = torch.randn((B, 1, cfg.hidden_size), generator=g)
    pos = torch.full((B, 1), 6)
    cos, sin = ds.yarn_tables(pos, cfg, m._inv_freq)
    valid = torch.arange(S)[None] <= torch.tensor([6, 4, 6])[:, None]
    mask = torch.zeros((B, S)).masked_fill(~valid, float("-inf"))
    ca, cd = cache.clone(), cache.clone()
    absorbed = m._attention(layers[l], l, x, cos, sin, mask, ca, 6, 0, absorbed=True)
    full = m._attention(layers[l], l, x, cos, sin, mask[:, None, None], cd, 6, 6, absorbed=False)
    torch.testing.assert_close(ca, cd, atol=0, rtol=0)
    torch.testing.assert_close(absorbed, full, atol=2e-6, rtol=1e-5)


def test_routed_top_k_sets_match_reference(tiny):
    """Each prompt's prefill routes, layer by layer, against the
    reference's, wherever its k-th and (k+1)-th probabilities are apart."""
    cfg, m, part = tiny
    got, route = [], ds.moe_route

    def spy(logits, x, k, counts=None):
        out = route(logits, x, k, counts)
        if x.shape[0] > 1:  # the prefill's, not the step's
            got.append(out[1])
        return out

    seqs = []
    with mock.patch.object(ds, "moe_route", spy):
        for p in PROMPTS:
            inp = m.prepare([p])
            seqs.append(inp.tokens[0, : int(inp.lengths[0])].tolist())
            m.decode(inp, forced=torch.full((1, 1), 5))
    rf = ref.DeepseekV2(published(cfg), part)
    rf.logits(seqs)
    n_moe = cfg.n_moe_layers
    assert len(got) == n_moe * len(seqs)
    for j, s in enumerate(seqs):
        for li in range(n_moe):
            ref_topi, ref_probs = rf.routes[li + cfg.first_k_dense][j]
            assert ref.route_agreement(got[j * n_moe + li][: len(s)], ref_topi, ref_probs) is None


@pytest.mark.parametrize("counts", [[3, 0, 5, 1, 7], [0, 0, 16, 0, 0]], ids=["one-empty", "one-has-all"])
def test_grouped_reference_matches_a_loop_over_experts(counts):
    g = torch.Generator().manual_seed(1)
    E, K, N = len(counts), 64, 48
    M = sum(counts)
    x = torch.randn((M, K), generator=g)
    w = torch.randint(-127, 128, (E, K, N), generator=g, dtype=torch.int8)
    s = torch.rand((E, N), generator=g) * 0.01
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32)
    got = moe_w8_grouped_gemm(x, w, s, offsets)
    assert torch.equal(got, moe_w8_grouped_reference(x, w, s, offsets))
    o = offsets.tolist()
    for e in range(E):
        want = (x[o[e] : o[e + 1]] @ w[e].float()) * s[e]
        torch.testing.assert_close(got[o[e] : o[e + 1]], want, atol=1e-5, rtol=1e-6)


def test_latent_attention_plain_path_is_a_softmax_over_the_latents():
    g = torch.Generator().manual_seed(2)
    B, H, S = 2, 16, 5
    q_lat, q_pe = torch.randn((B, H, 512), generator=g), torch.randn((B, H, 64), generator=g)
    cache = torch.randn((2, B, S, 576), generator=g)
    mask = torch.zeros((B, S))
    mask[1, 3:] = float("-inf")
    out = mla_decode_attention(q_lat, q_pe, cache, mask, 1, 0.1)
    for b in range(B):
        n = 5 if b == 0 else 3
        c = cache[1, b, :n]
        p = torch.softmax((q_lat[b] @ c[:, :512].T + q_pe[b] @ c[:, 512:].T) * 0.1, dim=-1)
        torch.testing.assert_close(out[b], p @ c[:, :512], atol=1e-5, rtol=1e-5)


def test_yarn_tables_at_the_published_widths_match_the_reference():
    cfg = ds.DeepseekV2Config.deepseek_v2_lite()
    got = ds.yarn_inv_freq(cfg)
    assert got.shape == (32,)
    torch.testing.assert_close(got, ref.yarn_inv_freq(published(cfg)), atol=0, rtol=0)
    extra = 1.0 / (10000.0 ** (torch.arange(0, 64, 2, dtype=torch.float32) / 64))
    torch.testing.assert_close(got[:10], extra[:10], atol=0, rtol=0)  # below the ramp: unscaled
    torch.testing.assert_close(got[23:], extra[23:] / 40, atol=0, rtol=1e-6)  # above it: interpolated
    assert cfg.softmax_scale == pytest.approx(192 ** -0.5 * (0.1 * 0.707 * np.log(40) + 1) ** 2, rel=1e-12)
    # the rotation of interleaved pairs at positions far apart, against the reference's
    rf = ref.DeepseekV2(published(cfg), lambda name: {})
    x = torch.randn((4, 3, 64), generator=torch.Generator().manual_seed(4))
    pos = torch.tensor([0, 7, 511, 4096])
    cos, sin = ds.yarn_tables(pos[None], cfg, got)
    torch.testing.assert_close(ds.rope_interleaved(x[None], cos, sin)[0], rf.rope(x, pos), atol=2e-6, rtol=0)


def test_cut_bpe_stays_below_100000_and_round_trips_captions():
    from tvc_torch.models.tokenizer import DEEPSEEK_V2_BOS, DEEPSEEK_V2_EOS, get_tokenizer

    tok = get_tokenizer(vocab_size=102400, context_length=96)
    caps = [c for _, c in json.load(gzip.open(CAPTIONS))[::25] if c.isascii()]
    rows = tok(caps)
    assert (rows < DEEPSEEK_V2_BOS).sum() + (rows == DEEPSEEK_V2_BOS).sum() + (rows == DEEPSEEK_V2_EOS).sum() \
        == rows.size
    assert (rows[:, 0] == DEEPSEEK_V2_BOS).all()
    assert tok.decode_batch(rows[:, 1:].tolist()) == caps
    pre, suf = tok([PARAPHRASE_PREFIX])[0], tok.without_bos([" a dog\nRewrite:"])[0]
    whole = tok([PARAPHRASE_PREFIX + " a dog\nRewrite:"])[0]
    n_pre, n_suf = int((pre != tok.pad_id).sum()), int((suf != tok.pad_id).sum())
    assert whole[: n_pre + n_suf].tolist() == pre[:n_pre].tolist() + suf[:n_suf].tolist()


def test_checkpoint_name_map_builds_the_same_model(tiny, monkeypatch):
    from tvc_torch.models import loaders

    cfg, m, part = tiny
    shapes = loaders.deepseek_v2_state_dict_shapes(cfg)
    rng = np.random.default_rng(0)
    sd = {k: rng.standard_normal(s).astype(np.float32) * 0.1 for k, s in shapes.items()}
    conv = loaders.convert_deepseek_v2_state_dict(sd, cfg)
    want = {n: s for p in ds.part_names(cfg) for n, s, *_ in ds.part_shapes(cfg, p)}
    assert {k: v.shape for k, v in conv.items()} == want
    e3 = sd["model.layers.2.mlp.experts.3.up_proj.weight"]
    np.testing.assert_array_equal(conv["layer_2.moe.experts.gate_up.kernel"][3][:, cfg.moe_intermediate_size:], e3.T)
    np.testing.assert_array_equal(conv["layer_1.moe.router.kernel"], sd["model.layers.1.mlp.gate.weight"].T)
    monkeypatch.setattr(loaders, "load_state_dict", lambda path: sd)
    model = loaders.load_deepseek_v2_weights(cfg, path=str(CAPTIONS), device="cpu", tokenizer=WordTok(),
                                             max_new_tokens=4)
    direct = ds.DeepseekV2Model(cfg, params={k: torch.as_tensor(v) for k, v in conv.items()}, tokenizer=WordTok(),
                                max_new_tokens=4, device="cpu")
    assert model.generate(PROMPTS, temperature=0.0) == direct.generate(PROMPTS, temperature=0.0)
    monkeypatch.delenv("TVC_DEEPSEEK_V2_WEIGHTS", raising=False)
    assert loaders.load_deepseek_v2_weights(cfg, device="cpu") is None


def test_routing_counters_are_read_back_with_the_tokens(tiny):
    cfg, m, _ = tiny
    before = tracing.counters()
    handle = m.generate_async(PROMPTS, temperature=0.8, seed=3, n_samples=2, shared_prefix=PARAPHRASE_PREFIX)
    mid = tracing.counters()
    assert {k: mid.get(k, 0) for k in ("moe.assignments", "moe.layer_steps")} == \
        {k: before.get(k, 0) for k in ("moe.assignments", "moe.layer_steps")}
    handle()
    after = tracing.counters()
    steps = m.last_decode_steps
    d = {k: after.get(k, 0) - before.get(k, 0) for k in ("moe.assignments", "moe.rows_max", "moe.layer_steps")}
    assert d["moe.layer_steps"] == steps * cfg.n_moe_layers
    assert d["moe.assignments"] == steps * cfg.n_moe_layers * 4 * cfg.num_experts_per_tok
    assert d["moe.layer_steps"] * 4 * cfg.num_experts_per_tok / cfg.n_routed_experts <= d["moe.rows_max"] <= \
        d["moe.layer_steps"] * 4


@pytest.mark.parametrize("max_rows", [1024, 4, 2])
def test_chip_smoke_step_launch_formula_matches_the_decode(tiny, max_rows):
    """chip_smoke's launches of one decode step, read off the code, equal
    the calls one step makes to the wrappers (spied on the CPU, where they
    compute their plain versions), also under a row limit the step's rows
    exceed; and give 109 w8 GEMMs, 52 grouped GEMMs, 27 latent attentions,
    1 norm, 54 norms after a residual add, 53 SiLU-gated products, 27 q|kv_a
    epilogues and output scales, 26 routings and combines a step at
    DeepSeek-V2-Lite's 960 rows. The names the
    benchmark's ranges wrap are called too: ``_moe`` once a MoE layer of a
    step, and ``w8_matmul_reference`` in a prefill above the row limit
    (4: the step's 4 rows take the kernel, the prefill's blocks do not)."""
    import chip_smoke

    cfg, m, _ = tiny
    names = ("w8_matmul", "moe_w8_grouped_gemm", "mla_decode_attention", "rmsnorm", "add_rmsnorm", "silu_mul",
             *chip_smoke.DSV2_FUSED)
    calls, at = dict.fromkeys(names + ("w8_matmul_reference", "_moe"), 0), {}

    def spy(name, fn):
        def f(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return f

    inp = m.prepare(PROMPTS, n_samples=2, shared_prefix=PARAPHRASE_PREFIX)
    with contextlib.ExitStack() as stack:
        # the decode routes by decoding's limit; the formula reads the one deepseek_v2.py re-exports
        stack.enter_context(mock.patch.object(decoding, "W8_MAX_ROWS", max_rows))
        stack.enter_context(mock.patch.object(ds, "W8_MAX_ROWS", max_rows))
        for mod in (ds, decoding):  # the final norm is CausalDecoder's
            for n in names + ("w8_matmul_reference",):
                if hasattr(mod, n):
                    stack.enter_context(mock.patch.object(mod, n, spy(n, getattr(mod, n))))
        stack.enter_context(mock.patch.object(ds.DeepseekV2Model, "_moe", spy("_moe", ds.DeepseekV2Model._moe)))
        m.decode(inp, forced=torch.full((3, 4), 5), on_logits=lambda i, lg: at.__setitem__(i, dict(calls)))
        want = chip_smoke.dsv2_step_launches(cfg, 4)
    step = {n: at[2][n] - at[1][n] for n in calls}
    assert {n: step[n] for n in names} == want
    assert want["w8_matmul"] == (0 if max_rows < 4 else 4 * cfg.num_layers + 1)
    assert step["_moe"] == cfg.n_moe_layers
    assert step["w8_matmul_reference"] == 4 * cfg.num_layers + 1 - want["w8_matmul"]
    prefill_rows = max(inp.P, inp.tokens.numel())
    assert (at[0]["w8_matmul_reference"] > 0) == (max_rows < prefill_rows) and prefill_rows > 4
    assert chip_smoke.dsv2_step_launches(ds.DeepseekV2Config.deepseek_v2_lite(), 960) == \
        {"w8_matmul": 109, "moe_w8_grouped_gemm": 52, "mla_decode_attention": 27, "rmsnorm": 1, "add_rmsnorm": 54,
         "silu_mul": 53, "mla_rope_cache": 27, "mla_out": 27, "moe_route": 26, "moe_combine": 26}


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
    lm = ds.DeepseekV2Model(ds.DeepseekV2Config.tiny(), seed=0, max_new_tokens=8, device="cpu")
    pipe = MultiModalDetectionPipeline(
        clip, PipelineConfig(num_text_variants=3, retrieval_top_k=4, num_reference_images=2), retriever=retriever,
        device="cpu",
        # the paraphrases alone (no WordNet synonyms, whose corpus takes seconds to load)
        text_augmenter=TextAugmenter(TextAugmentConfig(enable_template=False, enable_synonym_replacement=False,
                                                       max_variants=3),
                                     paraphrase_generator=lm.as_paraphrase_generator()),
    )
    texts = ["a dog runs in the park", "two cats on a mat", "a red bus", "a man on a horse"]
    t0 = tracing.RECORDER.spans()[-1].t1 if tracing.RECORDER.spans() else 0
    results = pipe.process_stream([(images[:2], texts[:2]), (images[2:], texts[2:])])
    assert len(results) == 2 and all(not r.errors for r in results)
    assert all(len(r.scores) == 2 for r in results)
    names = {s.name for s in tracing.spans(since_ns=t0)}
    assert {"dsv2.prepare", "dsv2.prefill", "dsv2.decode_step", "dsv2.readback"} <= names


@pytest.mark.parametrize("path", ["tests/reference_deepseek_v2.py", "perfbench/reference/deepseek_v2.py"])
def test_reference_imports_nothing_of_the_program(path):
    import ast

    tree = ast.parse((Path(__file__).resolve().parents[1] / path).read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert not {m.split(".")[0] for m in names} & {"tvc_torch", "tvc", "jax", "flax"}, names
