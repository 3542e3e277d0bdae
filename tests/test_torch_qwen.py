"""tvc_torch's Qwen2 (``tvc_torch/models/qwen.py``) against the JAX package's
``tvc/models/qwen.py`` on ``QwenConfig.tiny()`` with the same weights
(``qwen_params_from_jax``): the full forward, greedy decodes token for
token (f32, int8 W8A8 and int8 weight-only "w8", its routing by the row
threshold), prefix-shared prefill, ``n_samples`` tiling,
early exit, constrained decoding, sampling properties and the int8 /
``decode_only`` trees. On the CPU the kernel wrappers compute their plain
versions."""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import tvc_torch.models.decoding as decoding
import tvc_torch.models.qwen as tq
from tvc.models import qwen as jq
from tvc_torch.core.kernels import decode_gqa_reference, w8_matmul_plain, w8_matmul_reference, w8a8_matmul_reference

PROMPTS = ["a dog runs in the park", "two cats on a mat near the window"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(jmodel, cfg, **kw):
    return tq.QwenModel(cfg, params=tq.qwen_params_from_jax(_np_tree(jmodel.params), cfg), device="cpu", **kw)


@pytest.fixture(scope="module")
def f32():
    """The JAX model (seed 0) and the port on its weights."""
    jm = jq.QwenModel(jq.QwenConfig.tiny(), seed=0, max_new_tokens=8)
    return jm, _port(jm, tq.QwenConfig.tiny(), max_new_tokens=8)


@pytest.fixture(scope="module")
def w8a8():
    """The JAX model quantized by quantize_weights_int8, quant_gemm="w8a8"
    (the decode's int8 GEMMs through the Pallas kernel in interpret
    mode), and the port on the same int8 weights."""
    jm = jq.QwenModel(dataclasses.replace(jq.QwenConfig.tiny(), quant_gemm="w8a8"), seed=0, max_new_tokens=8)
    jm.quantize_weights_int8()
    return jm, _port(jm, dataclasses.replace(tq.QwenConfig.tiny(), quant_gemm="w8a8"), max_new_tokens=8)


@pytest.fixture(scope="module")
def w8():
    """The JAX model quantized by quantize_weights_int8 with the default
    quant_gemm="w8" (weight-only Pallas kernels in interpret mode), and the
    port on the same int8 weights."""
    jm = jq.QwenModel(jq.QwenConfig.tiny(), seed=0, max_new_tokens=8)
    jm.quantize_weights_int8()
    return jm, _port(jm, tq.QwenConfig.tiny(), max_new_tokens=8)


class WordTok:
    """Word-level tokenizer without BOS / EOS, so a prompt split at a space
    is token-exact and the prefix-shared prefill engages."""

    def __init__(self, vocab_size=512, context_length=48):
        self.vocab_size, self.context_length, self.pad_id, self.eot_id = vocab_size, context_length, 0, vocab_size - 1

    def __call__(self, texts):
        out = np.full((len(texts), self.context_length), self.pad_id, np.int32)
        for i, t in enumerate(texts):
            ws = "".join(c if c.isalnum() else " " for c in t.lower()).split()
            ids = [1 + (tq._stable_seed(w) % (self.vocab_size - 3)) for w in ws][: self.context_length]
            out[i, : len(ids)] = ids
        return out

    def decode(self, ids):
        return " ".join(f"w{int(i)}" for i in ids if i not in (self.pad_id, self.eot_id))


def _module_inputs(B=2, T=8, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, 512, (B, T)).astype(np.int32)
    pos = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32)
    mask = np.where(np.tril(np.ones((T, T), bool)), 0.0, -np.inf).astype(np.float32)[None, None].repeat(B, 0)
    return tok, pos, mask


def test_full_forward_matches_jax(f32):
    jm, tm = f32
    tok, pos, mask = _module_inputs()
    gather = np.asarray([5, 7], np.int32)
    want, _ = jm.module.apply({"params": jm.params}, *map(jnp.asarray, (tok, pos, mask)))
    want_g, _ = jm.module.apply({"params": jm.params}, *map(jnp.asarray, (tok, pos, mask)),
                                gather_index=jnp.asarray(gather))
    targs = (torch.as_tensor(tok).long(), torch.as_tensor(pos).long(), torch.as_tensor(mask))
    got, _ = tm.module.apply(tm.params, *targs)
    got_g, _ = tm.module.apply(tm.params, *targs, gather_index=torch.as_tensor(gather).long())
    assert got.dtype == torch.float32 and got.shape == (2, 8, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=2e-5, rtol=0)


def test_module_cache_path_matches_jax(f32):
    """The S-major cached module path (one token at cache_index)."""
    jm, tm = f32
    tok, pos, mask = _module_inputs(B=2, T=1, seed=1)
    S = 6
    cache = np.random.default_rng(2).standard_normal((2, 2, 2, S, 2, 16)).astype(np.float32)  # [L, k|v, B, S, KV, Dh]
    full = np.zeros((2, 1, 1, S), np.float32)
    want, wc = jm.module.apply({"params": jm.params}, jnp.asarray(tok), jnp.asarray(pos + 3), jnp.asarray(full),
                               caches=[(jnp.asarray(c[0]), jnp.asarray(c[1])) for c in cache], cache_index=3)
    got, gc = tm.module.apply(tm.params, torch.as_tensor(tok).long(), torch.as_tensor(pos + 3).long(),
                              torch.as_tensor(full), caches=[(torch.as_tensor(c[0]), torch.as_tensor(c[1]))
                                                             for c in cache], cache_index=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    np.testing.assert_allclose(gc[1][0].numpy(), np.asarray(wc[1][0]), atol=2e-5, rtol=0)


def test_greedy_generate_matches_jax_f32(f32):
    jm, tm = f32
    assert tm.generate(PROMPTS, temperature=0.0) == jm.generate(PROMPTS, temperature=0.0)


def test_greedy_generate_matches_jax_w8a8(w8a8):
    """Same int8 weights on both sides; the activations' int8 quanta come
    from f32 values computed in another order, so a quantum may flip (as
    ROADMAP §3 records for CLIP) — none does on these prompts."""
    jm, tm = w8a8
    want = jm.generate(PROMPTS, temperature=0.0, n_samples=2)
    assert tm.generate(PROMPTS, temperature=0.0, n_samples=2) == want
    assert want[0] == want[1] and want[2] == want[3]


def test_quantize_weights_int8_matches_jax(f32):
    """int8 values equal; scales within one ulp (under jit XLA takes
    max|w| / 127 as a product with the reciprocal, the port divides)."""
    jm, tm = f32
    jq_params = jax.jit(lambda p: jax.tree_util.tree_map_with_path(jq._quantize_leaf, p))(jm.params)
    port = tq.QwenModel(tq.QwenConfig.tiny(), params=tm.params, device="cpu")
    port.quantize_weights_int8()
    want, got = tq._flatten(_np_tree(jq_params)), tq._flatten(port.params)
    assert want.keys() == got.keys()
    n_q = 0
    for name, leaf in got.items():
        if tq._is_q(leaf):
            n_q += 1
            np.testing.assert_array_equal(leaf["int8"].numpy(), want[name]["int8"])
            np.testing.assert_array_max_ulp(leaf["scale"].numpy(), want[name]["scale"], maxulp=1)
        else:
            np.testing.assert_array_equal(leaf.numpy(), want[name])
    assert n_q == 1 + 2 * 7  # the embedding and seven matrices a layer


def test_prefix_shared_prefill_matches_plain_and_jax():
    prompts = ["rewrite this sentence: a cat sat on the mat", "rewrite this sentence: two dogs run in a park today"]
    jm = jq.QwenModel(jq.QwenConfig.tiny(), seed=0, max_new_tokens=6, tokenizer=WordTok())
    tm = _port(jm, tq.QwenConfig.tiny(), max_new_tokens=6, tokenizer=WordTok())
    plain = tm.generate(prompts, temperature=0.0)
    pref = tm.generate(prompts, temperature=0.0, shared_prefix="rewrite this sentence:")
    assert tm._prefix_ok_cache == {"rewrite this sentence:": True}
    assert pref == plain
    assert pref == jm.generate(prompts, temperature=0.0, shared_prefix="rewrite this sentence:")
    tiled = tm.generate(prompts, temperature=0.0, n_samples=2, shared_prefix="rewrite this sentence:")
    assert tiled == [p for p in plain for _ in range(2)]


def test_prefix_fallback_with_the_hash_tokenizer(f32):
    """The hash tokenizer wraps every call in sot / eot, so no split is
    token-exact: the call falls back to plain prefill."""
    tm = f32[1]
    prompts = ["rewrite: a cat", "rewrite: a dog"]
    assert tm.generate(prompts, temperature=0.0, shared_prefix="rewrite:") == tm.generate(prompts, temperature=0.0)
    assert tm._prefix_ok_cache["rewrite:"] is False
    with pytest.raises(ValueError, match="not a prefix"):
        tm.generate(["other"], shared_prefix="rewrite:")


def test_n_samples_tiling_equals_replicated_prompts():
    cfg = dataclasses.replace(tq.QwenConfig.tiny(), tie_embeddings=False, quant_gemm="w8a8")
    m = tq.QwenModel(cfg, seed=0, max_new_tokens=4, init_int8=True, device="cpu")
    tiled = m.generate(PROMPTS, temperature=0.0, n_samples=3)
    assert tiled == m.generate([p for p in PROMPTS for _ in range(3)], temperature=0.0)
    outs = m.generate(PROMPTS, temperature=1.0, n_samples=4, seed=1)
    assert len(outs) == 8 and len(set(outs)) > 1


def test_chunked_decode_matches_single_chunk_and_exits_early(f32):
    tm = f32[1]
    with mock.patch.object(tq, "DECODE_CHUNK", 8):  # max_new == chunk: no early-exit checks
        plain = tm.generate(PROMPTS, temperature=0.8, seed=5, n_samples=2)
    assert tm.generate(PROMPTS, temperature=0.8, seed=5, n_samples=2) == plain
    # a mask allowing only EOT ends every chain at step 0: the loop stops
    # at the first check and the output is the full-width EOT fill
    eot = tm.tokenizer.eot_id
    mask = np.zeros(512, bool)
    mask[eot] = True
    steps = []
    rows = tm.decode(tm.prepare(["a dog runs"], token_mask=mask), 0.8, seed=1, on_logits=lambda i, lg: steps.append(i))
    assert steps == [0, 1, 2, 3] and rows.shape == (1, 8) and bool((rows == eot).all())
    assert tm.generate(["a dog runs"], temperature=0.8, seed=1, token_mask=mask) == [""]


def test_token_mask_emits_only_allowed_ids(f32):
    tm = f32[1]
    rng = np.random.default_rng(0)
    mask = np.zeros(512, bool)
    mask[rng.choice(512, size=128, replace=False)] = True
    mask[tm.tokenizer.eot_id] = True
    inp = tm.prepare(PROMPTS, token_mask=mask)
    assert inp.allowed.shape[0] == -(-int(mask.sum()) // 128) * 128 and inp.n_real == int(mask.sum())
    for temperature in (0.0, 0.8, 5.0):
        ids = tm.decode(inp, temperature, seed=2).numpy()
        assert mask[ids.reshape(-1)].all()
    free = tm.generate(PROMPTS, temperature=0.8, seed=3)
    assert tm.generate(PROMPTS, temperature=0.8, seed=3, token_mask=np.ones(512, bool)) == free
    with pytest.raises(ValueError):
        tm.generate(PROMPTS, token_mask=np.zeros(512, bool))


def test_sampling_properties(f32):
    """Reproducible per seed, every sampled id among its step's top 50,
    temperature <= 1e-4 the argmax."""
    tm = f32[1]
    inp = tm.prepare(PROMPTS, n_samples=3)
    logits = []
    a = tm.decode(inp, 0.9, seed=7, on_logits=lambda i, lg: logits.append(lg.clone()))
    assert torch.equal(a, tm.decode(inp, 0.9, seed=7))
    assert not torch.equal(a, tm.decode(inp, 0.9, seed=8))
    eot = tm.tokenizer.eot_id
    for i, lg in enumerate(logits):
        top = torch.topk(lg, 50, dim=-1).indices
        live = a[:, i] != eot
        assert bool((top[live] == a[live, i : i + 1]).any(-1).all())
    greedy = tm.decode(inp, 1e-5, seed=1)
    assert torch.equal(greedy, tm.decode(inp, 0.0, seed=2))
    logits.clear()
    g = tm.decode(inp, 0.0, seed=0, on_logits=lambda i, lg: logits.append(lg))
    assert all(torch.equal(g[:, i], lg.argmax(-1)) for i, lg in enumerate(logits) if not (g[:, i] == eot).any())


def test_init_int8_tree_matches_the_quantized_jax_tree():
    cfg_j = dataclasses.replace(jq.QwenConfig.tiny(), tie_embeddings=False)
    jm = jq.QwenModel(cfg_j, seed=0, max_new_tokens=4)
    jm.quantize_weights_int8()
    cfg = dataclasses.replace(tq.QwenConfig.tiny(), tie_embeddings=False, quant_gemm="w8a8")
    tm = tq.QwenModel(cfg, seed=0, max_new_tokens=4, init_int8=True, device="cpu")
    want, got = tq._flatten(_np_tree(jm.params)), tq._flatten(tm.params)
    assert want.keys() == got.keys()
    for name, leaf in got.items():
        if tq._is_q(leaf):
            assert leaf["int8"].dtype == torch.int8 and leaf["int8"].shape == want[name]["int8"].shape
            assert leaf["scale"].shape == want[name]["scale"].shape
        else:
            assert tuple(leaf.shape) == want[name].shape
    # the 0.02 N(0, 1) head: scales near 0.02 * 4.5 sigma / 127
    assert 3e-4 < float(tm.params["lm_head"]["kernel"]["scale"].mean()) < 1.5e-3


def test_decode_only_frees_the_layers():
    cfg = dataclasses.replace(tq.QwenConfig.tiny(), quant_gemm="w8a8")
    m = tq.QwenModel(cfg, seed=0, max_new_tokens=4, decode_only=True, device="cpu")
    out = m.generate(["a b c"], temperature=0.0)
    assert not any(k.startswith("layer_") for k in m.params)
    non_layer, stacked = m._decode_state()
    assert stacked["wqkv"].shape == (2, 64, 64 + 2 * 32) and stacked["wgu"].shape == (2, 64, 256)
    assert m.generate(["a b c"], temperature=0.0) == out  # the cached stacked tree serves
    m.quantize_weights_int8()
    with pytest.raises(RuntimeError, match="decode_only"):
        m.generate(["a b c"], temperature=0.0)


def test_params_swap_rebuilds_the_decode_state(f32):
    tm = f32[1]
    m = tq.QwenModel(tq.QwenConfig.tiny(), params=tm.params, device="cpu", max_new_tokens=4)
    out_a, state_a = m.generate(["a b c"], temperature=0.0), m._decode_state()
    m.params = tq.init_params(tq.QwenConfig.tiny(), seed=1, device="cpu")
    assert m._decode_state() is not state_a
    assert m.generate(["a b c"], temperature=0.0) != out_a


def test_what_is_not_ported_raises(f32, tmp_path):
    """The tensor-parallel decode is ported: over a one-rank ``model`` mesh
    it decodes the single-device tokens (two ranks:
    tests/test_torch_tp.py)."""
    from tvc_torch.parallel.launch import one_rank
    from tvc_torch.parallel.mesh import MeshConfig, create_mesh

    tm = f32[1]
    with one_rank(device="cpu", run_dir=str(tmp_path)):
        mesh = create_mesh(MeshConfig(axes=("model",)), device="cpu")
        tp = tq.QwenModel(tq.QwenConfig.tiny(), params=tm.params, max_new_tokens=8, mesh=mesh)
        assert tp.mesh is mesh and tp.device == tm.device
        assert tp.generate(PROMPTS, temperature=0.0) == tm.generate(PROMPTS, temperature=0.0)


def test_generate_async_and_the_paraphrase_entry_points(f32):
    tm = f32[1]
    texts = ["a dog runs in the park", "a red car on the street"]
    handle = tm.generate_paraphrases_batch_async(texts, 2, seed=3)
    assert callable(handle) and handle() == tm.generate_paraphrases_batch(texts, 2, seed=3)
    assert tm.generate_paraphrases_batch_async([], 2)() == []
    assert len(tm.generate_paraphrases("a cat sat on the mat", 3)) <= 3
    adapter = tm.as_paraphrase_generator()
    assert adapter.batch(texts, 2) == adapter.batch_async(texts, 2)()
    out = tm.translate(texts, "en", "de")
    assert len(out) == 2 and out == tm.as_translator()(texts, "en", "de")
    assert tq._stable_seed("abc") == jq._stable_seed("abc")


def test_ascii_token_mask_with_the_hash_tokenizer(f32):
    tm = f32[1]
    m = tm.ascii_token_mask()
    assert m.shape == (512,) and m.all() and m is tm.ascii_token_mask()


def _spies(gemm: str, rows: dict):
    """Plain versions in place of the decode's kernels, each call counted
    (and its activation rows recorded) under its name in ``rows``; the
    prefill attention and the fused norms counted too, the final norm
    where ``CausalDecoder`` calls it."""
    plain = w8a8_matmul_reference if gemm == "w8a8_matmul" else w8_matmul_plain

    def spy(name, fn):
        def f(x, *a):
            rows.setdefault(name, []).append(int(np.prod(x.shape[:-1])))
            return fn(x, *a)
        return f

    return [
        mock.patch.object(tq, gemm, spy(gemm, plain)),
        mock.patch.object(tq, gemm + "_stacked", spy(gemm + "_stacked", lambda x, w, s, l: plain(x, w[l], s[l]))),
        mock.patch.object(tq, "w8_matmul_reference", spy("w8_matmul_reference", w8_matmul_reference)),
        mock.patch.object(tq, "decode_gqa_attention_stacked",
                          spy("decode_gqa_attention_stacked", lambda q, k, v, mk, l: decode_gqa_reference(q, k[l], v[l], mk))),
        mock.patch.object(tq, "_gqa_attention", spy("_gqa_attention", tq._gqa_attention)),
        *[mock.patch.object(mod, n, spy(n, getattr(mod, n)))
          for mod in (tq, decoding) for n in chip_smoke.DECODE_FUSED if hasattr(mod, n)],
    ]


@pytest.mark.parametrize("quant_gemm,tied,max_rows", [("w8a8", False, 1024), ("w8a8", True, 1024), ("w8", False, 1024),
                                                      ("w8", True, 1024), ("w8", False, 8)])
def test_launch_formula_matches_the_decode(quant_gemm, tied, max_rows):
    """chip_smoke's expected launch counts, read off the code, equal the
    calls the decode makes (counted here on the CPU through the plain
    versions) on each route, the w8 one also with a row limit the suffix
    prefill and the decode steps exceed; and give 2,033 GEMMs and 448
    attentions at Qwen2-7B W8A8 and 1,904 weight-only GEMMs at Qwen2-1.5B
    w8 paraphrasing 192 captions x 5 (suffix prefill 192 x 32 rows: the
    dequant fallback); the fused elementwise kernels counted the same way
    (57 norms, 28 q|k|v epilogues and 28 SiLU-gated products a step); and
    the plain prefill attention (``_gqa_attention``, the benchmark's
    ``prefill_attention`` range) once a layer in each prefill."""
    cfg = dataclasses.replace(tq.QwenConfig.tiny(), tie_embeddings=tied, quant_gemm=quant_gemm)
    m = tq.QwenModel(cfg, seed=0, max_new_tokens=8, init_int8=True, tokenizer=WordTok(), device="cpu")
    gemm = f"{quant_gemm}_matmul"
    rows = {}
    texts = ["a cat sat on the mat", "two dogs"]
    # the decode routes by decoding's limit; the formula reads the one qwen.py re-exports
    with mock.patch.object(decoding, "W8_MAX_ROWS", max_rows), mock.patch.object(tq, "W8_MAX_ROWS", max_rows):
        for p in _spies(gemm, rows):
            p.start()
        try:
            m.generate_paraphrases_batch(texts, 3)
        finally:
            mock.patch.stopall()
        P = len(m._prefix_ids(tq.PARAPHRASE_PREFIX))
        T = m.prepare([tq.PARAPHRASE_PROMPT.format(text=t) for t in texts], 3, None, tq.PARAPHRASE_PREFIX).tokens.shape[1]
        want = chip_smoke.qwen_expected_launches(cfg, P, m.last_decode_steps, prompts=2, suffix_len=T, n_samples=3)
    assert P > 0 and m.last_decode_steps == 8
    n = {k: len(v) for k, v in rows.items()}
    assert n.get(gemm + "_stacked", 0) == want[gemm + "_stacked"]
    assert n.get(gemm, 0) + n.get(gemm + "_stacked", 0) == want[gemm]
    assert n["decode_gqa_attention_stacked"] == want["decode_gqa_attention_stacked"] == want["decode_gqa_attention"]
    assert {k: n[k] for k in chip_smoke.DECODE_FUSED} == {k: want[k] for k in chip_smoke.DECODE_FUSED}
    assert n["_gqa_attention"] == 2 * cfg.num_layers  # the prefix prefill and the suffix prefill
    # every GEMM of the decode went through the kernel or, above the row
    # limit under "w8", through the dequant fallback
    L, steps = cfg.num_layers, m.last_decode_steps
    total = 4 * L * (2 + steps) + (0 if tied else 1 + steps)
    assert n.get(gemm, 0) + n.get(gemm + "_stacked", 0) + n.get("w8_matmul_reference", 0) == total
    fallback = rows.get("w8_matmul_reference", [])
    assert all(r > max_rows for r in fallback) and (len(fallback) > 0) == (max_rows == 8)
    if quant_gemm == "w8":
        assert all(r <= max_rows for k in (gemm, gemm + "_stacked") for r in rows.get(k, []))
    big = chip_smoke.qwen_expected_launches(dataclasses.replace(tq.QwenConfig.qwen2_7b(), quant_gemm="w8a8"), 15, 16)
    fused = {"rmsnorm": 18, "add_rmsnorm": 1007, "qkv_rope_cache": 448, "silu_mul": 504}
    assert big == {"w8a8_matmul": 2033, "w8a8_matmul_stacked": 2016,
                   "decode_gqa_attention": 448, "decode_gqa_attention_stacked": 448, **fused}
    small = chip_smoke.qwen_expected_launches(tq.QwenConfig.qwen2_1_5b(), 15, 16, prompts=192, suffix_len=32,
                                              n_samples=5)
    assert small == {"w8_matmul": 1904, "w8_matmul_stacked": 1904,
                     "decode_gqa_attention": 448, "decode_gqa_attention_stacked": 448, **fused}


def test_greedy_generate_matches_jax_w8(w8):
    """Weight-only int8: the same int8 weights on both sides, the products
    summed in f32 (the kernel's function on the CPU) on every GEMM."""
    jm, tm = w8
    want = jm.generate(PROMPTS, temperature=0.0, n_samples=2)
    assert tm.generate(PROMPTS, temperature=0.0, n_samples=2) == want
    assert want[0] == want[1] and want[2] == want[3]


def test_greedy_generate_matches_jax_w8_after_cast_params_bf16(f32):
    """cast_params_bf16 then quantize_weights_int8 (the genref order), each
    side quantizing its own bf16 tree: the int8 values agree within one
    quantum (a scale one ulp apart, as in the f32 test above, can move a
    bf16 weight that lies on a .5 boundary) and the greedy tokens are
    equal."""
    jm = jq.QwenModel(jq.QwenConfig.tiny(), params=f32[0].params, max_new_tokens=8, cast_params_bf16=True)
    jm.quantize_weights_int8()
    tm = tq.QwenModel(tq.QwenConfig.tiny(), params=f32[1].params, device="cpu", max_new_tokens=8,
                      cast_params_bf16=True)
    tm.quantize_weights_int8()
    want_tree, got_tree = tq._flatten(_np_tree(jm.params)), tq._flatten(tm.params)
    for name, leaf in got_tree.items():
        if tq._is_q(leaf):
            d = np.abs(leaf["int8"].numpy().astype(int) - want_tree[name]["int8"].astype(int))
            assert d.max() <= 1 and d.mean() < 1e-2, name
    assert tm.generate(PROMPTS, temperature=0.0) == jm.generate(PROMPTS, temperature=0.0)


def test_w8_routes_by_the_row_threshold():
    """130 prompts: the suffix prefill block (130 x 8 rows) exceeds
    W8_MAX_ROWS and dequantizes, then matmuls (w8_matmul_reference), the
    decode steps (130 rows) take the kernel; the greedy tokens equal the
    JAX package's, which routes the same way. The embedding stays f32
    here: under jit XLA's CPU backend computes the JAX package's bf16
    dequant of a tied int8 table (``int8 * scale`` in bf16) in f32 without
    the bf16 rounding, which the port keeps (ROADMAP §3)."""
    texts = [f"caption number {i} of a dog" for i in range(130)]
    jm = jq.QwenModel(jq.QwenConfig.tiny(), seed=0, max_new_tokens=8)
    jm.quantize_weights_int8(include_embed=False)
    tm = _port(jm, tq.QwenConfig.tiny(), max_new_tokens=8)
    rows = {}
    for p in _spies("w8_matmul", rows):
        p.start()
    try:
        got = tm.generate(texts, temperature=0.0)
    finally:
        mock.patch.stopall()
    assert got == jm.generate(texts, temperature=0.0)
    L = tq.QwenConfig.tiny().num_layers
    assert rows["w8_matmul_reference"] == [130 * 8] * 4 * L
    assert rows["w8_matmul_stacked"] == [130] * 4 * L * 8 and "w8_matmul" not in rows
    assert all(r <= tq.W8_MAX_ROWS < 130 * 8 for r in rows["w8_matmul_stacked"])


def test_chip_smoke_captions_follow_the_jax_loader():
    from tvc.data.loaders import load_coco_captions

    assert chip_smoke.coco_captions(192) == [c for _, c in load_coco_captions()[:192]]


@pytest.mark.parametrize("init_int8", [False, True])
def test_cast_params_bf16_matches_jax(f32, init_int8):
    """bf16 matrix storage (norms and biases stay f32), computing in the
    config's f32: the same greedy tokens as the JAX package's cast tree.
    Given parameters are cast whatever ``init_int8`` says, as the JAX
    package casts them (it only initializes without them)."""
    jm = jq.QwenModel(jq.QwenConfig.tiny(), params=f32[0].params, max_new_tokens=8, cast_params_bf16=True,
                      init_int8=init_int8)
    tm = tq.QwenModel(tq.QwenConfig.tiny(), params=f32[1].params, device="cpu", max_new_tokens=8,
                      cast_params_bf16=True, init_int8=init_int8)
    assert tm.params["layer_0"]["attn"]["q"]["kernel"].dtype == torch.bfloat16
    assert tm.params["layer_0"]["attn"]["q"]["bias"].dtype == torch.float32
    assert tm.generate(PROMPTS, temperature=0.0) == jm.generate(PROMPTS, temperature=0.0)
