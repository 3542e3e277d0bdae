"""The Kimi-Linear cell's reference, weights, tokenizer and work model
against the program and against counts worked out by hand, at tiny widths
on the CPU (the published configuration's keys, cut)."""

import numpy as np
import pytest
import torch

from perfbench import common, traffic, weights_kimi, work_kda
from perfbench.drivers.pipeline_stream_kimi import decode_routes, logged_routes, routes_of
from perfbench.reference import kimi_linear as kref
from perfbench.reference import qwen2 as qref

CELL_CONFIG = "tvc-kimi-linear-48b-w8"
TINY = dict(hidden_size=64, intermediate_size=96, moe_intermediate_size=32, num_hidden_layers=4,
            num_attention_heads=4, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            num_experts=16, num_experts_per_token=4)  # the vocabulary kept: it picks the tokenizer


def _tiny_cfg():
    c = dict(common.config(CELL_CONFIG))
    c.update(TINY)
    c["linear_attn_config"] = dict(c["linear_attn_config"], kda_layers=[1, 2, 3], full_attn_layers=[4], num_heads=2,
                                   head_dim=16)
    return c


def test_the_configuration_holds_the_published_numbers():
    c = common.config(CELL_CONFIG)
    la = c["linear_attn_config"]
    assert (c["hidden_size"], c["num_hidden_layers"], c["num_experts"], c["vocab_size"]) == (2304, 27, 256, 163840)
    assert len(la["kda_layers"]) == 20 and la["full_attn_layers"] == [4, 8, 12, 16, 20, 24, 27]
    assert c["reduced"] == [] and len(c["assumed"]) >= 5


def test_kimi_bpe_equals_the_programs():
    from tvc_torch.models.tokenizer import KIMI_LINEAR_BOS, KIMI_LINEAR_EOS, get_tokenizer

    ours, theirs = kref.KimiQwenBPE(), get_tokenizer(163840, 512)
    assert (kref.BOS, kref.EOS) == (KIMI_LINEAR_BOS, KIMI_LINEAR_EOS) == (theirs.bos_id, theirs.eot_id)
    texts = [qref.PARAPHRASE_PROMPT.format(text=t) for t in traffic.distinct_captions()[:100]]
    for t, row in zip(texts, theirs(texts)):
        ids = ours.prompt(t)
        assert list(row[: len(ids)]) == ids and row[len(ids)] == theirs.pad_id
        assert max(ids[1:]) < 151643  # the BPE's own ids: BOS and EOS lie above them


def test_the_weights_have_the_programs_names_and_shapes():
    from tvc_torch.models import kimi_linear as kl

    cfg = common.config(CELL_CONFIG)
    prog = kl.published_config(cfg)
    for part in weights_kimi.parts(cfg):
        mine = {n: s for n, s, *_ in weights_kimi.part_shapes(cfg, part)}
        theirs = {n: s for n, s, *_ in kl.part_shapes(prog, part)}
        assert mine == theirs, part


@pytest.fixture(scope="module")
def tiny():
    from tvc_torch.models import kimi_linear as kl

    cfg = _tiny_cfg()
    parts = {p: weights_kimi.part(cfg, 5, p, "cpu") for p in weights_kimi.parts(cfg)}
    prog = kl.KimiLinearModel(kl.published_config(cfg, max_seq_len=128, dtype=torch.float32), params=parts.get,
                              max_new_tokens=6, device="cpu")
    return cfg, parts, prog


def test_reference_equals_the_programs_teacher_forced_logits(tiny):
    """The program in f32 with w8 weights, teacher-forced, against the
    reference's full forward: the two sum the same products in other
    orders (~1e-7 relative a sum), so the logits agree to 2e-5 of unit
    scale; a wrong tap, gate, route or norm moves them by O(1e-1)."""
    from tvc_torch.models.decoding import PARAPHRASE_PREFIX

    cfg, parts, prog = tiny
    texts = traffic.distinct_captions()[:3]
    prompts = [qref.PARAPHRASE_PROMPT.format(text=t) for t in texts]
    inp = prog.prepare(prompts, 1, None, PARAPHRASE_PREFIX)
    forced = torch.randint(0, 150000, (6, 3), generator=torch.Generator().manual_seed(1))
    got = []
    prog.decode(inp, forced=forced, on_logits=lambda i, lg: got.append(lg.clone()))
    bpe = kref.KimiQwenBPE()
    seqs = [bpe.prompt(p) + forced[:-1, r].tolist() for r, p in enumerate(prompts)]
    want = kref.KimiLinear(cfg, parts.get).logits(seqs)
    for r, p in enumerate(prompts):
        n = len(bpe.prompt(p))
        torch.testing.assert_close(torch.stack([g[r] for g in got]), want[r][n - 1 :], atol=2e-5, rtol=0)


def test_routes_read_off_the_program_are_the_references_own_in_f32(tiny):
    """In f32 the program and the reference choose alike: routed through
    the program's recorded choices the reference gives its own logits and
    a route gap of 0; the int4 control's choices lie far below."""
    cfg, parts, prog = tiny
    texts = traffic.distinct_captions()[3:5]
    served = torch.randint(0, 150000, (4, 6), generator=torch.Generator().manual_seed(2))
    routes = decode_routes(prog, texts, 2, served, [1, 2])
    bpe = kref.KimiQwenBPE()
    seqs = [bpe.prompt(qref.PARAPHRASE_PROMPT.format(text=texts[r // 2])) + served[r, :5].tolist() for r in (1, 2)]
    own, follow = kref.KimiLinear(cfg, parts.get), kref.KimiLinear(cfg, parts.get)
    lo = own.logits(seqs)
    lf = follow.logits(seqs, routes)
    assert follow.route_gap == 0.0 and all(torch.equal(a, b) for a, b in zip(lo, lf))
    low = kref.KimiLinear(cfg, parts.get, bits=4)
    low.logits(seqs)
    ctl = kref.KimiLinear(cfg, parts.get)
    ctl.logits(seqs, [{li: r[j] for li, r in low.routes.items()} for j in range(2)])
    assert ctl.route_gap > 0.01


def test_kda_work_by_hand():
    # a decode step: 480 rows, one token, 32 heads of 128
    ops, nbytes = work_kda.recurrent(480, 1, 32, 128)
    assert ops == {"f32": 7.0 * 480 * 32 * 128 * 128}
    assert nbytes == 2 * 4 * 128 * 128 * 32 * 480 + 480 * 32 * (4 * 4 * 128 + 4 + 2 * 128)
    assert nbytes / 3.35e12 == pytest.approx(6.07e-4, rel=1e-2)  # ~0.6 ms a layer, bytes bound
    # two decodes over 2 KDA layers: prefixes of 14 and 0 tokens, suffixes of 8 and 5 real tokens
    suffix = work_kda.suffix_tokens([(14, 22), (0, 5)])
    calls = [(1, 14, False), (3, 4, True), (1, 14, False), (3, 4, True), (6, 1, False), (6, 1, False),
             (2, 3, True), (2, 3, True)]
    assert suffix == [8, 5] and work_kda.call_tokens(calls, suffix, 2) == [14, 8, 14, 8, 6, 6, 5, 5]
    with pytest.raises(ValueError):
        work_kda.call_tokens(calls[:-1], suffix, 2)
    ops, nbytes = work_kda.gated_norm(480, 1, 32, 128)
    assert nbytes == 3 * 2 * 480 * 4096 + 4 * 128
    ops, nbytes = work_kda.prepare(480, 1, 32, 3 * 4096, 4)
    assert nbytes == 480 * (2 * (12288 + 32) + 2 * 4096 + 4 * (4 * 4096 + 32)) + 2 * 2 * 3 * 12288 * 480 \
        + 4 * (12288 * 4 + 32 + 4096)
    assert np.isclose(ops["f32"], 480 * (2 * 4 * 12288 + 4 * 12288 + 8 * 4096))


def test_routes_logged_in_a_sampled_decode_equal_its_forced_rerun(tiny):
    """The ids the driver keeps from a timed (sampled) decode, sliced per
    row by ``routes_of``, equal those of the same decode run again with
    its served tokens forced (f32 on the CPU: the same choices), at every
    position the reference reads (the prompt and each served token but
    the last)."""
    from tvc_torch.models.decoding import PARAPHRASE_PREFIX, PARAPHRASE_PROMPT

    cfg, parts, prog = tiny
    texts = traffic.distinct_captions()[5:8]
    inp = prog.prepare([PARAPHRASE_PROMPT.format(text=t) for t in texts], 2, None, PARAPHRASE_PREFIX)
    calls = []
    with logged_routes(calls):
        served = prog.decode(inp, temperature=0.8, seed=4)
    rows = [0, 3, 5]
    B, T = inp.tokens.shape
    timed = routes_of(calls, prog.config, inp.P, B, T, inp.lengths.tolist(), 2, rows)
    again = decode_routes(prog, texts, 2, served, rows)
    lengths = inp.lengths.tolist()
    for r, a, b in zip(rows, timed, again):
        n = lengths[r // 2] + len(qref.served_positions(served[r].tolist(), kref.EOS)) - 1
        assert sorted(a) == sorted(b) == list(range(cfg["first_k_dense_replace"], cfg["num_hidden_layers"]))
        for li in a:
            assert a[li].shape[0] >= n and torch.equal(a[li][:n], b[li][:n])
