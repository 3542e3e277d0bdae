"""The Nemotron-H cell's reference, weights, tokenizer and work model
against the program and against counts worked out by hand, at tiny widths
on the CPU (the published configuration's keys, cut)."""

import pytest
import torch

from perfbench import common, traffic, weights_nemotron, work_ssm
from perfbench.drivers.pipeline_stream_kimi import decode_routes
from perfbench.reference import nemotron_h as nref
from perfbench.reference import qwen2 as qref

CELL_CONFIG = "tvc-nemotron3-nano-30b-w8"
#: the published config.json's numbers (the catalog's NVIDIA-Nemotron-3-Nano-30B-A3B-BF16 entry)
PUBLISHED = dict(
    attention_bias=False, chunk_size=128, conv_kernel=4, expand=2, head_dim=128, hidden_size=2688,
    hybrid_override_pattern="MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME", intermediate_size=1856,
    layer_norm_epsilon=1e-05, mamba_head_dim=64, mamba_hidden_act="silu", mamba_num_heads=64, mamba_proj_bias=False,
    max_position_embeddings=262144, mlp_bias=False, mlp_hidden_act="relu2", model_type="nemotron_h",
    moe_intermediate_size=1856, moe_shared_expert_intermediate_size=3712, n_group=1, n_groups=8,
    n_routed_experts=128, n_shared_experts=1, norm_eps=1e-05, norm_topk_prob=True, num_attention_heads=32,
    num_experts_per_tok=6, num_hidden_layers=52, num_key_value_heads=2, num_logits_to_keep=1,
    partial_rotary_factor=1, rescale_prenorm_residual=True, residual_in_fp32=False, rope_theta=10000,
    routed_scaling_factor=2.5, sliding_window=None, ssm_state_size=128, tie_word_embeddings=False,
    time_step_floor=0.0001, time_step_max=0.1, time_step_min=0.001, topk_group=1, use_bias=False,
    use_conv_bias=True, use_mamba_kernels=True, vocab_size=131072,
)
TINY = dict(hidden_size=64, intermediate_size=32, moe_intermediate_size=32, moe_shared_expert_intermediate_size=48,
            num_hidden_layers=5, hybrid_override_pattern="MEM*E", num_attention_heads=4, num_key_value_heads=2,
            head_dim=16, n_routed_experts=16, num_experts_per_tok=4, mamba_num_heads=4, mamba_head_dim=8,
            ssm_state_size=16, n_groups=2)  # the vocabulary kept: it picks the tokenizer


def _tiny_cfg():
    c = dict(common.config(CELL_CONFIG))
    c.update(TINY)
    return c


def test_the_configuration_holds_the_published_numbers():
    c = common.config(CELL_CONFIG)
    assert {k: c[k] for k in PUBLISHED} == PUBLISHED
    assert c["reduced"] == [] and len(c["assumed"]) >= 6
    p = c["hybrid_override_pattern"]
    assert (p.count("M"), p.count("E"), p.count("*"), len(p)) == (23, 23, 6, 52)


def test_nemotron_bpe_equals_the_programs():
    from tvc_torch.models.tokenizer import NEMOTRON_H_BOS, NEMOTRON_H_EOS, get_tokenizer

    ours, theirs = nref.NemotronQwenBPE(), get_tokenizer(131072, 512)
    assert (nref.BOS, nref.EOS) == (NEMOTRON_H_BOS, NEMOTRON_H_EOS) == (theirs.bos_id, theirs.eot_id)
    texts = [qref.PARAPHRASE_PROMPT.format(text=t) for t in traffic.distinct_captions()[:100]]
    for t, row in zip(texts, theirs(texts)):
        ids = ours.prompt(t)
        assert list(row[: len(ids)]) == ids and row[len(ids)] == theirs.pad_id
        assert max(ids[1:]) < nref.BOS


def test_the_weights_have_the_programs_names_and_shapes():
    from tvc_torch.models import nemotron_h as nh

    cfg = common.config(CELL_CONFIG)
    prog = nh.published_config(cfg)
    for part in weights_nemotron.parts(cfg):
        mine = {n: s for n, s, *_ in weights_nemotron.part_shapes(cfg, part)}
        theirs = {n: s for n, s, *_ in nh.part_shapes(prog, part)}
        assert mine == theirs, part


@pytest.fixture(scope="module")
def tiny():
    from tvc_torch.models import nemotron_h as nh

    cfg = _tiny_cfg()
    parts = {p: weights_nemotron.part(cfg, 5, p, "cpu") for p in weights_nemotron.parts(cfg)}
    prog = nh.NemotronHModel(nh.published_config(cfg, max_seq_len=128, dtype=torch.float32), params=parts.get,
                             max_new_tokens=6, device="cpu")
    return cfg, parts, prog


def test_the_drawn_ssm_parameters_follow_the_published_initialisation(tiny):
    cfg, parts, _ = tiny
    w = parts["layer_0"]
    a = torch.exp(w["layer_0.ssm.a_log"])
    dt = torch.nn.functional.softplus(w["layer_0.ssm.dt_bias"])
    assert ((a >= 1) & (a <= 16)).all() and ((dt >= 1e-4) & (dt <= 0.1 + 1e-6)).all()
    assert torch.equal(w["layer_0.ssm.d"], torch.ones(cfg["mamba_num_heads"]))


def test_reference_equals_the_programs_teacher_forced_logits(tiny):
    """The program in f32 with w8 weights, teacher-forced, against the
    reference's full forward: the two sum the same products in other
    orders (~1e-7 relative a sum), so the logits agree to 2e-5 of unit
    scale; a wrong tap, step, group, route or norm moves them by O(1e-1)."""
    from tvc_torch.models.decoding import PARAPHRASE_PREFIX

    cfg, parts, prog = tiny
    texts = traffic.distinct_captions()[:3]
    prompts = [qref.PARAPHRASE_PROMPT.format(text=t) for t in texts]
    inp = prog.prepare(prompts, 1, None, PARAPHRASE_PREFIX)
    forced = torch.randint(0, 131000, (6, 3), generator=torch.Generator().manual_seed(1))
    got = []
    prog.decode(inp, forced=forced, on_logits=lambda i, lg: got.append(lg.clone()))
    bpe = nref.NemotronQwenBPE()
    seqs = [bpe.prompt(p) + forced[:-1, r].tolist() for r, p in enumerate(prompts)]
    want = nref.NemotronH(cfg, parts.get).logits(seqs)
    for r, p in enumerate(prompts):
        n = len(bpe.prompt(p))
        torch.testing.assert_close(torch.stack([g[r] for g in got]), want[r][n - 1 :], atol=2e-5, rtol=0)


def test_routes_read_off_the_program_are_the_references_own_in_f32(tiny):
    """In f32 the program and the reference choose alike: routed through
    the program's recorded choices (keyed by MoE block) the reference gives
    its own logits and a route gap of 0; the int4 control's choices lie
    below."""
    cfg, parts, prog = tiny
    texts = traffic.distinct_captions()[3:5]
    served = torch.randint(0, 131000, (4, 6), generator=torch.Generator().manual_seed(2))
    routes = decode_routes(prog, texts, 2, served, [1, 2])
    assert all(sorted(r) == [0, 1] for r in routes)  # the two MoE blocks of MEM*E
    bpe = nref.NemotronQwenBPE()
    seqs = [bpe.prompt(qref.PARAPHRASE_PROMPT.format(text=texts[r // 2])) + served[r, :5].tolist() for r in (1, 2)]
    own, follow = nref.NemotronH(cfg, parts.get), nref.NemotronH(cfg, parts.get)
    lo = own.logits(seqs)
    lf = follow.logits(seqs, routes)
    assert follow.route_gap == 0.0 and all(torch.equal(a, b) for a, b in zip(lo, lf))
    low = nref.NemotronH(cfg, parts.get, bits=4)
    low.logits(seqs)
    ctl = nref.NemotronH(cfg, parts.get)
    ctl.logits(seqs, [{li: r[j][0] for li, r in low.routes.items()} for j in range(2)])
    assert ctl.route_gap > 0.001


def test_ssm_work_by_hand():
    # a decode step: 640 rows, one token, 64 heads of 64 x 128, 8 groups
    ops, nbytes = work_ssm.recurrent(640, 1, 64, 64, 128, 8)
    assert ops == {"f32": 640 * 64 * (5.0 * 64 * 128 + 128 + 2 * 64)}
    state = 2 * 4 * 64 * 128 * 64 * 640
    assert nbytes == state + 640 * (2 * (4096 + 2048) + 4 * 64 + 2 * 4096) + 2 * 4 * 64
    assert state / 3.35e12 == pytest.approx(8.0e-4, rel=1e-2)  # ~0.8 ms a block, bytes bound
    assert work_ssm.recurrent(2, 5, 64, 64, 128, 8, n=7)[1] == 2 * 4 * 64 * 128 * 64 * 2 + 7 * (
        2 * 6144 + 4 * 64 + 2 * 4096) + 2 * 4 * 64
    ops, nbytes = work_ssm.prepare(640, 1, 6144, 64, 4)
    assert nbytes == 640 * (2 * 2 * 6144 + 6 * 64) + 2 * 2 * 3 * 6144 * 640 + 4 * (6144 * 5 + 64)
    assert ops == {"f32": 640 * (13.0 * 6144 + 4 * 64)}
    ops, nbytes = work_ssm.gated_norm(640, 1, 4096)
    assert nbytes == 3 * 2 * 640 * 4096 + 4 * 4096 and ops == {"f32": 9.0 * 640 * 4096}
    assert work_ssm.relu2(3840 * 1856) == ({"f32": 2.0 * 3840 * 1856}, 4.0 * 3840 * 1856)
    # the attention blocks' decode: 640 rows, 2 KV heads of 16 query heads, D 128, 64 slots
    ops, nbytes = work_ssm.gqa_decode(640, 64, 2, 16, 128)
    assert ops == {"bf16": 4.0 * 640 * 32 * 128 * 64}
    assert nbytes == 2 * (2 * 640 * 32 * 128 + 2 * 640 * 2 * 64 * 128) + 4 * 640 * 64
