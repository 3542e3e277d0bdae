"""tvc_torch make_serving_step against the JAX serving step at tiny_coco
(context 32, so the two-bucket deduplicated text program engages on real
COCO captions): every output key within 2e-5, ref_idx and flags exact."""

import gzip
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tvc.models.clip import CLIPConfig as JConfig, CLIPModel as JModel
from tvc.parallel.steps import make_serving_step as j_make_step
from tvc_torch.models.clip import CLIPConfig, CLIPModel, bucket_text_tokens, params_from_jax
from tvc_torch.core.kernels import consistency_kernel
from tvc_torch.parallel import steps as steps_mod
from tvc_torch.parallel.steps import make_serving_step

ASSETS = Path(__file__).resolve().parent.parent / "tvc" / "assets"
B, V, K, R = 128, 3, 5, 3  # B*(V+1) = 512 text rows
KEYS = ("is_adversarial", "aggregated", "tv_score", "sd_score", "consistency_score",
        "orig_similarity", "variant_mean", "variant_std", "ref_idx", "img")


def _safe_threshold(agg, q):
    s = np.sort(np.asarray(agg, np.float64))
    gaps = [(abs(i / len(s) - q), (s[i] + s[i + 1]) / 2) for i in range(len(s) - 1) if s[i + 1] - s[i] > 2e-4]
    return np.float32(min(gaps)[1])


@pytest.fixture(scope="module")
def setup():
    jm = JModel(JConfig.tiny_coco(), seed=0)
    cfg = CLIPConfig.tiny_coco()
    tm = CLIPModel(cfg, params=params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params), cfg), device="cpu")
    with gzip.open(ASSETS / "coco_captions_val2017.json.gz", "rt") as f:
        caps = [c for _, c in json.load(f)[: B * (V + 1)]]
    rng = np.random.default_rng(11)
    tokens = np.asarray(tm.tokenize(caps[:B]))
    vtok = np.asarray(tm.tokenize(caps[B:])).reshape(B, V, -1)
    vtok[::4, 1] = vtok[::4, 0]  # duplicate rows: dedup engages
    vmask = rng.random((B, V)) > 0.15
    vmask[0] = False
    bank = rng.standard_normal((61, cfg.embed_dim)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    valid = np.arange(64) < 61
    bank = np.concatenate([bank, np.zeros((3, cfg.embed_dim), np.float32)])  # 3 pad rows
    inputs = dict(
        pixels=rng.random((B, 32, 32, 3)).astype(np.float32), tokens=tokens, vtok=vtok,
        vmask=vmask, bank=bank, valid=valid, weights=np.asarray([0.4, 0.4, 0.2], np.float32),
    )
    j_steps = {wb: j_make_step(jm, top_k=K, num_refs=R, with_bank=wb) for wb in (True, False)}
    return jm, tm, inputs, j_steps


def _call(step, params, d, lower, upper):
    return step(params, d["pixels"], d["tokens"], d["vtok"], d["vmask"], d["bank"], d["valid"],
                d["weights"], lower, upper)


def test_text_rows_take_the_bucketed_deduplicated_program(setup):
    _, _, d, _ = setup
    all_tok = np.concatenate([d["tokens"][:, None], d["vtok"]], 1).reshape(B * (V + 1), -1)
    plan = bucket_text_tokens(all_tok, dedup=True)
    assert plan is not None and plan["short"].shape[1] == 16
    assert len(np.unique(all_tok, axis=0)) < all_tok.shape[0]


@pytest.mark.parametrize("with_bank", [True, False])
@pytest.mark.parametrize("two_sided", [False, True])
def test_serving_step_matches_jax(setup, with_bank, two_sided):
    jm, tm, d, j_steps = setup
    js = j_steps[with_bank]
    probe = _call(js, jm.params, d, np.float32(-np.inf), np.float32(0.5))
    upper = _safe_threshold(probe["aggregated"], 0.6)
    lower = _safe_threshold(probe["aggregated"], 0.2) if two_sided else np.float32(-np.inf)
    want = _call(js, jm.params, d, lower, upper)
    step = make_serving_step(tm, top_k=K, num_refs=R, with_bank=with_bank, device="cpu")
    got = _call(step, tm.params, d, lower, upper)
    assert step.bucketed_calls == 1
    assert set(got) == set(KEYS) == set(want)
    for k in KEYS:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, k
        if k in ("is_adversarial", "ref_idx"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, atol=2e-5, rtol=0, err_msg=k)
    if two_sided:
        assert bool(got["is_adversarial"].any()) and not bool(got["is_adversarial"].all())


@pytest.mark.parametrize("with_bank", [True, False])
def test_serving_step_hands_the_consistency_kernel_operands_it_reads_as_they_lie(setup, monkeypatch, with_bank):
    """On the card the consistency wrapper copies any operand its kernel
    cannot read in place; the step's operands need no copy (and the
    weights and threshold go as f32 tensors, read by the kernel)."""
    _, tm, d, _ = setup
    seen = []

    def spy(*args, **kw):
        seen.append(consistency_kernel.operands_needing_copy(*args, **kw))
        return consistency_kernel.fused_consistency_scores(*args, **kw)

    monkeypatch.setattr(steps_mod, "fused_consistency_scores", spy)
    step = make_serving_step(tm, top_k=K, num_refs=R, with_bank=with_bank, device="cpu")
    _call(step, tm.params, d, np.float32(-np.inf), np.float32(0.5))
    assert seen == [[]]


def test_tensor_tokens_take_one_bucket_with_the_same_result(setup):
    """Tensor tokens skip host bucketing; the tower is length-polymorphic,
    so the result equals the bucketed program's."""
    _, tm, d, _ = setup
    step = make_serving_step(tm, top_k=K, num_refs=R, device="cpu")
    a = _call(step, tm.params, d, np.float32(-np.inf), np.float32(0.5))
    t = {**d, "tokens": torch.as_tensor(d["tokens"]), "vtok": torch.as_tensor(d["vtok"])}
    b = _call(step, tm.params, t, np.float32(-np.inf), np.float32(0.5))
    assert step.bucketed_calls == 1
    np.testing.assert_array_equal(a["ref_idx"].numpy(), b["ref_idx"].numpy())
    np.testing.assert_allclose(a["aggregated"].numpy(), b["aggregated"].numpy(), atol=2e-5, rtol=0)


def test_serving_step_single_device_only(setup, tmp_path):
    """No longer single device only: over a one-rank mesh (bank sharded over
    it) the step gives the single-device outputs, through the per-shard
    bucketed program (multi-rank: tests/test_torch_mesh_steps.py)."""
    from tvc_torch.parallel.launch import one_rank
    from tvc_torch.parallel.mesh import create_mesh

    _, tm, d, _ = setup
    want = _call(make_serving_step(tm, top_k=K, num_refs=R, device="cpu"), tm.params, d,
                 np.float32(-np.inf), np.float32(0.5))
    with one_rank(device="cpu", run_dir=str(tmp_path)):
        step = make_serving_step(tm, mesh=create_mesh(device="cpu"), top_k=K, num_refs=R, device="cpu")
        got = _call(step, tm.params, d, np.float32(-np.inf), np.float32(0.5))
    assert step.bucketed_calls == 1
    for k in KEYS:
        assert torch.equal(got[k], want[k]), k
