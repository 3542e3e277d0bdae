"""The port's mesh serving, defense and training steps on four gloo ranks
(spawned once for the file) against the JAX package's functions on the
same numpy inputs.

* ``make_serving_step(mesh)`` at tiny_coco in f32 and in int8 (W8A8
  towers) over a 4 x 1 (data) and a 2 x 2 (data x model: bank rows on
  ``model``) mesh, through the per-shard bucketed program (host tokens)
  and the one-bucket program (tensor tokens), against JAX's single-device
  ``make_serving_step`` (JAX's own slow tests hold that equal to its mesh
  program): f32 outputs within 2e-5, flags and ``ref_idx`` exact; int8 by
  the quanta rule of tests/test_torch_int8_serving.py.
* ``make_defense_step(mesh)`` against JAX's ``make_defense_step``.
* ``detect_batch`` through a mesh retriever at B = 6 (not divisible by the
  4 ranks: padded and trimmed) against the JAX detector.
* ``make_train_step(mesh)``, one and two steps, against JAX's
  ``make_train_step`` over a 4-device data mesh (losses, parameters, and
  AdamW's first moment, which carries the gradient's scale) and against
  the port's single-device step on the global batch: the loss equal to
  1e-6 relative, the parameters to 1e-6 (AdamW's first steps move each
  parameter by about the learning rate times the sign of its gradient, so
  the test uses eps = 1e-3, where the update is a smooth function of the
  gradient).

The ranks import neither JAX nor ``tvc``: this module imports them inside
fixtures and tests only.
"""

import dataclasses
import gzip
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tvc_torch.parallel.launch import run_ranks

WORLD = 4
ASSETS = Path(__file__).resolve().parent.parent / "tvc" / "assets"
B, V, K, R = 128, 3, 5, 3  # B * (V + 1) = 512 text rows: 128 a shard, the bucketed plan engages
KEYS = ("is_adversarial", "aggregated", "tv_score", "sd_score", "consistency_score",
        "orig_similarity", "variant_mean", "variant_std", "ref_idx", "img")
TOL = 2e-5
# int8 quanta, as tests/test_torch_int8_serving.py sets them out
FLIP_TOL, MAX_FLIPPED_ROWS = 5e-3, 0.10
DET_TEXTS = ["a dog runs on the beach", "two cats on a red couch", "a man riding a wave", "pizza on a table",
             "a bus in the rain", "three birds on a wire"]
LAYOUTS = {"data": ("data",), "2x2": ("data", "model")}
TRAIN_LR, TRAIN_EPS = 1e-3, 1e-3
#: the DP step against JAX's (measured on tiny_coco, B = 16, two steps: the
#: loss 2.0e-7 relative, parameters 2.1e-7, the first moment's worst leaf
#: 2.3e-6 of its norm; a gradient off by the data-axis size reads >= 0.75)
TRAIN_LOSS_RTOL, TRAIN_PARAM_ATOL, TRAIN_MU_RTOL = 1e-5, 1e-6, 1e-4


def _jax_flat(tree):
    """A JAX tree as ``{"a.b.c": numpy}``, the names of the port's ``_flatten``."""
    import jax

    return {".".join(str(k.key) for k in path): np.asarray(v) for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _safe_threshold(agg, q, gap):
    s = np.sort(np.asarray(agg, np.float64))
    cands = [(abs(i / len(s) - q), (s[i] + s[i + 1]) / 2) for i in range(len(s) - 1) if s[i + 1] - s[i] > gap]
    return np.float32(min(cands)[1])


def _mesh(layout):
    from tvc_torch.parallel.mesh import MeshConfig, create_mesh

    shape = (-1,) if layout == "data" else (2, 2)
    return create_mesh(MeshConfig(axes=LAYOUTS[layout], shape=shape), device="cpu")


def _rank_job(rank, world, p):
    """Every output the tests read, computed on this rank."""
    from tvc_torch.bank.index import EmbeddingBank
    from tvc_torch.detector import AdversarialDetector, DetectorConfig
    from tvc_torch.models.clip import CLIPConfig, CLIPModel, _flatten, params_from_jax
    from tvc_torch.optim import adamw
    from tvc_torch.parallel.steps import make_defense_step, make_serving_step, make_train_step
    from tvc_torch.retrieval import MultiModalRetriever

    out = {}
    out["jax or tvc"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "tvc"))
    meshes = {name: _mesh(name) for name in LAYOUTS}
    d = p["inputs"]
    for kind in ("f32", "int8"):
        cfg = dataclasses.replace(CLIPConfig.tiny_coco(), fused_attention=kind == "int8", int8_serving=kind == "int8")
        tm = CLIPModel(cfg, params=params_from_jax(p["params"], CLIPConfig.tiny_coco()), device="cpu")
        qp = tm.qparams() if kind == "int8" else None
        for layout, mesh in meshes.items():
            bank = EmbeddingBank(cfg.embed_dim, mesh=mesh, normalize=False, device="cpu").build(d["bank"])
            for wb in (True, False):
                if kind == "int8" and layout == "2x2" and not wb:
                    continue
                step = make_serving_step(tm, mesh=mesh, top_k=K, num_refs=R, with_bank=wb, qparams=qp, device="cpu")
                bk, valid = (bank._bank, bank.valid) if wb else (np.zeros((1, cfg.embed_dim), np.float32),
                                                                 np.zeros(1, bool))
                tok, vtok = d["tokens"], d["vtok"]
                if layout == "data" and kind == "f32" and not wb:  # the one-bucket program
                    tok, vtok = torch.as_tensor(tok), torch.as_tensor(vtok)
                res = step(tm.params, d["pixels"], tok, vtok, d["vmask"], bk, valid, d["weights"],
                           p["lower"][kind], p["upper"][kind])
                out[("serve", kind, layout, wb)] = ({k: v.numpy() for k, v in res.items()}, step.bucketed_calls)

    tm = CLIPModel(CLIPConfig.tiny_coco(), params=params_from_jax(p["params"], CLIPConfig.tiny_coco()), device="cpu")
    dstep = make_defense_step(tm, meshes["2x2"], 0, top_k=K, threshold=p["defense_threshold"], device="cpu")
    got = dstep(tm.params, d["pixels"][:16], d["tokens"][:16], d["vtok"][:16], d["bank"],
                variant_mask=d["vmask"][:16])
    out["defense"] = tuple(t.numpy() for t in got)

    # detect_batch at tiny through a mesh retriever, B = 6 over 4 ranks
    det_model = CLIPModel(CLIPConfig.tiny(), params=params_from_jax(p["tiny_params"], CLIPConfig.tiny()),
                          device="cpu")
    retriever = MultiModalRetriever(det_model, mesh=meshes["data"])
    retriever.build_image_index(embeddings=p["det_bank"])
    det = AdversarialDetector(det_model, DetectorConfig(**p["det_cfg"]), retriever=retriever, device="cpu")
    det.threshold_manager.update(p["det_threshold"])
    res = det.detect_batch(p["det_images"], DET_TEXTS, p["det_variants"])
    out["detect"] = (res.is_adversarial, res.aggregated_score, res.method_scores, res.details["ref_idx"],
                     res.details["mesh"])

    # data-parallel training, one and two steps
    train_model = CLIPModel(CLIPConfig.tiny_coco(), params=params_from_jax(p["params"], CLIPConfig.tiny_coco()),
                            device="cpu")
    opt = adamw(TRAIN_LR, eps=TRAIN_EPS)
    px, tok = d["pixels"][:16], d["tokens"][:16]
    for name, mesh in (("single", None), ("mesh", meshes["data"])):
        step, state = make_train_step(train_model, mesh=mesh, optimizer=opt, device="cpu")
        params, losses = train_model.params, []
        for _ in range(2):
            params, state, loss = step(params, state, px, tok)
            losses.append(float(loss))
            out[("train", name, len(losses))] = {n: t.numpy() for n, t in _flatten(params).items()}
            out[("train mu", name, len(losses))] = {n: t.numpy() for n, t in _flatten(state["mu"]).items()}
        out[("train loss", name)] = losses
    return out


@pytest.fixture(scope="module")
def jax_side():
    """The JAX models and their outputs, the thresholds, and the inputs
    (tokenized by the port, numpy)."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from tvc.detector import AdversarialDetector as JDetector, DetectorConfig as JDetConfig
    from tvc.models.clip import CLIPConfig as JConfig, CLIPModel as JModel
    from tvc.parallel.mesh import DATA_AXIS, MODEL_AXIS
    from tvc.parallel.steps import make_defense_step as j_make_defense_step, make_serving_step as j_make_step
    from tvc.parallel.steps import make_train_step as j_make_train_step
    from tvc.retrieval import MultiModalRetriever as JRetriever
    from tvc_torch.models.clip import CLIPConfig, CLIPModel

    jm = JModel(JConfig.tiny_coco(), seed=0)
    jm8 = JModel(dataclasses.replace(JConfig.tiny_coco(), fused_attention=True, int8_serving=True), params=jm.params)
    params = jax.tree_util.tree_map(np.asarray, jm.params)
    tok_model = CLIPModel(CLIPConfig.tiny_coco(), device="cpu")  # the BPE tokenizer (built here, once)
    with gzip.open(ASSETS / "coco_captions_val2017.json.gz", "rt") as f:
        caps = [c for _, c in json.load(f)[: B * (V + 1)]]
    rng = np.random.default_rng(11)
    tokens = np.asarray(tok_model.tokenize(caps[:B]))
    vtok = np.asarray(tok_model.tokenize(caps[B:])).reshape(B, V, -1)
    vtok[::4, 1] = vtok[::4, 0]  # duplicate rows: dedup engages
    vmask = rng.random((B, V)) > 0.15
    vmask[0] = False
    bank = rng.standard_normal((61, 32)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    bank[40] = bank[7]  # an exact tie across the shard boundary
    inputs = dict(pixels=rng.random((B, 32, 32, 3)).astype(np.float32), tokens=tokens, vtok=vtok, vmask=vmask,
                  bank=bank, weights=np.asarray([0.4, 0.4, 0.2], np.float32))
    jbank = np.concatenate([bank, np.zeros((3, 32), np.float32)])
    jvalid = np.arange(64) < 61
    want, lower, upper = {}, {}, {}
    for kind, model, gap in (("f32", jm, 2e-4), ("int8", jm8, 4e-3)):
        steps = {wb: j_make_step(model, top_k=K, num_refs=R, with_bank=wb,
                                 qparams=model.qparams() if kind == "int8" else None) for wb in (True, False)}

        def call(wb, lo, up):
            bk, va = (jbank, jvalid) if wb else (np.zeros((1, 32), np.float32), np.zeros(1, bool))
            return steps[wb](model.params, inputs["pixels"], tokens, vtok, vmask, bk, va, inputs["weights"], lo, up)

        probe = call(True, np.float32(-np.inf), np.float32(0.5))
        upper[kind] = _safe_threshold(probe["aggregated"], 0.6, gap)
        lower[kind] = _safe_threshold(probe["aggregated"], 0.2, gap)
        for wb in (True, False):
            want[(kind, wb)] = {k: np.asarray(v) for k, v in call(wb, lower[kind], upper[kind]).items()}

    defense = j_make_defense_step(jm, None, 0, top_k=K, threshold=0.0)
    probe = defense(jm.params, inputs["pixels"][:16], tokens[:16], vtok[:16], bank, variant_mask=vmask[:16])
    d_thr = float(_safe_threshold(np.asarray(probe[1]), 0.5, 2e-4))
    want["defense"] = tuple(np.asarray(t) for t in j_make_defense_step(jm, None, 0, top_k=K, threshold=d_thr)(
        jm.params, inputs["pixels"][:16], tokens[:16], vtok[:16], bank, variant_mask=vmask[:16]))

    # detect_batch at tiny (hash tokenizer)
    jt = JModel(JConfig.tiny(), seed=1)
    det_bank = rng.standard_normal((45, 32)).astype(np.float32)
    det_images = rng.random((len(DET_TEXTS), 32, 32, 3)).astype(np.float32)
    det_variants = [[f"{t} variant {j}" for j in range(3)] for t in DET_TEXTS]
    det_cfg = dict(num_text_variants=3, num_reference_images=2, retrieval_top_k=4)
    jr = JRetriever(jt)
    jr.build_image_index(embeddings=det_bank)
    jd = JDetector(jt, JDetConfig(**det_cfg), retriever=jr)
    probe = jd.detect_batch(det_images, DET_TEXTS, det_variants)
    det_thr = float(_safe_threshold(probe.aggregated_score, 0.5, 2e-4))
    jd.threshold_manager.update(det_thr)
    want["detect"] = jd.detect_batch(det_images, DET_TEXTS, det_variants)
    # JAX's data-parallel training step over a 4-device data mesh, on a copy
    # of the parameters (the step donates them), one and two steps
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]).reshape(WORLD, 1), (DATA_AXIS, MODEL_AXIS))
    train, tstate = j_make_train_step(jm, mesh, optax.adamw(TRAIN_LR, eps=TRAIN_EPS))
    repl = NamedSharding(mesh, PartitionSpec())
    tparams = jax.device_put(jax.tree_util.tree_map(jnp.copy, jm.params), repl)
    tstate = jax.device_put(tstate, repl)
    want["train loss"] = []
    for n in (1, 2):
        tparams, tstate, loss = train(tparams, tstate, inputs["pixels"][:16], tokens[:16])
        want["train loss"].append(float(loss))
        want[("train", n)] = _jax_flat(tparams)
        want[("train mu", n)] = _jax_flat(tstate[0].mu)

    payload = dict(params=params, inputs=inputs, lower=lower, upper=upper, defense_threshold=d_thr,
                   tiny_params=jax.tree_util.tree_map(np.asarray, jt.params), det_bank=det_bank,
                   det_images=det_images, det_variants=det_variants, det_cfg=det_cfg, det_threshold=det_thr)
    return want, payload


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    run_dir = str(tmp_path_factory.mktemp("mesh_steps_ranks"))
    return run_ranks(_rank_job, WORLD, jax_side[1], device="cpu", threads=1, timeout=120, run_dir=run_dir)


def _assert_close_up_to_flips(got, want, name):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).reshape(len(want), -1).max(-1)
    assert d.max() <= FLIP_TOL, (name, d.max())
    assert (d > TOL).mean() <= MAX_FLIPPED_ROWS, (name, int((d > TOL).sum()))


@pytest.mark.parametrize("layout", ["data", "2x2"])
@pytest.mark.parametrize("with_bank", [True, False])
def test_mesh_serving_step_matches_jax_f32(jax_side, ranks, layout, with_bank):
    want = jax_side[0][("f32", with_bank)]
    for out in ranks:
        got, bucketed = out[("serve", "f32", layout, with_bank)]
        # host tokens take the per-shard bucketed program; tensor tokens one bucket
        assert bucketed == (0 if (layout == "data" and not with_bank) else 1)
        assert set(got) == set(KEYS) == set(want)
        for k in KEYS:
            assert got[k].shape == want[k].shape, k
            if k in ("is_adversarial", "ref_idx"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            else:
                np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=0, err_msg=k)
    assert want["is_adversarial"].any() and not want["is_adversarial"].all()


@pytest.mark.parametrize("layout,with_bank", [("data", True), ("data", False), ("2x2", True)])
def test_mesh_serving_step_matches_jax_int8(jax_side, ranks, layout, with_bank):
    want = jax_side[0][("int8", with_bank)]
    for out in ranks:
        got, bucketed = out[("serve", "int8", layout, with_bank)]
        assert bucketed == 1
        for k in KEYS:
            if k in ("is_adversarial", "ref_idx"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            else:
                _assert_close_up_to_flips(got[k], want[k], k)


def test_mesh_defense_step_matches_jax(jax_side, ranks):
    want = jax_side[0]["defense"]
    for out in ranks:
        flags, agg, idx = out["defense"]
        np.testing.assert_array_equal(flags, want[0])
        np.testing.assert_allclose(agg, want[1], atol=TOL, rtol=0)
        np.testing.assert_array_equal(idx, want[2])
    assert want[0].any() and not want[0].all()


def test_detect_batch_through_a_mesh_retriever_pads_and_trims(jax_side, ranks):
    want = jax_side[0]["detect"]
    for out in ranks:
        flags, agg, scores, ref_idx, mesh = out["detect"]
        assert mesh is True and flags.shape == (len(DET_TEXTS),)
        np.testing.assert_array_equal(flags, want.is_adversarial)
        np.testing.assert_allclose(agg, want.aggregated_score, atol=TOL, rtol=0)
        for k, v in want.method_scores.items():
            np.testing.assert_allclose(scores[k], v, atol=TOL, rtol=0, err_msg=k)
        np.testing.assert_array_equal(ref_idx, want.details["ref_idx"])
    assert want.is_adversarial.any() and not want.is_adversarial.all()


@pytest.mark.parametrize("steps", [1, 2])
def test_data_parallel_train_step_equals_the_single_device_step(ranks, steps):
    for out in ranks:
        single, mesh = out[("train loss", "single")], out[("train loss", "mesh")]
        np.testing.assert_allclose(mesh[:steps], single[:steps], rtol=1e-6, atol=0)
        a, b = out[("train", "mesh", steps)], out[("train", "single", steps)]
        assert set(a) == set(b)
        for n in b:
            np.testing.assert_allclose(a[n], b[n], atol=1e-6, rtol=0, err_msg=n)
    assert ranks[0][("train loss", "single")][1] < ranks[0][("train loss", "single")][0]


@pytest.mark.parametrize("steps", [1, 2])
def test_data_parallel_train_step_matches_jax(jax_side, ranks, steps):
    """The port's 4-rank step against JAX's ``make_train_step`` over a
    4-device data mesh, same tree, batch and ``adamw``: each loss to
    TRAIN_LOSS_RTOL, the parameters to TRAIN_PARAM_ATOL, and each leaf of
    AdamW's first moment (0.1 x the gradient after one step, so this holds
    the gradient's scale, which Adam's update hides) to TRAIN_MU_RTOL of
    the leaf's norm."""
    want = jax_side[0]
    for out in ranks:
        np.testing.assert_allclose(out[("train loss", "mesh")][:steps], want["train loss"][:steps],
                                   rtol=TRAIN_LOSS_RTOL, atol=0)
        got, ref = out[("train", "mesh", steps)], want[("train", steps)]
        assert set(got) == set(ref)
        for n in ref:
            np.testing.assert_allclose(got[n], ref[n], atol=TRAIN_PARAM_ATOL, rtol=0, err_msg=n)
        got, ref = out[("train mu", "mesh", steps)], want[("train mu", steps)]
        assert set(got) == set(ref)
        for n in ref:
            gap = np.linalg.norm(got[n] - ref[n]) / np.linalg.norm(ref[n])
            assert gap <= TRAIN_MU_RTOL, (n, gap)
    assert want["train loss"][1] < want["train loss"][0]


def test_ranks_import_neither_jax_nor_tvc(ranks):
    """Beyond what a bare interpreter here preloads."""
    code = "import json, sys; print(json.dumps(sorted(sys.modules)))"
    bare = set(json.loads(subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                                         timeout=120, check=True).stdout))
    for out in ranks:
        assert set(out["jax or tvc"]) <= bare, out["jax or tvc"]
