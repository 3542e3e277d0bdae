"""The trained tiny-CLIP fixtures in the port: the pure-Python reader of
flax's msgpack against flax on both assets (every leaf bit-equal), the
evaluation functions against the JAX package's on the same features
(2e-5), the evaluation of the loaded fixtures against the metrics recorded
beside them, and ``ServingConfig(clip_model="tiny_coco_trained")`` serving
on the CPU."""

import json

import jax
import numpy as np
import pytest
import torch
from flax import serialization

import tvc.attacks  # noqa: F401  (the JAX evaluation imports it at its first call: ~2 s)
import tvc.fixtures as jf
import tvc_torch.fixtures as tf
from tvc_torch._flax_msgpack import MsgpackError, read_state_dict, unpackb
from tvc_torch.models.clip import CLIPConfig, params_from_jax
from tvc_torch.serving import ServingConfig, ServingRuntime

TOL = 2e-5
ASSETS = {"synthetic": tf.FIXTURE_PATH, "coco": tf.FIXTURE_COCO_PATH}


@pytest.mark.parametrize("name", list(ASSETS))
def test_reader_is_bit_equal_to_flax(name):
    path = ASSETS[name]
    assert path == {"synthetic": jf.FIXTURE_PATH, "coco": jf.FIXTURE_COCO_PATH}[name]
    got = read_state_dict(path)
    # flax.serialization.from_bytes restores its target from this state dict
    want = serialization.msgpack_restore(path.read_bytes())
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves] and len(got_leaves) == 62
    for (p, a), (_, b) in zip(got_leaves, want_leaves):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, p
        assert a.tobytes() == b.tobytes(), p


def test_reader_takes_the_msgpack_forms_of_a_parameter_tree():
    tree = {
        "a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": {"c": np.array(7, np.int32)},
        "big": np.zeros((300, 300), np.float16), "s": "text" * 20, "n": [1, -3, 300, 70000, -40000, 2**40],
        "f": 1.5, "t": True, "none": None, "i8": np.ones(3, np.int8),
        "list": [np.ones(3, np.uint8), {"x": np.full((1, 17), 3, np.float64)}],
        **{f"k{i}": i for i in range(20)},  # a map above 15 entries
    }
    got = read_state_dict(serialization.to_bytes(tree))
    want = serialization.msgpack_restore(serialization.to_bytes(tree))
    got_leaves, want_leaves = (jax.tree_util.tree_leaves_with_path(t) for t in (got, want))
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (p, a), (_, b) in zip(got_leaves, want_leaves):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), p
        else:
            assert a == b and type(a) is type(b), p
    with pytest.raises(MsgpackError, match="truncated"):
        unpackb(serialization.to_bytes({"a": 1})[:-1])
    with pytest.raises(MsgpackError, match="is a msgpack map"):
        read_state_dict(b"\x93\x01\x02\x03")  # an array, not a state dict
    with pytest.raises(MsgpackError, match="extension type 2"):
        read_state_dict(serialization.to_bytes({"z": 1 + 2j}))


@pytest.fixture(scope="module")
def coco_model():
    return tf.load_trained_tiny_coco(device="cpu")


class _NumpyModel:
    """The port's model with numpy outputs, for the JAX package's
    evaluation code."""

    def __init__(self, model):
        self.model, self.config = model, model.config

    def encode_image(self, images):
        return self.model.encode_image(images).numpy()

    def encode_text(self, texts):
        return self.model.encode_text(texts).numpy()


def test_loaded_parameters_are_the_assets(coco_model):
    from tvc_torch.models.clip import _flatten

    want = _flatten(params_from_jax(read_state_dict(tf.FIXTURE_COCO_PATH), CLIPConfig.tiny_coco()))
    got = _flatten(coco_model.params)
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert coco_model.config == CLIPConfig.tiny_coco() and coco_model.device.type == "cpu"


def test_evaluate_fixture_coco_equals_the_jax_function(coco_model):
    got = tf.evaluate_fixture_coco(coco_model, n=20, skip=3)
    want = jf.evaluate_fixture_coco(_NumpyModel(coco_model), n=20, skip=3)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= TOL, k


def test_evaluate_fixture_equals_the_jax_function():
    model = tf.load_trained_tiny(device="cpu")
    assert model.config == CLIPConfig.tiny()
    got = tf.evaluate_fixture(model, n=30, seed=5)
    want = jf.evaluate_fixture(_NumpyModel(model), n=30, seed=5)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= TOL, k


@pytest.mark.parametrize("name", ["synthetic", "coco"])
def test_the_fixtures_reach_their_recorded_quality(name, coco_model):
    """The recorded metrics were taken by the JAX package on another
    backend: retrieval exactly, similarities within 1e-3."""
    if name == "coco":
        got, meta = tf.evaluate_fixture_coco(coco_model), json.loads(tf.FIXTURE_COCO_META_PATH.read_text())
    else:
        got = tf.evaluate_fixture(tf.load_trained_tiny(device="cpu"))
        meta = json.loads(tf.FIXTURE_META_PATH.read_text())
    assert got["retrieval_accuracy"] == meta["retrieval_accuracy"] == 1.0
    for k in got:
        assert abs(got[k] - meta[k]) <= 1e-3, k


def test_augmented_captions_equal_jax():
    for cap in ("a man riding a big red car.", "a cat", "an old house on the street"):
        assert tf._augmented_captions(cap, np.random.default_rng(0)) == \
            jf._augmented_captions(cap, np.random.default_rng(0))
    assert tf.EVAL_HOLDOUT == jf.EVAL_HOLDOUT and tf._TRAIN_TEMPLATES == jf._TRAIN_TEMPLATES


def test_a_missing_fixture_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(tf, "FIXTURE_PATH", tmp_path / "none.msgpack")
    with pytest.raises(FileNotFoundError):
        tf.load_trained_tiny(train_if_missing=False, device="cpu")
    with pytest.raises(NotImplementedError, match="training step"):
        tf.load_trained_tiny(device="cpu")


@pytest.mark.parametrize("int8_serving", [False, True])
def test_serving_the_trained_fixture_on_the_cpu(coco_model, int8_serving):
    """Served as loaded, whatever int8_serving says (as the JAX package
    serves it): the module towers, the fixture's parameters."""
    rt = ServingRuntime(ServingConfig(clip_model="tiny_coco_trained", int8_serving=int8_serving,
                                      batch_max_size=4, drift_window=0, bank_size=64), device="cpu")
    model = rt.detector.model
    assert model.config == CLIPConfig.tiny_coco()
    assert not model.config.fused_attention and not model.config.int8_serving
    assert torch.equal(model.params["visual"]["proj"], coco_model.params["visual"]["proj"])
    rng = np.random.default_rng(4)
    images = rng.random((3, 32, 32, 3)).astype(np.float32)
    texts = ["a dog on a beach", "a red kite in the sky", "two boys playing soccer"]
    rt.start(http=False)
    try:
        res = rt.submit(images, texts, timeout=60)
    finally:
        rt.stop()
    direct = rt.detector.detect_batch(np.concatenate([images, np.zeros_like(images[:1])]), texts + ["pad"])
    np.testing.assert_allclose(res["scores"], direct.aggregated_score[:3], atol=1e-6, rtol=0)
    assert res["is_adversarial"] == direct.is_adversarial[:3].tolist()

