"""tvc_torch/utils (seed, checkpoint) against the JAX package's
tvc/utils: the same checkpoint layout and retention, restores across
packages, the stage snapshots, and the seeding contract (torch included;
``derive_key`` deterministic per (seed, folds), not threefry's bits)."""

import random

import numpy as np
import pytest
import torch

from tvc_torch.utils import CheckpointManager, SeedContext, StageCheckpointer, derive_key, set_random_seed


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(4, 4)).astype(np.float32), "b": rng.normal(size=(4,)).astype(np.float32)}


def _torch_tree(seed):
    return {k: torch.from_numpy(v) for k, v in _tree(seed).items()}


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _torch_tree(0)
    mgr.save(1, t, metadata={"loss": 0.5})
    assert (tmp_path / "step_00000001" / "tree.msgpack").exists()
    restored = mgr.restore(_torch_tree(9), step=1)
    assert torch.equal(restored["w"], t["w"]) and torch.is_tensor(restored["b"])
    assert mgr.metadata(1)["loss"] == 0.5


def test_latest_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for s in (1, 5, 9):
        mgr.save(s, _torch_tree(s))
    assert mgr.latest_step() == 9
    assert mgr.steps() == [5, 9]  # step 1 garbage-collected
    restored = mgr.restore(_torch_tree(0))  # latest by default
    assert torch.equal(restored["w"], _torch_tree(9)["w"])


def test_restore_empty_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path)).restore(_torch_tree(0))


def test_restores_the_jax_msgpack_layout(tmp_path):
    """A directory laid out as the JAX manager's msgpack branch writes it
    (``step_XXXXXXXX/tree.msgpack`` of ``flax.serialization.to_bytes``,
    ``metadata.json``): the port lists, restores and reads its metadata;
    flax reads the port's ``tree.msgpack``."""
    import json

    from flax import serialization

    d = tmp_path / "jax" / "step_00000007"
    d.mkdir(parents=True)
    (d / "tree.msgpack").write_bytes(serialization.to_bytes({"params": _tree(1), "count": 3}))
    (d / "metadata.json").write_text(json.dumps({"step": 7}, default=str))
    mgr = CheckpointManager(str(tmp_path / "jax"))
    assert mgr.latest_step() == 7 and mgr.metadata()["step"] == 7
    got = mgr.restore({"params": _torch_tree(0), "count": 0})
    assert got["count"] == 3 and torch.equal(got["params"]["w"], torch.from_numpy(_tree(1)["w"]))
    path = CheckpointManager(str(tmp_path / "port")).save(2, {"params": _torch_tree(2), "count": 4})
    back = serialization.from_bytes({"params": _tree(0), "count": 0}, (tmp_path / "port" / "step_00000002" /
                                                                       "tree.msgpack").read_bytes())
    assert path.endswith("step_00000002") and back["count"] == 4
    np.testing.assert_array_equal(back["params"]["b"], _tree(2)["b"])


@pytest.mark.slow
def test_restores_across_packages(tmp_path):
    """The JAX manager itself (importing orbax takes seconds): the port
    restores what its msgpack branch (the branch it takes without orbax)
    wrote, and that branch restores the port's directory."""
    from tvc.utils.checkpoint import CheckpointManager as JaxCheckpointManager

    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jmgr = JaxCheckpointManager(str(jax_dir))
    jmgr._orbax = None  # the msgpack branch
    jmgr.save(7, {"params": _tree(1), "count": 3}, metadata={"step": 7})
    mgr = CheckpointManager(str(jax_dir))
    assert mgr.latest_step() == 7 and mgr.metadata()["step"] == 7
    got = mgr.restore({"params": _torch_tree(0), "count": 0})
    assert got["count"] == 3 and torch.equal(got["params"]["w"], torch.from_numpy(_tree(1)["w"]))

    CheckpointManager(str(port_dir)).save(2, {"params": _torch_tree(2), "count": 4})
    jread = JaxCheckpointManager(str(port_dir))
    jread._orbax = None
    back = jread.restore({"params": _tree(0), "count": 0})
    assert back["count"] == 4
    np.testing.assert_array_equal(back["params"]["b"], _tree(2)["b"])


def test_restore_refuses_an_orbax_directory(tmp_path):
    (tmp_path / "step_00000003" / "tree").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="msgpack"):
        CheckpointManager(str(tmp_path)).restore(_torch_tree(0))


def test_stage_checkpointer_roundtrip(tmp_path):
    """Arrays (torch tensors too) and JSON per stage under the
    fingerprint, atomic names, clear; a new fingerprint starts empty."""
    sc = StageCheckpointer(str(tmp_path), "abc123")
    assert not sc.has("stage one")
    sc.save("stage one", {"x": torch.arange(5), "y": np.ones((2, 3), np.float32), "skip": None}, {"auroc": 0.9})
    assert sc.has("stage one") and (tmp_path / "abc123" / "stage_one.npz").exists()
    arrays, meta = sc.load("stage one")
    np.testing.assert_array_equal(arrays["x"], np.arange(5))
    assert set(arrays) == {"x", "y"} and meta == {"auroc": 0.9}
    sc.save("meta only", meta={"n": 1})
    assert sc.load("meta only") == ({}, {"n": 1})
    assert not list((tmp_path / "abc123").glob("*.tmp*"))
    assert not StageCheckpointer(str(tmp_path), "other").has("stage one")
    sc.clear()
    assert not (tmp_path / "abc123").exists()


def test_seed_context_restores_every_rng():
    set_random_seed(5)
    a = (random.random(), np.random.random(), torch.rand(1).item())
    set_random_seed(5)
    with SeedContext(123):
        inner = (random.random(), np.random.random(), torch.rand(1).item())
    b = (random.random(), np.random.random(), torch.rand(1).item())
    assert a == b  # the outer streams resumed where they were
    with SeedContext(123):
        assert (random.random(), np.random.random(), torch.rand(1).item()) == inner


def test_derive_key_is_deterministic_per_folds():
    def draw(*args):
        return torch.randn(4, generator=derive_key(*args, device="cpu"))

    assert torch.equal(draw(0, 1, 2), draw(0, 1, 2))
    outs = [draw(0), draw(0, 1), draw(0, 2), draw(1, 1), draw(0, 1, 0)]
    assert all(not torch.equal(x, y) for i, x in enumerate(outs) for y in outs[i + 1:])
