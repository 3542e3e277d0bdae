"""tvc_torch.parallel.mesh and the sharded bank against the JAX package.

In process: ``MeshConfig``, ``pad_to_multiple``, ``bank_shard_axis`` and
``bucket_text_tokens_sharded`` (bit-equal to ``tvc.models.clip``'s on
seeded token batches). On four gloo ranks (spawned once for the file):
``create_mesh`` 4 x 1 and 2 x 2, ``shard_batch``, ``initialize_multihost``
(already initialized: a no-op), ``host_local_batch``,
``local_mesh_for_tests``, and ``EmbeddingBank(mesh)``: search indices
equal and scores within 2e-5 of ``tvc.bank.index.EmbeddingBank`` over a
4-device JAX mesh, exact ties across shard boundaries included, the
similarity matrix, ``rows``, save and load.

The ranks import neither JAX nor ``tvc``: this module imports them inside
the tests only.
"""

import json
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from tvc_torch.models.clip import bucket_text_tokens_sharded
from tvc_torch.parallel import mesh as tmesh
from tvc_torch.parallel.launch import run_ranks

WORLD = 4
DIM, N_BANK, K = 16, 37, 6
#: bank rows duplicated across the shard boundaries (4 shards of 16 rows)
TIES = (3, 20, 35)


def _bank_inputs():
    rng = np.random.default_rng(7)
    emb = rng.standard_normal((N_BANK, DIM)).astype(np.float32)
    for r in TIES[1:]:
        emb[r] = emb[TIES[0]]
    q = rng.standard_normal((5, DIM)).astype(np.float32)
    q[0] = emb[TIES[0]]  # the three tied rows lead its top-k
    q[1] = 2 * emb[TIES[0]] + 1e-3 * rng.standard_normal(DIM).astype(np.float32)
    return emb, q


def _rank_job(rank, world, run_dir):
    """Everything the tests read, computed on this rank."""
    from tvc_torch.bank.index import EmbeddingBank

    out = {}
    out["jax or tvc"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "tvc"))
    m41 = tmesh.create_mesh(tmesh.MeshConfig(axes=("data", "model"), shape=(-1, 1)), device="cpu")
    m22 = tmesh.create_mesh(tmesh.MeshConfig(axes=("data", "model"), shape=(2, 2)), device="cpu")
    for name, m in (("4x1", m41), ("2x2", m22)):
        out[f"shape {name}"] = tmesh.mesh_shape(m)
        out[f"coords {name}"] = (tmesh.axis_index(m, "data"), tmesh.axis_index(m, "model"))
        batch = {"x": np.arange(8 * 3).reshape(8, 3), "y": [np.arange(8), np.zeros((8, 2, 2))]}
        sh = tmesh.shard_batch(m, batch)
        out[f"shard {name}"] = (sh["x"].numpy(), sh["y"][0].numpy(), tuple(sh["y"][1].shape))
        out[f"bank axis {name}"] = tmesh.bank_shard_axis(m)
        out[f"placements {name}"] = (repr(tmesh.data_sharding(m, 2)), repr(tmesh.replicated(m)))
        out[f"gather {name}"] = tmesh.all_gather(torch.tensor([[float(rank)]]), m, "data").flatten().tolist()
    out["initialize again"] = tmesh.initialize_multihost("127.0.0.1:1", 99, 98, device="cpu")
    out["host_local_batch"] = tmesh.host_local_batch(8)
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.host_local_batch(6)
    out["local mesh"] = tmesh.mesh_shape(tmesh.local_mesh_for_tests(4, device="cpu"))
    with pytest.raises(RuntimeError, match="need 8 ranks"):
        tmesh.local_mesh_for_tests(8, device="cpu")
    with pytest.raises(RuntimeError, match="not all in the initialized group"):
        tmesh.create_mesh(devices=range(WORLD + 1), device="cpu")

    emb, q = _bank_inputs()
    for name, m in (("data", tmesh.create_mesh(device="cpu")), ("2x2", m22)):
        for normalize in (True, False):
            bank = EmbeddingBank(DIM, mesh=m, normalize=normalize, device="cpu").build(emb)
            scores, idx = bank.search(q, K)
            out[f"search {name} {normalize}"] = (scores.numpy(), idx.numpy(), tuple(bank._bank.shape))
            out[f"sim {name} {normalize}"] = bank.similarity_matrix(q).numpy()
            out[f"rows {name} {normalize}"] = bank.rows(idx).numpy()
        bank.save(f"{run_dir}/bank_{name}")
        back = EmbeddingBank.load(f"{run_dir}/bank_{name}", mesh=m, normalize=False, device="cpu")
        out[f"load {name}"] = back.search(q, K)[1].numpy()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    run_dir = str(tmp_path_factory.mktemp("mesh_ranks"))
    return run_ranks(_rank_job, WORLD, run_dir, device="cpu", threads=1, timeout=120, run_dir=run_dir)


# ---- in process -------------------------------------------------------------------------


@pytest.mark.parametrize("shape,n", [((-1,), 8), ((2, -1), 8), ((4, 2), 8), ((3, -1), 8), ((2, 2), 8), ((), 1)])
def test_mesh_config_resolve_shape_matches_jax(shape, n):
    from tvc.parallel.mesh import MeshConfig as JMeshConfig

    axes = ("data", "model")[: len(shape)]
    try:
        want = JMeshConfig(axes=axes, shape=shape).resolve_shape(n)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            tmesh.MeshConfig(axes=axes, shape=shape).resolve_shape(n)
    else:
        assert tmesh.MeshConfig(axes=axes, shape=shape).resolve_shape(n) == want


def test_pad_to_multiple_and_bank_shard_axis_match_jax():
    from tvc.parallel import mesh as jmesh

    for n in range(0, 40, 3):
        for m in (1, 4, 8, 32):
            assert tmesh.pad_to_multiple(n, m) == jmesh.pad_to_multiple(n, m)
    for axes in (("data",), ("data", "model"), ("model",)):
        jax_like = types.SimpleNamespace(axis_names=axes)
        assert tmesh.bank_shard_axis(types.SimpleNamespace(mesh_dim_names=axes)) == jmesh.bank_shard_axis(jax_like)


def _token_batch(seed, S, T, short_frac):
    """S CLIP-like rows: SOT, words, EOT (the highest id), zero pad; some
    rows repeated (dedup engages)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((S, T), np.int32)
    for i in range(S):
        n = rng.integers(3, 15) if rng.random() < short_frac else rng.integers(16, T - 1)
        out[i, 0] = 1
        out[i, 1 : n + 1] = rng.integers(2, 400, size=n)
        out[i, n + 1] = 499
    dup = rng.integers(0, S, size=S // 8)
    out[dup[1:]] = out[dup[:-1]]
    return out


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_bucket_text_tokens_sharded_is_bit_equal_to_jax(n_shards, dedup, seed):
    from tvc.models.clip import bucket_text_tokens_sharded as jbucket

    tokens = _token_batch(seed, 512, 32, 0.8)
    want = jbucket(tokens, n_shards, dedup=dedup)
    got = bucket_text_tokens_sharded(tokens, n_shards, dedup=dedup)
    assert want is not None and set(got) == set(want) == {"short", "long", "inv"}
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # each shard's features gather back to its own rows from local indices
    g = tokens.shape[0] // n_shards
    ns, nl = got["short"].shape[0] // n_shards, got["long"].shape[0] // n_shards
    for k in range(n_shards):
        short = np.pad(got["short"][k * ns : (k + 1) * ns], ((0, 0), (0, 32 - 16)))
        rows = np.concatenate([short, got["long"][k * nl : (k + 1) * nl]])[got["inv"][k * g : (k + 1) * g]]
        np.testing.assert_array_equal(rows, tokens[k * g : (k + 1) * g])


@pytest.mark.parametrize("case", ["short T", "indivisible", "too few short rows", "no shards"])
def test_bucket_text_tokens_sharded_none_cases_match_jax(case):
    from tvc.models.clip import bucket_text_tokens_sharded as jbucket

    tokens, n = {
        "short T": (_token_batch(2, 512, 32, 0.8)[:, :16], 2),
        "indivisible": (_token_batch(3, 510, 32, 0.8), 4),
        "too few short rows": (_token_batch(4, 256, 32, 0.2), 2),
        "no shards": (_token_batch(5, 256, 32, 0.8), 0),
    }[case]
    for dedup in (False, True):
        assert jbucket(tokens, n, dedup=dedup) is None
        assert bucket_text_tokens_sharded(tokens, n, dedup=dedup) is None


def test_one_process_without_a_launcher_gets_a_one_rank_mesh(monkeypatch):
    """As the JAX package's ``create_mesh`` builds a mesh over the local
    devices in one process: with no launcher environment
    ``initialize_multihost`` brings up a one-rank group (the README's
    ``initialize_multihost(); create_mesh()``), and ``create_mesh`` alone
    does the same; a bank built over that mesh searches as one device's."""
    from tvc_torch.bank.index import EmbeddingBank

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert not torch.distributed.is_initialized()
    try:
        assert tmesh.initialize_multihost(device="cpu") == 1
        assert torch.distributed.get_world_size() == 1 and torch.distributed.get_backend() == "gloo"
        assert tmesh.host_local_batch(6) == 6
        assert tmesh.mesh_shape(tmesh.create_mesh(device="cpu")) == {"data": 1}
        assert tmesh.mesh_shape(tmesh.local_mesh_for_tests(1, device="cpu")) == {"data": 1}
        with pytest.raises(RuntimeError, match="need 2 ranks, have 1"):
            tmesh.local_mesh_for_tests(2, device="cpu")
        emb, q = _bank_inputs()
        mesh = tmesh.create_mesh(tmesh.MeshConfig(axes=("data", "model"), shape=(1, 1)), device="cpu")
        got = EmbeddingBank(DIM, mesh=mesh, device="cpu").build(emb).search(q, K)
        want = EmbeddingBank(DIM, device="cpu").build(emb).search(q, K)
        np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
        np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    finally:
        torch.distributed.destroy_process_group()
    try:
        assert tmesh.mesh_shape(tmesh.create_mesh(device="cpu")) == {"data": 1}  # create_mesh alone
    finally:
        torch.distributed.destroy_process_group()


def test_mesh_functions_need_a_device_and_a_complete_coordinator():
    assert not torch.distributed.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmesh.initialize_multihost("127.0.0.1:1", 1, 0)
    with pytest.raises(ValueError, match="needs num_processes"):
        tmesh.initialize_multihost("127.0.0.1:1", device="cpu")


# ---- on four ranks ----------------------------------------------------------------------


def test_create_mesh_shapes_and_coordinates(ranks):
    for r, out in enumerate(ranks):
        assert out["shape 4x1"] == {"data": 4, "model": 1}
        assert out["shape 2x2"] == {"data": 2, "model": 2}
        assert out["coords 4x1"] == (r, 0)
        assert out["coords 2x2"] == (r // 2, r % 2)
        assert out["bank axis 4x1"] == out["bank axis 2x2"] == "model"
        assert out["gather 4x1"] == [0.0, 1.0, 2.0, 3.0]
        assert out["gather 2x2"] == ([0.0, 2.0] if r % 2 == 0 else [1.0, 3.0])
        assert out["placements 2x2"] == ("(Shard(dim=0), Replicate())", "(Replicate(), Replicate())")


@pytest.mark.parametrize("name,dp", [("4x1", 4), ("2x2", 2)])
def test_shard_batch_gives_each_rank_its_block(ranks, name, dp):
    x = np.arange(8 * 3).reshape(8, 3)
    for r, out in enumerate(ranks):
        k = r if dp == 4 else r // 2
        g = 8 // dp
        sx, sy0, sy1 = out[f"shard {name}"]
        np.testing.assert_array_equal(sx, x[k * g : (k + 1) * g])
        np.testing.assert_array_equal(sy0, np.arange(8)[k * g : (k + 1) * g])
        assert sy1 == (g, 2, 2)


def test_initialize_multihost_and_host_local_batch(ranks):
    for out in ranks:
        assert out["initialize again"] == WORLD  # already initialized: a no-op
        assert out["host_local_batch"] == 2
        assert out["local mesh"] == {"data": 4}


@pytest.fixture(scope="module")
def jax_bank_results():
    import jax
    from jax.sharding import Mesh

    from tvc.bank.index import EmbeddingBank as JBank

    emb, q = _bank_inputs()
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("data",))
    out = {}
    for normalize in (True, False):
        jb = JBank(DIM, mesh=mesh, normalize=normalize).build(emb)
        s, i = jb.search(q, K)
        out[normalize] = (np.asarray(s), np.asarray(i), np.asarray(jb.similarity_matrix(q)))
    return out


@pytest.mark.parametrize("layout", ["data", "2x2"])
@pytest.mark.parametrize("normalize", [True, False])
def test_sharded_bank_search_matches_jax_mesh(ranks, jax_bank_results, layout, normalize):
    want_s, want_i, want_sim = jax_bank_results[normalize]
    # the leading rows of q[0] tie exactly across three shards: lower index first
    assert list(want_i[0, :3]) == list(TIES)
    for out in ranks:
        scores, idx, shard_shape = out[f"search {layout} {normalize}"]
        assert shard_shape == ((16, DIM) if layout == "data" else (24, DIM))  # 64 rows over 4, 48 over 2
        np.testing.assert_array_equal(idx, want_i)
        np.testing.assert_allclose(scores, want_s, atol=2e-5, rtol=0)
        np.testing.assert_allclose(out[f"sim {layout} {normalize}"], want_sim, atol=2e-5, rtol=0)


@pytest.mark.parametrize("layout", ["data", "2x2"])
def test_sharded_bank_rows_save_and_load(ranks, layout):
    emb, q = _bank_inputs()
    norm = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-8)
    for out in ranks:
        idx = out[f"search {layout} True"][1]
        np.testing.assert_array_equal(out[f"rows {layout} True"], norm[idx])
        np.testing.assert_array_equal(out[f"rows {layout} False"], emb[out[f"search {layout} False"][1]])
        np.testing.assert_array_equal(out[f"load {layout}"], out[f"search {layout} False"][1])


def test_ranks_import_neither_jax_nor_tvc(ranks):
    """Beyond what a bare interpreter here preloads."""
    code = "import json, sys; print(json.dumps(sorted(sys.modules)))"
    bare = set(json.loads(subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                                         timeout=120, check=True).stdout))
    for out in ranks:
        assert set(out["jax or tvc"]) <= bare, out["jax or tvc"]
