"""tvc_torch EmbeddingBank against tvc.bank.EmbeddingBank (single device):
identical top-k indices, scores within 2e-5, pad rows never returned; and
tvc_torch ReferenceBank against tvc.bank.ReferenceBank (the cases of
tests/test_bank.py on both packages: dedup, each eviction policy, queries,
clustering labels equal when scikit-learn imports, no clustering when it
does not, and save / load across the two packages)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvc.bank import EmbeddingBank as JBank
from tvc.bank import ReferenceBank as JRefBank, ReferenceBankConfig as JRefConfig
from tvc.bank.index import topk_exact as j_topk
from tvc_torch.bank import EmbeddingBank, ReferenceBank, ReferenceBankConfig, topk_exact


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    bank = rng.standard_normal((203, 32)).astype(np.float32)  # 203: 5 pad rows
    queries = rng.standard_normal((17, 32)).astype(np.float32)
    return bank, queries


@pytest.mark.parametrize("k", [1, 5, 203])
@pytest.mark.parametrize("normalize", [True, False])
def test_search_matches_jax(data, k, normalize):
    bank, queries = data
    jb = JBank(32, normalize=normalize).build(bank)
    tb = EmbeddingBank(32, normalize=normalize, device="cpu").build(bank)
    assert tb.size == jb.size == 203 and tb._bank.shape[0] == 208
    j_scores, j_idx = jb.search(jnp.asarray(queries), k)
    t_scores, t_idx = tb.search(queries, k)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(t_scores.numpy(), np.asarray(j_scores), atol=2e-5, rtol=0)
    assert int(t_idx.max()) < 203


def test_similarity_matrix_and_topk_exact(data):
    bank, queries = data
    tb = EmbeddingBank(32, device="cpu").build(bank)
    jb = JBank(32).build(bank)
    np.testing.assert_allclose(
        tb.similarity_matrix(queries).numpy(), np.asarray(jb.similarity_matrix(jnp.asarray(queries))),
        atol=2e-5, rtol=0,
    )
    ts, ti = topk_exact(torch.as_tensor(queries), torch.as_tensor(bank), 7)
    js, ji = j_topk(jnp.asarray(queries), jnp.asarray(bank), 7)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-5, rtol=0)


def test_save_load_roundtrip_and_errors(data, tmp_path):
    bank, queries = data
    tb = EmbeddingBank(32, device="cpu").build(bank)
    tb.save(str(tmp_path / "bank"))
    back = EmbeddingBank.load(str(tmp_path / "bank"), device="cpu")
    np.testing.assert_array_equal(back.search(queries, 4)[1].numpy(), tb.search(queries, 4)[1].numpy())
    with pytest.raises(ValueError):
        tb.search(queries, 204)
    with pytest.raises(ValueError):
        EmbeddingBank(16, device="cpu").build(bank)
    with pytest.raises(RuntimeError):
        EmbeddingBank(32, device="cpu").search(queries, 1)


def test_positional_parameters_follow_the_reference(data, tmp_path):
    """``(dim, mesh, normalize)`` in the reference's order: the positional
    call ``(d, None, False)`` builds an unnormalized bank, as JAX's does."""
    bank, queries = data
    tb = EmbeddingBank(32, None, False, device="cpu").build(bank)
    jb = JBank(32, None, False).build(bank)
    assert tb.normalize is False and jb.normalize is False
    np.testing.assert_allclose(tb._bank[:203].numpy(), bank, rtol=0, atol=0)
    np.testing.assert_array_equal(tb.search(queries, 5)[1].numpy(), np.asarray(jb.search(jnp.asarray(queries), 5)[1]))
    tb.save(str(tmp_path / "raw"))
    back = EmbeddingBank.load(str(tmp_path / "raw"), None, False, device="cpu")
    assert back.normalize is False
    np.testing.assert_array_equal(back._bank.numpy(), tb._bank.numpy())


def test_a_mesh_raises_until_the_sharded_bank_is_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="mesh"):
        EmbeddingBank(16, mesh=object(), device="cpu")
    EmbeddingBank(16, device="cpu").build(np.ones((3, 16), np.float32)).save(str(tmp_path / "b"))
    with pytest.raises(NotImplementedError, match="mesh"):
        EmbeddingBank.load(str(tmp_path / "b"), mesh=object(), device="cpu")


@pytest.mark.parametrize("pair", ["bank", "bank.load", "qwen"])
def test_signatures_keep_the_reference_order(pair):
    """The port's parameters are the reference's, in its order, with
    ``device`` last, so a positional call means the same in both."""
    import inspect

    import tvc.models.qwen as jq
    import tvc_torch.models.qwen as tq

    ref, port = {
        "bank": (JBank.__init__, EmbeddingBank.__init__),
        "bank.load": (JBank.load, EmbeddingBank.load),
        "qwen": (jq.QwenModel.__init__, tq.QwenModel.__init__),
    }[pair]
    names = lambda f: list(inspect.signature(f).parameters)
    assert names(port) == names(ref) + ["device"]


def test_a_positional_mesh_reaches_qwen_where_the_reference_has_it():
    import tvc_torch.models.qwen as tq

    with pytest.raises(NotImplementedError, match="mesh"):
        tq.QwenModel(tq.QwenConfig.tiny(), None, 0, None, 32, False, object(), device="cpu")


# ---- ReferenceBank ---------------------------------------------------------


def _ref_banks(dim, **kw):
    return JRefBank(dim, JRefConfig(**kw)), ReferenceBank(dim, ReferenceBankConfig(**kw))


def _same_store(got, want):
    np.testing.assert_array_equal(got._matrix, want._matrix)
    assert [it.text for it in got._items] == [it.text for it in want._items]
    assert got.stats == want.stats


def test_reference_bank_dedup():
    v = np.random.default_rng(0).normal(size=8)
    for bank in _ref_banks(8, similarity_threshold=0.99):
        assert bank.add_reference(v)
        assert not bank.add_reference(v)  # exact duplicate rejected
        assert bank.stats["rejected_duplicates"] == 1 and len(bank) == 1
    # a tensor is taken as its values
    bank = ReferenceBank(8, ReferenceBankConfig(similarity_threshold=0.99))
    assert bank.add_reference(torch.as_tensor(v)) and not bank.add_reference(v)


def test_reference_bank_sampled_dedup_draws_as_jax():
    """More rows than dedup_sample_size: the dedup check samples rows with
    the bank's seeded generator, the same draws in both packages."""
    vs = np.random.default_rng(1).normal(size=(60, 6))
    jb, tb = _ref_banks(6, similarity_threshold=0.9, dedup_sample_size=8, clustering_interval=0)
    assert [jb.add_reference(v, text=str(i)) for i, v in enumerate(vs)] == \
        [tb.add_reference(v, text=str(i)) for i, v in enumerate(vs)]
    _same_store(tb, jb)


@pytest.mark.parametrize("policy", ["fifo", "lru", "random", "most_similar"])
def test_reference_bank_eviction(policy):
    """Five inserts into a bank of three (queries in between for lru): the
    same items survive in both packages; fifo drops the oldest."""
    out = []
    for bank in _ref_banks(4, max_size=3, similarity_threshold=1.0, clustering_interval=0, eviction_policy=policy):
        for i in range(5):
            v = np.zeros(4)
            v[i % 4] = 1.0
            v[(i + 1) % 4] = 0.1 * i
            bank.add_reference(v, text=f"t{i}")
            if i == 2:
                bank.query_similar(np.array([1.0, 0.0, 0.0, 0.0]), top_k=1)  # t0 recently used
        assert len(bank) == 3 and bank.stats["evicted"] == 2
        out.append(bank)
    _same_store(out[1], out[0])
    texts = [it.text for it in out[1]._items]
    if policy == "fifo":
        assert "t0" not in texts and "t1" not in texts  # oldest evicted
    if policy == "lru":
        assert "t0" in texts and "t1" not in texts


def test_reference_bank_query_and_persistence_across_packages(tmp_path):
    vs = np.random.default_rng(2).normal(size=(20, 16))
    banks = _ref_banks(16, clustering_interval=0)
    for bank in banks:
        bank.add_batch(vs, texts=[f"t{i}" for i in range(20)], source="retrieval")
    jb, tb = banks
    res = tb.query_similar(vs[3], top_k=3)
    assert res[0][0] == 3 and res[0][1] > 0.99
    want = jb.query_similar(vs[3], top_k=3)
    assert [i for i, _ in res] == [i for i, _ in want]
    np.testing.assert_allclose([s for _, s in res], [s for _, s in want], atol=2e-5, rtol=0)
    assert tb.query_similar(torch.as_tensor(vs[5]), top_k=1)[0][0] == 5
    assert ReferenceBank(16).query_similar(vs[0]) == []
    # each package loads the other's files
    jb.save(str(tmp_path / "jax"))
    tb.save(str(tmp_path / "torch"))
    for loaded, other in ((ReferenceBank.load(str(tmp_path / "jax")), jb),
                          (JRefBank.load(str(tmp_path / "torch")), tb)):
        assert len(loaded) == len(other) and loaded.dim == 16
        np.testing.assert_array_equal(loaded._matrix, other._matrix)
        assert [(it.text, it.source, it.use_count) for it in loaded._items] == \
            [(it.text, it.source, it.use_count) for it in other._items]
        assert loaded.query_similar(vs[3], top_k=3)[0][0] == 3
    assert (tmp_path / "torch" / "references.npz").exists() and (tmp_path / "torch" / "bank.json").exists()


def test_reference_bank_clustering_matches_jax():
    """With scikit-learn the same KMeans call: equal labels and centers."""
    pytest.importorskip("sklearn")
    rng = np.random.default_rng(3)
    a = rng.normal(size=(10, 8)) + np.array([5.0] + [0] * 7)
    b = rng.normal(size=(10, 8)) - np.array([5.0] + [0] * 7)
    banks = _ref_banks(8, clustering_interval=10, num_clusters=2, similarity_threshold=1.0)
    for bank in banks:
        bank.add_batch(np.concatenate([a, b]))
    jb, tb = banks
    assert tb.clusters is not None and tb.clusters.shape == (2, 8)
    np.testing.assert_array_equal(tb.cluster_labels, jb.cluster_labels)
    np.testing.assert_allclose(tb.clusters, jb.clusters, atol=1e-6, rtol=0)


def test_reference_bank_without_sklearn_does_no_clustering(monkeypatch):
    """The card's machine has no scikit-learn: inserts go on, no clusters."""
    import builtins

    real_import = builtins.__import__

    def no_sklearn(name, *args, **kw):
        if name == "sklearn" or name.startswith("sklearn."):
            raise ImportError(name)
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_sklearn)
    bank = ReferenceBank(4, ReferenceBankConfig(clustering_interval=2, num_clusters=2, similarity_threshold=1.0))
    assert bank.add_batch(np.eye(4)) == 4
    assert bank.clusters is None and bank.cluster_labels is None


def test_reference_bank_config_checks():
    for kw in (dict(max_size=0), dict(similarity_threshold=1.5), dict(eviction_policy="oldest")):
        with pytest.raises(ValueError):
            ReferenceBankConfig(**kw)
    with pytest.raises(ValueError, match="expected dim"):
        ReferenceBank(4).add_reference(np.ones(5))
