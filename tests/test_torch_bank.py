"""tvc_torch EmbeddingBank against tvc.bank.EmbeddingBank (single device):
identical top-k indices, scores within 2e-5, pad rows never returned."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvc.bank import EmbeddingBank as JBank
from tvc.bank.index import topk_exact as j_topk
from tvc_torch.bank import EmbeddingBank, topk_exact


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
