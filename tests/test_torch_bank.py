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
