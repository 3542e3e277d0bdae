"""The bank top-k kernel's plain version against the JAX package's Pallas
``bank_topk`` in interpret mode: ``bank_topk_reference`` and the CPU route
of ``bank_topk`` on the cases of tests/test_pallas_topk.py, ``n_valid``
(int and tensor), k past the valid rows (the surplus slots exactly, one
tile and several), ``normalize=False`` with a bf16 bank, and banks of
duplicated rows whose exact ties must come out lower index first.
Indices exact, values 2e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvc.core.pallas.topk_kernel import bank_topk as j_bank_topk
from tvc_torch.core.kernels import bank_topk, bank_topk_reference, launch_counts
from tvc_torch.core.kernels.topk_kernel import topk_index_order

TOL = 2e-5


def _check(q_t, bank_t, q_j, bank_j, k, **kw):
    """Both port routes against the Pallas kernel; returns its (vals, idx)."""
    jv, ji = j_bank_topk(q_j, bank_j, k=k, **kw)
    jv, ji = np.asarray(jv), np.asarray(ji)
    before = launch_counts()
    for fn in (bank_topk, bank_topk_reference):
        tv, ti = fn(q_t, bank_t, k, **{n: (torch.tensor(np.asarray(v)) if isinstance(v, jnp.ndarray) else v)
                                       for n, v in kw.items()})
        assert tv.dtype == torch.float32 and ti.dtype == torch.int32 and tuple(ti.shape) == ji.shape
        np.testing.assert_array_equal(ti.numpy(), ji)
        np.testing.assert_allclose(tv.numpy(), jv, atol=TOL, rtol=0)
    assert launch_counts() == before  # CPU tensors: the plain version, no kernel
    return jv, ji


def _f32(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("N,block_n", [(512, 128), (300, 128), (1024, 256)])
def test_bank_topk_matches_pallas(N, block_n):
    q, bank = _f32(N, (8, 128), (N, 128))
    _check(torch.as_tensor(q), torch.as_tensor(bank), jnp.asarray(q), jnp.asarray(bank), 10, block_n=block_n)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_bank_topk_n_valid(as_tensor):
    q, bank = _f32(5, (4, 128), (256, 128))
    bank[100:] *= 100.0  # would dominate if not masked
    nv = jnp.asarray(100, jnp.int32) if as_tensor else 100
    _, idx = _check(torch.as_tensor(q), torch.as_tensor(bank), jnp.asarray(q), jnp.asarray(bank), 5,
                    n_valid=nv, block_n=128)
    assert np.all(idx < 100)


@pytest.mark.parametrize("N,block_n,n_valid,k", [
    (600, 1024, 3, 5),    # one tile: (-inf, 0)
    (600, 128, 3, 5),     # valid rows in the first of five tiles: the best of them
    (600, 128, 10, 12),
    (600, 128, 0, 4),     # no valid row
    (300, 128, 260, 12),  # some valid rows in the last tile
    (40, 128, None, 48),  # k past N itself
])
def test_bank_topk_surplus_slots(N, block_n, n_valid, k):
    q, bank = _f32(11, (3, 16), (N, 16))
    vals, idx = _check(torch.as_tensor(q), torch.as_tensor(bank), jnp.asarray(q), jnp.asarray(bank), k,
                       n_valid=n_valid, block_n=block_n)
    n = N if n_valid is None else min(n_valid, N)
    if n < k:
        assert np.all(np.isneginf(vals[:, n:]))


@pytest.mark.parametrize("q_bf16", [False, True])
def test_bank_topk_bf16_bank_without_normalize(q_bf16):
    q, bank = _f32(13, (6, 64), (384, 64))
    jb = jnp.asarray(bank, jnp.bfloat16)
    tb = torch.as_tensor(bank).bfloat16()
    jq = jnp.asarray(q, jnp.bfloat16) if q_bf16 else jnp.asarray(q)
    tq = torch.as_tensor(q).bfloat16() if q_bf16 else torch.as_tensor(q)
    _check(tq, tb, jq, jb, 7, block_n=128, normalize=False)


def test_bank_topk_normalize_bf16_bank():
    """normalize=True on a bf16 bank: the CUDA route divides by the bf16
    rows' norms in the kernel; the CPU route is the plain version."""
    q, bank = _f32(23, (5, 64), (512, 64))
    _check(torch.as_tensor(q), torch.as_tensor(bank).bfloat16(), jnp.asarray(q), jnp.asarray(bank, jnp.bfloat16), 9,
           block_n=128)


def test_bank_topk_normalize_rows_of_very_different_norms():
    """Rows scaled from 1e-3 to 1e3: with normalize the scores are cosines,
    so a large row must not win by its norm."""
    q, bank = _f32(29, (4, 32), (600, 32))
    bank *= np.logspace(-3, 3, 600, dtype=np.float32)[np.random.default_rng(29).permutation(600)][:, None]
    _check(torch.as_tensor(q), torch.as_tensor(bank), jnp.asarray(q), jnp.asarray(bank), 12, block_n=128)


def _tied_bank(seed, N, D=16):
    """Rows drawn from six unit vectors of +-0.5 on four coordinates, and
    queries of the same kind: every score is a multiple of 0.25 computed
    exactly in any summation order, so equal scores are true ties."""
    rng = np.random.default_rng(seed)

    def unit(n):
        out = np.zeros((n, D), np.float32)
        for r in out:
            r[rng.choice(D, 4, replace=False)] = rng.choice([-0.5, 0.5], 4)
        return out

    base = unit(6)
    return unit(5), base[rng.integers(0, 6, N)]


@pytest.mark.parametrize("normalize", [True, False])
def test_bank_topk_duplicated_rows_order_ties_by_index(normalize):
    q, bank = _tied_bank(17, 300)
    vals, idx = _check(torch.as_tensor(q), torch.as_tensor(bank), jnp.asarray(q), jnp.asarray(bank), 20,
                       block_n=128, normalize=normalize)
    for v, i in zip(vals, idx):  # ties inside the list: ascending index
        same = v[1:] == v[:-1]
        assert np.all(i[1:][same] > i[:-1][same])


def test_topk_index_order_is_a_stable_descending_sort():
    rng = np.random.default_rng(19)
    scores = rng.integers(-3, 4, (7, 500)).astype(np.float32) * 0.5
    scores[0, :5] = -0.0
    scores[1, 10:20] = -np.inf
    vals, idx = topk_index_order(torch.as_tensor(scores), 40)
    want = np.argsort(-scores, axis=1, kind="stable")[:, :40]
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(vals.numpy(), np.take_along_axis(scores, want, 1))
