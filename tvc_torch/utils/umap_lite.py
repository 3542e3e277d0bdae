"""First-party minimal UMAP (McInnes et al., arXiv:1802.03426).

The reference offers UMAP embedding projections through the optional
``umap-learn`` package (reference src/utils/visualization.py:432-590);
that package is not a dependency here, so the project ships a compact
NumPy implementation of the core algorithm instead of silently degrading
to t-SNE (port of ``tvc/utils/umap_lite.py``: a copy, numpy only):

1. exact kNN graph (the bank sizes projected here are <= a few thousand
   points — brute force is faster than any index);
2. fuzzy simplicial set: per-point bandwidth ``sigma_i`` found by binary
   search so the smoothed kNN weights sum to log2(k) (paper §3.1), then
   probabilistic t-conorm symmetrization ``P = P + P.T - P∘P.T``;
3. PCA initialization (deterministic; the paper's spectral init needs a
   sparse eigensolver that buys nothing at these sizes);
4. SGD layout over the weighted edges with negative sampling, using the
   paper's attractive/repulsive gradients of the a,b-curve
   ``1 / (1 + a d^(2b))`` and a linearly decaying learning rate.

Deterministic for a fixed seed. Not a drop-in replacement for umap-learn
(no supervised mode, no transform of unseen points) — it covers the
visualization use the reference put it to.
"""

from __future__ import annotations

import numpy as np

__all__ = ["umap_embed"]


def _smooth_knn_weights(dists: np.ndarray, k: int, n_iter: int = 64) -> np.ndarray:
    """Per-row fuzzy membership weights (paper Algorithm 3).

    dists: [N, k] sorted ascending kNN distances (self excluded).
    Returns [N, k] weights exp(-(d - rho)/sigma) with sum ~= log2(k).
    """
    target = np.log2(k)
    rho = dists[:, 0]  # distance to nearest neighbor (local connectivity 1)
    d = np.maximum(dists - rho[:, None], 0.0)
    lo = np.zeros(len(dists))
    hi = np.full(len(dists), np.inf)
    sigma = np.ones(len(dists))
    for _ in range(n_iter):
        psum = np.exp(-d / sigma[:, None]).sum(axis=1)
        too_big = psum > target
        hi = np.where(too_big, sigma, hi)
        lo = np.where(too_big, lo, sigma)
        sigma = np.where(
            np.isinf(hi), sigma * 2.0, (lo + hi) / 2.0
        )
    sigma = np.maximum(sigma, 1e-10)
    return np.exp(-d / sigma[:, None])


def _fit_ab(min_dist: float = 0.1, spread: float = 1.0):
    """Fit the (a, b) of 1/(1+a d^(2b)) to the piecewise target curve
    (umap-learn's find_ab_params, least squares on a grid)."""
    x = np.linspace(0, 3 * spread, 300)
    y = np.where(x < min_dist, 1.0, np.exp(-(x - min_dist) / spread))
    # coarse-to-fine grid search (SciPy-free; 2 params, smooth objective)
    best = (1.577, 0.895)  # umap defaults for min_dist=0.1 as fallback
    best_err = np.inf
    a_grid = np.linspace(0.5, 3.0, 26)
    b_grid = np.linspace(0.5, 2.0, 31)
    for _ in range(3):
        for a in a_grid:
            for b in b_grid:
                err = float(np.mean((1.0 / (1.0 + a * x ** (2 * b)) - y) ** 2))
                if err < best_err:
                    best, best_err = (float(a), float(b)), err
        a0, b0 = best
        a_grid = np.linspace(max(a0 - 0.2, 1e-3), a0 + 0.2, 21)
        b_grid = np.linspace(max(b0 - 0.15, 1e-3), b0 + 0.15, 21)
    return best


def umap_embed(
    x: np.ndarray,
    n_components: int = 2,
    n_neighbors: int = 15,
    min_dist: float = 0.1,
    n_epochs: int = 200,
    learning_rate: float = 1.0,
    negative_sample_rate: int = 5,
    seed: int = 0,
) -> np.ndarray:
    """Project ``x`` [N, D] to [N, n_components]. See module docstring."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    if n <= n_components:
        return np.zeros((n, n_components))
    k = int(min(n_neighbors, n - 1))
    rng = np.random.default_rng(seed)

    # 1. exact kNN (squared euclidean)
    sq = np.sum(x * x, axis=1)
    d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T), 0.0)
    np.fill_diagonal(d2, np.inf)
    nbr = np.argsort(d2, axis=1)[:, :k]  # [N, k]
    nbr_d = np.sqrt(np.take_along_axis(d2, nbr, axis=1))

    # 2. fuzzy simplicial set + symmetrization
    w = _smooth_knn_weights(nbr_d, k)
    P = np.zeros((n, n))
    rows = np.repeat(np.arange(n), k)
    P[rows, nbr.ravel()] = w.ravel()
    P = P + P.T - P * P.T

    # 3. PCA init, scaled to ~[-10, 10] (umap-learn convention)
    xc = x - x.mean(axis=0)
    _, _, vt = np.linalg.svd(xc, full_matrices=False)
    emb = xc @ vt[:n_components].T
    emb = 10.0 * emb / (np.abs(emb).max() + 1e-12)
    emb = np.ascontiguousarray(emb)

    # 4. SGD over edges with negative sampling
    a, b = _fit_ab(min_dist)
    ei, ej = np.nonzero(P > 0)
    pw = P[ei, ej]
    # per-edge epochs-per-sample (paper: stronger edges update more often)
    eps_per_sample = pw.max() / np.maximum(pw, 1e-12)
    next_update = eps_per_sample.copy()
    clip = 4.0
    # vectorized epoch: all active edges batch through numpy scatter-adds
    # (umap-learn's per-edge loop is Hogwild-async anyway — batched
    # parallel updates are an equally valid SGD schedule and ~100x faster
    # in pure numpy)
    for epoch in range(1, n_epochs + 1):
        alpha = learning_rate * (1.0 - epoch / n_epochs)
        act = np.nonzero(next_update <= epoch)[0]
        if len(act) == 0:
            continue
        i, j = ei[act], ej[act]
        diff = emb[i] - emb[j]  # [E, C]
        dist2 = np.einsum("ec,ec->e", diff, diff)
        pos = dist2 > 0.0
        g = np.where(
            pos,
            (-2.0 * a * b * np.maximum(dist2, 1e-12) ** (b - 1.0))
            / (1.0 + a * np.maximum(dist2, 1e-12) ** b),
            0.0,
        )
        grad = np.clip(g[:, None] * diff, -clip, clip)
        np.add.at(emb, i, alpha * grad)
        np.add.at(emb, j, -alpha * grad)
        for _ in range(negative_sample_rate):
            m = rng.integers(n, size=len(act))
            keep = m != i
            diffn = emb[i] - emb[m]
            d2 = np.einsum("ec,ec->e", diffn, diffn)
            gn = (2.0 * b) / ((0.001 + d2) * (1.0 + a * d2**b))
            gradn = np.clip(gn[:, None] * diffn, -clip, clip)
            np.add.at(emb, i, alpha * gradn * keep[:, None])
        next_update[act] += eps_per_sample[act]
    return np.asarray(emb, dtype=np.float32)
