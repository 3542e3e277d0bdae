"""Exact top-k retrieval over an embedding bank on one device (port of
``tvc/bank/index.py``, single device).

The bank ``[N, D]`` is padded to a multiple of 8 rows; pad rows are masked
to -inf before the top-k. Search is one ``torch.matmul`` plus an exact
top-k, as the JAX package leaves it to XLA. The top-k orders equal scores
by the lower index first, as ``lax.top_k`` does (``topk_index_order``;
``torch.topk`` promises no order on ties).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from tvc_torch._device import resolve_device
from tvc_torch.core.kernels.topk_kernel import topk_index_order
from tvc_torch.core.similarity import l2_normalize

ROW_MULTIPLE = 8


def topk_exact(
    queries: Tensor, bank: Tensor, k: int, normalize: bool = True
) -> Tuple[Tensor, Tensor]:
    """``queries [B, D] x bank [N, D] -> (scores [B, k], idx [B, k])`` by
    descending cosine / inner-product similarity."""
    if normalize:
        queries = l2_normalize(queries)
        bank = l2_normalize(bank)
    return topk_index_order(queries @ bank.T, k)


class EmbeddingBank:
    """Persistent exact embedding index on one device."""

    def __init__(
        self,
        dim: int,
        mesh=None,
        normalize: bool = True,
        device: Optional[Union[str, torch.device]] = None,
    ):
        """``mesh`` keeps the reference's parameter order: a sharded bank is
        not ported yet, so a mesh raises ``NotImplementedError``."""
        if mesh is not None:
            raise NotImplementedError("a sharded bank (mesh=) is not ported yet; it waits for the multi-GPU slice")
        self.dim = dim
        self.normalize = normalize
        self.device = resolve_device(device)
        self._bank: Optional[Tensor] = None  # [Np, D] padded
        self._valid: Optional[Tensor] = None  # [Np] bool
        self._n: int = 0

    @property
    def size(self) -> int:
        return self._n

    @property
    def valid(self) -> Tensor:
        """[Np] bool mask of the real rows."""
        return self._valid

    def build(self, embeddings: np.ndarray) -> "EmbeddingBank":
        """Load a [N, D] host array as the bank."""
        emb = np.asarray(embeddings, dtype=np.float32)
        if emb.ndim != 2 or emb.shape[1] != self.dim:
            raise ValueError(f"expected [N, {self.dim}], got {emb.shape}")
        self._n = emb.shape[0]
        rows = -(-max(self._n, 1) // ROW_MULTIPLE) * ROW_MULTIPLE
        padded = np.zeros((rows, self.dim), dtype=np.float32)
        padded[: self._n] = emb
        if self.normalize:
            norms = np.linalg.norm(padded, axis=1, keepdims=True)
            padded = padded / np.maximum(norms, 1e-8)
        self._bank = torch.as_tensor(padded, device=self.device)
        self._valid = torch.arange(rows, device=self.device) < self._n
        return self

    @torch.no_grad()
    def search(self, queries, k: int) -> Tuple[Tensor, Tensor]:
        """``queries [B, D] -> (scores [B, k], idx [B, k])``; pad rows never
        appear as long as k <= size."""
        if self._bank is None:
            raise RuntimeError("bank is empty; call build() first")
        if k > self._n:
            raise ValueError(f"k={k} exceeds bank size {self._n}")
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        if self.normalize:
            q = l2_normalize(q)
        sims = (q @ self._bank.T).masked_fill(~self._valid[None, :], float("-inf"))
        return topk_index_order(sims, k)

    @torch.no_grad()
    def similarity_matrix(self, queries) -> Tensor:
        """Full [B, N] similarity matrix."""
        if self._bank is None:
            raise RuntimeError("bank is empty; call build() first")
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        if self.normalize:
            q = l2_normalize(q)
        return (q @ self._bank.T)[:, : self._n]

    def save(self, path: str) -> None:
        if self._bank is None:
            raise RuntimeError("bank is empty")
        host = self._bank[: self._n].cpu().numpy()
        np.savez_compressed(path, embeddings=host, dim=self.dim, n=self._n)

    @classmethod
    def load(
        cls,
        path: str,
        mesh=None,
        normalize: bool = True,
        device: Optional[Union[str, torch.device]] = None,
    ) -> "EmbeddingBank":
        data = np.load(path if str(path).endswith(".npz") else str(path) + ".npz")
        return cls(int(data["dim"]), mesh=mesh, normalize=normalize, device=device).build(data["embeddings"])
