"""Exact top-k retrieval over an embedding bank (port of
``tvc/bank/index.py``), on one device or row-sharded over a mesh.

The bank ``[N, D]`` is padded to a multiple of 8 rows a shard; pad rows are
masked to -inf before the top-k. Search is one ``torch.matmul`` plus an
exact top-k, as the JAX package leaves it to XLA. The top-k orders equal
scores by the lower index first, as ``lax.top_k`` does
(``topk_index_order``; ``torch.topk`` promises no order on ties).

Over a mesh each rank keeps the rows of its shard on the bank axis
(:func:`tvc_torch.parallel.mesh.bank_shard_axis`); a search is a local
product and top-k, an ``all_gather`` of every shard's ``[B, k]``
candidates over that axis and one more exact top-k over them. Candidates
are concatenated in shard order and each shard's are sorted by (score,
index), so equal scores still come out lower global index first.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from tvc_torch._device import resolve_device
from tvc_torch.core.kernels.topk_kernel import topk_index_order
from tvc_torch.core.similarity import l2_normalize
from tvc_torch.parallel.mesh import (
    all_gather,
    all_reduce,
    axis_index,
    axis_size,
    bank_shard_axis,
    barrier,
    is_first_rank,
    mesh_device,
    pad_to_multiple,
)

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


def sharded_topk(queries: Tensor, bank_shard: Tensor, valid_shard: Tensor, k: int, mesh, axis: str
                 ) -> Tuple[Tensor, Tensor]:
    """The global exact top-k of ``queries [B, D]`` (the same on every rank)
    over a bank whose rows are sharded over ``axis``, each rank holding
    ``bank_shard [rows, D]`` and its ``valid_shard [rows]`` mask. Returns
    (scores [B, k], global idx [B, k]) on every rank."""
    rows = bank_shard.shape[0]
    sims = (queries @ bank_shard.T).masked_fill(~valid_shard[None, :], float("-inf"))
    scores, idx = topk_index_order(sims, min(k, rows))  # [B, k'], sorted
    gidx = idx + axis_index(mesh, axis) * rows
    B = queries.shape[0]
    cand = all_gather(scores, mesh, axis, dim=1)  # [B, S * k'] in shard order
    cand_idx = all_gather(gidx, mesh, axis, dim=1)
    top, pos = topk_index_order(cand, k)
    return top, torch.gather(cand_idx, 1, pos).reshape(B, k)


def gather_rows(bank_shard: Tensor, idx: Tensor, mesh, axis: str) -> Tensor:
    """Bank rows at global indices ``idx`` (any shape; the same on every
    rank) -> ``[*idx.shape, D]`` on every rank: each rank fills the rows its
    shard holds and zeros, and the sum over ``axis`` is exact (one nonzero
    term each)."""
    rows = bank_shard.shape[0]
    local = idx.long() - axis_index(mesh, axis) * rows
    mine = (local >= 0) & (local < rows)
    out = torch.where(mine[..., None], bank_shard[local.clamp(0, rows - 1)], 0.0)
    return all_reduce(out, mesh, axis) if axis_size(mesh, axis) > 1 else out


class EmbeddingBank:
    """Persistent exact embedding index, on one device or row-sharded over a
    mesh (each rank then holds its shard; searches return the global top-k
    on every rank)."""

    def __init__(
        self,
        dim: int,
        mesh=None,
        normalize: bool = True,
        device: Optional[Union[str, torch.device]] = None,
    ):
        """``mesh``: a ``DeviceMesh`` (``tvc_torch.parallel.mesh.create_mesh``)
        whose bank axis shards the rows; the bank lives on the mesh's device,
        and a ``device`` that names another raises."""
        self.dim = dim
        self.mesh = mesh
        self.normalize = normalize
        if mesh is not None:
            self.device = mesh_device(mesh)
            if device is not None and resolve_device(device) != self.device:
                raise ValueError(f"device {device} is not the mesh's {self.device}")
        else:
            self.device = resolve_device(device)
        self._bank: Optional[Tensor] = None  # [Np / shards, D] padded (this rank's rows)
        self._valid: Optional[Tensor] = None  # [Np / shards] bool
        self._n: int = 0

    @property
    def size(self) -> int:
        return self._n

    @property
    def valid(self) -> Tensor:
        """[rows] bool mask of the real rows (of this rank's shard)."""
        return self._valid

    def _axis(self) -> str:
        return bank_shard_axis(self.mesh)

    def build(self, embeddings: np.ndarray) -> "EmbeddingBank":
        """Load a [N, D] host array (the same on every rank) as the bank."""
        emb = np.asarray(embeddings, dtype=np.float32)
        if emb.ndim != 2 or emb.shape[1] != self.dim:
            raise ValueError(f"expected [N, {self.dim}], got {emb.shape}")
        self._n = emb.shape[0]
        shards = axis_size(self.mesh, self._axis()) if self.mesh is not None else 1
        rows = pad_to_multiple(max(self._n, 1), shards * ROW_MULTIPLE)
        per = rows // shards
        lo = (axis_index(self.mesh, self._axis()) if self.mesh is not None else 0) * per
        padded = np.zeros((per, self.dim), dtype=np.float32)
        real = emb[lo : min(lo + per, self._n)]
        padded[: len(real)] = real
        if self.normalize:
            norms = np.linalg.norm(padded, axis=1, keepdims=True)
            padded = padded / np.maximum(norms, 1e-8)
        self._bank = torch.as_tensor(padded, device=self.device)
        self._valid = torch.arange(lo, lo + per, device=self.device) < self._n
        return self

    def _queries(self, queries) -> Tensor:
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        return l2_normalize(q) if self.normalize else q

    @torch.no_grad()
    def search(self, queries, k: int) -> Tuple[Tensor, Tensor]:
        """``queries [B, D] -> (scores [B, k], idx [B, k])``; pad rows never
        appear as long as k <= size. Over a mesh every rank passes the same
        queries and gets the global result."""
        if self._bank is None:
            raise RuntimeError("bank is empty; call build() first")
        if k > self._n:
            raise ValueError(f"k={k} exceeds bank size {self._n}")
        q = self._queries(queries)
        if self.mesh is not None:
            return sharded_topk(q, self._bank, self._valid, k, self.mesh, self._axis())
        sims = (q @ self._bank.T).masked_fill(~self._valid[None, :], float("-inf"))
        return topk_index_order(sims, k)

    @torch.no_grad()
    def rows(self, idx) -> Tensor:
        """Bank rows (normalized when the bank is) at global indices ``idx``
        -> ``[*idx.shape, D]``."""
        idx = torch.as_tensor(idx, dtype=torch.long, device=self.device)
        if self.mesh is not None:
            return gather_rows(self._bank, idx, self.mesh, self._axis())
        return self._bank[idx]

    @torch.no_grad()
    def similarity_matrix(self, queries) -> Tensor:
        """Full [B, N] similarity matrix (gathered over a mesh)."""
        if self._bank is None:
            raise RuntimeError("bank is empty; call build() first")
        sims = self._queries(queries) @ self._bank.T
        if self.mesh is not None:
            sims = all_gather(sims, self.mesh, self._axis(), dim=1)
        return sims[:, : self._n]

    def save(self, path: str) -> None:
        """Write the bank rows to ``path`` (``.npz``). Over a mesh the rows
        are gathered on every rank and the mesh's first rank writes the file;
        every rank returns once it exists."""
        if self._bank is None:
            raise RuntimeError("bank is empty")
        bank = self._bank
        if self.mesh is not None:
            bank = all_gather(bank, self.mesh, self._axis())
        host = bank[: self._n].cpu().numpy()
        if self.mesh is None or is_first_rank(self.mesh):
            np.savez_compressed(path, embeddings=host, dim=self.dim, n=self._n)
        if self.mesh is not None:
            barrier(self.mesh)

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
