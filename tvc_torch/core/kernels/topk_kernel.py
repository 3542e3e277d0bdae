"""Exact streaming top-k over an embedding bank (port of
``tvc/core/pallas/topk_kernel.py``).

    bank_topk(queries [B, D], bank [N, D], k) -> (scores [B, k] f32, idx [B, k] int32)

by descending similarity, without the ``[B, N]`` score matrix in device
memory. Semantics of the TPU kernel, kept in the kernel and the plain
version alike:

* equal scores are ordered by the lower row index first;
* rows at or past ``n_valid`` (an int or a 0-dim tensor) never appear;
* when fewer than k rows are valid, the surplus slots hold ``(-inf, s)``
  with ``s`` the TPU kernel's leftover index: its running list starts at
  ``(-inf, 0)`` and its argmax picks the first column, so ``s`` is the best
  valid row before the last ``block_n`` tile (rows below
  ``(ceil(N / block_n) - 1) * block_n``), else 0. With one tile that is
  ``(-inf, 0)``.

As in the JAX wrapper, ``normalize`` L2-normalizes both operands in f32
in the plain version, and the ``n_valid`` mask is built with plain tensor
ops before the kernel; without ``normalize`` the operands keep their
dtype (f32 or bf16; bf16 converts to f32 exactly) and products sum in
f32. ``n_valid`` past N is taken as N (the TPU wrapper would score its
zero pad rows as valid).

For CUDA tensors the wrapper launches the hand-written kernels of
``tvc_torch/csrc/bank_topk.cu`` (a split-N partial pass on the CUDA cores,
8 x 16 scores a thread on 128-query x 256-row tiles fed by a 3-stage
cp.async ring, threshold filters ahead of the sorted candidate lists in
shared memory, then a merge); for CPU tensors it computes the plain
version :func:`bank_topk_reference` (matmul, then an exact top-k over keys
that order ties by index). The kernels hold sorted lists of at most 128
entries and read rows in 16-byte pieces; the TPU kernel takes any k and
D, and so does the wrapper: a k above 128 runs in passes of at most 128,
each pass taking only the rows after the previous pass's last entry in
the (score, index) order (a floor the partial kernel applies per query),
and a D that is not a multiple of 8 is zero-padded in both operands (no
score changes; the copies are counted in ``bank_topk.copies``).
``bank_topk.launches`` counts the kernels' passes (a partial and a merge
launch each).

The kernel route's rounding point with ``normalize``: the wrapper
normalizes only the ``[B, D]`` queries in f32, and the kernel divides each
score by its bank row's norm ``max(sqrt(sum b^2), eps)``, summed in f32
from the tiles it already streams: ``(q^ . b) / |b|`` where the plain
version computes ``q^ . (b / |b|)``. The two differ by a few f32 ulps
(well inside the 1e-5 the card's checks hold the kernel to), and no
normalized ``[N, D]`` copy of the bank is made: a bf16 bank stays bf16.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import Tensor

from tvc_torch.core.kernels import _build
from tvc_torch.core.kernels._pad import padded, round_up
from tvc_torch.core.similarity import l2_normalize

MAX_K = 128  # the kernel's sorted candidate lists hold at most 128 entries: larger k runs in passes
TILE_ROWS = 256  # bank rows of one tile of the partial kernel
QUERY_BLOCK = 128  # queries of one partial block
BLOCKS_PER_SM = 1  # partial blocks an SM holds (~255 registers a thread): the splits fill one wave

NValid = Optional[Union[int, Tensor]]


def _operands(queries: Tensor, bank: Tensor, n_valid: NValid, normalize: bool):
    """The plain version's steps: f32 L2-normalize of both operands when
    ``normalize``, and the [N] validity mask (None: every row valid)."""
    if normalize:
        queries = l2_normalize(queries.float())
        bank = l2_normalize(bank.float())
    return queries, bank, _valid_rows(bank, n_valid)


def _valid_rows(bank: Tensor, n_valid: NValid) -> Optional[Tensor]:
    """The [N] validity mask of ``n_valid`` (None: every row valid)."""
    if n_valid is None:
        return None
    # an int compares as a scalar: no host-to-device copy in the stream
    nv = n_valid.to(bank.device) if torch.is_tensor(n_valid) else int(n_valid)
    return torch.arange(bank.shape[0], device=bank.device) < nv


def _aligned(t: Tensor) -> Tensor:
    """``t`` contiguous with a 16-byte aligned base (the kernel's cp.async
    loads), copied only if it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _cutoff(N: int, block_n: int) -> int:
    """The first row of the TPU kernel's last tile."""
    return (-(-N // block_n) - 1) * block_n


def topk_index_order(scores: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Exact top-k of ``scores [B, N]`` (f32) ordered by (score descending,
    index ascending), as ``lax.top_k`` orders ties; ``torch.topk`` promises
    no order on ties. Sorts int64 keys: the order-preserving integer of the
    f32 score above the complement of the index."""
    N = scores.shape[-1]
    s = torch.where(scores == 0, torch.zeros((), dtype=scores.dtype, device=scores.device), scores)  # -0.0 ties +0.0
    bits = s.view(torch.int32)
    key32 = bits >> 31  # -1 for negative scores: flip their 31 low bits
    key32 &= 0x7FFFFFFF
    key32 ^= bits
    del s, bits
    key = key32.to(torch.int64)
    del key32
    key *= 2**32
    key += (2**32 - 1) - torch.arange(N, dtype=torch.int64, device=scores.device)
    top = torch.topk(key, k, dim=-1).values
    del key
    idx = (2**32 - 1) - (top & 0xFFFFFFFF)
    return torch.gather(scores, -1, idx), idx


def bank_topk_reference(
    queries: Tensor,
    bank: Tensor,
    k: int,
    n_valid: NValid = None,
    block_n: int = 2048,
    normalize: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of :func:`bank_topk`: the full f32 score
    matrix, invalid rows at -inf, the exact index-ordered top-k, the TPU
    kernel's surplus slots."""
    B, N = queries.shape[0], bank.shape[0]
    q, bk, valid = _operands(queries, bank, n_valid, normalize)
    scores = q.float() @ bk.float().T
    if valid is not None:
        scores.masked_fill_(~valid[None, :], float("-inf"))
    kk = min(k, N)
    vals, idx = topk_index_order(scores, kk)
    del scores
    if kk < k:
        vals = torch.cat([vals, vals.new_full((B, k - kk), float("-inf"))], dim=1)
        idx = torch.cat([idx, idx.new_zeros((B, k - kk))], dim=1)
    finite = vals > float("-inf")
    left = finite & (idx < _cutoff(N, block_n))
    first = torch.gather(idx, 1, left.to(torch.uint8).argmax(dim=1, keepdim=True))
    leftover = torch.where(left.any(dim=1, keepdim=True), first, torch.zeros_like(first))
    idx = torch.where(finite, idx, leftover)
    return vals, idx.to(torch.int32)


def split_plan(B: int, N: int, sms: int) -> Tuple[int, int]:
    """(splits, rows_per_split) of the partial kernel: whole tiles a split,
    about BLOCKS_PER_SM blocks an SM over the query blocks and splits."""
    tiles = max(1, -(-N // TILE_ROWS))
    splits = max(1, min(tiles, -(-BLOCKS_PER_SM * sms // -(-B // QUERY_BLOCK))))
    rows_per_split = -(-tiles // splits) * TILE_ROWS
    return max(1, -(-N // rows_per_split)), rows_per_split


def _check_operands(q: Tensor, bank: Tensor, k: int) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    for name, t in (("queries", q), ("bank", bank)):
        if t.ndim != 2 or t.dtype not in (torch.float32, torch.bfloat16) or t.device != q.device:
            raise ValueError(f"{name} must be a float32 or bf16 2-D tensor on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if q.shape[1] != bank.shape[1]:
        raise ValueError(f"queries [B, {q.shape[1]}] and bank [N, {bank.shape[1]}] differ in width")
    if k < 1:
        raise ValueError(f"the top-k kernel takes k >= 1; got k={k}")


def bank_topk(
    queries: Tensor,
    bank: Tensor,
    k: int,
    n_valid: NValid = None,
    block_n: int = 2048,
    normalize: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Exact top-k over a bank: ``queries [B, D]``, ``bank [N, D]``,
    ``n_valid`` the count of real bank rows (default all). Returns
    ``(scores [B, k] f32, idx [B, k] int32)`` by descending similarity.
    ``block_n`` is the TPU kernel's tile, which fixes only the surplus
    slots' index (see the module docstring)."""
    k = int(k)
    if queries.device.type == "cpu":
        return bank_topk_reference(queries, bank, k, n_valid, block_n, normalize)
    _check_operands(queries, bank, k)
    # normalize: the queries here in f32, the bank rows' norms in the kernel
    q = _aligned(l2_normalize(queries.float()) if normalize else queries)
    bk = _aligned(bank)
    valid = _valid_rows(bank, n_valid)
    B, D = q.shape
    N = bk.shape[0]
    if D % 8:
        q = padded(q, (B, round_up(D, 8)), bank_topk)
        bk = padded(bk, (N, round_up(D, 8)), bank_topk)
    if B == 0:
        return (torch.empty((B, k), dtype=torch.float32, device=q.device),
                torch.empty((B, k), dtype=torch.int32, device=q.device))
    cutoff = _cutoff(N, block_n)
    passes = []
    for k0 in range(0, k, MAX_K):
        floor = passes[-1] if passes else None
        passes.append(_topk_pass(q, bk, valid, min(MAX_K, k - k0), floor, normalize, cutoff))
    if len(passes) == 1:
        return passes[0]
    vals = torch.cat([v for v, _ in passes], dim=1)
    idx = torch.cat([i for _, i in passes], dim=1)
    # the surplus slots' index over the whole list, as one pass's merge
    # sets it: the best valid row before the TPU kernel's last tile, else 0
    finite = vals > float("-inf")
    left = finite & (idx < cutoff)
    first = torch.gather(idx, 1, left.to(torch.uint8).argmax(dim=1, keepdim=True))
    leftover = torch.where(left.any(dim=1, keepdim=True), first, torch.zeros_like(first))
    return vals, torch.where(finite, idx, leftover)


bank_topk.launches = 0
bank_topk.copies = 0


def _topk_pass(q: Tensor, bk: Tensor, valid, k: int, floor, normalize: bool, cutoff: int):
    """One partial + merge launch pair: the top ``k`` <= 128 of each query
    among the valid rows after its ``floor`` entry (the last column of the
    previous pass's ``(vals, idx)``, or None for all rows)."""
    B, D = q.shape
    N = bk.shape[0]
    vals = torch.empty((B, k), dtype=torch.float32, device=q.device)
    idx = torch.empty((B, k), dtype=torch.int32, device=q.device)
    floor_vals = floor_idx = None
    if floor is not None:
        floor_vals, floor_idx = floor[0][:, -1].contiguous(), floor[1][:, -1].contiguous()
    splits, rows_per_split = split_plan(B, N, torch.cuda.get_device_properties(q.device).multi_processor_count)
    part_vals = torch.empty((B, splits, k), dtype=torch.float32, device=q.device)
    part_idx = torch.empty((B, splits, k), dtype=torch.int32, device=q.device)
    lib = _build.load("bank_topk")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()
    _build.check(
        lib.tvc_bank_topk_partial(
            q.data_ptr(), bk.data_ptr(), ptr(valid), ptr(floor_vals), ptr(floor_idx),
            part_vals.data_ptr(), part_idx.data_ptr(), B, N, D, k, rows_per_split, splits,
            int(bk.dtype == torch.bfloat16), int(q.dtype == torch.bfloat16), int(normalize), stream,
        ),
        "tvc_bank_topk_partial",
    )
    _build.check(
        lib.tvc_bank_topk_merge(
            part_vals.data_ptr(), part_idx.data_ptr(), vals.data_ptr(), idx.data_ptr(),
            B, splits, k, cutoff, stream,
        ),
        "tvc_bank_topk_merge",
    )
    bank_topk.launches += 1
    return vals, idx
