"""The int8 GEMMs of the Qwen2 decode (port of
``tvc/core/pallas/w8_matmul_kernel.py``): the W8A8 ``w8a8_matmul`` /
``w8a8_matmul_stacked`` and the weight-only ``w8_matmul`` /
``w8_matmul_stacked``.

    w8a8_matmul(x [M, K], w_q int8 [K, N], scale f32 [N]) -> [M, N], x's dtype
        = ((q(x) . w_q) . rs) . scale

where ``q(x), rs`` is the dynamic symmetric per-row int8 quantization of
``x`` taken in f32 (``rs = max(max|x|, 1e-12) / 127``, round half to even,
clip to +-127), the int8 product is summed exactly and the dequantization
runs in f32 in that order. Weights come per output channel from
``tvc_torch.models.qwen._quantize_leaf``.

For CUDA tensors the wrapper launches the hand-written kernels of
``tvc_torch/csrc/quantized_layer.cu``: the row-quantize kernel (f32 or bf16
rows) and the int8 tensor-core GEMM with its dequantize-only epilogue, two
launches a call (three when :func:`i8_plan` splits K). For CPU tensors it computes the plain version beside it,
which sums the int8 products in float64 (exact for every int32 sum here).

    w8_matmul(x [M, K], w_q int8 [K, N], scale f32 [N]) -> [M, N], x's dtype
        = ((x . w_q) summed in f32) * scale

is the weight-only GEMM (the JAX package's default ``quant_gemm="w8"``):
the activations stay in the model dtype, the int8 weights convert exactly
to it, the products are summed in f32 and scaled per output channel in
f32, then rounded once to x's dtype. For CUDA tensors the wrapper launches
the kernels of ``tvc_torch/csrc/w8_matmul.cu``: bf16 activations on the
tensor cores (the card's path; tile and split of K from :func:`w8_plan`),
f32 activations on the CUDA cores (the tiny and f32 configurations: f32
products summed in f32, no TF32). An operand that does not start on a
16-byte boundary, or an x that is not contiguous, is copied first; bf16
widths K, N that are not multiples of 16 are zero-padded around the
kernel (copies counted in ``w8_matmul.copies``; likewise the W8A8 GEMM in
``w8a8_matmul.copies``). For
CPU tensors it computes the plain version :func:`w8_matmul_plain`. :func:`w8_matmul_reference` is another
function: the JAX package's dequantize-then-matmul oracle, which rounds
every dequantized weight to x's dtype first; the decode takes it for
activation blocks above the kernels' row limit, as the JAX package does.

``*_stacked(x, w_q [L, K, N], scale [L, N], layer)`` is the same function
on layer ``layer`` of the stacked weights: the TPU kernels select the layer
by scalar prefetch so that ``lax.scan`` copies no slab, and here
``w_q[layer]`` of the contiguous stack is already a zero-copy view, so each
stacked wrapper calls its flat wrapper on it. ``<flat>.launches`` therefore
counts every launch of the kernel, ``<stacked>.launches`` the stacked calls
among them.
"""

from __future__ import annotations

import functools

import torch
from torch import Tensor

from tvc_torch.core.kernels import _build
from tvc_torch.core.kernels._pad import padded, round_up
from tvc_torch.core.kernels.quantized_layer_kernel import (
    _i8_gemm,
    _mm_i32,
    _quant_rows,
    _quant_rows_cuda,
)

QEPI_DEQUANT_BF16, QEPI_DEQUANT_F32 = 3, 4


def w8a8_matmul_reference(x: Tensor, w_q: Tensor, scale: Tensor) -> Tensor:
    """Plain PyTorch version of :func:`w8a8_matmul`."""
    xq, rs = _quant_rows(x.float())
    return (_mm_i32(xq, w_q) * rs * scale.float()).to(x.dtype)


def _check_operands(x: Tensor, w_q: Tensor, scale: Tensor, dtypes=(torch.bfloat16, torch.float32)) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.ndim != 2 or x.dtype not in dtypes or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous {' or '.join(map(str, dtypes))} [M, K] tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    M, K = x.shape
    N = w_q.shape[-1] if w_q.ndim == 2 else -1
    if w_q.dtype != torch.int8 or w_q.ndim != 2 or w_q.shape[0] != K or not w_q.is_contiguous() \
            or w_q.device != x.device:
        raise ValueError(f"w_q must be a contiguous int8 [{K}, N] tensor on {x.device}, got "
                         f"{w_q.dtype} {tuple(w_q.shape)}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (N,) or not scale.is_contiguous() \
            or scale.device != x.device:
        raise ValueError(f"scale must be a contiguous float32 [{N}] tensor on {x.device}")


def w8a8_matmul(x: Tensor, w_q: Tensor, scale: Tensor) -> Tensor:
    """x [M, K] (bf16 or f32) @ (w_q int8 [K, N] * scale f32 [N]) with x
    quantized per row to int8; returns [M, N] in x's dtype."""
    if x.device.type == "cpu":
        return w8a8_matmul_reference(x, w_q, scale)
    _check_operands(x, w_q, scale)
    M, K = x.shape
    N = w_q.shape[1]
    lib = _build.load("quantized_layer")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    xq, rs = _quant_rows_cuda(lib, x, None, None, 0.0, stream)
    epilogue = QEPI_DEQUANT_BF16 if x.dtype == torch.bfloat16 else QEPI_DEQUANT_F32
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    _i8_gemm(lib, xq, rs, w_q, scale, None, None, out, epilogue, stream, owner=w8a8_matmul)
    w8a8_matmul.launches += 1
    return out


w8a8_matmul.launches = 0
w8a8_matmul.copies = 0


def _check_stacked(w_q: Tensor, scale: Tensor, layer: int) -> None:
    if w_q.ndim != 3 or scale.ndim != 2 or scale.shape != (w_q.shape[0], w_q.shape[2]):
        raise ValueError(f"stacked weights must be w_q [L, K, N] and scale [L, N], got "
                         f"{tuple(w_q.shape)} and {tuple(scale.shape)}")
    if not 0 <= layer < w_q.shape[0]:
        raise ValueError(f"layer {layer} out of range for {w_q.shape[0]} stacked layers")


def w8a8_matmul_stacked(x: Tensor, w_q: Tensor, scale: Tensor, layer: int) -> Tensor:
    """x [M, K] @ (w_q [L, K, N])[layer] * (scale [L, N])[layer]."""
    layer = int(layer)
    _check_stacked(w_q, scale, layer)
    if x.device.type == "cpu":
        return w8a8_matmul_reference(x, w_q[layer], scale[layer])
    out = w8a8_matmul(x, w_q[layer], scale[layer])
    w8a8_matmul_stacked.launches += 1
    return out


w8a8_matmul_stacked.launches = 0


# -- weight-only ------------------------------------------------------------------


def w8_matmul_plain(x: Tensor, w_q: Tensor, scale: Tensor) -> Tensor:
    """Plain PyTorch version of :func:`w8_matmul`: the int8 weights
    converted exactly, the products summed in f32, scaled in f32, rounded
    once to x's dtype."""
    return (torch.matmul(x.float(), w_q.float()) * scale.float()).to(x.dtype)


def w8_matmul_reference(x: Tensor, w_q: Tensor, scale: Tensor) -> Tensor:
    """The JAX package's ``w8_matmul_reference``: dequantize in x's dtype
    (``w_q * scale``, each weight rounded to that dtype), then one matmul
    summed in f32 and rounded to x's dtype. x may carry leading batch dims."""
    w = w_q.to(x.dtype) * scale.to(x.dtype)
    return torch.matmul(x, w)


SMS = 132  # streaming multiprocessors of an H100 SXM
W8_BK = 64  # the kernel's k-tile


def w8_plan(M: int, N: int, K: int):
    """The bf16 kernel's tiling for an [M, K] x [K, N] product: ``(bm, bn,
    splits, per)``: bm x bn output tiles (256 x 192, 256 x 128 or 64 x 64)
    and ``splits`` ranges of ``per`` 64-deep k-tiles each (the last range
    may hold fewer; the kernel masks K's tail). A pure function of the
    shape.

    Above 64 rows a block converts each weight tile once for 256 rows (one
    block an SM). Where the 256 x 128 tiles fill the card, 192 columns are
    taken instead when that needs fewer waves' worth of columns (gate|up:
    3 waves of 192 against 5 of 128, the last nearly empty). Where the
    tiles are fewer than the SMs, K is split into as many ranges as fit
    beside them in one wave (each range costs a pass over the [M, N] f32
    sums). At M <= 64 (the prefix prefill) the weights dominate: 64 x 64
    tiles (two blocks an SM) with K split until every SM streams weights
    twice over."""
    nk = -(-K // W8_BK)
    cdiv = lambda a, b: -(-a // b)
    if M <= 64:
        blocks = cdiv(N, 64)
        per = nk if blocks >= 2 * SMS else max(1, nk // cdiv(2 * SMS, blocks))
        return 64, 64, cdiv(nk, per), per
    bm = 256
    blocks = cdiv(M, bm) * cdiv(N, 128)
    if blocks >= SMS:
        wide = cdiv(M, bm) * cdiv(N, 192)
        if wide >= SMS and cdiv(wide, SMS) * 192 < cdiv(blocks, SMS) * 128:
            return bm, 192, 1, nk
    per = cdiv(nk, max(1, min(nk, SMS // blocks)))
    return bm, 128, cdiv(nk, per), per


I8_BK = 128  # the int8 kernel's k-tile: one 128-byte row of int8
#: the int8 kernel's tiles (bm, bn) -> (blocks an SM holds, SM clocks a
#: 128-deep k-tile takes, SM clocks of a block's fill and epilogue): clocks
#: at 1.755 GHz fitted to ``scripts/sweep_i8_gemm.py``'s times of every tile
#: at the table's 22 shapes on an H100 (a pair of co-resident blocks costs
#: twice its row, as they share the SM)
I8_TILES = {
    (192, 256): (1, 3265, 28427),
    (128, 256): (1, 2559, 27004),
    (192, 128): (1, 1911, 17711),
    (128, 128): (2, 1325, 10256),
    (64, 128): (2, 1146, 7390),
}
I8_MAX_SPLITS = 16
#: device-memory bytes a clock that a split's int32 workspace moves at
#: (fitted with the tiles' clocks)
I8_BYTES_PER_CLOCK = 2832


def i8_costed_plans(M: int, N: int, K: int):
    """Every tile and split :func:`i8_plan` weighs for an [M, K] x [K, N]
    product, as ``((cost in SM clocks, splits, -bm bn), (bm, bn, splits,
    per))``."""
    cdiv = lambda a, b: -(-a // b)
    nk = cdiv(K, I8_BK)
    for (bm, bn), (per_sm, tile_clocks, block_clocks) in I8_TILES.items():
        tiles = cdiv(M, bm) * cdiv(N, bn)
        for per in sorted({cdiv(nk, s) for s in range(1, min(nk, I8_MAX_SPLITS) + 1)}, reverse=True):
            splits = cdiv(nk, per)
            blocks = tiles * splits
            share = min(per_sm, cdiv(blocks, SMS))  # blocks that share an SM
            cost = cdiv(blocks, SMS * share) * share * (per * tile_clocks + block_clocks)
            if splits > 1:
                cost += 4 * (splits + 1) * M * N / I8_BYTES_PER_CLOCK
            yield (cost, splits, -bm * bn), (bm, bn, splits, per)


@functools.lru_cache(maxsize=4096)
def i8_plan(M: int, N: int, K: int):
    """The int8 kernel's tiling for an [M, K] x [K, N] product: ``(bm, bn,
    splits, per)``: bm x bn output tiles (one of :data:`I8_TILES`) and
    ``splits`` ranges of ``per`` 128-deep k-tiles each (the last range may
    hold fewer; TMA fills K's tail with zeros). A pure function of the
    shape, cached (a decode asks for the same few shapes thousands of
    times).

    Each candidate tile and split is costed in SM clocks
    (:func:`i8_costed_plans`): the waves of blocks over the 132 SMs (two
    blocks share an SM where the tile allows two and there are blocks for
    both) times a block's k-tiles and fixed cost at the tile's measured
    clocks (:data:`I8_TILES`), plus a split's int32 workspace written and
    read. Rows and columns past the edges cost as full tiles, so M = 576
    takes 192-row blocks (3 of them, none padded), a shape with too few
    tiles to fill the card splits K, and at many blocks the 128 x 128
    tiles, two an SM, hide each other's fill and epilogue. The cheapest
    wins; ties go to fewer splits, then the larger tile."""
    return min(i8_costed_plans(M, N, K))[1]


def _aligned(t: Tensor) -> Tensor:
    """``t`` itself when it is contiguous and starts on a 16-byte boundary
    (the kernels' 16-byte loads), else a fresh contiguous copy (which
    ``torch.empty`` aligns)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
    out.copy_(t)
    return out


def w8_matmul(x: Tensor, w_q: Tensor, scale: Tensor) -> Tensor:
    """x [M, K] (bf16 or f32) @ (w_q int8 [K, N] * scale f32 [N]); returns
    [M, N] in x's dtype."""
    if x.device.type == "cpu":
        return w8_matmul_plain(x, w_q, scale)
    if x.device.type == "cuda" and x.ndim == 2 and w_q.ndim == 2:
        x, w_q = _aligned(x), _aligned(w_q)
    _check_operands(x, w_q, scale)
    M, K = x.shape
    N = N_out = w_q.shape[1]
    lib = _build.load("w8_matmul")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.dtype == torch.float32:
        out = torch.empty((M, N), dtype=x.dtype, device=x.device)
        code = lib.tvc_w8_matmul_f32(x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(), M, N, K, stream)
    else:
        # the tensor-core kernel's 16-byte rows: K and N zero-padded to
        # multiples of 16 around it (zero columns of x and rows of w_q add
        # nothing; padded columns are sliced off; copies counted)
        K, N = round_up(K, 16), round_up(N, 16)
        x, w_q, scale = padded(x, (M, K), w8_matmul), padded(w_q, (K, N), w8_matmul), padded(scale, (N,), w8_matmul)
        out = torch.empty((M, N), dtype=x.dtype, device=x.device)
        bm, bn, splits, per = w8_plan(M, N, K)
        ws = torch.empty((splits, M, N), dtype=torch.float32, device=x.device) if splits > 1 else None
        code = lib.tvc_w8_matmul(
            x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
            M, N, K, bm, bn, splits, per, stream,
        )
    _build.check(code, "tvc_w8_matmul")
    w8_matmul.launches += 1
    if out.shape[1] != N_out:
        w8_matmul.copies += 1
        return out[:, :N_out].contiguous()
    return out


w8_matmul.launches = 0
w8_matmul.copies = 0


def w8_matmul_stacked(x: Tensor, w_q: Tensor, scale: Tensor, layer: int) -> Tensor:
    """x [M, K] @ (w_q [L, K, N])[layer] * (scale [L, N])[layer], weight-only."""
    layer = int(layer)
    _check_stacked(w_q, scale, layer)
    if x.device.type == "cpu":
        return w8_matmul_plain(x, w_q[layer], scale[layer])
    out = w8_matmul(x, w_q[layer], scale[layer])
    w8_matmul_stacked.launches += 1
    return out


w8_matmul_stacked.launches = 0
