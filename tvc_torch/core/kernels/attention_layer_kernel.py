"""Pre-LN attention and MLP sub-blocks of the CLIP towers (port of
``tvc/core/pallas/attention_layer_kernel.py``).

    fused_attention_layer: x + W_out . MHA(split(W_qkv . LN(x)))
    fused_mlp_layer:       x + W_proj . quick_gelu(W_fc . LN(x))

The compute dtype is ``x.dtype``, as in the TPU kernel: bf16 on the
serving towers, f32 on the tiny configurations (and in the CPU tests).
For CUDA tensors the wrappers launch the hand-written kernels of
``tvc_torch/csrc/attention_layer.cu``: a LayerNorm row kernel (LN(x)
rounded to the compute dtype, as the TPU kernel rounds it before its
product); for bf16 a TMA-fed wgmma GEMM with a bias / quick_gelu /
residual epilogue, tiled by :func:`bf16_plan`; for f32 the same function
on the CUDA cores (no TF32); and the per-head attention of
``head_attention.cuh`` (tiled at head widths :data:`HEAD_DIMS`, any other
width on its tail path; any sequence length). Widths the bf16 GEMM's
16-byte tensor-map rows do not take (K or N not a multiple of 8) are
zero-padded around it, which changes no product; each padded operand and
the sliced output is a copy, counted in ``<wrapper>.copies``. An
attention layer is 4 launches and an MLP layer 3, one more for each GEMM
whose K the plan splits, because the TPU kernel's VMEM-resident
weights and per-sequence qkv do not fit a Hopper block's shared memory (the
source note gives the sizes). For CPU tensors they compute the plain
PyTorch versions beside them, which follow the TPU kernel's numerics: f32
LayerNorm and softmax, GEMMs on compute-dtype operands with f32
accumulation, f32 bias and residual. Inference only.

Weights keep the JAX layout ``[in, out]``, in the compute dtype.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import torch
from torch import Tensor

from tvc_torch.core.kernels import _build
from tvc_torch.core.kernels._pad import padded, round_up

EPI_BIAS, EPI_GELU, EPI_RESIDUAL = 0, 1, 2
HEAD_DIMS = (32, 64)  # the tiled attention kernels' head widths (tiny configs, every CLIP preset)
SMS = 132  # streaming multiprocessors of an H100 SXM

BF16_BK = 64  # the bf16 GEMM's k-tile: one 128-byte swizzled row of bf16
#: the bf16 GEMM's tiles (bm, bn) -> (blocks an SM holds, SM clocks a
#: 64-deep k-tile takes, SM clocks of a block's fill and epilogue): clocks
#: at 1.755 GHz fitted to ``scripts/sweep_bf16_gemm.py``'s times of every
#: tile at the 16 layer GEMMs of the CLIP presets on an H100 (a pair of
#: co-resident blocks costs twice its row, as they share the SM)
BF16_TILES = {
    (128, 256): (1, 1293, 16180),
    (128, 192): (1, 1002, 12614),
    (128, 128): (2, 701, 6632),
    (64, 128): (2, 453, 4154),
}
BF16_MAX_SPLITS = 8
#: device-memory bytes a clock that a split's f32 workspace moves at
BF16_BYTES_PER_CLOCK = 2832


def bf16_costed_plans(M: int, N: int, K: int):
    """Every tile and split :func:`bf16_plan` weighs for an [M, K] x [K, N]
    product, as ``((cost in SM clocks, splits, -bm bn), (bm, bn, splits,
    per))``."""
    cdiv = lambda a, b: -(-a // b)
    nk = cdiv(K, BF16_BK)
    for (bm, bn), (per_sm, tile_clocks, block_clocks) in BF16_TILES.items():
        tiles = cdiv(M, bm) * cdiv(N, bn)
        for per in sorted({cdiv(nk, s) for s in range(1, min(nk, BF16_MAX_SPLITS) + 1)}, reverse=True):
            splits = cdiv(nk, per)
            blocks = tiles * splits
            share = min(per_sm, cdiv(blocks, SMS))  # blocks that share an SM
            cost = cdiv(blocks, SMS * share) * share * (per * tile_clocks + block_clocks)
            if splits > 1:
                cost += 4 * (splits + 1) * M * N / BF16_BYTES_PER_CLOCK
            yield (cost, splits, -bm * bn), (bm, bn, splits, per)


@functools.lru_cache(maxsize=4096)
def bf16_plan(M: int, N: int, K: int):
    """The bf16 GEMM's tiling for an [M, K] x [K, N] product: ``(bm, bn,
    splits, per)``: bm x bn output tiles (one of :data:`BF16_TILES`) and
    ``splits`` ranges of ``per`` 64-deep k-tiles each (the last range may
    hold fewer; TMA fills K's tail with zeros). A pure function of the
    shape, cached.

    Each candidate is costed in SM clocks (:func:`bf16_costed_plans`): the
    waves of blocks over the 132 SMs (two blocks share an SM where the tile
    allows two and there are blocks for both) times a block's k-tiles and
    fixed cost at the tile's clocks (:data:`BF16_TILES`), plus a split's f32
    workspace written and read. Rows and columns past the edges cost as
    full tiles, so a shape whose 128 x 128 tiles come to just over one wave
    (M = 3,200, N = 768: 150 tiles) takes wider tiles in one wave instead
    of leaving a tail. The cheapest wins; ties go to fewer splits, then the
    larger tile."""
    return min(bf16_costed_plans(M, N, K))[1]


def layernorm_f32(x: Tensor, scale: Tensor, bias: Tensor, eps: float = 1e-5) -> Tensor:
    """LayerNorm in f32 (two-pass variance), returns f32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def _mm_f32(a: Tensor, b: Tensor) -> Tensor:
    """Product of the operands' values with f32 accumulation (the TPU
    kernel's ``preferred_element_type=f32``)."""
    return torch.matmul(a.float(), b.float())


def attention_layer_reference(
    x: Tensor,
    ln_scale: Tensor,
    ln_bias: Tensor,
    wqkv: Tensor,
    bqkv: Tensor,
    wout: Tensor,
    bout: Tensor,
    heads: int,
    eps: float = 1e-5,
    causal: bool = False,
) -> Tensor:
    """Plain PyTorch version of :func:`fused_attention_layer`."""
    cd = x.dtype
    B, T, W = x.shape
    D = W // heads
    h = layernorm_f32(x, ln_scale, ln_bias, eps).to(cd).reshape(B * T, W)
    qkv = (_mm_f32(h, wqkv.to(cd)) + bqkv.float()).to(cd)
    q, k, v = (
        t.reshape(B, T, heads, D).transpose(1, 2) for t in qkv.split(W, dim=-1)
    )
    logits = _mm_f32(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(D))  # [B, H, T, T]
    if causal:
        keep = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    w = torch.softmax(logits, dim=-1).to(cd)
    attn = _mm_f32(w, v).to(cd).transpose(1, 2).reshape(B * T, W)
    out = _mm_f32(attn, wout.to(cd)) + bout.float()
    return (x.float() + out.reshape(B, T, W)).to(x.dtype)


def mlp_layer_reference(
    x: Tensor,
    ln_scale: Tensor,
    ln_bias: Tensor,
    wfc: Tensor,
    bfc: Tensor,
    wproj: Tensor,
    bproj: Tensor,
    eps: float = 1e-5,
) -> Tensor:
    """Plain PyTorch version of :func:`fused_mlp_layer`."""
    cd = x.dtype
    B, T, W = x.shape
    h = layernorm_f32(x, ln_scale, ln_bias, eps).to(cd).reshape(B * T, W)
    h = _mm_f32(h, wfc.to(cd)) + bfc.float()
    h = (h * torch.sigmoid(1.702 * h)).to(cd)  # quick_gelu
    out = _mm_f32(h, wproj.to(cd)) + bproj.float()
    return (x.float() + out.reshape(B, T, W)).to(x.dtype)


def _check_cuda_operands(
    x: Tensor,
    vectors: Sequence[Tuple[str, Tensor, int]],
    matrices: Sequence[Tuple[str, Tensor, Tuple[int, int]]],
    weight_dtype: torch.dtype = None,
) -> None:
    """Raise unless every operand is what the kernels take: contiguous,
    16-byte aligned, on x's device, bf16 or f32 activations, weights of
    ``weight_dtype`` (by default x's dtype) and f32 vectors."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.ndim != 3 or x.dtype not in (torch.bfloat16, torch.float32) or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous bf16 or float32 [B, T, W] tensor, got {x.dtype} {tuple(x.shape)}")
    weight_dtype = x.dtype if weight_dtype is None else weight_dtype
    for name, t, n in vectors:
        if t.dtype != torch.float32 or tuple(t.shape) != (n,) or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name} must be a contiguous float32 [{n}] tensor on {x.device}")
    for name, t, shape in matrices:
        if t.dtype != weight_dtype or tuple(t.shape) != shape or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name} must be a contiguous {weight_dtype} {list(shape)} tensor on {x.device}")
    for name, t in (("x", x), *((name, t) for name, t, _ in matrices)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (tensor-map loads)")


def _check_heads(W: int, heads: int) -> None:
    if heads <= 0 or W % heads:
        raise ValueError(f"width {W} must split into {heads} heads")


def _layernorm_rows(lib, x: Tensor, ln_scale, ln_bias, eps, stream) -> Tensor:
    """LN(x) of x [M, W] rounded to x's dtype: one launch."""
    M, W = x.shape
    y = torch.empty_like(x)
    _build.check(
        lib.tvc_layernorm_rows(x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), y.data_ptr(), M, W, eps,
                               int(x.dtype == torch.float32), stream),
        "tvc_layernorm_rows",
    )
    return y


def _gemm(lib, a: Tensor, w: Tensor, bias: Tensor, residual, epilogue: int, stream, plan=None,
          owner=None) -> Tensor:
    """epilogue(a [M, K] . w [K, N]) in a's dtype: the bf16 tensor-core GEMM
    tiled by ``plan`` = ``(bm, bn, splits, per)`` (by default
    :func:`bf16_plan` of the shape; two launches when K is split), or the
    f32 CUDA-core GEMM. A bf16 K or N that is not a multiple of 8 is
    zero-padded around the GEMM (copies counted in ``owner.copies``, in
    ``_gemm.copies`` without an owner)."""
    M, K = a.shape
    N = w.shape[1]
    if a.dtype == torch.bfloat16 and (K % 8 or N % 8):
        owner = owner or _gemm
        Kp, Np = round_up(K, 8), round_up(N, 8)
        out = _gemm(lib, padded(a, (M, Kp), owner), padded(w, (Kp, Np), owner), padded(bias, (Np,), owner),
                    None if residual is None else padded(residual, (M, Np), owner), epilogue, stream, plan)
        if Np == N:
            return out
        owner.copies += 1
        return out[:, :N].contiguous()
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    if a.dtype == torch.float32:
        code = lib.tvc_f32_gemm(a.data_ptr(), w.data_ptr(), bias.data_ptr(), ptr(residual), out.data_ptr(),
                                M, N, K, epilogue, stream)
    else:
        bm, bn, splits, per = bf16_plan(M, N, K) if plan is None else plan
        ws = torch.empty((splits, M, N), dtype=torch.float32, device=a.device) if splits > 1 else None
        code = lib.tvc_bf16_gemm(a.data_ptr(), w.data_ptr(), bias.data_ptr(), ptr(residual), out.data_ptr(),
                                 ptr(ws), M, N, K, epilogue, bm, bn, splits, per, stream)
    _build.check(code, "tvc_f32_gemm" if a.dtype == torch.float32 else "tvc_bf16_gemm")
    return out


_gemm.copies = 0


def fused_attention_layer(
    x: Tensor,
    ln_scale: Tensor,
    ln_bias: Tensor,
    wqkv: Tensor,
    bqkv: Tensor,
    wout: Tensor,
    bout: Tensor,
    heads: int,
    eps: float = 1e-5,
    causal: bool = False,
) -> Tensor:
    """One pre-LN attention sub-block: x [B, T, W]; wqkv [W, 3W]; wout
    [W, W]; biases and LayerNorm parameters f32. Returns x + attn(LN(x))."""
    if x.device.type == "cpu":
        return attention_layer_reference(
            x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, heads, eps, causal
        )
    B, T, W = x.shape
    _check_cuda_operands(
        x,
        [("ln_scale", ln_scale, W), ("ln_bias", ln_bias, W), ("bqkv", bqkv, 3 * W), ("bout", bout, W)],
        [("wqkv", wqkv, (W, 3 * W)), ("wout", wout, (W, W))],
    )
    _check_heads(W, heads)
    M = B * T
    lib = _build.load("attention_layer")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    h = _layernorm_rows(lib, x.view(M, W), ln_scale, ln_bias, eps, stream)
    qkv = _gemm(lib, h, wqkv, bqkv, None, EPI_BIAS, stream, owner=fused_attention_layer)
    attn = torch.empty((M, W), dtype=x.dtype, device=x.device)
    _build.check(
        lib.tvc_head_attention(qkv.data_ptr(), attn.data_ptr(), B, T, W, heads, int(causal),
                               int(x.dtype == torch.float32), stream),
        "tvc_head_attention",
    )
    out = _gemm(lib, attn, wout, bout, x.view(M, W), EPI_RESIDUAL, stream, owner=fused_attention_layer)
    fused_attention_layer.launches += 1
    return out.view(B, T, W)


fused_attention_layer.launches = 0
fused_attention_layer.copies = 0


def fused_mlp_layer(
    x: Tensor,
    ln_scale: Tensor,
    ln_bias: Tensor,
    wfc: Tensor,
    bfc: Tensor,
    wproj: Tensor,
    bproj: Tensor,
    eps: float = 1e-5,
) -> Tensor:
    """Pre-LN MLP sub-block: x + proj(quick_gelu(fc(LN(x)))); wfc [W, Wh],
    wproj [Wh, W]."""
    if x.device.type == "cpu":
        return mlp_layer_reference(x, ln_scale, ln_bias, wfc, bfc, wproj, bproj, eps)
    B, T, W = x.shape
    Wh = wfc.shape[1] if wfc.ndim == 2 else -1
    _check_cuda_operands(
        x,
        [("ln_scale", ln_scale, W), ("ln_bias", ln_bias, W), ("bfc", bfc, Wh), ("bproj", bproj, W)],
        [("wfc", wfc, (W, Wh)), ("wproj", wproj, (Wh, W))],
    )
    M = B * T
    lib = _build.load("attention_layer")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    h = _layernorm_rows(lib, x.view(M, W), ln_scale, ln_bias, eps, stream)
    hidden = _gemm(lib, h, wfc, bfc, None, EPI_GELU, stream, owner=fused_mlp_layer)
    out = _gemm(lib, hidden, wproj, bproj, x.view(M, W), EPI_RESIDUAL, stream, owner=fused_mlp_layer)
    fused_mlp_layer.launches += 1
    return out.view(B, T, W)


fused_mlp_layer.launches = 0
fused_mlp_layer.copies = 0
