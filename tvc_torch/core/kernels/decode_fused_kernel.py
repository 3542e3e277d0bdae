"""The elementwise steps of a decoder layer, fused (no TPU counterpart: the
JAX package leaves them to XLA).

    rmsnorm(x [..., W], scale [W], eps) -> [..., W], x's dtype
    add_rmsnorm(h, y [..., W], scale [W], eps) -> (h + y, rmsnorm(h + y))
    qkv_rope_cache(qkv [B, 1, (nh + 2 kv) D], bias, cos, sin [B, 1, 1, D / 2],
                   ck, cv [L, B, kv, S, D], layer, cache_index) -> q [B, kv, nh / kv, D]
    qkv_cache(qkv [B, 1, (nh + 2 kv) D], ck, cv [L, B, kv, S, D], layer, cache_index)
        -> q [B, kv, nh / kv, D]
    silu_mul(gu [..., 2 I], I) -> [..., I]
    relu2(u [...]) -> [...]

``rmsnorm`` is the decoders' RMSNorm: f32 statistics, ``x * rsqrt(mean(x^2)
+ eps) * scale`` in f32, rounded to x's dtype; the kernel sums the squares
in the order of PyTorch's own reduction kernel (read off torch 2.11 on the
card), so that it returns the plain version's bits there. ``add_rmsnorm``
first forms the residual stream ``h + y``, rounded as PyTorch's add of two
tensors of that dtype rounds, and returns it with its norm: the layer
loops carry each residual branch's output into the next norm. ``qkv_rope_cache`` is the
epilogue of one decode step's q|k|v GEMM: the bias, the half-split rotary
embedding of q and k (``apply_rope``, f32 products), k and v written into
slot ``cache_index`` of layer ``layer`` of the KV-major caches in place,
and q returned as the contiguous ``[B, kv, R, D]`` tensor the decode
attention reads; ``qkv_cache`` is the same epilogue for attention with
no bias and no rotary embedding (Nemotron-H's): the cache write and q, the
values as they are. ``silu_mul`` is the SiLU-gated product of an MLP, SiLU
rounded to gu's dtype, then the product; ``relu2`` the squared ReLU of a
non-gated one, ``F.relu(u).square()``.

For CUDA tensors (bf16 or f32) each wrapper launches one kernel of
``tvc_torch/csrc/decode_fused.cu`` or raises; for CPU tensors it computes
the plain version beside it (the expressions the models ran before the
kernels, moved here). On the card every kernel is bit-equal to its plain
version (``tests/test_torch_decode_fused.py``). ``<wrapper>.launches`` counts the calls that
launched the kernel. Inference only.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from tvc_torch.core.kernels import _build

DTYPES = (torch.bfloat16, torch.float32)


def rmsnorm_reference(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    """Plain PyTorch version of :func:`rmsnorm`."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


def add_rmsnorm_reference(h: Tensor, y: Tensor, scale: Tensor, eps: float) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of :func:`add_rmsnorm`."""
    h = h + y
    return h, rmsnorm_reference(h, scale, eps)


def apply_rope(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """The half-split rotary embedding of ``x [..., D]`` in f32, rounded to
    x's dtype (cos / sin broadcast against ``x``'s halves)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def qkv_rope_cache_reference(qkv: Tensor, bias: Tensor, cos: Tensor, sin: Tensor, ck: Tensor, cv: Tensor,
                             layer: int, cache_index: int) -> Tensor:
    """Plain PyTorch version of :func:`qkv_rope_cache`."""
    _, B, kv, _, D = ck.shape
    qkv = qkv.reshape(B, 1, -1) + bias.to(qkv.dtype)
    nq = qkv.shape[-1] - 2 * kv * D
    q = apply_rope(qkv[..., :nq].reshape(B, 1, nq // D, D), cos, sin)
    k = apply_rope(qkv[..., nq : nq + kv * D].reshape(B, 1, kv, D), cos, sin)
    v = qkv[..., nq + kv * D :].reshape(B, 1, kv, D)
    ck[layer, :, :, cache_index : cache_index + 1] = k.transpose(1, 2)
    cv[layer, :, :, cache_index : cache_index + 1] = v.transpose(1, 2)
    return q.reshape(B, kv, nq // (kv * D), D).contiguous()


def qkv_cache_reference(qkv: Tensor, ck: Tensor, cv: Tensor, layer: int, cache_index: int) -> Tensor:
    """Plain PyTorch version of :func:`qkv_cache`."""
    _, B, kv, _, D = ck.shape
    qkv = qkv.reshape(B, 1, -1)
    nq = qkv.shape[-1] - 2 * kv * D
    k = qkv[..., nq : nq + kv * D].reshape(B, 1, kv, D)
    v = qkv[..., nq + kv * D :].reshape(B, 1, kv, D)
    ck[layer, :, :, cache_index : cache_index + 1] = k.transpose(1, 2)
    cv[layer, :, :, cache_index : cache_index + 1] = v.transpose(1, 2)
    return qkv[..., :nq].reshape(B, kv, nq // (kv * D), D).contiguous()


def silu_mul_reference(gu: Tensor, I: int) -> Tensor:
    """Plain PyTorch version of :func:`silu_mul`."""
    return (F.silu(gu[..., :I]) * gu[..., I:]).to(gu.dtype)


def relu2_reference(u: Tensor) -> Tensor:
    """Plain PyTorch version of :func:`relu2`."""
    return F.relu(u).square()


def _stream(t: Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_card(*ts: Tensor) -> None:
    """Every operand bf16 or f32 like the first, on its CUDA device."""
    dev, dt = ts[0].device, ts[0].dtype
    if dt not in DTYPES:
        raise ValueError(f"the fused decode kernels take bf16 or float32, got {dt}")
    for t in ts:
        if t.dtype != dt or t.device != dev:
            raise ValueError(f"operands must share dtype and device: {t.dtype} on {t.device}, {dt} on {dev}")
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")


def _scale_f32(scale: Tensor, W: int, dev) -> Tensor:
    if scale.shape != (W,) or scale.device != dev:
        raise ValueError(f"scale must be a [{W}] tensor on {dev}, got {tuple(scale.shape)} on {scale.device}")
    return scale.float().contiguous()


def _row_stride(x: Tensor) -> int:
    """The stride of x's rows [..., W] when its leading dims fold into one
    uniformly strided dim over unit-stride rows, else 0."""
    if x.shape[-1] > 1 and x.stride(-1) != 1:
        return 0
    ld = step = None
    for d in range(x.ndim - 2, -1, -1):
        if x.shape[d] == 1:
            continue
        if ld is None:
            ld = step = x.stride(d)
        elif x.stride(d) != step:
            return 0
        step *= x.shape[d]
    if ld is None:
        return x.shape[-1]
    return ld if ld >= x.shape[-1] else 0


def _torch_lanes(rows: int, W: int) -> int:
    """The block width PyTorch's CUDA reduction kernel takes for the mean
    over the last dim of a contiguous f32 ``[rows, W]`` (``Reduce.cuh``:
    ``setReduceConfig``, ``set_block_dimension``, 512 threads a block; 4-wide
    vectors from 128 values): the norm kernel gives each row as many lanes
    and sums in that kernel's order, so that its statistics are the plain
    version's bits (at the models' widths; from ``W / lanes`` of 256 values
    a lane PyTorch also splits a row across warps)."""
    dim0 = W // 4 if W >= 128 else W
    p0 = 512 if dim0 >= 512 else 1 << (dim0.bit_length() - 1)
    p1 = 512 if rows >= 512 else 1 << (rows.bit_length() - 1)
    height = min(p1, 512 // min(p0, 32))
    return min(p0, 512 // height)


def _norm(x: Tensor, y, scale: Tensor, eps: float):
    W = x.shape[-1]
    sc = _scale_f32(scale, W, x.device)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    h = None
    if y is None:
        ld = _row_stride(x)
        if not ld:
            x = x.contiguous()
            ld = W
    else:
        if y.shape != x.shape:
            raise ValueError(f"h and y must have one shape, got {tuple(x.shape)} and {tuple(y.shape)}")
        x, y, ld = x.contiguous(), y.contiguous(), W
        h = torch.empty_like(x)
    rows = x.numel() // W if W else 0
    if rows:
        factor = float(np.float32(rows) / np.float32(rows * W))  # the plain mean's float(rows) / numel
        _build.check(
            _build.load("decode_fused").tvc_rmsnorm_rows(
                x.data_ptr(), None if y is None else y.data_ptr(), sc.data_ptr(), None if h is None else h.data_ptr(),
                out.data_ptr(), rows, W, ld, float(eps), factor, _torch_lanes(rows, W),
                int(x.dtype == torch.float32), _stream(x),
            ),
            "tvc_rmsnorm_rows",
        )
    return h, out


def rmsnorm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    """RMSNorm of the rows of ``x [..., W]`` (unit-stride rows, any uniform
    row stride) times ``scale``; one launch."""
    if x.device.type == "cpu":
        return rmsnorm_reference(x, scale, eps)
    _on_card(x)
    _, out = _norm(x, None, scale, eps)
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0


def add_rmsnorm(h: Tensor, y: Tensor, scale: Tensor, eps: float) -> Tuple[Tensor, Tensor]:
    """``(h + y, rmsnorm(h + y, scale, eps))`` in one launch."""
    if h.device.type == "cpu":
        return add_rmsnorm_reference(h, y, scale, eps)
    _on_card(h, y)
    out = _norm(h, y, scale, eps)
    add_rmsnorm.launches += 1
    return out


add_rmsnorm.launches = 0


def _qkv_shapes(qkv: Tensor, ck: Tensor, cv: Tensor, layer: int, cache_index: int):
    """``(B, nh, kv, D, S, W)`` of a q|k|v epilogue's operands on the card,
    checked."""
    _on_card(qkv, ck, cv)
    L, B, kv, S, D = ck.shape if ck.ndim == 5 else (0,) * 5
    W = qkv.shape[-1]
    if ck.ndim != 5 or cv.shape != ck.shape or not ck.is_contiguous() or not cv.is_contiguous() \
            or not 0 <= layer < L or not 0 <= cache_index < S or D % 2:
        raise ValueError(f"ck, cv must be contiguous [L, B, kv, S, D] caches (D even) holding layer {layer} and slot "
                         f"{cache_index}, got {tuple(ck.shape)} and {tuple(cv.shape)}")
    nh = W // D - 2 * kv
    if qkv.numel() != B * W or W % D or nh < kv or nh % kv:
        raise ValueError(f"qkv must hold {B} rows of (nh + 2 x {kv}) x {D} values, nh a multiple of {kv}; got "
                         f"{tuple(qkv.shape)}")
    return B, nh, kv, D, S, W


def qkv_rope_cache(qkv: Tensor, bias: Tensor, cos: Tensor, sin: Tensor, ck: Tensor, cv: Tensor, layer: int,
                   cache_index: int) -> Tensor:
    """One decode step's q|k|v epilogue over layer ``layer`` of the stacked
    caches ``[L, B, kv, S, D]``: bias, rotary embedding, cache write; returns
    q ``[B, kv, nh / kv, D]``."""
    layer, cache_index = int(layer), int(cache_index)
    if qkv.device.type == "cpu":
        return qkv_rope_cache_reference(qkv, bias, cos, sin, ck, cv, layer, cache_index)
    B, nh, kv, D, S, W = _qkv_shapes(qkv, ck, cv, layer, cache_index)
    half = D // 2
    tables = [t.float().contiguous() for t in (cos, sin)]
    if any(t.numel() != B * half or t.device != qkv.device for t in tables):
        raise ValueError(f"cos, sin must hold [{B}, {half}] angles on {qkv.device}")
    b = _scale_f32(bias, W, qkv.device)
    qkv = qkv.contiguous()
    q = torch.empty((B, kv, nh // kv, D), dtype=qkv.dtype, device=qkv.device)
    _build.check(
        _build.load("decode_fused").tvc_qkv_rope_cache(
            qkv.data_ptr(), b.data_ptr(), tables[0].data_ptr(), tables[1].data_ptr(), ck[layer].data_ptr(),
            cv[layer].data_ptr(), q.data_ptr(), B, nh, kv, D, S, cache_index, int(qkv.dtype == torch.float32),
            _stream(qkv),
        ),
        "tvc_qkv_rope_cache",
    )
    qkv_rope_cache.launches += 1
    return q


qkv_rope_cache.launches = 0


def qkv_cache(qkv: Tensor, ck: Tensor, cv: Tensor, layer: int, cache_index: int) -> Tensor:
    """One decode step's q|k|v epilogue without bias or rotary embedding:
    k and v into slot ``cache_index`` of layer ``layer`` of the stacked
    caches ``[L, B, kv, S, D]``; returns q ``[B, kv, nh / kv, D]``."""
    layer, cache_index = int(layer), int(cache_index)
    if qkv.device.type == "cpu":
        return qkv_cache_reference(qkv, ck, cv, layer, cache_index)
    B, nh, kv, D, S, _ = _qkv_shapes(qkv, ck, cv, layer, cache_index)
    qkv = qkv.contiguous()
    q = torch.empty((B, kv, nh // kv, D), dtype=qkv.dtype, device=qkv.device)
    _build.check(
        _build.load("decode_fused").tvc_qkv_cache(
            qkv.data_ptr(), ck[layer].data_ptr(), cv[layer].data_ptr(), q.data_ptr(), B, nh, kv, D, S, cache_index,
            int(qkv.dtype == torch.float32), _stream(qkv),
        ),
        "tvc_qkv_cache",
    )
    qkv_cache.launches += 1
    return q


qkv_cache.launches = 0


def silu_mul(gu: Tensor, I: int) -> Tensor:
    """``silu(gu[..., :I]) * gu[..., I:]`` in gu's dtype; one launch."""
    I = int(I)
    if gu.device.type == "cpu":
        return silu_mul_reference(gu, I)
    _on_card(gu)
    if gu.shape[-1] != 2 * I or I < 1:
        raise ValueError(f"gu must be [..., 2 x {I}], got {tuple(gu.shape)}")
    gu = gu.contiguous()
    out = torch.empty((*gu.shape[:-1], I), dtype=gu.dtype, device=gu.device)
    _build.check(
        _build.load("decode_fused").tvc_silu_mul(
            gu.data_ptr(), out.data_ptr(), gu.numel() // (2 * I), I, int(gu.dtype == torch.float32), _stream(gu),
        ),
        "tvc_silu_mul",
    )
    silu_mul.launches += 1
    return out


silu_mul.launches = 0


def relu2(u: Tensor) -> Tensor:
    """``relu(u)^2`` in u's dtype; one launch."""
    if u.device.type == "cpu":
        return relu2_reference(u)
    _on_card(u)
    u = u.contiguous()
    out = torch.empty_like(u)
    _build.check(
        _build.load("decode_fused").tvc_relu2(u.data_ptr(), out.data_ptr(), u.numel(), int(u.dtype == torch.float32),
                                              _stream(u)),
        "tvc_relu2",
    )
    relu2.launches += 1
    return out


relu2.launches = 0
