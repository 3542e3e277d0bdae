"""Int8 (W8A8, dynamic per-row activations) pre-LN attention and MLP
sub-blocks of the int8 CLIP serving towers (port of
``tvc/core/pallas/quantized_layer_kernel.py``).

    fused_attention_layer_i8: x + out(MHA(qkv(LN(x)))), int8 QKV / out-proj
    fused_mlp_layer_i8:       x + proj(quick_gelu(fc(LN(x)))), int8 fc / proj

Scheme, as the JAX package's: weights symmetric per output channel, int8
``[in, out]`` with f32 scales ``[out]``, prepared once by
:func:`quantize_linear`; activations symmetric per row, quantized at run
time after the LayerNorm, after attention and after quick_gelu
(:func:`_quant_rows`); each GEMM int8 x int8 -> int32, dequantized as
``acc * row_scale * col_scale + bias`` in f32. LayerNorm, softmax and the
residual stay f32; the per-head attention products run on compute-dtype
operands with f32 accumulation.

For CUDA tensors the wrappers launch the hand-written kernels of
``tvc_torch/csrc/quantized_layer.cu`` (row-quantize, int8 tensor-core GEMM
with a dequantizing epilogue, per-head attention with an f32 output, tiled
at head widths 32 and 64, any other on the tail path): an attention layer
is 5 launches and an MLP layer 4 (one more for each GEMM whose K the plan
splits). A GEMM width that is not a multiple of 16 (the int8 tensor-map
rows) is zero-padded around the GEMM: zero activations and weight rows
change no int32 sum, zero weight columns are sliced off; each padded
operand and the sliced output is a copy, counted in ``<wrapper>.copies``.
For CPU tensors they compute the plain PyTorch versions beside them,
which follow the TPU kernel's body line by line: ``torch.round`` rounds
half to even as ``jnp.round`` does, ``h / rs`` is the same IEEE division,
and the int8 products are summed exactly (in float64, whose 53-bit
mantissa holds every int32 sum here) before the f32 dequantization. The
compute dtype is
``x.dtype``: bf16 on the serving towers, f32 on the tiny configurations
(f32 qkv and residual, as the TPU kernel computes them) and in the CPU
tests. Inference only.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import Tensor

from tvc_torch.core.kernels import _build
from tvc_torch.core.kernels.attention_layer_kernel import (
    _check_cuda_operands,
    _check_heads,
    _mm_f32,
    layernorm_f32,
)
from tvc_torch.core.kernels._pad import padded, round_up

QEPI_BF16, QEPI_GELU_F32, QEPI_RESIDUAL = 0, 1, 2
QEPI_BIAS_F32, QEPI_RESIDUAL_F32 = 5, 6  # the f32-x forms of QEPI_BF16 / QEPI_RESIDUAL


def over_127(t: Tensor) -> Tensor:
    """``t / 127`` as an IEEE division on every device (PyTorch's CUDA
    division by a Python scalar multiplies by the scalar's reciprocal,
    which can be one ulp away; the kernels and the JAX package divide)."""
    return t / torch.full((), 127.0, dtype=t.dtype, device=t.device)


def quantize_linear(w: Tensor) -> Tuple[Tensor, Tensor]:
    """Symmetric per-output-channel int8 quantization of a ``[K, N]``
    weight: ``(w_q int8 [K, N], scale f32 [N])`` with ``w ~= w_q * scale``."""
    wf = w.float()
    scale = over_127(wf.abs().amax(dim=0).clamp(min=1e-12))
    w_q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return w_q.contiguous(), scale.contiguous()


def _quant_rows(h: Tensor) -> Tuple[Tensor, Tensor]:
    """Dynamic symmetric per-row int8: ``h [M, K]`` f32 -> ``(int8 [M, K],
    scale f32 [M, 1])``."""
    rs = over_127(h.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12))
    return torch.clamp(torch.round(h / rs), -127, 127).to(torch.int8), rs


def _mm_i32(a: Tensor, b: Tensor) -> Tensor:
    """The exact int32 product of two int8 matrices, as f32 (the TPU
    kernel's ``preferred_element_type=int32`` then ``astype(f32)``)."""
    return torch.matmul(a.double(), b.double()).float()


def attention_layer_i8_reference(
    x: Tensor,
    ln_scale: Tensor,
    ln_bias: Tensor,
    wqkv_q: Tensor,
    sqkv: Tensor,
    bqkv: Tensor,
    wout_q: Tensor,
    sout: Tensor,
    bout: Tensor,
    heads: int,
    eps: float = 1e-5,
    causal: bool = False,
) -> Tensor:
    """Plain PyTorch version of :func:`fused_attention_layer_i8`."""
    cd = x.dtype
    B, T, W = x.shape
    D = W // heads
    h = layernorm_f32(x, ln_scale, ln_bias, eps).reshape(B * T, W)
    hq, hs = _quant_rows(h)
    qkv = (_mm_i32(hq, wqkv_q) * hs * sqkv.float() + bqkv.float()).to(cd)
    q, k, v = (
        t.reshape(B, T, heads, D).transpose(1, 2) for t in qkv.split(W, dim=-1)
    )
    logits = _mm_f32(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(D))  # [B, H, T, T]
    if causal:
        keep = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    w = torch.softmax(logits, dim=-1).to(cd)
    attn = _mm_f32(w, v).transpose(1, 2).reshape(B * T, W)  # f32
    aq, as_ = _quant_rows(attn)
    out = _mm_i32(aq, wout_q) * as_ * sout.float() + bout.float()
    return (x.float() + out.reshape(B, T, W)).to(x.dtype)


def mlp_layer_i8_reference(
    x: Tensor,
    ln_scale: Tensor,
    ln_bias: Tensor,
    wfc_q: Tensor,
    sfc: Tensor,
    bfc: Tensor,
    wproj_q: Tensor,
    sproj: Tensor,
    bproj: Tensor,
    eps: float = 1e-5,
) -> Tensor:
    """Plain PyTorch version of :func:`fused_mlp_layer_i8`."""
    B, T, W = x.shape
    h = layernorm_f32(x, ln_scale, ln_bias, eps).reshape(B * T, W)
    hq, hs = _quant_rows(h)
    hf = _mm_i32(hq, wfc_q) * hs * sfc.float() + bfc.float()
    g = hf * torch.sigmoid(1.702 * hf)  # quick_gelu, f32
    gq, gs = _quant_rows(g)
    out = _mm_i32(gq, wproj_q) * gs * sproj.float() + bproj.float()
    return (x.float() + out.reshape(B, T, W)).to(x.dtype)


def _quant_rows_cuda(lib, h, ln_scale, ln_bias, eps, stream) -> Tuple[Tensor, Tensor]:
    """One row-quantize launch over ``h [M, K]`` (bf16 or f32), LayerNorm
    first when ``ln_scale`` is given. Returns (int8 [M, K], f32 [M])."""
    M, K = h.shape
    q = torch.empty((M, K), dtype=torch.int8, device=h.device)
    scale = torch.empty((M,), dtype=torch.float32, device=h.device)
    has_ln = ln_scale is not None
    _build.check(
        lib.tvc_quant_rows(
            h.data_ptr(), ln_scale.data_ptr() if has_ln else None,
            ln_bias.data_ptr() if has_ln else None, q.data_ptr(), scale.data_ptr(),
            M, K, eps, int(has_ln), int(h.dtype == torch.float32), stream,
        ),
        "tvc_quant_rows",
    )
    return q, scale


def _i8_gemm(lib, a, row_scale, w, col_scale, bias, residual, out, epilogue, stream, plan=None,
             owner=None) -> None:
    """One int8 tensor-core GEMM launch (two when K is split) with its
    epilogue, tiled by ``plan`` = ``(bm, bn, splits, per)``, by default
    :func:`~tvc_torch.core.kernels.w8_matmul_kernel.i8_plan` of the shape.
    K or N not a multiple of 16 is zero-padded around the GEMM (copies
    counted in ``owner.copies``, in ``_i8_gemm.copies`` without an
    owner)."""
    from tvc_torch.core.kernels.w8_matmul_kernel import i8_plan  # that module imports this one

    M, K = a.shape
    N = w.shape[1]
    if K % 16 or N % 16:
        owner = owner or _i8_gemm
        Kp, Np = round_up(K, 16), round_up(N, 16)
        pad = lambda t, *shape: None if t is None else padded(t, shape, owner)
        out_p = out if Np == N else out.new_empty((M, Np))
        _i8_gemm(lib, pad(a, M, Kp), row_scale, pad(w, Kp, Np), pad(col_scale, Np), pad(bias, Np),
                 pad(residual, M, Np), out_p, epilogue, stream, plan)
        if Np != N:
            out.copy_(out_p[:, :N])
            owner.copies += 1
        return
    bm, bn, splits, per = i8_plan(M, N, K) if plan is None else plan
    ws = torch.empty((splits, M, N), dtype=torch.int32, device=a.device) if splits > 1 else None
    _build.check(
        lib.tvc_i8_gemm(
            a.data_ptr(), row_scale.data_ptr(), w.data_ptr(), col_scale.data_ptr(),
            None if bias is None else bias.data_ptr(), None if residual is None else residual.data_ptr(),
            out.data_ptr(), None if ws is None else ws.data_ptr(), M, N, K, epilogue, bm, bn, splits, per, stream,
        ),
        "tvc_i8_gemm",
    )


_i8_gemm.copies = 0


def fused_attention_layer_i8(
    x: Tensor,
    ln_scale: Tensor,
    ln_bias: Tensor,
    wqkv_q: Tensor,
    sqkv: Tensor,
    bqkv: Tensor,
    wout_q: Tensor,
    sout: Tensor,
    bout: Tensor,
    heads: int,
    eps: float = 1e-5,
    causal: bool = False,
) -> Tensor:
    """Pre-LN attention sub-block with int8 QKV / out-proj GEMMs: x [B, T,
    W]; wqkv_q int8 [W, 3W], wout_q int8 [W, W] from :func:`quantize_linear`
    with their f32 scales; biases and LayerNorm parameters f32."""
    if x.device.type == "cpu":
        return attention_layer_i8_reference(
            x, ln_scale, ln_bias, wqkv_q, sqkv, bqkv, wout_q, sout, bout, heads, eps, causal
        )
    B, T, W = x.shape
    _check_cuda_operands(
        x,
        [("ln_scale", ln_scale, W), ("ln_bias", ln_bias, W), ("sqkv", sqkv, 3 * W),
         ("bqkv", bqkv, 3 * W), ("sout", sout, W), ("bout", bout, W)],
        [("wqkv_q", wqkv_q, (W, 3 * W)), ("wout_q", wout_q, (W, W))],
        weight_dtype=torch.int8,
    )
    _check_heads(W, heads)
    f32 = x.dtype == torch.float32
    M = B * T
    lib = _build.load("quantized_layer")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    hq, hs = _quant_rows_cuda(lib, x.view(M, W), ln_scale, ln_bias, eps, stream)
    qkv = torch.empty((M, 3 * W), dtype=x.dtype, device=x.device)
    _i8_gemm(lib, hq, hs, wqkv_q, sqkv, bqkv, None, qkv, QEPI_BIAS_F32 if f32 else QEPI_BF16, stream,
             owner=fused_attention_layer_i8)
    attn = torch.empty((M, W), dtype=torch.float32, device=x.device)
    _build.check(
        lib.tvc_head_attention_f32(qkv.data_ptr(), attn.data_ptr(), B, T, W, heads, int(causal), int(f32), stream),
        "tvc_head_attention_f32",
    )
    aq, as_ = _quant_rows_cuda(lib, attn, None, None, eps, stream)
    out = torch.empty_like(x)
    _i8_gemm(lib, aq, as_, wout_q, sout, bout, x.view(M, W), out.view(M, W),
             QEPI_RESIDUAL_F32 if f32 else QEPI_RESIDUAL, stream, owner=fused_attention_layer_i8)
    fused_attention_layer_i8.launches += 1
    return out


fused_attention_layer_i8.launches = 0
fused_attention_layer_i8.copies = 0


def fused_mlp_layer_i8(
    x: Tensor,
    ln_scale: Tensor,
    ln_bias: Tensor,
    wfc_q: Tensor,
    sfc: Tensor,
    bfc: Tensor,
    wproj_q: Tensor,
    sproj: Tensor,
    bproj: Tensor,
    eps: float = 1e-5,
) -> Tensor:
    """Pre-LN MLP sub-block with int8 fc / proj GEMMs: x +
    proj(quick_gelu(fc(LN(x)))); wfc_q int8 [W, Wh], wproj_q int8 [Wh, W]."""
    if x.device.type == "cpu":
        return mlp_layer_i8_reference(x, ln_scale, ln_bias, wfc_q, sfc, bfc, wproj_q, sproj, bproj, eps)
    B, T, W = x.shape
    Wh = wfc_q.shape[1] if wfc_q.ndim == 2 else -1
    _check_cuda_operands(
        x,
        [("ln_scale", ln_scale, W), ("ln_bias", ln_bias, W), ("sfc", sfc, Wh),
         ("bfc", bfc, Wh), ("sproj", sproj, W), ("bproj", bproj, W)],
        [("wfc_q", wfc_q, (W, Wh)), ("wproj_q", wproj_q, (Wh, W))],
        weight_dtype=torch.int8,
    )
    M = B * T
    lib = _build.load("quantized_layer")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    hq, hs = _quant_rows_cuda(lib, x.view(M, W), ln_scale, ln_bias, eps, stream)
    g = torch.empty((M, Wh), dtype=torch.float32, device=x.device)
    _i8_gemm(lib, hq, hs, wfc_q, sfc, bfc, None, g, QEPI_GELU_F32, stream, owner=fused_mlp_layer_i8)
    gq, gs = _quant_rows_cuda(lib, g, None, None, eps, stream)
    out = torch.empty_like(x)
    epilogue = QEPI_RESIDUAL_F32 if x.dtype == torch.float32 else QEPI_RESIDUAL
    _i8_gemm(lib, gq, gs, wproj_q, sproj, bproj, x.view(M, W), out.view(M, W), epilogue, stream,
             owner=fused_mlp_layer_i8)
    fused_mlp_layer_i8.launches += 1
    return out


fused_mlp_layer_i8.launches = 0
fused_mlp_layer_i8.copies = 0
