"""Pre-LN attention and MLP sub-blocks of the CLIP towers (port of
``tvc/core/pallas/attention_layer_kernel.py``).

    fused_attention_layer: x + W_out . MHA(split(W_qkv . LN(x)))
    fused_mlp_layer:       x + W_proj . quick_gelu(W_fc . LN(x))

For CUDA tensors the wrappers launch the hand-written kernels of
``tvc_torch/csrc/attention_layer.cu``: a tiled bf16 tensor-core GEMM with a
LayerNorm prologue and a bias / quick_gelu / residual epilogue, and the
per-head attention of ``head_attention.cuh`` (wgmma tiles of 64 query rows,
any sequence length). An attention layer is three launches
and an MLP layer two, because the TPU kernel's VMEM-resident weights and
per-sequence qkv do not fit a Hopper block's shared memory (the source note
gives the sizes). For CPU tensors they compute the plain PyTorch versions
beside them, which follow the TPU kernel's numerics: f32 LayerNorm and
softmax, GEMMs on compute-dtype operands with f32 accumulation, f32 bias
and residual. The compute dtype is ``x.dtype`` (bf16 on the card, f32 in
the CPU tests). Inference only.

Weights keep the JAX layout ``[in, out]``.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import Tensor

from tvc_torch.core.kernels import _build

EPI_BIAS, EPI_GELU, EPI_RESIDUAL = 0, 1, 2
HEAD_DIM = 64  # the attention kernel's head width


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
    weight_dtype: torch.dtype = torch.bfloat16,
) -> None:
    """Raise unless every operand is what the kernels take: contiguous,
    on x's device, bf16 activations, ``weight_dtype`` weights and f32
    vectors."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.ndim != 3 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous bf16 [B, T, W] tensor, got {x.dtype} {tuple(x.shape)}")
    W = x.shape[2]
    if W % 8 != 0:
        raise ValueError(f"width {W} must be a multiple of 8 (16-byte loads)")
    for name, t, n in vectors:
        if t.dtype != torch.float32 or tuple(t.shape) != (n,) or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name} must be a contiguous float32 [{n}] tensor on {x.device}")
    for name, t, shape in matrices:
        if t.dtype != weight_dtype or tuple(t.shape) != shape or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name} must be a contiguous {weight_dtype} {list(shape)} tensor on {x.device}")


def _gemm(lib, a, ln_scale, ln_bias, w, bias, residual, out, M, N, K, eps, has_ln, epilogue, stream):
    ptr = lambda t: None if t is None else t.data_ptr()
    _build.check(
        lib.tvc_ln_gemm(
            ptr(a), ptr(ln_scale), ptr(ln_bias), ptr(w), ptr(bias), ptr(residual),
            ptr(out), M, N, K, eps, int(has_ln), epilogue, stream,
        ),
        "tvc_ln_gemm",
    )


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
    if W != heads * HEAD_DIM:
        raise ValueError(f"the attention kernel takes head width {HEAD_DIM}; got W={W}, heads={heads}")
    M = B * T
    lib = _build.load("attention_layer")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    qkv = torch.empty((M, 3 * W), dtype=torch.bfloat16, device=x.device)
    _gemm(lib, x, ln_scale, ln_bias, wqkv, bqkv, None, qkv, M, 3 * W, W, eps, True, EPI_BIAS, stream)
    attn = torch.empty((M, W), dtype=torch.bfloat16, device=x.device)
    _build.check(
        lib.tvc_head_attention(qkv.data_ptr(), attn.data_ptr(), B, T, W, heads, int(causal), stream),
        "tvc_head_attention",
    )
    out = torch.empty_like(x)
    _gemm(lib, attn, None, None, wout, bout, x, out, M, W, W, eps, False, EPI_RESIDUAL, stream)
    fused_attention_layer.launches += 1
    return out


fused_attention_layer.launches = 0


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
    if Wh % 8 != 0:
        raise ValueError(f"hidden width {Wh} must be a multiple of 8")
    M = B * T
    lib = _build.load("attention_layer")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    hidden = torch.empty((M, Wh), dtype=torch.bfloat16, device=x.device)
    _gemm(lib, x, ln_scale, ln_bias, wfc, bfc, None, hidden, M, Wh, W, eps, True, EPI_GELU, stream)
    out = torch.empty_like(x)
    _gemm(lib, hidden, None, None, wproj, bproj, x, out, M, W, Wh, eps, False, EPI_RESIDUAL, stream)
    fused_mlp_layer.launches += 1
    return out


fused_mlp_layer.launches = 0
