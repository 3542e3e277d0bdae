"""Kimi Delta Attention (KDA), the linear-attention layers of Kimi-Linear,
around their GEMMs (no TPU counterpart: the JAX package has no linear
attention).

    kda_prepare(y [B, T, W], f [B, T, >= nh d], conv_w [3 nh d, K] f32, a_log [nh] f32,
                dt_bias [nh d] f32, conv_state [B, K - 1, 3 nh d], lengths [B] or None,
                heads, b_col) -> (qkvg f32 [B, T, nh, 4, d], beta f32 [B, T, nh])
    kda_recurrent(qkvg, beta, state f32 [B, nh, d, d], lengths, dtype) -> o [B, T, nh, d]
    kda_gated_norm(o [B, T, nh, d], gate [B, T, >= nh d], weight [d] f32, eps) -> [B, T, nh d]

``y`` is a row of the layer's merged projection: ``q | k | v`` (3 nh d
values from column 0) and, from column ``b_col``, the nh logits of beta;
``f`` holds the log-decay's input (``(x W_fa) W_fb``) from column 0.
``kda_prepare`` runs the short causal depthwise convolution over the
window ``conv_state`` (the last K - 1 inputs of each row, updated in place
to the last K - 1 valid ones), SiLU rounded to y's dtype (the published
convolution's output), then in f32: the L2 norms of q and k per head
(``x rsqrt(sum x^2 + 1e-6)``, flash-linear-attention's ``l2norm``) with q
also scaled by ``d^-1/2``, the log-decay ``g = -exp(A_log[h]) softplus(f +
dt_bias)`` and ``beta = sigmoid(b)``. ``kda_recurrent`` runs, per head,
``S <- Diag(exp g) S``, ``S <- S + beta k (v - S^T k)^T``, ``o = S^T q``
token by token on the f32 state ``S [d_k, d_v]`` in place, and returns o
rounded to ``dtype``. ``kda_gated_norm`` is the output's RMSNorm per head
times the weight and ``sigmoid(gate)``, in f32, rounded once.

``lengths`` (int, ``[B]``) gives each row's valid tokens of the block: a
token at or past it is a pad, which writes zeros and leaves the state and
the window as they were (a right-padded prompt stops at its length).
None: every token is valid.

For CUDA tensors (bf16 activations and output, the recurrence at d = 128) each
wrapper launches one kernel of ``tvc_torch/csrc/kda.cu`` or raises; for CPU
tensors it computes the plain version beside it. The kernels sum in other
orders than PyTorch, so they agree with the plain versions to f32 rounding
(``tests/test_torch_kimi_cuda.py``). ``<wrapper>.launches`` counts the
calls that launched the kernel. Inference only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from tvc_torch.core.kernels import _build

#: L2-norm epsilon of q and k (flash-linear-attention's ``l2norm`` default)
L2_EPS = 1e-6
RECURRENT_D = 128  # the recurrence kernel's head width (csrc/kda.cu, kD)


def _valid(lengths: Optional[Tensor], B: int, T: int, device) -> Tensor:
    """Bool [B, T]: which tokens of the block are real."""
    if lengths is None:
        return torch.ones((B, T), dtype=torch.bool, device=device)
    return torch.arange(T, device=device)[None] < lengths.to(device)[:, None]


def kda_prepare_reference(y: Tensor, f: Tensor, conv_w: Tensor, a_log: Tensor, dt_bias: Tensor, conv_state: Tensor,
                          lengths: Optional[Tensor], heads: int, b_col: int) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of :func:`kda_prepare`."""
    B, T, _ = y.shape
    C, K = conv_w.shape
    HD = C // 3
    d = HD // heads
    valid = _valid(lengths, B, T, y.device)
    raw = torch.cat([conv_state, y[..., :C]], dim=1)  # [B, K - 1 + T, C]
    x = raw.float()
    acc = x[:, 0:T] * conv_w[:, 0]
    for j in range(1, K):  # the taps summed in order
        acc = acc + x[:, j : j + T] * conv_w[:, j]
    a = F.silu(acc).to(y.dtype).float().view(B, T, 3, heads, d)
    q, k, v = a.unbind(2)
    q = q * torch.rsqrt(q.square().sum(-1, keepdim=True) + L2_EPS) * d ** -0.5
    k = k * torch.rsqrt(k.square().sum(-1, keepdim=True) + L2_EPS)
    fv = f[..., :HD].float() + dt_bias
    g = -torch.exp(a_log)[:, None] * F.softplus(fv.view(B, T, heads, d))
    qkvg = torch.stack([q, k, v, g], dim=3) * valid[:, :, None, None, None]
    beta = torch.sigmoid(y[..., b_col : b_col + heads].float()) * valid[:, :, None]
    # the last K - 1 inputs up to each row's length: raw rows n .. n + K - 2
    n = valid.sum(dim=1)
    idx = (n[:, None] + torch.arange(K - 1, device=y.device)[None])[:, :, None].expand(B, K - 1, C)
    conv_state.copy_(raw.gather(1, idx))
    return qkvg.contiguous(), beta.contiguous()


def kda_recurrent_reference(qkvg: Tensor, beta: Tensor, state: Tensor, lengths: Optional[Tensor],
                            dtype: torch.dtype) -> Tensor:
    """Plain PyTorch version of :func:`kda_recurrent`: the token loop."""
    B, T, nh, _, d = qkvg.shape
    valid = _valid(lengths, B, T, qkvg.device)
    out = torch.zeros((B, T, nh, d), dtype=torch.float32, device=qkvg.device)
    for t in range(T):
        q, k, v, g = qkvg[:, t].unbind(2)  # [B, nh, d]
        S = state * torch.exp(g)[..., None]
        u = v - torch.einsum("bhkv,bhk->bhv", S, k)
        S = S + beta[:, t, :, None, None] * k[..., None] * u[..., None, :]
        live = valid[:, t]
        out[:, t] = torch.einsum("bhkv,bhk->bhv", S, q) * live[:, None, None]
        state.copy_(torch.where(live[:, None, None, None], S, state))
    return out.to(dtype)


def kda_gated_norm_reference(o: Tensor, gate: Tensor, weight: Tensor, eps: float) -> Tensor:
    """Plain PyTorch version of :func:`kda_gated_norm`."""
    B, T, nh, d = o.shape
    x = o.float()
    y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * weight
    y = y * torch.sigmoid(gate[..., : nh * d].float().reshape(B, T, nh, d))
    return y.to(o.dtype).reshape(B, T, nh * d)


def _stream(t: Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _lengths(lengths: Optional[Tensor], B: int, dev) -> Optional[Tensor]:
    if lengths is None:
        return None
    if tuple(lengths.shape) != (B,) or lengths.device != dev:
        raise ValueError(f"lengths must be a [{B}] tensor on {dev}, got {tuple(lengths.shape)} on {lengths.device}")
    return lengths.to(torch.int64).contiguous()


def _rows(t: Tensor, name: str, B: int, T: int, width: int) -> int:
    """A bf16 [B, T, >= width] tensor whose rows are unit-stride and evenly
    spaced; returns the row stride."""
    if t.dtype != torch.bfloat16 or t.ndim != 3 or tuple(t.shape[:2]) != (B, T) or t.shape[2] < width \
            or t.stride(2) != 1 or (T > 1 and t.stride(0) != T * t.stride(1)):
        raise ValueError(f"{name} must be a bf16 [{B}, {T}, >= {width}] tensor with unit-stride, evenly spaced rows, "
                         f"got {t.dtype} {tuple(t.shape)} {t.stride()}")
    return t.stride(1) if T > 1 else (t.stride(0) if B > 1 else t.shape[2])


def kda_prepare(y: Tensor, f: Tensor, conv_w: Tensor, a_log: Tensor, dt_bias: Tensor, conv_state: Tensor,
                lengths: Optional[Tensor], heads: int, b_col: int) -> Tuple[Tensor, Tensor]:
    """The convolution, SiLU, norms, gate and beta of a block of tokens;
    returns ``(qkvg, beta)`` and updates ``conv_state``. One launch."""
    if y.device.type == "cpu":
        return kda_prepare_reference(y, f, conv_w, a_log, dt_bias, conv_state, lengths, heads, b_col)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    B, T, _ = y.shape
    C, K = conv_w.shape
    HD = C // 3
    d = HD // max(heads, 1)
    if heads < 1 or C != 3 * heads * d or d % 32 or d > 1024 or not 1 <= K <= 8:
        raise ValueError(f"kda_prepare takes conv_w [3 heads d, K] with d a multiple of 32 up to 1,024 and K <= 8, "
                         f"got {tuple(conv_w.shape)} at {heads} heads")
    ldy = _rows(y, "y", B, T, b_col + heads)
    ldf = _rows(f, "f", B, T, HD)
    if b_col < C:
        raise ValueError(f"b_col {b_col} lies inside q | k | v ({C} columns)")
    if conv_state.dtype != torch.bfloat16 or tuple(conv_state.shape) != (B, K - 1, C) \
            or not conv_state.is_contiguous() or conv_state.device != y.device:
        raise ValueError(f"conv_state must be a contiguous bf16 [{B}, {K - 1}, {C}] tensor on {y.device}")
    f32 = [t.float().contiguous() for t in (conv_w, a_log, dt_bias)]
    if tuple(f32[1].shape) != (heads,) or tuple(f32[2].shape) != (HD,) or any(t.device != y.device for t in f32):
        raise ValueError(f"a_log must be [{heads}] and dt_bias [{HD}], on {y.device}")
    ln = _lengths(lengths, B, y.device)
    qkvg = torch.empty((B, T, heads, 4, d), dtype=torch.float32, device=y.device)
    beta = torch.empty((B, T, heads), dtype=torch.float32, device=y.device)
    _build.check(
        _build.load("kda").tvc_kda_prepare(
            y.data_ptr(), ldy, f.data_ptr(), ldf, f32[0].data_ptr(), f32[1].data_ptr(), f32[2].data_ptr(),
            conv_state.data_ptr(), None if ln is None else ln.data_ptr(), qkvg.data_ptr(), beta.data_ptr(),
            B, T, heads, d, K, b_col, float(d ** -0.5), _stream(y),
        ),
        "tvc_kda_prepare",
    )
    kda_prepare.launches += 1
    return qkvg, beta


kda_prepare.launches = 0


def kda_recurrent(qkvg: Tensor, beta: Tensor, state: Tensor, lengths: Optional[Tensor], dtype: torch.dtype) -> Tensor:
    """The delta-rule recurrence of a block of tokens on ``state [B, nh, d,
    d]`` in place; returns o ``[B, T, nh, d]`` in ``dtype``. One launch."""
    if qkvg.device.type == "cpu":
        return kda_recurrent_reference(qkvg, beta, state, lengths, dtype)
    if qkvg.device.type != "cuda":
        raise ValueError(f"unsupported device {qkvg.device}")
    B, T, nh, _, d = qkvg.shape
    if d != RECURRENT_D or qkvg.dtype != torch.float32 or not qkvg.is_contiguous():
        raise ValueError(f"qkvg must be a contiguous float32 [B, T, nh, 4, {RECURRENT_D}] tensor, got "
                         f"{qkvg.dtype} {tuple(qkvg.shape)}")
    if beta.dtype != torch.float32 or tuple(beta.shape) != (B, T, nh) or not beta.is_contiguous():
        raise ValueError(f"beta must be a contiguous float32 [{B}, {T}, {nh}] tensor")
    if state.dtype != torch.float32 or tuple(state.shape) != (B, nh, d, d) or not state.is_contiguous() \
            or state.device != qkvg.device or state.data_ptr() % 16:
        raise ValueError(f"state must be a contiguous float32 [{B}, {nh}, {d}, {d}] tensor on {qkvg.device}")
    if dtype != torch.bfloat16:
        raise ValueError(f"kda_recurrent writes bf16 on the card, not {dtype}")
    ln = _lengths(lengths, B, qkvg.device)
    out = torch.empty((B, T, nh, d), dtype=dtype, device=qkvg.device)
    _build.check(
        _build.load("kda").tvc_kda_recurrent(
            qkvg.data_ptr(), beta.data_ptr(), state.data_ptr(), None if ln is None else ln.data_ptr(),
            out.data_ptr(), B, T, nh, _stream(qkvg),
        ),
        "tvc_kda_recurrent",
    )
    kda_recurrent.launches += 1
    return out


kda_recurrent.launches = 0


def kda_gated_norm(o: Tensor, gate: Tensor, weight: Tensor, eps: float) -> Tensor:
    """``RMSNorm(o) * weight * sigmoid(gate)`` per head, ``[B, T, nh d]``.
    One launch."""
    if o.device.type == "cpu":
        return kda_gated_norm_reference(o, gate, weight, eps)
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    B, T, nh, d = o.shape
    if o.dtype != torch.bfloat16 or not o.is_contiguous() or d % 32 or d > 256:
        raise ValueError(f"o must be a contiguous bf16 [B, T, nh, d] tensor, d a multiple of 32 up to 256, got "
                         f"{o.dtype} {tuple(o.shape)}")
    ldg = _rows(gate, "gate", B, T, nh * d)
    w = weight.float().contiguous()
    if tuple(w.shape) != (d,) or w.device != o.device:
        raise ValueError(f"weight must be [{d}] on {o.device}")
    out = torch.empty((B, T, nh * d), dtype=o.dtype, device=o.device)
    _build.check(
        _build.load("kda").tvc_kda_gated_norm(
            o.data_ptr(), gate.data_ptr(), ldg, w.data_ptr(), out.data_ptr(), B * T, nh, d, float(eps), _stream(o),
        ),
        "tvc_kda_gated_norm",
    )
    kda_gated_norm.launches += 1
    return out


kda_gated_norm.launches = 0
