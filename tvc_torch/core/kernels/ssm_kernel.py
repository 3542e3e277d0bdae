"""Mamba-2 selective state-space (SSM) layers, the state-space blocks of
Nemotron-H, around their GEMMs (no TPU counterpart: the JAX package has no
state-space layer).

    ssm_prepare(y [B, T, W], conv_w [C, K] f32, conv_b [C] f32, dt_bias [nh] f32,
                conv_state [B, K - 1, C], lengths [B] or None, xbc_col, dt_col)
        -> (xbc [B, T, C] in y's dtype, dt f32 [B, T, nh])
    ssm_recurrent(xbc, dt, a_log [nh] f32, d [nh] f32, state f32 [B, nh, P, N], lengths,
                  groups, dtype) -> y [B, T, nh P]
    ssm_gated_norm(y [B, T, I], z [B, T, >= I], weight [I] f32, groups, eps) -> [B, T, I]

``y`` is a row of the block's input projection: ``x | B | C`` (C = nh P + 2
groups N channels) from column ``xbc_col`` and the nh step inputs from
column ``dt_col``. ``ssm_prepare`` runs the short causal depthwise
convolution over the window ``conv_state`` (the last K - 1 inputs of each
row, updated in place to the last K - 1 valid ones) plus its bias, SiLU
rounded to y's dtype (the published convolution's output), and in f32 the
step ``dt = softplus(dt_in + dt_bias)`` per head. ``ssm_recurrent`` runs,
per head h of group ``g = h // (nh / groups)``, ``S <- exp(dt A) S + (dt
B_g) x_h^T`` with ``A = -exp(A_log)`` and ``y_h = S C_g + D x_h`` token by
token on the f32 state ``S [P, N]`` in place (the published
``torch_forward``'s order of the products), and returns y rounded to
``dtype``. ``ssm_gated_norm`` is Mamba-2's gated RMSNorm: ``y * SiLU(z)``,
normed over each group of ``I / groups`` channels, times the weight, in
f32, rounded once.

``lengths`` (int, ``[B]``) gives each row's valid tokens of the block: a
token at or past it is a pad, which writes zeros and leaves the state and
the window as they were (a right-padded prompt stops at its length).
None: every token is valid.

For CUDA tensors (bf16 activations and output; the recurrence at P = 64, N
= 128) each wrapper launches one kernel of ``tvc_torch/csrc/ssm.cu`` or
raises; for CPU tensors it computes the plain version beside it. The
kernels sum in other orders than PyTorch, so they agree with the plain
versions to f32 rounding (``tests/test_torch_nemotron_cuda.py``).
``<wrapper>.launches`` counts the calls that launched the kernel.
Inference only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from tvc_torch.core.kernels import _build
from tvc_torch.core.kernels.kda_kernel import _lengths, _rows, _stream, _valid

#: the recurrence kernel's head width and state size (csrc/ssm.cu, kP / kN)
RECURRENT_P, RECURRENT_N = 64, 128


def ssm_prepare_reference(y: Tensor, conv_w: Tensor, conv_b: Tensor, dt_bias: Tensor, conv_state: Tensor,
                          lengths: Optional[Tensor], xbc_col: int, dt_col: int) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of :func:`ssm_prepare`."""
    B, T, _ = y.shape
    C, K = conv_w.shape
    nh = dt_bias.shape[0]
    valid = _valid(lengths, B, T, y.device)
    raw = torch.cat([conv_state, y[..., xbc_col : xbc_col + C]], dim=1)  # [B, K - 1 + T, C]
    x = raw.float()
    acc = x[:, 0:T] * conv_w[:, 0]
    for j in range(1, K):  # the taps summed in order, then the bias
        acc = acc + x[:, j : j + T] * conv_w[:, j]
    xbc = F.silu(acc + conv_b).to(y.dtype) * valid[:, :, None]
    dt = F.softplus(y[..., dt_col : dt_col + nh].float() + dt_bias) * valid[:, :, None]
    n = valid.sum(dim=1)  # the last K - 1 inputs up to each row's length: raw rows n .. n + K - 2
    idx = (n[:, None] + torch.arange(K - 1, device=y.device)[None])[:, :, None].expand(B, K - 1, C)
    conv_state.copy_(raw.gather(1, idx))
    return xbc.contiguous(), dt.contiguous()


def ssm_recurrent_reference(xbc: Tensor, dt: Tensor, a_log: Tensor, d: Tensor, state: Tensor,
                            lengths: Optional[Tensor], groups: int, dtype: torch.dtype) -> Tensor:
    """Plain PyTorch version of :func:`ssm_recurrent`: the token loop."""
    B, T, _ = xbc.shape
    _, nh, P, N = state.shape
    I = nh * P
    valid = _valid(lengths, B, T, xbc.device)
    x = xbc[..., :I].float().view(B, T, nh, P)
    bm = xbc[..., I : I + groups * N].float().view(B, T, groups, N).repeat_interleave(nh // groups, dim=2)
    cm = xbc[..., I + groups * N : I + 2 * groups * N].float().view(B, T, groups, N)
    cm = cm.repeat_interleave(nh // groups, dim=2)
    A = -torch.exp(a_log.float())
    out = torch.zeros((B, T, nh, P), dtype=torch.float32, device=xbc.device)
    for t in range(T):
        dA = torch.exp(dt[:, t] * A)  # [B, nh]
        dbx = (dt[:, t, :, None] * bm[:, t])[:, :, None, :] * x[:, t, :, :, None]  # [B, nh, P, N]
        S = state * dA[:, :, None, None] + dbx
        y = torch.einsum("bhpn,bhn->bhp", S, cm[:, t]) + x[:, t] * d.float()[:, None]
        live = valid[:, t]
        out[:, t] = y * live[:, None, None]
        state.copy_(torch.where(live[:, None, None, None], S, state))
    return out.to(dtype).reshape(B, T, I)


def ssm_gated_norm_reference(y: Tensor, z: Tensor, weight: Tensor, groups: int, eps: float) -> Tensor:
    """Plain PyTorch version of :func:`ssm_gated_norm`."""
    B, T, I = y.shape
    h = y.float() * F.silu(z[..., :I].float())
    hg = h.view(B, T, groups, I // groups)
    hg = hg * torch.rsqrt(hg.square().mean(-1, keepdim=True) + eps)
    return (hg.view(B, T, I) * weight.float()).to(y.dtype)


def ssm_prepare(y: Tensor, conv_w: Tensor, conv_b: Tensor, dt_bias: Tensor, conv_state: Tensor,
                lengths: Optional[Tensor], xbc_col: int, dt_col: int) -> Tuple[Tensor, Tensor]:
    """The convolution, bias and SiLU of the x | B | C channels and the step
    of a block of tokens; returns ``(xbc, dt)`` and updates ``conv_state``.
    One launch."""
    if y.device.type == "cpu":
        return ssm_prepare_reference(y, conv_w, conv_b, dt_bias, conv_state, lengths, xbc_col, dt_col)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    B, T, _ = y.shape
    C, K = conv_w.shape
    nh = dt_bias.shape[0]
    if not 1 <= K <= 8:
        raise ValueError(f"ssm_prepare takes a convolution of at most 8 taps, got {K}")
    ldy = _rows(y, "y", B, T, max(xbc_col + C, dt_col + nh))
    if conv_state.dtype != torch.bfloat16 or tuple(conv_state.shape) != (B, K - 1, C) \
            or not conv_state.is_contiguous() or conv_state.device != y.device:
        raise ValueError(f"conv_state must be a contiguous bf16 [{B}, {K - 1}, {C}] tensor on {y.device}")
    f32 = [t.float().contiguous() for t in (conv_w, conv_b, dt_bias)]
    if tuple(f32[1].shape) != (C,) or tuple(f32[2].shape) != (nh,) or any(t.device != y.device for t in f32):
        raise ValueError(f"conv_b must be [{C}] and dt_bias [{nh}], on {y.device}")
    ln = _lengths(lengths, B, y.device)
    xbc = torch.empty((B, T, C), dtype=y.dtype, device=y.device)
    dt = torch.empty((B, T, nh), dtype=torch.float32, device=y.device)
    _build.check(
        _build.load("ssm").tvc_ssm_prepare(
            y.data_ptr(), ldy, int(xbc_col), int(dt_col), f32[0].data_ptr(), f32[1].data_ptr(), f32[2].data_ptr(),
            conv_state.data_ptr(), None if ln is None else ln.data_ptr(), xbc.data_ptr(), dt.data_ptr(),
            B, T, C, nh, K, _stream(y),
        ),
        "tvc_ssm_prepare",
    )
    ssm_prepare.launches += 1
    return xbc, dt


ssm_prepare.launches = 0


def ssm_recurrent(xbc: Tensor, dt: Tensor, a_log: Tensor, d: Tensor, state: Tensor, lengths: Optional[Tensor],
                  groups: int, dtype: torch.dtype) -> Tensor:
    """The selective-scan recurrence of a block of tokens on ``state [B, nh,
    P, N]`` in place; returns y ``[B, T, nh P]`` in ``dtype``. One launch."""
    if xbc.device.type == "cpu":
        return ssm_recurrent_reference(xbc, dt, a_log, d, state, lengths, groups, dtype)
    if xbc.device.type != "cuda":
        raise ValueError(f"unsupported device {xbc.device}")
    B, T, C = xbc.shape
    _, nh, P, N = state.shape
    if (P, N) != (RECURRENT_P, RECURRENT_N) or groups < 1 or nh % groups or C != nh * P + 2 * groups * N:
        raise ValueError(f"the recurrence kernel takes a [B, nh, {RECURRENT_P}, {RECURRENT_N}] state and x | B | C of "
                         f"nh {RECURRENT_P} + 2 groups {RECURRENT_N} channels, got {tuple(state.shape)}, "
                         f"{tuple(xbc.shape)} and {groups} groups")
    if xbc.dtype != torch.bfloat16 or not xbc.is_contiguous():
        raise ValueError(f"xbc must be a contiguous bf16 [B, T, C] tensor, got {xbc.dtype} {tuple(xbc.shape)}")
    if dt.dtype != torch.float32 or tuple(dt.shape) != (B, T, nh) or not dt.is_contiguous():
        raise ValueError(f"dt must be a contiguous float32 [{B}, {T}, {nh}] tensor")
    if state.dtype != torch.float32 or state.shape[0] != B or not state.is_contiguous() \
            or state.device != xbc.device or state.data_ptr() % 16:
        raise ValueError(f"state must be a contiguous float32 [{B}, {nh}, {P}, {N}] tensor on {xbc.device}")
    if dtype != torch.bfloat16:
        raise ValueError(f"ssm_recurrent writes bf16 on the card, not {dtype}")
    f32 = [t.float().contiguous() for t in (a_log, d)]
    if any(tuple(t.shape) != (nh,) or t.device != xbc.device for t in f32):
        raise ValueError(f"a_log and d must be [{nh}] on {xbc.device}")
    ln = _lengths(lengths, B, xbc.device)
    out = torch.empty((B, T, nh * P), dtype=dtype, device=xbc.device)
    _build.check(
        _build.load("ssm").tvc_ssm_recurrent(
            xbc.data_ptr(), dt.data_ptr(), f32[0].data_ptr(), f32[1].data_ptr(), state.data_ptr(),
            None if ln is None else ln.data_ptr(), out.data_ptr(), B, T, nh, groups, _stream(xbc),
        ),
        "tvc_ssm_recurrent",
    )
    ssm_recurrent.launches += 1
    return out


ssm_recurrent.launches = 0


def ssm_gated_norm(y: Tensor, z: Tensor, weight: Tensor, groups: int, eps: float) -> Tensor:
    """``RMSNorm_group(y * SiLU(z)) * weight``, ``[B, T, I]``. One launch."""
    if y.device.type == "cpu":
        return ssm_gated_norm_reference(y, z, weight, groups, eps)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    B, T, I = y.shape
    gs = I // max(groups, 1)
    if y.dtype != torch.bfloat16 or not y.is_contiguous() or groups < 1 or I % groups or gs % 32 or gs > 1024:
        raise ValueError(f"y must be a contiguous bf16 [B, T, I] tensor of groups of a multiple of 32 channels up to "
                         f"1,024, got {y.dtype} {tuple(y.shape)} in {groups} groups")
    ldz = _rows(z, "z", B, T, I)
    w = weight.float().contiguous()
    if tuple(w.shape) != (I,) or w.device != y.device:
        raise ValueError(f"weight must be [{I}] on {y.device}")
    out = torch.empty((B, T, I), dtype=y.dtype, device=y.device)
    _build.check(
        _build.load("ssm").tvc_ssm_gated_norm(
            y.data_ptr(), z.data_ptr(), ldz, w.data_ptr(), out.data_ptr(), B * T, groups, gs, float(eps), _stream(y),
        ),
        "tvc_ssm_gated_norm",
    )
    ssm_gated_norm.launches += 1
    return out


ssm_gated_norm.launches = 0
