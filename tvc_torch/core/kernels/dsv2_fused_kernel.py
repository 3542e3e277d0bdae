"""DeepSeek-V2's decode-layer glue, fused (no TPU counterpart: the JAX
package has no DeepSeek-V2).

    mla_rope_cache(qa [B, 1, nh (nope + rope) + r + rope], cos, sin [B, 1, 1, rope / 2],
                   suk [nh, nope], kv_norm [r], eps, cache [L, B, S, r + rope], layer, cache_index)
        -> (qn [nh, B, nope], q_pe [B, nh, rope])
    mla_out(o [nh, B, v], suv [nh, v]) -> [B, 1, nh v]
    moe_route(logits [N, E] f32, x [N, H], k, counts [E] int32 or None)
        -> (topv [N, k] f32, topi [N, k], pos [N, k] int32, xs [N k, H], offsets [E + 1] int32)
    moe_combine(yd [N k, H], pos [N, k], topv [N, k], shared [N, H], scale) -> [N, H]

``mla_rope_cache`` is the epilogue of one decode step's q|kv_a GEMM: the
interleaved YaRN rope of q_pe and k_pe (:func:`rope_interleaved`), the
latent's RMSNorm (its sum of squares in the order of PyTorch's reduction,
as ``rmsnorm``), both written into slot ``cache_index`` of layer ``layer``
of the latent cache in place, and q_nope times W_UK's scales rounded to
the model's dtype, returned as the ``[nh, B, nope]`` view the first
absorbed product reads. ``mla_out`` scales the second absorbed product's
output by W_UV's scales and lays it out for the o GEMM. ``moe_route`` is
the router after its GEMM: the f32 softmax over the experts, the top k
(weights and ids in ``torch.topk``'s order), the counts added into
``counts`` (a fresh zero row when None), the offsets (their cumulative
sum), each row-expert pair's position in the rows sorted by expert (a
stable sort: by expert, then by row) and the rows ``xs`` in that order,
which the grouped expert GEMM takes. ``moe_combine`` sums each row's
expert outputs, read at their positions, weighted by ``topv * scale``, in
f32 and adds the shared experts' output before the one rounding.

For CUDA tensors (bf16, the router's logits f32; E <= 64, k <= 32; the
hidden width and v multiples of 8) each wrapper launches
``tvc_torch/csrc/dsv2_fused.cu`` (``moe_route`` twice: the routing, then
the gather) or raises; for CPU tensors it computes the plain version
beside it (the expressions the model ran before the
kernels, moved here). On the card every kernel returns its plain
version's bits (``tests/test_torch_dsv2_cuda.py``). ``<wrapper>.launches``
counts the calls that launched the kernels. Inference only.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from tvc_torch.core.kernels import _build
from tvc_torch.core.kernels.decode_fused_kernel import _torch_lanes, apply_rope, rmsnorm_reference

ROUTE_ROWS = 16  # rows a block of the routing pass (csrc/dsv2_fused.cu, kRouteRows)
MAX_EXPERTS, MAX_TOPK = 64, 32


def rope_interleaved(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """The published rope of ``x [..., rope]``: de-interleave the pairs
    (2i, 2i + 1) into halves, then rotate-half."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    return apply_rope(x, cos, sin)


def mla_rope_cache_reference(qa: Tensor, cos: Tensor, sin: Tensor, suk: Tensor, kv_norm: Tensor, eps: float,
                             cache: Tensor, layer: int, cache_index: int) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of :func:`mla_rope_cache`."""
    B, T, W = qa.shape
    r, lw = kv_norm.shape[0], cache.shape[-1]
    nh, dn = suk.shape
    nq = W - lw
    q = qa[..., :nq].reshape(B, T, nh, nq // nh)
    q_pe = rope_interleaved(q[..., dn:], cos, sin)
    cache[layer, :, cache_index : cache_index + T, :r] = rmsnorm_reference(qa[..., nq : nq + r], kv_norm, eps)
    cache[layer, :, cache_index : cache_index + T, r:] = rope_interleaved(qa[..., None, nq + r :], cos, sin)[:, :, 0]
    qn = (q[:, 0, :, :dn].float() * suk).to(qa.dtype).transpose(0, 1)  # [nh, B, nope]
    return qn, q_pe[:, 0].contiguous()


def mla_out_reference(o: Tensor, suv: Tensor) -> Tensor:
    """Plain PyTorch version of :func:`mla_out`."""
    nh, B, dv = o.shape
    return (o.float() * suv[:, None, :]).to(o.dtype).transpose(0, 1).reshape(B, 1, nh * dv)


def moe_route_reference(logits: Tensor, x: Tensor, k: int,
                        counts: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Plain PyTorch version of :func:`moe_route`."""
    N, E = logits.shape
    topv, topi = torch.topk(torch.softmax(logits, dim=-1), k, dim=-1)
    ids = topi.reshape(-1)
    if counts is None:
        counts = torch.zeros(E, dtype=torch.int32, device=x.device)
    counts.scatter_add_(0, ids, torch.ones(N * k, dtype=torch.int32, device=x.device))
    offsets = F.pad(torch.cumsum(counts, 0, dtype=torch.int32), (1, 0))
    order = torch.argsort(ids, stable=True)
    xs = x.index_select(0, torch.div(order, k, rounding_mode="floor")).contiguous()
    pos = torch.empty(N * k, dtype=torch.int32, device=x.device)
    pos[order] = torch.arange(N * k, dtype=torch.int32, device=x.device)
    return topv, topi, pos.view(N, k), xs, offsets


def moe_combine_reference(yd: Tensor, pos: Tensor, topv: Tensor, shared: Tensor, scale: float) -> Tensor:
    """Plain PyTorch version of :func:`moe_combine`: ``yd`` unsorted (the
    rows' pairs back in row order), then the weighted sum over the k
    pairs in f32 and the shared experts' output."""
    N, k = pos.shape
    y = yd.index_select(0, pos.reshape(-1).long())
    routed = (y.view(N, k, -1).float() * (topv * scale)[:, :, None]).sum(dim=1)
    return (routed + shared.float()).to(shared.dtype)


def _stream(t: Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_card(what: str, *ts: Tensor) -> None:
    """Every operand bf16, on the first one's CUDA device."""
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for t in ts:
        if t.dtype != torch.bfloat16 or t.device != dev:
            raise ValueError(f"{what} takes bf16 operands on one device, got {t.dtype} on {t.device}")


def _f32(t: Tensor, shape, dev, name: str) -> Tensor:
    if tuple(t.shape) != tuple(shape) or t.device != dev:
        raise ValueError(f"{name} must be a {list(shape)} tensor on {dev}, got {tuple(t.shape)} on {t.device}")
    return t.float().contiguous()


def mla_rope_cache(qa: Tensor, cos: Tensor, sin: Tensor, suk: Tensor, kv_norm: Tensor, eps: float, cache: Tensor,
                   layer: int, cache_index: int) -> Tuple[Tensor, Tensor]:
    """One decode step's q|kv_a epilogue over layer ``layer`` of the latent
    cache ``[L, B, S, r + rope]``: rope, latent norm, cache write, q_nope's
    scales; returns ``(qn [nh, B, nope], q_pe [B, nh, rope])``. One launch."""
    layer, cache_index = int(layer), int(cache_index)
    if qa.device.type == "cpu":
        return mla_rope_cache_reference(qa, cos, sin, suk, kv_norm, eps, cache, layer, cache_index)
    _on_card("mla_rope_cache", qa, cache)
    L, B, S, lw = cache.shape if cache.ndim == 4 else (0,) * 4
    r, (nh, dn) = kv_norm.shape[0], suk.shape
    dr = lw - r
    if cache.ndim != 4 or not cache.is_contiguous() or not 0 <= layer < L or not 0 <= cache_index < S:
        raise ValueError(f"cache must be a contiguous [L, B, S, r + rope] tensor holding layer {layer} and slot "
                         f"{cache_index}, got {tuple(cache.shape)}")
    W = nh * (dn + dr) + lw
    if tuple(qa.shape) != (B, 1, W) or not qa.is_contiguous() or dn % 2 or dr % 4 or r % 2 or r < 2:
        raise ValueError(f"qa must be a contiguous [{B}, 1, {W}] tensor (nope, r even, rope a multiple of 4), got "
                         f"{tuple(qa.shape)}")
    half = dr // 2
    tables = [_f32(t.reshape(B, half), (B, half), qa.device, "cos / sin") for t in (cos, sin)]
    sk = _f32(suk, (nh, dn), qa.device, "suk")
    kn = _f32(kv_norm, (r,), qa.device, "kv_norm")
    qn = torch.empty((B, nh, dn), dtype=qa.dtype, device=qa.device)
    q_pe = torch.empty((B, nh, dr), dtype=qa.dtype, device=qa.device)
    _build.check(
        _build.load("dsv2_fused").tvc_mla_rope_cache(
            qa.data_ptr(), tables[0].data_ptr(), tables[1].data_ptr(), sk.data_ptr(), kn.data_ptr(),
            cache[layer].data_ptr(), qn.data_ptr(), q_pe.data_ptr(), B, nh, dn, dr, r, S, cache_index, float(eps),
            float(np.float32(B) / np.float32(B * r)), _torch_lanes(B, r), _stream(qa),
        ),
        "tvc_mla_rope_cache",
    )
    mla_rope_cache.launches += 1
    return qn.transpose(0, 1), q_pe


mla_rope_cache.launches = 0


def mla_out(o: Tensor, suv: Tensor) -> Tensor:
    """``o [nh, B, v]`` times ``suv [nh, v]`` in f32, rounded to o's dtype,
    as ``[B, 1, nh v]``. One launch."""
    if o.device.type == "cpu":
        return mla_out_reference(o, suv)
    _on_card("mla_out", o)
    nh, B, dv = o.shape
    if dv % 8:
        raise ValueError(f"mla_out takes v a multiple of 8, got {dv}")
    o = o.contiguous()
    sv = _f32(suv, (nh, dv), o.device, "suv")
    out = torch.empty((B, 1, nh * dv), dtype=o.dtype, device=o.device)
    _build.check(
        _build.load("dsv2_fused").tvc_mla_out(o.data_ptr(), sv.data_ptr(), out.data_ptr(), B, nh, dv, _stream(o)),
        "tvc_mla_out",
    )
    mla_out.launches += 1
    return out


mla_out.launches = 0

_TICKETS: Dict[Tuple[torch.device, int], Tensor] = {}


def _ticket(dev: torch.device, stream: int) -> Tensor:
    """The routing pass's ticket for calls on ``stream``: one word, 0
    between calls (the last block of each call resets it), so calls on one
    stream, which run in turn, share it and calls on two streams do not."""
    t = _TICKETS.get((dev, stream))
    if t is None:
        t = _TICKETS[dev, stream] = torch.zeros(1, dtype=torch.int32, device=dev)
    return t


def moe_route(logits: Tensor, x: Tensor, k: int,
              counts: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """The routing of ``x [N, H]`` from the router's f32 ``logits [N, E]``:
    ``(topv, topi, pos, xs, offsets)``; ``counts`` (int32 ``[E]``, or None
    for a fresh zero row) gets this call's count of each expert added. Two
    launches, for any N."""
    k = int(k)
    if x.device.type == "cpu":
        return moe_route_reference(logits, x, k, counts)
    _on_card("moe_route", x)
    N, E = logits.shape
    H = x.shape[-1]
    if logits.dtype != torch.float32 or not logits.is_contiguous() or logits.device != x.device:
        raise ValueError(f"logits must be a contiguous float32 [N, E] tensor on {x.device}")
    ldx = x.stride(0) if N > 1 else H
    if x.ndim != 2 or x.shape[0] != N or x.stride(1) != 1 or H % 8 or ldx % 8 or not 1 <= k <= min(E, MAX_TOPK) \
            or E > MAX_EXPERTS:
        raise ValueError(f"x must be [{N}, H] with unit-stride rows, H and the row stride multiples of 8, and 1 <= k "
                         f"<= E <= {MAX_EXPERTS}, k <= {MAX_TOPK}; got x {tuple(x.shape)} {x.stride()}, E {E}, k {k}")
    if counts is not None and (counts.dtype != torch.int32 or tuple(counts.shape) != (E,)
                               or not counts.is_contiguous() or counts.device != x.device):
        raise ValueError(f"counts must be a contiguous int32 [{E}] tensor on {x.device}")
    blocks = -(-N // ROUTE_ROWS)
    nk = N * k
    words = 3 * nk + 2 * E + 1 + 2 * blocks * E
    ws = torch.empty(words, dtype=torch.int32, device=x.device)
    topv = torch.empty((N, k), dtype=torch.float32, device=x.device)
    xs = torch.empty((nk, H), dtype=x.dtype, device=x.device)
    stream = _stream(x)
    _build.check(
        _build.load("dsv2_fused").tvc_moe_route(
            logits.data_ptr(), x.data_ptr(), ldx, None if counts is None else counts.data_ptr(),
            _ticket(x.device, stream).data_ptr(), ws.data_ptr(), topv.data_ptr(), xs.data_ptr(), N, E, k, H, words,
            stream,
        ),
        "tvc_moe_route",
    )
    moe_route.launches += 1
    return topv, ws[:nk].view(N, k), ws[2 * nk : 3 * nk].view(N, k), xs, ws[3 * nk : 3 * nk + E + 1]


moe_route.launches = 0


def moe_combine(yd: Tensor, pos: Tensor, topv: Tensor, shared: Tensor, scale: float) -> Tensor:
    """``sum_j yd[pos[n, j]] * topv[n, j] * scale + shared[n]`` in f32,
    rounded once to the model's dtype; ``[N, H]``. One launch."""
    if yd.device.type == "cpu":
        return moe_combine_reference(yd, pos, topv, shared, scale)
    _on_card("moe_combine", yd, shared)
    N, k = pos.shape
    H = yd.shape[-1]
    if tuple(shared.shape) != (N, H) or yd.shape[0] != N * k or H % 8 or pos.dtype != torch.int32 \
            or topv.dtype != torch.float32 or tuple(topv.shape) != (N, k) \
            or any(t.device != yd.device for t in (pos, topv)):
        raise ValueError(f"moe_combine takes yd [{N * k}, H] (H a multiple of 8), int32 pos and f32 topv [{N}, {k}], "
                         f"shared [{N}, {H}] on one device; got {tuple(yd.shape)}, {pos.dtype} {tuple(pos.shape)}, "
                         f"{topv.dtype} {tuple(topv.shape)}, {tuple(shared.shape)}")
    yd, pos, topv, shared = yd.contiguous(), pos.contiguous(), topv.contiguous(), shared.contiguous()
    out = torch.empty((N, H), dtype=yd.dtype, device=yd.device)
    _build.check(
        _build.load("dsv2_fused").tvc_moe_combine(
            yd.data_ptr(), pos.data_ptr(), topv.data_ptr(), shared.data_ptr(), out.data_ptr(), N, k, H, float(scale),
            _stream(yd),
        ),
        "tvc_moe_combine",
    )
    moe_combine.launches += 1
    return out


moe_combine.launches = 0
