"""Tensor-parallel sharding rules and the tensor-parallel forward for the
Qwen2 LM (port of ``tvc/parallel/tp.py``).

Megatron layout, the JAX package's leaf for leaf (``qwen_param_specs``
gives each leaf a PartitionSpec as a tuple: ``()`` replicated, ``(None,
"model")`` column-parallel, ``("model", None)`` row-parallel):

  q/k/v kernels  [H, heads*Dh]   -> shard output dim  (None, "model")
  o kernel       [heads*Dh, H]   -> shard input dim   ("model", None)
  gate/up        [H, I]          -> (None, "model")
  down           [I, H]          -> ("model", None)
  embed          [V, H]          -> ("model", None)   (vocab-sharded)
  lm_head        [H, V]          -> (None, "model")
  norms/biases                   -> replicated (q/k/v biases shard with
                                    their columns when divisible)

The JAX package lets XLA insert the collectives; here each rank keeps its
slice (``shard_qwen_params``) and the forward (:func:`tp_block`,
:func:`make_tp_forward`, and the decode of :class:`TPQwenModel`, which
``QwenModel(..., mesh=...)`` builds) runs the module path on the slices
with explicit collectives over the ``model`` axis: an ``all_reduce`` after the
row-parallel o and down projections, a masked lookup in the vocab-sharded
embedding plus an ``all_reduce``, and an ``all_gather`` of the
column-parallel head's logits. The partial sums are reduced in f32. int8
leaves are dequantized one layer at a time to bf16 and multiplied by plain
``torch.matmul``, as the JAX decode's module path does under TP. The
number of kv heads must be divisible by the model-axis size (Qwen2-7B: 4
kv heads, up to 4-way).
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import Tensor

from tvc_torch._device import resolve_device
from tvc_torch.core.kernels.decode_fused_kernel import apply_rope, rmsnorm
from tvc_torch.models.decoding import _flatten, _is_q, _unflatten
from tvc_torch.models.qwen import QwenModel, _gqa_attention, rope_tables
from tvc_torch.parallel.mesh import MODEL_AXIS, all_gather, all_reduce, axis_index, axis_size, mesh_device

Spec = Tuple[Optional[str], ...]


def _rebuild(tree: Mapping, fn, prefix: str = "/") -> Dict:
    return {
        k: (_rebuild(v, fn, f"{prefix}{k}/") if isinstance(v, Mapping) else fn(f"{prefix}{k}/", v))
        for k, v in tree.items()
    }


def _spec_for(path: str, leaf) -> Spec:
    if leaf.ndim < 2:
        return ()  # biases, norm scales
    if "embed" in path:
        return (MODEL_AXIS, None)  # vocab-sharded embedding
    if "/attn/q/" in path or "/attn/k/" in path or "/attn/v/" in path:
        return (None, MODEL_AXIS)  # column-parallel
    if "/attn/o/" in path:
        return (MODEL_AXIS, None)  # row-parallel
    if "/mlp/gate/" in path or "/mlp/up/" in path:
        return (None, MODEL_AXIS)
    if "/mlp/down/" in path:
        return (MODEL_AXIS, None)
    if "lm_head" in path:
        return (None, MODEL_AXIS)
    return ()


def qwen_param_specs(params: Dict[str, Any]) -> Dict[str, Any]:
    """A PartitionSpec (as a tuple) per leaf of a QwenLM parameter tree."""
    return _rebuild(params, _spec_for)


def _bias_fixup(path_str: str, spec: Spec, mesh_size: int, leaf) -> Spec:
    """q/k/v biases are per-output-feature: shard when divisible."""
    if (
        ("/attn/q/" in path_str or "/attn/k/" in path_str or "/attn/v/" in path_str)
        and leaf.ndim == 1
        and leaf.shape[0] % mesh_size == 0
    ):
        return (MODEL_AXIS,)
    return spec


def _take(leaf: Tensor, spec: Spec, t: int, r: int) -> Tensor:
    """This rank's slice of ``leaf`` under ``spec``, or the whole leaf
    when a sharded dim does not divide (tiny test configs)."""
    if any(name is not None and leaf.shape[d] % t for d, name in enumerate(spec)):
        return leaf
    for d, name in enumerate(spec):
        if name is not None:
            g = leaf.shape[d] // t
            leaf = leaf.narrow(d, r * g, g)
    return leaf


def shard_qwen_params(params: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's slices of a QwenLM parameter tree under the TP layout
    (:func:`qwen_param_specs` with the q/k/v bias fix-up), on the mesh's
    device; shardings that do not divide are dropped (the leaf stays
    whole), as the JAX package drops them."""
    t, r = axis_size(mesh, MODEL_AXIS), axis_index(mesh, MODEL_AXIS)
    dev = mesh_device(mesh)

    def place(path, leaf):
        spec = _bias_fixup(path, _spec_for(path, leaf), t, leaf)
        return _take(torch.as_tensor(leaf), spec, t, r).contiguous().to(dev)

    return _rebuild(params, place)


def _stacked_spec(path: str, leaf) -> Spec:
    col = any(s in path for s in ("/q/", "/k/", "/v/", "/gate/", "/up/"))
    row = any(s in path for s in ("/o/", "/down/"))
    last = path.rstrip("/").rsplit("/", 1)[-1]
    if col:
        if last in ("kernel", "int8") and leaf.ndim == 3:
            return (None, None, MODEL_AXIS)  # output-dim sharded
        if last in ("bias", "scale") and leaf.ndim == 2:
            return (None, MODEL_AXIS)  # per-output-feature vectors
    elif row and last in ("kernel", "int8") and leaf.ndim == 3:
        return (None, MODEL_AXIS, None)  # input-dim sharded
    # row-parallel scale is per-OUTPUT column [L, H]: replicated
    return ()


def shard_stacked_qwen_layers(stacked: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's slices of a STACKED layer tree ([L, ...] leaves, one
    QwenBlock parameter structure): the same layout with a leading
    replicated L dim, int8-aware (``{"int8": [L, in, out], "scale": [L,
    out]}``: int8 shards like its kernel, a column-parallel scale with its
    output dim, a row-parallel one stays whole)."""
    t, r = axis_size(mesh, MODEL_AXIS), axis_index(mesh, MODEL_AXIS)
    dev = mesh_device(mesh)
    return _rebuild(
        stacked, lambda p, leaf: _take(torch.as_tensor(leaf), _stacked_spec(p, leaf), t, r).contiguous().to(dev)
    )


def gather_qwen_leaf(leaf: Tensor, full_shape, mesh) -> Tensor:
    """The whole of a leaf this rank holds a slice of (``full_shape``: its
    unsharded shape), gathered over ``model``; a whole leaf passes."""
    if tuple(leaf.shape) == tuple(full_shape):
        return leaf
    (d,) = [i for i, (a, b) in enumerate(zip(leaf.shape, full_shape)) if a != b]
    return all_gather(leaf.contiguous(), mesh, MODEL_AXIS, dim=d)


# ---------------------------------------------------------------------------
# the tensor-parallel module path
# ---------------------------------------------------------------------------


def tp_weight(leaf, dtype, r: int) -> Tensor:
    """A local weight leaf in ``dtype``; int8 leaves dequantize to bf16
    first (``int8 * scale``, the JAX package's ``_dequant``). A
    column-parallel int8 leaf whose per-output scale stayed whole (the
    layout keeps gate / up / head scales replicated) takes this rank's
    slice of it."""
    if not _is_q(leaf):
        return leaf.to(dtype)
    w, s = leaf["int8"], leaf["scale"]
    if s.shape[-1] != w.shape[-1]:
        n = w.shape[-1]
        s = s[..., r * n : (r + 1) * n]
    return (w.to(torch.bfloat16) * s.to(torch.bfloat16)).to(dtype)


def _row_reduce(partial: Tensor, mesh) -> Tensor:
    """Sum the row-parallel partial products over ``model`` in f32."""
    return all_reduce(partial.float(), mesh, MODEL_AXIS).to(partial.dtype)


def tp_embed(table, tokens: Tensor, cfg, mesh) -> Tensor:
    """Rows of the (vocab-sharded) embedding for ``tokens``: each rank looks
    up the ids its rows hold, zeros elsewhere, summed over ``model``
    (exact: one nonzero term). int8 tables gather, then dequantize."""
    dt = cfg.dtype
    rows = (table["int8"] if _is_q(table) else table).shape[0]

    def look(ids):
        if _is_q(table):
            return table["int8"][ids].to(dt) * table["scale"].to(dt)
        return table[ids].to(dt)

    if rows == cfg.vocab_size:
        return look(tokens)
    local = tokens - axis_index(mesh, MODEL_AXIS) * rows
    mine = (local >= 0) & (local < rows)
    x = torch.where(mine[..., None], look(local.clamp(0, rows - 1)), 0.0)
    return all_reduce(x.float(), mesh, MODEL_AXIS).to(dt)


def tp_logits(x: Tensor, non_layer: Dict, cfg, mesh) -> Tensor:
    """f32 logits [..., vocab] of the final hidden states: the tied
    embedding's (or the column-parallel head's) local vocab columns, then
    an ``all_gather`` of the columns over ``model``."""
    r = axis_index(mesh, MODEL_AXIS)
    dt = cfg.dtype
    if cfg.tie_embeddings:
        tbl = non_layer["embed"]["embedding"]
        logits = x.to(dt) @ tp_weight(tbl, dt, r).T
    else:
        logits = x.to(dt) @ tp_weight(non_layer["lm_head"]["kernel"], dt, r)
    if logits.shape[-1] == cfg.vocab_size:
        return logits.float()
    lead = logits.shape[:-1]
    flat = logits.float().reshape(-1, logits.shape[-1])
    full = all_gather(flat.T.contiguous(), mesh, MODEL_AXIS).T  # [rows, vocab]
    return full.reshape(*lead, -1)


def tp_block(lp: Dict, h: Tensor, cos: Tensor, sin: Tensor, mask: Tensor, cfg, mesh,
             cache: Optional[Tuple[Tensor, Tensor]] = None, cache_index: int = 0, ctx: int = 0) -> Tensor:
    """One QwenBlock on this rank's heads and MLP columns.

    ``lp``: the layer's local parameter tree (unmerged q / k / v, gate /
    up); h [B, T, H] replicated; cos / sin the rope tables; ``mask`` [B, T,
    S] additive. ``cache``: this layer's KV-major (k, v) [B, KV_local, S,
    Dh], written in place at ``cache_index``; attention then reads slots
    [0, ctx + T) of it when ``ctx`` (prefix prefill) or T == 1 (decode),
    else the block's own k / v."""
    c = cfg
    dt = c.dtype
    r = axis_index(mesh, MODEL_AXIS)
    B, T, _ = h.shape
    Dh = c.hidden_size // c.num_heads

    def dense(x, name, bias=True):
        y = x.to(dt) @ tp_weight(lp["attn"][name]["kernel"], dt, r)
        return y + lp["attn"][name]["bias"].to(dt) if bias else y

    x = rmsnorm(h, lp["ln_attn"]["scale"], c.rms_eps)
    q, k, v = dense(x, "q"), dense(x, "k"), dense(x, "v")
    nh, nkv = q.shape[-1] // Dh, k.shape[-1] // Dh  # this rank's heads
    q = apply_rope(q.reshape(B, T, nh, Dh), cos, sin)
    k = apply_rope(k.reshape(B, T, nkv, Dh), cos, sin).transpose(1, 2)
    v = v.reshape(B, T, nkv, Dh).transpose(1, 2)
    if cache is not None:
        ck, cv = cache
        ck[:, :, cache_index : cache_index + T] = k
        cv[:, :, cache_index : cache_index + T] = v
        if T == 1 or ctx:
            span = cache_index + T
            k, v = ck[:, :, :span], cv[:, :, :span]
    qg = q.reshape(B, T, nkv, nh // nkv, Dh)
    out = _gqa_attention(qg, k, v, mask[..., : k.shape[2]], dt).reshape(B, T, nh * Dh)
    h = h + _row_reduce(dense(out, "o", bias=False), mesh)
    x2 = rmsnorm(h, lp["ln_mlp"]["scale"], c.rms_eps)
    mlp = lp["mlp"]
    gate = x2.to(dt) @ tp_weight(mlp["gate"]["kernel"], dt, r)
    up = x2.to(dt) @ tp_weight(mlp["up"]["kernel"], dt, r)
    act = (torch.nn.functional.silu(gate) * up).to(dt)
    return h + _row_reduce(act @ tp_weight(mlp["down"]["kernel"], dt, r), mesh)


def check_tp_config(cfg, mesh) -> None:
    """Heads and kv heads must split evenly over the ``model`` axis."""
    t = axis_size(mesh, MODEL_AXIS)
    if cfg.num_heads % t or cfg.num_kv_heads % t:
        raise ValueError(
            f"{cfg.num_heads} heads / {cfg.num_kv_heads} kv heads do not split over a {t}-way model axis"
        )


def make_tp_forward(model, mesh):
    """TP forward: ``(sharded_params, tokens [B, T]) -> logits [B, T,
    vocab]`` (f32, the same on every rank); ``sharded_params`` is this
    rank's :func:`shard_qwen_params` tree. Positions 0..T-1, causal."""
    cfg = model.config
    check_tp_config(cfg, mesh)
    dev = mesh_device(mesh)

    @torch.no_grad()
    def forward(params, tokens):
        tok = torch.as_tensor(tokens, dtype=torch.long, device=dev)
        B, T = tok.shape
        positions = torch.arange(T, device=dev)[None].expand(B, T)
        cos, sin = rope_tables(positions, cfg.hidden_size // cfg.num_heads, cfg.rope_theta)
        causal = torch.ones((T, T), dtype=torch.bool, device=dev).tril()
        mask = torch.zeros((B, T, T), device=dev).masked_fill(~causal, -math.inf)
        x = tp_embed(params["embed"]["embedding"], tok, cfg, mesh)
        for i in range(cfg.num_layers):
            x = tp_block(params[f"layer_{i}"], x, cos, sin, mask, cfg, mesh)
        x = rmsnorm(x, params["ln_f"]["scale"], cfg.rms_eps)
        return tp_logits(x, params, cfg, mesh)

    return forward


class TPQwenModel(QwenModel):
    """``QwenModel(..., mesh=...)``: the tensor-parallel implementation of
    the decode's hooks. Each rank holds its slices of every parameter and
    caches its kv heads; the decode runs :func:`tp_embed`, :func:`tp_block`
    on each layer's own tree and :func:`tp_logits`."""

    # -- where the parameters live ----------------------------------------------------
    def _device_for(self, device) -> torch.device:
        check_tp_config(self.config, self.mesh)
        dev = mesh_device(self.mesh)
        if device is not None and resolve_device(device) != dev:
            raise ValueError(f"device {device} is not the mesh's {dev}")
        return dev

    def _place(self, tree: Dict) -> Dict:
        """This rank's TP slices of a full (sub)tree of the parameters."""
        return shard_qwen_params(tree, self.mesh)

    def _quantized(self, name: str, leaf, include_embed: bool):
        """A matrix is gathered whole, quantized and cut again, so the int8
        weights and scales are the single-device model's."""
        if not (torch.is_tensor(leaf) and leaf.ndim == 2):
            return leaf
        whole = gather_qwen_leaf(leaf, self.module.get_parameter(name).shape, self.mesh)
        q = super()._quantized(name, whole, include_embed)
        return _flatten(self._place(_unflatten({name: q})))[name] if _is_q(q) else leaf

    # -- the decode's hooks ------------------------------------------------------------
    def _decode_state(self) -> Tuple[Dict, List[Dict]]:
        """(non-layer params, each layer's own tree, q / k / v and gate / up
        unmerged)."""
        p = self.params
        return ({k: v for k, v in p.items() if not k.startswith("layer_")},
                [p[f"layer_{i}"] for i in range(self.config.num_layers)])

    def _embed(self, non_layer: Dict, tokens: Tensor) -> Tensor:
        return tp_embed(non_layer["embed"]["embedding"], tokens, self.config, self.mesh)

    def _head(self, non_layer: Dict, allowed: Optional[Tensor]) -> Callable[[Tensor], Tensor]:
        head = lambda x: tp_logits(x, non_layer, self.config, self.mesh)  # noqa: E731
        return head if allowed is None else lambda x: head(x)[..., allowed]

    def _run_layers(self, layers, x, positions, mask, caches, cache_index, ctx=0, step=None):
        """Every layer through :func:`tp_block` (mask as ``QwenModel``'s);
        returns ``(h, None)``: each residual add is the layer's."""
        c = self.config
        cos, sin = rope_tables(positions, c.hidden_size // c.num_heads, c.rope_theta)
        m3 = mask[:, 0] if mask.ndim == 4 else mask[:, None]
        for l, lp in enumerate(layers):
            x = tp_block(lp, x, cos, sin, m3, c, self.mesh, (caches[0][l], caches[1][l]), cache_index, ctx)
        return x, None

    def _new_cache(self, B: int, S: int) -> Tuple[Tensor, Tensor]:
        """The KV-major caches of this rank's kv heads, zeroed."""
        c = self.config
        kv = c.num_kv_heads // axis_size(self.mesh, MODEL_AXIS)
        shape = (c.num_layers, B, kv, S, c.hidden_size // c.num_heads)
        return (torch.zeros(shape, dtype=c.dtype, device=self.device),
                torch.zeros(shape, dtype=c.dtype, device=self.device))
