"""Qwen2 decoder-only LM in PyTorch (port of ``tvc/models/qwen.py``):
paraphrase generation for the text variants of full TVC.

* ``QwenConfig`` presets (tiny, 0.5B default, 1.5B, 7B) and ``quant_gemm``.
* The module path: ``RMSNorm``, ``rope``, ``QwenAttention``, ``QwenMLP``,
  ``QwenBlock``, ``QwenLM`` as ``nn.Module``s named like the flax tree
  (Dense kernels ``[in, out]``); ``QwenLM.apply(params, ...)`` runs the full
  forward on a parameter tree, int8 leaves dequantized as the JAX
  package's ``_dequant`` does.
* ``QwenModel``: parameters (seeded random init, optionally straight to
  int8 layer by layer), the stacked-layer decode (q|k|v and gate|up merged,
  a KV-major cache updated in place, prefix-shared prefill, ``n_samples``
  tiling, the constrained head, top-50 sampling, early exit) and the
  paraphrase / translate entry points. It runs on the card unless given
  ``device="cpu"``.

The int8 GEMMs of the decode route as the JAX package routes them
(``QwenConfig.quant_gemm``): under ``"w8a8"`` every one goes through the
W8A8 kernel (``w8a8_matmul`` / ``w8a8_matmul_stacked``; both of the JAX
package's W8A8 routes sum int32 exactly, so one kernel serves every
block); under the default ``"w8"`` an activation block of at most
``W8_MAX_ROWS`` rows goes through the weight-only kernel (``w8_matmul`` /
``w8_matmul_stacked``) and a larger one (the suffix prefill) through the
dequantize-then-matmul ``w8_matmul_reference``, a plain matmul as the JAX
package leaves it to XLA. Every decode step's attention goes through
``decode_gqa_attention_stacked``; the prefill attention, norms, rope, the
tied head and sampling are plain PyTorch, as the JAX package leaves them
to XLA. Sampling uses an explicit ``torch.Generator`` and an exact top-50:
the draws are not ``jax.random``'s.

With a ``mesh`` (a ``model`` axis) the model is tensor-parallel
(``tvc_torch.parallel.tp``): each rank holds its Megatron slices, and the
decode takes the JAX package's module path under TP: per layer the int8
leaves dequantize to bf16, plain ``torch.matmul`` on the slices, the
module attention, and the collectives of ``tp_block`` (q|k|v and gate|up
stay unmerged). Every rank passes the same prompts and gets the same
tokens.
"""

from __future__ import annotations

import dataclasses
import math
import os
from collections.abc import Mapping
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor, nn

from tvc_torch._device import resolve_device
from tvc_torch.core.kernels.decode_attention_kernel import decode_gqa_attention_stacked
from tvc_torch.core.kernels.quantized_layer_kernel import quantize_linear
from tvc_torch.core.kernels.w8_matmul_kernel import (
    w8_matmul,
    w8_matmul_reference,
    w8_matmul_stacked,
    w8a8_matmul,
    w8a8_matmul_stacked,
)
from tvc_torch.utils import tracing

#: the largest activation block (B * T rows) the weight-only kernels take;
#: larger blocks dequantize, then matmul (the JAX package's VMEM limit,
#: ``tvc/models/qwen.py`` ``mm`` / ``mm_stacked``)
W8_MAX_ROWS = 1024


@dataclasses.dataclass(frozen=True)
class QwenConfig:
    """Qwen2 architecture knobs (defaults: Qwen2-0.5B shape class)."""

    vocab_size: int = 151936
    hidden_size: int = 896
    intermediate_size: int = 4864
    num_layers: int = 24
    num_heads: int = 14
    num_kv_heads: int = 2
    max_seq_len: int = 512
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = True
    dtype: Any = torch.bfloat16
    model_name: str = "Qwen/Qwen2-0.5B-Instruct"
    #: the GEMM that serves int8 weight leaves in the decode: "w8"
    #: (weight-only: activations in the model dtype) or "w8a8" (the
    #: activations quantized per row to int8 too)
    quant_gemm: str = "w8"

    @classmethod
    def tiny(cls) -> "QwenConfig":
        return cls(
            vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, max_seq_len=64, dtype=torch.float32,
            model_name="tiny",
        )

    @classmethod
    def qwen2_1_5b(cls) -> "QwenConfig":
        return cls(
            hidden_size=1536, intermediate_size=8960, num_layers=28,
            num_heads=12, num_kv_heads=2, model_name="Qwen/Qwen2-1.5B-Instruct",
        )

    @classmethod
    def qwen2_7b(cls) -> "QwenConfig":
        return cls(
            hidden_size=3584, intermediate_size=18944, num_layers=28,
            num_heads=28, num_kv_heads=4, tie_embeddings=False,
            model_name="Qwen/Qwen2-7B-Instruct",
        )


# ---------------------------------------------------------------------------
# shared math
# ---------------------------------------------------------------------------


def _rmsnorm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


def rope_tables(positions: Tensor, head_dim: int, theta: float) -> Tuple[Tensor, Tensor]:
    """f32 cos / sin ``[B, T, 1, head_dim / 2]`` of the rotary angles."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=positions.device) / half))
    angles = positions[..., None].float() * freqs
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """Rotary embedding in f32. x: [B, T, H, Dh]; positions: [B, T]."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


def _gqa_attention(qg: Tensor, k: Tensor, v: Tensor, mask: Tensor, dtype) -> Tensor:
    """Prefill / module attention: qg [B, T, KV, R, D], k / v [B, KV, S, D],
    mask [B, T, S] additive; f32 logits and softmax, weights rounded to
    ``dtype``, AV accumulated in f32 -> [B, T, KV, R, D] in ``dtype``."""
    D = qg.shape[-1]
    lg = torch.einsum("btkrd,bksd->bkrts", qg.float(), k.float()) / math.sqrt(D)
    lg = lg + mask[:, None, None]
    w = torch.softmax(lg, dim=-1).to(dtype)
    return torch.einsum("bkrts,bksd->btkrd", w.float(), v.float()).to(dtype)


# ---------------------------------------------------------------------------
# module path, named and laid out like the flax tree
# ---------------------------------------------------------------------------


def _param(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape, dtype=torch.float32, device=device), requires_grad=False)


class Dense(nn.Module):
    """``x @ kernel (+ bias)`` with ``kernel [in, out]``, computed in ``dtype``."""

    def __init__(self, din: int, dout: int, dtype, bias: bool, device=None):
        super().__init__()
        self.kernel = _param(din, dout, device=device)
        self.bias = _param(dout, device=device) if bias else None
        self.dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class RMSNorm(nn.Module):
    def __init__(self, width: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(width, device=device), requires_grad=False)
        self.eps = eps

    def forward(self, x: Tensor) -> Tensor:
        return _rmsnorm(x, self.scale, self.eps)


class QwenAttention(nn.Module):
    def __init__(self, cfg: QwenConfig, device=None):
        super().__init__()
        self.cfg = c = cfg
        Dh = c.hidden_size // c.num_heads
        self.q = Dense(c.hidden_size, c.num_heads * Dh, c.dtype, True, device)
        self.k = Dense(c.hidden_size, c.num_kv_heads * Dh, c.dtype, True, device)
        self.v = Dense(c.hidden_size, c.num_kv_heads * Dh, c.dtype, True, device)
        self.o = Dense(c.num_heads * Dh, c.hidden_size, c.dtype, False, device)

    def forward(self, x, positions, mask, cache=None, cache_index=None):
        """mask [B, 1, T, S] additive; cache (k, v) [B, S, KV, Dh] (S-major)."""
        c = self.cfg
        Dh = c.hidden_size // c.num_heads
        B, T, _ = x.shape
        q = rope(self.q(x).reshape(B, T, c.num_heads, Dh), positions, c.rope_theta)
        k = rope(self.k(x).reshape(B, T, c.num_kv_heads, Dh), positions, c.rope_theta)
        v = self.v(x).reshape(B, T, c.num_kv_heads, Dh)
        new_cache = None
        if cache is not None:
            ck, cv = (t.clone() for t in cache)
            ck[:, cache_index : cache_index + T] = k
            cv[:, cache_index : cache_index + T] = v
            k, v, new_cache = ck, cv, (ck, cv)
        qg = q.reshape(B, T, c.num_kv_heads, c.num_heads // c.num_kv_heads, Dh)
        out = _gqa_attention(qg, k.transpose(1, 2), v.transpose(1, 2), mask[:, 0], c.dtype)
        return self.o(out.reshape(B, T, c.num_heads * Dh)), new_cache


class QwenMLP(nn.Module):
    def __init__(self, cfg: QwenConfig, device=None):
        super().__init__()
        c = cfg
        self.gate = Dense(c.hidden_size, c.intermediate_size, c.dtype, False, device)
        self.up = Dense(c.hidden_size, c.intermediate_size, c.dtype, False, device)
        self.down = Dense(c.intermediate_size, c.hidden_size, c.dtype, False, device)

    def forward(self, x: Tensor) -> Tensor:
        return self.down(F.silu(self.gate(x)) * self.up(x))


class QwenBlock(nn.Module):
    def __init__(self, cfg: QwenConfig, device=None):
        super().__init__()
        self.ln_attn = RMSNorm(cfg.hidden_size, cfg.rms_eps, device)
        self.attn = QwenAttention(cfg, device)
        self.ln_mlp = RMSNorm(cfg.hidden_size, cfg.rms_eps, device)
        self.mlp = QwenMLP(cfg, device)

    def forward(self, x, positions, mask, cache=None, cache_index=None):
        h, new_cache = self.attn(self.ln_attn(x), positions, mask, cache, cache_index)
        x = x + h
        return x + self.mlp(self.ln_mlp(x)), new_cache


class QwenLM(nn.Module):
    def __init__(self, cfg: QwenConfig, device=None):
        super().__init__()
        self.cfg = c = cfg
        self.embed = nn.Module()
        self.embed.embedding = _param(c.vocab_size, c.hidden_size, device=device)
        for i in range(c.num_layers):
            self.add_module(f"layer_{i}", QwenBlock(c, device))
        self.ln_f = RMSNorm(c.hidden_size, c.rms_eps, device)
        if not c.tie_embeddings:
            self.lm_head = Dense(c.hidden_size, c.vocab_size, torch.float32, False, device)

    def forward(self, tokens, positions, mask, caches=None, cache_index=None, gather_index=None):
        """tokens / positions [B, T], mask [B, 1, T, S]; gather_index [B]:
        logits only at that position per sample. Returns (f32 logits,
        new caches)."""
        c = self.cfg
        emb = self.embed.embedding
        x = emb.to(c.dtype)[tokens]
        new_caches = []
        for i in range(c.num_layers):
            x, nc = getattr(self, f"layer_{i}")(x, positions, mask, caches[i] if caches else None, cache_index)
            new_caches.append(nc)
        x = self.ln_f(x)
        if gather_index is not None:
            x = x[torch.arange(x.shape[0], device=x.device), gather_index][:, None]
        if c.tie_embeddings:
            logits = x.to(c.dtype) @ emb.to(c.dtype).T  # flax Embed.attend: both in dtype
        else:
            logits = self.lm_head(x.float())
        return logits.float(), new_caches

    def apply(self, params: Dict, *args, **kw):
        """The forward on the parameter tree ``params`` (int8 leaves are
        dequantized to bf16 first, as the JAX package's ``_dequant``)."""
        flat = _flatten(QwenModel._dequant(params))
        return torch.func.functional_call(self, flat, args, kw)


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------


def _is_q(x) -> bool:
    return isinstance(x, Mapping) and "int8" in x


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    """Dotted names -> leaves; an ``{"int8", "scale"}`` dict is one leaf."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping) and not _is_q(v):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = v
    return out


def _unflatten(flat: Dict[str, Any]) -> Dict:
    tree: Dict = {}
    for name, v in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _tree_map(fn: Callable[[str, Any], Any], tree: Mapping) -> Dict:
    return _unflatten({n: fn(n, v) for n, v in _flatten(tree).items()})


def _quantize_leaf(name: str, x, include_embed: bool = True):
    """Per-output-channel symmetric int8 for 2-D matrix params; other leaves
    pass through (the embedding too when ``include_embed`` is false)."""
    is_embed = "embed" in name.split(".")
    if not torch.is_tensor(x) or x.ndim != 2 or (is_embed and not include_embed):
        return x
    w_q, scale = quantize_linear(x)
    return {"int8": w_q, "scale": scale}


def qwen_params_from_jax(tree, cfg: QwenConfig) -> Dict:
    """The flax parameter tree (numpy leaves, ``{"int8", "scale"}`` leaves
    included) as the port's tree of CPU tensors, with every name and shape
    checked against the port's module."""
    flat = _flatten(tree)
    want = {n: tuple(p.shape) for n, p in QwenLM(cfg, device="meta").named_parameters()}
    missing, extra = set(want) - set(flat), set(flat) - set(want)
    if missing or extra:
        raise ValueError(f"parameter tree mismatch: missing {sorted(missing)}, unexpected {sorted(extra)}")

    def conv(a, dtype=None):
        return torch.from_numpy(np.array(a, dtype=dtype))

    out = {}
    for name, shape in want.items():
        leaf = flat[name]
        if _is_q(leaf):
            w_q, scale = conv(leaf["int8"], np.int8), conv(leaf["scale"], np.float32)
            if tuple(w_q.shape) != shape or tuple(scale.shape) != shape[-1:]:
                raise ValueError(f"{name}: int8 {tuple(w_q.shape)} / scale {tuple(scale.shape)}, expected {shape}")
            out[name] = {"int8": w_q, "scale": scale}
        else:
            arr = np.asarray(leaf)
            t = conv(arr, np.float32) if arr.dtype != np.float32 else conv(arr)
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
            out[name] = t
    return _unflatten(out)


def _lecun_normal_(t: Tensor, gen: torch.Generator) -> Tensor:
    """flax's ``lecun_normal``: a normal truncated at 2 standard units,
    std sqrt(1 / fan_in) after the truncation."""
    std = math.sqrt(1.0 / t.shape[0]) / 0.87962566103423978
    return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)


def init_params(cfg: QwenConfig, seed: int = 0, device=None) -> Dict:
    """Seeded random parameters at the flax initializers' distributions:
    Dense kernels lecun-normal, biases 0, RMSNorm scales 1, the embedding
    N(0, 1 / hidden)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, p in QwenLM(cfg, device="meta").named_parameters():
        t = torch.empty(p.shape, dtype=torch.float32, device=device)
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "bias":
            t.zero_()
        elif leaf == "scale":
            t.fill_(1.0)
        elif name == "embed.embedding":
            t.normal_(0.0, cfg.hidden_size ** -0.5, generator=gen)
        else:
            _lecun_normal_(t, gen)
        out[name] = t
    return _unflatten(out)


def _get(tree: Mapping, path: str):
    for k in path.split("."):
        tree = tree[k]
    return tree


def _pop(tree: Dict, path: str) -> None:
    *parents, leaf = path.split(".")
    for k in parents:
        tree = tree[k]
    tree.pop(leaf)


def _stack_group(layers: List[Dict], paths: Sequence[str], free: bool):
    """``out[l] = concat(leaves of layers[l] at paths)`` along the output
    dim, for tensor or int8 leaves (concatenating per-output-channel
    quantized kernels concatenates their scales). With ``free`` each
    layer's leaves are dropped once copied."""
    first = [_get(layers[0], p) for p in paths]
    keys = ("int8", "scale") if _is_q(first[0]) else (None,)
    outs = {}
    for k in keys:
        parts = [leaf if k is None else leaf[k] for leaf in first]
        shape = (len(layers), *parts[0].shape[:-1], sum(t.shape[-1] for t in parts))
        outs[k] = torch.empty(shape, dtype=parts[0].dtype, device=parts[0].device)
    for i, tree in enumerate(layers):
        leaves = [_get(tree, p) for p in paths]
        for k, out in outs.items():
            o = 0
            for leaf in leaves:
                t = leaf if k is None else leaf[k]
                out[i, ..., o : o + t.shape[-1]] = t
                o += t.shape[-1]
        if free:
            for p in paths:
                _pop(tree, p)
    return outs[None] if keys == (None,) else outs


#: early-exit decode granularity: the decode loop checks the
#: all-sequences-done flag every DECODE_CHUNK steps, when max_new_tokens is
#: a larger multiple of it
DECODE_CHUNK = 4


def _stable_seed(text: str) -> int:
    """FNV-1a digest -> [0, 2^31): stable across processes, unlike hash()."""
    h = 0xCBF29CE484222325
    for b in text.encode("utf-8"):
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h % (2**31)


#: the instruction prefix shared by every paraphrase prompt (prefilled once
#: at batch 1); it ends on a byte-level-BPE pre-tokenizer boundary, so
#: tokenize(prefix) + tokenize(suffix) == tokenize(prefix + suffix)
PARAPHRASE_PREFIX = (
    "Rewrite the following sentence with the same meaning but different "
    "wording.\nSentence:"
)
PARAPHRASE_PROMPT = PARAPHRASE_PREFIX + " {text}\nRewrite:"

TRANSLATE_PREFIX = (
    "Translate the following sentence from {src} to {dst}. Reply with only "
    "the translation.\nSentence:"
)
TRANSLATE_PROMPT = TRANSLATE_PREFIX + " {text}\nTranslation:"

_LANG_NAMES = {
    "en": "English",
    "de": "German",
    "fr": "French",
    "es": "Spanish",
    "zh": "Chinese",
    "ja": "Japanese",
}


@dataclasses.dataclass
class DecodeInputs:
    """One decode call's prompt block, built on the host by
    :meth:`QwenModel.prepare`: ``prefix`` [P] shared ids (P may be 0),
    ``tokens`` [B, plen - P] padded suffixes (or whole prompts), ``lengths``
    [B] real lengths counting the prefix, ``plen`` the cache slots the
    prompt takes, ``allowed`` the padded allowed-id list (or None) with its
    ``n_real`` real entries."""

    prefix: Tensor
    tokens: Tensor
    lengths: Tensor
    plen: int
    n_samples: int
    allowed: Optional[Tensor]
    n_real: int

    @property
    def P(self) -> int:
        return int(self.prefix.shape[0])


class QwenModel:
    """User-facing wrapper: parameters, tokenizer, the decode and
    ``generate_paraphrases(text, num_paraphrases, temperature)``."""

    def __init__(
        self,
        config: Optional[QwenConfig] = None,
        params: Optional[Dict] = None,
        seed: int = 0,
        tokenizer: Optional[Callable] = None,
        max_new_tokens: int = 32,
        cast_params_bf16: bool = False,
        mesh=None,
        init_int8: bool = False,
        decode_only: bool = False,
        device: Optional[Union[str, torch.device]] = None,
    ):
        """cast_params_bf16: matrix params stored in bf16.

        init_int8: random init straight into int8 serving form, one layer
        at a time on the device, so the f32 transient is one layer's (the
        f32 embedding and head tables, 2.2 GB each at Qwen2-7B, are the
        largest).

        decode_only: the per-layer params are freed once the stacked decode
        tree is built; the module path (``QwenLM.apply``) cannot run after.

        mesh: a ``DeviceMesh`` with a ``model`` axis: tensor-parallel. The
        parameters (given, or the seeded init, built one layer at a time
        with ``init_int8``) are cut to this rank's slices
        (``shard_qwen_params``), so every rank holds the numbers the
        single-device model holds; the model lives on the mesh's device."""
        self.config = c = config or QwenConfig.tiny()
        self.mesh = mesh
        if mesh is not None:
            from tvc_torch.parallel.mesh import mesh_device
            from tvc_torch.parallel.tp import check_tp_config

            check_tp_config(c, mesh)
            self.device = mesh_device(mesh)
            if device is not None and resolve_device(device) != self.device:
                raise ValueError(f"device {device} is not the mesh's {self.device}")
        else:
            self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the f32 plain paths are references: full f32, no TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.module = QwenLM(c, device="meta")
        self.max_new_tokens = max_new_tokens
        self.decode_only = decode_only
        if params is None:
            params = self._init_params_int8(seed) if init_int8 else init_params(c, seed, self.device)
        else:
            params = _tree_map(lambda n, t: _to(t, self.device), params)
        if cast_params_bf16 and not init_int8:
            params = _tree_map(
                lambda n, t: t.to(torch.bfloat16) if torch.is_tensor(t) and t.ndim >= 2 else t, params
            )
        if mesh is not None and not init_int8:
            params = self._shard(params)
        self.params = params
        if tokenizer is None:
            from tvc_torch.models.tokenizer import get_tokenizer

            tokenizer = get_tokenizer(
                vocab_size=c.vocab_size, context_length=c.max_seq_len,
                merges_path=os.environ.get("TVC_QWEN_TOKENIZER"),
            )
        self.tokenizer = tokenizer
        self._decode_state_cache = None

    # -- int8 weights ------------------------------------------------------------
    def _shard(self, tree: Dict) -> Dict:
        """This rank's TP slices of a full (sub)tree of the parameters."""
        from tvc_torch.parallel.tp import shard_qwen_params

        return shard_qwen_params(tree, self.mesh)

    def quantize_weights_int8(self, include_embed: bool = True) -> None:
        """Per-output-channel symmetric int8 on every 2-D matrix param
        (the embedding too unless ``include_embed`` is false). Under TP each
        leaf is gathered whole, quantized and cut again, so the int8
        weights and scales are the single-device model's."""
        if self.mesh is None:
            self.params = _tree_map(lambda n, t: _quantize_leaf(n, t, include_embed), self.params)
        else:
            from tvc_torch.parallel.tp import gather_qwen_leaf

            full = {n: p.shape for n, p in QwenLM(self.config, device="meta").named_parameters()}
            out = {}
            for name, leaf in _flatten(self.params).items():
                if torch.is_tensor(leaf) and leaf.ndim == 2:
                    q = _quantize_leaf(name, gather_qwen_leaf(leaf, full[name], self.mesh), include_embed)
                    leaf = _flatten(self._shard(_unflatten({name: q})))[name] if _is_q(q) else leaf
                out[name] = leaf
            self.params = _unflatten(out)
        self._decode_state_cache = None

    def _init_params_int8(self, seed: int) -> Dict:
        """Layer-wise random init straight into int8 serving form, with the
        module's tree structure (embed / layer_i / ln_f / lm_head); the
        embedding and untied head 0.02 N(0, 1) as the JAX package does."""
        c, dev = self.config, self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        block = QwenBlock(c, device="meta")
        params: Dict[str, Any] = {}
        for i in range(c.num_layers):
            flat = {}
            for name, p in block.named_parameters():
                t = torch.empty(p.shape, dtype=torch.float32, device=dev)
                leaf = name.rsplit(".", 1)[-1]
                if leaf == "bias":
                    t.zero_()
                elif leaf == "scale":
                    t.fill_(1.0)
                else:
                    _lecun_normal_(t, gen)
                flat[name] = _quantize_leaf(name, t)
            params[f"layer_{i}"] = _unflatten(flat)
            if self.mesh is not None:  # keep this rank's slices of the whole layer
                params[f"layer_{i}"] = self._shard({f"layer_{i}": params[f"layer_{i}"]})[f"layer_{i}"]
        table = lambda *shape: 0.02 * torch.randn(shape, generator=gen, device=dev)
        params["embed"] = {"embedding": _quantize_leaf("embed.embedding", table(c.vocab_size, c.hidden_size))}
        params["ln_f"] = {"scale": torch.ones(c.hidden_size, device=dev)}
        if not c.tie_embeddings:
            params["lm_head"] = {"kernel": _quantize_leaf("lm_head.kernel", table(c.hidden_size, c.vocab_size))}
        if self.mesh is not None:
            params.update(self._shard({k: v for k, v in params.items() if not k.startswith("layer_")}))
        return params

    @staticmethod
    def _dequant(params: Dict) -> Dict:
        """bf16 view of a (possibly) int8-quantized tree; plain leaves pass."""
        return _tree_map(
            lambda n, x: x["int8"].to(torch.bfloat16) * x["scale"].to(torch.bfloat16) if _is_q(x) else x,
            params,
        )

    # -- the stacked decode state ----------------------------------------------------
    def _decode_state(self) -> Tuple[Dict, Dict]:
        """(non-layer params, stacked merged layers ``[L, ...]``): q|k|v and
        gate|up concatenated along the output dim (each output column's
        contraction is unchanged). Cached for the current ``params``
        object; with ``decode_only`` each layer's leaves are freed as they
        are stacked."""
        if self._decode_state_cache is not None and self._decode_state_cache[0] is self.params:
            return self._decode_state_cache[1]
        c, params = self.config, self.params
        if self.mesh is not None:
            # the TP module path runs on each layer's own (sliced) tree
            layers = [params[f"layer_{i}"] for i in range(c.num_layers)]
            non_layer = {k: v for k, v in params.items() if not k.startswith("layer_")}
            self._decode_state_cache = (self.params, (non_layer, layers))
            return non_layer, layers
        if self.decode_only and "layer_0" not in params:
            raise RuntimeError(
                "decode_only=True freed the per-layer params when the stacked decode tree was built; "
                "the weight tree cannot be rebuilt (reassign .params with a full tree, or construct the "
                "model with the desired weights/quantization up front)"
            )
        layers = [params[f"layer_{i}"] for i in range(c.num_layers)]
        free = self.decode_only
        stacked = {
            "ln_attn": _stack_group(layers, ["ln_attn.scale"], free),
            "ln_mlp": _stack_group(layers, ["ln_mlp.scale"], free),
            "wqkv": _stack_group(layers, ["attn.q.kernel", "attn.k.kernel", "attn.v.kernel"], free),
            "bqkv": _stack_group(layers, ["attn.q.bias", "attn.k.bias", "attn.v.bias"], free),
            "wo": _stack_group(layers, ["attn.o.kernel"], free),
            "wgu": _stack_group(layers, ["mlp.gate.kernel", "mlp.up.kernel"], free),
            "wd": _stack_group(layers, ["mlp.down.kernel"], free),
        }
        if free:
            for i in range(c.num_layers):
                params.pop(f"layer_{i}")
        non_layer = {k: v for k, v in params.items() if not k.startswith("layer_")}
        self._decode_state_cache = (self.params, (non_layer, stacked))
        return non_layer, stacked

    # -- the decode math ---------------------------------------------------------------
    def _mm(self, x3: Tensor, leaf) -> Tensor:
        """x [B, T, K] @ weight leaf; int8 leaves through the W8A8 kernel,
        or under "w8" through the weight-only kernel up to W8_MAX_ROWS rows
        and dequantize-then-matmul above."""
        c = self.config
        B, T = x3.shape[:2]
        if _is_q(leaf):
            if c.quant_gemm != "w8a8" and B * T > W8_MAX_ROWS:
                return w8_matmul_reference(x3.to(c.dtype), leaf["int8"], leaf["scale"])
            kern = w8a8_matmul if c.quant_gemm == "w8a8" else w8_matmul
            y = kern(x3.reshape(B * T, -1).to(c.dtype).contiguous(), leaf["int8"], leaf["scale"])
            return y.reshape(B, T, -1)
        return x3.to(c.dtype) @ leaf.to(c.dtype)

    def _mm_stacked(self, x3: Tensor, leaf, l: int) -> Tensor:
        """x [B, T, K] @ (stacked weight leaf)[l]: int8 leaves through the
        stacked kernels where :meth:`_mm` would take a kernel, else
        :meth:`_mm` on layer l's slice."""
        c = self.config
        B, T = x3.shape[:2]
        if _is_q(leaf):
            if c.quant_gemm == "w8a8" or B * T <= W8_MAX_ROWS:
                kern = w8a8_matmul_stacked if c.quant_gemm == "w8a8" else w8_matmul_stacked
                y = kern(x3.reshape(B * T, -1).to(c.dtype).contiguous(), leaf["int8"], leaf["scale"], l)
                return y.reshape(B, T, -1)
            return self._mm(x3, {"int8": leaf["int8"][l], "scale": leaf["scale"][l]})
        return self._mm(x3, leaf[l])

    def _embed(self, non_layer: Dict, tokens: Tensor) -> Tensor:
        """Take, then dequantize: only the gathered rows are converted."""
        e = non_layer["embed"]["embedding"]
        dt = self.config.dtype
        if self.mesh is not None:
            from tvc_torch.parallel.tp import tp_embed

            return tp_embed(e, tokens, self.config, self.mesh)
        if _is_q(e):
            return e["int8"][tokens].to(dt) * e["scale"].to(dt)
        return e[tokens].to(dt)

    def _head(self, non_layer: Dict, allowed: Optional[Tensor]) -> Callable[[Tensor], Tensor]:
        """The f32 logits of the last hidden state: over the whole vocab or,
        for constrained decoding, over the allowed rows gathered once."""
        c = self.config
        dt = c.dtype
        if self.mesh is not None:
            from tvc_torch.parallel.tp import tp_logits

            if allowed is None:
                return lambda x: tp_logits(x, non_layer, c, self.mesh)
            return lambda x: tp_logits(x, non_layer, c, self.mesh)[..., allowed]
        if c.tie_embeddings:
            e = non_layer["embed"]["embedding"]
            if allowed is not None:
                tbl = (e["int8"][allowed].to(dt) * e["scale"].to(dt)) if _is_q(e) else e[allowed].to(dt)
            else:
                tbl = (e["int8"].to(torch.bfloat16) * e["scale"].to(torch.bfloat16) if _is_q(e) else e).to(dt)
            return lambda x: (x.to(dt) @ tbl.T).float()
        kern = non_layer["lm_head"]["kernel"]
        if allowed is not None:
            kern = {"int8": kern["int8"][:, allowed].contiguous(), "scale": kern["scale"][allowed].contiguous()} \
                if _is_q(kern) else kern[:, allowed]
        return lambda x: self._mm(x, kern).float()

    def _merged_layer(self, stacked, l, h, cos, sin, mask, ck, cv, cache_index, ctx):
        """QwenBlock with q|k|v and gate|up as single GEMMs. The cache is
        KV-major ``[L, B, KV, S, Dh]``; this step's k / v are written into
        it in place. T == 1 (decode): the decode attention kernel over
        layer l of the stacked cache, mask [B, S]; else (prefill): plain
        attention over the block plus the ``ctx`` cached prefix slots, mask
        [B, 1, T, S]."""
        c = self.config
        B, T, _ = h.shape
        Dh = c.hidden_size // c.num_heads
        nq, nkv, R = c.num_heads * Dh, c.num_kv_heads * Dh, c.num_heads // c.num_kv_heads
        x = _rmsnorm(h, stacked["ln_attn"][l], c.rms_eps)
        qkv = self._mm_stacked(x, stacked["wqkv"], l) + stacked["bqkv"][l].to(c.dtype)
        q = apply_rope(qkv[..., :nq].reshape(B, T, c.num_heads, Dh), cos, sin)
        k = apply_rope(qkv[..., nq : nq + nkv].reshape(B, T, c.num_kv_heads, Dh), cos, sin)
        v = qkv[..., nq + nkv :].reshape(B, T, c.num_kv_heads, Dh)
        k_t, v_t = k.transpose(1, 2), v.transpose(1, 2)  # [B, KV, T, Dh]
        ck[l, :, :, cache_index : cache_index + T] = k_t
        cv[l, :, :, cache_index : cache_index + T] = v_t
        if T == 1:
            out = decode_gqa_attention_stacked(q.reshape(B, c.num_kv_heads, R, Dh).contiguous(), ck, cv, mask, l)
            out = out.reshape(B, 1, nq)
        else:
            kk, vv = (ck[l, :, :, : ctx + T], cv[l, :, :, : ctx + T]) if ctx else (k_t, v_t)
            qg = q.reshape(B, T, c.num_kv_heads, R, Dh)
            out = _gqa_attention(qg, kk, vv, mask[:, 0, :, : ctx + T], c.dtype).reshape(B, T, nq)
        h = h + self._mm_stacked(out, stacked["wo"], l)
        gu = self._mm_stacked(_rmsnorm(h, stacked["ln_mlp"][l], c.rms_eps), stacked["wgu"], l)
        act = F.silu(gu[..., : c.intermediate_size]) * gu[..., c.intermediate_size :]
        return h + self._mm_stacked(act.to(c.dtype), stacked["wd"], l)

    def _run_layers(self, stacked, x, positions, mask, caches, cache_index, ctx=0) -> Tensor:
        """Every layer: mask [B, 1, T, S] (prefill) or [B, S] (one step)."""
        c = self.config
        cos, sin = rope_tables(positions, c.hidden_size // c.num_heads, c.rope_theta)
        if self.mesh is not None:
            from tvc_torch.parallel.tp import tp_block

            m3 = mask[:, 0] if mask.ndim == 4 else mask[:, None]
            for l in range(c.num_layers):
                x = tp_block(stacked[l], x, cos, sin, m3, c, self.mesh, (caches[0][l], caches[1][l]),
                             cache_index, ctx)
            return x
        for l in range(c.num_layers):
            x = self._merged_layer(stacked, l, x, cos, sin, mask, caches[0], caches[1], cache_index, ctx)
        return x

    @staticmethod
    def _sample(lg: Tensor, gen: torch.Generator, temperature: float, top_k: int,
                allowed: Optional[Tensor], n_real: int) -> Tensor:
        """Top-k (exact) sampling at ``temperature`` by the Gumbel-max trick
        (``jax.random.categorical``'s method), or argmax at or below 1e-4;
        padded allowed-id slots are never chosen."""
        if allowed is not None:
            pad = torch.arange(lg.shape[-1], device=lg.device) >= n_real
            lg = lg.masked_fill(pad, float("-inf"))
        if temperature > 1e-4:
            topv, topi = torch.topk(lg, top_k, dim=-1)
            u = torch.rand(topv.shape, generator=gen, device=lg.device).clamp_(min=torch.finfo(torch.float32).tiny)
            choice = torch.argmax(topv / max(temperature, 1e-4) - torch.log(-torch.log(u)), dim=-1)
            loc = topi.gather(1, choice[:, None])[:, 0]
        else:
            loc = torch.argmax(lg, dim=-1)
        return allowed[loc] if allowed is not None else loc

    def _kv_heads(self) -> int:
        """The kv heads this rank caches (its slice under TP)."""
        c = self.config
        if self.mesh is None:
            return c.num_kv_heads
        from tvc_torch.parallel.mesh import MODEL_AXIS, axis_size

        return c.num_kv_heads // axis_size(self.mesh, MODEL_AXIS)

    @torch.no_grad()
    def decode(
        self,
        inp: DecodeInputs,
        temperature: float = 0.8,
        seed: int = 0,
        forced: Optional[Tensor] = None,
        on_logits: Optional[Callable[[int, Tensor], None]] = None,
    ) -> Tensor:
        """Prefill + the token loop on the device; returns the tokens
        ``[B * n_samples, max_new_tokens]`` (EOT after a sequence ends).

        ``forced`` [n, B * n_samples]: take these tokens instead of sampling
        and stop after n steps (teacher forcing, to hold two runs of the
        same path against each other); ``on_logits(step, logits)`` sees the
        f32 logits each step samples from. ``self.last_decode_steps`` is
        the number of steps the loop ran (fewer after an early exit)."""
        with tracing.span("qwen.prefill", rows=int(inp.tokens.shape[0])):
            c, dev = self.config, self.device
            non_layer, stacked = self._decode_state()
            Dh = c.hidden_size // c.num_heads
            eot = getattr(self.tokenizer, "eot_id", -1)
            P, plen = inp.P, inp.plen
            S = plen + self.max_new_tokens
            B = inp.tokens.shape[0]
            head = self._head(non_layer, inp.allowed)
            cache_shape = (c.num_layers, B, self._kv_heads(), S, Dh)
            caches = (torch.zeros(cache_shape, dtype=c.dtype, device=dev),
                      torch.zeros(cache_shape, dtype=c.dtype, device=dev))
            ks = torch.arange(S, device=dev)
            lengths = inp.lengths
            T = plen - P
            t_idx = torch.arange(T, device=dev)
            if P:
                # prefix-shared prefill: the prefix at batch 1, broadcast into
                # every row's slots [0, P); then the suffixes at offset P
                kp = torch.arange(P, device=dev)
                pre_mask = torch.zeros((1, 1, P, P), device=dev).masked_fill(kp[None, :] > kp[:, None], float("-inf"))
                pre = tuple(torch.zeros((c.num_layers, 1, self._kv_heads(), P, Dh), dtype=c.dtype, device=dev)
                            for _ in range(2))
                self._run_layers(stacked, self._embed(non_layer, inp.prefix[None]), kp[None], pre_mask, pre, 0)
                for cz, cp in zip(caches, pre):
                    cz[:, :, :, :P] = cp
            keep = (ks[None, None, :] <= P + t_idx[None, :, None]) & (ks[None, None, :] < lengths[:, None, None])
            if P:
                keep = keep | (ks < P)[None, None, :]
            prefill_mask = torch.zeros(keep.shape, device=dev).masked_fill(~keep, float("-inf"))[:, None]
            positions = (P + t_idx)[None].expand(B, T)
            x = self._run_layers(stacked, self._embed(non_layer, inp.tokens), positions, prefill_mask, caches, P, ctx=P)
            x = _rmsnorm(x, non_layer["ln_f"]["scale"], c.rms_eps)
            x = x[torch.arange(B, device=dev), lengths - P - 1][:, None]
            next_logits = head(x)[:, 0]

        n = inp.n_samples
        if n > 1:  # each prompt's prefilled cache serves n sampling chains
            caches = tuple(t.repeat_interleave(n, dim=1) for t in caches)
            next_logits = next_logits.repeat_interleave(n, dim=0)
            lengths = lengths.repeat_interleave(n, dim=0)
        top_k = min(50, inp.allowed.shape[0] if inp.allowed is not None else c.vocab_size)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        Bn = next_logits.shape[0]
        done = torch.zeros(Bn, dtype=torch.bool, device=dev)
        tokens = torch.full((self.max_new_tokens, Bn), eot, dtype=torch.long, device=dev)
        steps = self.max_new_tokens if forced is None else min(self.max_new_tokens, forced.shape[0])
        chunk = DECODE_CHUNK
        early_exit = self.max_new_tokens > chunk and self.max_new_tokens % chunk == 0
        self.last_decode_steps = 0
        for i in range(steps):
            if early_exit and i and i % chunk == 0 and bool(done.all()):
                break  # every sequence has ended: the rest is the EOT fill
            with tracing.span("qwen.decode_step", step=i, rows=Bn):
                self.last_decode_steps = i + 1
                if on_logits is not None:
                    on_logits(i, next_logits)
                if forced is not None:
                    tok = forced[i].to(dev, torch.long)
                else:
                    tok = self._sample(next_logits, gen, temperature, top_k, inp.allowed, inp.n_real)
                tok = torch.where(done, torch.full_like(tok, eot), tok)
                done = done | (tok == eot)
                tokens[i] = tok
                cache_pos = plen + i
                valid = (ks[None] < lengths[:, None]) | ((ks[None] >= plen) & (ks[None] <= cache_pos))
                step_mask = torch.zeros(valid.shape, device=dev).masked_fill(~valid, float("-inf"))
                x = self._run_layers(stacked, self._embed(non_layer, tok[:, None]), (lengths + i)[:, None],
                                     step_mask, caches, cache_pos)
                next_logits = head(_rmsnorm(x, non_layer["ln_f"]["scale"], c.rms_eps))[:, 0]
        return tokens.T

    # -- host side -----------------------------------------------------------------------
    def _prefix_ids(self, prefix: str) -> np.ndarray:
        """Token ids of a shared prompt prefix (a few fixed strings, cached)."""
        cache = self.__dict__.setdefault("_prefix_ids_cache", {})
        ids = cache.get(prefix)
        if ids is None:
            row = self.tokenizer([prefix])[0]
            pad = getattr(self.tokenizer, "pad_id", 0)
            ids = row[: int((row != pad).sum())].astype(np.int32)
            if len(cache) >= 8:
                cache.clear()
            cache[prefix] = ids
        return ids

    def prepare(
        self,
        prompts: List[str],
        n_samples: int = 1,
        token_mask: Optional[np.ndarray] = None,
        shared_prefix: Optional[str] = None,
    ) -> DecodeInputs:
        """Tokenize, split off the shared prefix where the split is
        token-exact (checked on the first prompt, verdict cached per
        prefix), bucket the prompt length to a multiple of 8 and turn the
        vocabulary mask into a padded allowed-id list."""
        pad = getattr(self.tokenizer, "pad_id", 0)
        prefix_ids = np.zeros((0,), np.int32)
        if shared_prefix:
            bad = next((p for p in prompts if not p.startswith(shared_prefix)), None)
            if bad is not None:
                raise ValueError(f"shared_prefix {shared_prefix!r} is not a prefix of prompt {bad!r}")
            ok_cache = self.__dict__.setdefault("_prefix_ok_cache", {})
            if ok_cache.get(shared_prefix, True):
                prefix_ids = self._prefix_ids(shared_prefix)
                tok = self.tokenizer([p[len(shared_prefix):] for p in prompts])
                if prompts and shared_prefix not in ok_cache:
                    full0 = self.tokenizer([prompts[0]])[0]
                    n0 = int((full0 != pad).sum())
                    split0 = np.concatenate([prefix_ids, tok[0, : int((tok[0] != pad).sum())]])
                    ok_cache[shared_prefix] = bool(n0 == len(split0) and np.array_equal(full0[:n0], split0))
            if not ok_cache.get(shared_prefix, True):
                prefix_ids = np.zeros((0,), np.int32)  # not token-exact: plain prefill
                tok = self.tokenizer(prompts)
        else:
            tok = self.tokenizer(prompts)
        P = len(prefix_ids)
        lengths = (tok != pad).sum(axis=1)
        plen = min(-(-max(int(lengths.max()), 4) // 8) * 8, self.config.max_seq_len - self.max_new_tokens - P)
        tok = tok[:, :plen]
        allowed, n_real = None, 0
        if token_mask is not None:
            m_np = np.asarray(token_mask, bool)
            if m_np.shape != (self.config.vocab_size,):
                raise ValueError(f"token_mask must be bool [{self.config.vocab_size}], got shape {m_np.shape}")
            if not m_np.any():
                raise ValueError("token_mask allows no vocabulary ids")
            if not m_np.all():
                key = m_np.tobytes()
                cached = self.__dict__.get("_allowed_cache")
                if cached is not None and cached[0] == key:
                    _, allowed, n_real = cached
                else:
                    ids = np.nonzero(m_np)[0]
                    n_real = len(ids)
                    va = -(-n_real // 128) * 128  # padded with copies of ids[0], never sampled
                    ids = np.pad(ids, (0, va - n_real), constant_values=int(ids[0]))
                    allowed = torch.as_tensor(ids, dtype=torch.long, device=self.device)
                    self._allowed_cache = (key, allowed, n_real)
        dev = self.device
        return DecodeInputs(
            prefix=torch.as_tensor(prefix_ids, dtype=torch.long, device=dev),
            tokens=torch.as_tensor(tok, dtype=torch.long, device=dev),
            lengths=torch.as_tensor(np.minimum(lengths, plen) + P, dtype=torch.long, device=dev),
            plen=plen + P, n_samples=n_samples, allowed=allowed, n_real=n_real,
        )

    def generate_async(
        self,
        prompts: List[str],
        temperature: float = 0.8,
        seed: int = 0,
        n_samples: int = 1,
        token_mask: Optional[np.ndarray] = None,
        shared_prefix: Optional[str] = None,
    ) -> Callable[[], List[str]]:
        """Run the batched decode and return a zero-arg callable that reads
        the tokens back and detokenizes them. The decode is queued on the
        card's stream, but its early-exit check every DECODE_CHUNK steps
        waits for the device, so this call returns after the decode's
        last chunk is queued; only the readback and the detokenization
        are left to the callable. Spans: ``qwen.prepare`` (tokenizing),
        ``qwen.prefill`` and one ``qwen.decode_step`` a step (``decode``),
        ``qwen.readback`` (the callable)."""
        with tracing.span("qwen.prepare", rows=len(prompts)):
            inp = self.prepare(prompts, n_samples, token_mask, shared_prefix)
        rows = self.decode(inp, temperature, seed)

        def result() -> List[str]:
            with tracing.span("qwen.readback"):
                out = rows.cpu().numpy()
                batch_decode = getattr(self.tokenizer, "decode_batch", None)
                if batch_decode is not None:
                    eot = getattr(self.tokenizer, "eot_id", -1)
                    return batch_decode([[i for i in row if i != eot] for row in out.tolist()])
                return [self._detokenize(row) for row in out]

        return result

    def generate(
        self,
        prompts: List[str],
        temperature: float = 0.8,
        seed: int = 0,
        n_samples: int = 1,
        token_mask: Optional[np.ndarray] = None,
        shared_prefix: Optional[str] = None,
    ) -> List[str]:
        """Batched prompt -> continuation decode; ``n_samples > 1`` gives n
        sampled continuations per prompt (rows ``i*n .. (i+1)*n`` belong to
        prompt i) from one shared prefill; ``token_mask`` (bool [vocab])
        constrains sampling to the allowed ids (see ascii_token_mask)."""
        return self.generate_async(prompts, temperature, seed, n_samples, token_mask, shared_prefix)()

    def ascii_token_mask(self) -> np.ndarray:
        """Bool [vocab] mask of the ids whose decoded text is printable
        ASCII (or empty), plus EOT; all True for a tokenizer that cannot
        decode single ids. Cached per instance."""
        cached = self.__dict__.get("_ascii_mask")
        if cached is not None:
            return cached
        vocab = self.config.vocab_size
        mask = np.ones((vocab,), bool)
        token_texts = getattr(self.tokenizer, "token_texts", None)
        if token_texts is not None:
            n = min(vocab, len(self.tokenizer))
            mask = np.zeros((vocab,), bool)
            mask[:n] = np.fromiter(
                ((t.isascii() and t.isprintable()) or t == "" for t in token_texts(n)), bool, count=n
            )
        eot = getattr(self.tokenizer, "eot_id", None)
        if eot is not None:
            mask[int(eot)] = True  # chains must be able to terminate
        self._ascii_mask = mask
        return mask

    def _detokenize(self, ids: np.ndarray) -> str:
        eot = getattr(self.tokenizer, "eot_id", -1)
        ids = [int(i) for i in ids if int(i) != eot]
        decode = getattr(self.tokenizer, "decode", None)
        if decode is not None:
            return decode(ids)
        # the hash tokenizer is not invertible: deterministic placeholder words
        return " ".join(f"tok{i}" for i in ids)

    def generate_paraphrases(self, text: str, num_paraphrases: int = 3, temperature: float = 0.8) -> List[str]:
        """N samples of the paraphrase prompt, batched into one decode."""
        outs = self.generate(
            [PARAPHRASE_PROMPT.format(text=text)], temperature=temperature,
            seed=_stable_seed(text), n_samples=num_paraphrases,
        )
        return [o.strip() for o in outs if o.strip()]

    def generate_paraphrases_batch(
        self,
        texts: List[str],
        num_paraphrases: int = 3,
        temperature: float = 0.8,
        seed: int = 0,
        token_mask: Optional[np.ndarray] = None,
    ) -> List[List[str]]:
        """Every query's paraphrases in one decode batch of B * N sequences."""
        return self.generate_paraphrases_batch_async(texts, num_paraphrases, temperature, seed, token_mask)()

    def generate_paraphrases_batch_async(
        self,
        texts: List[str],
        num_paraphrases: int = 3,
        temperature: float = 0.8,
        seed: int = 0,
        token_mask: Optional[np.ndarray] = None,
    ) -> Callable[[], List[List[str]]]:
        """:meth:`generate_paraphrases_batch` through :meth:`generate_async`:
        one prefill per prompt (the instruction prefix once for the batch),
        n sampling chains each."""
        n = num_paraphrases
        if not texts:
            return lambda: []
        handle = self.generate_async(
            [PARAPHRASE_PROMPT.format(text=t) for t in texts], temperature=temperature, seed=seed,
            n_samples=n, token_mask=token_mask, shared_prefix=PARAPHRASE_PREFIX,
        )

        def result() -> List[List[str]]:
            outs = handle()
            return [[o.strip() for o in outs[i * n : (i + 1) * n] if o.strip()] for i in range(len(texts))]

        return result

    def translate(self, texts: List[str], src: str, dst: str, temperature: float = 0.0) -> List[str]:
        """Batched prompt-based translation (greedy by default); an empty
        output keeps its input, so outputs align with inputs."""
        sn, dn = _LANG_NAMES.get(src, src), _LANG_NAMES.get(dst, dst)
        outs = self.generate(
            [TRANSLATE_PROMPT.format(src=sn, dst=dn, text=t) for t in texts], temperature=temperature,
            seed=_stable_seed(f"{src}->{dst}:" + "\x00".join(texts)),
            shared_prefix=TRANSLATE_PREFIX.format(src=sn, dst=dn),
        )
        return [o.strip() or texts[i] for i, o in enumerate(outs)]

    def as_translator(self):
        """Callable ``(texts, src, dst) -> list[str]``."""
        return self.translate

    def as_paraphrase_generator(self) -> "ParaphraseAdapter":
        return ParaphraseAdapter(self)


class ParaphraseAdapter:
    """Callable ``(text, n) -> list[str]`` plus ``batch(texts, n)`` so a
    text augmenter can run one decode across a whole query batch."""

    def __init__(self, model: QwenModel, temperature: float = 0.8):
        self.model = model
        self.temperature = temperature

    def __call__(self, text: str, n: int) -> List[str]:
        return self.model.generate_paraphrases(text, n, self.temperature)

    def batch(self, texts: List[str], n: int) -> List[List[str]]:
        return self.batch_async(texts, n)()

    def batch_async(self, texts: List[str], n: int) -> Callable[[], List[List[str]]]:
        return self.model.generate_paraphrases_batch_async(
            texts, n, self.temperature, seed=_stable_seed("\x00".join(texts))
        )


def _to(t, device):
    if _is_q(t):
        return {"int8": t["int8"].to(device), "scale": t["scale"].to(device)}
    return t.to(device) if torch.is_tensor(t) else torch.as_tensor(np.asarray(t), device=device)
