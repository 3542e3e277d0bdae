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
``decode_gqa_attention_stacked``. The elementwise steps between the GEMMs
go through the fused kernels of ``decode_fused_kernel``: each RMSNorm with
the residual add before it (``add_rmsnorm``, ``rmsnorm`` where no add comes
first; the layer loop carries each residual branch's output into the next
norm), the SiLU-gated product (``silu_mul``) and, in a decode step, the
q|k|v bias, rotary embedding and cache write (``qkv_rope_cache``). The
prefill attention and rotary embedding, the tied head and sampling are
plain PyTorch, as the JAX package leaves them to XLA. Sampling uses an
explicit ``torch.Generator`` and an exact top-50: the draws are not
``jax.random``'s.

With a ``mesh`` (a ``model`` axis) ``QwenModel(...)`` builds a
``TPQwenModel`` (``tvc_torch.parallel.tp``), the tensor-parallel
implementation of the same hooks: each rank holds its Megatron slices, and
the decode takes the JAX package's module path under TP: per layer the
int8 leaves dequantize to bf16, plain ``torch.matmul`` on the slices, the
module attention, and the collectives of ``tp_block`` (q|k|v and gate|up
stay unmerged). Every rank passes the same prompts and gets the same
tokens.
"""

from __future__ import annotations

import dataclasses
import inspect
import math
import os
from collections.abc import Mapping
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor, nn

from tvc_torch._device import disable_tf32, resolve_device
from tvc_torch.core.kernels.decode_attention_kernel import decode_gqa_attention_stacked
from tvc_torch.core.kernels.decode_fused_kernel import (
    add_rmsnorm,
    apply_rope,
    qkv_rope_cache,
    rmsnorm,
    rmsnorm_reference,
    silu_mul,
)
from tvc_torch.core.kernels.quantized_layer_kernel import quantize_linear
from tvc_torch.core.kernels.w8_matmul_kernel import (
    w8_matmul,
    w8_matmul_reference,
    w8_matmul_stacked,
    w8a8_matmul,
    w8a8_matmul_stacked,
)
from tvc_torch.models import decoding as _decoding
from tvc_torch.models.decoding import (  # noqa: F401  (the names this module has always offered)
    PARAPHRASE_PREFIX,
    PARAPHRASE_PROMPT,
    TRANSLATE_PREFIX,
    TRANSLATE_PROMPT,
    W8_MAX_ROWS,
    CausalDecoder,
    DecodeInputs,
    ParaphraseAdapter,
    _flatten,
    _is_q,
    _stable_seed,
    _to,
    _unflatten,
    takes_kernel,
)


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


def rope_tables(positions: Tensor, head_dim: int, theta: float) -> Tuple[Tensor, Tensor]:
    """f32 cos / sin ``[B, T, 1, head_dim / 2]`` of the rotary angles."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=positions.device) / half))
    angles = positions[..., None].float() * freqs
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


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
        return rmsnorm_reference(x, self.scale, self.eps)


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


#: early-exit decode granularity (see ``decoding.DECODE_CHUNK``); read at
#: each decode call, so a test may patch it here
DECODE_CHUNK = _decoding.DECODE_CHUNK


class QwenModel(CausalDecoder):
    """User-facing wrapper: parameters, tokenizer, the decode and
    ``generate_paraphrases(text, num_paraphrases, temperature)`` (the
    decode loop and the host side are :class:`CausalDecoder`'s)."""

    SPANS = ("qwen.prepare", "qwen.prefill", "qwen.decode_step", "qwen.readback")

    def __new__(cls, *args, **kwargs):
        """Given a ``mesh`` (by keyword or by position), the model is the
        tensor-parallel :class:`tvc_torch.parallel.tp.TPQwenModel`."""
        mesh = inspect.signature(cls.__init__).bind(None, *args, **kwargs).arguments.get("mesh")
        if cls is QwenModel and mesh is not None:
            from tvc_torch.parallel.tp import TPQwenModel

            cls = TPQwenModel
        return super().__new__(cls)

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

        mesh: a ``DeviceMesh`` with a ``model`` axis: tensor-parallel
        (``TPQwenModel``). The parameters (given, or the seeded init, built
        one layer at a time with ``init_int8``) are cut to this rank's
        slices (``shard_qwen_params``), so every rank holds the numbers the
        single-device model holds; the model lives on the mesh's device."""
        self.config = c = config or QwenConfig.tiny()
        self.mesh = mesh
        self.device = self._device_for(device)
        disable_tf32(self.device)
        self.module = QwenLM(c, device="meta")
        self.max_new_tokens = max_new_tokens
        self.decode_only = decode_only
        if params is None and init_int8:
            params = self._init_params_int8(seed)  # placed one layer at a time
        else:
            if params is None:
                params = init_params(c, seed, self.device)
            else:
                params = _tree_map(lambda n, t: _to(t, self.device), params)
            if cast_params_bf16:
                params = _tree_map(
                    lambda n, t: t.to(torch.bfloat16) if torch.is_tensor(t) and t.ndim >= 2 else t, params
                )
            params = self._place(params)
        self.params = params
        if tokenizer is None:
            from tvc_torch.models.tokenizer import get_tokenizer

            tokenizer = get_tokenizer(
                vocab_size=c.vocab_size, context_length=c.max_seq_len,
                merges_path=os.environ.get("TVC_QWEN_TOKENIZER"),
            )
        self.tokenizer = tokenizer
        self._decode_state_cache = None

    # -- where the parameters live ----------------------------------------------------
    def _device_for(self, device) -> torch.device:
        """The device the model runs on."""
        return resolve_device(device)

    def _place(self, tree: Dict) -> Dict:
        """What this process holds of a full (sub)tree of the parameters:
        all of it."""
        return tree

    # -- int8 weights ------------------------------------------------------------
    def quantize_weights_int8(self, include_embed: bool = True) -> None:
        """Per-output-channel symmetric int8 on every 2-D matrix param
        (the embedding too unless ``include_embed`` is false)."""
        self.params = _tree_map(lambda n, t: self._quantized(n, t, include_embed), self.params)
        self._decode_state_cache = None

    _quantized = staticmethod(_quantize_leaf)  # one leaf of quantize_weights_int8

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
            params.update(self._place({f"layer_{i}": _unflatten(flat)}))  # placed whole, before the next layer
        table = lambda *shape: 0.02 * torch.randn(shape, generator=gen, device=dev)
        rest = {"embed": {"embedding": _quantize_leaf("embed.embedding", table(c.vocab_size, c.hidden_size))},
                "ln_f": {"scale": torch.ones(c.hidden_size, device=dev)}}
        if not c.tie_embeddings:
            rest["lm_head"] = {"kernel": _quantize_leaf("lm_head.kernel", table(c.hidden_size, c.vocab_size))}
        params.update(self._place(rest))
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
    def _mm(self, x3: Tensor, leaf, layer: Optional[int] = None) -> Tensor:
        """x [B, T, K] @ a weight leaf, or @ layer ``layer`` of a stacked
        one. An int8 leaf goes through the W8A8 or the weight-only kernel
        (the stacked one on a stacked leaf) where :func:`takes_kernel`
        says so, else through dequantize-then-matmul."""
        c = self.config
        B, T = x3.shape[:2]
        if not _is_q(leaf):
            return x3.to(c.dtype) @ (leaf if layer is None else leaf[layer]).to(c.dtype)
        w, s = leaf["int8"], leaf["scale"]
        if not takes_kernel(B * T, c.quant_gemm):
            if layer is not None:
                w, s = w[layer], s[layer]
            return w8_matmul_reference(x3.to(c.dtype), w, s)
        x2 = x3.reshape(B * T, -1).to(c.dtype).contiguous()
        if layer is None:
            y = (w8a8_matmul if c.quant_gemm == "w8a8" else w8_matmul)(x2, w, s)
        else:
            y = (w8a8_matmul_stacked if c.quant_gemm == "w8a8" else w8_matmul_stacked)(x2, w, s, layer)
        return y.reshape(B, T, -1)

    def _head(self, non_layer: Dict, allowed: Optional[Tensor]) -> Callable[[Tensor], Tensor]:
        """The f32 logits of the last hidden state: over the whole vocab or,
        for constrained decoding, over the allowed rows gathered once; a
        tied head is the embedding table's (plain PyTorch), an untied one
        :class:`CausalDecoder`'s."""
        c = self.config
        dt = c.dtype
        if not c.tie_embeddings:
            return super()._head(non_layer, allowed)
        e = non_layer["embed"]["embedding"]
        if allowed is not None:
            tbl = self._embed(non_layer, allowed)
        else:
            tbl = (e["int8"].to(torch.bfloat16) * e["scale"].to(torch.bfloat16) if _is_q(e) else e).to(dt)
        return lambda x: (x.to(dt) @ tbl.T).float()

    def _merged_layer(self, stacked, l, h, y, cos, sin, mask, ck, cv, cache_index, ctx):
        """QwenBlock with q|k|v and gate|up as single GEMMs, on the residual
        stream ``h`` and the previous layer's MLP output ``y`` not yet added
        to it (None before the first layer); returns ``(h, y)`` of this
        layer, its MLP output not added. The cache is KV-major ``[L, B, KV,
        S, Dh]``; this step's k / v are written into it in place. T == 1
        (decode): the fused q|k|v epilogue and the decode attention kernel
        over layer l of the stacked cache, mask [B, S]; else (prefill):
        plain attention over the block plus the ``ctx`` cached prefix slots,
        mask [B, 1, T, S]."""
        c = self.config
        B, T, _ = h.shape
        Dh = c.hidden_size // c.num_heads
        nq, nkv, R = c.num_heads * Dh, c.num_kv_heads * Dh, c.num_heads // c.num_kv_heads
        if y is None:
            x = rmsnorm(h, stacked["ln_attn"][l], c.rms_eps)
        else:
            h, x = add_rmsnorm(h, y, stacked["ln_attn"][l], c.rms_eps)
        qkv = self._mm(x, stacked["wqkv"], l)
        if T == 1:
            q = qkv_rope_cache(qkv, stacked["bqkv"][l], cos, sin, ck, cv, l, cache_index)
            out = decode_gqa_attention_stacked(q, ck, cv, mask, l).reshape(B, 1, nq)
        else:
            qkv = qkv + stacked["bqkv"][l].to(c.dtype)
            q = apply_rope(qkv[..., :nq].reshape(B, T, c.num_heads, Dh), cos, sin)
            k = apply_rope(qkv[..., nq : nq + nkv].reshape(B, T, c.num_kv_heads, Dh), cos, sin)
            v = qkv[..., nq + nkv :].reshape(B, T, c.num_kv_heads, Dh)
            k_t, v_t = k.transpose(1, 2), v.transpose(1, 2)  # [B, KV, T, Dh]
            ck[l, :, :, cache_index : cache_index + T] = k_t
            cv[l, :, :, cache_index : cache_index + T] = v_t
            kk, vv = (ck[l, :, :, : ctx + T], cv[l, :, :, : ctx + T]) if ctx else (k_t, v_t)
            qg = q.reshape(B, T, c.num_kv_heads, R, Dh)
            out = _gqa_attention(qg, kk, vv, mask[:, 0, :, : ctx + T], c.dtype).reshape(B, T, nq)
        h, x = add_rmsnorm(h, self._mm(out, stacked["wo"], l), stacked["ln_mlp"][l], c.rms_eps)
        gu = self._mm(x, stacked["wgu"], l)
        return h, self._mm(silu_mul(gu, c.intermediate_size), stacked["wd"], l)

    def _run_layers(self, stacked, x, positions, mask, caches, cache_index, ctx=0, step=None, lengths=None):
        """Every layer: mask [B, 1, T, S] (prefill) or [B, S] (one step);
        ``step`` and ``lengths`` (the mask's) are not read. Returns ``(h,
        y)`` (``CausalDecoder``)."""
        c = self.config
        cos, sin = rope_tables(positions, c.hidden_size // c.num_heads, c.rope_theta)
        y = None
        for l in range(c.num_layers):
            x, y = self._merged_layer(stacked, l, x, y, cos, sin, mask, caches[0], caches[1], cache_index, ctx)
        return x, y

    # -- the decode loop's hooks (``CausalDecoder``) ---------------------------------------
    def _chunk(self) -> int:
        return DECODE_CHUNK

    def _new_cache(self, B: int, S: int) -> Tuple[Tensor, Tensor]:
        """The KV-major caches ``[L, B, KV, S, Dh]``, zeroed."""
        c = self.config
        shape = (c.num_layers, B, c.num_kv_heads, S, c.hidden_size // c.num_heads)
        return (torch.zeros(shape, dtype=c.dtype, device=self.device),
                torch.zeros(shape, dtype=c.dtype, device=self.device))

    @staticmethod
    def _put_prefix(cache, pre, P: int) -> None:
        for cz, cp in zip(cache, pre):
            cz[:, :, :, :P] = cp

    @staticmethod
    def _tile_cache(cache, n: int):
        return tuple(t.repeat_interleave(n, dim=1) for t in cache)
