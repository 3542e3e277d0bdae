"""Kimi-Linear decoder-only LM in PyTorch: a paraphrase model for the text
variants of full TVC, beside Qwen2 and DeepSeek-V2, through the same decode
loop and host side (``decoding.CausalDecoder``) and DeepSeek-V2's latent
attention and experts (``deepseek_v2.DeepseekV2Model``, whose paths this
model takes as they are).

* ``KimiLinearConfig``: the published ``Kimi-Linear-48B-A3B`` shape
  (``kimi_linear_48b()``, moonshotai/Kimi-Linear-48B-A3B-Instruct
  ``config.json``) and a ``tiny()`` preset for the CPU tests with the same
  layer pattern (three KDA layers, then a latent one) and routing.
* The layer equations (the published ``modeling_kimi.py`` and
  flash-linear-attention's ``KimiDeltaAttention``): in each layer ``h +=
  Mix(RMSNorm(h))``, then ``h += FFN(RMSNorm(h))``; after the last, the
  final RMSNorm and the untied head.

  - Mix is Kimi Delta Attention (KDA) in the ``kda_layers`` and multi-head
    latent attention in the others: DeepSeek-V2's (no q-LoRA) with 32
    heads, no rotation of the rope dimensions (NoPE: identity tables, so
    the latent cache and kernels are DeepSeek-V2's) and ``softmax_scale``
    ``(nope + rope)^-1/2``.
  - KDA of a normed ``x``: ``q, k, v = SiLU(conv_4(x W_q | x W_k | x
    W_v))`` (a causal depthwise convolution per channel), ``g =
    -exp(A_log) softplus((x W_fa) W_fb + dt_bias)`` per channel, ``beta =
    sigmoid(x W_b)`` per head, ``q = l2norm(q) d^-1/2``, ``k = l2norm(k)``;
    per head a state ``S [d, d]``: ``S <- Diag(exp g) S``, ``S <- S + beta
    k (v - S^T k)^T``, ``o = S^T q``; then ``o <- RMSNorm(o) w
    sigmoid((x W_ga) W_gb)`` per head and ``o W_o``.
  - FFN: the first ``first_k_dense`` layers a SiLU-gated MLP; the others
    256 routed experts chosen by ``sigmoid(x W_router) + bias`` (the
    correction bias), top 8, weighted by the unbiased sigmoids
    renormalised over the 8, times ``routed_scaling_factor``, plus one
    shared expert (``DeepseekV2Model._moe``).

* ``KimiLinearModel``: seeded random weights, a tree, or one part at a time
  (``"embed"``, ``"layer_i"``, ``"ln_f"``, ``"lm_head"``), each quantized to
  w8 as it arrives (int8 per output channel, weight-only), except the
  router and its bias, the convolution's taps, ``A_log``, ``dt_bias`` and
  the norms (f32). A KDA layer's projections that read ``x`` are one w8
  GEMM (q | k | v | f_a | g_a | b), f_b and g_b one more (block-diagonal,
  exact), then three kernels (``kda_kernel``: the convolution and the
  norms, gate and beta; the recurrence on the f32 state in place; the
  gated output norm) and the o GEMM. The decode cache is
  :class:`HybridCache`: the latent cache of the latent layers, the KDA
  state (f32) and the convolution windows of the KDA layers. The prefill
  gives each row its real length, so that a right-padded prompt's pads
  neither decay nor update a state or a window.

Spans ``kimi.prepare``, ``kimi.prefill``, ``kimi.decode_step`` (``step``,
``rows``), ``kimi.readback``; counters ``moe.*`` (DeepSeek-V2's), and, read
back in ``kimi.readback``, ``kda.token_updates``: the row-tokens a decode
call's prefill folds into each KDA layer's state (the shared prefix once,
then each prompt's real suffix; pads excluded).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from tvc_torch.core.kernels.decode_fused_kernel import add_rmsnorm, rmsnorm
from tvc_torch.core.kernels.kda_kernel import kda_gated_norm, kda_prepare, kda_recurrent
from tvc_torch.models import deepseek_v2 as ds
from tvc_torch.models.deepseek_v2 import DeepseekV2Config, DeepseekV2Model, Shapes
from tvc_torch.utils import tracing

#: the published layers, 1-indexed: KDA in all but every fourth and the last
KDA_LAYERS_1 = (1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19, 21, 22, 23, 25, 26)


@dataclasses.dataclass(frozen=True)
class KimiLinearConfig(DeepseekV2Config):
    """Kimi-Linear architecture knobs (defaults: Kimi-Linear-48B-A3B as
    published); the latent attention's and the experts' as
    :class:`DeepseekV2Config`'s."""

    vocab_size: int = 163840
    hidden_size: int = 2304
    intermediate_size: int = 9216
    moe_intermediate_size: int = 1024
    num_layers: int = 27
    first_k_dense: int = 1
    num_heads: int = 32
    n_routed_experts: int = 256
    n_shared_experts: int = 1
    num_experts_per_tok: int = 8
    routed_scaling_factor: float = 2.446
    rope_factor: float = 1.0  # rope_scaling null: no YaRN, softmax_scale (nope + rope)^-1/2
    rms_eps: float = 1e-5
    scoring_func: str = "sigmoid"
    norm_topk_prob: bool = True
    use_rope: bool = False  # mla_use_nope
    model_name: str = "moonshotai/Kimi-Linear-48B-A3B-Instruct"
    #: the KDA layers, 0-indexed (the others are latent attention)
    kda_layers: Tuple[int, ...] = tuple(i - 1 for i in KDA_LAYERS_1)
    kda_heads: int = 32
    kda_head_dim: int = 128
    conv_size: int = 4

    @classmethod
    def kimi_linear_48b(cls) -> "KimiLinearConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "KimiLinearConfig":
        return cls(
            vocab_size=512, hidden_size=64, intermediate_size=96, moe_intermediate_size=32, num_layers=4,
            num_heads=4, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            n_routed_experts=16, num_experts_per_tok=4, kda_layers=(0, 1, 2), kda_heads=2, kda_head_dim=16,
            max_seq_len=64, dtype=torch.float32, model_name="tiny",
        )

    @property
    def kda_width(self) -> int:
        return self.kda_heads * self.kda_head_dim

    @property
    def mla_layers(self) -> Tuple[int, ...]:
        return tuple(i for i in range(self.num_layers) if i not in self.kda_layers)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def kda_shapes(c: KimiLinearConfig, b: str) -> Shapes:
    """A KDA layer's norm and mixing, under prefix ``b``. Kernels ``[in,
    out]``; the three convolutions' taps merged, q | k | v channels,
    ``[3 nh d, K]``. Kinds besides ``w`` and ``ln``: ``alog`` (log U(1,
    16)) and ``dt`` (the inverse softplus of a log-uniform step in
    [1e-3, 0.1]), the published initialisation."""
    H, d, HD, K = c.hidden_size, c.kda_head_dim, c.kda_width, c.conv_size
    return [
        (f"{b}.ln_attn.scale", (H,), "ln", 0.1),
        (f"{b}.kda.q.kernel", (H, HD), "w", H ** -0.5),
        (f"{b}.kda.k.kernel", (H, HD), "w", H ** -0.5),
        (f"{b}.kda.v.kernel", (H, HD), "w", H ** -0.5),
        (f"{b}.kda.f_a.kernel", (H, d), "w", H ** -0.5),
        (f"{b}.kda.f_b.kernel", (d, HD), "w", d ** -0.5),
        (f"{b}.kda.g_a.kernel", (H, d), "w", H ** -0.5),
        (f"{b}.kda.g_b.kernel", (d, HD), "w", d ** -0.5),
        (f"{b}.kda.b.kernel", (H, c.kda_heads), "w", H ** -0.5),
        (f"{b}.kda.conv.kernel", (3 * HD, K), "w", K ** -0.5),
        (f"{b}.kda.a_log", (c.kda_heads,), "alog", 0.0),
        (f"{b}.kda.dt_bias", (HD,), "dt", 0.0),
        (f"{b}.kda.o_norm.scale", (d,), "ln", 0.1),
        (f"{b}.kda.o.kernel", (HD, H), "w", HD ** -0.5),
    ]


def part_shapes(c: KimiLinearConfig, part: str) -> Shapes:
    """``(name, shape, kind, std)`` of a part's parameters (as
    :func:`deepseek_v2.part_shapes`; a KDA layer's mixing in place of the
    latent attention)."""
    if not part.startswith("layer_"):
        return ds.part_shapes(c, part)
    i = int(part.split("_")[1])
    mix = kda_shapes(c, part) if i in c.kda_layers else ds.mla_shapes(c, part)
    return mix + ds.ffn_shapes(c, part, i)


def draw_part(cfg: KimiLinearConfig, part: str, gen: torch.Generator, device, shapes=part_shapes) -> Dict[str, Tensor]:
    """One part's seeded random parameters, f32, flat names."""
    out = {}
    for name, shape, kind, std in shapes(cfg, part):
        if kind == "alog":
            out[name] = torch.log(1 + 15 * torch.rand(shape, generator=gen, device=device))
        elif kind == "dt":
            lo, hi = math.log(1e-3), math.log(0.1)
            dt = torch.exp(torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo).clamp(min=1e-4)
            out[name] = dt + torch.log(-torch.expm1(-dt))
        else:
            t = torch.randn(shape, generator=gen, device=device) * std
            out[name] = t + 1.0 if kind == "ln" else t
    return out


@dataclasses.dataclass
class HybridCache:
    """A decode's cache: ``latent [latent layers, B, S, r + rope]`` (the
    latent layers' slots), ``state`` f32 ``[KDA layers, B, nh, d, d]`` and
    ``conv [KDA layers, B, K - 1, 3 nh d]`` (each row's last inputs)."""

    latent: Tensor
    state: Tensor
    conv: Tensor


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


class KimiLinearModel(DeepseekV2Model):
    """Kimi-Linear under the w8 scheme with the decode, the paraphrase and
    translation entry points of :class:`CausalDecoder`. Runs on the card
    unless given ``device="cpu"``."""

    SPANS = ("kimi.prepare", "kimi.prefill", "kimi.decode_step", "kimi.readback")
    part_shapes = staticmethod(part_shapes)
    draw_part = staticmethod(draw_part)
    F32_MATRICES = ("router.kernel", "conv.kernel")

    def __init__(self, config: Optional[KimiLinearConfig] = None, params=None, seed: int = 0, tokenizer=None,
                 max_new_tokens: int = 32, device=None):
        """As :class:`DeepseekV2Model`; default config ``KimiLinearConfig.tiny()``."""
        super().__init__(config or KimiLinearConfig.tiny(), params, seed, tokenizer, max_new_tokens, device)
        c = self.config
        self._kda_index = {i: j for j, i in enumerate(c.kda_layers)}
        self._mla_index = {i: j for j, i in enumerate(c.mla_layers)}
        self._kda_updates = None

    # -- the decode state ------------------------------------------------------------
    def _decode_state(self) -> Tuple[Dict, List[Dict]]:
        if self._state is not None:
            return self._state
        c, p = self.config, self.params
        layers = []
        for i in range(c.num_layers):
            lp = p[f"layer_{i}"]
            mix = self._kda_state(lp["kda"]) if i in self._kda_index else self._mla_state(lp["attn"])
            layers.append({"ln_attn": lp["ln_attn"]["scale"], **mix, **self._ffn_state(lp, i)})
        non_layer = {k: v for k, v in p.items() if not k.startswith("layer_")}
        self._state = (non_layer, layers)
        return self._state

    def _kda_state(self, a: Dict) -> Dict:
        """A KDA layer's decode weights: q|k|v|f_a|g_a|b merged into one w8
        GEMM, f_b and g_b into one block-diagonal w8 GEMM (its zero blocks
        quantize to 0 and add nothing), the rest as given."""
        d, HD = self.config.kda_head_dim, self.config.kda_width
        names = ("q", "k", "v", "f_a", "g_a", "b")
        fb, gb = a["f_b"]["kernel"], a["g_b"]["kernel"]
        wfg = torch.zeros((2 * d, 2 * HD), dtype=torch.int8, device=self.device)
        wfg[:d, :HD], wfg[d:, HD:] = fb["int8"], gb["int8"]
        return {
            "w_in": {"int8": torch.cat([a[n]["kernel"]["int8"] for n in names], dim=1).contiguous(),
                     "scale": torch.cat([a[n]["kernel"]["scale"] for n in names]).contiguous()},
            "w_fg": {"int8": wfg, "scale": torch.cat([fb["scale"], gb["scale"]]).contiguous()},
            "conv": a["conv"]["kernel"], "a_log": a["a_log"], "dt_bias": a["dt_bias"],
            "o_norm": a["o_norm"]["scale"], "wo": a["o"]["kernel"],
        }

    # -- the cache ---------------------------------------------------------------------
    def _new_cache(self, B: int, S: int) -> HybridCache:
        """The latent cache, the KDA state and windows, zeroed."""
        c = self.config
        nk = len(c.kda_layers)
        return HybridCache(
            latent=torch.zeros((len(c.mla_layers), B, S, c.latent_width), dtype=c.dtype, device=self.device),
            state=torch.zeros((nk, B, c.kda_heads, c.kda_head_dim, c.kda_head_dim), dtype=torch.float32,
                              device=self.device),
            conv=torch.zeros((nk, B, c.conv_size - 1, 3 * c.kda_width), dtype=c.dtype, device=self.device),
        )

    @staticmethod
    def _put_prefix(cache: HybridCache, pre: HybridCache, P: int) -> None:
        cache.latent[:, :, :P] = pre.latent
        cache.state.copy_(pre.state.expand_as(cache.state))
        cache.conv.copy_(pre.conv.expand_as(cache.conv))

    @staticmethod
    def _tile_cache(cache: HybridCache, n: int) -> HybridCache:
        return HybridCache(*(t.repeat_interleave(n, dim=1) for t in (cache.latent, cache.state, cache.conv)))

    # -- the layers --------------------------------------------------------------------
    def _kda(self, L: Dict, j: int, x: Tensor, cache: HybridCache, lengths: Optional[Tensor]) -> Tensor:
        """KDA layer ``j`` (of the KDA layers) on a normed ``x [B, T, H]``,
        its state and window updated over each row's ``lengths`` tokens."""
        c = self.config
        nh, d, HD = c.kda_heads, c.kda_head_dim, c.kda_width
        y = self._mm(x, L["w_in"])  # [B, T, 3 HD + 2 d + nh]
        fg = self._mm(y[..., 3 * HD : 3 * HD + 2 * d], L["w_fg"])  # [B, T, 2 HD]: f | gate
        qkvg, beta = kda_prepare(y, fg, L["conv"], L["a_log"], L["dt_bias"], cache.conv[j], lengths, nh,
                                 3 * HD + 2 * d)
        o = kda_recurrent(qkvg, beta, cache.state[j], lengths, c.dtype)
        return self._mm(kda_gated_norm(o, fg[..., HD:], L["o_norm"], c.rms_eps), L["wo"])

    def _layer(self, L: Dict, i: int, h: Tensor, y: Optional[Tensor], cos, sin, mask, cache: HybridCache,
               cache_index, ctx, step, lengths=None) -> Tuple[Tensor, Tensor]:
        """As :meth:`DeepseekV2Model._layer`; a KDA layer stops each row at
        its ``lengths``, a latent layer reads the mask."""
        eps = self.config.rms_eps
        if y is None:
            x = rmsnorm(h, L["ln_attn"], eps)
        else:
            h, x = add_rmsnorm(h, y, L["ln_attn"], eps)
        if i in self._kda_index:
            mix = self._kda(L, self._kda_index[i], x, cache, lengths)
        else:
            mix = self._attention(L, self._mla_index[i], x, cos, sin, mask, cache.latent, cache_index, ctx)
        h, x = add_rmsnorm(h, mix, L["ln_mlp"], eps)
        return h, self._ffn(L, x, step)

    # -- the counters ------------------------------------------------------------------
    def decode(self, inp, *args, **kwargs):
        """:meth:`CausalDecoder.decode`, the row-tokens its prefill folds
        into each KDA state (the prefix once, each prompt's suffix up to
        its length) kept on the device for its readback."""
        self._kda_updates = inp.P + (inp.lengths - inp.P).sum()
        return super().decode(inp, *args, **kwargs)

    def _decode_aux(self):
        return super()._decode_aux(), self._kda_updates

    def _readback(self, rows: Tensor, aux) -> np.ndarray:
        moe, updates = aux
        out = super()._readback(rows, moe)
        tracing.count("kda.token_updates", int(updates))
        return out


def published_config(cfg: Dict[str, Any], **over) -> KimiLinearConfig:
    """A :class:`KimiLinearConfig` from the published ``config.json`` keys
    (``linear_attn_config``'s layers 1-indexed, as published)."""
    la = cfg["linear_attn_config"]
    return KimiLinearConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"], intermediate_size=cfg["intermediate_size"],
        moe_intermediate_size=cfg["moe_intermediate_size"], num_layers=cfg["num_hidden_layers"],
        first_k_dense=cfg["first_k_dense_replace"], num_heads=cfg["num_attention_heads"],
        kv_lora_rank=cfg["kv_lora_rank"], qk_nope_head_dim=cfg["qk_nope_head_dim"],
        qk_rope_head_dim=cfg["qk_rope_head_dim"], v_head_dim=cfg["v_head_dim"], n_routed_experts=cfg["num_experts"],
        n_shared_experts=cfg["num_shared_experts"], num_experts_per_tok=cfg["num_experts_per_token"],
        routed_scaling_factor=cfg["routed_scaling_factor"], rope_theta=cfg["rope_theta"], rms_eps=cfg["rms_norm_eps"],
        scoring_func=cfg["moe_router_activation_func"], norm_topk_prob=cfg["moe_renormalize"],
        use_rope=not cfg["mla_use_nope"], kda_layers=tuple(i - 1 for i in la["kda_layers"]),
        kda_heads=la["num_heads"], kda_head_dim=la["head_dim"], conv_size=la["short_conv_kernel_size"], **over,
    )
