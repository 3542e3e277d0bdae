"""Nemotron-H decoder-only LM in PyTorch: a paraphrase model for the text
variants of full TVC, beside Qwen2, DeepSeek-V2 and Kimi-Linear, through
the same decode loop and host side (``decoding.CausalDecoder``),
DeepSeek-V2's experts (``deepseek_v2.DeepseekV2Model``, whose MoE path
this model takes as it is) and Qwen2's grouped-query attention.

* ``NemotronHConfig``: the published ``NVIDIA-Nemotron-3-Nano-30B-A3B``
  shape (``nemotron3_nano_30b()``, nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16
  ``config.json``) and a ``tiny()`` preset for the CPU tests with one full
  period of the block kinds (``MEM*E``).
* The block equations (the published ``modeling_nemotron_h.py``): one mixer
  a block, ``h += Mix(RMSNorm(h))``, the mixer given by the block's letter
  in ``hybrid_override_pattern``; after the last, the final RMSNorm and the
  untied head.

  - ``M``, Mamba-2: ``[z | xBC | dt] = x W_in``; ``xBC = SiLU(conv_K(xBC) +
    b)`` (a causal depthwise convolution per channel), split into ``x``
    (nh heads of P), ``B`` and ``C`` (groups of N; head h reads group ``h //
    (nh / groups)``); ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``;
    per head a state ``S [P, N]``: ``S <- exp(dt A) S + (dt B) x^T``, ``y =
    S C + D x``; then ``o = RMSNorm_group(y * SiLU(z)) w`` over groups of
    ``nh P / groups`` channels and ``o W_out``.
  - ``*``, attention: ``q, k, v = x W_q, x W_k, x W_v`` (``num_heads``
    query heads and ``num_kv_heads`` key / value heads of ``head_dim``), no
    rotary embedding (NemotronH's attention applies none), ``softmax(q k^T
    / sqrt(head_dim))`` over the cache, then ``W_o``.
  - ``E``, experts: 128 routed experts chosen by ``sigmoid(x W_router) +
    bias`` (the correction bias), top 6, weighted by the unbiased sigmoids
    renormalised over the 6, times ``routed_scaling_factor``, plus one
    shared expert; every expert non-gated, ``relu(x W_up)^2 W_down``
    (``DeepseekV2Model._moe`` with ``expert_act`` ``relu2``).

* ``NemotronHModel``: seeded random weights, a tree, or one part at a time
  (``"embed"``, ``"layer_i"``, ``"ln_f"``, ``"lm_head"``), each quantized to
  w8 as it arrives (int8 per output channel, weight-only), except the
  router and its bias, the convolution's taps and bias, ``A_log``,
  ``dt_bias``, ``D`` and the norms (f32). An SSM block is its W_in GEMM
  (w8), three kernels (``ssm_kernel``: the convolution and the step; the
  recurrence on the f32 state in place; the gated norm) and its W_out
  GEMM; an attention block its q|k|v GEMM, the cache write
  (``qkv_cache``), the decode attention and W_o. The decode cache is
  :class:`NemotronCache`: the KV cache of the attention blocks, the SSM
  state (f32) and the convolution windows of the SSM blocks. The prefill
  gives each row its real length, so that a right-padded prompt's pads
  neither decay nor update a state or a window.

Spans ``nemotron.prepare``, ``nemotron.prefill``, ``nemotron.decode_step``
(``step``, ``rows``), ``nemotron.readback``; counters ``moe.*``
(DeepSeek-V2's), and, read back in ``nemotron.readback``,
``ssm.token_updates``: the row-tokens a decode call's prefill folds into
each SSM block's state (the shared prefix once, then each prompt's real
suffix; pads excluded).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from tvc_torch.core.kernels.decode_attention_kernel import decode_gqa_attention_stacked
from tvc_torch.core.kernels.decode_fused_kernel import add_rmsnorm, qkv_cache, rmsnorm
from tvc_torch.core.kernels.ssm_kernel import ssm_gated_norm, ssm_prepare, ssm_recurrent
from tvc_torch.models import deepseek_v2 as ds
from tvc_torch.models.deepseek_v2 import DeepseekV2Config, DeepseekV2Model, Shapes
from tvc_torch.models.qwen import _gqa_attention
from tvc_torch.utils import tracing

#: the published block kinds: M Mamba-2, E experts, * attention
PATTERN = "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"


@dataclasses.dataclass(frozen=True)
class NemotronHConfig(DeepseekV2Config):
    """Nemotron-H architecture knobs (defaults: NVIDIA-Nemotron-3-Nano-30B-A3B
    as published); the experts' and the routing's as
    :class:`DeepseekV2Config`'s (no dense blocks, so ``first_k_dense`` 0).
    The latent-attention, dense-MLP and rotary knobs it inherits are not
    read."""

    vocab_size: int = 131072
    hidden_size: int = 2688
    moe_intermediate_size: int = 1856
    #: the shared expert's width
    shared_intermediate_size: int = 3712
    num_layers: int = 52
    first_k_dense: int = 0
    num_heads: int = 32
    num_kv_heads: int = 2
    head_dim: int = 128
    n_routed_experts: int = 128
    n_shared_experts: int = 1
    num_experts_per_tok: int = 6
    routed_scaling_factor: float = 2.5
    rms_eps: float = 1e-5
    scoring_func: str = "sigmoid"
    norm_topk_prob: bool = True
    use_rope: bool = False
    expert_act: str = "relu2"
    model_name: str = "nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16"
    #: one letter a block: M Mamba-2, E experts, * attention
    pattern: str = PATTERN
    mamba_heads: int = 64
    mamba_head_dim: int = 64
    ssm_state: int = 128
    ssm_groups: int = 8
    conv_size: int = 4

    @classmethod
    def nemotron3_nano_30b(cls) -> "NemotronHConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "NemotronHConfig":
        return cls(
            vocab_size=512, hidden_size=64, moe_intermediate_size=32,
            shared_intermediate_size=48, num_layers=5, num_heads=4, num_kv_heads=2, head_dim=16,
            n_routed_experts=16, num_experts_per_tok=4, pattern="MEM*E", mamba_heads=4, mamba_head_dim=8,
            ssm_state=16, ssm_groups=2, max_seq_len=64, dtype=torch.float32, model_name="tiny",
        )

    def __post_init__(self):
        if len(self.pattern) != self.num_layers or set(self.pattern) - set("ME*"):
            raise ValueError(f"pattern {self.pattern!r} must give one of M, E, * for each of {self.num_layers} blocks")

    def blocks(self, kind: str) -> Tuple[int, ...]:
        """The indices of the blocks of one kind."""
        return tuple(i for i, k in enumerate(self.pattern) if k == kind)

    @property
    def n_moe_layers(self) -> int:
        return self.pattern.count("E")

    @property
    def ssm_width(self) -> int:
        """The SSM's inner width: its heads times their width."""
        return self.mamba_heads * self.mamba_head_dim

    @property
    def conv_channels(self) -> int:
        """The convolved channels: x | B | C."""
        return self.ssm_width + 2 * self.ssm_groups * self.ssm_state

    @property
    def ssm_in_width(self) -> int:
        """W_in's output: z | xBC | dt."""
        return self.ssm_width + self.conv_channels + self.mamba_heads


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def part_shapes(c: NemotronHConfig, part: str) -> Shapes:
    """``(name, shape, kind, std)`` of a part's parameters (names dotted from
    the model's root; kernels ``[in, out]``, experts ``[E, in, out]``).
    Kinds besides ``w`` and ``ln``: ``alog`` (log U(1, 16)) and ``dt`` (the
    inverse softplus of a log-uniform step in [1e-3, 0.1], floored at 1e-4),
    the published initialisation; D is drawn as a norm scale is, not left
    at 1, so that a path that drops or misplaces it shows."""
    if not part.startswith("layer_"):
        return ds.part_shapes(c, part)
    H = c.hidden_size
    i = int(part.split("_")[1])
    b = part
    out: Shapes = [(f"{b}.ln.scale", (H,), "ln", 0.1)]
    kind = c.pattern[i]
    if kind == "M":
        I, C, nh = c.ssm_width, c.conv_channels, c.mamba_heads
        return out + [
            (f"{b}.ssm.in.kernel", (H, c.ssm_in_width), "w", H ** -0.5),
            (f"{b}.ssm.conv.kernel", (C, c.conv_size), "w", c.conv_size ** -0.5),
            (f"{b}.ssm.conv.bias", (C,), "w", 0.1),
            (f"{b}.ssm.a_log", (nh,), "alog", 0.0),
            (f"{b}.ssm.dt_bias", (nh,), "dt", 0.0),
            (f"{b}.ssm.d", (nh,), "ln", 0.1),
            (f"{b}.ssm.norm.scale", (I,), "ln", 0.1),
            (f"{b}.ssm.out.kernel", (I, H), "w", I ** -0.5),
        ]
    if kind == "*":
        nq, nkv = c.num_heads * c.head_dim, c.num_kv_heads * c.head_dim
        return out + [
            (f"{b}.attn.q.kernel", (H, nq), "w", H ** -0.5),
            (f"{b}.attn.k.kernel", (H, nkv), "w", H ** -0.5),
            (f"{b}.attn.v.kernel", (H, nkv), "w", H ** -0.5),
            (f"{b}.attn.o.kernel", (nq, H), "w", nq ** -0.5),
        ]
    E, Ie, Is = c.n_routed_experts, c.moe_intermediate_size, c.shared_intermediate_size
    return out + [
        (f"{b}.moe.router.kernel", (H, E), "w", H ** -0.5),
        (f"{b}.moe.router.bias", (E,), "w", 0.1),
        (f"{b}.moe.experts.up.kernel", (E, H, Ie), "w", H ** -0.5),
        (f"{b}.moe.experts.down.kernel", (E, Ie, H), "w", Ie ** -0.5),
        (f"{b}.moe.shared.up.kernel", (H, Is), "w", H ** -0.5),
        (f"{b}.moe.shared.down.kernel", (Is, H), "w", Is ** -0.5),
    ]


def draw_part(cfg: NemotronHConfig, part: str, gen: torch.Generator, device, shapes=part_shapes) -> Dict[str, Tensor]:
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
class NemotronCache:
    """A decode's cache: ``k``, ``v [attention blocks, B, kv, S, D]`` (the
    KV-major slots of the attention blocks), ``state`` f32 ``[SSM blocks, B,
    nh, P, N]`` and ``conv [SSM blocks, B, K - 1, C]`` (each row's last
    inputs)."""

    k: Tensor
    v: Tensor
    state: Tensor
    conv: Tensor


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


class NemotronHModel(DeepseekV2Model):
    """Nemotron-H under the w8 scheme with the decode, the paraphrase and
    translation entry points of :class:`CausalDecoder`. Runs on the card
    unless given ``device="cpu"``."""

    SPANS = ("nemotron.prepare", "nemotron.prefill", "nemotron.decode_step", "nemotron.readback")
    part_shapes = staticmethod(part_shapes)
    draw_part = staticmethod(draw_part)
    F32_MATRICES = ("router.kernel", "conv.kernel")

    def __init__(self, config: Optional[NemotronHConfig] = None, params=None, seed: int = 0, tokenizer=None,
                 max_new_tokens: int = 32, device=None):
        """As :class:`DeepseekV2Model`; default config ``NemotronHConfig.tiny()``."""
        super().__init__(config or NemotronHConfig.tiny(), params, seed, tokenizer, max_new_tokens, device)
        c = self.config
        #: each block's index among the blocks of its kind
        self._index = {i: j for kind in "ME*" for j, i in enumerate(c.blocks(kind))}
        self._ssm_updates = None

    # -- the decode state ------------------------------------------------------------
    def _decode_state(self) -> Tuple[Dict, List[Dict]]:
        if self._state is not None:
            return self._state
        c, p = self.config, self.params
        layers = []
        for i, kind in enumerate(c.pattern):
            lp = p[f"layer_{i}"]
            if kind == "M":
                mix = self._ssm_state(lp["ssm"])
            elif kind == "*":
                mix = self._attn_state(lp["attn"])
            else:
                mix = self._moe_state(lp["moe"], self._index[i])
            layers.append({"ln": lp["ln"]["scale"], **mix})
        non_layer = {k: v for k, v in p.items() if not k.startswith("layer_")}
        self._state = (non_layer, layers)
        return self._state

    @staticmethod
    def _ssm_state(a: Dict) -> Dict:
        return {"w_in": a["in"]["kernel"], "conv": a["conv"]["kernel"], "conv_b": a["conv"]["bias"],
                "a_log": a["a_log"], "dt_bias": a["dt_bias"], "d": a["d"], "norm": a["norm"]["scale"],
                "wo": a["out"]["kernel"]}

    def _attn_state(self, a: Dict) -> Dict:
        """q|k|v merged into one w8 GEMM."""
        names = ("q", "k", "v")
        return {"wqkv": {"int8": torch.cat([a[n]["kernel"]["int8"] for n in names], dim=1).contiguous(),
                         "scale": torch.cat([a[n]["kernel"]["scale"] for n in names]).contiguous()},
                "wo": a["o"]["kernel"]}

    # -- the cache ---------------------------------------------------------------------
    def _new_cache(self, B: int, S: int) -> NemotronCache:
        """The KV cache, the SSM state and windows, zeroed."""
        c = self.config
        kv = (len(c.blocks("*")), B, c.num_kv_heads, S, c.head_dim)
        ns = len(c.blocks("M"))
        return NemotronCache(
            k=torch.zeros(kv, dtype=c.dtype, device=self.device),
            v=torch.zeros(kv, dtype=c.dtype, device=self.device),
            state=torch.zeros((ns, B, c.mamba_heads, c.mamba_head_dim, c.ssm_state), dtype=torch.float32,
                              device=self.device),
            conv=torch.zeros((ns, B, c.conv_size - 1, c.conv_channels), dtype=c.dtype, device=self.device),
        )

    @staticmethod
    def _put_prefix(cache: NemotronCache, pre: NemotronCache, P: int) -> None:
        cache.k[:, :, :, :P] = pre.k
        cache.v[:, :, :, :P] = pre.v
        cache.state.copy_(pre.state.expand_as(cache.state))
        cache.conv.copy_(pre.conv.expand_as(cache.conv))

    @staticmethod
    def _tile_cache(cache: NemotronCache, n: int) -> NemotronCache:
        return NemotronCache(*(t.repeat_interleave(n, dim=1) for t in (cache.k, cache.v, cache.state, cache.conv)))

    # -- the blocks --------------------------------------------------------------------
    def _ssm(self, L: Dict, j: int, x: Tensor, cache: NemotronCache, lengths: Optional[Tensor]) -> Tensor:
        """SSM block ``j`` (of the SSM blocks) on a normed ``x [B, T, H]``, its
        state and window updated over each row's ``lengths`` tokens."""
        c = self.config
        I, C = c.ssm_width, c.conv_channels
        y = self._mm(x, L["w_in"])  # [B, T, I + C + nh]: z | xBC | dt
        xbc, dt = ssm_prepare(y, L["conv"], L["conv_b"], L["dt_bias"], cache.conv[j], lengths, I, I + C)
        o = ssm_recurrent(xbc, dt, L["a_log"], L["d"], cache.state[j], lengths, c.ssm_groups, c.dtype)
        return self._mm(ssm_gated_norm(o, y, L["norm"], c.ssm_groups, c.rms_eps), L["wo"])

    def _gqa(self, L: Dict, l: int, x: Tensor, mask: Tensor, cache: NemotronCache, cache_index: int,
             ctx: int) -> Tensor:
        """Attention block ``l`` (of the attention blocks) on a normed ``x [B,
        T, H]``, its keys and values written into slots ``cache_index ..``.
        T == 1 (decode): the cache write and the decode attention kernel,
        mask [B, S]; else (prefill): attention over the block and the ``ctx``
        cached slots before it, mask [B, 1, T, S]. No rotary embedding."""
        c = self.config
        B, T, _ = x.shape
        D, kv = c.head_dim, c.num_kv_heads
        nq, nkv = c.num_heads * D, kv * D
        qkv = self._mm(x, L["wqkv"])
        if T == 1:
            q = qkv_cache(qkv, cache.k, cache.v, l, cache_index)
            out = decode_gqa_attention_stacked(q, cache.k, cache.v, mask, l).reshape(B, 1, nq)
        else:
            k_t = qkv[..., nq : nq + nkv].reshape(B, T, kv, D).transpose(1, 2)  # [B, KV, T, D]
            v_t = qkv[..., nq + nkv :].reshape(B, T, kv, D).transpose(1, 2)
            cache.k[l, :, :, cache_index : cache_index + T] = k_t
            cache.v[l, :, :, cache_index : cache_index + T] = v_t
            kk, vv = (cache.k[l, :, :, : ctx + T], cache.v[l, :, :, : ctx + T]) if ctx else (k_t, v_t)
            qg = qkv[..., :nq].reshape(B, T, kv, c.num_heads // kv, D)
            out = _gqa_attention(qg, kk, vv, mask[:, 0, :, : ctx + T], c.dtype).reshape(B, T, nq)
        return self._mm(out, L["wo"])

    def _run_layers(self, layers, x, positions, mask, cache: NemotronCache, cache_index, ctx=0, step=None,
                    lengths=None):
        """Every block: ``h += Mix(RMSNorm(h))``, each block's output carried
        into the next norm's launch. mask [B, 1, T, S] (prefill) or [B, S]
        (decode step ``step``); an SSM block stops each row at its
        ``lengths``. ``positions`` are not read (no rotary embedding).
        Returns ``(h, y)`` (``CausalDecoder``)."""
        c = self.config
        h, y = x, None
        for i, L in enumerate(layers):
            if y is None:
                xn = rmsnorm(h, L["ln"], c.rms_eps)
            else:
                h, xn = add_rmsnorm(h, y, L["ln"], c.rms_eps)
            kind, j = c.pattern[i], self._index[i]
            if kind == "M":
                y = self._ssm(L, j, xn, cache, lengths)
            elif kind == "*":
                y = self._gqa(L, j, xn, mask, cache, cache_index, ctx)
            else:
                y = self._moe(L, xn, step)
        return h, y

    # -- the counters ------------------------------------------------------------------
    def decode(self, inp, *args, **kwargs):
        """:meth:`CausalDecoder.decode`, the row-tokens its prefill folds
        into each SSM state (the prefix once, each prompt's suffix up to
        its length) kept on the device for its readback."""
        self._ssm_updates = inp.P + (inp.lengths - inp.P).sum()
        return super().decode(inp, *args, **kwargs)

    def _decode_aux(self):
        return super()._decode_aux(), self._ssm_updates

    def _readback(self, rows: Tensor, aux) -> np.ndarray:
        moe, updates = aux
        out = super()._readback(rows, moe)
        tracing.count("ssm.token_updates", int(updates))
        return out


def published_config(cfg: Dict[str, Any], **over) -> NemotronHConfig:
    """A :class:`NemotronHConfig` from the published ``config.json`` keys
    (``intermediate_size``, ``rope_theta`` and ``partial_rotary_factor``
    are not read: no block is a dense MLP, and none rotates)."""
    pattern = cfg["hybrid_override_pattern"]
    if cfg["num_hidden_layers"] != len(pattern):
        raise ValueError(f"{cfg['num_hidden_layers']} layers but a pattern of {len(pattern)} blocks")
    if cfg["n_group"] != 1 or cfg["topk_group"] != 1 or cfg["mlp_hidden_act"] != "relu2":
        raise ValueError("the port routes over one group of experts with relu2 experts")
    return NemotronHConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        moe_intermediate_size=cfg["moe_intermediate_size"],
        shared_intermediate_size=cfg["moe_shared_expert_intermediate_size"], num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"], num_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        n_routed_experts=cfg["n_routed_experts"], n_shared_experts=cfg["n_shared_experts"],
        num_experts_per_tok=cfg["num_experts_per_tok"], routed_scaling_factor=cfg["routed_scaling_factor"],
        rms_eps=cfg["layer_norm_epsilon"], norm_topk_prob=cfg["norm_topk_prob"], pattern=pattern,
        mamba_heads=cfg["mamba_num_heads"], mamba_head_dim=cfg["mamba_head_dim"], ssm_state=cfg["ssm_state_size"], ssm_groups=cfg["n_groups"], conv_size=cfg["conv_kernel"], **over,
    )
