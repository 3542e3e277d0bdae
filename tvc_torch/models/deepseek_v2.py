"""DeepSeek-V2 decoder-only LM in PyTorch: a paraphrase model for the text
variants of full TVC, beside Qwen2 (``qwen.py``), through the same decode
loop and host side (``decoding.CausalDecoder``).

* ``DeepseekV2Config``: the published ``DeepSeek-V2-Lite`` shape
  (``deepseek_v2_lite()``) and a ``tiny()`` preset for the CPU tests.
* The layer equations of the published ``modeling_deepseek.py``: in each
  layer ``h += Attn(RMSNorm(h))``, then ``h += FFN(RMSNorm(h))``; after the
  last, the final RMSNorm and the untied head.

  - Attention (MLA, no q-LoRA): ``q = x W_q`` per head ``[q_nope | q_pe]``;
    ``a = x W_kva``, ``c = RMSNorm_kv(a[:r])``, ``k_pe = a[r:]`` (one rope
    key a token, shared by the heads); ``[k_nope | v] = c W_kvb`` per head.
    The rope rotates interleaved pairs of ``q_pe`` and ``k_pe`` (the
    published de-interleave, then rotate-half) at YaRN frequencies
    (:func:`yarn_inv_freq`); the logits are ``(q_nope . k_nope + q_pe .
    k_pe) * softmax_scale`` with YaRN's ``mscale^2`` in the scale, a
    causal f32 softmax, then ``o_proj``.
  - The first ``first_k_dense`` layers' FFN is a SiLU-gated MLP; the others
    are mixtures of experts: ``p = softmax(x W_router)`` in f32, the top
    ``num_experts_per_tok`` by value (not renormalised, times
    ``routed_scaling_factor``), ``y = sum_top p_e E_e(x) + S(x)`` with each
    expert and the merged shared experts SiLU-gated MLPs (or, where the
    configuration's ``expert_act`` is ``relu2``, non-gated ones:
    ``relu(x W_up)^2 W_down``).

* ``DeepseekV2Model``: seeded random weights, or a given tree, or a
  callable that hands over one part at a time (``"embed"``, ``"layer_i"``,
  ``"ln_f"``, ``"lm_head"``), each quantized to the w8 scheme as it
  arrives (int8 per output channel, weight-only: every matrix but the
  router, the embedding and the head too), so that the f32 or bf16
  transient is one layer's. The decode keeps one latent cache ``[L, B, S,
  r + rope]`` (the normed ``c`` and the roped ``k_pe`` of each position,
  1,152 bytes a token-layer in bf16). The prefill takes the decompressed
  form; each decode step the absorbed one: ``q_lat_h = W_UK,h^T q_nope_h``,
  the latent attention over the cache (``mla_decode_attention``, one
  launch a layer), ``out_h = W_UV,h sum_s p_h(s) c_s``, with ``W_kvb``'s
  per-output-channel scales folded into ``q_nope`` before the absorption
  and into the output after it (the dequantized weight's arithmetic in
  another order). The routed experts of a layer take two launches of the
  grouped weight-only GEMM (``moe_w8_grouped_gemm``: gate|up, then down);
  the routing (gate, softmax, top-k, counts, offsets, the sort, the
  combine) stays on the device, with no host read inside a step.
  Each RMSNorm, with the residual add before it, and each SiLU-gated
  product is one launch of the fused kernels (``decode_fused_kernel``):
  the layer loop carries each residual branch's output into the next norm.
  The glue around the GEMMs is DeepSeek's own kernels
  (``dsv2_fused_kernel``): in a decode step the rope of q_pe and k_pe, the
  latent norm, both cache writes and q_nope's W_UK scales are one launch
  (``mla_rope_cache``), W_UV's scales and the o GEMM's layout one
  (``mla_out``; the latent attention reads the first absorbed product's
  transposed output as it is); in every MoE layer, prefill too, the
  softmax, top-k, counts, offsets, stable sort and gather of the expert
  rows are two (``moe_route``) and the weighted combine with the shared
  experts' output one (``moe_combine``). A decode step of DeepSeek-V2-Lite
  at 960 rows launches 638 device kernels, ~24 a layer.

Spans ``dsv2.prepare``, ``dsv2.prefill``, ``dsv2.decode_step`` (``step``,
``rows``) and ``dsv2.readback``; counters ``moe.assignments`` (row-expert
assignments), ``moe.rows_max`` (the rows of the busiest expert, summed over
layer-steps) and ``moe.layer_steps``, for the decode steps, read back once
a decode call inside ``dsv2.readback`` with the tokens.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from tvc_torch._device import disable_tf32, resolve_device
from tvc_torch.core.kernels.decode_fused_kernel import add_rmsnorm, relu2, rmsnorm, silu_mul
from tvc_torch.core.kernels.dsv2_fused_kernel import (  # noqa: F401  (rope_interleaved: the names this module offers)
    mla_out,
    mla_rope_cache,
    moe_combine,
    moe_route,
    rope_interleaved,
)
from tvc_torch.core.kernels.mla_kernel import mla_decode_attention
from tvc_torch.core.kernels.moe_kernel import moe_w8_grouped_gemm
from tvc_torch.core.kernels.quantized_layer_kernel import quantize_linear
from tvc_torch.core.kernels.w8_matmul_kernel import w8_matmul, w8_matmul_reference
from tvc_torch.models.decoding import W8_MAX_ROWS  # noqa: F401  (the names this module has always offered)
from tvc_torch.models.decoding import CausalDecoder, _flatten, _is_q, _to, _unflatten, takes_kernel
from tvc_torch.utils import tracing


@dataclasses.dataclass(frozen=True)
class DeepseekV2Config:
    """DeepSeek-V2 architecture knobs (defaults: DeepSeek-V2-Lite as
    published; no q-LoRA)."""

    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944  # the dense layers' MLP
    moe_intermediate_size: int = 1408  # one expert's width
    num_layers: int = 27
    first_k_dense: int = 1
    num_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    routed_scaling_factor: float = 1.0
    rope_theta: float = 10000.0
    rope_factor: float = 40.0
    rope_original_max_positions: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707
    rms_eps: float = 1e-6
    #: the router's scoring: "softmax" (DeepSeek-V2) or "sigmoid" (with a
    #: correction bias in the choice of the experts, not in their weights)
    scoring_func: str = "softmax"
    #: the chosen experts' weights divided by their sum
    norm_topk_prob: bool = False
    #: False: the latent attention's rope dimensions are not rotated (NoPE)
    use_rope: bool = True
    #: the experts' activation: "silu" (SiLU-gated, gate|up then down) or
    #: "relu2" (non-gated, relu(up)^2 then down)
    expert_act: str = "silu"
    max_seq_len: int = 512
    dtype: Any = torch.bfloat16
    model_name: str = "deepseek-ai/DeepSeek-V2-Lite"

    @classmethod
    def deepseek_v2_lite(cls) -> "DeepseekV2Config":
        return cls()

    @classmethod
    def tiny(cls) -> "DeepseekV2Config":
        return cls(
            vocab_size=512, hidden_size=64, intermediate_size=96, moe_intermediate_size=32, num_layers=3,
            num_heads=4, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            n_routed_experts=16, max_seq_len=64, dtype=torch.float32, model_name="tiny",
        )

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_width(self) -> int:
        """Values a cache row holds: the latent, then the rope key."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def n_moe_layers(self) -> int:
        return self.num_layers - self.first_k_dense

    @property
    def softmax_scale(self) -> float:
        """``q_head_dim^-1/2 * mscale^2`` (YaRN's ``mscale_all_dim``)."""
        m = yarn_get_mscale(self.rope_factor, self.rope_mscale_all_dim)
        return self.q_head_dim ** -0.5 * m * m


# ---------------------------------------------------------------------------
# YaRN rotary embedding (the published DeepseekV2YarnRotaryEmbedding)
# ---------------------------------------------------------------------------


def yarn_get_mscale(scale: float = 1.0, mscale: float = 1.0) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def _correction_dim(rotations: float, dim: int, base: float, max_pos: int) -> float:
    return dim * math.log(max_pos / (rotations * 2 * math.pi)) / (2 * math.log(base))


def yarn_inv_freq(cfg: DeepseekV2Config) -> Tensor:
    """f32 ``[rope / 2]``: ``inter * ramp + extra * (1 - ramp)`` with
    ``extra_i = theta^(-2i / rope)``, ``inter = extra / factor`` and the
    linear ramp over the published ``find_correction_range``."""
    dim = cfg.qk_rope_head_dim
    extra = 1.0 / (cfg.rope_theta ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    inter = 1.0 / (cfg.rope_factor * cfg.rope_theta ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    low = max(math.floor(_correction_dim(cfg.rope_beta_fast, dim, cfg.rope_theta, cfg.rope_original_max_positions)), 0)
    high = min(math.ceil(_correction_dim(cfg.rope_beta_slow, dim, cfg.rope_theta, cfg.rope_original_max_positions)),
               dim - 1)
    if low == high:
        high += 0.001
    extra_mask = 1.0 - ((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
    return inter * (1 - extra_mask) + extra * extra_mask  # the published order of the operations


def yarn_tables(positions: Tensor, cfg: DeepseekV2Config, inv_freq: Tensor) -> Tuple[Tensor, Tensor]:
    """f32 cos / sin ``[B, T, 1, rope / 2]`` times ``mscale / mscale_all_dim``."""
    m = yarn_get_mscale(cfg.rope_factor, cfg.rope_mscale) / yarn_get_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim)
    angles = positions[..., None].float() * inv_freq.to(positions.device)
    return (torch.cos(angles) * m)[:, :, None, :], (torch.sin(angles) * m)[:, :, None, :]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

Shapes = List[Tuple[str, Tuple[int, ...], str, float]]


def part_names(cfg: DeepseekV2Config) -> List[str]:
    """The parts the weights come in, in order."""
    return ["embed"] + [f"layer_{i}" for i in range(cfg.num_layers)] + ["ln_f", "lm_head"]


def part_shapes(cfg: DeepseekV2Config, part: str) -> Shapes:
    """``(name, shape, kind, std)`` of a part's parameters (names dotted from
    the model's root; kernels ``[in, out]``, experts ``[E, in, out]``; gate
    and up merged along the output). ``kind``: ``w`` (std * normal) or
    ``ln`` (1 + std * normal)."""
    c = cfg
    H = c.hidden_size
    if part == "embed":
        return [("embed.embedding", (c.vocab_size, H), "w", H ** -0.5)]
    if part == "ln_f":
        return [("ln_f.scale", (H,), "ln", 0.1)]
    if part == "lm_head":
        return [("lm_head.kernel", (H, c.vocab_size), "w", H ** -0.5)]
    return mla_shapes(c, part) + ffn_shapes(c, part, int(part.split("_")[1]))


def mla_shapes(c: DeepseekV2Config, b: str) -> Shapes:
    """A latent-attention layer's norm and attention, under prefix ``b``."""
    H, r, nh = c.hidden_size, c.kv_lora_rank, c.num_heads
    return [
        (f"{b}.ln_attn.scale", (H,), "ln", 0.1),
        (f"{b}.attn.q.kernel", (H, nh * c.q_head_dim), "w", H ** -0.5),
        (f"{b}.attn.kv_a.kernel", (H, c.latent_width), "w", H ** -0.5),
        (f"{b}.attn.kv_norm.scale", (r,), "ln", 0.1),
        (f"{b}.attn.kv_b.kernel", (r, nh * (c.qk_nope_head_dim + c.v_head_dim)), "w", r ** -0.5),
        (f"{b}.attn.o.kernel", (nh * c.v_head_dim, H), "w", (nh * c.v_head_dim) ** -0.5),
    ]


def ffn_shapes(c: DeepseekV2Config, b: str, i: int) -> Shapes:
    """Layer ``i``'s FFN norm and FFN: the dense MLP in the first
    ``first_k_dense`` layers, the experts after them (the router's
    correction bias where the scoring is sigmoid)."""
    H = c.hidden_size
    out: Shapes = [(f"{b}.ln_mlp.scale", (H,), "ln", 0.1)]
    if i < c.first_k_dense:
        I = c.intermediate_size
        return out + [(f"{b}.mlp.gate_up.kernel", (H, 2 * I), "w", H ** -0.5),
                      (f"{b}.mlp.down.kernel", (I, H), "w", I ** -0.5)]
    E, Ie, Is = c.n_routed_experts, c.moe_intermediate_size, c.moe_intermediate_size * c.n_shared_experts
    out.append((f"{b}.moe.router.kernel", (H, E), "w", H ** -0.5))
    if c.scoring_func == "sigmoid":
        out.append((f"{b}.moe.router.bias", (E,), "w", 0.1))
    return out + [(f"{b}.moe.experts.gate_up.kernel", (E, H, 2 * Ie), "w", H ** -0.5),
                  (f"{b}.moe.experts.down.kernel", (E, Ie, H), "w", Ie ** -0.5),
                  (f"{b}.moe.shared.gate_up.kernel", (H, 2 * Is), "w", H ** -0.5),
                  (f"{b}.moe.shared.down.kernel", (Is, H), "w", Is ** -0.5)]


def draw_part(cfg: DeepseekV2Config, part: str, gen: torch.Generator, device,
              shapes: Callable[[Any, str], Shapes] = part_shapes) -> Dict[str, Tensor]:
    """One part's seeded random parameters, f32, flat names (kinds ``w``
    and ``ln`` as :func:`part_shapes` gives them)."""
    out = {}
    for name, shape, kind, std in shapes(cfg, part):
        t = torch.randn(shape, generator=gen, device=device) * std
        out[name] = t + 1.0 if kind == "ln" else t
    return out


def _quantize_leaf(name: str, x, f32_matrices: Tuple[str, ...] = ("router.kernel",)):
    """Every matrix but the router to w8 (int8 per output channel, per
    expert too); the router to f32 (its logits are f32 products of the
    weights as given); vectors to f32. ``f32_matrices``: the name endings
    of the matrices kept in f32."""
    if _is_q(x) or not torch.is_tensor(x):
        return x
    if x.ndim >= 2 and not name.endswith(f32_matrices):
        w_q, scale = quantize_linear(x)
        return {"int8": w_q, "scale": scale}
    return x.float()


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


class DeepseekV2Model(CausalDecoder):
    """DeepSeek-V2 under the w8 scheme with the decode, the paraphrase and
    translation entry points of :class:`CausalDecoder`. Runs on the card
    unless given ``device="cpu"``."""

    SPANS = ("dsv2.prepare", "dsv2.prefill", "dsv2.decode_step", "dsv2.readback")
    #: the weights' parts, their shapes and draws, and the matrices kept in
    #: f32: a model of other layers on the same paths overrides these
    part_names = staticmethod(part_names)
    part_shapes = staticmethod(part_shapes)
    draw_part = staticmethod(draw_part)
    F32_MATRICES: Tuple[str, ...] = ("router.kernel",)

    def __init__(
        self,
        config: Optional[DeepseekV2Config] = None,
        params: Union[None, Mapping, Callable[[str], Mapping]] = None,
        seed: int = 0,
        tokenizer: Optional[Callable] = None,
        max_new_tokens: int = 32,
        device: Optional[Union[str, torch.device]] = None,
    ):
        """params: None (seeded random f32 weights, one part at a time from
        one generator), a tree (nested or dotted names, f32 / bf16 or
        already w8 leaves), or a callable ``part -> tree`` of that part
        (:func:`part_names`). Every part is quantized to w8 as it arrives,
        on the device, so the transient is one part's: the model serves w8
        weights only."""
        self.config = c = config or DeepseekV2Config.tiny()
        self.device = resolve_device(device)
        disable_tf32(self.device)
        self.max_new_tokens = max_new_tokens
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
            source = lambda part: self.draw_part(c, part, gen, self.device, self.part_shapes)  # noqa: E731
        elif callable(params):
            source = params
        else:
            flat = _flatten(params)
            source = lambda part: {n: flat[n] for n, *_ in self.part_shapes(c, part)}  # noqa: E731
        tree: Dict[str, Any] = {}
        for part in self.part_names(c):
            got = _flatten(source(part))
            want = {n: s for n, s, *_ in self.part_shapes(c, part)}
            if set(got) != set(want):
                raise ValueError(f"part {part}: missing {sorted(set(want) - set(got))}, "
                                 f"unexpected {sorted(set(got) - set(want))}")
            for name, leaf in got.items():
                leaf = _quantize_leaf(name, _to(leaf, self.device), self.F32_MATRICES)
                shape = tuple(leaf["int8"].shape) if _is_q(leaf) else tuple(leaf.shape)
                if shape != want[name]:
                    raise ValueError(f"{name}: shape {shape}, expected {want[name]}")
                tree[name] = leaf
            del got
        self.params = _unflatten(tree)
        if tokenizer is None:
            from tvc_torch.models.tokenizer import get_tokenizer

            tokenizer = get_tokenizer(vocab_size=c.vocab_size, context_length=c.max_seq_len)
        self.tokenizer = tokenizer
        self._inv_freq = yarn_inv_freq(c).to(self.device)
        self._state = None
        self._counts = None

    # -- the decode state ------------------------------------------------------------
    def _decode_state(self) -> Tuple[Dict, List[Dict]]:
        """(non-layer weights, one dict a layer): q|kv_a merged into one w8
        GEMM; ``W_kvb`` kept for the prefill's decompression and split,
        per head, into the absorbed decode's ``W_UK^T`` [nh, nope, r] and
        ``W_UV`` [nh, r, v] (int8 values in the model dtype, exact) with
        their scales [nh, nope] / [nh, v] in f32. Built once."""
        if self._state is not None:
            return self._state
        c, p = self.config, self.params
        layers = []
        for i in range(c.num_layers):
            lp = p[f"layer_{i}"]
            layers.append({"ln_attn": lp["ln_attn"]["scale"], **self._mla_state(lp["attn"]), **self._ffn_state(lp, i)})
        non_layer = {k: v for k, v in p.items() if not k.startswith("layer_")}
        self._state = (non_layer, layers)
        return self._state

    def _mla_state(self, a: Dict) -> Dict:
        """A latent-attention layer's decode weights from its ``attn`` tree."""
        c, dt = self.config, self.config.dtype
        nh, dn, dv, r = c.num_heads, c.qk_nope_head_dim, c.v_head_dim, c.kv_lora_rank
        q, kva, kvb = a["q"]["kernel"], a["kv_a"]["kernel"], a["kv_b"]["kernel"]
        wb = kvb["int8"].view(r, nh, dn + dv)
        sb = kvb["scale"].view(nh, dn + dv)
        return {
            "kv_norm": a["kv_norm"]["scale"],
            "wqa": {"int8": torch.cat([q["int8"], kva["int8"]], dim=1).contiguous(),
                    "scale": torch.cat([q["scale"], kva["scale"]]).contiguous()},
            "wkb": kvb,
            "wuk": wb[:, :, :dn].permute(1, 2, 0).to(dt).contiguous(),  # [nh, nope, r]
            "suk": sb[:, :dn].contiguous(),
            "wuv": wb[:, :, dn:].permute(1, 0, 2).to(dt).contiguous(),  # [nh, r, v]
            "suv": sb[:, dn:].contiguous(),
            "wo": a["o"]["kernel"],
        }

    def _ffn_state(self, lp: Dict, i: int) -> Dict:
        """Layer ``i``'s FFN norm and FFN decode weights: the dense MLP's,
        or the router (its correction bias, where it has one) and experts."""
        out = {"ln_mlp": lp["ln_mlp"]["scale"]}
        if "mlp" in lp:
            return {**out, "wgu": lp["mlp"]["gate_up"]["kernel"], "wd": lp["mlp"]["down"]["kernel"]}
        return {**out, **self._moe_state(lp["moe"], i - self.config.first_k_dense)}

    def _moe_state(self, m: Dict, index: int) -> Dict:
        """An MoE block's decode weights from its ``moe`` tree, the ``index``-th
        of the model's MoE blocks: the router (and its correction bias, where
        it has one) and each expert's first matrix, gate|up (SiLU-gated) or
        up (non-gated: ``expert_act`` relu2), and down."""
        first = "up" if self.config.expert_act == "relu2" else "gate_up"
        return {"router": m["router"]["kernel"], "router_bias": m["router"].get("bias"),
                "egu": m["experts"][first]["kernel"], "ed": m["experts"]["down"]["kernel"],
                "sgu": m["shared"][first]["kernel"], "sd": m["shared"]["down"]["kernel"], "moe_index": index}

    # -- the decode math ----------------------------------------------------------------
    def _mm(self, x3: Tensor, leaf) -> Tensor:
        """x [..., K] @ a w8 leaf: the weight-only kernel where
        :func:`takes_kernel` says so, else dequantize-then-matmul (as
        Qwen2's "w8"). Each model module calls its own ``w8_matmul`` /
        ``w8_matmul_reference``, the names a profiler's ranges wrap per
        model."""
        dt = self.config.dtype
        lead, K = x3.shape[:-1], x3.shape[-1]
        n = math.prod(lead)
        if not takes_kernel(n):
            return w8_matmul_reference(x3.to(dt), leaf["int8"], leaf["scale"])
        y = w8_matmul(x3.reshape(n, K).to(dt).contiguous(), leaf["int8"], leaf["scale"])
        return y.reshape(*lead, -1)

    def _new_cache(self, B: int, S: int) -> Tensor:
        """The latent cache ``[L, B, S, r + rope]``, zeroed."""
        c = self.config
        return torch.zeros((c.num_layers, B, S, c.latent_width), dtype=c.dtype, device=self.device)

    @staticmethod
    def _put_prefix(cache: Tensor, pre: Tensor, P: int) -> None:
        cache[:, :, :P] = pre

    @staticmethod
    def _tile_cache(cache: Tensor, n: int) -> Tensor:
        return cache.repeat_interleave(n, dim=1)

    def _attention(self, L: Dict, l: int, x: Tensor, cos, sin, mask, cache: Tensor, cache_index: int, ctx: int,
                   absorbed: Optional[bool] = None):
        """MLA of ``x [B, T, H]`` (normed): its latents written into slots
        ``cache_index ..`` of layer ``l``; one position (``absorbed``, the
        default at T == 1, mask [B, S]) through the latent kernel, a block
        in the decompressed form over it and the ``ctx`` slots before it
        (mask [B, 1, T, S])."""
        c, dt = self.config, self.config.dtype
        B, T, _ = x.shape
        nh, dn, dr, dv, r = c.num_heads, c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim, c.kv_lora_rank
        nq = nh * c.q_head_dim
        qa = self._mm(x, L["wqa"])
        if absorbed if absorbed is not None else T == 1:  # the absorbed form over the latent cache
            qn, q_pe = mla_rope_cache(qa, cos, sin, L["suk"], L["kv_norm"], c.rms_eps, cache, l, cache_index)
            q_lat = torch.bmm(qn, L["wuk"]).transpose(0, 1)  # [B, nh, r], read strided
            o_lat = mla_decode_attention(q_lat, q_pe, cache, mask, l, c.softmax_scale)
            out = mla_out(torch.bmm(o_lat.transpose(0, 1), L["wuv"]), L["suv"])  # [B, 1, nh v]
        else:  # the decompressed form over the block and the ctx cached slots
            q = qa[..., :nq].reshape(B, T, nh, c.q_head_dim)
            q_nope = q[..., :dn]
            q_pe = rope_interleaved(q[..., dn:], cos, sin)
            cache[l, :, cache_index : cache_index + T, :r] = rmsnorm(qa[..., nq : nq + r], L["kv_norm"], c.rms_eps)
            k_pe = rope_interleaved(qa[..., None, nq + r :], cos, sin)[:, :, 0]
            cache[l, :, cache_index : cache_index + T, r:] = k_pe
            lat = cache[l, :, : ctx + T]
            kv = self._mm(lat[..., :r], L["wkb"]).reshape(B, ctx + T, nh, dn + dv)
            lg = (torch.einsum("bthd,bshd->bhts", q_nope.float(), kv[..., :dn].float())
                  + torch.einsum("bthd,bsd->bhts", q_pe.float(), lat[..., r:].float())) * c.softmax_scale
            w = torch.softmax(lg + mask[:, :, :, : ctx + T], dim=-1).to(dt)
            out = torch.einsum("bhts,bshd->bthd", w.float(), kv[..., dn:].float()).to(dt).reshape(B, T, nh * dv)
        return self._mm(out, L["wo"])

    def _moe(self, L: Dict, x: Tensor, step: Optional[int] = None) -> Tensor:
        """The routed experts (two grouped GEMM launches) and the shared
        ones; everything on the device. In decode step ``step`` the
        routing counts add into that step's row of the call's counters."""
        c = self.config
        B, T, H = x.shape
        N = B * T
        xf = x.reshape(N, H)
        counts = None if step is None else self._counts[step, L["moe_index"]]
        topv, _, pos, xs, offsets = moe_route(xf.float() @ L["router"], xf, c.num_experts_per_tok, counts,
                                              c.scoring_func, L["router_bias"], c.norm_topk_prob)
        gu = moe_w8_grouped_gemm(xs, L["egu"]["int8"], L["egu"]["scale"], offsets)
        yd = moe_w8_grouped_gemm(self._expert_act(gu), L["ed"]["int8"], L["ed"]["scale"], offsets)
        shared = self._mm(self._expert_act(self._mm(xf, L["sgu"])), L["sd"])
        return moe_combine(yd, pos, topv, shared, c.routed_scaling_factor).reshape(B, T, H)

    def _expert_act(self, gu: Tensor) -> Tensor:
        """An expert's activation of its first GEMM's output: the SiLU-gated
        product of gate|up, or the squared ReLU of up (``expert_act``)."""
        if self.config.expert_act == "relu2":
            return relu2(gu)
        return silu_mul(gu, gu.shape[-1] // 2)

    def _layer(self, L: Dict, l: int, h: Tensor, y: Optional[Tensor], cos, sin, mask, cache, cache_index, ctx,
               step, lengths=None) -> Tuple[Tensor, Tensor]:
        """One layer on the residual stream ``h`` and the previous layer's
        FFN output ``y`` not yet added to it (None before the first);
        returns ``(h, y)`` of this layer, its FFN output not added. The
        rows' ``lengths`` are the mask's to apply."""
        eps = self.config.rms_eps
        if y is None:
            x = rmsnorm(h, L["ln_attn"], eps)
        else:
            h, x = add_rmsnorm(h, y, L["ln_attn"], eps)
        h, x = add_rmsnorm(h, self._attention(L, l, x, cos, sin, mask, cache, cache_index, ctx), L["ln_mlp"], eps)
        return h, self._ffn(L, x, step)

    def _ffn(self, L: Dict, x: Tensor, step: Optional[int]) -> Tensor:
        """The FFN of a normed ``x``: the dense MLP or the experts."""
        if "wgu" in L:
            gu = self._mm(x, L["wgu"])
            return self._mm(silu_mul(gu, gu.shape[-1] // 2), L["wd"])
        return self._moe(L, x, step)

    def _rope_tables(self, positions: Tensor) -> Tuple[Tensor, Tensor]:
        """cos / sin ``[B, T, 1, rope / 2]`` at ``positions``: YaRN's, or
        where the configuration has no rope (NoPE) cos 1 and sin 0, which
        leave the rope dimensions as they are (``x * 1 - y * 0 == x``)."""
        c = self.config
        if c.use_rope:
            return yarn_tables(positions, c, self._inv_freq)
        ones = torch.ones((*positions.shape, 1, c.qk_rope_head_dim // 2), device=positions.device)
        return ones, torch.zeros_like(ones)

    def _run_layers(self, layers, x, positions, mask, cache, cache_index, ctx=0, step=None, lengths=None):
        """Every layer: mask [B, 1, T, S] (prefill) or [B, S] (decode step
        ``step``), each prefill row's real ``lengths`` (``_layer``'s).
        Returns ``(h, y)`` (``CausalDecoder``)."""
        cos, sin = self._rope_tables(positions)
        y = None
        for l, L in enumerate(layers):
            x, y = self._layer(L, l, x, y, cos, sin, mask, cache, cache_index, ctx, step, lengths)
        return x, y

    # -- the routing counters ------------------------------------------------------------
    def _begin_decode(self, steps: int) -> None:
        c = self.config
        self._counts = torch.zeros((max(steps, 1), c.n_moe_layers, c.n_routed_experts), dtype=torch.int32,
                                   device=self.device)

    def _decode_aux(self):
        return self._counts, self.last_decode_steps

    def _readback(self, rows: Tensor, aux) -> np.ndarray:
        out = rows.cpu().numpy()
        counts, steps = aux
        if counts is not None and steps:
            got = counts[:steps].cpu().long()  # [steps, moe layers, E]
            tracing.count("moe.assignments", int(got.sum()))
            tracing.count("moe.rows_max", int(got.amax(dim=-1).sum()))
            tracing.count("moe.layer_steps", int(got.shape[0] * got.shape[1]))
        return out
