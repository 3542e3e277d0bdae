"""Seeded Kimi-Linear weights made on the device one part at a time
(``"embed"``, ``"layer_i"``, ``"ln_f"``, ``"lm_head"``), each from its own
generator seeded by ``(seed, part)``, as ``weights_dsv2`` makes DeepSeek-V2's:
one ``randn`` draw in bf16 over a flat buffer, cut into leaves. Matrices
std ``fan_in^-1/2`` (the routed experts stacked ``[E, in, out]``, gate and
up merged along the output, the three short convolutions' taps one ``[3 nh
d, K]`` matrix of std ``K^-1/2``), norm scales ``1 + 0.1 N(0, 1)``, the
router's correction bias ``0.1 N(0, 1)``, and, from the same normal draws
through the normal CDF, ``A_log = log U(1, 16)`` and ``dt_bias`` the
inverse softplus of a step log-uniform in [0.001, 0.1] (the published
initialisation). Names are the program's; keys the published
``config.json``'s."""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from perfbench import weights_dsv2
from perfbench.weights_dsv2 import Shapes


def parts(cfg: Dict) -> List[str]:
    return weights_dsv2.parts(cfg)


def is_kda(cfg: Dict, i: int) -> bool:
    """Whether layer ``i`` (0-indexed) is a KDA layer (published 1-indexed)."""
    return i + 1 in cfg["linear_attn_config"]["kda_layers"]


def part_shapes(cfg: Dict, part: str) -> Shapes:
    """``(name, shape, kind, std)`` of a part, from the published keys."""
    if not part.startswith("layer_"):
        return weights_dsv2.part_shapes(cfg, part)
    H = cfg["hidden_size"]
    i = int(part.split("_")[1])
    b = part
    out: Shapes = [(f"{b}.ln_attn.scale", (H,), "ln", 0.1)]
    if is_kda(cfg, i):
        la = cfg["linear_attn_config"]
        nh, d, K = la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]
        HD = nh * d
        out += [(f"{b}.kda.{n}.kernel", (H, HD), "w", H ** -0.5) for n in ("q", "k", "v")]
        out += [(f"{b}.kda.f_a.kernel", (H, d), "w", H ** -0.5), (f"{b}.kda.f_b.kernel", (d, HD), "w", d ** -0.5),
                (f"{b}.kda.g_a.kernel", (H, d), "w", H ** -0.5), (f"{b}.kda.g_b.kernel", (d, HD), "w", d ** -0.5),
                (f"{b}.kda.b.kernel", (H, nh), "w", H ** -0.5), (f"{b}.kda.conv.kernel", (3 * HD, K), "w", K ** -0.5),
                (f"{b}.kda.a_log", (nh,), "alog", 0.0), (f"{b}.kda.dt_bias", (HD,), "dt", 0.0),
                (f"{b}.kda.o_norm.scale", (d,), "ln", 0.1), (f"{b}.kda.o.kernel", (HD, H), "w", HD ** -0.5)]
    else:
        nh, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
        dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
        out += [(f"{b}.attn.q.kernel", (H, nh * (dn + dr)), "w", H ** -0.5),
                (f"{b}.attn.kv_a.kernel", (H, r + dr), "w", H ** -0.5),
                (f"{b}.attn.kv_norm.scale", (r,), "ln", 0.1),
                (f"{b}.attn.kv_b.kernel", (r, nh * (dn + dv)), "w", r ** -0.5),
                (f"{b}.attn.o.kernel", (nh * dv, H), "w", (nh * dv) ** -0.5)]
    out.append((f"{b}.ln_mlp.scale", (H,), "ln", 0.1))
    if i < cfg["first_k_dense_replace"]:
        I = cfg["intermediate_size"]
        return out + [(f"{b}.mlp.gate_up.kernel", (H, 2 * I), "w", H ** -0.5),
                      (f"{b}.mlp.down.kernel", (I, H), "w", I ** -0.5)]
    E, Ie = cfg["num_experts"], cfg["moe_intermediate_size"]
    Is = Ie * cfg["num_shared_experts"]
    return out + [(f"{b}.moe.router.kernel", (H, E), "w", H ** -0.5), (f"{b}.moe.router.bias", (E,), "w", 0.1),
                  (f"{b}.moe.experts.gate_up.kernel", (E, H, 2 * Ie), "w", H ** -0.5),
                  (f"{b}.moe.experts.down.kernel", (E, Ie, H), "w", Ie ** -0.5),
                  (f"{b}.moe.shared.gate_up.kernel", (H, 2 * Is), "w", H ** -0.5),
                  (f"{b}.moe.shared.down.kernel", (Is, H), "w", Is ** -0.5)]


def part(cfg: Dict, seed: int, name: str, device) -> Dict[str, torch.Tensor]:
    """One part's weights: matrices bf16, vectors f32."""
    shapes = part_shapes(cfg, name)
    k = parts(cfg).index(name)
    gen = torch.Generator(device=device).manual_seed((int(seed) * 1009 + 17 * k + 11) % (2**63))
    total = sum(math.prod(s) for _, s, _, _ in shapes)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.bfloat16)
    out, o = {}, 0
    for n, shape, kind, std in shapes:
        size = math.prod(shape)
        t = flat[o : o + size].view(shape)
        o += size
        if len(shape) >= 2:
            out[n] = t * std
            continue
        t = t.float()
        if kind in ("alog", "dt"):
            u = (0.5 * (1 + torch.erf(t / math.sqrt(2)))).clamp(1e-6, 1 - 1e-6)  # uniform from the normal
            if kind == "alog":
                out[n] = torch.log(1 + 15 * u)
            else:
                lo, hi = math.log(1e-3), math.log(0.1)
                dt = torch.exp(u * (hi - lo) + lo).clamp(min=1e-4)
                out[n] = dt + torch.log(-torch.expm1(-dt))
        else:
            out[n] = t * std + 1.0 if kind == "ln" else t * std
    return out
