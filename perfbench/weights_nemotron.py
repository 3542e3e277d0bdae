"""Seeded Nemotron-H weights made on the device one part at a time
(``"embed"``, ``"layer_i"``, ``"ln_f"``, ``"lm_head"``), each from its own
generator seeded by ``(seed, part)``, as ``weights_dsv2`` makes DeepSeek-V2's:
one ``randn`` draw in bf16 over a flat buffer, cut into leaves. Matrices
std ``fan_in^-1/2`` (the routed experts stacked ``[E, in, out]``, the
convolution's taps ``[C, K]`` of std ``K^-1/2``, the attention's q, k and v
apart), norm scales ``1 + 0.1 N(0, 1)``, the router's correction bias and
the convolution's bias ``0.1 N(0, 1)``, D 1, and, from the same normal
draws through the normal CDF, ``A_log = log U(1, 16)`` and ``dt_bias`` the
inverse softplus of a step log-uniform in [time_step_min, time_step_max]
floored at time_step_floor (the published initialisation). Each block
holds its letter's mixer (``hybrid_override_pattern``: M Mamba-2, E
experts, * attention) behind one norm. Names are the program's; keys the
published ``config.json``'s."""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from perfbench import weights_dsv2
from perfbench.weights_dsv2 import Shapes


def parts(cfg: Dict) -> List[str]:
    return weights_dsv2.parts(cfg)


def part_shapes(cfg: Dict, part: str) -> Shapes:
    """``(name, shape, kind, std)`` of a part, from the published keys."""
    if not part.startswith("layer_"):
        return weights_dsv2.part_shapes(cfg, part)
    H = cfg["hidden_size"]
    b = part
    kind = cfg["hybrid_override_pattern"][int(part.split("_")[1])]
    out: Shapes = [(f"{b}.ln.scale", (H,), "ln", 0.1)]
    if kind == "M":
        nh, G, N, K = cfg["mamba_num_heads"], cfg["n_groups"], cfg["ssm_state_size"], cfg["conv_kernel"]
        I = nh * cfg["mamba_head_dim"]
        C = I + 2 * G * N
        return out + [(f"{b}.ssm.in.kernel", (H, I + C + nh), "w", H ** -0.5),
                      (f"{b}.ssm.conv.kernel", (C, K), "w", K ** -0.5), (f"{b}.ssm.conv.bias", (C,), "w", 0.1),
                      (f"{b}.ssm.a_log", (nh,), "alog", 0.0), (f"{b}.ssm.dt_bias", (nh,), "dt", 0.0),
                      (f"{b}.ssm.d", (nh,), "ln", 0.0), (f"{b}.ssm.norm.scale", (I,), "ln", 0.1),
                      (f"{b}.ssm.out.kernel", (I, H), "w", I ** -0.5)]
    if kind == "*":
        nq, nkv = cfg["num_attention_heads"] * cfg["head_dim"], cfg["num_key_value_heads"] * cfg["head_dim"]
        return out + [(f"{b}.attn.q.kernel", (H, nq), "w", H ** -0.5), (f"{b}.attn.k.kernel", (H, nkv), "w", H ** -0.5),
                      (f"{b}.attn.v.kernel", (H, nkv), "w", H ** -0.5),
                      (f"{b}.attn.o.kernel", (nq, H), "w", nq ** -0.5)]
    E, Ie, Is = cfg["n_routed_experts"], cfg["moe_intermediate_size"], cfg["moe_shared_expert_intermediate_size"]
    return out + [(f"{b}.moe.router.kernel", (H, E), "w", H ** -0.5), (f"{b}.moe.router.bias", (E,), "w", 0.1),
                  (f"{b}.moe.experts.up.kernel", (E, H, Ie), "w", H ** -0.5),
                  (f"{b}.moe.experts.down.kernel", (E, Ie, H), "w", Ie ** -0.5),
                  (f"{b}.moe.shared.up.kernel", (H, Is), "w", H ** -0.5),
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
                lo, hi = math.log(cfg["time_step_min"]), math.log(cfg["time_step_max"])
                dt = torch.exp(u * (hi - lo) + lo).clamp(min=cfg["time_step_floor"])
                out[n] = dt + torch.log(-torch.expm1(-dt))
        else:
            out[n] = t * std + 1.0 if kind == "ln" else t * std
    return out
