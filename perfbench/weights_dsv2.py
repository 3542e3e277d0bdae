"""Seeded DeepSeek-V2 weights made on the device one part at a time
(``"embed"``, ``"layer_i"``, ``"ln_f"``, ``"lm_head"``), each from its own
generator seeded by ``(seed, part)``: the program takes the parts one
after another and quantizes each as it comes, and the reference makes each
layer anew when it reaches it, so neither holds more than one layer's
bf16 or f32 transient.

Each part is one ``randn`` draw in bf16 over a flat buffer, cut into
leaves and scaled to the leaf's spread (matrices std ``fan_in^-1/2``),
norm scales ``1 + 0.1 N(0, 1)`` in f32 (drawn, not left at 1, so that a
path that drops one shows). Names are the program's: kernels ``[in, out]``,
each gate and up projection merged along the output (gate first), the
routed experts stacked ``[E, in, out]``, the router ``moe.router``."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Shapes = List[Tuple[str, Tuple[int, ...], str, float]]


def parts(cfg: Dict) -> List[str]:
    return ["embed"] + [f"layer_{i}" for i in range(cfg["num_hidden_layers"])] + ["ln_f", "lm_head"]


def part_shapes(cfg: Dict, part: str) -> Shapes:
    """``(name, shape, kind, std)`` of a part, from the published keys."""
    H, V = cfg["hidden_size"], cfg["vocab_size"]
    if part == "embed":
        return [("embed.embedding", (V, H), "w", H ** -0.5)]
    if part == "ln_f":
        return [("ln_f.scale", (H,), "ln", 0.1)]
    if part == "lm_head":
        return [("lm_head.kernel", (H, V), "w", H ** -0.5)]
    i = int(part.split("_")[1])
    nh, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    out: Shapes = [
        (f"{part}.ln_attn.scale", (H,), "ln", 0.1),
        (f"{part}.attn.q.kernel", (H, nh * (dn + dr)), "w", H ** -0.5),
        (f"{part}.attn.kv_a.kernel", (H, r + dr), "w", H ** -0.5),
        (f"{part}.attn.kv_norm.scale", (r,), "ln", 0.1),
        (f"{part}.attn.kv_b.kernel", (r, nh * (dn + dv)), "w", r ** -0.5),
        (f"{part}.attn.o.kernel", (nh * dv, H), "w", (nh * dv) ** -0.5),
        (f"{part}.ln_mlp.scale", (H,), "ln", 0.1),
    ]
    if i < cfg["first_k_dense_replace"]:
        I = cfg["intermediate_size"]
        return out + [(f"{part}.mlp.gate_up.kernel", (H, 2 * I), "w", H ** -0.5),
                      (f"{part}.mlp.down.kernel", (I, H), "w", I ** -0.5)]
    E, Ie = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    Is = Ie * cfg["n_shared_experts"]
    return out + [(f"{part}.moe.router.kernel", (H, E), "w", H ** -0.5),
                  (f"{part}.moe.experts.gate_up.kernel", (E, H, 2 * Ie), "w", H ** -0.5),
                  (f"{part}.moe.experts.down.kernel", (E, Ie, H), "w", Ie ** -0.5),
                  (f"{part}.moe.shared.gate_up.kernel", (H, 2 * Is), "w", H ** -0.5),
                  (f"{part}.moe.shared.down.kernel", (Is, H), "w", Is ** -0.5)]


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
        else:
            t = t.float() * std
            out[n] = t + 1.0 if kind == "ln" else t
    return out
