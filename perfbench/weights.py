"""Seeded inputs made on the device: model weights, the reference-image
bank and image batches. The same seed and device give the same numbers, so
the program and the plain reference are handed equal inputs; the reference
makes them anew once the program's state is freed.

Weights are drawn in one ``randn`` call per model over a flat buffer and
cut into leaves, each scaled to its initializer's spread. Biases and norm
parameters are drawn too (not left at 0 and 1), so that a path that drops
one shows in the comparison."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Shapes = List[Tuple[str, Tuple[int, ...], str, float]]


def clip_shapes(c: Dict) -> Shapes:
    """``(name, shape, kind, std)`` of every CLIP parameter, named as the
    flax tree joins its paths. ``kind``: ``w`` (normal, std), ``ln``
    (1 + std * normal), ``const`` (std itself)."""
    W, Wt, E, P = c["vision_width"], c["text_width"], c["embed_dim"], c["patch_size"]
    n_patch = (c["image_size"] // P) ** 2
    out: Shapes = [("logit_scale", (), "const", math.log(1 / 0.07))]

    def blocks(prefix: str, width: int, layers: int) -> None:
        for i in range(layers):
            b = f"{prefix}.transformer.block_{i}"
            out.extend([
                (f"{b}.ln_1.scale", (width,), "ln", 0.1),
                (f"{b}.ln_1.bias", (width,), "w", 0.02),
                (f"{b}.attn.qkv.kernel", (width, 3 * width), "w", width ** -0.5),
                (f"{b}.attn.qkv.bias", (3 * width,), "w", 0.02),
                (f"{b}.attn.out.kernel", (width, width), "w", width ** -0.5),
                (f"{b}.attn.out.bias", (width,), "w", 0.02),
                (f"{b}.ln_2.scale", (width,), "ln", 0.1),
                (f"{b}.ln_2.bias", (width,), "w", 0.02),
                (f"{b}.mlp.fc.kernel", (width, 4 * width), "w", width ** -0.5),
                (f"{b}.mlp.fc.bias", (4 * width,), "w", 0.02),
                (f"{b}.mlp.proj.kernel", (4 * width, width), "w", (4 * width) ** -0.5),
                (f"{b}.mlp.proj.bias", (width,), "w", 0.02),
            ])

    out.extend([
        ("visual.class_embedding", (W,), "w", W ** -0.5),
        ("visual.positional_embedding", (n_patch + 1, W), "w", W ** -0.5),
        ("visual.proj", (W, E), "w", W ** -0.5),
        ("visual.patch_embed.kernel", (P, P, 3, W), "w", (P * P * 3) ** -0.5),
        ("visual.ln_pre.scale", (W,), "ln", 0.1),
        ("visual.ln_pre.bias", (W,), "w", 0.02),
    ])
    blocks("visual", W, c["vision_layers"])
    out.extend([
        ("visual.ln_post.scale", (W,), "ln", 0.1),
        ("visual.ln_post.bias", (W,), "w", 0.02),
        ("text.positional_embedding", (c["context_length"], Wt), "w", 0.01),
        ("text.text_projection", (Wt, E), "w", Wt ** -0.5),
        ("text.token_embedding.embedding", (c["vocab_size"], Wt), "w", Wt ** -0.5),
    ])
    blocks("text", Wt, c["text_layers"])
    out.extend([
        ("text.ln_final.scale", (Wt,), "ln", 0.1),
        ("text.ln_final.bias", (Wt,), "w", 0.02),
    ])
    return out


def qwen_shapes(q: Dict) -> Shapes:
    """``(name, shape, kind, std)`` of every Qwen2 parameter (tied head),
    named as the flax tree joins its paths; kernels ``[in, out]``."""
    H, I = q["hidden_size"], q["intermediate_size"]
    Dh = H // q["num_attention_heads"]
    KV = q["num_key_value_heads"] * Dh
    out: Shapes = [("embed.embedding", (q["vocab_size"], H), "w", H ** -0.5)]
    for i in range(q["num_hidden_layers"]):
        b = f"layer_{i}"
        out.extend([
            (f"{b}.ln_attn.scale", (H,), "ln", 0.1),
            (f"{b}.attn.q.kernel", (H, H), "w", H ** -0.5),
            (f"{b}.attn.q.bias", (H,), "w", 0.02),
            (f"{b}.attn.k.kernel", (H, KV), "w", H ** -0.5),
            (f"{b}.attn.k.bias", (KV,), "w", 0.02),
            (f"{b}.attn.v.kernel", (H, KV), "w", H ** -0.5),
            (f"{b}.attn.v.bias", (KV,), "w", 0.02),
            (f"{b}.attn.o.kernel", (H, H), "w", H ** -0.5),
            (f"{b}.ln_mlp.scale", (H,), "ln", 0.1),
            (f"{b}.mlp.gate.kernel", (H, I), "w", H ** -0.5),
            (f"{b}.mlp.up.kernel", (H, I), "w", H ** -0.5),
            (f"{b}.mlp.down.kernel", (I, H), "w", I ** -0.5),
        ])
    out.append(("ln_f.scale", (H,), "ln", 0.1))
    return out


def _draw(shapes: Shapes, seed: int, device, matrix_dtype) -> Dict[str, torch.Tensor]:
    """One flat normal draw, cut into the leaves: matrices (ndim >= 2) in
    ``matrix_dtype``, vectors and scalars in f32."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    total = sum(math.prod(s) for _, s, kind, _ in shapes if kind != "const")
    flat = torch.randn(total, generator=gen, device=device, dtype=matrix_dtype)
    out, o = {}, 0
    for name, shape, kind, std in shapes:
        if kind == "const":
            out[name] = torch.tensor(std, dtype=torch.float32, device=device)
            continue
        n = math.prod(shape)
        t = flat[o : o + n].view(shape)
        o += n
        dt = matrix_dtype if len(shape) >= 2 else torch.float32
        t = t.to(dt) * std
        out[name] = t + 1.0 if kind == "ln" else t
    return out


def clip_params(c: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """CLIP parameters, f32 (the program casts what it serves)."""
    return _draw(clip_shapes(c), seed, device, torch.float32)


def qwen_params(q: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Qwen2 parameters: matrices in bf16 (the configuration casts to bf16
    before the int8 weight quantization), vectors f32."""
    return _draw(qwen_shapes(q), seed + 1, device, torch.bfloat16)


def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    """Dotted names -> the nested tree the program's models take."""
    tree: Dict = {}
    for name, v in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def bank(rows: int, dim: int, seed: int, device) -> torch.Tensor:
    """The reference-image bank, f32 ``[rows, dim]``, not normalized."""
    gen = torch.Generator(device=device).manual_seed(int(seed) + 2)
    return torch.randn((rows, dim), generator=gen, device=device)


def images(n: int, size: int, seed: int, device) -> torch.Tensor:
    """``n`` raw images ``[n, size, size, 3]`` in [0, 1], f32."""
    gen = torch.Generator(device=device).manual_seed(int(seed) + 3)
    return torch.rand((n, size, size, 3), generator=gen, device=device)
