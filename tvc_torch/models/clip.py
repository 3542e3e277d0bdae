"""CLIP dual encoder in PyTorch (port of ``tvc/models/clip.py``).

* ``CLIPModule`` and its towers are ``nn.Module``s named like the flax
  tree, with the flax layouts: Dense kernels ``[in, out]``, the patch-embed
  kernel HWIO ``[P, P, 3, W]``. ``named_parameters()`` therefore yields the
  flax paths joined by dots, and :func:`params_from_jax` only moves arrays.
  The module path is the differentiable one.
* ``vision_features_fused`` / ``text_features_fused`` are the serving
  towers: every attention and MLP sub-block goes through the hand-written
  layer kernels (``tvc_torch.core.kernels``). Their ``_i8`` twins take the
  int8 weights of :func:`quantize_clip_params` and run the W8A8 layer
  kernels (``config.int8_serving``).
* ``CLIPModel`` holds the parameters, the tokenizer and the inference
  entry points; it runs on the card unless given ``device="cpu"``.

Models start from deterministic random weights (numpy ``default_rng(seed)``
at the flax initializers' scales): the repository ships no pretrained
CLIP checkpoint.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch
from torch import Tensor, nn

from tvc_torch._device import disable_tf32, resolve_device
from tvc_torch.core.kernels.attention_kernel import fused_mha
from tvc_torch.core.kernels.attention_layer_kernel import (
    fused_attention_layer,
    fused_mlp_layer,
    layernorm_f32,
)
from tvc_torch.core.kernels.quantized_layer_kernel import (
    fused_attention_layer_i8,
    fused_mlp_layer_i8,
    quantize_linear,
)
from tvc_torch.core.similarity import cosine_similarity, l2_normalize

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """Architecture + runtime config; defaults are ViT-B/32."""

    # vision tower
    image_size: int = 224
    patch_size: int = 32
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    # text tower
    vocab_size: int = 49408
    context_length: int = 77
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    # joint
    embed_dim: int = 512
    # runtime
    dtype: Any = torch.bfloat16  # activation / GEMM dtype
    model_name: str = "ViT-B/32"
    #: serve through the hand-written attention / MLP layer kernels
    fused_attention: bool = False
    #: int8 W8A8 serving towers (the W8A8 layer kernels); takes effect
    #: only with ``fused_attention``
    int8_serving: bool = False

    @classmethod
    def tiny(cls) -> "CLIPConfig":
        return cls(
            image_size=32, patch_size=16, vision_width=64, vision_layers=2,
            vision_heads=2, vocab_size=512, context_length=16, text_width=64,
            text_layers=2, text_heads=2, embed_dim=32, dtype=torch.float32,
            model_name="tiny",
        )

    @classmethod
    def vit_b32(cls, **kw) -> "CLIPConfig":
        return cls(model_name="ViT-B/32", **kw)

    @classmethod
    def vit_b16(cls, **kw) -> "CLIPConfig":
        return cls(patch_size=16, model_name="ViT-B/16", **kw)

    @classmethod
    def vit_l14(cls, **kw) -> "CLIPConfig":
        return cls(
            patch_size=14, vision_width=1024, vision_layers=24, vision_heads=16,
            text_width=768, text_layers=12, text_heads=12, embed_dim=768,
            model_name="ViT-L/14", **kw,
        )

    @classmethod
    def tiny_coco(cls) -> "CLIPConfig":
        """Tiny config with the full CLIP BPE vocab and a 32-token context."""
        return cls(
            image_size=32, patch_size=8, vision_width=64, vision_layers=2,
            vision_heads=2, vocab_size=49408, context_length=32, text_width=64,
            text_layers=2, text_heads=2, embed_dim=32, dtype=torch.float32,
            model_name="tiny_coco",
        )

    @classmethod
    def from_name(cls, name: str, **kw) -> "CLIPConfig":
        canon = {
            "vit-b/32": cls.vit_b32,
            "openai/clip-vit-base-patch32": cls.vit_b32,
            "vit-b/16": cls.vit_b16,
            "openai/clip-vit-base-patch16": cls.vit_b16,
            "vit-l/14": cls.vit_l14,
            "openai/clip-vit-large-patch14": cls.vit_l14,
            "tiny": lambda **k: dataclasses.replace(cls.tiny(), **k),
            "tiny_coco": lambda **k: dataclasses.replace(cls.tiny_coco(), **k),
        }
        key = name.strip().lower()
        if key not in canon:
            raise ValueError(
                f"unsupported CLIP model {name!r}; supported: "
                "ViT-B/32, ViT-B/16, ViT-L/14 (and HF spellings), tiny"
            )
        return canon[key](**kw)


def quick_gelu(x: Tensor) -> Tensor:
    return x * torch.sigmoid(1.702 * x)


# ---------------------------------------------------------------------------
# module towers (differentiable path), named and laid out like the flax tree
# ---------------------------------------------------------------------------


def _param(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape, dtype=torch.float32, device=device))


class Dense(nn.Module):
    """``x @ kernel + bias`` with ``kernel [in, out]``, computed in ``dtype``."""

    def __init__(self, din: int, dout: int, dtype, device=None):
        super().__init__()
        self.kernel = _param(din, dout, device=device)
        self.bias = _param(dout, device=device)
        self.dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        return x.to(self.dtype) @ self.kernel.to(self.dtype) + self.bias.to(self.dtype)


class LayerNorm(nn.Module):
    """LayerNorm in f32 (eps 1e-5); returns f32."""

    def __init__(self, width: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(width, device=device))
        self.bias = _param(width, device=device)

    def forward(self, x: Tensor) -> Tensor:
        return layernorm_f32(x, self.scale, self.bias)


class MLP(nn.Module):
    def __init__(self, width: int, dtype, device=None):
        super().__init__()
        self.fc = Dense(width, 4 * width, dtype, device)
        self.proj = Dense(4 * width, width, dtype, device)

    def forward(self, x: Tensor) -> Tensor:
        return self.proj(quick_gelu(self.fc(x)))


class Attention(nn.Module):
    """``fused``: unmasked calls go through the multi-head attention kernel
    (:func:`fused_mha`, inference only)."""

    def __init__(self, width: int, heads: int, dtype, device=None, fused: bool = False):
        super().__init__()
        self.width, self.heads, self.dtype, self.fused = width, heads, dtype, fused
        self.qkv = Dense(width, 3 * width, dtype, device)
        self.out = Dense(width, width, dtype, device)

    def forward(self, x: Tensor, mask: Optional[Tensor] = None) -> Tensor:
        B, T, _ = x.shape
        D = self.width // self.heads
        qkv = self.qkv(x).split(self.width, dim=-1)
        if self.fused and mask is None:
            # views of the packed projection: the kernel reads them in place
            q4, k4, v4 = (t.reshape(B, T, self.heads, D) for t in qkv)
            return self.out(fused_mha(q4, k4, v4).reshape(B, T, self.width))
        q, k, v = (t.reshape(B, T, self.heads, D).transpose(1, 2) for t in qkv)
        # f32 logits of the dtype operands, f32 softmax
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(D))
        if mask is not None:
            logits = logits + mask
        w = torch.softmax(logits, dim=-1).to(self.dtype)
        out = torch.matmul(w, v).transpose(1, 2).reshape(B, T, self.width)
        return self.out(out)


class ResidualBlock(nn.Module):
    def __init__(self, width: int, heads: int, dtype, device=None, fused: bool = False):
        super().__init__()
        self.ln_1 = LayerNorm(width, device)
        self.attn = Attention(width, heads, dtype, device, fused)
        self.ln_2 = LayerNorm(width, device)
        self.mlp = MLP(width, dtype, device)

    def forward(self, x: Tensor, mask: Optional[Tensor] = None) -> Tensor:
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, dtype, device=None, fused: bool = False):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"block_{i}", ResidualBlock(width, heads, dtype, device, fused))

    def forward(self, x: Tensor, mask: Optional[Tensor] = None) -> Tensor:
        for i in range(self.layers):
            x = getattr(self, f"block_{i}")(x, mask)
        return x


class PatchEmbed(nn.Module):
    """Stride-P convolution without bias, kernel HWIO ``[P, P, 3, W]``,
    computed as one patch-matrix product."""

    def __init__(self, patch: int, width: int, dtype, device=None):
        super().__init__()
        self.patch, self.dtype = patch, dtype
        self.kernel = _param(patch, patch, 3, width, device=device)

    def forward(self, images: Tensor) -> Tensor:
        return patch_embed(images, self.kernel, self.patch, self.dtype)


def patch_embed(images: Tensor, kernel: Tensor, patch: int, dtype) -> Tensor:
    """``[B, H, W, 3]`` -> ``[B, (H/P)(W/P), width]``: the VALID stride-P
    convolution as patches ``[.., P*P*3]`` (h, w, c order, as HWIO
    flattens) times ``kernel.reshape(P*P*3, width)``."""
    B, H, Wd, C = images.shape
    gh, gw = H // patch, Wd // patch
    x = images.to(dtype)[:, : gh * patch, : gw * patch]
    x = x.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, gh * gw, patch * patch * C)
    return x @ kernel.to(dtype).reshape(patch * patch * C, -1)


class VisionTower(nn.Module):
    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__()
        self.cfg = cfg
        W = cfg.vision_width
        n_patches = (cfg.image_size // cfg.patch_size) ** 2
        self.patch_embed = PatchEmbed(cfg.patch_size, W, cfg.dtype, device)
        self.class_embedding = _param(W, device=device)
        self.positional_embedding = _param(n_patches + 1, W, device=device)
        self.ln_pre = LayerNorm(W, device)
        self.transformer = Transformer(
            W, cfg.vision_layers, cfg.vision_heads, cfg.dtype, device, fused=cfg.fused_attention
        )
        self.ln_post = LayerNorm(W, device)
        self.proj = _param(W, cfg.embed_dim, device=device)

    def forward(self, images: Tensor) -> Tensor:
        """CLIP-normalized images ``[B, H, W, 3]`` (NHWC) -> ``[B, embed_dim]`` f32."""
        c = self.cfg
        x = self.patch_embed(images)
        B = x.shape[0]
        cls = self.class_embedding.to(c.dtype).expand(B, 1, c.vision_width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(c.dtype)
        x = self.ln_pre(x).to(c.dtype)
        x = self.transformer(x)
        return self.ln_post(x[:, 0, :]) @ self.proj.float()


def causal_mask(T: int, device) -> Tensor:
    keep = torch.ones((T, T), dtype=torch.bool, device=device).tril()
    return torch.zeros((T, T), device=device).masked_fill(~keep, float("-inf"))


class TextTower(nn.Module):
    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__()
        self.cfg = cfg
        W = cfg.text_width
        self.token_embedding = nn.Module()
        self.token_embedding.embedding = _param(cfg.vocab_size, W, device=device)
        self.positional_embedding = _param(cfg.context_length, W, device=device)
        self.transformer = Transformer(W, cfg.text_layers, cfg.text_heads, cfg.dtype, device)
        self.ln_final = LayerNorm(W, device)
        self.text_projection = _param(W, cfg.embed_dim, device=device)

    def forward(self, tokens: Tensor) -> Tensor:
        """tokens ``[B, T]`` -> ``[B, embed_dim]`` f32, pooled at EOT (argmax id)."""
        c = self.cfg
        T = tokens.shape[1]
        x = self.token_embedding.embedding.to(c.dtype)[tokens]
        x = x + self.positional_embedding[:T].to(c.dtype)
        x = self.transformer(x, causal_mask(T, tokens.device))
        x = self.ln_final(x)
        x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
        return x @ self.text_projection.float()


class CLIPModule(nn.Module):
    """Both towers + logit scale. With ``cfg.fused_attention`` the vision
    tower's attention runs :func:`fused_mha` (the text tower passes a causal
    mask and keeps the einsum path)."""

    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__()
        self.visual = VisionTower(cfg, device)
        self.text = TextTower(cfg, device)
        self.logit_scale = nn.Parameter(
            torch.tensor(math.log(1 / 0.07), dtype=torch.float32, device=device)
        )

    def encode_image(self, images: Tensor) -> Tensor:
        return self.visual(images)

    def encode_text(self, tokens: Tensor) -> Tensor:
        return self.text(tokens)

    def forward(self, images: Tensor, tokens: Tensor):
        img = l2_normalize(self.encode_image(images))
        txt = l2_normalize(self.encode_text(tokens))
        return img, txt, torch.exp(self.logit_scale) * img @ txt.T


# ---------------------------------------------------------------------------
# parameters: flax tree <-> port
# ---------------------------------------------------------------------------


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
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


def _tie_parameters(module: nn.Module, source: nn.Module) -> None:
    """Make each parameter of ``module`` the tensor of the same name in
    ``source`` (the two share storage from then on)."""
    params = dict(source.named_parameters())
    for name, _ in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        setattr(module.get_submodule(owner), leaf, params[name])


def params_from_jax(tree, cfg: CLIPConfig) -> Dict:
    """The flax parameter tree (leaves as numpy arrays) as the port's
    parameter tree (f32 CPU tensors). The port keeps the flax layouts
    (Dense ``[in, out]``, patch embed HWIO), so this checks every name and
    shape against the port's module and converts the leaves."""
    flat = _flatten(tree)
    want = {n: tuple(p.shape) for n, p in CLIPModule(cfg, device="meta").named_parameters()}
    missing, extra = set(want) - set(flat), set(flat) - set(want)
    if missing or extra:
        raise ValueError(f"parameter tree mismatch: missing {sorted(missing)}, unexpected {sorted(extra)}")
    out = {}
    for name, shape in want.items():
        arr = np.asarray(flat[name], dtype=np.float32)
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape}, expected {shape}")
        out[name] = torch.from_numpy(arr.copy())
    return _unflatten(out)


def init_params(cfg: CLIPConfig, seed: int = 0) -> Dict:
    """Seeded random parameters at the flax initializers' scales: Dense and
    conv kernels lecun-normal (std sqrt(1/fan_in)), biases 0, LayerNorm
    scale 1, token embedding std 1/sqrt(width), vision embeddings and
    projections std width^-0.5, text positional std 0.01, logit scale
    log(1/0.07)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in CLIPModule(cfg, device="meta").named_parameters():
        shape = tuple(p.shape)
        leaf = name.rsplit(".", 1)[-1]
        if name == "logit_scale":
            arr = np.asarray(math.log(1 / 0.07), np.float32)
        elif leaf == "bias":
            arr = np.zeros(shape, np.float32)
        elif leaf == "scale":
            arr = np.ones(shape, np.float32)
        else:
            if leaf == "kernel":
                std = math.sqrt(1.0 / int(np.prod(shape[:-1])))
            elif name == "text.positional_embedding":
                std = 0.01
            elif name.startswith("text."):  # token embedding, text projection
                std = cfg.text_width ** -0.5
            else:  # class/positional embedding, vision projection
                std = cfg.vision_width ** -0.5
            arr = rng.standard_normal(shape, dtype=np.float32) * np.float32(std)
        out[name] = torch.from_numpy(arr)
    return _unflatten(out)


# ---------------------------------------------------------------------------
# serving towers through the layer kernels
# ---------------------------------------------------------------------------


def _blocks(tower: Dict, layers: int):
    for i in range(layers):
        yield tower["transformer"][f"block_{i}"]


def _attn_args(blk: Dict, dtype):
    return (
        blk["ln_1"]["scale"].float(), blk["ln_1"]["bias"].float(),
        blk["attn"]["qkv"]["kernel"].to(dtype), blk["attn"]["qkv"]["bias"].float(),
        blk["attn"]["out"]["kernel"].to(dtype), blk["attn"]["out"]["bias"].float(),
    )


def _mlp_args(blk: Dict, dtype):
    return (
        blk["ln_2"]["scale"].float(), blk["ln_2"]["bias"].float(),
        blk["mlp"]["fc"]["kernel"].to(dtype), blk["mlp"]["fc"]["bias"].float(),
        blk["mlp"]["proj"]["kernel"].to(dtype), blk["mlp"]["proj"]["bias"].float(),
    )


def vision_features_fused(params: Dict, cfg: CLIPConfig, pixels: Tensor) -> Tensor:
    """Inference ViT forward with every sub-block through the layer
    kernels; same math as ``VisionTower`` on the same parameters.
    pixels: CLIP-normalized ``[B, H, W, 3]``. Returns ``[B, embed_dim]`` f32."""
    v = params["visual"]
    dtype = cfg.dtype
    x = _vision_embed(v, cfg, pixels)
    for blk in _blocks(v, cfg.vision_layers):
        x = fused_attention_layer(x, *_attn_args(blk, dtype), heads=cfg.vision_heads)
        x = fused_mlp_layer(x, *_mlp_args(blk, dtype))
    return _vision_head(v, x)


def text_features_fused(params: Dict, cfg: CLIPConfig, tokens: Tensor) -> Tensor:
    """Inference text forward with every sub-block (causal) through the
    layer kernels; same math as ``TextTower``. Returns ``[B, embed_dim]`` f32."""
    t = params["text"]
    dtype = cfg.dtype
    x = _text_embed(t, dtype, tokens)
    for blk in _blocks(t, cfg.text_layers):
        x = fused_attention_layer(x, *_attn_args(blk, dtype), heads=cfg.text_heads, causal=True)
        x = fused_mlp_layer(x, *_mlp_args(blk, dtype))
    return _text_head(t, x, tokens)


def _vision_embed(v: Dict, cfg: CLIPConfig, pixels: Tensor) -> Tensor:
    """Patch embedding, class token, positions and LN-pre, in ``cfg.dtype``."""
    dtype = cfg.dtype
    x = patch_embed(pixels, v["patch_embed"]["kernel"], cfg.patch_size, dtype)
    B = x.shape[0]
    cls = v["class_embedding"].to(dtype).expand(B, 1, cfg.vision_width)
    x = torch.cat([cls, x], dim=1) + v["positional_embedding"].to(dtype)
    return layernorm_f32(x, v["ln_pre"]["scale"], v["ln_pre"]["bias"]).to(dtype)


def _vision_head(v: Dict, x: Tensor) -> Tensor:
    """LN-post of the class token and the projection, f32."""
    x = layernorm_f32(x[:, 0, :], v["ln_post"]["scale"], v["ln_post"]["bias"])
    return x @ v["proj"].float()


def _text_embed(t: Dict, dtype, tokens: Tensor) -> Tensor:
    T = tokens.shape[1]
    x = t["token_embedding"]["embedding"].to(dtype)[tokens]
    return (x + t["positional_embedding"][:T].to(dtype)).contiguous()


def _text_head(t: Dict, x: Tensor, tokens: Tensor) -> Tensor:
    """Final LN, the feature at the EOT position (argmax id), projection."""
    x = layernorm_f32(x, t["ln_final"]["scale"], t["ln_final"]["bias"])
    x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
    return x @ t["text_projection"].float()


def quantize_clip_params(params: Dict, cfg: CLIPConfig) -> Dict:
    """The int8 serving weights: per-output-channel symmetric int8 for the
    four projection GEMMs of every block of both towers (QKV, attn-out, MLP
    fc, MLP proj), on the parameters' device. Returns
    ``{"visual"|"text": {"block_i": {name: (w_q int8, scale f32)}}}``."""

    def tower(tree: Dict, layers: int) -> Dict:
        return {
            f"block_{i}": {
                "qkv": quantize_linear(blk["attn"]["qkv"]["kernel"]),
                "out": quantize_linear(blk["attn"]["out"]["kernel"]),
                "fc": quantize_linear(blk["mlp"]["fc"]["kernel"]),
                "proj": quantize_linear(blk["mlp"]["proj"]["kernel"]),
            }
            for i, blk in enumerate(_blocks(tree, layers))
        }

    return {
        "visual": tower(params["visual"], cfg.vision_layers),
        "text": tower(params["text"], cfg.text_layers),
    }


def _attn_i8_args(blk: Dict, qblk: Dict):
    return (
        blk["ln_1"]["scale"].float(), blk["ln_1"]["bias"].float(),
        *qblk["qkv"], blk["attn"]["qkv"]["bias"].float(),
        *qblk["out"], blk["attn"]["out"]["bias"].float(),
    )


def _mlp_i8_args(blk: Dict, qblk: Dict):
    return (
        blk["ln_2"]["scale"].float(), blk["ln_2"]["bias"].float(),
        *qblk["fc"], blk["mlp"]["fc"]["bias"].float(),
        *qblk["proj"], blk["mlp"]["proj"]["bias"].float(),
    )


def vision_features_fused_i8(params: Dict, qparams: Dict, cfg: CLIPConfig, pixels: Tensor) -> Tensor:
    """``vision_features_fused`` with every sub-block through the W8A8
    layer kernels; ``qparams`` from :func:`quantize_clip_params`."""
    v, qv = params["visual"], qparams["visual"]
    x = _vision_embed(v, cfg, pixels)
    for i, blk in enumerate(_blocks(v, cfg.vision_layers)):
        qblk = qv[f"block_{i}"]
        x = fused_attention_layer_i8(x, *_attn_i8_args(blk, qblk), heads=cfg.vision_heads)
        x = fused_mlp_layer_i8(x, *_mlp_i8_args(blk, qblk))
    return _vision_head(v, x)


def text_features_fused_i8(params: Dict, qparams: Dict, cfg: CLIPConfig, tokens: Tensor) -> Tensor:
    """``text_features_fused`` with every sub-block (causal) through the
    W8A8 layer kernels."""
    t, qt = params["text"], qparams["text"]
    x = _text_embed(t, cfg.dtype, tokens)
    for i, blk in enumerate(_blocks(t, cfg.text_layers)):
        qblk = qt[f"block_{i}"]
        x = fused_attention_layer_i8(x, *_attn_i8_args(blk, qblk), heads=cfg.text_heads, causal=True)
        x = fused_mlp_layer_i8(x, *_mlp_i8_args(blk, qblk))
    return _text_head(t, x, tokens)


# ---------------------------------------------------------------------------
# host-side preprocessing
# ---------------------------------------------------------------------------


def preprocess_images(
    images: Sequence, image_size: int = 224, normalize: bool = True
) -> np.ndarray:
    """PIL images / uint8 or [0, 1] float arrays of any size -> ``[B,
    image_size, image_size, 3]`` float32 (in CLIP stats when ``normalize``).

    The JAX package's branches: with ``normalize`` and every input an
    ``[h, w, 3]`` image, the native OpenMP resize + normalize
    (``tvc_torch.native``, a triangle filter as PIL's BILINEAR; float
    arrays become uint8 as ``clip * 255`` truncated); otherwise, the
    detector's ``normalize=False`` included, PIL's ``resize((size,
    size))``. Unlike the JAX package, a native failure raises instead of
    falling through to PIL."""
    if normalize:
        raws = []
        for im in images:
            if hasattr(im, "convert"):
                raws.append(np.asarray(im.convert("RGB"), dtype=np.uint8))
            else:
                arr = np.asarray(im)
                if arr.dtype != np.uint8:
                    arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
                raws.append(arr)
        if all(r.ndim == 3 and r.shape[-1] == 3 for r in raws):
            from tvc_torch import native

            return native.resize_normalize_varied(raws, image_size)
    from PIL import Image

    out = []
    for im in images:
        if hasattr(im, "convert"):  # PIL (an ndarray also has .resize)
            im = im.convert("RGB").resize((image_size, image_size))
            arr = np.asarray(im, dtype=np.float32) / 255.0
        else:
            arr = np.asarray(im, dtype=np.float32)
            if arr.max() > 1.5:
                arr = arr / 255.0
            if arr.shape[:2] != (image_size, image_size):
                pil = Image.fromarray((arr * 255).astype(np.uint8))
                arr = np.asarray(pil.resize((image_size, image_size)), dtype=np.float32) / 255.0
        out.append(arr)
    batch = np.stack(out)
    if normalize:
        batch = (batch - np.asarray(CLIP_IMAGE_MEAN)) / np.asarray(CLIP_IMAGE_STD)
    return batch.astype(np.float32)


def normalize_pixels(pixels: Tensor) -> Tensor:
    """[0, 1] pixels -> CLIP-normalized."""
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=torch.float32, device=pixels.device)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=torch.float32, device=pixels.device)
    return (pixels - mean) / std


def bucket_text_tokens(
    tokens: np.ndarray,
    short_len: int = 16,
    capacity_quantum: int = 256,
    dedup: bool = False,
) -> Optional[Dict[str, np.ndarray]]:
    """Host-side two-bucket partition of a padded token batch ``[S, T]``
    for :meth:`CLIPModel.infer_text_features_bucketed` (numpy, identical to
    the JAX package's).

    Rows sort stably by real length (EOT position + 1, or the last nonzero
    id if later); the C shortest go to a ``short_len``-wide bucket and the
    rest to a full-T bucket, C being the largest multiple of
    ``capacity_quantum`` not above the rows that fit ``short_len``. Returns
    None when T <= short_len or fewer than one quantum of short rows.
    ``dedup=True`` also costs encoding each distinct row once (the long
    bucket then zero-pads up to a quantum multiple) and keeps the cheaper
    plan. Output: ``short`` [C, short_len], ``long`` [L, T], ``inv`` [S]
    int32 with ``concat(feats_short, feats_long)[inv]`` in input order.
    """
    S, T = tokens.shape
    if T <= short_len or S < 2 * capacity_quantum:
        return None

    def _plan(rows, pad_long_to_quantum):
        U = rows.shape[0]
        lens = rows.argmax(-1) + 1
        nonzero = rows != 0
        content = np.where(nonzero.any(axis=-1), T - nonzero[:, ::-1].argmax(-1), 0)
        lens = np.maximum(lens, content)
        n_short = int((lens <= short_len).sum())
        C = (n_short // capacity_quantum) * capacity_quantum
        if C < capacity_quantum or C >= U:
            return None
        order = np.argsort(lens, kind="stable")
        pos = np.empty(U, dtype=np.int32)
        pos[order] = np.arange(U, dtype=np.int32)
        long_rows = rows[order[C:], :]
        if pad_long_to_quantum:
            L = -(-(U - C) // capacity_quantum) * capacity_quantum
            if L > U - C:
                long_rows = np.concatenate(
                    [long_rows, np.zeros((L - (U - C), T), dtype=rows.dtype)]
                )
        return {
            "short": np.ascontiguousarray(rows[order[:C], :short_len]),
            "long": np.ascontiguousarray(long_rows),
            "pos": pos,
        }

    def _cost(plan):
        return plan["short"].size + plan["long"].shape[0] * T

    raw = _plan(tokens, pad_long_to_quantum=False)
    best, inv_u = raw, None
    if dedup:
        uniq, iu = np.unique(tokens, axis=0, return_inverse=True)
        if uniq.shape[0] < S:
            dp = _plan(uniq, pad_long_to_quantum=True)
            if dp is not None and (raw is None or _cost(dp) < _cost(raw)):
                best, inv_u = dp, iu.reshape(-1).astype(np.int32)
    if best is None:
        return None
    inv = best["pos"] if inv_u is None else best["pos"][inv_u]
    return {
        "short": best["short"],
        "long": best["long"],
        "inv": np.ascontiguousarray(inv.astype(np.int32)),
    }


def bucket_text_tokens_sharded(
    tokens: np.ndarray,
    n_shards: int,
    short_len: int = 16,
    capacity_quantum: int = 64,
    dedup: bool = False,
) -> Optional[Dict[str, np.ndarray]]:
    """Per-shard two-bucket partition for mesh serving (numpy, identical to
    the JAX package's).

    ``tokens`` [S, T] flattens a batch-sharded [B, V+1, T] block b-major, so
    shard k of the ``data`` axis owns rows [k*g, (k+1)*g), g = S/n_shards.
    Each shard partitions its own rows like :func:`bucket_text_tokens`, with
    one (short, long) capacity shared by every shard: ``n_short`` is the
    least per-shard short count quantized to ``capacity_quantum`` (a shard's
    surplus short rows go to its full-T long bucket). ``inv`` holds LOCAL
    indices (0..n_short+n_long), so each rank gathers its own features.
    ``dedup=True`` dedups within each shard and keeps the cheaper plan.

    Returns ``short`` [n_shards*n_short, short_len], ``long`` [n_shards*n_long,
    T], ``inv`` [S] int32, or None when bucketing cannot help (T <=
    short_len, rows not shardable, or too few short rows)."""
    S, T = tokens.shape
    if T <= short_len or n_shards < 1 or S % n_shards != 0:
        return None
    g = S // n_shards

    def _lens(rows):
        ln = rows.argmax(-1) + 1
        nonzero = rows != 0
        content = np.where(nonzero.any(axis=-1), T - nonzero[:, ::-1].argmax(-1), 0)
        return np.maximum(ln, content)

    def _plan(shard_rows, shard_inv_u, pad_to_quantum):
        counts_short = [int((_lens(rows) <= short_len).sum()) for rows in shard_rows]
        n_short = (min(counts_short) // capacity_quantum) * capacity_quantum
        if n_short < capacity_quantum or any(n_short >= r.shape[0] for r in shard_rows):
            return None
        if pad_to_quantum:
            n_long = max(-(-(r.shape[0] - n_short) // capacity_quantum) * capacity_quantum for r in shard_rows)
        else:
            n_long = max(r.shape[0] - n_short for r in shard_rows)
        shorts, longs, invs = [], [], []
        for k, rows in enumerate(shard_rows):
            order = np.argsort(_lens(rows), kind="stable")
            pos = np.empty(rows.shape[0], dtype=np.int32)
            pos[order] = np.arange(rows.shape[0], dtype=np.int32)
            long_rows = rows[order[n_short:], :]
            if long_rows.shape[0] < n_long:
                long_rows = np.concatenate([long_rows, np.zeros((n_long - long_rows.shape[0], T), rows.dtype)])
            shorts.append(rows[order[:n_short], :short_len])
            longs.append(long_rows)
            inv = pos if shard_inv_u[k] is None else pos[shard_inv_u[k]]
            invs.append(inv.astype(np.int32))
        return {
            "short": np.ascontiguousarray(np.concatenate(shorts)),
            "long": np.ascontiguousarray(np.concatenate(longs)),
            "inv": np.ascontiguousarray(np.concatenate(invs)),
        }

    def _cost(plan):
        return plan["short"].size + plan["long"].shape[0] * T

    raw_rows = [tokens[k * g : (k + 1) * g] for k in range(n_shards)]
    best = _plan(raw_rows, [None] * n_shards, pad_to_quantum=False)
    if dedup:
        uniq_rows, inv_us = [], []
        any_dup = False
        for rows in raw_rows:
            u, iu = np.unique(rows, axis=0, return_inverse=True)
            any_dup = any_dup or u.shape[0] < rows.shape[0]
            uniq_rows.append(u)
            inv_us.append(iu.reshape(-1).astype(np.int32))
        if any_dup:
            dp = _plan(uniq_rows, inv_us, pad_to_quantum=True)
            if dp is not None and (best is None or _cost(dp) < _cost(best)):
                best = dp
    return best


# ---------------------------------------------------------------------------
# user-facing wrapper
# ---------------------------------------------------------------------------


class CLIPModel:
    """Parameters + tokenizer + encode entry points.

    ``params`` is the port's parameter tree (the flax tree's structure,
    torch tensors); assigning a new tree loads it into the module and
    yields a new tree object. Runs on the card unless ``device="cpu"``.
    """

    def __init__(
        self,
        config: Optional[CLIPConfig] = None,
        params: Optional[Dict] = None,
        seed: int = 0,
        tokenizer: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.config = config or CLIPConfig()
        self.device = resolve_device(device)
        disable_tf32(self.device)
        # the differentiable module (einsum attention); the inference module
        # below runs fused_mha in its vision tower when fused_attention is on
        self.module = CLIPModule(dataclasses.replace(self.config, fused_attention=False), device=self.device)
        self.module.requires_grad_(False)
        #: the public handle for custom inference programs: the same
        #: parameter tensors as ``module`` (no copy; assigning ``params``
        #: updates both), not differentiable with fused_attention
        self.inference_module = CLIPModule(self.config, device="meta")
        _tie_parameters(self.inference_module, self.module)
        self._params: Dict = {}
        self._compute = (None, None)  # (params tree, dtype-cast tree) cache
        self.params = params if params is not None else init_params(self.config, seed)
        if tokenizer is None:
            from tvc_torch.models.tokenizer import get_tokenizer

            tokenizer = get_tokenizer(
                vocab_size=self.config.vocab_size,
                context_length=self.config.context_length,
            )
        self.tokenizer = tokenizer

    # -- parameters ------------------------------------------------------------
    @property
    def params(self) -> Dict:
        return self._params

    @params.setter
    def params(self, tree: Dict) -> None:
        flat = _flatten(tree)
        named = dict(self.module.named_parameters())
        if set(flat) != set(named):
            raise ValueError("parameter tree does not match the model's structure")
        with torch.no_grad():
            for name, p in named.items():
                src = flat[name] if torch.is_tensor(flat[name]) else torch.as_tensor(np.asarray(flat[name]))
                if tuple(src.shape) != tuple(p.shape):
                    raise ValueError(f"{name}: shape {tuple(src.shape)}, expected {tuple(p.shape)}")
                p.copy_(src)
        self._params = _unflatten({n: p.detach() for n, p in named.items()})
        self._compute = (None, None)

    def _compute_params(self, params: Dict) -> Dict:
        """``params`` with the GEMM weights and embeddings cast to the compute
        dtype once (cached for the current tree), biases and norms f32."""
        if self._compute[0] is not params:
            dtype = self.config.dtype

            def cast(name, t):
                leaf = name.rsplit(".", 1)[-1]
                big = leaf in ("kernel", "embedding") and t.ndim >= 2
                return (t.to(dtype) if big else t.float()).contiguous()

            flat = {n: cast(n, t) for n, t in _flatten(params).items()}
            self._compute = (params, _unflatten(flat))
        return self._compute[1]

    def qparams(self) -> Dict:
        """The int8 serving weights of the current parameters
        (:func:`quantize_clip_params`), for callers that pass ``qparams``
        to ``infer_*_features`` instead of quantizing in every call."""
        return quantize_clip_params(self.params, self.config)

    # -- functional core ---------------------------------------------------------
    def _module_call(self, params: Dict, tower: str, x: Tensor) -> Tensor:
        flat = {
            n[len(tower) + 1:]: t for n, t in _flatten(params).items() if n.startswith(tower + ".")
        }
        return torch.func.functional_call(getattr(self.module, tower), flat, (x,))

    def image_features(self, params: Dict, pixels: Tensor) -> Tensor:
        """Differentiable: CLIP-normalized pixels [B,H,W,3] -> [B,E]."""
        return self._module_call(params, "visual", pixels)

    def text_features(self, params: Dict, tokens: Tensor) -> Tensor:
        return self._module_call(params, "text", tokens)

    @torch.no_grad()
    def infer_image_features(
        self, params: Dict, pixels: Tensor, qparams: Optional[Dict] = None
    ) -> Tensor:
        """Inference image features: the layer kernels when
        ``config.fused_attention`` (the W8A8 ones with
        ``config.int8_serving``), else the module. In int8, ``qparams=None``
        quantizes the weights from ``params`` in this call; pass
        :meth:`qparams` to skip that."""
        cfg = self.config
        if cfg.fused_attention:
            if cfg.int8_serving:
                qp = qparams if qparams is not None else quantize_clip_params(params, cfg)
                return vision_features_fused_i8(self._compute_params(params), qp, cfg, pixels)
            return vision_features_fused(self._compute_params(params), cfg, pixels)
        return self.image_features(params, pixels)

    @torch.no_grad()
    def infer_text_features(
        self, params: Dict, tokens: Tensor, qparams: Optional[Dict] = None
    ) -> Tensor:
        """Inference text features; see :meth:`infer_image_features`."""
        cfg = self.config
        if cfg.fused_attention:
            if cfg.int8_serving:
                qp = qparams if qparams is not None else quantize_clip_params(params, cfg)
                return text_features_fused_i8(self._compute_params(params), qp, cfg, tokens)
            return text_features_fused(self._compute_params(params), cfg, tokens)
        return self.text_features(params, tokens)

    @torch.no_grad()
    def infer_text_features_bucketed(
        self,
        params: Dict,
        short_tokens: Tensor,
        long_tokens: Tensor,
        inv_perm: Tensor,
        qparams: Optional[Dict] = None,
    ) -> Tensor:
        """Encode the short bucket at its own length and the long bucket at
        full length, then gather rows back to input order (exact: the tower
        is length-polymorphic)."""
        fs = self.infer_text_features(params, short_tokens, qparams=qparams)
        fl = self.infer_text_features(params, long_tokens, qparams=qparams)
        return torch.cat([fs, fl], dim=0)[inv_perm]

    # -- convenience API -----------------------------------------------------------
    def preprocess(self, images: Sequence) -> np.ndarray:
        return preprocess_images(images, self.config.image_size)

    def tokenize(self, texts: Union[str, Sequence[str]]) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        return self.tokenizer(texts)

    def encode_image(self, images, normalize: bool = True) -> Tensor:
        """PIL list or raw [0, 1] NHWC pixel array (or tensor) -> embeddings [B, E]."""
        if isinstance(images, (list, tuple)):
            pixels = torch.as_tensor(self.preprocess(images), device=self.device)
        else:
            if torch.is_tensor(images):
                arr = images.to(self.device, torch.float32)
            else:
                arr = torch.as_tensor(np.asarray(images, np.float32), device=self.device)
            pixels = normalize_pixels(arr[None] if arr.ndim == 3 else arr)
        feats = self.infer_image_features(self.params, pixels)
        return l2_normalize(feats) if normalize else feats

    def encode_image_tensor(self, pixels: Tensor, normalize: bool = True) -> Tensor:
        """Differentiable path on already-normalized pixels (the attack
        loop): the einsum module, whatever ``config.fused_attention`` says,
        since the kernels define no gradient."""
        feats = self.image_features(self.params, pixels)
        return l2_normalize(feats) if normalize else feats

    def encode_text(self, texts, normalize: bool = True) -> Tensor:
        """Strings (tokenized here and cut to the smallest 8-multiple that
        keeps every row's real tokens) or a token array -> [B, E]."""
        if isinstance(texts, str) or (
            isinstance(texts, (list, tuple)) and texts and isinstance(texts[0], str)
        ):
            tokens = self.tokenize(texts)
            real = int(tokens.argmax(-1).max()) + 1
            nonzero = tokens != 0
            content = int(
                np.where(nonzero.any(axis=-1), tokens.shape[-1] - nonzero[:, ::-1].argmax(-1), 0).max()
            )
            t_b = min(-(-max(real, content, 8) // 8) * 8, tokens.shape[-1])
            tokens = tokens[:, :t_b]
        else:
            tokens = np.asarray(texts)
        feats = self.infer_text_features(
            self.params, torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        )
        return l2_normalize(feats) if normalize else feats

    def get_text_image_similarity(self, text, image) -> Tensor:
        """cos(text, image): a caption or captions against one image (an
        [H, W, 3] array, resized and normalized) or a list of them."""
        t = self.encode_text([text] if isinstance(text, str) else text)
        i = self.encode_image(image if isinstance(image, (list, tuple)) else [image])
        return cosine_similarity(t, i)
