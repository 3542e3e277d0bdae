"""Stable Diffusion (port of ``tvc/models/sd.py``): reference-image
synthesis for the TVC defense.

* a latent-diffusion UNet (ResBlocks + self / cross attention, sinusoidal
  time embedding) conditioned on text states;
* a VAE encoder / decoder (8x spatial at SD-1.5's shape, 4 latent
  channels, scale 0.18215);
* a DDIM sampler with classifier-free guidance: one batched UNet call a
  step over the unconditional and conditional halves, over all prompts and
  images per prompt at once.

The JAX package computes these convolutions, GEMMs and attentions in plain
XLA (no Pallas kernel), so the port computes them in plain torch
(``F.conv2d``, matmul, softmax), NHWC throughout (the convolutions read
the channels-last views). The modules mirror the flax modules: the same
names, flax's SAME padding (a stride-2 convolution on an even size pads
nothing on the top and left and one row and column on the bottom and
right), flax's GroupNorm (epsilon 1e-6, statistics in f32 as
``E[x^2] - E[x]^2``), the tanh GELU, and the attention as the JAX module
writes it (f32 logits of the compute-dtype operands, f32 softmax, weights
cast to the compute dtype, then P.V; not SDPA, whose rescaled output is
another function). Parameters are f32, each GEMM and convolution runs in
its module's dtype on weights cast once per parameter tree. Layouts:
convolution kernels OIHW and the UNet / VAE Dense kernels ``[out, in]``
(``sd_params_from_jax`` converts flax's HWIO and ``[in, out]``); the text
encoder reuses the port's CLIP ``Transformer``, whose Dense kernels keep
flax's ``[in, out]``.

Noise: the sampler takes its initial latents as an argument;
``generate_images_batch`` draws them from a ``torch.Generator`` seeded
from (seed, batch size), deterministic per (seed, batch) but not the JAX
package's threefry bits. Runs on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor, nn

from tvc_torch._device import resolve_device
from tvc_torch.models.clip import CLIPConfig, Transformer, _flatten, _unflatten, causal_mask


@dataclasses.dataclass(frozen=True)
class SDConfig:
    """Architecture + sampler config (defaults: the SD-1.5 shape class)."""

    image_size: int = 512
    latent_channels: int = 4
    vae_base: int = 128
    vae_mults: Tuple[int, ...] = (1, 2, 4, 4)
    unet_base: int = 320
    unet_mults: Tuple[int, ...] = (1, 2, 4, 4)
    attn_levels: Tuple[int, ...] = (1, 2, 3)
    num_res_blocks: int = 2
    num_heads: int = 8
    context_dim: int = 768  # CLIP text hidden size
    context_len: int = 77
    num_train_steps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    num_inference_steps: int = 20
    guidance_scale: float = 7.5
    vae_scale: float = 0.18215
    dtype: Any = torch.bfloat16
    model_name: str = "runwayml/stable-diffusion-v1-5"

    @classmethod
    def tiny(cls) -> "SDConfig":
        return cls(
            image_size=32,
            vae_base=16,
            vae_mults=(1, 2),
            unet_base=32,
            unet_mults=(1, 2),
            attn_levels=(1,),
            num_res_blocks=1,
            num_heads=2,
            context_dim=64,
            context_len=16,
            num_inference_steps=4,
            dtype=torch.float32,
            model_name="tiny",
        )


def _gn(x_channels: int) -> int:
    return min(32, x_channels) if x_channels % min(32, x_channels) == 0 else 1


def _param(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape, dtype=torch.float32, device=device), requires_grad=False)


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """flax / XLA SAME padding of one spatial axis: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` with SAME (or VALID) padding on NHWC tensors,
    computed in ``dtype``; kernel OIHW ``[out, in, k, k]``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, dtype=torch.float32, device=None,
                 padding: str = "SAME"):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding {padding!r}")
        self.kernel = _param(cout, cin, k, k, device=device)
        self.bias = _param(cout, device=device)
        self.k, self.stride, self.dtype, self.padding = k, stride, dtype, padding

    def forward(self, x: Tensor) -> Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # the channels-last view
        if self.padding == "VALID":
            y = F.conv2d(x, self.kernel.to(self.dtype), self.bias.to(self.dtype), stride=self.stride)
            return y.permute(0, 2, 3, 1)
        (top, bottom), (left, right) = (same_pads(n, self.k, self.stride) for n in x.shape[2:])
        if top == bottom and left == right:
            pad = (top, left)
        else:
            x, pad = F.pad(x, (left, right, top, bottom)), 0
        y = F.conv2d(x, self.kernel.to(self.dtype), self.bias.to(self.dtype), stride=self.stride, padding=pad)
        return y.permute(0, 2, 3, 1)


class Dense(nn.Module):
    """flax ``nn.Dense`` computed in ``dtype``; kernel ``[out, in]``."""

    def __init__(self, din: int, dout: int, dtype=torch.float32, device=None, bias: bool = True):
        super().__init__()
        self.kernel = _param(dout, din, device=device)
        self.bias = _param(dout, device=device) if bias else None
        self.dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.kernel.to(self.dtype), bias)


def _normalize(x: Tensor, mean: Tensor, var: Tensor, scale: Tensor, bias: Tensor, eps: float) -> Tensor:
    """flax's ``_normalize``: (x - mean) * (rsqrt(var + eps) * scale) + bias, in f32."""
    return (x.float() - mean) * (torch.rsqrt(var + eps) * scale.float()) + bias.float()


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(groups)`` over NHWC (default ``_gn(C)`` groups):
    statistics over (H, W, C / G) in f32 (E[x^2] - E[x]^2, clamped at 0),
    epsilon ``eps`` (default 1e-6), the result in ``dtype``."""

    def __init__(self, channels: int, dtype=torch.float32, device=None, groups: Optional[int] = None,
                 eps: float = 1e-6):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels, device=device), requires_grad=False)
        self.bias = _param(channels, device=device)
        self.groups, self.dtype, self.eps = groups or _gn(channels), dtype, eps

    def forward(self, x: Tensor) -> Tensor:
        B, C = x.shape[0], x.shape[-1]
        xg = x.float().reshape(B, -1, self.groups, C // self.groups)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = torch.clamp(torch.square(xg).mean(dim=(1, 3), keepdim=True) - torch.square(mean), min=0.0)
        y = _normalize(xg, mean, var, self.scale.reshape(self.groups, -1), self.bias.reshape(self.groups, -1),
                       self.eps)
        return y.reshape(x.shape).to(self.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=eps)`` (default 1e-6, E[x^2] -
    E[x]^2), f32."""

    def __init__(self, width: int, device=None, eps: float = 1e-6):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(width, device=device), requires_grad=False)
        self.bias = _param(width, device=device)
        self.eps = eps

    def forward(self, x: Tensor) -> Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp(torch.square(xf).mean(dim=-1, keepdim=True) - torch.square(mean), min=0.0)
        return _normalize(xf, mean, var, self.scale, self.bias, self.eps)


class ResBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, dtype, temb_dim: Optional[int] = None, device=None):
        super().__init__()
        self.dtype = dtype
        self.norm1 = GroupNorm(in_ch, dtype, device)
        self.conv1 = Conv(in_ch, out_ch, 3, dtype=dtype, device=device)
        if temb_dim is not None:
            self.temb_proj = Dense(temb_dim, out_ch, dtype, device)
        self.norm2 = GroupNorm(out_ch, dtype, device)
        self.conv2 = Conv(out_ch, out_ch, 3, dtype=dtype, device=device)
        if in_ch != out_ch:
            self.skip = Conv(in_ch, out_ch, 1, dtype=dtype, device=device)

    def forward(self, x: Tensor, temb: Optional[Tensor] = None) -> Tensor:
        h = self.norm1(x)
        h = self.conv1(F.silu(h).to(self.dtype))
        if temb is not None:
            h = h + self.temb_proj(F.silu(temb))[:, None, None, :]
        h2 = self.norm2(h)
        h = self.conv2(F.silu(h2).to(self.dtype))
        if hasattr(self, "skip"):
            x = self.skip(x)
        return x + h


class AttnBlock(nn.Module):
    """Self-attention + optional cross-attention over flattened space, then
    a GELU feed-forward."""

    def __init__(self, channels: int, heads: int, dtype, context_dim: Optional[int] = None, device=None):
        super().__init__()
        C = channels
        self.heads, self.dtype = heads, dtype
        self.norm = GroupNorm(C, dtype, device)
        names = ["self"] + (["cross"] if context_dim is not None else [])
        for name in names:
            for part in "qkvo":
                self.add_module(f"{name}_{part}", Dense(C, C, dtype, device))
        if context_dim is not None:
            self.ctx_proj = Dense(context_dim, C, dtype, device)
        self.ff1 = Dense(C, 4 * C, dtype, device)
        self.ff2 = Dense(4 * C, C, dtype, device)

    def _mha(self, q_in: Tensor, kv_in: Tensor, name: str) -> Tensor:
        B, _, C = q_in.shape
        hd = C // self.heads
        q = getattr(self, f"{name}_q")(q_in).reshape(B, -1, self.heads, hd).transpose(1, 2)
        k = getattr(self, f"{name}_k")(kv_in).reshape(B, -1, self.heads, hd).transpose(1, 2)
        v = getattr(self, f"{name}_v")(kv_in).reshape(B, -1, self.heads, hd).transpose(1, 2)
        # f32 logits of the dtype operands (preferred_element_type=f32), f32 softmax
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / np.float32(math.sqrt(hd))
        w = torch.softmax(logits, dim=-1).to(self.dtype)
        o = torch.matmul(w, v).transpose(1, 2).reshape(B, -1, C)
        return getattr(self, f"{name}_o")(o)

    def forward(self, x: Tensor, context: Optional[Tensor] = None) -> Tensor:
        B, H, W, C = x.shape
        flat = self.norm(x).reshape(B, H * W, C)
        flat = flat + self._mha(flat, flat, "self")
        if context is not None:
            flat = flat + self._mha(flat, self.ctx_proj(context), "cross")
        ff = self.ff1(flat)
        flat = flat + self.ff2(F.gelu(ff, approximate="tanh"))
        return x + flat.reshape(B, H, W, C).to(x.dtype)


def timestep_embedding(t: Tensor, dim: int) -> Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def upsample2x(x: Tensor) -> Tensor:
    """``jax.image.resize(x, (B, 2H, 2W, C), "nearest")`` on NHWC."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class UNet(nn.Module):
    def __init__(self, cfg: SDConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        dt, temb_dim = c.dtype, c.unet_base * 4
        self.temb1 = Dense(c.unet_base, temb_dim, dt, device)
        self.temb2 = Dense(temb_dim, temb_dim, dt, device)
        self.conv_in = Conv(c.latent_channels, c.unet_base, 3, dtype=dt, device=device)
        prev, skips = c.unet_base, [c.unet_base]
        for level, mult in enumerate(c.unet_mults):
            ch = c.unet_base * mult
            for i in range(c.num_res_blocks):
                self.add_module(f"down_{level}_res_{i}", ResBlock(prev, ch, dt, temb_dim, device))
                if level in c.attn_levels:
                    self.add_module(f"down_{level}_attn_{i}", AttnBlock(ch, c.num_heads, dt, c.context_dim, device))
                prev = ch
                skips.append(ch)
            if level < len(c.unet_mults) - 1:
                self.add_module(f"down_{level}_downsample", Conv(ch, ch, 3, 2, dt, device))
                skips.append(ch)
        self.mid_res_1 = ResBlock(prev, prev, dt, temb_dim, device)
        self.mid_attn = AttnBlock(prev, c.num_heads, dt, c.context_dim, device)
        self.mid_res_2 = ResBlock(prev, prev, dt, temb_dim, device)
        for level in reversed(range(len(c.unet_mults))):
            ch = c.unet_base * c.unet_mults[level]
            for i in range(c.num_res_blocks + 1):
                self.add_module(f"up_{level}_res_{i}", ResBlock(prev + skips.pop(), ch, dt, temb_dim, device))
                if level in c.attn_levels:
                    self.add_module(f"up_{level}_attn_{i}", AttnBlock(ch, c.num_heads, dt, c.context_dim, device))
                prev = ch
            if level > 0:
                self.add_module(f"up_{level}_upsample", Conv(ch, ch, 3, dtype=dt, device=device))
        self.norm_out = GroupNorm(prev, torch.float32, device)
        self.conv_out = Conv(prev, c.latent_channels, 3, dtype=torch.float32, device=device)

    def forward(self, latents: Tensor, t: Tensor, context: Tensor) -> Tensor:
        c = self.cfg
        temb = self.temb1(timestep_embedding(t, c.unet_base))
        temb = self.temb2(F.silu(temb))
        x = self.conv_in(latents.to(c.dtype))
        skips = [x]
        for level in range(len(c.unet_mults)):
            for i in range(c.num_res_blocks):
                x = getattr(self, f"down_{level}_res_{i}")(x, temb)
                if level in c.attn_levels:
                    x = getattr(self, f"down_{level}_attn_{i}")(x, context)
                skips.append(x)
            if level < len(c.unet_mults) - 1:
                x = getattr(self, f"down_{level}_downsample")(x)
                skips.append(x)
        x = self.mid_res_1(x, temb)
        x = self.mid_attn(x, context)
        x = self.mid_res_2(x, temb)
        for level in reversed(range(len(c.unet_mults))):
            for i in range(c.num_res_blocks + 1):
                x = torch.cat([x, skips.pop()], dim=-1)
                x = getattr(self, f"up_{level}_res_{i}")(x, temb)
                if level in c.attn_levels:
                    x = getattr(self, f"up_{level}_attn_{i}")(x, context)
            if level > 0:
                x = getattr(self, f"up_{level}_upsample")(upsample2x(x))
        x = self.norm_out(x)
        x = self.conv_out(F.silu(x).to(c.dtype))
        return x.float()


class VAEEncoder(nn.Module):
    def __init__(self, cfg: SDConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        dt = c.dtype
        self.conv_in = Conv(3, c.vae_base, 3, dtype=dt, device=device)
        prev = c.vae_base
        for level, mult in enumerate(c.vae_mults):
            ch = c.vae_base * mult
            for i in range(2):
                self.add_module(f"down_{level}_res_{i}", ResBlock(prev, ch, dt, device=device))
                prev = ch
            if level < len(c.vae_mults) - 1:
                self.add_module(f"down_{level}_ds", Conv(ch, ch, 3, 2, dt, device))
        self.norm_out = GroupNorm(prev, torch.float32, device)
        self.conv_out = Conv(prev, c.latent_channels * 2, 3, dtype=torch.float32, device=device)

    def forward(self, images: Tensor) -> Tuple[Tensor, Tensor]:
        c = self.cfg
        x = self.conv_in(images.to(c.dtype))
        for level in range(len(c.vae_mults)):
            for i in range(2):
                x = getattr(self, f"down_{level}_res_{i}")(x)
            if level < len(c.vae_mults) - 1:
                x = getattr(self, f"down_{level}_ds")(x)
        x = self.norm_out(x)
        moments = self.conv_out(F.silu(x).to(c.dtype)).float()
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)


class VAEDecoder(nn.Module):
    def __init__(self, cfg: SDConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        dt = c.dtype
        mults = tuple(reversed(c.vae_mults))
        self.conv_in = Conv(c.latent_channels, c.vae_base * mults[0], 3, dtype=dt, device=device)
        prev = c.vae_base * mults[0]
        for level, mult in enumerate(mults):
            ch = c.vae_base * mult
            for i in range(2):
                self.add_module(f"up_{level}_res_{i}", ResBlock(prev, ch, dt, device=device))
                prev = ch
            if level < len(mults) - 1:
                self.add_module(f"up_{level}_us", Conv(ch, ch, 3, dtype=dt, device=device))
        self.norm_out = GroupNorm(prev, torch.float32, device)
        self.conv_out = Conv(prev, 3, 3, dtype=torch.float32, device=device)

    def forward(self, latents: Tensor) -> Tensor:
        c = self.cfg
        x = self.conv_in(latents.to(c.dtype))
        levels = len(c.vae_mults)
        for level in range(levels):
            for i in range(2):
                x = getattr(self, f"up_{level}_res_{i}")(x)
            if level < levels - 1:
                x = getattr(self, f"up_{level}_us")(upsample2x(x))
        x = self.norm_out(x)
        return self.conv_out(F.silu(x).to(c.dtype)).float()


class SeqTower(nn.Module):
    """The default text encoder: token embedding + learned positions, the
    CLIP ``Transformer`` with a causal mask, a final LayerNorm; returns
    the token states ``[B, T, width]``."""

    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.tok = nn.Module()
        self.tok.embedding = _param(cfg.vocab_size, cfg.text_width, device=device)
        self.pos = _param(cfg.context_length, cfg.text_width, device=device)
        self.tr = Transformer(cfg.text_width, cfg.text_layers, cfg.text_heads, cfg.dtype, device)
        self.ln = LayerNorm(cfg.text_width, device)

    def forward(self, tokens: Tensor) -> Tensor:
        T = tokens.shape[1]
        x = self.tok.embedding[tokens] + self.pos[None, :T]
        x = self.tr(x, causal_mask(T, tokens.device))
        return self.ln(x)


def text_encoder_config(cfg: SDConfig) -> CLIPConfig:
    """The CLIP text-tower shape of the default text encoder."""
    return CLIPConfig(
        vocab_size=4096,
        context_length=cfg.context_len,
        text_width=cfg.context_dim,
        text_layers=2,
        text_heads=max(1, cfg.context_dim // 64),
        embed_dim=cfg.context_dim,
        dtype=torch.float32,
    )


class TextEncoder:
    """``texts -> [B, context_len, context_dim]`` token states: a
    :class:`SeqTower` (seeded random weights, or ``params``) behind the
    hash tokenizer."""

    def __init__(self, cfg: SDConfig, seed: int = 0, params: Optional[Dict] = None, device=None):
        from tvc_torch.models.tokenizer import HashTokenizer

        self.device = resolve_device(device)
        ccfg = text_encoder_config(cfg)
        self.tower = SeqTower(ccfg, device=self.device)
        if params is None:
            init_params(self.tower, torch.Generator(device=self.device).manual_seed(seed))
        else:
            load_params(self.tower, params)
        self.tokenizer = HashTokenizer(ccfg.vocab_size, ccfg.context_length)

    @property
    def params(self) -> Dict:
        return module_params(self.tower)

    @torch.no_grad()
    def __call__(self, texts: List[str]) -> Tensor:
        tokens = torch.as_tensor(self.tokenizer(list(texts)), dtype=torch.long, device=self.device)
        return self.tower(tokens)


# ---------------------------------------------------------------------------
# parameters: seeded init on the device, flax trees, compute-dtype copies
# ---------------------------------------------------------------------------

#: flax's truncated-normal initializers draw N(0, 1) cut at +-2 and divide
#: the std by this (the std of that truncated normal)
TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random parameters drawn in place, module by module, from
    flax's initializers: Dense and Conv kernels lecun-normal (a truncated
    normal of std sqrt(1 / fan_in)), biases 0, norm scales 1, the text
    token embedding normal(1 / sqrt(width)), the positions normal(0.01)."""
    for mod in module.modules():
        for leaf, p in mod.named_parameters(recurse=False):
            if leaf == "bias":
                p.zero_()
            elif leaf == "scale":
                p.fill_(1.0)
            elif leaf == "kernel":
                fan_in = p[0].numel() if isinstance(mod, (Conv, Dense)) else p.shape[0]
                nn.init.trunc_normal_(p, 0.0, 1.0, -2.0, 2.0, generator=generator)
                p.mul_(math.sqrt(1.0 / fan_in) / TRUNC_STD)
            elif leaf == "embedding":
                nn.init.normal_(p, 0.0, 1.0 / math.sqrt(p.shape[-1]), generator=generator)
            elif leaf == "pos":
                nn.init.normal_(p, 0.0, 0.01, generator=generator)
            else:
                raise ValueError(f"no initializer for parameter {leaf!r}")


def module_params(module: nn.Module) -> Dict:
    """The module's parameters as a nested tree (flax names)."""
    return _unflatten({n: p.detach() for n, p in module.named_parameters()})


@torch.no_grad()
def load_params(module: nn.Module, tree: Dict) -> None:
    """Copy a parameter tree into the module (names and shapes checked)."""
    flat = _flatten(tree)
    named = dict(module.named_parameters())
    missing, extra = set(named) - set(flat), set(flat) - set(named)
    if missing or extra:
        raise ValueError(f"parameter tree mismatch: missing {sorted(missing)}, unexpected {sorted(extra)}")
    for name, p in named.items():
        src = flat[name] if torch.is_tensor(flat[name]) else torch.as_tensor(np.asarray(flat[name]))
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)}, expected {tuple(p.shape)}")
        p.copy_(src)


def compute_params(module: nn.Module) -> Dict[str, Tensor]:
    """Flat parameters for ``functional_call``: each Conv / Dense's kernel
    and bias cast once to its module's dtype (convolution kernels in the
    channels-last layout the NHWC convolutions read), norms f32."""
    out = {}
    for mname, mod in module.named_modules():
        for leaf, p in mod.named_parameters(recurse=False):
            t = p.detach()
            if isinstance(mod, (Conv, Dense)):
                t = t.to(mod.dtype)
                if t.ndim == 4:
                    t = t.contiguous(memory_format=torch.channels_last)
            out[f"{mname}.{leaf}" if mname else leaf] = t
    return out


def module_tree_from_jax(module: nn.Module, tree) -> Dict:
    """One flax module's parameter tree (numpy leaves) as the port
    module's: conv kernels HWIO -> OIHW, the SD Dense kernels transposed
    to ``[out, in]``, every name and shape checked."""
    flat = _flatten(tree)
    want = dict(module.named_parameters())
    missing, extra = set(want) - set(flat), set(flat) - set(want)
    if missing or extra:
        raise ValueError(f"parameter tree mismatch: missing {sorted(missing)}, unexpected {sorted(extra)}")
    owners = dict(module.named_modules())
    out = {}
    for name, p in want.items():
        arr = np.asarray(flat[name], dtype=np.float32)
        path, _, leaf = name.rpartition(".")
        if leaf == "kernel" and isinstance(owners[path], Conv):
            arr = arr.transpose(3, 2, 0, 1)
        elif leaf == "kernel" and isinstance(owners[path], Dense):
            arr = arr.T
        if arr.shape != tuple(p.shape):
            raise ValueError(f"{name}: shape {arr.shape}, expected {tuple(p.shape)}")
        out[name] = torch.tensor(arr)
    return _unflatten(out)


SD_MODULES = {"unet": UNet, "vae_enc": VAEEncoder, "vae_dec": VAEDecoder}


def sd_params_from_jax(tree, cfg: SDConfig) -> Dict:
    """The JAX package's SD parameters (leaves as numpy arrays), any of
    ``unet`` / ``vae_enc`` / ``vae_dec`` and the default text encoder's
    under ``text_encoder``, as the port's trees (f32 CPU tensors; see
    :func:`module_tree_from_jax`)."""
    constructors = {**SD_MODULES, "text_encoder": lambda c, device: SeqTower(text_encoder_config(c), device=device)}
    out = {}
    for key, sub in tree.items():
        if key not in constructors:
            raise ValueError(f"unknown SD module {key!r}")
        try:
            out[key] = module_tree_from_jax(constructors[key](cfg, device="meta"), sub)
        except ValueError as e:
            raise ValueError(f"{key}: {e}") from None
    return out


def ddim_schedule(cfg: SDConfig) -> Tuple[np.ndarray, np.ndarray]:
    """(timesteps [S], alphas_cumprod [T]) for the DDIM stride."""
    betas = np.linspace(cfg.beta_start**0.5, cfg.beta_end**0.5, cfg.num_train_steps, dtype=np.float64) ** 2
    alphas_cumprod = np.cumprod(1.0 - betas)
    stride = cfg.num_train_steps // cfg.num_inference_steps
    timesteps = (np.arange(0, cfg.num_inference_steps) * stride)[::-1].copy()
    return timesteps.astype(np.int32), alphas_cumprod.astype(np.float32)


def mixed_seed(*values: int) -> int:
    """A generator seed mixed from these integers: (seed, batch size) for
    the initial latents, (seed, module) for the seeded init."""
    return int(np.random.SeedSequence([int(v) for v in values]).generate_state(1, np.uint64)[0] >> 1)


class StableDiffusionModel:
    """User-facing wrapper: text -> images through the DDIM + CFG sampler,
    and the VAE both ways."""

    def __init__(
        self,
        config: Optional[SDConfig] = None,
        params: Optional[Dict] = None,
        seed: int = 0,
        text_encoder: Optional[Callable[[List[str]], Tensor]] = None,
        mesh=None,
        unet=None,
        vae_enc=None,
        vae_dec=None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        """text_encoder: ``texts -> [B, context_len, context_dim]`` token
        states. Default: :class:`TextEncoder`, a causal text tower sized to
        context_dim with seeded random weights, behind the hash tokenizer.

        unet / vae_enc / vae_dec: module overrides with the same call
        signatures (the diffusers-layout mirrors run through this sampler).

        mesh: the sharded denoising batch is not ported; a mesh raises."""
        if mesh is not None:
            raise NotImplementedError("StableDiffusionModel(mesh=...): the sharded sampler is not ported")
        self.config = config or SDConfig.tiny()
        self.device = resolve_device(device)
        c = self.config
        self.unet = unet if unet is not None else UNet(c, device=self.device)
        self.vae_enc = vae_enc if vae_enc is not None else VAEEncoder(c, device=self.device)
        self.vae_dec = vae_dec if vae_dec is not None else VAEDecoder(c, device=self.device)
        for k, module in enumerate((self.unet, self.vae_enc, self.vae_dec)):
            module.requires_grad_(False)
            if params is None:
                init_params(module, torch.Generator(device=self.device).manual_seed(mixed_seed(seed, k)))
        self._compute: Tuple[Any, Dict] = (None, {})
        if params is not None:
            self.params = params
        else:
            self._params = {k: module_params(m) for k, m in self._components().items()}
        self.latent_size = c.image_size // (2 ** (len(c.vae_mults) - 1))
        self._text_encoder = text_encoder or self._default_text_encoder(seed)
        self.stats = {"images_generated": 0, "batches": 0}

    def _components(self) -> Dict[str, nn.Module]:
        return {"unet": self.unet, "vae_enc": self.vae_enc, "vae_dec": self.vae_dec}

    @property
    def params(self) -> Dict:
        return self._params

    @params.setter
    def params(self, tree: Dict) -> None:
        for key, module in self._components().items():
            load_params(module, tree[key])
        self._params = {k: module_params(m) for k, m in self._components().items()}
        self._compute = (None, {})

    def _compute_params(self) -> Dict[str, Dict[str, Tensor]]:
        """The modules' parameters cast to their compute dtypes, once per
        parameter tree."""
        if self._compute[0] is not self._params:
            self._compute = (self._params, {k: compute_params(m) for k, m in self._components().items()})
        return self._compute[1]

    def _apply(self, name: str, *args):
        module = self._components()[name]
        return torch.func.functional_call(module, self._compute_params()[name], args)

    def _default_text_encoder(self, seed: int) -> TextEncoder:
        return TextEncoder(self.config, seed + 17, device=self.device)

    # -- sampling ---------------------------------------------------------------
    def sampler(self, steps: Optional[int] = None, guidance: Optional[float] = None):
        """``sample(context, uncond_context, latents) -> uint8 [B, H, W, 3]``:
        the DDIM loop with classifier-free guidance (one UNet call a step
        over both halves), the CFG combination and the update in f32, then
        the VAE decode; steps and guidance default to the config's."""
        c = self.config
        steps = steps or c.num_inference_steps
        guidance = float(guidance if guidance is not None else c.guidance_scale)
        timesteps, ac = ddim_schedule(dataclasses.replace(c, num_inference_steps=steps))
        one = np.float32(1.0)

        @torch.no_grad()
        def sample(context: Tensor, uncond_context: Tensor, latents: Tensor) -> Tensor:
            B = context.shape[0]
            lat = latents.float()
            ctx = torch.cat([uncond_context, context]).float()
            for i in range(steps):
                t = int(timesteps[i])
                t_prev = int(timesteps[i + 1]) if i + 1 < steps else -1
                tvec = torch.full((2 * B,), float(t), dtype=torch.float32, device=lat.device)
                eps_u, eps_c = self._apply("unet", torch.cat([lat, lat]), tvec, ctx).chunk(2)
                eps = eps_u + guidance * (eps_c - eps_u)
                a_t = ac[t]
                a_prev = ac[t_prev] if t_prev >= 0 else one
                x0 = (lat - float(np.sqrt(one - a_t)) * eps) / float(np.sqrt(a_t))
                lat = float(np.sqrt(a_prev)) * x0 + float(np.sqrt(one - a_prev)) * eps
            images = self._apply("vae_dec", lat / c.vae_scale)
            # uint8 out, as the JAX sampler returns (the generations are
            # 8-bit images before any downstream use)
            x01 = torch.clamp((images + 1.0) / 2.0, 0.0, 1.0)
            return (x01 * 255.0 + 0.5).to(torch.uint8)

        return sample

    def initial_latents(self, batch: int, seed: int) -> Tensor:
        """Standard normal latents ``[B, h, w, C]`` drawn per (seed, B)."""
        c = self.config
        g = torch.Generator(device=self.device).manual_seed(mixed_seed(seed, batch))
        shape = (batch, self.latent_size, self.latent_size, c.latent_channels)
        return torch.randn(shape, generator=g, device=self.device, dtype=torch.float32)

    def generate_image(
        self,
        prompt: str,
        num_images: int = 1,
        seed: int = 0,
        num_inference_steps: Optional[int] = None,
        guidance_scale: Optional[float] = None,
        **_,
    ) -> List[np.ndarray]:
        """[H, W, 3] arrays in [0, 1]; all num_images in one batched
        denoising loop."""
        return self.generate_images_batch([prompt], num_images, seed, num_inference_steps, guidance_scale)[0]

    def generate_images_batch(
        self,
        prompts: Sequence[str],
        num_images: int = 1,
        seed: int = 0,
        num_inference_steps: Optional[int] = None,
        guidance_scale: Optional[float] = None,
        latents: Optional[Tensor] = None,
    ) -> List[List[np.ndarray]]:
        """``latents``: the initial latents ``[P * num_images, h, w, C]``
        (default: :meth:`initial_latents` of (seed, P * num_images))."""
        c = self.config
        P = len(prompts)
        ctx = self._text_encoder(list(prompts))  # [P, L, D]
        uncond = self._text_encoder([""] * P)
        ctx = ctx.repeat_interleave(num_images, dim=0)  # [P*N, L, D]
        uncond = uncond.repeat_interleave(num_images, dim=0)
        B = P * num_images
        sample = self.sampler(num_inference_steps, guidance_scale)
        if latents is None:
            latents = self.initial_latents(B, seed)
        images = sample(ctx, uncond, torch.as_tensor(latents, device=self.device))
        images = (images.cpu().numpy().astype(np.float32) / 255.0).reshape(
            P, num_images, c.image_size, c.image_size, 3
        )
        self.stats["images_generated"] += B
        self.stats["batches"] += 1
        return [list(images[p]) for p in range(P)]

    # -- VAE ---------------------------------------------------------------------
    @torch.no_grad()
    def encode_image(self, images, seed: int = 0, noise: Optional[Tensor] = None) -> Tensor:
        """images [B, H, W, 3] in [0, 1] -> latents [B, h, w, 4]; ``noise``
        (default: standard normal from a generator seeded with ``seed``)
        samples the posterior."""
        x = torch.as_tensor(np.asarray(images, np.float32), device=self.device) * 2.0 - 1.0
        if x.ndim == 3:
            x = x[None]
        mean, logvar = self._apply("vae_enc", x)
        if noise is None:
            g = torch.Generator(device=self.device).manual_seed(int(seed))
            noise = torch.randn(mean.shape, generator=g, device=self.device)
        return (mean + torch.exp(0.5 * logvar) * torch.as_tensor(noise, device=self.device)) * self.config.vae_scale

    @torch.no_grad()
    def decode_latents(self, latents) -> Tensor:
        images = self._apply("vae_dec", torch.as_tensor(latents, device=self.device).float() / self.config.vae_scale)
        return torch.clamp((images + 1.0) / 2.0, 0.0, 1.0)

    def save_image(self, image: np.ndarray, path: str) -> None:
        from PIL import Image

        Image.fromarray((np.asarray(image) * 255).astype(np.uint8)).save(path)

    def get_stats(self) -> Dict[str, int]:
        return dict(self.stats)
