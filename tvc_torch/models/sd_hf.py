"""The diffusers-layout Stable Diffusion UNet and VAE (port of
``tvc/models/sd_hf.py``).

The port's native UNet (``tvc_torch/models/sd.py``) is another
architecture, so diffusers checkpoints cannot map onto it. These modules
mirror diffusers' ``UNet2DConditionModel`` and ``AutoencoderKL`` at the
SD-1.5 configuration with the parameter names of the JAX package's flax
mirror, so ``tvc_torch.models.loaders.convert_sd_unet_state_dict`` /
``convert_sd_vae_state_dict`` map a ``runwayml/stable-diffusion-v1-5``
state dict onto them key for key, ``module_tree_from_jax`` takes the flax
trees, and ``StableDiffusionModel(unet=HFUNet(...), vae_enc=...,
vae_dec=...)`` runs them in its DDIM + CFG sampler (``init_params``,
``compute_params`` and ``functional_call`` as for the native modules).

The semantics are the JAX mirror's, which follows diffusers:

* ``ResnetBlock2D``: GN32 (eps 1e-5) -> silu -> conv1 (+ time_emb_proj of
  silu(temb)) -> GN32 -> silu -> conv2, a 1x1 conv_shortcut when the
  channels change;
* ``Transformer2DModel``: GN32 with eps **1e-6** -> 1x1 proj_in ->
  BasicTransformerBlock(s) -> 1x1 proj_out, the residual from the
  *pre-norm* input;
* ``BasicTransformerBlock``: self attention, cross attention and a GEGLU
  feed-forward (proj to 8C, ``hidden * gelu(gate)`` with the gate in f32,
  project 4C -> C), each after a LayerNorm (eps 1e-5) and added back;
  q / k / v without bias, the out projection with. The GELU is flax's
  ``nn.gelu``, the tanh approximation, where diffusers uses the exact erf
  GELU; the port follows the JAX file. SD-1.5's "attention_head_dim = 8"
  means **8 heads**;
* timesteps: [cos | sin] (flip_sin_to_cos=True, downscale_freq_shift=0)
  -> linear_1 -> silu -> linear_2;
* the UNet's Downsample2D: a 3x3 stride-2 convolution with flax's SAME
  padding (none before, one after on even sizes); the VAE encoder's: an
  **asymmetric** (0, 1, 0, 1) pad then a VALID stride-2 convolution;
* Upsample2D: nearest x2, then a 3x3 convolution;
* the VAE mid attention: single-head spatial attention after a
  group_norm, to_q / to_k / to_v / to_out all biased.

NHWC throughout, each convolution run on the channels-last view in its
module's dtype (bf16 at SD-1.5 by default), norms and softmax in f32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor, nn

from tvc_torch.models.sd import Conv, Dense, GroupNorm, LayerNorm, upsample2x


@dataclasses.dataclass(frozen=True)
class HFUNetConfig:
    """Mirror of the UNet2DConditionModel config subset SD-1.x/2.x use."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    #: which down blocks are CrossAttnDownBlock2D (SD-1.5: all but the last)
    cross_attn_blocks: Tuple[bool, ...] = (True, True, True, False)
    attention_heads: int = 8  # SD-1.5 "attention_head_dim": 8 == 8 heads
    cross_attention_dim: int = 768
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16

    @classmethod
    def tiny(cls) -> "HFUNetConfig":
        return cls(
            block_out_channels=(32, 64),
            layers_per_block=1,
            cross_attn_blocks=(True, False),
            attention_heads=2,
            cross_attention_dim=32,
            dtype=torch.float32,
        )


@dataclasses.dataclass(frozen=True)
class HFVAEConfig:
    """Mirror of AutoencoderKL config (SD-1.5 defaults)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_eps: float = 1e-6
    scaling_factor: float = 0.18215
    dtype: Any = torch.bfloat16

    @classmethod
    def tiny(cls) -> "HFVAEConfig":
        return cls(block_out_channels=(32, 64), layers_per_block=1, dtype=torch.float32)


def hf_timestep_embedding(t: Tensor, dim: int) -> Tensor:
    """diffusers Timesteps(flip_sin_to_cos=True, downscale_freq_shift=0):
    [cos | sin], f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _attend(q: Tensor, k: Tensor, v: Tensor, heads: int, dtype) -> Tensor:
    """``[B, Tq, C]`` x ``[B, Tk, C]``: f32 logits of the compute-dtype
    operands over sqrt(head width), f32 softmax, the weights cast to the
    compute dtype, then P.V (the JAX mirror's einsums)."""
    B, _, C = q.shape
    hd = C // heads
    q, k, v = (x.reshape(B, -1, heads, hd).transpose(1, 2) for x in (q, k, v))
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / np.float32(math.sqrt(hd))
    w = torch.softmax(logits, dim=-1).to(dtype)
    return torch.matmul(w, v).transpose(1, 2).reshape(B, -1, C)


class HFResnetBlock(nn.Module):
    """diffusers ResnetBlock2D; ``temb_dim=None`` is the VAE's block (no
    time_emb_proj)."""

    def __init__(self, in_ch: int, out_ch: int, eps: float, dtype, temb_dim: Optional[int] = None, device=None):
        super().__init__()
        self.dtype = dtype
        self.norm1 = GroupNorm(in_ch, torch.float32, device, groups=32, eps=eps)
        self.conv1 = Conv(in_ch, out_ch, 3, dtype=dtype, device=device)
        if temb_dim is not None:
            self.time_emb_proj = Dense(temb_dim, out_ch, dtype, device)
        self.norm2 = GroupNorm(out_ch, torch.float32, device, groups=32, eps=eps)
        self.conv2 = Conv(out_ch, out_ch, 3, dtype=dtype, device=device)
        if in_ch != out_ch:
            self.conv_shortcut = Conv(in_ch, out_ch, 1, dtype=dtype, device=device)

    def forward(self, x: Tensor, temb: Optional[Tensor] = None) -> Tensor:
        h = self.conv1(F.silu(self.norm1(x)).to(self.dtype))
        if hasattr(self, "time_emb_proj") and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = self.conv2(F.silu(self.norm2(h)).to(self.dtype))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class HFCrossAttention(nn.Module):
    """diffusers Attention: to_q / to_k / to_v (no bias) + to_out_0 (bias);
    ``context_dim=None`` is self attention."""

    def __init__(self, channels: int, heads: int, dtype, context_dim: Optional[int] = None, device=None):
        super().__init__()
        kv = channels if context_dim is None else context_dim
        self.heads, self.dtype = heads, dtype
        self.to_q = Dense(channels, channels, dtype, device, bias=False)
        self.to_k = Dense(kv, channels, dtype, device, bias=False)
        self.to_v = Dense(kv, channels, dtype, device, bias=False)
        self.to_out_0 = Dense(channels, channels, dtype, device)

    def forward(self, x: Tensor, context: Optional[Tensor] = None) -> Tensor:
        kv = x if context is None else context
        o = _attend(self.to_q(x), self.to_k(kv), self.to_v(kv), self.heads, self.dtype)
        return self.to_out_0(o)


class HFBasicTransformerBlock(nn.Module):
    def __init__(self, channels: int, heads: int, dtype, context_dim: int, device=None):
        super().__init__()
        C = channels
        self.dtype = dtype
        self.norm1 = LayerNorm(C, device, eps=1e-5)
        self.attn1 = HFCrossAttention(C, heads, dtype, None, device)
        self.norm2 = LayerNorm(C, device, eps=1e-5)
        self.attn2 = HFCrossAttention(C, heads, dtype, context_dim, device)
        self.norm3 = LayerNorm(C, device, eps=1e-5)
        self.ff_net_0_proj = Dense(C, 8 * C, dtype, device)
        self.ff_net_2 = Dense(4 * C, C, dtype, device)

    def forward(self, x: Tensor, context: Tensor) -> Tensor:
        x = x + self.attn1(self.norm1(x).to(self.dtype))
        x = x + self.attn2(self.norm2(x).to(self.dtype), context)
        # GEGLU: proj to 8C, split into (hidden, gate), hidden * gelu(gate)
        hidden, gate = self.ff_net_0_proj(self.norm3(x).to(self.dtype)).chunk(2, dim=-1)
        ff = hidden * F.gelu(gate.float(), approximate="tanh").to(self.dtype)
        return x + self.ff_net_2(ff)


class HFTransformer2D(nn.Module):
    """diffusers Transformer2DModel (use_linear_projection=False); its
    GroupNorm takes eps 1e-6 whatever ``eps`` says, as the JAX mirror's."""

    def __init__(self, channels: int, heads: int, eps: float, dtype, context_dim: int, num_layers: int = 1,
                 device=None):
        super().__init__()
        C = channels
        self.dtype, self.num_layers = dtype, num_layers
        self.norm = GroupNorm(C, torch.float32, device, groups=32, eps=1e-6)
        self.proj_in = Conv(C, C, 1, dtype=dtype, device=device)
        for i in range(num_layers):
            self.add_module(f"transformer_blocks_{i}", HFBasicTransformerBlock(C, heads, dtype, context_dim, device))
        self.proj_out = Conv(C, C, 1, dtype=dtype, device=device)

    def forward(self, x: Tensor, context: Tensor) -> Tensor:
        B, H, W, C = x.shape
        h = self.proj_in(self.norm(x).to(self.dtype)).reshape(B, H * W, C)
        for i in range(self.num_layers):
            h = getattr(self, f"transformer_blocks_{i}")(h, context)
        return self.proj_out(h.reshape(B, H, W, C)) + x


class HFUNet(nn.Module):
    """diffusers UNet2DConditionModel at the SD-1.x layout.

    ``forward(latents [B,h,w,4] NHWC, t [B], context [B,T,ctx]) -> eps`` f32.
    """

    def __init__(self, cfg: HFUNetConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        dt, eps, heads, ctx = c.dtype, c.norm_eps, c.attention_heads, c.cross_attention_dim
        ch0 = c.block_out_channels[0]
        temb = ch0 * 4
        self.time_embedding_linear_1 = Dense(ch0, temb, dt, device)
        self.time_embedding_linear_2 = Dense(temb, temb, dt, device)
        self.conv_in = Conv(c.in_channels, ch0, 3, dtype=dt, device=device)
        x, skips, n = ch0, [ch0], len(c.block_out_channels)
        for bi, ch in enumerate(c.block_out_channels):
            for li in range(c.layers_per_block):
                self.add_module(f"down_blocks_{bi}_resnets_{li}", HFResnetBlock(x, ch, eps, dt, temb, device))
                x = ch
                if c.cross_attn_blocks[bi]:
                    self.add_module(f"down_blocks_{bi}_attentions_{li}",
                                    HFTransformer2D(ch, heads, eps, dt, ctx, device=device))
                skips.append(x)
            if bi < n - 1:
                self.add_module(f"down_blocks_{bi}_downsamplers_0_conv", Conv(ch, ch, 3, 2, dt, device))
                skips.append(ch)
        self.mid_block_resnets_0 = HFResnetBlock(x, x, eps, dt, temb, device)
        self.mid_block_attentions_0 = HFTransformer2D(x, heads, eps, dt, ctx, device=device)
        self.mid_block_resnets_1 = HFResnetBlock(x, x, eps, dt, temb, device)
        for ui, bi in enumerate(reversed(range(n))):
            ch = c.block_out_channels[bi]
            for li in range(c.layers_per_block + 1):
                self.add_module(f"up_blocks_{ui}_resnets_{li}",
                                HFResnetBlock(x + skips.pop(), ch, eps, dt, temb, device))
                x = ch
                if c.cross_attn_blocks[bi]:
                    self.add_module(f"up_blocks_{ui}_attentions_{li}",
                                    HFTransformer2D(ch, heads, eps, dt, ctx, device=device))
            if bi > 0:
                self.add_module(f"up_blocks_{ui}_upsamplers_0_conv", Conv(ch, ch, 3, dtype=dt, device=device))
        self.conv_norm_out = GroupNorm(x, torch.float32, device, groups=32, eps=eps)
        self.conv_out = Conv(x, c.out_channels, 3, dtype=torch.float32, device=device)

    def forward(self, latents: Tensor, t: Tensor, context: Tensor) -> Tensor:
        c = self.cfg
        ch0, n = c.block_out_channels[0], len(c.block_out_channels)
        temb = self.time_embedding_linear_1(hf_timestep_embedding(t, ch0))
        temb = self.time_embedding_linear_2(F.silu(temb))
        context = context.to(c.dtype)
        x = self.conv_in(latents.to(c.dtype))
        skips = [x]
        for bi in range(n):
            for li in range(c.layers_per_block):
                x = getattr(self, f"down_blocks_{bi}_resnets_{li}")(x, temb)
                if c.cross_attn_blocks[bi]:
                    x = getattr(self, f"down_blocks_{bi}_attentions_{li}")(x, context)
                skips.append(x)
            if bi < n - 1:
                x = getattr(self, f"down_blocks_{bi}_downsamplers_0_conv")(x)
                skips.append(x)
        x = self.mid_block_resnets_0(x, temb)
        x = self.mid_block_attentions_0(x, context)
        x = self.mid_block_resnets_1(x, temb)
        for ui, bi in enumerate(reversed(range(n))):
            for li in range(c.layers_per_block + 1):
                x = getattr(self, f"up_blocks_{ui}_resnets_{li}")(torch.cat([x, skips.pop()], dim=-1), temb)
                if c.cross_attn_blocks[bi]:
                    x = getattr(self, f"up_blocks_{ui}_attentions_{li}")(x, context)
            if bi > 0:
                x = getattr(self, f"up_blocks_{ui}_upsamplers_0_conv")(upsample2x(x))
        x = self.conv_out(F.silu(self.conv_norm_out(x)).to(c.dtype))
        return x.float()


class HFVAEAttention(nn.Module):
    """AutoencoderKL mid-block attention: single-head spatial attention
    with group_norm; q / k / v / out all biased."""

    def __init__(self, channels: int, eps: float, dtype, device=None):
        super().__init__()
        C = channels
        self.dtype = dtype
        self.group_norm = GroupNorm(C, torch.float32, device, groups=32, eps=eps)
        self.to_q = Dense(C, C, dtype, device)
        self.to_k = Dense(C, C, dtype, device)
        self.to_v = Dense(C, C, dtype, device)
        self.to_out_0 = Dense(C, C, dtype, device)

    def forward(self, x: Tensor) -> Tensor:
        B, H, W, C = x.shape
        flat = self.group_norm(x).reshape(B, H * W, C).to(self.dtype)
        o = _attend(self.to_q(flat), self.to_k(flat), self.to_v(flat), 1, self.dtype)
        return x + self.to_out_0(o).reshape(B, H, W, C).to(x.dtype)


class HFVAEEncoder(nn.Module):
    """AutoencoderKL.encoder + quant_conv: images -> (mean, logvar)."""

    def __init__(self, cfg: HFVAEConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        dt, eps, chs = c.dtype, c.norm_eps, c.block_out_channels
        self.conv_in = Conv(c.in_channels, chs[0], 3, dtype=dt, device=device)
        x = chs[0]
        for bi, ch in enumerate(chs):
            for li in range(c.layers_per_block):
                self.add_module(f"down_blocks_{bi}_resnets_{li}", HFResnetBlock(x, ch, eps, dt, device=device))
                x = ch
            if bi < len(chs) - 1:
                self.add_module(f"down_blocks_{bi}_downsamplers_0_conv",
                                Conv(ch, ch, 3, 2, dt, device, padding="VALID"))
        self.mid_block_resnets_0 = HFResnetBlock(x, x, eps, dt, device=device)
        self.mid_block_attentions_0 = HFVAEAttention(x, eps, dt, device)
        self.mid_block_resnets_1 = HFResnetBlock(x, x, eps, dt, device=device)
        self.conv_norm_out = GroupNorm(x, torch.float32, device, groups=32, eps=eps)
        self.conv_out = Conv(x, 2 * c.latent_channels, 3, dtype=torch.float32, device=device)
        self.quant_conv = Conv(2 * c.latent_channels, 2 * c.latent_channels, 1, dtype=torch.float32, device=device)

    def forward(self, images: Tensor) -> Tuple[Tensor, Tensor]:
        c = self.cfg
        x = self.conv_in(images.to(c.dtype))
        n = len(c.block_out_channels)
        for bi in range(n):
            for li in range(c.layers_per_block):
                x = getattr(self, f"down_blocks_{bi}_resnets_{li}")(x)
            if bi < n - 1:
                # the VAE's Downsample2D: asymmetric (0, 1, 0, 1) pad, VALID stride 2
                x = getattr(self, f"down_blocks_{bi}_downsamplers_0_conv")(F.pad(x, (0, 0, 0, 1, 0, 1)))
        x = self.mid_block_resnets_0(x)
        x = self.mid_block_attentions_0(x)
        x = self.mid_block_resnets_1(x)
        x = self.conv_out(F.silu(self.conv_norm_out(x)).to(c.dtype))
        mean, logvar = self.quant_conv(x).chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)


class HFVAEDecoder(nn.Module):
    """post_quant_conv + AutoencoderKL.decoder: latents -> images [-1, 1]."""

    def __init__(self, cfg: HFVAEConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        dt, eps = c.dtype, c.norm_eps
        chs = tuple(reversed(c.block_out_channels))
        self.post_quant_conv = Conv(c.latent_channels, c.latent_channels, 1, dtype=torch.float32, device=device)
        self.conv_in = Conv(c.latent_channels, chs[0], 3, dtype=dt, device=device)
        self.mid_block_resnets_0 = HFResnetBlock(chs[0], chs[0], eps, dt, device=device)
        self.mid_block_attentions_0 = HFVAEAttention(chs[0], eps, dt, device)
        self.mid_block_resnets_1 = HFResnetBlock(chs[0], chs[0], eps, dt, device=device)
        x = chs[0]
        for bi, ch in enumerate(chs):
            for li in range(c.layers_per_block + 1):
                self.add_module(f"up_blocks_{bi}_resnets_{li}", HFResnetBlock(x, ch, eps, dt, device=device))
                x = ch
            if bi < len(chs) - 1:
                self.add_module(f"up_blocks_{bi}_upsamplers_0_conv", Conv(ch, ch, 3, dtype=dt, device=device))
        self.conv_norm_out = GroupNorm(x, torch.float32, device, groups=32, eps=eps)
        self.conv_out = Conv(x, c.out_channels, 3, dtype=torch.float32, device=device)

    def forward(self, latents: Tensor) -> Tensor:
        c = self.cfg
        x = self.conv_in(self.post_quant_conv(latents.float()).to(c.dtype))
        x = self.mid_block_resnets_0(x)
        x = self.mid_block_attentions_0(x)
        x = self.mid_block_resnets_1(x)
        n = len(c.block_out_channels)
        for bi in range(n):
            for li in range(c.layers_per_block + 1):
                x = getattr(self, f"up_blocks_{bi}_resnets_{li}")(x)
            if bi < n - 1:
                x = getattr(self, f"up_blocks_{bi}_upsamplers_0_conv")(upsample2x(x))
        x = self.conv_out(F.silu(self.conv_norm_out(x)).to(c.dtype))
        return x.float()
