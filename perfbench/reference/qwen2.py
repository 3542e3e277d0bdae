"""Plain reference of the Qwen2 decoder under the w8 scheme the
configuration states: the bf16 weights of every matrix (the tied embedding
too) quantized to int8 symmetrically per output channel, dequantized to
f32; activations, RMSNorm, rotary embedding (rotate-half, theta from the
config), grouped-query causal attention, SiLU-gated MLP and the tied head in
f32 with TF32 off. ``bits=4`` quantizes the same weights to int4: the
control.

The reference runs teacher-forced over a prompt and the tokens the program
served, one sequence at a time, and returns the logits at every served
position. Nothing here imports the program."""

from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch import Tensor

from perfbench.reference.clip_int8 import no_tf32

#: the paraphrase prompt of the pipeline's LLM strategy
PARAPHRASE_PROMPT = (
    "Rewrite the following sentence with the same meaning but different "
    "wording.\nSentence: {text}\nRewrite:"
)


def dequant(w: Tensor, bits: int) -> Tensor:
    """Per-output-channel symmetric quantization of ``w [K, N]`` and back, f32."""
    qmax = float(2 ** (bits - 1) - 1)
    wf = w.float()
    scale = wf.abs().amax(dim=0).clamp(min=1e-12) / qmax
    return torch.clamp(torch.round(wf / scale), -qmax, qmax) * scale


class Qwen2:
    def __init__(self, q: Dict, p: Dict[str, Tensor], bits: int = 8):
        no_tf32()
        self.q, self.bits = q, bits
        self.H = q["hidden_size"]
        self.nh, self.nkv = q["num_attention_heads"], q["num_key_value_heads"]
        self.Dh = self.H // self.nh
        self.eps, self.theta = q["rms_norm_eps"], q["rope_theta"]
        self.p = p
        self.embed = dequant(p["embed.embedding"], bits)  # [V, H], channels of H
        self._layer_cache: Dict[int, Dict[str, Tensor]] = {}

    def _layer(self, i: int) -> Dict[str, Tensor]:
        """Layer i's weights, dequantized (kept: the reference holds the whole
        model in f32, 6 GB at Qwen2-1.5B)."""
        if i not in self._layer_cache:
            p, b = self.p, f"layer_{i}"
            self._layer_cache[i] = {
                "ln_attn": p[f"{b}.ln_attn.scale"], "ln_mlp": p[f"{b}.ln_mlp.scale"],
                **{k: dequant(p[f"{b}.attn.{k}.kernel"], self.bits) for k in "qkvo"},
                **{f"b{k}": p[f"{b}.attn.{k}.bias"] for k in "qkv"},
                **{k: dequant(p[f"{b}.mlp.{k}.kernel"], self.bits) for k in ("gate", "up", "down")},
            }
        return self._layer_cache[i]

    def rms(self, x: Tensor, s: Tensor) -> Tensor:
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) * s

    def rope(self, x: Tensor, pos: Tensor) -> Tensor:
        half = self.Dh // 2
        freqs = 1.0 / (self.theta ** (torch.arange(half, device=x.device, dtype=torch.float32) / half))
        ang = pos[:, None].float() * freqs  # [T, half]
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    @torch.no_grad()
    def logits(self, ids: List[int]) -> Tensor:
        """f32 logits ``[T, vocab]`` of a causal forward over ``ids``."""
        dev = self.embed.device
        ids_t = torch.as_tensor(ids, device=dev)
        T = len(ids)
        pos = torch.arange(T, device=dev)
        x = self.embed[ids_t]
        mask = torch.full((T, T), float("-inf"), device=dev).triu(1)
        R = self.nh // self.nkv
        for i in range(self.q["num_hidden_layers"]):
            w = self._layer(i)
            h = self.rms(x, w["ln_attn"])
            qh = self.rope((h @ w["q"] + w["bq"]).reshape(T, self.nh, self.Dh), pos)
            kh = self.rope((h @ w["k"] + w["bk"]).reshape(T, self.nkv, self.Dh), pos)
            vh = (h @ w["v"] + w["bv"]).reshape(T, self.nkv, self.Dh)
            kh = kh.repeat_interleave(R, dim=1)
            vh = vh.repeat_interleave(R, dim=1)
            att = torch.einsum("thd,shd->hts", qh, kh) / math.sqrt(self.Dh) + mask
            o = torch.einsum("hts,shd->thd", torch.softmax(att, dim=-1), vh).reshape(T, self.H)
            x = x + o @ w["o"]
            h = self.rms(x, w["ln_mlp"])
            x = x + (torch.nn.functional.silu(h @ w["gate"]) * (h @ w["up"])) @ w["down"]
        x = self.rms(x, self.p["ln_f.scale"])
        return x @ self.embed.T


def served_positions(served: List[int], eos: int) -> List[int]:
    """The served tokens up to and with the first end of sequence."""
    out = []
    for t in served:
        out.append(int(t))
        if int(t) == eos:
            break
    return out


def topk_gaps(logits: Tensor, tokens: List[int], k: int) -> Tensor:
    """How far each token's logit lies below the k-th largest of its row
    (0 inside the top k)."""
    kth = torch.topk(logits, k, dim=-1).values[:, -1]
    tok = logits[torch.arange(len(tokens), device=logits.device), torch.as_tensor(tokens, device=logits.device)]
    return (kth - tok).clamp(min=0)


def sample_topk(logits: Tensor, k: int, temperature: float, gen: torch.Generator) -> List[int]:
    """One token a row from the top k at ``temperature`` (Gumbel-max)."""
    v, i = torch.topk(logits, k, dim=-1)
    u = torch.rand(v.shape, generator=gen, device=logits.device).clamp(min=torch.finfo(torch.float32).tiny)
    pick = torch.argmax(v / temperature - torch.log(-torch.log(u)), dim=-1)
    return i.gather(1, pick[:, None])[:, 0].tolist()
