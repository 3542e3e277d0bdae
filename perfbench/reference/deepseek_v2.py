"""Plain reference of the DeepSeek-V2 decoder under the w8 scheme: every
matrix but the router quantized to int8 symmetrically per output channel
(per expert too) and dequantized to f32; the router's weights as given, in
f32. Activations, RMSNorm, the YaRN rotary embedding on interleaved pairs,
multi-head latent attention in its decompressed form, the dense and the
expert MLPs (every routed expert a loop), the final norm and the untied
head in f32 with TF32 off. ``bits=4`` quantizes the same weights to int4:
the control.

The configuration is a dict with the published ``config.json`` keys; the
weights come from ``part(name)``, one part at a time (``"embed"``,
``"layer_i"``, ``"ln_f"``, ``"lm_head"``), named as the program names them
(gate and up merged along the output). :meth:`DeepseekV2.logits` runs whole
sequences, one at a time, without a cache or batching; it dequantizes one
layer at a time and runs every sequence through it before the next, so it
holds one layer's f32 weights (about 2.3 GB at DeepSeek-V2-Lite). Nothing
here imports the program.

:class:`CutQwenBPE` is the tokenizer the configuration assumes: Qwen2's
byte-level BPE without the merges whose result has an id of 100,000 or
more and without added tokens, a BOS (100,000) opening every prompt and the
EOS 100,001."""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import Tensor

from perfbench.reference.tokenizers import QwenBPE

BOS, EOS = 100000, 100001


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dequant(w: Tensor, bits: int) -> Tensor:
    """Symmetric quantization per output channel of ``w [..., K, N]`` and
    back, f32."""
    qmax = torch.tensor(float(2 ** (bits - 1) - 1), device=w.device)
    wf = w.float()
    scale = wf.abs().amax(dim=-2, keepdim=True).clamp(min=1e-12) / qmax
    return torch.clamp(torch.round(wf / scale), -qmax, qmax) * scale


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(cfg: Dict) -> Tensor:
    """The published ``DeepseekV2YarnRotaryEmbedding`` frequencies."""
    rs = cfg["rope_scaling"]
    dim, base = cfg["qk_rope_head_dim"], cfg["rope_theta"]
    orig = rs["original_max_position_embeddings"]

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    low, high = max(math.floor(corr(rs["beta_fast"])), 0), min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    inter = 1.0 / (rs["factor"] * base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    mask = 1.0 - ((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
    return inter * (1 - mask) + extra * mask


class DeepseekV2:
    def __init__(self, cfg: Dict, part: Callable[[str], Dict[str, Tensor]], bits: int = 8, device=None):
        no_tf32()
        self.cfg, self.part, self.bits = cfg, part, bits
        self.device = device
        rs = cfg["rope_scaling"]
        self.nh = cfg["num_attention_heads"]
        self.dn, self.dr, self.dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
        self.r = cfg["kv_lora_rank"]
        self.eps = cfg["rms_norm_eps"]
        m = yarn_mscale(rs["factor"], rs["mscale_all_dim"])
        self.scale = (self.dn + self.dr) ** -0.5 * m * m
        self.rope_m = yarn_mscale(rs["factor"], rs["mscale"]) / m
        self.inv_freq = yarn_inv_freq(cfg)
        #: per MoE layer, per sequence: (top-k ids [T, k], probabilities [T, E])
        self.routes: Dict[int, List] = {}

    def rms(self, x: Tensor, s: Tensor) -> Tensor:
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) * s.float()

    def rope(self, x: Tensor, pos: Tensor) -> Tensor:
        """x [T, heads, rope]: de-interleave, then rotate-half."""
        T, h, d = x.shape
        x = x.view(T, h, d // 2, 2).transpose(3, 2).reshape(T, h, d)
        freqs = pos[:, None].float() * self.inv_freq.to(x.device)
        emb = torch.cat([freqs, freqs], dim=-1)
        cos, sin = (emb.cos() * self.rope_m)[:, None], (emb.sin() * self.rope_m)[:, None]
        rot = torch.cat([-x[..., d // 2 :], x[..., : d // 2]], dim=-1)
        return x * cos + rot * sin

    def _weights(self, name: str) -> Dict[str, Tensor]:
        out = {}
        for k, v in self.part(name).items():
            v = v.to(self.device) if self.device is not None else v
            key = k.split(".", 1)[1] if "." in k else k
            if v.ndim >= 2 and not key.endswith("router.kernel"):
                out[key] = dequant(v, self.bits)
            else:
                out[key] = v.float()
        return out

    def attention(self, w: Dict[str, Tensor], h: Tensor, pos: Tensor) -> Tensor:
        T = h.shape[0]
        nh, dn, dr, dv, r = self.nh, self.dn, self.dr, self.dv, self.r
        q = (h @ w["attn.q.kernel"]).view(T, nh, dn + dr)
        a = h @ w["attn.kv_a.kernel"]
        c = self.rms(a[:, :r], w["attn.kv_norm.scale"])
        kv = (c @ w["attn.kv_b.kernel"]).view(T, nh, dn + dv)
        q_pe = self.rope(q[..., dn:], pos)
        k_pe = self.rope(a[:, None, r:], pos).expand(T, nh, dr)
        qf = torch.cat([q[..., :dn], q_pe], dim=-1)
        kf = torch.cat([kv[..., :dn], k_pe], dim=-1)
        att = torch.einsum("thd,shd->hts", qf, kf) * self.scale
        att = att + torch.full((T, T), float("-inf"), device=h.device).triu(1)
        o = torch.einsum("hts,shd->thd", torch.softmax(att, dim=-1), kv[..., dn:]).reshape(T, nh * dv)
        return o @ w["attn.o.kernel"]

    @staticmethod
    def mlp(h: Tensor, gate_up: Tensor, down: Tensor) -> Tensor:
        n = gate_up.shape[-1] // 2
        return (F.silu(h @ gate_up[..., :n]) * (h @ gate_up[..., n:])) @ down

    def moe(self, w: Dict[str, Tensor], h: Tensor, layer: int) -> Tensor:
        cfg = self.cfg
        probs = torch.softmax(h @ w["moe.router.kernel"], dim=-1)
        topv, topi = torch.topk(probs, cfg["num_experts_per_tok"], dim=-1)
        self.routes.setdefault(layer, []).append((topi, probs))
        topv = topv * cfg["routed_scaling_factor"]
        y = torch.zeros_like(h)
        gu, dn = w["moe.experts.gate_up.kernel"], w["moe.experts.down.kernel"]
        for e in range(cfg["n_routed_experts"]):
            rows, slot = torch.nonzero(topi == e, as_tuple=True)
            if rows.numel():
                y[rows] += topv[rows, slot][:, None] * self.mlp(h[rows], gu[e], dn[e])
        return y + self.mlp(h, w["moe.shared.gate_up.kernel"], w["moe.shared.down.kernel"])

    @torch.no_grad()
    def logits(self, seqs: List[List[int]]) -> List[Tensor]:
        """f32 logits ``[T, vocab]`` of a causal forward over each id list."""
        cfg = self.cfg
        emb = self._weights("embed")["embedding"]
        xs = [emb[torch.as_tensor(ids, device=emb.device)] for ids in seqs]
        del emb
        for i in range(cfg["num_hidden_layers"]):
            w = self._weights(f"layer_{i}")
            for j, x in enumerate(xs):
                pos = torch.arange(x.shape[0], device=x.device)
                x = x + self.attention(w, self.rms(x, w["ln_attn.scale"]), pos)
                h = self.rms(x, w["ln_mlp.scale"])
                if i < cfg["first_k_dense_replace"]:
                    x = x + self.mlp(h, w["mlp.gate_up.kernel"], w["mlp.down.kernel"])
                else:
                    x = x + self.moe(w, h, i)
                xs[j] = x
            del w
        ln_f = self._weights("ln_f")["scale"]
        head = self._weights("lm_head")["kernel"]
        return [self.rms(x, ln_f) @ head for x in xs]


def route_agreement(prog_topi: Tensor, ref_topi: Tensor, ref_probs: Tensor, margin: float = 1e-6) -> Optional[int]:
    """The first token whose top-k set differs from the reference's while
    the reference's k-th and (k+1)-th probabilities differ by more than
    ``margin``; None where every such token agrees."""
    k = ref_topi.shape[-1]
    srt = torch.sort(ref_probs, dim=-1, descending=True).values
    clear = (srt[:, k - 1] - srt[:, k]) > margin
    for t in range(ref_topi.shape[0]):
        if clear[t] and set(prog_topi[t].tolist()) != set(ref_topi[t].tolist()):
            return t
    return None


class CutQwenBPE(QwenBPE):
    """Qwen2's byte-level BPE cut below id ``BOS``; ``prompt(text)`` is
    ``[BOS] + encode(text)``."""

    def __init__(self):
        super().__init__()
        self.ranks = {p: r for p, r in self.ranks.items() if self.encoder.get(p[0] + p[1], BOS) < BOS}
        self.added = {}
        self._split = re.compile("((?!))")
        self.eos = EOS

    def prompt(self, text: str) -> List[int]:
        return [BOS] + self.encode(text)
