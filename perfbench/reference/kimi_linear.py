"""Plain reference of the Kimi-Linear decoder under the w8 scheme: every
matrix but the router and the short convolutions' taps quantized to int8
symmetrically per output channel (per expert too) and dequantized to f32;
the router, its correction bias, the taps, ``A_log``, ``dt_bias`` and the
norms as given. Everything in f32 with TF32 off, over whole sequences with
no cache and no batching: Kimi Delta Attention (KDA) token by token, the
latent layers' attention decompressed and without rotation (NoPE), the
dense and the expert MLPs (every routed expert a loop, chosen by sigmoid +
correction bias, weighted by the unbiased sigmoids renormalised, times
``routed_scaling_factor``), the final norm and the untied head. ``bits=4``
quantizes the same weights to int4: the control.

The equations are the published ``modeling_kimi.py`` and
flash-linear-attention's ``fused_recurrent_kda`` (q and k L2-normed with
epsilon 1e-6, q times ``d^-1/2``; ``S <- Diag(exp g) S``, ``S <- S + beta
k (v - S^T k)^T``, ``o = S^T q``; the output's RMSNorm per head times
``sigmoid`` of the output gate). Departures from the published code: the
three convolutions' taps are one ``[3 nh d, K]`` tensor; gate and up one
matrix. Neither changes the function.

The configuration is a dict with the published ``config.json`` keys; the
weights come from ``part(name)``, one part at a time, named as the program
names them. :meth:`KimiLinear.logits` dequantizes one layer at a time and
runs every sequence through it before the next, so it holds one layer's
f32 weights (about 7.3 GB for a layer of 256 experts). Nothing here imports
the program.

:class:`KimiQwenBPE` is the tokenizer the configuration assumes: Qwen2's
byte-level BPE whole, without added tokens, a BOS (163,584) opening every
prompt and the EOS 163,585."""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import Tensor

from perfbench.reference.deepseek_v2 import dequant, no_tf32
from perfbench.reference.tokenizers import QwenBPE

BOS, EOS = 163584, 163585
L2_EPS = 1e-6


class KimiLinear:
    def __init__(self, cfg: Dict, part: Callable[[str], Dict[str, Tensor]], bits: int = 8, device=None):
        no_tf32()
        self.cfg, self.part, self.bits, self.device = cfg, part, bits, device
        la = cfg["linear_attn_config"]
        self.kda_layers = {i - 1 for i in la["kda_layers"]}
        self.kh, self.d, self.K = la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]
        self.nh = cfg["num_attention_heads"]
        self.dn, self.dr, self.dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
        self.r = cfg["kv_lora_rank"]
        self.eps = cfg["rms_norm_eps"]
        self.scale = (self.dn + self.dr) ** -0.5
        self.route_gap = 0.0
        self.routes: Dict[int, List[Tensor]] = {}

    def rms(self, x: Tensor, s: Tensor) -> Tensor:
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) * s.float()

    def _weights(self, name: str) -> Dict[str, Tensor]:
        out = {}
        for k, v in self.part(name).items():
            v = v.to(self.device) if self.device is not None else v
            key = k.split(".", 1)[1] if "." in k else k
            if v.ndim >= 2 and not key.endswith(("router.kernel", "conv.kernel")):
                out[key] = dequant(v, self.bits)
            else:
                out[key] = v.float()
        return out

    def kda(self, w: Dict[str, Tensor], h: Tensor) -> Tensor:
        T = h.shape[0]
        nh, d, K = self.kh, self.d, self.K
        x = torch.cat([h @ w["kda.q.kernel"], h @ w["kda.k.kernel"], h @ w["kda.v.kernel"]], dim=-1)
        C = x.shape[-1]
        conv = F.conv1d(F.pad(x.T[None], (K - 1, 0)), w["kda.conv.kernel"][:, None, :], groups=C)[0].T
        q, k, v = F.silu(conv).view(T, 3, nh, d).unbind(1)
        q = q * torch.rsqrt(q.square().sum(-1, keepdim=True) + L2_EPS) * d ** -0.5
        k = k * torch.rsqrt(k.square().sum(-1, keepdim=True) + L2_EPS)
        f = (h @ w["kda.f_a.kernel"] @ w["kda.f_b.kernel"] + w["kda.dt_bias"]).view(T, nh, d)
        g = -torch.exp(w["kda.a_log"])[:, None] * F.softplus(f)
        beta = torch.sigmoid(h @ w["kda.b.kernel"])
        S = torch.zeros((nh, d, d), dtype=torch.float32, device=h.device)
        out = []
        for t in range(T):
            S = S * torch.exp(g[t])[..., None]
            u = v[t] - torch.einsum("hkv,hk->hv", S, k[t])
            S = S + beta[t][:, None, None] * k[t][..., None] * u[:, None, :]
            out.append(torch.einsum("hkv,hk->hv", S, q[t]))
        gate = (h @ w["kda.g_a.kernel"] @ w["kda.g_b.kernel"]).view(T, nh, d)
        o = self.rms(torch.stack(out), w["kda.o_norm.scale"]) * torch.sigmoid(gate)
        return o.reshape(T, nh * d) @ w["kda.o.kernel"]

    def mla(self, w: Dict[str, Tensor], h: Tensor) -> Tensor:
        T = h.shape[0]
        nh, dn, dr, dv, r = self.nh, self.dn, self.dr, self.dv, self.r
        q = (h @ w["attn.q.kernel"]).view(T, nh, dn + dr)
        a = h @ w["attn.kv_a.kernel"]
        c = self.rms(a[:, :r], w["attn.kv_norm.scale"])
        kv = (c @ w["attn.kv_b.kernel"]).view(T, nh, dn + dv)
        kf = torch.cat([kv[..., :dn], a[:, None, r:].expand(T, nh, dr)], dim=-1)
        att = torch.einsum("thd,shd->hts", q, kf) * self.scale
        att = att + torch.full((T, T), float("-inf"), device=h.device).triu(1)
        o = torch.einsum("hts,shd->thd", torch.softmax(att, dim=-1), kv[..., dn:]).reshape(T, nh * dv)
        return o @ w["attn.o.kernel"]

    def _follow(self, route: Tensor, topc: Tensor, choice: Tensor) -> Tensor:
        """The experts another model chose (``route [T, k]``), in place of
        this one's top k: ``route_gap`` keeps how far below this model's
        k-th choice value the weakest of them lies (0 where they are its own
        top k; a rounding-level near-tie gives a gap of that level)."""
        route = route[: choice.shape[0]].to(choice.device).long()
        below = (topc[:, -1] - choice.gather(1, route).min(dim=-1).values).clamp(min=0)
        self.route_gap = max(self.route_gap, float(below.max()))
        return route

    @staticmethod
    def mlp(h: Tensor, gate_up: Tensor, down: Tensor) -> Tensor:
        n = gate_up.shape[-1] // 2
        return (F.silu(h @ gate_up[..., :n]) * (h @ gate_up[..., n:])) @ down

    def moe(self, w: Dict[str, Tensor], h: Tensor, layer: int, route: Optional[Tensor] = None) -> Tensor:
        cfg = self.cfg
        scores = torch.sigmoid(h @ w["moe.router.kernel"])
        choice = scores + w["moe.router.bias"]
        topc, topi = torch.topk(choice, cfg["num_experts_per_token"], dim=-1)
        self.routes.setdefault(layer, []).append(topi)
        if route is not None:
            topi = self._follow(route, topc, choice)
        topv = scores.gather(1, topi)
        if cfg["moe_renormalize"]:
            topv = topv / (topv.sum(-1, keepdim=True) + 1e-20)
        topv = topv * cfg["routed_scaling_factor"]
        y = torch.zeros_like(h)
        gu, dn = w["moe.experts.gate_up.kernel"], w["moe.experts.down.kernel"]
        for e in range(cfg["num_experts"]):
            rows, slot = torch.nonzero(topi == e, as_tuple=True)
            if rows.numel():
                y[rows] += topv[rows, slot][:, None] * self.mlp(h[rows], gu[e], dn[e])
        return y + self.mlp(h, w["moe.shared.gate_up.kernel"], w["moe.shared.down.kernel"])

    @torch.no_grad()
    def logits(self, seqs: List[List[int]], routes: Optional[List[Dict[int, Tensor]]] = None) -> List[Tensor]:
        """f32 logits ``[T, vocab]`` of a causal forward over each id list.
        ``routes`` (per sequence, per MoE layer, the experts ``[T, k]``
        another model chose): route through them instead, keeping
        ``route_gap`` (:meth:`_follow`). This model's own choices are kept
        in ``routes``, per MoE layer one ``[T, k]`` a sequence."""
        cfg = self.cfg
        emb = self._weights("embed")["embedding"]
        xs = [emb[torch.as_tensor(ids, device=emb.device)] for ids in seqs]
        del emb
        for i in range(cfg["num_hidden_layers"]):
            w = self._weights(f"layer_{i}")
            for j, x in enumerate(xs):
                hn = self.rms(x, w["ln_attn.scale"])
                x = x + (self.kda(w, hn) if i in self.kda_layers else self.mla(w, hn))
                h = self.rms(x, w["ln_mlp.scale"])
                if i < cfg["first_k_dense_replace"]:
                    x = x + self.mlp(h, w["mlp.gate_up.kernel"], w["mlp.down.kernel"])
                else:
                    x = x + self.moe(w, h, i, None if routes is None else routes[j][i])
                xs[j] = x
            del w
        ln_f = self._weights("ln_f")["scale"]
        head = self._weights("lm_head")["kernel"]
        return [self.rms(x, ln_f) @ head for x in xs]


class KimiQwenBPE(QwenBPE):
    """Qwen2's byte-level BPE whole, no added tokens; ``prompt(text)`` is
    ``[BOS] + encode(text)``."""

    def __init__(self):
        super().__init__()
        self.added = {}
        self._split = re.compile("((?!))")
        self.eos = EOS

    def prompt(self, text: str) -> List[int]:
        return [BOS] + self.encode(text)
