"""Plain reference of the Nemotron-H decoder under the w8 scheme: every
matrix but the router and the convolution's taps quantized to int8
symmetrically per output channel (per expert too) and dequantized to f32;
the router, its correction bias, the taps and their bias, ``A_log``,
``dt_bias``, ``D`` and the norms as given. Everything in f32 with TF32 off,
over whole sequences with no cache and no batching: the Mamba-2 blocks
token by token, the attention blocks without rotary embedding, the experts
(every routed expert a loop, chosen by sigmoid + correction bias, weighted
by the unbiased sigmoids renormalised, times ``routed_scaling_factor``,
each ``relu(x W_up)^2 W_down``, plus the shared one), the final norm and
the untied head. ``bits=4`` quantizes the same weights to int4: the
control.

The equations are the published ``modeling_nemotron_h.py``'s, one mixer a
block (``hybrid_override_pattern``), ``h += Mix(RMSNorm(h))``: Mamba-2's
``[z | xBC | dt] = x W_in``, ``xBC = SiLU(conv_K(xBC) + b)``, ``dt =
softplus(dt + dt_bias)``, per head ``S <- exp(dt A) S + (dt B) x^T``, ``y =
S C + D x`` (``A = -exp(A_log)``, B and C the head's group's), the gated
norm ``RMSNorm_group(y * SiLU(z)) w`` over groups of ``nh P / groups``
channels, then ``W_out``; grouped-query attention, ``softmax(q k^T /
sqrt(head_dim))``. Departure from the published code: the gated norm
multiplies by its weight in f32 before rounding (the same function in
f32).

The configuration is a dict with the published ``config.json`` keys; the
weights come from ``part(name)``, one part at a time, named as the program
names them. :meth:`NemotronH.logits` dequantizes one block at a time and
runs every sequence through it before the next, so it holds one block's
f32 weights (about 5.1 GB for a block of 128 experts). Nothing here
imports the program.

:class:`NemotronQwenBPE` is the tokenizer the configuration assumes:
Qwen2's byte-level BPE without the merges whose result has an id of
131,070 or more and without added tokens, a BOS (131,070) opening every
prompt and the EOS 131,071."""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import Tensor

from perfbench.reference.deepseek_v2 import dequant, no_tf32
from perfbench.reference.tokenizers import QwenBPE

BOS, EOS = 131070, 131071


def ssm_scan(x: Tensor, b: Tensor, c: Tensor, dt: Tensor, a_log: Tensor, d: Tensor) -> Tensor:
    """The selective scan of one sequence token by token: x ``[T, nh, P]``,
    b and c ``[T, nh, N]`` (each head's group's), dt ``[T, nh]``; returns y
    ``[T, nh, P]``."""
    T, nh, P = x.shape
    A = -torch.exp(a_log)
    S = torch.zeros((nh, P, b.shape[-1]), dtype=torch.float32, device=x.device)
    out = []
    for t in range(T):
        S = S * torch.exp(dt[t] * A)[:, None, None] + (dt[t][:, None] * b[t])[:, None, :] * x[t][:, :, None]
        out.append(torch.einsum("hpn,hn->hp", S, c[t]) + x[t] * d[:, None])
    return torch.stack(out)


class NemotronH:
    def __init__(self, cfg: Dict, part: Callable[[str], Dict[str, Tensor]], bits: int = 8, device=None):
        no_tf32()
        self.cfg, self.part, self.bits, self.device = cfg, part, bits, device
        self.pattern = cfg["hybrid_override_pattern"]
        self.eps = cfg["layer_norm_epsilon"]
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

    def ssm(self, w: Dict[str, Tensor], h: Tensor) -> Tensor:
        cfg = self.cfg
        T = h.shape[0]
        nh, P, N, G = cfg["mamba_num_heads"], cfg["mamba_head_dim"], cfg["ssm_state_size"], cfg["n_groups"]
        K, I = cfg["conv_kernel"], nh * cfg["mamba_head_dim"]
        C = I + 2 * G * N
        proj = h @ w["ssm.in.kernel"]
        z, xbc, dt = proj[:, :I], proj[:, I : I + C], proj[:, I + C :]
        conv = F.conv1d(F.pad(xbc.T[None], (K - 1, 0)), w["ssm.conv.kernel"][:, None, :], w["ssm.conv.bias"],
                        groups=C)[0].T
        xbc = F.silu(conv)
        x = xbc[:, :I].view(T, nh, P)
        b = xbc[:, I : I + G * N].view(T, G, N).repeat_interleave(nh // G, dim=1)
        c = xbc[:, I + G * N :].view(T, G, N).repeat_interleave(nh // G, dim=1)
        dt = F.softplus(dt + w["ssm.dt_bias"])
        y = ssm_scan(x, b, c, dt, w["ssm.a_log"], w["ssm.d"]).reshape(T, I) * F.silu(z)
        g = y.view(T, G, I // G)
        g = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + self.eps)
        return (g.reshape(T, I) * w["ssm.norm.scale"]) @ w["ssm.out.kernel"]

    def attention(self, w: Dict[str, Tensor], h: Tensor) -> Tensor:
        cfg = self.cfg
        T = h.shape[0]
        nh, kv, D = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
        q = (h @ w["attn.q.kernel"]).view(T, nh, D)
        k = (h @ w["attn.k.kernel"]).view(T, kv, D).repeat_interleave(nh // kv, dim=1)
        v = (h @ w["attn.v.kernel"]).view(T, kv, D).repeat_interleave(nh // kv, dim=1)
        att = torch.einsum("thd,shd->hts", q, k) / D ** 0.5
        att = att + torch.full((T, T), float("-inf"), device=h.device).triu(1)
        o = torch.einsum("hts,shd->thd", torch.softmax(att, dim=-1), v).reshape(T, nh * D)
        return o @ w["attn.o.kernel"]

    def _follow(self, route: Tensor, topc: Tensor, choice: Tensor) -> Tensor:
        """The experts another model chose (``route [T, k]``), in place of
        this one's top k: ``route_gap`` keeps how far below this model's
        k-th choice value the weakest of them lies."""
        route = route[: choice.shape[0]].to(choice.device).long()
        below = (topc[:, -1] - choice.gather(1, route).min(dim=-1).values).clamp(min=0)
        self.route_gap = max(self.route_gap, float(below.max()))
        return route

    @staticmethod
    def mlp(h: Tensor, up: Tensor, down: Tensor) -> Tensor:
        return torch.relu(h @ up).square() @ down

    def moe(self, w: Dict[str, Tensor], h: Tensor, index: int, route: Optional[Tensor] = None) -> Tensor:
        """MoE block ``index`` (of the MoE blocks)."""
        cfg = self.cfg
        scores = torch.sigmoid(h @ w["moe.router.kernel"])
        choice = scores + w["moe.router.bias"]
        topc, topi = torch.topk(choice, cfg["num_experts_per_tok"], dim=-1)
        self.routes.setdefault(index, []).append((topi, choice))
        if route is not None:
            topi = self._follow(route, topc, choice)
        topv = scores.gather(1, topi)
        if cfg["norm_topk_prob"]:
            topv = topv / (topv.sum(-1, keepdim=True) + 1e-20)
        topv = topv * cfg["routed_scaling_factor"]
        y = torch.zeros_like(h)
        up, dn = w["moe.experts.up.kernel"], w["moe.experts.down.kernel"]
        for e in range(cfg["n_routed_experts"]):
            rows, slot = torch.nonzero(topi == e, as_tuple=True)
            if rows.numel():
                y[rows] += topv[rows, slot][:, None] * self.mlp(h[rows], up[e], dn[e])
        return y + self.mlp(h, w["moe.shared.up.kernel"], w["moe.shared.down.kernel"])

    @torch.no_grad()
    def logits(self, seqs: List[List[int]], routes: Optional[List[Dict[int, Tensor]]] = None) -> List[Tensor]:
        """f32 logits ``[T, vocab]`` of a causal forward over each id list.
        ``routes``
        (per sequence, per MoE block, the experts ``[T, k]`` another model
        chose): route through them instead, keeping ``route_gap``. This
        model's own choices and choice values are kept in ``routes``."""
        emb = self._weights("embed")["embedding"]
        xs = [emb[torch.as_tensor(ids, device=emb.device)] for ids in seqs]
        del emb
        n_moe = 0
        for i, kind in enumerate(self.pattern):
            w = self._weights(f"layer_{i}")
            for j, x in enumerate(xs):
                hn = self.rms(x, w["ln.scale"])
                if kind == "M":
                    xs[j] = x + self.ssm(w, hn)
                elif kind == "*":
                    xs[j] = x + self.attention(w, hn)
                else:
                    xs[j] = x + self.moe(w, hn, n_moe, None if routes is None else routes[j][n_moe])
            n_moe += kind == "E"
            del w
        ln_f = self._weights("ln_f")["scale"]
        head = self._weights("lm_head")["kernel"]
        return [self.rms(x, ln_f) @ head for x in xs]


class NemotronQwenBPE(QwenBPE):
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
