"""Plain reference of the int8 W8A8 CLIP towers and of the TVC scoring.

Written from the published CLIP ViT-B/32 architecture (pre-LN blocks,
quick_gelu, class-token and EOT pooling, projections) and from the W8A8
scheme the configuration states: every block's four projections quantized
symmetrically per output channel from the f32 weights, activations per row
at run time after each LayerNorm, after attention and after quick_gelu,
products summed exactly, dequantized as ``acc * row_scale * col_scale +
bias``. Everything else is f32 with TF32 off: the patch embedding, the
residual stream, LayerNorm, attention and softmax. ``bits=4`` is the same
function one precision below (int4 weights and activations): the control.

Nothing here imports the program; inputs are the benchmark's own."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def quantize_cols(w: Tensor, bits: int) -> Tuple[Tensor, Tensor]:
    """Symmetric per-output-channel quantization of ``w [K, N]``: integer
    values (as f64) and f32 scales ``[N]``."""
    qmax = float(2 ** (bits - 1) - 1)
    scale = w.float().abs().amax(dim=0).clamp(min=1e-12) / qmax
    return torch.clamp(torch.round(w.float() / scale), -qmax, qmax).double(), scale


def quantize_rows(h: Tensor, bits: int) -> Tuple[Tensor, Tensor]:
    qmax = float(2 ** (bits - 1) - 1)
    scale = h.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) / qmax
    return torch.clamp(torch.round(h / scale), -qmax, qmax).double(), scale


def qlinear(h: Tensor, wq: Tuple[Tensor, Tensor], bias: Tensor, bits: int) -> Tensor:
    """``h [M, K]`` f32 through a quantized weight: exact integer sums in
    f64, dequantized in f32."""
    hq, hs = quantize_rows(h, bits)
    return (hq @ wq[0]).float() * hs * wq[1] + bias


def layernorm(x: Tensor, scale: Tensor, bias: Tensor, eps: float = 1e-5) -> Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * scale + bias


class Tower:
    """One tower's blocks with their quantized weights (made once)."""

    def __init__(self, p: Dict[str, Tensor], prefix: str, layers: int, heads: int, bits: int):
        self.heads, self.bits = heads, bits
        self.blocks = []
        for i in range(layers):
            b = f"{prefix}.transformer.block_{i}"
            self.blocks.append({
                "ln1": (p[f"{b}.ln_1.scale"], p[f"{b}.ln_1.bias"]),
                "qkv": (quantize_cols(p[f"{b}.attn.qkv.kernel"], bits), p[f"{b}.attn.qkv.bias"]),
                "out": (quantize_cols(p[f"{b}.attn.out.kernel"], bits), p[f"{b}.attn.out.bias"]),
                "ln2": (p[f"{b}.ln_2.scale"], p[f"{b}.ln_2.bias"]),
                "fc": (quantize_cols(p[f"{b}.mlp.fc.kernel"], bits), p[f"{b}.mlp.fc.bias"]),
                "proj": (quantize_cols(p[f"{b}.mlp.proj.kernel"], bits), p[f"{b}.mlp.proj.bias"]),
            })

    def __call__(self, x: Tensor, causal: bool) -> Tensor:
        B, T, W = x.shape
        H, bits = self.heads, self.bits
        D = W // H
        keep = torch.ones((T, T), dtype=torch.bool, device=x.device).tril() if causal else None
        for blk in self.blocks:
            h = layernorm(x, *blk["ln1"]).reshape(B * T, W)
            qkv = qlinear(h, *blk["qkv"], bits)
            q, k, v = (t.reshape(B, T, H, D).transpose(1, 2) for t in qkv.split(W, dim=-1))
            logits = (q @ k.transpose(-1, -2)) / math.sqrt(D)
            if keep is not None:
                logits = logits.masked_fill(~keep, float("-inf"))
            attn = (torch.softmax(logits, dim=-1) @ v).transpose(1, 2).reshape(B * T, W)
            x = x + qlinear(attn, *blk["out"], bits).reshape(B, T, W)
            h = layernorm(x, *blk["ln2"]).reshape(B * T, W)
            g = qlinear(h, *blk["fc"], bits)
            g = g * torch.sigmoid(1.702 * g)
            x = x + qlinear(g, *blk["proj"], bits).reshape(B, T, W)
        return x


class ClipInt8:
    """Both towers of a CLIP configuration at ``bits``, from f32 params
    named as the flax tree joins its paths."""

    def __init__(self, c: Dict, p: Dict[str, Tensor], bits: int = 8):
        no_tf32()
        self.c, self.p = c, p
        self.vision = Tower(p, "visual", c["vision_layers"], c["vision_heads"], bits)
        self.text = Tower(p, "text", c["text_layers"], c["text_heads"], bits)

    @torch.no_grad()
    def image_features(self, pixels: Tensor, block: int = 64) -> Tensor:
        """Raw ``[B, H, W, 3]`` pixels in [0, 1] -> L2-normed ``[B, E]``."""
        return torch.cat([self._image(pixels[i : i + block]) for i in range(0, pixels.shape[0], block)])

    def _image(self, pixels: Tensor) -> Tensor:
        c, p = self.c, self.p
        P, W = c["patch_size"], c["vision_width"]
        mean = torch.tensor(CLIP_MEAN, device=pixels.device)
        std = torch.tensor(CLIP_STD, device=pixels.device)
        x = (pixels.float() - mean) / std
        B, Hh, Ww, C = x.shape
        gh, gw = Hh // P, Ww // P
        x = x[:, : gh * P, : gw * P].reshape(B, gh, P, gw, P, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, gh * gw, P * P * C) @ p["visual.patch_embed.kernel"].reshape(P * P * C, W)
        cls = p["visual.class_embedding"].expand(B, 1, W)
        x = torch.cat([cls, x], dim=1) + p["visual.positional_embedding"]
        x = layernorm(x, p["visual.ln_pre.scale"], p["visual.ln_pre.bias"])
        x = self.vision(x, causal=False)
        x = layernorm(x[:, 0], p["visual.ln_post.scale"], p["visual.ln_post.bias"]) @ p["visual.proj"]
        return l2n(x)

    @torch.no_grad()
    def text_features(self, tokens: Tensor, block: int = 256) -> Tensor:
        """``[N, T]`` token ids (EOT the highest id) -> L2-normed ``[N, E]``."""
        return torch.cat([self._text(tokens[i : i + block]) for i in range(0, tokens.shape[0], block)])

    def _text(self, tokens: Tensor) -> Tensor:
        p = self.p
        T = tokens.shape[1]
        x = p["text.token_embedding.embedding"][tokens] + p["text.positional_embedding"][:T]
        x = self.text(x, causal=True)
        x = layernorm(x, p["text.ln_final.scale"], p["text.ln_final.bias"])
        x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
        return l2n(x @ p["text.text_projection"])


def l2n(x: Tensor, eps: float = 1e-12) -> Tensor:
    return x / torch.clamp(torch.sqrt((x * x).sum(-1, keepdim=True)), min=eps)


def bucket_tokens(tok: np.ndarray, bucket: Optional[int], eot: int) -> np.ndarray:
    """The serving text window: with a fixed ``bucket`` (rounded up to 8)
    rows whose EOT lies past it are cut with EOT pinned at its last slot;
    without one, the smallest multiple of 8 that holds every EOT."""
    real = int(tok.argmax(-1).max()) + 1
    if bucket is None:
        return tok[:, : min(-(-real // 8) * 8, tok.shape[1])]
    T = min(-(-bucket // 8) * 8, tok.shape[1])
    tok = tok.copy()
    tok[tok.argmax(-1) >= T, T - 1] = eot
    return tok[:, :T]


def encode_texts(model: ClipInt8, bpe, texts: Sequence[str], bucket: Optional[int], device) -> Dict[str, Tensor]:
    """Features of each distinct text, keyed by the text."""
    uniq = list(dict.fromkeys(texts))
    tok = bucket_tokens(bpe(uniq), bucket, bpe.eot)
    feats = model.text_features(torch.as_tensor(tok, device=device))
    return {t: feats[i] for i, t in enumerate(uniq)}


# -- the TVC primary-stack scoring ------------------------------------------------


def tvc_scores(img: Tensor, txt: Tensor, var: Tensor, vmask: Tensor, refs: Tensor,
               weights=(0.4, 0.4, 0.2), threshold: float = 0.5) -> Dict[str, Tensor]:
    """The weighted-mean TVC decision over unit features: ``img``, ``txt``
    ``[B, D]``, ``var`` ``[B, V, D]`` with ``vmask`` ``[B, V]``, ``refs``
    ``[B, R, D]`` (all present). Text-variant score ``1 - (0.7 (1 - |orig -
    mean|) + 0.3 (1 - std))`` (0 and absent without variants), reference
    score ``1 - mean cos``, global ``1 - orig``; population std."""
    img, txt, var, refs = l2n(img), l2n(txt), l2n(var), l2n(refs)
    orig = (img * txt).sum(-1)
    vs = torch.einsum("bd,bvd->bv", img, var)
    rs = torch.einsum("bd,brd->br", img, refs)
    m = vmask.float()
    cnt = m.sum(-1)
    has = cnt > 0
    mean = (vs * m).sum(-1) / cnt.clamp(min=1)
    var_ = ((vs - mean[:, None]).square() * m).sum(-1) / cnt.clamp(min=1)
    std = torch.sqrt(var_.clamp(min=0))
    mean, std = torch.where(has, mean, 0 * mean), torch.where(has, std, 0 * std)
    tv = torch.where(has, 1 - (0.7 * (1 - (orig - mean).abs()) + 0.3 * (1 - std)), 0 * orig)
    sd = 1 - rs.mean(-1)
    gc = 1 - orig
    w = torch.tensor(weights, dtype=torch.float32, device=img.device)
    present = torch.stack([has.float(), torch.ones_like(orig), torch.ones_like(orig)], -1)
    ww = w * present
    agg = (torch.stack([tv, sd, gc], -1) * ww).sum(-1) / ww.sum(-1)
    return {"tv_score": tv, "sd_score": sd, "consistency_score": gc, "aggregated": agg,
            "orig_similarity": orig, "variant_mean": mean, "variant_std": std, "is_adversarial": agg > threshold}


SCORE_KEYS = ("tv_score", "sd_score", "consistency_score", "aggregated", "orig_similarity",
              "variant_mean", "variant_std")


def bank_sims(bank: Tensor, txt: Tensor, block: int = 16384) -> Tensor:
    """Cosines of unit text features ``[B, D]`` with every bank row
    (normalized here), f32 ``[B, N]``."""
    out = []
    for i in range(0, bank.shape[0], block):
        rows = bank[i : i + block]
        out.append(txt @ (rows / rows.norm(dim=-1, keepdim=True).clamp(min=1e-8)).T)
    return torch.cat(out, dim=1)


def unit_bank_rows(bank: Tensor, idx: Tensor) -> Tensor:
    rows = bank[idx]
    return rows / rows.norm(dim=-1, keepdim=True).clamp(min=1e-8)


def topk_gap(sims: Tensor, chosen: Tensor, r: int) -> Tensor:
    """Per row: how far the worst of the ``r`` chosen bank rows lies below
    the ``r``-th best cosine (0 when the choice is the exact top-r)."""
    kth = torch.topk(sims, r, dim=-1).values[:, -1]
    worst = torch.gather(sims, 1, chosen[:, :r].long()).min(dim=-1).values
    return (kth - worst).clamp(min=0)


def judge_rows(model: ClipInt8, bpe, bank: Tensor, pixels: Tensor, texts: List[str],
               variants: List[List[str]], V: int, out: Dict[str, np.ndarray], chosen: np.ndarray,
               R: int, bucket: Optional[int], threshold: float, score_limit: float) -> Dict[str, float]:
    """Hold the program's answers for some rows against the reference.

    ``out``: the program's per-row scores (those of ``SCORE_KEYS`` its
    entry point returns, and the flags);
    ``chosen``: the bank rows it retrieved (its top-k by the text feature,
    first R scored). Returns the widest score gap, the widest top-k gap and
    the flags that differ where the reference's aggregated score lies more
    than ``score_limit`` from the threshold."""
    dev = bank.device
    B = len(texts)
    img = model.image_features(pixels.to(dev))
    feats = encode_texts(model, bpe, list(texts) + [v for vl in variants for v in vl], bucket, dev)
    txt = torch.stack([feats[t] for t in texts])
    D = txt.shape[1]
    var = torch.zeros((B, max(V, 1), D), device=dev)
    vmask = torch.zeros((B, max(V, 1)), dtype=torch.bool, device=dev)
    for b, vl in enumerate(variants):
        for j, v in enumerate(vl[:V]):
            var[b, j], vmask[b, j] = feats[v], True
    chosen_t = torch.as_tensor(chosen, device=dev).long()
    sims = bank_sims(bank, txt)
    tk = topk_gap(sims, chosen_t, R)
    ref = tvc_scores(img, txt, var, vmask, unit_bank_rows(bank, chosen_t[:, :R]), threshold=threshold)
    gaps = [np.abs(np.asarray(out[k], np.float64) - ref[k].double().cpu().numpy()) for k in SCORE_KEYS if k in out]
    ref_agg = ref["aggregated"].double().cpu().numpy()
    clear = np.abs(ref_agg - threshold) > score_limit
    flips = int(np.sum((np.asarray(out["is_adversarial"], bool) != ref["is_adversarial"].cpu().numpy()) & clear))
    return {"score_gap": float(max(g.max() for g in gaps)), "topk_gap": float(tk.max().item()),
            "flag_flips": float(flips)}


def answer_rows(model: ClipInt8, bpe, bank: Tensor, pixels: Tensor, texts: List[str],
                variants: List[List[str]], V: int, R: int, K: int, bucket: Optional[int],
                threshold: float) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """What a detector built on ``model`` answers for these rows: the
    scores and the top-K bank rows by the text feature (ties to the lower
    index). Run at ``bits=4`` in the program's place, it is the control."""
    dev = bank.device
    B = len(texts)
    img = model.image_features(pixels.to(dev))
    feats = encode_texts(model, bpe, list(texts) + [v for vl in variants for v in vl], bucket, dev)
    txt = torch.stack([feats[t] for t in texts])
    var = torch.zeros((B, max(V, 1), txt.shape[1]), device=dev)
    vmask = torch.zeros((B, max(V, 1)), dtype=torch.bool, device=dev)
    for b, vl in enumerate(variants):
        for j, v in enumerate(vl[:V]):
            var[b, j], vmask[b, j] = feats[v], True
    sims = bank_sims(bank, txt)
    idx = torch.topk(sims, K, dim=-1).indices
    out = tvc_scores(img, txt, var, vmask, unit_bank_rows(bank, idx[:, :R]), threshold=threshold)
    return {k: v.cpu().numpy() for k, v in out.items()}, idx.cpu().numpy()


def judge_answers(model: ClipInt8, bpe, bank: Tensor, pixels: Tensor, texts: List[str], agg: np.ndarray,
                  flags: np.ndarray, R: int, bucket: Optional[int], threshold: float, score_limit: float,
                  tie: float) -> Dict[str, float]:
    """Hold answers that carry only the aggregated score and the flag (the
    serving runtime's, no variants) against the reference. Which R bank
    rows were scored is not returned, so each answer is held against every
    admissible choice: any R rows whose cosines lie within ``tie`` of the
    reference's R-th best; the score gap of a row is its least over them."""
    from itertools import combinations

    dev = bank.device
    img = model.image_features(pixels.to(dev))
    feats = encode_texts(model, bpe, texts, bucket, dev)
    txt = torch.stack([feats[t] for t in texts])
    sims = bank_sims(bank, txt)
    top_v, top_i = torch.topk(sims, R + 6, dim=-1)
    orig = (img * txt).sum(-1)
    gaps, ref_agg = [], []
    w = torch.tensor([0.4, 0.2], dtype=torch.float32, device=dev)
    for b in range(len(texts)):
        ok = top_i[b][top_v[b] >= top_v[b, R - 1] - tie]
        cands = unit_bank_rows(bank, ok)
        best, first = float("inf"), None
        for combo in combinations(range(len(ok)), R):
            sd = 1 - (cands[list(combo)] @ img[b]).mean()
            a = float(((torch.stack([sd, 1 - orig[b]]) * w).sum() / w.sum()).item())
            first = a if first is None else first
            best = min(best, abs(float(agg[b]) - a))
        gaps.append(best)
        ref_agg.append(first)
    ref_agg = np.asarray(ref_agg)
    clear = np.abs(ref_agg - threshold) > score_limit
    flips = int(np.sum((np.asarray(flags, bool) != (ref_agg > threshold)) & clear))
    return {"score_gap": float(max(gaps)) if gaps else 0.0, "flag_flips": float(flips)}
