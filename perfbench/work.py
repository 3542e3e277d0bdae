"""Operations and bytes of the work the program did, counted from the
shapes each call really ran at, and the published peaks of one H100 SXM
(NVIDIA's data sheet, dense rates, 700 W).

An operation count ``ops`` is a dict ``{operand type: operations}``; its
least time is the sum over types of operations / that type's peak. A
bound is the larger of that and bytes / the memory rate (each input byte
read once, each output byte written once)."""

from __future__ import annotations

from typing import Dict, Tuple

PEAK = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

Ops = Dict[str, float]


def add(*counts: Ops) -> Ops:
    out: Ops = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0.0) + v
    return out


def peak_seconds(ops: Ops) -> float:
    """The least time of ``ops`` at the peak rate of each operand type."""
    return sum(v / PEAK[k] for k, v in ops.items())


def bound_s(ops: Ops, nbytes: float) -> float:
    return max(peak_seconds(ops), nbytes / PEAK_BYTES_PER_S)


def gemm(M: int, K: int, N: int, kind: str) -> Ops:
    return {kind: 2.0 * M * K * N}


# -- CLIP int8 W8A8 layers ------------------------------------------------------------


def i8_attention_layer(B: int, T: int, W: int, heads: int, causal: bool) -> Tuple[Ops, float]:
    """One pre-LN attention sub-block on ``x [B, T, W]`` bf16: int8 QKV and
    out-projection GEMMs, the per-head products on bf16 operands (causal:
    the lower triangle). Bytes: x in, the int8 weights and f32 scales and
    biases in, the output out."""
    M = B * T
    pairs = T * (T + 1) / 2 if causal else T * T
    ops = add(gemm(M, W, 3 * W, "int8"), gemm(M, W, W, "int8"), {"bf16": 2 * 2.0 * B * pairs * W})
    nbytes = 2 * M * W * 2 + (3 * W * W + W * W) + 4 * (3 * W + W) * 2 + 4 * 2 * W
    return ops, nbytes


def i8_mlp_layer(B: int, T: int, W: int, hidden: int) -> Tuple[Ops, float]:
    """One pre-LN MLP sub-block: int8 fc and proj GEMMs."""
    M = B * T
    ops = add(gemm(M, W, hidden, "int8"), gemm(M, hidden, W, "int8"))
    nbytes = 2 * M * W * 2 + 2 * W * hidden + 4 * (hidden + W) * 2 + 4 * 2 * W
    return ops, nbytes


def clip_embed_and_bank(B: int, c: Dict, bank_rows: int, text_rows: int) -> Ops:
    """The detector step's products outside the layers: the patch
    embedding (bf16), both projections (f32) and the bank scores of the
    query texts (f32, TF32 off)."""
    P, W, E = c["patch_size"], c["vision_width"], c["embed_dim"]
    n = (c["image_size"] // P) ** 2
    return add(
        gemm(B * n, P * P * 3, W, "bf16"),
        gemm(B, W, E, "f32"),
        gemm(text_rows, c["text_width"], E, "f32"),
        gemm(B, E, bank_rows, "f32"),
    )


# -- Qwen2 w8 ---------------------------------------------------------------------------


def w8_gemm(M: int, K: int, N: int) -> Tuple[Ops, float]:
    """Weight-only int8 GEMM on bf16 activations: operations at the bf16
    rate; bytes x in, int8 weights and f32 scales in, bf16 output out."""
    return gemm(M, K, N, "bf16"), 2 * (M * K + M * N) + K * N + 4 * N


def gqa_prefill(B: int, T: int, S: int, heads: int, head_dim: int) -> Ops:
    """Causal prefill attention of T new positions over S cached ones (the
    new ones included): logits and weighted values, f32 on bf16 values."""
    pairs = T * (S - T) + T * (T + 1) / 2
    return {"bf16": 2 * 2.0 * B * heads * head_dim * pairs}


def gqa_decode(rows: int, S: int, heads: int, head_dim: int) -> Ops:
    """One decode step's attention over S valid cache slots."""
    return {"bf16": 2 * 2.0 * rows * heads * head_dim * S}


def head(rows: int, hidden: int, vocab: int) -> Ops:
    """The tied head's logits (bf16 table)."""
    return gemm(rows, hidden, vocab, "bf16")

