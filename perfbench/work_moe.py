"""Operations and bytes of the DeepSeek-V2 paraphrase decode's own kernels
and of its active-parameter products, counted from the shapes each call
ran at (the H100 peaks and the rules of ``work.py``)."""

from __future__ import annotations

from typing import Tuple

from perfbench.work import Ops, gemm


def expert_gemm(assignments: int, K: int, N: int, busy_experts: int) -> Tuple[Ops, float]:
    """One grouped weight-only GEMM over a layer's routed experts:
    2 x assignments x K x N operations at the bf16 rate; bytes the int8
    weights and f32 scales of every expert that received rows, the bf16
    rows in and the bf16 output out."""
    nbytes = busy_experts * (K * N + 4 * N) + 2 * assignments * (K + N)
    return gemm(assignments, K, N, "bf16"), float(nbytes)


def mla_decode(rows: int, S: int, heads: int = 16, latent: int = 512, rope: int = 64) -> Tuple[Ops, float]:
    """One decode step's latent attention over S cache slots: the logits
    over the 576-wide rows and the weighted latents, bf16 products; bytes
    the latent rows, q_lat and q_pe in and the output out (bf16)."""
    ops = {"bf16": 2.0 * rows * heads * S * (latent + rope + latent)}
    nbytes = 2 * (rows * S * (latent + rope) + rows * heads * (latent + rope) + rows * heads * latent)
    return ops, float(nbytes)


def absorbed(rows: int, heads: int = 16, nope: int = 128, v: int = 128, latent: int = 512) -> Ops:
    """The absorbed up-projections of one decode step (W_UK into the query,
    W_UV out of the latent output), bf16 products."""
    return gemm(rows * heads, nope + v, latent, "bf16")


def router(rows: int, hidden: int, experts: int) -> Ops:
    """The router's f32 logits."""
    return gemm(rows, hidden, experts, "f32")
