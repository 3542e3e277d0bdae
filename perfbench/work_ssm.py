"""Operations and bytes of the Mamba-2 blocks' own kernels (the
preparation, the recurrence, the gated norm), of the experts' squared
ReLU and of the attention blocks' decode attention, counted from the shapes each call ran at and the tokens it really
folded (a right-padded row's pads excluded: the program's
``ssm.token_updates``, through ``work_kda``'s ``suffix_tokens`` and
``call_tokens``), with the rules of ``work.py``: each input byte read once,
each output byte written once. The state is counted at the
configuration's f32, read and written once a call for each row that has a
valid token. The SSM kernels run on the CUDA cores in f32."""

from __future__ import annotations

from typing import Optional, Tuple

from perfbench import work
from perfbench.work import Ops


def prepare(B: int, T: int, channels: int, heads: int, K: int, n: Optional[int] = None) -> Tuple[Ops, float]:
    """The convolution of ``channels`` (x | B | C) over K taps, its bias and
    SiLU, and each head's step (softplus) for ``n`` row-tokens (``B * T`` by
    default). Bytes: each token's convolved inputs and step inputs (bf16)
    in, its x | B | C (bf16) and steps (f32) out; each row's window (bf16,
    K - 1 inputs) read and written; the taps, their bias and dt_bias (f32)
    once."""
    n = B * T if n is None else n
    ops = {"f32": n * ((2.0 * K + 5.0) * channels + 4.0 * heads)}
    nbytes = (n * (2 * 2 * channels + (2 + 4) * heads) + 2 * 2 * (K - 1) * channels * B
              + 4 * (channels * (K + 1) + heads))
    return ops, float(nbytes)


def recurrent(B: int, T: int, heads: int, P: int, N: int, groups: int, n: Optional[int] = None) -> Tuple[Ops, float]:
    """The selective scan over ``n`` row-tokens (``B * T`` by default): per
    token and head the decay (P N), dt B (N), its product with x (P N), the
    sum (P N), y = S C (2 P N) and D x (2 P), in f32. Bytes: the f32 state
    ``[P, N]`` of each head of each row read and written once; x, B, C
    (bf16) and the steps (f32) in and y (bf16) out for each token; A_log and
    D once. Every row of the program's calls has a valid token, so every
    row's state is read and written."""
    n = B * T if n is None else n
    ops = {"f32": n * heads * (5.0 * P * N + N + 2.0 * P)}
    nbytes = 2 * 4 * P * N * heads * B + n * (2 * (heads * P + 2 * groups * N) + 4 * heads + 2 * heads * P) \
        + 2 * 4 * heads
    return ops, float(nbytes)


def gated_norm(B: int, T: int, width: int) -> Tuple[Ops, float]:
    """``RMSNorm_group(y * SiLU(z)) w`` on every row-token of the call: y and
    z (bf16) in, the output (bf16) out, the weight (f32) once; per value the
    SiLU (4), the gate (1), its square and sum (2) and the two scalings
    (2)."""
    m = B * T * width
    return {"f32": 9.0 * m}, float(3 * 2 * m + 4 * width)


def relu2(n: int, elem_bytes: int = 2) -> Tuple[Ops, float]:
    """``relu(u)^2`` of ``n`` values: u in, the output out; a comparison and
    a product a value."""
    return {"f32": 2.0 * n}, float(2 * elem_bytes * n)


def gqa_decode(rows: int, S: int, kv: int, R: int, D: int, elem_bytes: int = 2) -> Tuple[Ops, float]:
    """One decode step's grouped-query attention: ``rows`` rows, ``kv`` key /
    value heads of ``R`` query heads each, head width ``D``, over the S
    cache slots the call is given (``work.gqa_decode``'s products at the
    bf16 rate). Bytes: q, the keys and values of the S slots and the f32
    mask in, the output out."""
    nbytes = elem_bytes * (2 * rows * kv * R * D + 2 * rows * kv * S * D) + 4 * rows * S
    return work.gqa_decode(rows, S, kv * R, D), float(nbytes)
