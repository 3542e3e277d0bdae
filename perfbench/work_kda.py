"""Operations and bytes of Kimi Delta Attention's own kernels (the
preparation, the recurrence, the gated output norm), counted from the
shapes each call ran at and the tokens it really folded (a right-padded
row's pads excluded: the program's ``kda.token_updates``), with the rules of ``work.py``: each input byte read
once, each output byte written once. The state is counted at the
configuration's f32, read and written once a call for each row that has a
valid token. The kernels run on the CUDA cores in f32."""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from perfbench.work import Ops


def suffix_tokens(prefills: Iterable[Tuple[int, int]]) -> List[int]:
    """Per decode, the real row-tokens of its prompts' suffixes, from
    ``(P, updates)``: its prefix length and the change of the program's
    ``kda.token_updates`` over its readback (the prefix once, then each
    suffix up to its length)."""
    return [u - P for P, u in prefills]


def call_tokens(calls: Iterable[Tuple[int, int, bool]], suffix: List[int], layers: int) -> List[int]:
    """Row-tokens each KDA call folds, ``calls`` ``(B, T, given lengths)``
    in order: ``B T`` where no lengths were given (a prefix, a decode
    step); else its decode's ``suffix`` tokens, ``layers`` such calls (one
    a KDA layer) a decode, the decodes in order."""
    out, k = [], 0
    for B, T, ragged in calls:
        if ragged:
            if k // layers >= len(suffix):
                raise ValueError(f"{k + 1} suffix calls over {layers} layers, but {len(suffix)} decodes read back")
            out.append(suffix[k // layers])
            k += 1
        else:
            out.append(B * T)
    if k != layers * len(suffix):
        raise ValueError(f"{k} suffix calls over {layers} layers, but {len(suffix)} decodes read back")
    return out


def recurrent(B: int, T: int, heads: int, d: int, n: Optional[int] = None) -> Tuple[Ops, float]:
    """The delta rule over ``n`` row-tokens (``B * T`` by default): per
    token and head the decay (d^2), S^T k (2 d^2), the rank-one update
    (2 d^2) and S^T q (2 d^2) in f32. Bytes: the f32 state ``[d, d]`` of
    each head of each row read and written once, q, k, v, g (f32) and beta
    in and o (bf16) out for each token. Every row of the program's calls
    has a valid token, so every row's state is read and written."""
    n = B * T if n is None else n
    ops = {"f32": 7.0 * n * heads * d * d}
    nbytes = 2 * 4 * d * d * heads * B + n * heads * (4 * 4 * d + 4 + 2 * d)
    return ops, float(nbytes)


def prepare(B: int, T: int, heads: int, channels: int, K: int, n: Optional[int] = None) -> Tuple[Ops, float]:
    """The convolution of ``channels`` (q | k | v) over K taps, SiLU, the
    two L2 norms, gate and beta for ``n`` row-tokens. Bytes: the q | k | v
    and beta inputs (bf16) and the gate's (bf16, a third of the channels)
    of each token in, its q, k, v, g and beta (f32) out; each row's window
    (bf16, K - 1 inputs) read and written; the taps, A_log and dt_bias
    (f32) once."""
    n = B * T if n is None else n
    hd = channels // 3
    ops = {"f32": n * (2.0 * K * channels + 4.0 * channels + 8.0 * hd)}
    nbytes = (n * (2 * (channels + heads) + 2 * hd + 4 * (4 * hd + heads))
              + 2 * 2 * (K - 1) * channels * B + 4 * (channels * K + heads + hd))
    return ops, float(nbytes)


def gated_norm(B: int, T: int, heads: int, d: int) -> Tuple[Ops, float]:
    """The output's RMSNorm per head, times the weight and sigmoid(gate),
    on every row-token of the call: o and the gate (bf16) in, the output
    (bf16) out, the weight (f32) once."""
    m = B * T * heads * d
    return {"f32": 6.0 * m}, float(3 * 2 * m + 4 * d)
