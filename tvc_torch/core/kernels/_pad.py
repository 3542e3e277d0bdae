"""Zero-padding of a kernel's operands to the widths its tiles take.

A wrapper whose kernel reads 16-byte rows (the GEMMs, ``bank_topk``)
pads a width off that grain with zeros, which change no product, and
slices the padded columns off the output. Each padded operand and each
sliced output is a copy, counted in the wrapper's ``copies``.
"""

from __future__ import annotations

from typing import Sequence

from torch import Tensor


def padded(t: Tensor, shape: Sequence[int], owner) -> Tensor:
    """``t`` zero-padded at the end of each dimension to ``shape``: a copy,
    counted in ``owner.copies``; ``t`` itself when it has that shape."""
    if tuple(t.shape) == tuple(shape):
        return t
    out = t.new_zeros(tuple(shape))
    out[tuple(slice(0, n) for n in t.shape)] = t
    owner.copies += 1
    return out


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m
