"""A reader of ``flax.serialization.to_bytes`` files, in pure Python.

The JAX package checkpoints parameter trees with flax's msgpack format:
msgpack maps with string keys (lists and tuples become maps keyed "0",
"1", ...), numbers and strings, plus flax's extension types for arrays.
The port loads those files (the trained tiny-CLIP fixtures under
``tvc/assets``) without ``msgpack`` or ``flax``, which the card's machine
does not have:

    tree = read_state_dict(path)  # nested dicts of numpy arrays

A parameter tree's leaves are arrays, flax's extension type 1 (ndarray,
flax/serialization.py ``_MsgpackExtType``): a nested msgpack array
``(shape, dtype name, raw bytes)``, the bytes C-ordered in the dtype's
native (little-endian) layout. flax's other extension types (native
complex, numpy scalar) and arrays it split into chunks (above 2^30 bytes)
are not read: a parameter tree holds none.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Tuple, Union

import numpy as np

EXT_NDARRAY = 1


class MsgpackError(ValueError):
    """The bytes are not the msgpack this reader takes."""


def _dtype(name) -> np.dtype:
    name = name.decode() if isinstance(name, bytes) else name
    try:
        return np.dtype(name)
    except TypeError as e:
        raise MsgpackError(f"array dtype {name!r} is not a numpy dtype") from e


def _ext(code: int, data: bytes) -> np.ndarray:
    if code != EXT_NDARRAY:
        raise MsgpackError(f"msgpack extension type {code} is not an array")
    shape, dtype, raw = unpackb(data)
    return np.frombuffer(raw, dtype=_dtype(dtype)).reshape(tuple(shape)).copy()


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise MsgpackError("truncated msgpack data")
        out = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            code = self.unpack("b")
            return _ext(code, self.take(1 << (b - 0xD4)))
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                   0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self.unpack(numbers[b])
        sizes = {0: "B", 1: "H", 2: "I"}
        if 0xC4 <= b <= 0xC6:  # bin 8, 16, 32
            return self.take(self.unpack(sizes[b - 0xC4]))
        if 0xC7 <= b <= 0xC9:  # ext 8, 16, 32
            n = self.unpack(sizes[b - 0xC7])
            code = self.unpack("b")
            return _ext(code, self.take(n))
        if 0xD9 <= b <= 0xDB:  # str 8, 16, 32
            return self.take(self.unpack(sizes[b - 0xD9])).decode("utf-8")
        if b in (0xDC, 0xDD):  # array 16, 32
            return [self.value() for _ in range(self.unpack(sizes[b - 0xDB]))]
        if b in (0xDE, 0xDF):  # map 16, 32
            return self.map(self.unpack(sizes[b - 0xDD]))
        raise MsgpackError(f"msgpack type byte 0x{b:02x} at {self.pos - 1} is not taken")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def unpackb(data: bytes) -> Any:
    """One msgpack value from ``data``, which it must use up exactly."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise MsgpackError(f"{len(r.data) - r.pos} trailing bytes after the msgpack value")
    return out


def read_state_dict(source: Union[str, Path, bytes]) -> dict:
    """The state dict that ``flax.serialization.to_bytes`` wrote (a file
    path or its bytes): nested dicts with numpy array leaves."""
    data = source if isinstance(source, (bytes, bytearray)) else Path(source).read_bytes()
    tree = unpackb(bytes(data))
    if not isinstance(tree, dict):
        raise MsgpackError(f"a flax state dict is a msgpack map, got {type(tree).__name__}")
    _reject_chunked(tree, ())
    return tree


def _reject_chunked(node: Any, path: Tuple[str, ...]) -> None:
    if isinstance(node, dict):
        if "__msgpack_chunked_array__" in node:
            raise MsgpackError(f"{'.'.join(path)}: chunked arrays (above 2^30 bytes) are not read")
        for k, v in node.items():
            _reject_chunked(v, path + (str(k),))
