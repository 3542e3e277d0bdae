"""A reader and a writer of ``flax.serialization.to_bytes`` files, in
pure Python.

The JAX package checkpoints parameter trees with flax's msgpack format:
msgpack maps with string keys (lists and tuples become maps keyed "0",
"1", ...), numbers and strings, plus flax's extension types for arrays.
The port loads those files (the trained tiny-CLIP fixtures under
``tvc/assets``) without ``msgpack`` or ``flax``, which the card's machine
does not have:

    tree = read_state_dict(path)  # nested dicts of numpy arrays
    data = to_bytes(tree)          # the bytes flax writes for that tree

A parameter tree's leaves are arrays, flax's extension type 1 (ndarray,
flax/serialization.py ``_MsgpackExtType``): a nested msgpack array
``(shape, dtype name, raw bytes)``, the bytes C-ordered in the dtype's
native (little-endian) layout; a numpy scalar is type 3 with the same
payload. The writer takes torch tensors too (as the numpy array of their
values; bf16 as flax writes ml_dtypes' ``bfloat16``, which the reader
widens to f32, since numpy has no bf16). flax's native complex type and
arrays it splits into chunks (above 2^30 bytes) are neither read nor
written: a parameter tree holds none.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Optional, Tuple, Union

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
#: flax splits arrays above this many bytes into chunks
MAX_CHUNK_SIZE = 2**30


class MsgpackError(ValueError):
    """The bytes are not the msgpack this reader takes."""


def _dtype(name) -> np.dtype:
    name = name.decode() if isinstance(name, bytes) else name
    try:
        return np.dtype(name)
    except TypeError as e:
        raise MsgpackError(f"array dtype {name!r} is not a numpy dtype") from e


def _ext(code: int, data: bytes):
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise MsgpackError(f"msgpack extension type {code} is not an array")
    shape, dtype, raw = unpackb(data)
    if (dtype.decode() if isinstance(dtype, bytes) else dtype) == "bfloat16":  # the upper half of an f32
        arr = (np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16).view(np.float32).reshape(tuple(shape))
    else:
        arr = np.frombuffer(raw, dtype=_dtype(dtype)).reshape(tuple(shape)).copy()
    return arr[()] if code == EXT_NPSCALAR else arr


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


# ---------------------------------------------------------------------------
# the writer: msgpack-python's packb(tree, strict_types=True) with flax's
# extension hook, byte for byte
# ---------------------------------------------------------------------------


def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return struct.pack("B", v)
    if -32 <= v < 0:
        return struct.pack("b", v)
    for lo, hi, code, fmt in ((0, 0xFF, 0xCC, "B"), (-0x80, -1, 0xD0, "b"), (0, 0xFFFF, 0xCD, "H"),
                              (-0x8000, -1, 0xD1, "h"), (0, 0xFFFFFFFF, 0xCE, "I"),
                              (-0x80000000, -1, 0xD2, "i"), (0, 0xFFFFFFFFFFFFFFFF, 0xCF, "Q"),
                              (-0x8000000000000000, -1, 0xD3, "q")):
        if lo <= v <= hi:
            return struct.pack(">B" + fmt, code, v)
    raise MsgpackError(f"integer {v} does not fit 64 bits")


def _sized(n: int, fix: Optional[Tuple[int, int]], codes: Tuple[int, ...]) -> bytes:
    """The type byte(s) of a str / bin / array / map of n items: the fix
    form (type, bound) when it fits, else the smallest of the 8 / 16 /
    32-bit length forms ``codes`` (arrays and maps have no 8-bit form)."""
    if fix is not None and n < fix[1]:
        return struct.pack("B", fix[0] | n)
    forms = (("B", 0xFF), ("H", 0xFFFF), ("I", 0xFFFFFFFF))[3 - len(codes):]
    for code, (fmt, hi) in zip(codes, forms):
        if n <= hi:
            return struct.pack(">B" + fmt, code, n)
    raise MsgpackError(f"{n} items or bytes do not fit msgpack")


def _ext_bytes(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = struct.pack("Bb", fixed[n], code)
    else:
        head = _sized(n, None, (0xC7, 0xC8, 0xC9)) + struct.pack("b", code)
    return head + payload


def _array_payload(arr) -> bytes:
    """flax's ``_ndarray_to_bytes``: packb((shape, dtype name, C bytes))."""
    import torch

    if torch.is_tensor(arr):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            shape, name, raw = tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()
        else:
            a = t.numpy()
            shape, name, raw = a.shape, a.dtype.name, a.tobytes("C")
    else:
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise MsgpackError("object and structured dtypes are not serialized")
        shape, name, raw = arr.shape, arr.dtype.name, arr.tobytes("C")
    if len(raw) > MAX_CHUNK_SIZE:
        raise MsgpackError(f"an array of {len(raw)} bytes: flax would chunk it, which is not written")
    return _pack([list(shape), name, raw])


def _pack(v) -> bytes:
    import torch

    if v is None:
        return b"\xc0"
    if v is True or v is False:
        return b"\xc3" if v else b"\xc2"
    if type(v) is int:
        return _int(v)
    if type(v) is float:
        return struct.pack(">Bd", 0xCB, v)
    if isinstance(v, str):
        b = v.encode("utf-8")
        return _sized(len(b), (0xA0, 32), (0xD9, 0xDA, 0xDB)) + b
    if isinstance(v, (bytes, bytearray)):
        return _sized(len(v), None, (0xC4, 0xC5, 0xC6)) + bytes(v)
    if isinstance(v, list):
        return _sized(len(v), (0x90, 16), (0xDC, 0xDD)) + b"".join(_pack(x) for x in v)
    if isinstance(v, dict):
        return _sized(len(v), (0x80, 16), (0xDE, 0xDF)) + b"".join(_pack(k) + _pack(x) for k, x in v.items())
    if isinstance(v, np.ndarray) or torch.is_tensor(v):
        return _ext_bytes(EXT_NDARRAY, _array_payload(v))
    if isinstance(v, np.generic):
        return _ext_bytes(EXT_NPSCALAR, _array_payload(np.asarray(v)))
    raise MsgpackError(f"cannot serialize a {type(v).__name__}")


def to_state_dict(tree: Any) -> Any:
    """flax's ``to_state_dict`` of nested dicts, lists and tuples: keys as
    strings, lists and tuples as maps keyed "0", "1", ...; leaves kept."""
    if isinstance(tree, dict):
        keys = [str(k) for k in tree]
        if len(set(keys)) != len(keys):
            raise MsgpackError(f"dict keys without a unique string form: {list(tree)}")
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return tree


def to_bytes(tree: Any) -> bytes:
    """The bytes ``flax.serialization.to_bytes`` writes for this tree (numpy
    arrays, torch tensors, Python and numpy scalars as leaves)."""
    return _pack(to_state_dict(tree))


def write_state_dict(path: Union[str, Path], tree: Any) -> None:
    """Write :func:`to_bytes` of ``tree`` to ``path`` (parents made), through
    a temporary file renamed into place."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(to_bytes(tree))
    tmp.replace(path)


def from_state_dict(template: Any, state: Any) -> Any:
    """flax's ``from_state_dict``: ``state`` (as :func:`read_state_dict`
    gives it) in ``template``'s structure, the keys checked; a torch tensor
    leaf of the template comes back as a tensor on its device (bf16 again
    where the template's is), any other leaf as stored."""
    import torch

    if isinstance(template, dict):
        if not isinstance(state, dict) or {str(k) for k in template} != set(state):
            have = sorted(state) if isinstance(state, dict) else type(state).__name__
            raise ValueError(f"the target keys {sorted(str(k) for k in template)} and the state keys {have} "
                             "do not match")
        return {k: from_state_dict(v, state[str(k)]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if not isinstance(state, dict) or set(state) != {str(i) for i in range(len(template))}:
            raise ValueError(f"a sequence of {len(template)} items and the state {state!r:.80} do not match")
        items = [from_state_dict(v, state[str(i)]) for i, v in enumerate(template)]
        return type(template)(*items) if hasattr(template, "_fields") else type(template)(items)
    if torch.is_tensor(template):
        t = torch.from_numpy(np.array(state)).to(template.device)
        return t.to(torch.bfloat16) if template.dtype == torch.bfloat16 else t
    return state
