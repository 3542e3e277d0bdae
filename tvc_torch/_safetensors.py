"""A reader of ``.safetensors`` files into numpy, in pure Python.

Published checkpoints (HF ``model.safetensors``, diffusers
``diffusion_pytorch_model.safetensors``) use this layout:

* 8 bytes: the header's length N, a little-endian unsigned 64-bit integer;
* N bytes: a UTF-8 JSON object ``{name: {"dtype": "F32", "shape": [...],
  "data_offsets": [begin, end]}, ..., "__metadata__": {...}}``;
* the tensors' raw bytes, C-ordered and little-endian, each at
  ``[begin, end)`` counted from the end of the header.

The port reads them without the ``safetensors`` package, which the card's
machine does not have. It reads the dtypes published checkpoints use,
F32, F16, BF16, I64 and BOOL; every float tensor comes out as f32 (F16 and
BF16 widened exactly), as the JAX package's ``.bin`` branch gives it
(``v.float().numpy()``); BF16 is what Qwen2's published checkpoints hold.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict, Union

import numpy as np

#: safetensors dtype name -> the numpy dtype of the stored bytes
_STORED = {"F32": np.dtype("<f4"), "F16": np.dtype("<f2"), "BF16": np.dtype("<u2"), "I64": np.dtype("<i8"),
           "BOOL": np.dtype("?")}
#: a header above this is not a checkpoint's (the format's own cap)
MAX_HEADER = 100 * 2**20


class SafetensorsError(ValueError):
    """The bytes are not a safetensors file this reader takes."""


def _widen(arr: np.ndarray, dtype: str) -> np.ndarray:
    if dtype == "BF16":  # the upper half of an f32
        return (arr.astype(np.uint32) << 16).view(np.float32)
    if dtype == "F16":
        return arr.astype(np.float32)
    return arr


def _header(path: Path):
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise SafetensorsError(f"{path}: shorter than the 8-byte header length")
        (n,) = struct.unpack("<Q", head)
        if n > MAX_HEADER:
            raise SafetensorsError(f"{path}: header length {n} is above {MAX_HEADER}")
        raw = f.read(n)
    if len(raw) != n:
        raise SafetensorsError(f"{path}: header of {n} bytes is truncated to {len(raw)}")
    try:
        header = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise SafetensorsError(f"{path}: the header is not JSON ({e})") from None
    if not isinstance(header, dict):
        raise SafetensorsError(f"{path}: the header is not a JSON object")
    return header, 8 + n


def load_file(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    """Every tensor of a ``.safetensors`` file as a numpy array, floats as
    f32, in the header's order. An entry whose bytes run past the end of
    the file, or whose byte count does not fit its dtype and shape,
    raises :class:`SafetensorsError`."""
    path = Path(path)
    header, start = _header(path)
    size = path.stat().st_size
    data = np.memmap(path, dtype=np.uint8, mode="r") if size > 0 else np.zeros(0, np.uint8)
    out = {}
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        try:
            dtype, shape, (begin, end) = entry["dtype"], list(entry["shape"]), entry["data_offsets"]
        except (KeyError, TypeError, ValueError):
            raise SafetensorsError(f"{path}: bad header entry {name!r}: {entry!r}") from None
        if dtype not in _STORED:
            raise SafetensorsError(f"{path}: {name}: dtype {dtype!r} is not read")
        stored = _STORED[dtype]
        if not 0 <= begin <= end or start + end > size:
            raise SafetensorsError(f"{path}: {name}: bytes [{begin}, {end}) run past the end of the file")
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * stored.itemsize:
            raise SafetensorsError(f"{path}: {name}: {end - begin} bytes for {dtype} {shape}")
        arr = np.frombuffer(data, dtype=stored, count=count, offset=start + begin).reshape(shape)
        wide = _widen(arr, dtype)
        # a copy either way: the file may change after the call
        out[name] = np.array(wide) if wide is arr else wide
    del data
    return out
