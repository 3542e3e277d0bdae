"""Native (C++) host ops of the port, loaded with ctypes: the CLIP BPE
tokenizer (``bpe_tokenizer.cpp``, same API as the JAX package's
``bpe_init`` / ``bpe_encode_batch``) and the image resize + normalize
library (``image_ops.cpp``: ``resize_normalize_batch``,
``resize_normalize_varied``, ``l2_normalize_rows``, same API as the JAX
package's).

Each library builds at first use with ``g++ -O3 -march=native -shared
-fPIC -fopenmp`` into ``build/tvc_torch_kernels/`` at the repo root, named
by the hash of its source, the flags, the compiler and the host CPU's
feature flags (``-march=native`` code runs only on a CPU like the one that
built it). A failed build or load raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

import numpy as np

from tvc_torch.core.kernels._build import BUILD_DIR

HERE = Path(__file__).resolve().parent
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-fopenmp"]

CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)
_INT = ctypes.c_int

#: C entry points of each source: name -> (argtypes, restype)
SIGNATURES = {
    "bpe_tokenizer": {
        "bpe_init": ([ctypes.c_char_p, _I64P, _I32P, ctypes.c_int32, ctypes.c_char_p, _I64P, ctypes.c_int32], _INT),
        "bpe_encode_batch": (
            [ctypes.c_char_p, _I64P, ctypes.c_int32, _I32P, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32], _INT,
        ),
        "bpe_ready": ([], _INT),
    },
    "image_ops": {
        # src, batch, h, w, dst, size, mean, std
        "resize_normalize_batch": ([_U8P, _INT, _INT, _INT, _F32P, _INT, _F32P, _F32P], None),
        # src, offsets, dims, batch, dst, size, mean, std
        "resize_normalize_varied": ([_U8P, _I64P, _I32P, _INT, _F32P, _INT, _F32P, _F32P], None),
        # data, n, d
        "l2_normalize_rows": ([_F32P, ctypes.c_int64, ctypes.c_int64], None),
    },
}


def _gxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found on PATH: the native libraries build from source at first use")
    return path


def _cpu_flags() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"flags")), b"")
    except OSError:
        return b""


def library_path(name: str) -> Path:
    gxx = _gxx()
    version = subprocess.run([gxx, "--version"], capture_output=True, check=True).stdout
    h = hashlib.sha256((HERE / f"{name}.cpp").read_bytes())
    for part in (" ".join(GXX_FLAGS).encode(), version, _cpu_flags()):
        h.update(part)
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _load(name: str) -> ctypes.CDLL:
    """The loaded library of ``<name>.cpp``, built first if needed (raises
    on failure)."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        src = HERE / f"{name}.cpp"
        out = library_path(name)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [_gxx(), *GXX_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed for {src.name} (rc {proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
        lib = ctypes.CDLL(str(out))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = restype
        _LIBS[name] = lib
        return lib


# -- CLIP BPE tokenizer ------------------------------------------------------------


def _blob(strings) -> Tuple[bytes, np.ndarray]:
    """Concatenated UTF-8 bytes + int64 offsets [n + 1]."""
    enc = [s.encode("utf-8") for s in strings]
    offsets = np.zeros(len(enc) + 1, np.int64)
    np.cumsum([len(b) for b in enc], out=offsets[1:])
    return b"".join(enc), offsets


def bpe_init(encoder: dict, ranks: dict) -> bool:
    """Load a BPETokenizer's token -> id and merge -> rank tables into the
    library (one vocab per process). Returns True; raises on failure."""
    lib = _load("bpe_tokenizer")
    tokens = list(encoder)
    vblob, voff = _blob(tokens)
    vids = np.asarray([encoder[t] for t in tokens], np.int32)
    merges = [None] * len(ranks)
    for (first, second), rank in ranks.items():
        merges[rank] = f"{first}\x01{second}"
    if any(m is None for m in merges):
        raise ValueError("merge ranks must be 0 .. n-1")
    mblob, moff = _blob(merges)
    rc = lib.bpe_init(
        vblob, voff.ctypes.data_as(_I64P), vids.ctypes.data_as(_I32P), len(tokens),
        mblob, moff.ctypes.data_as(_I64P), len(merges),
    )
    if rc != 0:
        raise RuntimeError(f"bpe_init failed (rc {rc})")
    return True


def bpe_encode_batch(
    texts: Sequence[str], context_length: int, sot_id: int, eot_id: int, pad_id: int = 0
) -> np.ndarray:
    """Lowercased ASCII texts without special tokens -> int32 ``[B,
    context_length]``: SOT, the ids cut to ``context_length - 2``, EOT,
    then ``pad_id``."""
    lib = _load("bpe_tokenizer")
    if not lib.bpe_ready():
        raise RuntimeError("native BPE tables not loaded: call bpe_init first")
    blob, offsets = _blob(texts)
    out = np.full((len(texts), context_length), pad_id, np.int32)
    rc = lib.bpe_encode_batch(
        blob, offsets.ctypes.data_as(_I64P), len(texts), out.ctypes.data_as(_I32P),
        context_length, sot_id, eot_id,
    )
    if rc != 0:
        raise RuntimeError(f"bpe_encode_batch failed (rc {rc})")
    return out


# -- image resize + normalize ---------------------------------------------------------


def _fptr(arr: np.ndarray):
    return arr.ctypes.data_as(_F32P)


def _stats(mean, std) -> Tuple[np.ndarray, np.ndarray]:
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    if mean.shape != (3,) or std.shape != (3,):
        raise ValueError("mean and std take one value per RGB channel")
    return mean, std


def resize_normalize_batch(
    images: np.ndarray, size: int, mean: np.ndarray = CLIP_MEAN, std: np.ndarray = CLIP_STD
) -> np.ndarray:
    """uint8 ``[B, H, W, 3]`` -> CLIP-normalized float32 ``[B, size, size, 3]``."""
    lib = _load("image_ops")
    images = np.ascontiguousarray(images, dtype=np.uint8)
    if images.ndim != 4 or images.shape[-1] != 3:
        raise ValueError(f"expected [B, H, W, 3] uint8, got {images.shape}")
    B, H, W, _ = images.shape
    out = np.empty((B, size, size, 3), np.float32)
    mean, std = _stats(mean, std)
    lib.resize_normalize_batch(images.ctypes.data_as(_U8P), B, H, W, _fptr(out), size, _fptr(mean), _fptr(std))
    return out


def resize_normalize_varied(
    images: Sequence[np.ndarray], size: int, mean: np.ndarray = CLIP_MEAN, std: np.ndarray = CLIP_STD
) -> np.ndarray:
    """List of uint8 ``[h_i, w_i, 3]`` -> float32 ``[B, size, size, 3]``."""
    lib = _load("image_ops")
    arrs = [np.ascontiguousarray(im, np.uint8) for im in images]
    for a in arrs:
        if a.ndim != 3 or a.shape[-1] != 3:
            raise ValueError(f"expected [h, w, 3] uint8, got {a.shape}")
    blob = np.concatenate([a.reshape(-1) for a in arrs]) if arrs else np.zeros(0, np.uint8)
    offsets = np.zeros(len(arrs), np.int64)
    dims = np.zeros(2 * len(arrs), np.int32)
    pos = 0
    for i, a in enumerate(arrs):
        offsets[i] = pos
        dims[2 * i], dims[2 * i + 1] = a.shape[0], a.shape[1]
        pos += a.size
    out = np.empty((len(arrs), size, size, 3), np.float32)
    mean, std = _stats(mean, std)
    lib.resize_normalize_varied(
        blob.ctypes.data_as(_U8P), offsets.ctypes.data_as(_I64P), dims.ctypes.data_as(_I32P),
        len(arrs), _fptr(out), size, _fptr(mean), _fptr(std),
    )
    return out


def l2_normalize_rows(data: np.ndarray) -> np.ndarray:
    """Row L2 normalization of a float32 ``[N, D]`` matrix, in place when
    ``data`` is already a contiguous float32 array; returns the result."""
    lib = _load("image_ops")
    data = np.ascontiguousarray(data, np.float32)
    if data.ndim != 2:
        raise ValueError(f"expected [N, D], got {data.shape}")
    lib.l2_normalize_rows(_fptr(data), data.shape[0], data.shape[1])
    return data
