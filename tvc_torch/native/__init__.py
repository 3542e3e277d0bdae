"""Native (C++) host ops of the port, loaded with ctypes: the CLIP BPE
tokenizer (``bpe_tokenizer.cpp``), same API as the JAX package's
``bpe_init`` / ``bpe_encode_batch``.

The library builds at first use with ``g++ -O3 -march=native -shared
-fPIC -fopenmp`` into ``build/tvc_torch_kernels/`` at the repo root, named
by the hash of the source, the flags, the compiler and the host CPU's
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
from typing import Optional, Sequence, Tuple

import numpy as np

from tvc_torch.core.kernels._build import BUILD_DIR

SRC = Path(__file__).resolve().with_name("bpe_tokenizer.cpp")
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-fopenmp"]

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()
_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)


def _gxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found on PATH: the native BPE tokenizer builds from source at first use")
    return path


def _cpu_flags() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"flags")), b"")
    except OSError:
        return b""


def library_path() -> Path:
    gxx = _gxx()
    version = subprocess.run([gxx, "--version"], capture_output=True, check=True).stdout
    h = hashlib.sha256(SRC.read_bytes())
    for part in (" ".join(GXX_FLAGS).encode(), version, _cpu_flags()):
        h.update(part)
    return BUILD_DIR / f"bpe_tokenizer-{h.hexdigest()[:16]}.so"


def _load() -> ctypes.CDLL:
    """The loaded library, built first if needed (raises on failure)."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        out = library_path()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [_gxx(), *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed for {SRC.name} (rc {proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
        lib = ctypes.CDLL(str(out))
        lib.bpe_init.argtypes = [
            ctypes.c_char_p, _I64P, _I32P, ctypes.c_int32, ctypes.c_char_p, _I64P, ctypes.c_int32,
        ]
        lib.bpe_init.restype = ctypes.c_int
        lib.bpe_encode_batch.argtypes = [
            ctypes.c_char_p, _I64P, ctypes.c_int32, _I32P, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ]
        lib.bpe_encode_batch.restype = ctypes.c_int
        lib.bpe_ready.restype = ctypes.c_int
        _LIB = lib
        return lib


def _blob(strings) -> Tuple[bytes, np.ndarray]:
    """Concatenated UTF-8 bytes + int64 offsets [n + 1]."""
    enc = [s.encode("utf-8") for s in strings]
    offsets = np.zeros(len(enc) + 1, np.int64)
    np.cumsum([len(b) for b in enc], out=offsets[1:])
    return b"".join(enc), offsets


def bpe_init(encoder: dict, ranks: dict) -> bool:
    """Load a BPETokenizer's token -> id and merge -> rank tables into the
    library (one vocab per process). Returns True; raises on failure."""
    lib = _load()
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
    lib = _load()
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
