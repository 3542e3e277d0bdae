"""Build and load the port's CUDA kernels (``tvc_torch/csrc/*.cu``).

Each source compiles on its own with ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds). Libraries land in ``build/tvc_torch_kernels/`` at the repo
root, named by the hash of their source and of the shared headers
(``csrc/*.cuh``): an edited source or header rebuilds, an unchanged one
loads the library already there. ``build_all`` starts one
``nvcc`` per source, all at once.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

from tvc_torch.utils import tracing

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "tvc_torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

#: C entry points of each source: name -> ctypes argtypes
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES: Dict[str, Dict[str, list]] = {
    "consistency": {
        # img, txt, var, ref, vmask, rmask, weights (or null), threshold (or
        # null), w_tv, w_sd, w_cons, threshold, stats, flags, B, V, R, D,
        # dtypes, vmask code, rmask code, stream
        "tvc_consistency_scores": [_P, _P, _P, _P, _P, _P, _P, _P, _F, _F, _F, _F, _P, _P,
                                   _I, _I, _I, _I, _I, _I, _I, _P],
    },
    "attention_layer": {
        # x, ln_scale, ln_bias, y, M, K, eps, is_f32, stream
        "tvc_layernorm_rows": [_P, _P, _P, _P, _I, _I, _F, _I, _P],
        # a, w, bias, residual, out, ws (f32 or null), M, N, K, epilogue,
        # bm, bn, splits, per, stream
        "tvc_bf16_gemm": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
        # a, w, bias, residual, out, M, N, K, epilogue, stream
        "tvc_f32_gemm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        # qkv, out, seqs, T, W, heads, causal, is_f32, stream
        "tvc_head_attention": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
    },
    "quantized_layer": {
        # h, ln_scale, ln_bias, q, scale, M, K, eps, has_ln, is_f32, stream
        "tvc_quant_rows": [_P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _P],
        # a, row_scale, w, col_scale, bias, residual, out, ws (int32 or
        # null), M, N, K, epilogue, bm, bn, splits, per, stream
        "tvc_i8_gemm": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
        # qkv, out, seqs, T, W, heads, causal, in_f32, stream
        "tvc_head_attention_f32": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
    },
    "decode_attention": {
        # q, k, v, mask, out, ws (f32 or null), B, KV, R, S, D, is_bf16,
        # splits, chunk, stream
        "tvc_decode_gqa": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
        # B, KV, R, D, splits -> f32 words of workspace the split path needs
        "tvc_decode_gqa_workspace": [_I, _I, _I, _I, _I],
        # q, k, v, mask, out, B, KV, R, S, D, is_bf16, stream (the tail
        # path: head widths off 16 / 32 / 64 / 128, R > 8)
        "tvc_decode_gqa_any": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    },
    "w8_matmul": {
        # x (bf16), w (int8), scale (f32), out (bf16), ws (f32 or null), M, N,
        # K, bm, bn, splits, per, stream
        "tvc_w8_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        # x (f32), w (int8), scale (f32), out (f32), M, N, K, stream
        "tvc_w8_matmul_f32": [_P, _P, _P, _P, _I, _I, _I, _P],
    },
    "moe_w8": {
        # x (bf16), w (int8 [E, K, N]), scale (f32 [E, N]), offsets (int32
        # [E + 1]), out (bf16), M, E, N, K, row tile, ring stages, stream
        "tvc_moe_w8_grouped": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    },
    "mla_decode": {
        # q_lat, q_pe, cache (one layer's [B, S, 576]), mask, out, B, heads,
        # S, q_lat's row and head strides, scale, stream
        "tvc_mla_decode": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    },
    "dsv2_fused": {
        # qa, cos, sin, suk, kv_norm (f32), cache (the layer's), qn, qpe, B,
        # nh, nope, rope, r, S, slot, eps, factor (1 / r), lanes a row, stream
        "tvc_mla_rope_cache": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P],
        # o, suv (f32), out, B, nh, v, stream
        "tvc_mla_out": [_P, _P, _P, _I, _I, _I, _P],
        # logits (f32), x, ldx, counts (or null), ticket, ws (int32), topv
        # (f32), xs, bias (f32 or null), N, E, k, H, sigmoid, renorm, ws
        # words, stream
        "tvc_moe_route": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_longlong, _P],
        # yd, pos (int32), topv (f32), shared, out, N, k, H, scale, stream
        "tvc_moe_combine": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    },
    "kda": {
        # y, ldy, f, ldf, conv_w, a_log, dt_bias (f32), conv_state, lengths
        # (int64 or null), out, beta (f32), B, T, heads, d, K, b_col,
        # q_scale, stream
        "tvc_kda_prepare": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
        # qkvg, beta (f32), state (f32), lengths (int64 or null), out, B, T,
        # heads, stream
        "tvc_kda_recurrent": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
        # o, gate, ldg, w (f32), out, rows, heads, d, eps, stream
        "tvc_kda_gated_norm": [_P, _P, _I, _P, _P, ctypes.c_longlong, _I, _I, _F, _P],
    },
    "ssm": {
        # y, ldy, xbc_col, dt_col, conv_w, conv_b, dt_bias (f32),
        # conv_state, lengths (int64 or null), xbc, dt (f32), B, T, C,
        # heads, K, stream
        "tvc_ssm_prepare": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        # xbc, dt, a_log, d (f32), state (f32), lengths (int64 or null),
        # out, B, T, heads, groups, stream
        "tvc_ssm_recurrent": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        # y, z, ldz, w (f32), out, rows, groups, group size, eps, stream
        "tvc_ssm_gated_norm": [_P, _P, _I, _P, _P, ctypes.c_longlong, _I, _I, _F, _P],
    },
    "decode_fused": {
        # x, y (or null), scale (f32), h_out (or null), out, rows, W, ldx,
        # eps, factor (1 / W), lanes a row, is_f32, stream
        "tvc_rmsnorm_rows": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _I, _P],
        # qkv, bias (f32), cos, sin (f32), ck, cv (the layer's), q, B, nh,
        # kv, D, S, slot, is_f32, stream
        "tvc_qkv_rope_cache": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        # qkv, ck, cv (the layer's), q, B, nh, kv, D, S, slot, is_f32, stream
        "tvc_qkv_cache": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        # gu, out, rows, I, is_f32, stream
        "tvc_silu_mul": [_P, _P, _I, _I, _I, _P],
        # u, out, n, is_f32, stream
        "tvc_relu2": [_P, _P, ctypes.c_longlong, _I, _P],
    },
    "mha": {
        # q, k, v, out, ld, B, T, H, D, is_bf16, causal, scale, stream
        "tvc_mha": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    },
    "bank_topk": {
        # q, bank, valid (u8 or null), floor_vals, floor_idx (or null),
        # part_vals, part_idx, B, N, D, k, rows_per_split, splits,
        # bank_is_bf16, q_is_bf16, normalize, stream
        "tvc_bank_topk_partial": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
        # part_vals, part_idx, vals, idx, B, splits, k, cutoff, stream
        "tvc_bank_topk_merge": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the tvc_torch "
            "CUDA kernels build from source at first use"
        )
    return path


def library_path(name: str) -> Path:
    """Named by the hash of the source, the shared headers it may include
    and the flags."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start nvcc for ``name`` unless its library is current; returns
    (process, temp path, final path) or None."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file


def build_all(names: List[str] = None) -> float:
    """Build every source (one nvcc each, all started together); returns
    the wall seconds spent. A call that builds anything records a
    ``kernel.build`` span (``sources``: the ones built) and adds their
    number to the ``kernel.builds`` counter and its nanoseconds to
    ``kernel.build_ns``: a build while serving stalls every request, and
    ``ServingRuntime.stats()`` reports both counters."""
    names = list(SIGNATURES) if names is None else names
    t0 = time.perf_counter()
    t0_ns = time.time_ns()
    with _LOCK:
        jobs = {n: _start_build(n) for n in names}
        built = [n for n, job in jobs.items() if job is not None]
        for n in built:
            _finish_build(n, jobs[n])
    if built:
        t1_ns = time.time_ns()
        tracing.record("kernel.build", t0_ns, t1_ns, sources=built)
        tracing.count("kernel.builds", len(built))
        tracing.count("kernel.build_ns", t1_ns - t0_ns)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _LIBS[name] = lib
    return _LIBS[name]


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {code}")
