"""Compare the layer kernels' per-head attention of this tree with another
tree's, bit for bit and in time, on one NVIDIA GPU.

    python scripts/compare_head_attention.py OTHER_CSRC_DIR

Builds ``attention_layer.cu`` and ``quantized_layer.cu`` (with the
``head_attention.cuh`` beside each) from ``tvc_torch/csrc`` and from
OTHER_CSRC_DIR, runs ``tvc_head_attention`` (bf16 out) and
``tvc_head_attention_f32`` (f32 out) of both on the same packed q | k | v
at the serving shapes, and prints for each the number of output elements
that differ, the largest difference, and both kernels' times (medians of
CUDA events, taken in turns: this, other, other, this). Exits non-zero if
any output differs.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
NVCC = ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC"]
SHAPES = (  # (tag, sequences, T, W, heads, causal)
    ("vision", 64, 50, 768, 12, False),
    ("text", 448, 16, 512, 8, True),
    ("text", 448, 32, 512, 8, True),
    ("vit-l/14 vision", 8, 257, 1024, 16, False),
)


def _build(csrc: Path, out_dir: Path, tag: str) -> dict:
    libs = {}
    for name, fn in (("attention_layer", "tvc_head_attention"), ("quantized_layer", "tvc_head_attention_f32")):
        so = out_dir / f"{tag}-{name}.so"
        subprocess.run([*NVCC, "-o", str(so), str(csrc / f"{name}.cu")], check=True)
        f = getattr(ctypes.CDLL(str(so)), fn)
        f.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        libs[fn] = f
    return libs


def _time_ms(run, iters: int = 50) -> float:
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        run()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def main(other: str) -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        ours = _build(REPO / "tvc_torch" / "csrc", Path(tmp), "this")
        theirs = _build(Path(other), Path(tmp), "other")
        gen = torch.Generator(device="cuda").manual_seed(0)
        stream = torch.cuda.current_stream().cuda_stream
        differ = 0
        for tag, seqs, T, W, H, causal in SHAPES:
            qkv = torch.randn((seqs * T, 3 * W), generator=gen, device="cuda").to(torch.bfloat16)
            for fn, dtype in (("tvc_head_attention", torch.bfloat16), ("tvc_head_attention_f32", torch.float32)):
                a = torch.empty((seqs * T, W), dtype=dtype, device="cuda")
                b = torch.empty_like(a)
                for lib, out in ((ours, a), (theirs, b)):
                    rc = lib[fn](qkv.data_ptr(), out.data_ptr(), seqs, T, W, H, int(causal), stream)
                    if rc:
                        raise RuntimeError(f"{fn}: cudaError {rc}")
                torch.cuda.synchronize()
                n = int((a != b).sum())
                differ += n
                run = {name: (lambda lib=lib, out=out: lib[fn](qkv.data_ptr(), out.data_ptr(), seqs, T, W, H,
                                                              int(causal), stream))
                       for name, lib, out in (("this", ours, a), ("other", theirs, b))}
                times = {"this": [], "other": []}
                for name in ("this", "other", "other", "this"):
                    times[name].append(_time_ms(run[name]))
                print(f"{fn} {tag} seqs={seqs} T={T} W={W} H={H}{' causal' if causal else ''}: "
                      f"{n} of {a.numel()} outputs differ, max |d| {float((a.float() - b.float()).abs().max()):.3e}; "
                      f"ms this {times['this']} other {times['other']}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
