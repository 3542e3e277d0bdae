"""Time and hold the per-head tensor-core attention (``head_attention.cuh``
through ``mha.cu``'s ``tvc_mha``) on one NVIDIA GPU.

    python scripts/compare_head_attention.py [--other OTHER_CSRC_DIR] [--ablate]

For each bf16 shape below it prints the median CUDA-event time of this
tree's kernel and of ``scaled_dot_product_attention`` on the same q, k, v,
and the largest difference of the kernel's output from the plain version
``mha_reference``, relative to max(1, |y|). ``--other`` adds another tree's
``tvc_mha`` (built from OTHER_CSRC_DIR), held the same way and timed in
turns with this one (this, other, other, this). ``--ablate`` adds copies of
this tree's kernel with one part cut out, as timing probes whose outputs
are wrong: ``noload`` loads no key or value tile after the first,
``nosoftmax1`` skips sweep 1's softmax (its Q.K^T stays; P is zero),
``noexp`` takes x for 2^x.
Exits non-zero if this tree's or the other tree's kernel is farther than
1e-2 from the plain version (``chip_smoke.py``'s bf16 tolerance): the two
trees' outputs need not be equal bit for bit.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from tvc_torch.core.kernels.attention_kernel import mha_reference  # noqa: E402

NVCC = ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC"]
SHAPES = (  # (tag, B, T, H, causal), head width 64
    ("ViT-L/14", 64, 257, 16, False),
    ("ViT-L/14 336 px", 16, 577, 16, False),
    ("ViT-B/32", 256, 50, 12, False),
    ("text", 448, 32, 8, True),
)
ABLATIONS = {  # name: [(text of head_attention.cuh, its replacement), ...]
    "noload": [("    if (tid == 0 && i + 1 < nsteps) load_step(i + 1);\n", ""),
               ("    mbar_wait(bar_s + 8 * (1 + (i & 1)), (i >> 1) & 1);\n",
                "    if (i == 0) mbar_wait(bar_s + 8, 0);  // the first tile, so no load is left in flight\n")],
    "nosoftmax1": [("    if (i < nkt) {\n      if (live) {", "    if (i < nkt) {\n      if (false) {")],
    "noexp": [('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "y = x;")],
}
TOL = 1e-2


def _build(csrc: Path, out_dir: Path, tag: str, edits=()) -> subprocess.Popen:
    d = out_dir / tag
    d.mkdir()
    for name in ("mha.cu", "head_attention.cuh", "hopper.cuh"):
        if (csrc / name).exists():
            shutil.copy(csrc / name, d / name)
    if edits:
        src = (d / "head_attention.cuh").read_text()
        for old, new in edits:
            if src.count(old) != 1:
                raise ValueError(f"{tag}: the ablated text is not once in head_attention.cuh")
            src = src.replace(old, new)
        (d / "head_attention.cuh").write_text(src)
    return subprocess.Popen([*NVCC, "-o", str(d / "mha.so"), str(d / "mha.cu")])


def _load(so: Path):
    f = ctypes.CDLL(str(so)).tvc_mha
    f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def _time_ms(run, iters: int = 30) -> float:
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)  # the card spins while the host enqueues: device time only
        s.record()
        run()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="another tree's tvc_torch/csrc")
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        tmp = Path(tmp)
        builds = {"this": _build(REPO / "tvc_torch" / "csrc", tmp, "this")}
        if args.other:
            builds["other"] = _build(Path(args.other), tmp, "other")
        if args.ablate:
            for name, edits in ABLATIONS.items():
                builds[name] = _build(REPO / "tvc_torch" / "csrc", tmp, name, edits)
        for name, proc in builds.items():
            if proc.wait() != 0:
                raise RuntimeError(f"nvcc failed for {name}")
        kernels = {name: _load(tmp / name / "mha.so") for name in builds}
        gen = torch.Generator(device="cuda").manual_seed(0)
        stream = torch.cuda.current_stream().cuda_stream
        worst = 0.0
        for tag, B, T, H, causal in SHAPES:
            q, k, v = (torch.randn((B, T, H, 64), generator=gen, device="cuda").bfloat16() for _ in range(3))
            qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            want = mha_reference(q, k, v, causal).float()
            runs, errs, refused = {}, {}, []
            for name, f in kernels.items():
                out = torch.empty_like(q)
                run = (lambda f=f, out=out: f(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                              H * 64, B, T, H, 64, 1, int(causal), 0.125, stream))
                if run():
                    if name == "other":  # an older kernel may refuse the shape (the CUDA-core one took T <= 257)
                        refused.append(name)
                        continue
                    raise RuntimeError(f"{name} tvc_mha failed at {tag}")
                runs[name] = run
                torch.cuda.synchronize()
                errs[name] = float(((out.float() - want).abs() / want.abs().clamp(min=1.0)).max())
                if name in ("this", "other"):
                    worst = max(worst, errs[name])
            times = {name: [] for name in runs}
            order = ["this", "other", "other", "this"] if "other" in runs else ["this"]
            for name in order + [n for n in runs if n not in ("this", "other")]:
                times[name].append(_time_ms(runs[name]))
            sdpa = _time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal))
            parts = [f"{name} {'/'.join(f'{t:.4f}' for t in times[name])} ms (err {errs[name]:.2e})"
                     for name in runs] + [f"{name} refused the shape" for name in refused]
            print(f"{tag} B={B} T={T} H={H}{' causal' if causal else ''}: sdpa {sdpa:.4f} ms; " + "; ".join(parts),
                  flush=True)
    print(f"largest difference from the plain version: {worst:.3e} (tolerance {TOL})")
    return 0 if worst <= TOL else 1


if __name__ == "__main__":
    sys.exit(main())
