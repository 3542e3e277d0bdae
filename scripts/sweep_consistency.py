"""Time ``fused_consistency_scores`` on one NVIDIA GPU, this tree against
another, and split each wrapper call into its device activities.

    python scripts/sweep_consistency.py [--other OTHER_TREE] [--probe NAMES] [--iters N]

For each shape of ``chip_smoke.py``'s ``CONSISTENCY_SHAPES`` (the same
inputs, made from one seed per shape) it prints, per tree: the wrapper's
device time (``chip_smoke.time_ms``: a spin kernel queued ahead of each
call, so host time is not counted), the bare kernel's (the C entry point
alone between the same events), the bound and the kernel's share of it,
and one wrapper call under ``torch.profiler``: every device activity it ran
(kernels, copies) with its time. ``--other`` adds another checkout of the
repo (unpack it with ``git archive`` under ``build/``, which git ignores):
each tree runs in a process of its own, in turns (other, this, this,
other), and a tree whose wrapper refuses a shape's operands says so. The
other tree may have the wrapper of before the redesign, whose C entry
point takes a 4-float params tensor and writes a [B, 8] f32 block.
``--probe a,b`` adds copies of this tree's kernel with one change each
(``PROBES``), built from edited copies of ``consistency.cu``, each timed
alone on this tree's operands and held to the plain version like it.
Exits non-zero if this tree's wrapper or a probe disagrees with the plain
version (``chip_smoke.consistency_errors`` at ``CONSISTENCY_TOL``).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
#: name: [(text of consistency.cu, its replacement), ...]
PROBES = {
    "regs48": [("__maxnreg__(56)", "__maxnreg__(48)")],
    "regs64": [("__maxnreg__(56)", "__maxnreg__(64)")],
    # request a row before its mask element arrives (a masked row is read too)
    "speculative": [("  if (valid) load_step(r, 0, lane, w);\n", "  load_step(r, 0, lane, w);\n")],
    "words8": [("constexpr int kWords = 4;", "constexpr int kWords = 8;")],
    # a block a query: no persistent grid, so no next query's rows in flight
    "nopersist": [("  const int grid = (int)(B < fit ? B : fit);", "  const int grid = B;")],
}


def _smoke():
    """This tree's chip_smoke.py (its inputs, bounds and timer), whatever
    tree's tvc_torch is imported."""
    spec = importlib.util.spec_from_file_location("smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bare(ck, args):
    """The tree's C entry point alone, on the wrapper's operands."""
    import torch

    from tvc_torch.core.kernels import _build

    if hasattr(ck, "consistency_launch"):
        return ck.consistency_launch(*args)[0]
    # the wrapper of before the redesign: a params tensor, a [B, 8] block
    img, txt, var, refs, vmask, rmask, weights, thr = args
    B, D = img.shape
    params = ck._params_tensor(weights, thr, img.device)
    out = torch.empty((B, 8), dtype=torch.float32, device=img.device)
    lib = _build.load("consistency")
    ptrs = [t.data_ptr() for t in (params, img, txt, var, vmask, refs, rmask, out)]

    def launch():
        stream = torch.cuda.current_stream(img.device).cuda_stream
        _build.check(lib.tvc_consistency_scores(*ptrs, B, var.shape[1], refs.shape[1], D, stream), "consistency")
    return launch


def _probe_fns(names) -> dict:
    """name -> the probe's C entry point, every copy built at once."""
    from tvc_torch.core.kernels import _build

    src = (REPO / "tvc_torch" / "csrc" / "consistency.cu").read_text()
    out = Path(tempfile.mkdtemp(prefix="consistency_probes_"))
    jobs = {}
    for name in names:
        text = src
        for old, new in PROBES[name]:
            if text.count(old) != 1:
                raise ValueError(f"probe {name}: the edited text is not once in consistency.cu")
            text = text.replace(old, new)
        cu = out / f"{name}.cu"
        cu.write_text(text)
        jobs[name] = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
                                       "-o", str(out / f"{name}.so"), str(cu)])
    fns = {}
    for name, proc in jobs.items():
        if proc.wait():
            raise RuntimeError(f"probe {name} did not build")
        fn = ctypes.CDLL(str(out / f"{name}.so")).tvc_consistency_scores
        fn.argtypes = _build.SIGNATURES["consistency"]["tvc_consistency_scores"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def worker(tree: Path, iters: int, probes=()) -> None:
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    smoke = _smoke()
    from tvc_torch.core.kernels import _build
    from tvc_torch.core.kernels import consistency_kernel as ck

    assert Path(ck.__file__).resolve().is_relative_to(tree.resolve()), ck.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    fns = _probe_fns(probes) if probes else {}
    rows = []
    for i, (what, B, D, V, R, kind) in enumerate(smoke.CONSISTENCY_SHAPES):
        args, plain_args, vmask_np, rmask_np = smoke.consistency_inputs(dev, np.random.default_rng(100 + i), B, D,
                                                                        V, R, kind)
        row = {"shape": f"{what}: B={B} D={D} V={V} R={R}"}
        try:
            got = ck.fused_consistency_scores(*args)
        except ValueError as e:
            rows.append({**row, "refused": str(e)})
            continue
        want = ck.consistency_scores_reference(*plain_args)
        errs = smoke.consistency_errors(got, want, args[4].bool(), args[5].bool(), (0.4, 0.4, 0.2))
        bare = _bare(ck, args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ck.fused_consistency_scores(*args)
            torch.cuda.synchronize()
        split = [(e.name[:60], e.time_range.elapsed_us() / 1e3) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        nbytes, bms, by = smoke.consistency_bound(args, vmask_np, rmask_np)
        row.update(wrapper_ms=smoke.time_ms(lambda: ck.fused_consistency_scores(*args), iters=iters),
                   kernel_ms=smoke.time_ms(bare, iters=iters), bound_ms=bms, bound_by=by, mbytes=nbytes / 1e6,
                   held=max(errs.values()), split=split, probes={})
        for name, fn in fns.items():
            cargs, pout, keep = ck.kernel_call(*args)
            stream = torch.cuda.current_stream(dev).cuda_stream
            launch = lambda: _build.check(fn(*cargs, stream), "probe")
            launch()
            perr = smoke.consistency_errors(pout, want, args[4].bool(), args[5].bool(), (0.4, 0.4, 0.2))
            row["probes"][name] = (smoke.time_ms(launch, iters=iters), max(perr.values()))
        rows.append(row)
    print(json.dumps(rows), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="another checkout of the repo, timed in turns with this one")
    ap.add_argument("--probe", default="", help=f"comma-separated probes of this tree's kernel: {sorted(PROBES)}")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    a = ap.parse_args()
    probes = [p for p in a.probe.split(",") if p]
    if a.worker:
        worker(a.worker, a.iters, probes if a.worker.resolve() == REPO else ())
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30).stdout.strip()
    print(f"card: {smi}", flush=True)
    order = [("this", REPO)] if a.other is None else [("other", a.other), ("this", REPO), ("this", REPO),
                                                       ("other", a.other)]
    runs = []
    for tag, tree in order:
        out = subprocess.run([sys.executable, __file__, "--worker", str(tree), "--iters", str(a.iters),
                              "--probe", a.probe],
                             capture_output=True, text=True, timeout=600)
        if out.returncode:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append((tag, json.loads(out.stdout.strip().splitlines()[-1])))
    bad = []
    for i, first in enumerate(runs[0][1]):
        print(f"== {first['shape']}")
        for turn, (tag, rows) in enumerate(runs):
            r = rows[i]
            if "refused" in r:
                print(f"  {turn} {tag:5s} refused: {r['refused']}")
                continue
            print(f"  {turn} {tag:5s} wrapper {r['wrapper_ms']:.4f} ms, kernel {r['kernel_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.5f} ({r['bound_by']}, {r['mbytes']:.3f} MB): kernel at "
                  f"{100 * r['bound_ms'] / r['kernel_ms']:.1f}% of the bound; held {r['held']:.2e}; one call: "
                  + ", ".join(f"{n} {ms:.4f}" for n, ms in r["split"]))
            for name, (ms, held) in r.get("probes", {}).items():
                print(f"        probe {name:10s} kernel {ms:.4f} ms ({100 * r['bound_ms'] / ms:.1f}% of the bound), "
                      f"held {held:.2e}")
                if held > 1e-5:
                    bad.append(f"{r['shape']} probe {name}")
            if tag == "this" and r["held"] > 1e-5:
                bad.append(r["shape"])
    print(f"on {smi}")
    if bad:
        print(f"this tree disagrees with the plain version at {bad}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
