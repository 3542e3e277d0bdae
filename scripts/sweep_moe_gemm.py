"""Time and hold the grouped w8 expert GEMM (``moe_w8.cu``'s
``tvc_moe_w8_grouped``) at every row tile ``moe_plan`` chooses from, on one
NVIDIA GPU.

    python scripts/sweep_moe_gemm.py [--other OTHER_CSRC_DIR] [--ptxas] [--quick] [--json PATH]

For each shape of ``chip_smoke.MOE_CASES`` (DeepSeek-V2-Lite's and
Kimi-Linear's decode and prefill expert GEMMs, rows spread over the experts
by ``chip_smoke.moe_spread``) and each row tile of ``MOE_ROWS`` it prints
the median CUDA-event device time, the bound (``perfbench/work_moe.py``:
the busy experts' weights and the rows at 3.35 TB/s, or the products at
989 TF/s) and the kernel's share of it, and marks the plan's pick. Every
run is held to the plain version (``chip_smoke.W8_TOL``, scaled) and two
calls to the same bits. ``--other`` adds another tree's ``moe_w8.cu`` with
the entry point before row tiles (x, w, scale, offsets, out, M, E, N, K,
stream), built here with nvcc and timed in turns with this tree's plan
(this, other, other, this). ``--ptxas`` prints ``nvcc -Xptxas -v``'s
registers, spills and shared memory of each kernel of the source.
``--quick`` times the plan's pick only; ``--json`` writes the table to
PATH as well. Exits non-zero on any disagreement.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from perfbench import work, work_moe  # noqa: E402
from tvc_torch.core.kernels import _build, quantize_linear  # noqa: E402
from tvc_torch.core.kernels.moe_kernel import (  # noqa: E402
    MOE_ROWS,
    moe_plan,
    moe_stages,
    moe_w8_grouped_reference,
)


def _nvcc_flags():
    return [_build._nvcc(), *[f for f in _build.NVCC_FLAGS if f != "-shared"]]


def _ptxas() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run([*_nvcc_flags(), "-Xptxas", "-v", "-c", "-o", str(Path(tmp) / "m.o"),
                              str(_build.CSRC_DIR / "moe_w8.cu")], capture_output=True, text=True)
    print(out.stdout + out.stderr, flush=True)


def _other(csrc: Path, tmp: Path):
    so = tmp / "moe_w8_other.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(csrc / "moe_w8.cu")], check=True)
    lib = ctypes.CDLL(str(so))
    fn = lib.tvc_moe_w8_grouped
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="another tree's tvc_torch/csrc")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--json", help="write the table here too")
    args = ap.parse_args(argv)
    if args.ptxas:
        _ptxas()
    dev = torch.device("cuda", 0)
    lib = _build.load("moe_w8")
    tmp = tempfile.TemporaryDirectory()
    other = _other(Path(args.other), Path(tmp.name)) if args.other else None
    gen = torch.Generator(device=dev).manual_seed(26)
    rows_out, bad = [], 0
    for case, tag, E, K, N in cs.MOE_CASES:
        counts = cs.moe_spread(case)
        M, busy = int(counts.sum()), int((counts > 0).sum())
        off = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32, device=dev)
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        w, s = quantize_linear(torch.randn((E, K, N), generator=gen, device=dev) / math.sqrt(K))
        want = moe_w8_grouped_reference(x, w, s, off)
        out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        ops, nbytes = work_moe.expert_gemm(M, K, N, busy)
        bms, by = cs.bound_ms_of(nbytes, work.peak_seconds(ops))
        plan = moe_plan(M, E, N, K)

        def ours(rows, o=out):
            _build.check(lib.tvc_moe_w8_grouped(x.data_ptr(), w.data_ptr(), s.data_ptr(), off.data_ptr(),
                                                o.data_ptr(), M, E, N, K, rows, moe_stages(rows), stream),
                         "tvc_moe_w8_grouped")
            return o

        def theirs(o=out):
            _build.check(other(x.data_ptr(), w.data_ptr(), s.data_ptr(), off.data_ptr(), o.data_ptr(), M, E, N, K,
                               stream), "other tvc_moe_w8_grouped")
            return o

        def held(run, name):
            nonlocal bad
            got = run().clone()
            again = run().clone()
            torch.cuda.synchronize()
            _, rel = cs._layer_error(got, want)
            same = torch.equal(got, again)
            if not (rel <= cs.W8_TOL and same):
                bad += 1
                print(f"DIFFERS {tag} {name}: scaled error {rel:.3e}, two calls equal {same}", flush=True)
            return rel

        for rows in (plan.rows,) if args.quick else MOE_ROWS:
            rel = held(lambda: ours(rows), f"swap{rows}")
            ms = cs.time_ms(lambda: ours(rows))
            pick = " <- plan" if rows == plan.rows else ""
            print(f"{tag} M={M} E={E} K={K} N={N} max rows {int(counts.max())}: swap{rows} ({moe_stages(rows)} "
                  f"stages) {ms:.4f} ms, bound {bms:.4f} ({by}), {100 * bms / ms:.1f} % of it, err {rel:.2e}{pick}",
                  flush=True)
            rows_out.append({"case": tag, "M": M, "E": E, "K": K, "N": N, "rows": rows, "ms": ms, "bound_ms": bms,
                             "bound_by": by, "plan": bool(pick)})
        if other is not None:
            rel = held(theirs, "other")
            mine = lambda: ours(plan.rows)  # noqa: E731
            turns = [cs.time_ms(f) for f in (mine, theirs, theirs, mine)]
            print(f"{tag}: this {turns[0]:.4f} / {turns[3]:.4f} ms, other {turns[1]:.4f} / {turns[2]:.4f} ms "
                  f"(x{(turns[1] + turns[2]) / (turns[0] + turns[3]):.2f}), other err {rel:.2e}", flush=True)
            rows_out.append({"case": tag, "this_ms": [turns[0], turns[3]], "other_ms": [turns[1], turns[2]]})
        del x, w, s, want, out
        torch.cuda.empty_cache()
    if args.json:
        Path(args.json).write_text(json.dumps({"device": torch.cuda.get_device_name(0), "rows": rows_out}, indent=1))
    tmp.cleanup()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
