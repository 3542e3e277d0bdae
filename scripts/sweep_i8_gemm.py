"""Time and hold the int8 tensor-core GEMM (``quantized_layer.cu``'s
``tvc_i8_gemm``) at every tile and split that ``i8_plan`` weighs, on one
NVIDIA GPU.

    python scripts/sweep_i8_gemm.py [--other OTHER_CSRC_DIR [--other-api old|new]] [--ptxas] [--quick]
                                    [--probe NAME,...] [--host]

For each shape of ``chip_smoke.py``'s table (the Qwen2-7B W8A8 GEMMs and
the int8 CLIP layers' GEMMs), the Qwen2-7B prefix prefill's three GEMMs
(M = 15) and each tile of ``I8_TILES``, it prints the
median CUDA-event device time of the kernel (dequantize-to-bf16 epilogue)
with no split and with the split ``i8_plan``'s model prefers for that tile,
the model's estimate, and marks the plan's pick. Every run is held equal,
bit for bit, to the plain int8 product (summed exactly in float64,
dequantized in f32 in the kernel's order). ``--other`` adds another tree's
``tvc_i8_gemm`` built from OTHER_CSRC_DIR (``--other-api old``: the
12-argument entry point of PR 7, its own tiling; ``new``: this tree's entry
point, run at this tree's plan), timed in turns with this tree's plan
(this, other, other, this) and held equal as well. ``--ptxas`` prints ``nvcc -Xptxas -v``'s
registers, spills and shared memory of each kernel of the source.
``--quick`` runs the plan's pick only. ``--probe`` adds copies of this
tree's kernel with one edit each (``PROBES``), timed beside it: ablations
at the plan's pick, whose outputs are wrong (``notranspose`` writes no
K-major weight tile, ``nomma`` issues no wgmma, ``noepilogue`` stores no
output, ``loadonly`` neither transposes nor multiplies, ``halfa`` /
``halfw`` load every other k-tile's activation / weight box only), and
other ring depths at one tile, held equal like the rest.
``--host`` times, instead, the host side of one call of this tree's C
entry point (its two tensor maps included), of the same through
``_i8_gemm`` (the plan's lookup added) and of the other tree's entry point, at a shape whose device time is shorter (M = 64, N = K = 128),
over 2,000 calls each. Exits non-zero on any difference of a kernel
whose outputs should be right.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from tvc_torch.core.kernels import _build  # noqa: E402
from tvc_torch.core.kernels.quantized_layer_kernel import _i8_gemm, _mm_i32  # noqa: E402
from tvc_torch.core.kernels.w8_matmul_kernel import I8_BK, I8_TILES, i8_costed_plans, i8_plan  # noqa: E402

QEPI_DEQUANT_BF16 = 3
CLOCK_HZ = 1.755e9  # the SM clock the model's clocks are read at
SHAPES = (  # (tag, M, N, K)
    ("q|k|v", 576, 4608, 3584), ("o", 576, 3584, 3584), ("gate|up", 576, 37888, 3584),
    ("down", 576, 3584, 18944), ("lm_head", 576, 151936, 3584), ("q|k|v suffix prefill", 4608, 4608, 3584),
    ("vision qkv", 3200, 2304, 768), ("vision out", 3200, 768, 768), ("vision fc", 3200, 3072, 768),
    ("vision proj", 3200, 768, 3072), ("text T=16 qkv", 7168, 1536, 512), ("text T=16 out", 7168, 512, 512),
    ("text T=16 fc", 7168, 2048, 512), ("text T=16 proj", 7168, 512, 2048), ("text T=32 qkv", 14336, 1536, 512),
    ("text T=32 out", 14336, 512, 512), ("text T=32 fc", 14336, 2048, 512), ("text T=32 proj", 14336, 512, 2048),
    ("ViT-L/14 qkv", 2056, 3072, 1024), ("ViT-L/14 out", 2056, 1024, 1024), ("T=300 qkv", 1200, 2304, 768),
    ("T=300 out", 1200, 768, 768), ("q|k|v prefix prefill", 15, 4608, 3584),
    ("gate|up prefix prefill", 15, 37888, 3584), ("down prefix prefill", 15, 3584, 18944),
)


PROBES = {  # name: ([(text of quantized_layer.cu, its replacement), ...], tile or None, outputs right)
    # ablations at the plan's pick: timing probes whose outputs are wrong
    "notranspose": ([("for (int u = tid >> 5; u < BN / 4; u += C::kThreads / 32)",
                      "for (int u = tid >> 5; u < 0; u += C::kThreads / 32)")], None, False),
    "nomma": ([("wgmma_m64n256k32_s8(acc, da, db, 1);", ""), ("wgmma_m64n128k32_s8(acc, da, db, 1);", "")],
              None, False),
    "noepilogue": ([("if (row >= e.M || col >= e.N) continue;", "if (row >= 0) continue;")], None, False),
    "loadonly": ([("for (int u = tid >> 5; u < BN / 4; u += C::kThreads / 32)",
                   "for (int u = tid >> 5; u < 0; u += C::kThreads / 32)"),
                  ("wgmma_m64n256k32_s8(acc, da, db, 1);", ""), ("wgmma_m64n128k32_s8(acc, da, db, 1);", "")],
                 None, False),
    # every other k-tile's activation (weight) box not loaded: its barrier
    # completes on a plain arrival and the stale stage is read again
    "halfa": ([("    mbar_expect_tx(bar, C::kA);\n    tma_load_2d(a_s + (t % SA) * C::kA, &tma, (kt0 + t) * QBK, m0, bar);",
                "    if (t & 1) { asm volatile(\"mbarrier.arrive.shared::cta.b64 _, [%0];\" ::\"r\"(bar) : \"memory\"); return; }\n"
                "    mbar_expect_tx(bar, C::kA);\n    tma_load_2d(a_s + (t % SA) * C::kA, &tma, (kt0 + t) * QBK, m0, bar);")],
              None, False),
    "halfw": ([("    mbar_expect_tx(bar, C::kW);\n    tma_load_2d(w_s + (t % SW) * C::kW, &tmw, n0, (kt0 + t) * QBK, bar);",
                "    if (t & 1) { asm volatile(\"mbarrier.arrive.shared::cta.b64 _, [%0];\" ::\"r\"(bar) : \"memory\"); return; }\n"
                "    mbar_expect_tx(bar, C::kW);\n    tma_load_2d(w_s + (t % SW) * C::kW, &tmw, n0, (kt0 + t) * QBK, bar);")],
              None, False),
    # other ring depths (activation stages, weight stages) of one tile
    "sa2sw3_192x256": ([("launch_i8<3, 256, 3, 2>", "launch_i8<3, 256, 2, 3>")], (192, 256), True),
    "sa3sw3_128x256": ([("launch_i8<2, 256, 4, 2>", "launch_i8<2, 256, 3, 3>")], (128, 256), True),
    "sw4_192x128": ([("launch_i8<3, 128, 4, 2>", "launch_i8<3, 128, 4, 4>")], (192, 128), True),
}


def _time_ms(run, iters: int = 20) -> float:
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


def _model_ms(M, N, K, plan) -> float:
    """i8_plan's cost of ``plan``, in ms at CLOCK_HZ."""
    return 1e3 * next(key[0] for key, p in i8_costed_plans(M, N, K) if p == plan) / CLOCK_HZ


def _best_split(M, N, K, bm, bn):
    """The split i8_plan's model prefers for one tile."""
    return min((key, p) for key, p in i8_costed_plans(M, N, K) if p[:2] == (bm, bn))[1]


def _ptxas() -> None:
    src = REPO / "tvc_torch" / "csrc" / "quantized_layer.cu"
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        out = subprocess.run([*_nvcc_flags(), "-Xptxas", "-v", "-c", "-o", str(Path(tmp) / "q.o"), str(src)],
                             capture_output=True, text=True)
    for line in (out.stdout + out.stderr).splitlines():
        if "i8_gemm" in line or "i8_splitk" in line or "registers" in line or "spill" in line:
            print("ptxas", line.strip())


def _nvcc_flags():
    return [_build._nvcc(), *[f for f in _build.NVCC_FLAGS if f not in ("-shared",)]]


def _copy_build(csrc: Path, tmp: Path, tag: str, edits=()) -> Path:
    """Start nvcc on csrc's quantized_layer.cu (edited) in tmp/tag; (process, library path)."""
    d = tmp / tag
    d.mkdir()
    for f in csrc.iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, d / f.name)
    src = (d / "quantized_layer.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"{tag}: the ablated text is not once in quantized_layer.cu")
        src = src.replace(old, new)
    (d / "quantized_layer.cu").write_text(src)
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "q.so"),
                             str(d / "quantized_layer.cu")]), d / "q.so"


def _wait(job) -> Path:
    proc, so = job
    if proc.wait() != 0:
        raise RuntimeError(f"nvcc failed for {so.parent.name}")
    return so


def _load_other(so: Path):
    f = ctypes.CDLL(str(so)).tvc_i8_gemm
    f.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


class _Library:
    """A built copy's library, called as _i8_gemm calls the loaded one."""

    def __init__(self, so: Path):
        self.tvc_i8_gemm = ctypes.CDLL(str(so)).tvc_i8_gemm
        self.tvc_i8_gemm.argtypes = _build.SIGNATURES["quantized_layer"]["tvc_i8_gemm"]
        self.tvc_i8_gemm.restype = ctypes.c_int


def _host_us(lib, other, other_api, gen, stream, calls: int = 2000) -> int:
    """Host microseconds a call, this tree's entry point and the other's."""
    M, N, K = 64, 128, 128
    a = torch.randint(-127, 128, (M, K), generator=gen, device="cuda", dtype=torch.int8)
    w = torch.randint(-127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8)
    rs, cs = torch.rand(M, device="cuda"), torch.rand(N, device="cuda")
    out = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
    bm, bn, splits, per = i8_plan(M, N, K)
    runs = {
        "this": lambda: lib.tvc_i8_gemm(a.data_ptr(), rs.data_ptr(), w.data_ptr(), cs.data_ptr(), None, None,
                                        out.data_ptr(), None, M, N, K, QEPI_DEQUANT_BF16, bm, bn, splits, per, stream),
        "this through _i8_gemm": lambda: _i8_gemm(lib, a, rs, w, cs, None, None, out, QEPI_DEQUANT_BF16, stream),
    }
    if other is not None:
        runs["other"] = (
            (lambda: other(a.data_ptr(), rs.data_ptr(), w.data_ptr(), cs.data_ptr(), None, None, out.data_ptr(),
                           M, N, K, QEPI_DEQUANT_BF16, stream))
            if other_api == "old" else
            (lambda: _i8_gemm(other, a, rs, w, cs, None, None, out, QEPI_DEQUANT_BF16, stream)))
    times = {name: [] for name in runs}
    for name in ("this", "this through _i8_gemm", "other", "other", "this through _i8_gemm", "this"):
        if name not in runs:
            continue
        for _ in range(50):
            runs[name]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            runs[name]()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        times[name].append(1e6 * (t1 - t0) / calls)
    print("host us a call (enqueue only, M=64 N=128 K=128): "
          + "; ".join(f"{k} {statistics.mean(v):.2f} {v}" for k, v in times.items()), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="another tree's tvc_torch/csrc")
    ap.add_argument("--other-api", choices=("old", "new"), default="old",
                    help="old: tvc_i8_gemm's 12-argument form (its own tiling); new: this tree's, run at this plan")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--probe", default="", help="comma-separated names of PROBES")
    ap.add_argument("--host", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    (REPO / "build").mkdir(exist_ok=True)
    if args.ptxas:
        _ptxas()
    lib = _build.load("quantized_layer")
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = 0
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        csrc = REPO / "tvc_torch" / "csrc"
        probes = {name: PROBES[name] for name in args.probe.split(",") if name}
        jobs = {name: _copy_build(csrc, Path(tmp), name, probe[0]) for name, probe in probes.items()}
        if args.other:
            jobs["other"] = _copy_build(Path(args.other), Path(tmp), "other")
        libs = {name: _wait(job) for name, job in jobs.items()}
        other = None
        if args.other:
            so = libs.pop("other")
            other = _load_other(so) if args.other_api == "old" else _Library(so)
        ablated = {name: _Library(so) for name, so in libs.items()}
        if args.host:
            return _host_us(lib, other, args.other_api, gen, stream)
        for tag, M, N, K in SHAPES:
            a = torch.randint(-127, 128, (M, K), generator=gen, device="cuda", dtype=torch.int8)
            w = torch.randint(-127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8)
            rs = torch.rand(M, generator=gen, device="cuda") * 1e-2
            cs = torch.rand(N, generator=gen, device="cuda") * 1e-2
            want = (_mm_i32(a, w) * rs[:, None] * cs).to(torch.bfloat16)
            plan = i8_plan(M, N, K)
            cands = [plan] if args.quick else []
            if not args.quick:
                for bm, bn in I8_TILES:
                    nk = -(-K // I8_BK)
                    for p in ((bm, bn, 1, nk), _best_split(M, N, K, bm, bn)):
                        if p not in cands:
                            cands.append(p)
            out = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
            line = []
            for p in cands:
                run = lambda p=p: _i8_gemm(lib, a, rs, w, cs, None, None, out, QEPI_DEQUANT_BF16, stream, plan=p)
                run()
                torch.cuda.synchronize()
                first = out.clone()
                run()
                torch.cuda.synchronize()
                ok = torch.equal(first, want) and torch.equal(out, want)
                bad += not ok
                ms = _time_ms(run)
                bm, bn, splits, per = p
                line.append(f"{bm}x{bn}/{splits}{'*' if p == plan else ''}: {ms:.4f} (model {_model_ms(M, N, K, p):.4f})"
                            + ("" if ok else " DIFFERS"))
            print(f"{tag} M={M} N={N} K={K} plan={plan}: " + "; ".join(line), flush=True)
            for name, alib in ablated.items():
                _, tile, right = probes[name]
                at = plan if tile is None else _best_split(M, N, K, *tile)
                run_t = lambda: _i8_gemm(lib, a, rs, w, cs, None, None, out, QEPI_DEQUANT_BF16, stream, plan=at)
                run_p = lambda: _i8_gemm(alib, a, rs, w, cs, None, None, out, QEPI_DEQUANT_BF16, stream, plan=at)
                if right:
                    run_p()
                    torch.cuda.synchronize()
                    ok = torch.equal(out, want)
                    bad += not ok
                t = {"this": [], name: []}
                for who in ("this", name, name, "this"):
                    t[who].append(_time_ms(run_t if who == "this" else run_p))
                print(f"  probe {name} {tag} at {at}: this {statistics.mean(t['this']):.4f} ms, "
                      f"{name} {statistics.mean(t[name]):.4f} ms" + (("" if ok else " DIFFERS") if right else ""),
                      flush=True)
            if other is not None:
                o_out = torch.empty_like(out)
                if args.other_api == "old":
                    run_o = lambda: other(a.data_ptr(), rs.data_ptr(), w.data_ptr(), cs.data_ptr(), None, None,
                                          o_out.data_ptr(), M, N, K, QEPI_DEQUANT_BF16, stream)
                else:
                    run_o = lambda: _i8_gemm(other, a, rs, w, cs, None, None, o_out, QEPI_DEQUANT_BF16, stream,
                                             plan=plan) or 0
                run_t = lambda: _i8_gemm(lib, a, rs, w, cs, None, None, out, QEPI_DEQUANT_BF16, stream, plan=plan)
                if run_o():
                    raise RuntimeError("the other tree's tvc_i8_gemm failed")
                torch.cuda.synchronize()
                same = torch.equal(o_out, want)
                bad += not same
                t = {"this": [], "other": []}
                for name in ("this", "other", "other", "this"):
                    t[name].append(_time_ms(run_t if name == "this" else run_o))
                print(f"  other {tag}: this {statistics.mean(t['this']):.4f} ms, other {statistics.mean(t['other']):.4f} ms"
                      f" ({t['this']} / {t['other']}), other equal: {same}", flush=True)
            del a, w, want, out
    print(f"sweep done: {bad} runs differ from the plain product")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
