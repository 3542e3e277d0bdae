"""Time and hold the bf16 layer GEMM (``attention_layer.cu``'s
``tvc_bf16_gemm``) at every tile and split that ``bf16_plan`` weighs, on one
NVIDIA GPU.

    python scripts/sweep_bf16_gemm.py [--other OTHER_CSRC_DIR] [--ptxas] [--quick] [--probe NAME,...]
                                      [--layers]

For each GEMM of the bf16 CLIP layers (vision B=64 T=50 W=768, text B=448
at T=16 and T=32 W=512, ViT-L/14 B=8 T=257 W=1024, B=4 T=300 W=768) and
each tile of ``BF16_TILES``, it prints the median CUDA-event device time of
the GEMM with its layer's epilogue, with no split and with the split
``bf16_plan``'s model prefers for that tile, the model's estimate, and
marks the plan's pick; then cuBLAS (``a @ w``, bf16) on the same operands,
and for the GEMMs that follow a LayerNorm the LayerNorm row kernel. Every
run is held to the plain version (f32 sums of the bf16 products, the
epilogue in f32, one rounding: 1e-2 of max(1, |y|)) and two calls to the
same bits. ``--other`` adds another tree's ``tvc_ln_gemm`` (the entry point
of the WMMA kernel it replaced, LayerNorm in its prologue) built from
OTHER_CSRC_DIR, timed in turns with this tree's LayerNorm + GEMM (this,
other, other, this) and held to the same plain version (3e-2, its
LayerNorm rounds element by element). ``--layers`` times whole layers
instead: this tree's ``fused_attention_layer`` / ``fused_mlp_layer``
against the other tree's three / two launches, in turns. ``--ptxas``
prints ``nvcc -Xptxas -v``'s registers, spills and shared memory of the
GEMM kernels. ``--quick`` runs the plan's pick only. ``--probe`` adds
copies of this tree's kernel with one edit each (``PROBES``), timed beside
it at the plan's pick: ablations whose outputs are wrong (``nomma`` issues
no wgmma, ``noepilogue`` stores no output, ``loadonly`` does neither) and
other ring depths of one tile, held like the rest. Exits non-zero on any
difference of a kernel whose outputs should be right.
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

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from tvc_torch.core.kernels import _build  # noqa: E402
from tvc_torch.core.kernels import attention_layer_kernel as alk  # noqa: E402

CLOCK_HZ = 1.755e9  # the SM clock the model's clocks are read at
EPS = 1e-5
TOL, OTHER_TOL = 1e-2, 3e-2
LAYERS = (  # (tag, B, T, W, heads, causal)
    ("vision", 64, 50, 768, 12, False), ("text T=16", 448, 16, 512, 8, True), ("text T=32", 448, 32, 512, 8, True),
    ("ViT-L/14", 8, 257, 1024, 16, False), ("T=300", 4, 300, 768, 12, False),
)


def gemm_shapes():
    """(tag, M, N, K, epilogue, after a LayerNorm) of every layer GEMM."""
    out = []
    for tag, B, T, W, _, _ in LAYERS:
        M = B * T
        out += [(f"{tag} qkv", M, 3 * W, W, alk.EPI_BIAS, True), (f"{tag} out", M, W, W, alk.EPI_RESIDUAL, False)]
        if tag not in ("ViT-L/14", "T=300"):
            out += [(f"{tag} fc", M, 4 * W, W, alk.EPI_GELU, True),
                    (f"{tag} proj", M, W, 4 * W, alk.EPI_RESIDUAL, False)]
    return out


NOMMA = [(f"wgmma_m64n{n}_ss<1>(acc, da, db, 1);", "") for n in (256, 192, 128)]
NOEPILOGUE = [("if (row >= e.M || col >= e.N) continue;", "if (row >= 0) continue;")]
PROBES = {  # name: ([(text of attention_layer.cu, its replacement everywhere), ...], tile or None, outputs right)
    # ablations at the plan's pick: timing probes whose outputs are wrong
    "nomma": (NOMMA, None, False),
    "noepilogue": (NOEPILOGUE, None, False),
    "loadonly": (NOMMA + NOEPILOGUE, None, False),
    # every other k-tile's weight (activation) boxes not loaded: the stale
    # stage is read again; the L2 traffic a cluster multicast would save
    "halfw": ([("mbar_expect_tx(bar, C::kA + C::kB);", "mbar_expect_tx(bar, C::kA + (t & 1 ? 0 : C::kB));"),
               ("for (int j = 0; j < BN / 64; ++j) tma_load_2d(", "for (int j = 0; j < (t & 1 ? 0 : BN / 64); ++j) tma_load_2d(")],
              None, False),
    "halfa": ([("mbar_expect_tx(bar, C::kA + C::kB);", "mbar_expect_tx(bar, (t & 1 ? 0 : C::kA) + C::kB);"),
               ("tma_load_2d(a_s + slot * C::kA, &tma, k0, m0, bar);", "if (!(t & 1)) tma_load_2d(a_s + slot * C::kA, &tma, k0, m0, bar);")],
              None, False),
    # the block barrier of each k-tile left out (a race: timing only)
    "nosync": ([("    __syncthreads();\n    if (tid == 0 && t >= 1 && t - 1 + S < n) issue(t - 1 + S);",
                 "    if (tid == 0 && t >= 1 && t - 1 + S < n) issue(t - 1 + S);")], None, False),
    # other ring depths of one tile
    "s3_128x256": ([("launch_bf16<2, 256, 4>", "launch_bf16<2, 256, 3>")], (128, 256), True),
    "s3_128x192": ([("launch_bf16<2, 192, 4>", "launch_bf16<2, 192, 3>")], (128, 192), True),
    "s6_64x128": ([("launch_bf16<1, 128, 4>", "launch_bf16<1, 128, 6>")], (64, 128), True),
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


def _turns(runs: dict) -> dict:
    """Mean ms of each run timed in turns: a, b, b, a."""
    names = list(runs)
    t = {n: [] for n in names}
    for n in names + names[::-1]:
        t[n].append(_time_ms(runs[n]))
    return {n: statistics.mean(v) for n, v in t.items()}


def _scaled_err(got, want) -> float:
    return float(((got.float() - want.float()).abs() / want.float().abs().clamp(min=1.0)).max())


def _model_ms(M, N, K, plan) -> float:
    """bf16_plan's cost of ``plan``, in ms at CLOCK_HZ."""
    return 1e3 * next(key[0] for key, p in alk.bf16_costed_plans(M, N, K) if p == plan) / CLOCK_HZ


def _best_split(M, N, K, bm, bn):
    return min((key, p) for key, p in alk.bf16_costed_plans(M, N, K) if p[:2] == (bm, bn))[1]


def _nvcc_flags():
    return [_build._nvcc(), *[f for f in _build.NVCC_FLAGS if f != "-shared"]]


def _ptxas() -> None:
    src = REPO / "tvc_torch" / "csrc" / "attention_layer.cu"
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        out = subprocess.run([*_nvcc_flags(), "-Xptxas", "-v", "-c", "-o", str(Path(tmp) / "a.o"), str(src)],
                             capture_output=True, text=True)
    for line in (out.stdout + out.stderr).splitlines():
        if any(w in line for w in ("bf16_gemm", "splitk", "layernorm", "registers", "spill", "error")):
            print("ptxas", line.strip())


def _copy_build(csrc: Path, tmp: Path, tag: str, edits=()):
    """Start nvcc on csrc's attention_layer.cu (edited) in tmp/tag; (process, library path)."""
    d = tmp / tag
    d.mkdir()
    for f in csrc.iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, d / f.name)
    src = (d / "attention_layer.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise ValueError(f"{tag}: the edited text is not in attention_layer.cu")
        src = src.replace(old, new)
    (d / "attention_layer.cu").write_text(src)
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "a.so"),
                             str(d / "attention_layer.cu")]), d / "a.so"


def _wait(job) -> Path:
    proc, so = job
    if proc.wait() != 0:
        raise RuntimeError(f"nvcc failed for {so.parent.name}")
    return so


class _Library:
    """A built copy's library with this tree's entry points."""

    def __init__(self, so: Path):
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _build.SIGNATURES["attention_layer"].items():
            f = getattr(lib, fn)
            f.argtypes, f.restype = argtypes, ctypes.c_int
            setattr(self, fn, f)


class _Other:
    """The other tree's library: tvc_ln_gemm(a, ln_scale, ln_bias, w, bias,
    residual, out, M, N, K, eps, has_ln, epilogue, stream) and
    tvc_head_attention(qkv, out, seqs, T, W, heads, causal, stream)."""

    def __init__(self, so: Path):
        lib = ctypes.CDLL(str(so))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self.ln_gemm = lib.tvc_ln_gemm
        self.ln_gemm.argtypes = [P] * 7 + [I, I, I, F, I, I, P]
        self.attention = lib.tvc_head_attention
        self.attention.argtypes = [P, P, I, I, I, I, I, P]
        for f in (self.ln_gemm, self.attention):
            f.restype = ctypes.c_int

    def gemm(self, a, g, b, w, bias, res, out, has_ln, epilogue, stream):
        M, K = a.shape
        N = w.shape[1]
        ptr = lambda t: None if t is None else t.data_ptr()
        _build.check(self.ln_gemm(a.data_ptr(), ptr(g), ptr(b), w.data_ptr(), bias.data_ptr(), ptr(res),
                                  out.data_ptr(), M, N, K, EPS, int(has_ln), epilogue, stream), "other tvc_ln_gemm")

    def attention_layer(self, x, g, b, wqkv, bqkv, wout, bout, heads, causal, stream):
        B, T, W = x.shape
        x2 = x.view(B * T, W)
        qkv = torch.empty((B * T, 3 * W), dtype=x.dtype, device=x.device)
        self.gemm(x2, g, b, wqkv, bqkv, None, qkv, True, alk.EPI_BIAS, stream)
        attn = torch.empty_like(x2)
        _build.check(self.attention(qkv.data_ptr(), attn.data_ptr(), B, T, W, heads, int(causal), stream),
                     "other tvc_head_attention")
        out = torch.empty_like(x2)
        self.gemm(attn, None, None, wout, bout, x2, out, False, alk.EPI_RESIDUAL, stream)
        return out.view(B, T, W)

    def mlp_layer(self, x, g, b, wfc, bfc, wproj, bproj, stream):
        B, T, W = x.shape
        x2 = x.view(B * T, W)
        hidden = torch.empty((B * T, wfc.shape[1]), dtype=x.dtype, device=x.device)
        self.gemm(x2, g, b, wfc, bfc, None, hidden, True, alk.EPI_GELU, stream)
        out = torch.empty_like(x2)
        self.gemm(hidden, None, None, wproj, bproj, x2, out, False, alk.EPI_RESIDUAL, stream)
        return out.view(B, T, W)


def _plain(a, w, bias, res, epilogue):
    v = a.float() @ w.float() + bias
    if epilogue == alk.EPI_GELU:
        v = v * torch.sigmoid(1.702 * v)
    if epilogue == alk.EPI_RESIDUAL:
        v = res.float() + v
    return v.bfloat16()


def _layers(other, gen, stream) -> int:
    """Whole layers, this tree's wrappers against the other tree's launches."""
    bad = 0
    for tag, B, T, W, H, causal in LAYERS:
        f = lambda *shape, scale=1.0: (torch.randn(shape, generator=gen, device="cuda") * scale)
        x = f(B, T, W).bfloat16()
        g, b = 1 + f(W, scale=0.1), f(W, scale=0.1)
        wqkv, bqkv = f(W, 3 * W, scale=W ** -0.5).bfloat16(), f(3 * W, scale=0.02)
        wout, bout = f(W, W, scale=W ** -0.5).bfloat16(), f(W, scale=0.02)
        wfc, bfc = f(W, 4 * W, scale=W ** -0.5).bfloat16(), f(4 * W, scale=0.02)
        wproj, bproj = f(4 * W, W, scale=(4 * W) ** -0.5).bfloat16(), f(W, scale=0.02)
        cases = [("attention", lambda: alk.fused_attention_layer(x, g, b, wqkv, bqkv, wout, bout, H, causal=causal),
                  lambda: other.attention_layer(x, g, b, wqkv, bqkv, wout, bout, H, causal, stream),
                  lambda: alk.attention_layer_reference(x, g, b, wqkv, bqkv, wout, bout, H, causal=causal))]
        if tag not in ("ViT-L/14", "T=300"):
            cases.append(("mlp", lambda: alk.fused_mlp_layer(x, g, b, wfc, bfc, wproj, bproj),
                          lambda: other.mlp_layer(x, g, b, wfc, bfc, wproj, bproj, stream),
                          lambda: alk.mlp_layer_reference(x, g, b, wfc, bfc, wproj, bproj)))
        for kind, run_t, run_o, run_p in cases:
            want = run_p()
            e_t, e_o = _scaled_err(run_t(), want), _scaled_err(run_o(), want)
            bad += e_t > OTHER_TOL or e_o > OTHER_TOL
            t = _turns({"this": run_t, "other": run_o})
            print(f"layer {kind} {tag} B={B} T={T} W={W}: this {t['this']:.4f} ms, other {t['other']:.4f} ms "
                  f"({t['other'] / t['this']:.2f}x); scaled err this {e_t:.2e} other {e_o:.2e}", flush=True)
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="another tree's tvc_torch/csrc (with tvc_ln_gemm)")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--probe", default="", help="comma-separated names of PROBES")
    ap.add_argument("--layers", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    (REPO / "build").mkdir(exist_ok=True)
    if args.ptxas:
        _ptxas()
    lib = _build.load("attention_layer")
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = 0
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        probes = {name: PROBES[name] for name in args.probe.split(",") if name}
        jobs = {name: _copy_build(REPO / "tvc_torch" / "csrc", Path(tmp), name, p[0]) for name, p in probes.items()}
        if args.other:
            jobs["other"] = _copy_build(Path(args.other), Path(tmp), "other")
        libs = {name: _wait(job) for name, job in jobs.items()}
        other = _Other(libs.pop("other")) if args.other else None
        ablated = {name: _Library(so) for name, so in libs.items()}
        if args.layers:
            if other is None:
                raise SystemExit("--layers needs --other")
            bad = _layers(other, gen, stream)
            print(f"sweep done: {bad} layers off the plain version")
            return 1 if bad else 0
        for tag, M, N, K, epi, has_ln in gemm_shapes():
            f = lambda *shape, scale=1.0: (torch.randn(shape, generator=gen, device="cuda") * scale)
            x = f(M, K).bfloat16()
            g, b = 1 + f(K, scale=0.1), f(K, scale=0.1)
            a = alk._layernorm_rows(lib, x, g, b, EPS, stream) if has_ln else x
            w, bias = f(K, N, scale=K ** -0.5).bfloat16(), f(N, scale=0.02)
            res = f(M, N).bfloat16() if epi == alk.EPI_RESIDUAL else None
            want = _plain(a, w, bias, res, epi)
            plan = alk.bf16_plan(M, N, K)
            cands = [plan]
            if not args.quick:
                nk = -(-K // alk.BF16_BK)
                for bm, bn in alk.BF16_TILES:
                    for p in ((bm, bn, 1, nk), _best_split(M, N, K, bm, bn)):
                        if p not in cands:
                            cands.append(p)
            line = []
            for p in cands:
                run = lambda p=p: alk._gemm(lib, a, w, bias, res, epi, stream, plan=p)
                first, again = run(), run()
                torch.cuda.synchronize()
                err = _scaled_err(first, want)
                ok = err <= TOL and torch.equal(first, again)
                bad += not ok
                ms = _time_ms(run)
                bm, bn, splits, _ = p
                line.append(f"{bm}x{bn}/{splits}{'*' if p == plan else ''}: {ms:.4f} (model {_model_ms(M, N, K, p):.4f})"
                            + ("" if ok else f" DIFFERS ({err:.2e})"))
            cublas = _time_ms(lambda: a @ w)
            flops = 2 * M * N * K
            pick = _time_ms(lambda: alk._gemm(lib, a, w, bias, res, epi, stream))
            ln = f"; LayerNorm rows {_time_ms(lambda: alk._layernorm_rows(lib, x, g, b, EPS, stream)):.4f}" if has_ln else ""
            print(f"{tag} M={M} N={N} K={K} plan={plan}: " + "; ".join(line)
                  + f"; cuBLAS {cublas:.4f} ms; pick at {flops / pick / 1e9:.1f} TF/s, {pick / cublas:.2f}x cuBLAS" + ln,
                  flush=True)
            for name, alib in ablated.items():
                _, tile, right = probes[name]
                at = plan if tile is None else _best_split(M, N, K, *tile)
                run_t = lambda: alk._gemm(lib, a, w, bias, res, epi, stream, plan=at)
                run_p = lambda: alk._gemm(alib, a, w, bias, res, epi, stream, plan=at)
                mark = ""
                if right:
                    err = _scaled_err(run_p(), want)
                    bad += err > TOL
                    mark = "" if err <= TOL else f" DIFFERS ({err:.2e})"
                t = _turns({"this": run_t, name: run_p})
                print(f"  probe {name} {tag} at {at}: this {t['this']:.4f} ms, {name} {t[name]:.4f} ms{mark}", flush=True)
            if other is not None:
                o_out = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
                if has_ln:
                    run_t = lambda: alk._gemm(lib, alk._layernorm_rows(lib, x, g, b, EPS, stream), w, bias, res, epi, stream)
                    run_o = lambda: other.gemm(x, g, b, w, bias, res, o_out, True, epi, stream)
                else:
                    run_t = lambda: alk._gemm(lib, x, w, bias, res, epi, stream)
                    run_o = lambda: other.gemm(x, None, None, w, bias, res, o_out, False, epi, stream)
                run_o()
                err = _scaled_err(o_out, want)
                bad += err > OTHER_TOL
                t = _turns({"this": run_t, "other": run_o})
                print(f"  other {tag}{' (LayerNorm + GEMM)' if has_ln else ''}: this {t['this']:.4f} ms, "
                      f"other {t['other']:.4f} ms ({t['other'] / t['this']:.2f}x), other's scaled err {err:.2e}",
                      flush=True)
            del x, a, w, res, want
    print(f"sweep done: {bad} runs off the plain version")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
