"""Run one cell of the benchmark once.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell asks
for. Prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``: each number the
correctness check compared, with its limit. The same numbers close
standard error. Exits non-zero, printing no result, where no card is
present, where fewer cards than the cell asks for are, or where the JAX
package or JAX was loaded."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict  # noqa: E402

from perfbench import common  # noqa: E402


class NoCard(RuntimeError):
    pass


def load_reader(name: str, bench_dir: Path):
    """``metrics/<name>.py``'s ``read(ctx)``, loaded by path (names hold dots)."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Context:
    """What a per-layer metric reader may read."""

    def __init__(self, driver, trace, sub):
        self.driver, self.trace, self.sub = driver, trace, sub
        self._work = None

    @property
    def work(self) -> Dict:
        if self._work is None:
            self._work = self.driver.work(self.sub.steps)
        return self._work


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device=None,
             bench_dir: Path = common.BENCH_DIR, root: Path = common.ROOT, t_start: float = T_START) -> Dict:
    """Build, warm up, measure and judge one cell; return the result line's
    object. ``device`` None: the card, which must be there."""
    import torch

    from perfbench.drivers import SubWindow
    from perfbench.spans import Spans
    from perfbench.trace import Trace

    wl = common.workload(workload, bench_dir)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(wl["chips"]):
            raise NoCard(f"cell {workload} needs {wl['chips']} card(s); "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    common.set_cache_env()
    spec = common.benchmark_spec(root)
    wanted = common.cell_metrics(spec, workload)
    cfg = common.config(wl["config"], bench_dir)
    mix = common.mix(wl["traffic"], bench_dir)
    drv_mod = importlib.import_module(f"perfbench.drivers.{wl['driver']}")
    spans = Spans()
    driver = drv_mod.Driver(cfg, wl, mix, int(seed), device, spans)

    driver.setup()
    if trace:
        driver.instrument()
    trace_path = common.CACHE_DIR / "trace.json"
    tw = wl.get("trace_window", {})
    sub = SubWindow(bool(trace) and device.type == "cuda", int(tw.get("first", 2)), int(tw.get("count", 4)),
                    trace_path, spans)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    win = driver.window(float(seconds), sub)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    metrics: Dict[str, Dict] = {}
    breakdown = None
    dev_info: Dict = {
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": int(wl["chips"]),
        "memory_peak_bytes": int(peak),
    }
    if device.type == "cuda":
        dev_info["power_limit_w"] = common.power_limit_w()
    if not trace:
        values = dict(win["e2e"], setup_s=setup_s)
        for m in wanted["end_to_end"]:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    elif sub.done:
        tr = Trace.load(trace_path)
        ctx = Context(driver, tr, sub)
        for m in wanted["per_layer"]:
            v = load_reader(m["name"], bench_dir)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_info["busy_s"] = tr.busy_s
        dev_info["window_s"] = tr.window_s
        breakdown = {"device_ops": [[n, s] for n, s in tr.device_ops()],
                     "idle_gaps": [[n, s] for n, s in tr.idle_gaps()]}
    spans.restore()

    driver.free()
    _refuse_jax()
    chk = wl["check"]
    readings = driver.check(chk["limits"], int(chk["rows"]))
    checks = {k: {"value": readings[k], "limit": lim} for k, lim in chk["limits"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and win["failed"] == 0
    out = {"correct": bool(correct), "attempted": int(win["attempted"]), "failed": int(win["failed"]),
           "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if "generator" in win:
        out["generator"] = win["generator"]
    out["checks"] = checks
    _refuse_jax()
    return out


def _refuse_jax() -> None:
    loaded = common.forbidden_loaded()
    if loaded:
        raise RuntimeError(f"loaded in the run's process: {', '.join(loaded)}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    try:
        out = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    except NoCard as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 3
    if "generator" in out:
        print(f"generator: {json.dumps(out['generator'])}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
