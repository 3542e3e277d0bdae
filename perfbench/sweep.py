"""Find the serving cell's knee: the highest offered rate at which, over a
window, the backlog does not grow and the generator keeps its schedule.
One process, one set-up, one window a rate:

    python3 -m perfbench.sweep --workload clip-vit-b32-int8.saturated --rates 500,1000,2000 --seconds 8

Prints a JSON line a rate: offered and achieved queries/s, the latency
percentiles from due to answer, the generator's lateness, and the backlog
trend (the median latency of the window's last third over its first
third). A cell under the knee, at about 0.8 of it, holds the tail; a cell
above it, as ``saturated`` is, holds the served rate."""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from perfbench import common
from perfbench.drivers import SubWindow
from perfbench.drivers.serve_open import Driver
from perfbench.spans import Spans


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--seed", type=int, default=7)
    a = p.parse_args(argv)
    wl = common.workload(a.workload)
    d = Driver(common.config(wl["config"]), wl, common.mix(wl["traffic"]), a.seed, torch.device("cuda", 0), Spans())
    d.setup()
    for rate in (float(r) for r in a.rates.split(",")):
        w = d.window(a.seconds, SubWindow(False, 0, 0, None, None), rate=rate)
        lat = w["latency_ms"]  # sorted
        third = len(lat) // 3
        first, last = d.req_latency[:third], d.req_latency[-third:]  # requests in due order
        print(json.dumps({
            "offered_qps": rate, "achieved_qps": w["e2e"]["serve_qps"], "requests": len(lat),
            "p50_ms": float(lat[len(lat) // 2]), "p95_ms": w["e2e"]["serve_p95_ms"],
            "p99_ms": float(lat[int(np.ceil(0.99 * len(lat))) - 1]),
            "late_p99_ms": w["generator"]["late_p99_ms"], "failed": w["failed"],
            "backlog_trend": float(np.median(last) / np.median(first)), "batch_fill": d.fill,
        }), flush=True)
    d.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
