"""Read the control of a cell: the plain reference one precision below the
configuration's (int4 where the configuration states int8), put in the
program's place, judged by the same comparison as a run. A sound check
fails it.

    python3 -m perfbench.controls --workload <cell> --seeds 1,2,3 [--batches N]

Prints one JSON line a seed with the numbers the check compares. Runs on
the card unless ``--device cpu``; the benchmark's own runs never run it."""

from __future__ import annotations

import argparse
import importlib
import json
import sys

import torch

from perfbench import common
from perfbench.spans import Spans


def control(workload: str, seed: int, batches: int, device, bench_dir=common.BENCH_DIR) -> dict:
    wl = common.workload(workload, bench_dir)
    cfg = common.config(wl["config"], bench_dir)
    mix = common.mix(wl["traffic"], bench_dir)
    drv = importlib.import_module(f"perfbench.drivers.{wl['driver']}").Driver(
        cfg, wl, mix, int(seed), torch.device(device), Spans())
    return drv.control(wl["check"]["limits"], int(wl["check"]["rows"]), batches)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--batches", type=int, default=100, help="window batches the rows are sampled from")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    for s in a.seeds.split(","):
        out = control(a.workload, int(s), a.batches, a.device)
        print(json.dumps({"workload": a.workload, "seed": int(s), "control": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
