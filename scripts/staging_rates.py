"""Measure the rates behind the pinned pixel upload on one NVIDIA GPU.

    python scripts/staging_rates.py [--rows 256] [--reps 10]

For a [rows, 224, 224, 3] f32 batch of pixels in pageable numpy memory
(154 MB at 256 rows) it prints one JSON line: the card's name and power
limit; the host copy into a pinned buffer (``copy_``) at 1, 4 and 8
intra-op threads (GB/s), and from a thread of its own at the default
count, as the stager's worker makes it; the pinned buffer's copy to the
card on a stream of its own, timed with CUDA events; the pageable copy the
serving step made before (``torch.as_tensor`` to the card); and a whole
upload through
``tvc_torch.core.staging`` (``start`` then ``wait``, synchronised). Each
figure is the median of ``--reps`` runs after one warm-up run. Exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tvc_torch.core.staging import PinnedStager  # noqa: E402


def _median_s(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=256)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    x = np.random.default_rng(0).random((args.rows, 224, 224, 3)).astype(np.float32)
    src = torch.from_numpy(x)
    gb = x.nbytes / 1e9
    pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    out = {"card": card, "torch": torch.__version__, "rows": args.rows, "bytes": x.nbytes,
           "intra_op_threads": torch.get_num_threads()}

    threads = torch.get_num_threads()
    for n in (1, 4, 8):
        torch.set_num_threads(n)
        out[f"host_to_pinned_GBps_{n}t"] = gb / _median_s(lambda: pinned.copy_(src), args.reps)
    torch.set_num_threads(threads)

    # as the stager's worker copies: from a thread of its own
    worker = threading.Thread(target=lambda: out.update(
        {f"host_to_pinned_GBps_worker_{threads}t": gb / _median_s(lambda: pinned.copy_(src), args.reps)}))
    worker.start()
    worker.join()

    stream = torch.cuda.Stream(dev)
    d = torch.empty(src.shape, dtype=src.dtype, device=dev)
    ms = []
    for _ in range(args.reps + 1):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(stream):
            a.record(stream)
            d.copy_(pinned, non_blocking=True)
            b.record(stream)
        b.synchronize()
        ms.append(a.elapsed_time(b))
    out["pinned_to_device_GBps"] = gb / (statistics.median(ms[1:]) * 1e-3)

    def pageable():
        torch.as_tensor(x, device=dev)
        torch.cuda.synchronize(dev)

    out["pageable_to_device_GBps"] = gb / _median_s(pageable, args.reps)

    st = PinnedStager(dev)
    try:
        def staged():
            st.start(x).wait()
            torch.cuda.synchronize(dev)

        s = _median_s(staged, args.reps)
    finally:
        st.close()
    out["staged_upload_ms"] = s * 1e3
    out["staged_upload_GBps"] = gb / s
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
