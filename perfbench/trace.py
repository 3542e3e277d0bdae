"""Reduction of one profiler trace of a steady sub-window to what the
per-layer metrics read: the device's busy time (the union of its kernel,
copy and set intervals), the idle gaps named by the benchmark's ranges the
host was inside, device time by operation, device time of the kernels
launched inside each named range, and host-to-device copy time.

The trace is ``torch.profiler``'s Chrome trace: host ranges are
``user_annotation`` events, launches ``cuda_runtime`` / ``cuda_driver``
events, device work ``kernel`` / ``gpu_memcpy`` / ``gpu_memset`` events
tied to their launch by ``args.correlation``."""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW_RANGE = "perfbench.window"

Interval = Tuple[float, float]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


class _Ranges:
    """Host ranges of one name on each thread, for point lookups."""

    def __init__(self):
        self.by_tid: Dict[object, List[Interval]] = defaultdict(list)

    def add(self, tid, a: float, b: float) -> None:
        self.by_tid[tid].append((a, b))

    def finish(self) -> None:
        for tid in self.by_tid:
            self.by_tid[tid] = union(self.by_tid[tid])

    def covers(self, tid, t: float) -> bool:
        iv = self.by_tid.get(tid)
        if not iv:
            return False
        i = bisect.bisect_right(iv, (t, float("inf"))) - 1
        return i >= 0 and iv[i][0] <= t <= iv[i][1]


class Trace:
    def __init__(self, events: List[dict]):
        self.device: List[dict] = []
        self.launch_at: Dict[int, Tuple[object, float]] = {}
        self.ranges: Dict[str, _Ranges] = defaultdict(_Ranges)
        self.annotations: List[Tuple[float, float, object, str]] = []
        for e in events:
            cat, ph = e.get("cat"), e.get("ph")
            if ph != "X":
                continue
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                self.device.append(e)
            elif cat in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    self.launch_at[int(corr)] = (e.get("tid"), ts)
            elif cat == "user_annotation":
                self.ranges[e["name"]].add(e.get("tid"), ts, ts + dur)
                self.annotations.append((ts, ts + dur, e.get("tid"), e["name"]))
        for r in self.ranges.values():
            r.finish()
        win = self.ranges.get(WINDOW_RANGE)
        spans = [iv for ivs in (win.by_tid.values() if win else []) for iv in ivs]
        if not spans:
            raise ValueError(f"the trace holds no {WINDOW_RANGE!r} range")
        self.lo, self.hi = min(a for a, _ in spans), max(b for _, b in spans)
        self.annotations.sort()
        counts: Dict[object, int] = defaultdict(int)
        for _, _, tid, name in self.annotations:
            if name != WINDOW_RANGE:
                counts[tid] += 1
        #: the host thread that drives the device: the one inside most ranges
        self.host_tid = max(counts, key=counts.get) if counts else next(iter(win.by_tid))

    @classmethod
    def load(cls, path: Path) -> "Trace":
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    # -- the device ---------------------------------------------------------------------
    def _intervals(self, events: Iterable[dict]) -> List[Interval]:
        return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in events]

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-6

    def busy(self) -> List[Interval]:
        return clip(union(self._intervals(self.device)), self.lo, self.hi)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-6

    def device_ops(self, top: int = 10) -> List[Tuple[str, float]]:
        by: Dict[str, float] = defaultdict(float)
        for e in self.device:
            by[e["name"][:160]] += sum(b - a for a, b in clip(self._intervals([e]), self.lo, self.hi)) * 1e-6
        return sorted(by.items(), key=lambda kv: -kv[1])[:top]

    def innermost(self, tid, points: Iterable[float]) -> Dict[float, Optional[str]]:
        """The innermost benchmark range the host thread was inside at each
        point (ranges on one thread nest)."""
        ann = [(a, b, n) for a, b, t, n in self.annotations if t == tid and n != WINDOW_RANGE]
        out: Dict[float, Optional[str]] = {}
        stack: List[Tuple[float, float, str]] = []
        j = 0
        for t in sorted(points):
            while j < len(ann) and ann[j][0] <= t:
                while stack and stack[-1][1] < ann[j][0]:
                    stack.pop()
                stack.append(ann[j])
                j += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            out[t] = stack[-1][2] if stack else None
        return out

    def idle_gaps(self, top: int = 10) -> List[Tuple[str, float]]:
        """Idle seconds of the device within the window, summed by the
        innermost range the driving host thread was inside at each gap's
        middle ("outside any range" where none)."""
        busy = self.busy()
        edges = [self.lo] + [x for iv in busy for x in iv] + [self.hi]
        gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        names = self.innermost(self.host_tid, [0.5 * (a + b) for a, b in gaps])
        by: Dict[str, float] = defaultdict(float)
        for a, b in gaps:
            by[names[0.5 * (a + b)] or "outside any range"] += (b - a) * 1e-6
        return sorted(by.items(), key=lambda kv: -kv[1])[:top]

    def device_s_under(self, names: Iterable[str]) -> float:
        """Device seconds of the work launched inside any range of ``names``."""
        rs = [self.ranges[n] for n in names if n in self.ranges]
        total = 0.0
        for e in self.device:
            corr = e.get("args", {}).get("correlation")
            at = self.launch_at.get(int(corr)) if corr is not None else None
            if at is None:
                continue
            if any(r.covers(at[0], at[1]) for r in rs):
                iv = clip(self._intervals([e]), self.lo, self.hi)
                total += sum(b - a for a, b in iv)
        return total * 1e-6

    def copy_s(self, kind: str = "HtoD") -> float:
        iv = [e for e in self.device if e.get("cat") == "gpu_memcpy" and kind in e.get("name", "")]
        return sum(b - a for a, b in clip(self._intervals(iv), self.lo, self.hi)) * 1e-6
