"""The program's own spans (``tvc_torch.utils.tracing``'s ring) on the clock
of the sub-window's profiler trace, for the per-layer metrics whose source
is ``program_span``.

The trace file gives ``baseTimeNanoseconds``, from which every event's
``ts`` (µs) counts; a ring stamp ``t`` (``time.time_ns()``) therefore lies
at ``(t - base) / 1e3`` on the trace's axis. Nothing is returned, and the
metrics that read it are left out of the line, where the program has no
recorder (a checkout older than it), the trace names no base, or the ring
dropped spans that reached into the sub-window."""

from __future__ import annotations

import json
import re
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence

from perfbench.trace import Interval, clip, union


class WindowSpan(NamedTuple):
    name: str
    a: float  # start, trace µs
    b: float  # end, trace µs
    tid: int
    id: int
    parent: int
    attrs: dict

    @property
    def ms(self) -> float:
        return (self.b - self.a) * 1e-3


def base_ns(path) -> Optional[int]:
    """``baseTimeNanoseconds`` of a Chrome trace file (written near its top)."""
    with open(path, "rb") as f:
        head = f.read(1 << 16)
    m = re.search(rb'"baseTimeNanoseconds"\s*:\s*(\d+)', head)
    if m is not None:
        return int(m.group(1))
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    base = data.get("baseTimeNanoseconds") if isinstance(data, dict) else None
    return int(base) if base is not None else None


def window(ctx) -> Optional[List[WindowSpan]]:
    """Every ring span that overlaps the sub-window, in trace µs; None
    where there is nothing whole to read."""
    try:
        from tvc_torch.utils import tracing
    except ImportError:
        return None
    tr, path = ctx.trace, getattr(ctx.sub, "path", None)
    if tr is None or path is None:
        return None
    base = base_ns(path)
    if base is None:
        return None
    lo_ns, hi_ns = base + tr.lo * 1e3, base + tr.hi * 1e3
    dropped = tracing.dropped()
    ring = tracing.spans()
    # the ring keeps spans in the order they ended: a dropped span ended no
    # later than the oldest kept one, so none reached the window if that
    # one ended before it
    if dropped and (not ring or ring[0].t1 >= lo_ns):
        return None
    return [WindowSpan(s.name, (s.t0 - base) * 1e-3, (s.t1 - base) * 1e-3, s.tid, s.id, s.parent, s.attrs)
            for s in ring if s.t1 >= lo_ns and s.t0 <= hi_ns]


def started(ctx, spans: Sequence[WindowSpan], name: str) -> List[WindowSpan]:
    """The spans of ``name`` that started inside the sub-window."""
    lo, hi = ctx.trace.lo, ctx.trace.hi
    return [s for s in spans if s.name == name and lo <= s.a <= hi]


def mean_ms(ctx, name: str) -> Optional[float]:
    """Mean duration of the spans of ``name`` that started in the window."""
    spans = window(ctx)
    got = started(ctx, spans, name) if spans is not None else []
    return sum(s.ms for s in got) / len(got) if got else None


def children_ms(ctx, parent: str, children: Iterable[str]) -> Optional[float]:
    """Mean, over the spans of ``parent`` that started in the window, of the
    summed durations of their direct children named in ``children``."""
    spans = window(ctx)
    if spans is None:
        return None
    parents = {s.id: 0.0 for s in started(ctx, spans, parent)}
    if not parents:
        return None
    want = set(children)
    for s in spans:
        if s.parent in parents and s.name in want:
            parents[s.parent] += s.ms
    return sum(parents.values()) / len(parents)


def idle(ctx) -> List[Interval]:
    """The sub-window's intervals with nothing on the device (trace µs)."""
    tr = ctx.trace
    edges = [tr.lo] + [x for iv in tr.busy() for x in iv] + [tr.hi]
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]


def overlap_us(xs: Sequence[Interval], ys: Sequence[Interval]) -> float:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def minus(xs: Sequence[Interval], ys: Sequence[Interval]) -> List[Interval]:
    """The parts of sorted disjoint intervals ``xs`` outside sorted disjoint ``ys``."""
    out: List[Interval] = []
    j = 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            if ys[k][0] > a:
                out.append((a, ys[k][0]))
            a = max(a, ys[k][1])
            k += 1
        if b > a:
            out.append((a, b))
    return out


def idle_by_span(ctx, spans: Sequence[WindowSpan]) -> Dict[str, float]:
    """The sub-window's device-idle time (µs) by the innermost of ``spans``
    (one thread's, nested): each span's own time, its interval less its
    direct children's among ``spans``, met with the device's idle intervals,
    summed by name."""
    lo, hi = ctx.trace.lo, ctx.trace.hi
    kids: Dict[int, List[Interval]] = {}
    for s in spans:
        kids.setdefault(s.parent, []).append((s.a, s.b))
    idle_ivs = idle(ctx)
    out: Dict[str, float] = {}
    for s in spans:
        own = minus(clip([(s.a, s.b)], lo, hi), union(kids.get(s.id, ())))
        out[s.name] = out.get(s.name, 0.0) + overlap_us(idle_ivs, own)
    return out
