"""The port's one recorder of spans and counters.

A span is a named interval of host time, stamped with ``time.time_ns()``
at entry and exit: the clock that ``torch.profiler``'s Chrome trace gives
as ``baseTimeNanoseconds`` + ``ts``, so spans and the device trace line up.
Each span keeps its thread, its own id, the id of the span it opened
inside on the same thread (0 for none) and a few attributes (``req``,
``batch``, ``rows``, ...). Spans go into one bounded ring of ``CAPACITY``
tuples; once the ring is full the oldest are overwritten and counted as
dropped. The counters are never dropped.

While ``torch.profiler`` records on the calling thread, a span also opens
a ``record_function`` range of its name, so the trace shows it; otherwise
it opens none (a range costs several microseconds even with no profiler).

    from tvc_torch.utils import tracing

    with tracing.span("detect.batch", rows=len(texts)) as s:
        ...
        s.set(bucket=b)
    tracing.record("serve.queue", t_enqueue_ns, time.time_ns(), req=7)
    tracing.count("kernel.builds", 2)
    tracing.spans(since_ns, until_ns, names=("serve.queue",))

A span opened for work that another span started, on another thread or
later, names that span as its parent (``span(name, parent=tracing.current())``
taken where the work was started).

``set_enabled(False)`` stops the ring, the counters and the ranges; a span still stamps its own times, so callers that read its
``seconds`` keep working.
"""

from __future__ import annotations

import itertools
import math
import threading
import time
from typing import Any, Dict, Iterable, List, NamedTuple, Optional

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

#: spans the ring holds; a serving window of 30 s makes under 30,000
CAPACITY = 65536


class Span(NamedTuple):
    name: str
    t0: int  # time.time_ns() at entry
    t1: int  # time.time_ns() at exit
    tid: int  # threading.get_ident() of the thread that recorded it
    id: int
    parent: int  # the enclosing span's id on that thread, 0 for none
    attrs: Dict[str, Any]

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9


class RunningStats:
    """Count, total, min, max and sum of squares of a stream of values
    (``PipelineProfiler``'s per-stage aggregates)."""

    __slots__ = ("count", "total", "min", "max", "sumsq")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.sumsq = 0.0

    def add(self, x: float) -> None:
        self.count += 1
        self.total += x
        self.sumsq += x * x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x

    def summary(self) -> Dict[str, float]:
        """``mean``, ``std`` (population), ``min``, ``max``, ``count``,
        ``total``; call only after one ``add``."""
        mean = self.total / self.count
        return {
            "mean": mean,
            "std": math.sqrt(max(self.sumsq / self.count - mean * mean, 0.0)),
            "min": self.min,
            "max": self.max,
            "count": self.count,
            "total": self.total,
        }


class OpenSpan:
    """What ``span()`` returns: a context manager that records on exit."""

    __slots__ = ("_rec", "name", "attrs", "id", "parent", "_outer", "t0", "t1", "_rf")

    def __init__(self, rec: "Recorder", name: str, attrs: Dict[str, Any], parent: Optional[int] = None):
        self._rec, self.name, self.attrs, self.parent = rec, name, attrs, parent
        self.t1 = 0
        self._rf = None

    def __enter__(self) -> "OpenSpan":
        rec = self._rec
        if rec.enabled:
            local = rec._local
            self._outer = local.current
            if self.parent is None:
                self.parent = self._outer
            local.current = self.id = next(rec._ids)
            if _profiler_enabled():
                self._rf = record_function(self.name)
                self._rf.__enter__()
        else:
            self.id = 0
        self.t0 = time.time_ns()  # after the range opens: closer to its start
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.time_ns()
        if self.id:
            rec = self._rec
            if self._rf is not None:
                self._rf.__exit__(*exc)
            rec._local.current = self._outer
            rec._add(self.name, self.t0, self.t1, threading.get_ident(), self.id, self.parent, self.attrs)
        return False

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)

    @property
    def seconds(self) -> float:
        """Duration; up to now while the span is open."""
        return ((self.t1 or time.time_ns()) - self.t0) * 1e-9


class _Local(threading.local):
    #: the id of the innermost open span on this thread, 0 for none
    current = 0


class Recorder:
    """The ring and the counters. The module holds the one
    the program records into; a test may build its own."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = int(capacity)
        self.enabled = True
        self._ring: List[Optional[tuple]] = [None] * self.capacity
        self._n = 0  # spans ever written
        self._lock = threading.Lock()
        self._local = _Local()
        self._ids = itertools.count(1)
        self._counters: Dict[str, int] = {}

    def _add(self, name, t0, t1, tid, sid, parent, attrs) -> None:
        with self._lock:
            self._ring[self._n % self.capacity] = (name, t0, t1, tid, sid, parent, attrs)
            self._n += 1

    # -- writing ------------------------------------------------------------------------
    def span(self, name: str, parent: Optional[int] = None, **attrs) -> OpenSpan:
        """A span, the child of the innermost open span on this thread, or
        of the span whose id ``parent`` gives."""
        return OpenSpan(self, name, attrs, parent)

    def record(self, name: str, t0_ns: int, t1_ns: int, **attrs) -> None:
        """A span whose start was stamped earlier (``time.time_ns()``)."""
        if self.enabled:
            self._add(name, int(t0_ns), int(t1_ns), threading.get_ident(), next(self._ids),
                      self._local.current, attrs)

    def count(self, name: str, n: int = 1) -> None:
        if self.enabled:
            with self._lock:
                self._counters[name] = self._counters.get(name, 0) + n

    # -- reading ------------------------------------------------------------------------
    def current(self) -> int:
        """The id of the innermost open span on this thread, 0 for none."""
        return self._local.current

    def spans(self, since_ns: Optional[int] = None, until_ns: Optional[int] = None,
              names: Optional[Iterable[str]] = None) -> List[Span]:
        """The ring's spans that overlap ``[since_ns, until_ns]`` (either end
        open when None), of ``names`` if given, in the order they ended."""
        with self._lock:
            n, cap = self._n, self.capacity
            if n <= cap:
                raw = self._ring[:n]
            else:
                i = n % cap
                raw = self._ring[i:] + self._ring[:i]
        lo = -math.inf if since_ns is None else since_ns
        hi = math.inf if until_ns is None else until_ns
        want = None if names is None else frozenset(names)
        return [Span(*r) for r in raw if r[2] >= lo and r[1] <= hi and (want is None or r[0] in want)]

    def dropped(self) -> int:
        """Spans overwritten since the ring filled."""
        with self._lock:
            return max(0, self._n - self.capacity)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)


RECORDER = Recorder()
span = RECORDER.span
current = RECORDER.current
record = RECORDER.record
count = RECORDER.count
spans = RECORDER.spans
dropped = RECORDER.dropped
counters = RECORDER.counters


def set_enabled(on: bool) -> None:
    RECORDER.enabled = bool(on)

