"""The readers of the program's spans (``program_spans.py`` and the
``program_span`` metrics) on a synthetic trace and ring: the clock
conversion, the window, what each metric sums, and the cases in which
nothing is read."""

import json
import sys
from types import SimpleNamespace

import pytest

import tvc_torch.utils
from perfbench import common, program_spans
from perfbench.run import load_reader
from perfbench.trace import WINDOW_RANGE, Trace
from tvc_torch.utils import tracing

BASE = 1_700_000_000_000_000_000  # ns: the trace's baseTimeNanoseconds
LO, HI = 1000.0, 2000.0  # the sub-window, trace µs
BATCHER, CLIENT, MAIN = 11, 22, 33  # thread ids


def ns(us: float) -> int:
    return BASE + int(us * 1e3)


def _trace(tmp_path, base=BASE):
    events = [
        {"ph": "X", "cat": "user_annotation", "name": WINDOW_RANGE, "ts": LO, "dur": HI - LO, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "k0", "ts": 1000.0, "dur": 200.0},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 1500.0, "dur": 100.0},
    ]
    path = tmp_path / "trace.json"
    head = {"schemaVersion": 1} if base is None else {"schemaVersion": 1, "baseTimeNanoseconds": base}
    path.write_text(json.dumps({**head, "traceEvents": events}))
    return SimpleNamespace(trace=Trace(events), sub=SimpleNamespace(path=path, steps=1))


def _ring(capacity=4096):
    rec = tracing.Recorder(capacity)

    def add(name, a_us, b_us, tid=MAIN, sid=None, parent=0, **attrs):
        sid = sid if sid is not None else rec._n + 1000
        rec._add(name, ns(a_us), ns(b_us), tid, sid, parent, attrs)
        return sid

    # serving: idle on the device is [1200, 1500] and [1600, 2000] (700 µs)
    add("serve.form", 1150, 1250, BATCHER)  # 50 µs of it idle
    batch = add("serve.batch", 1300, 1700, BATCHER)  # 200 + 100
    add("serve.assemble", 1350, 1400, BATCHER, parent=batch)  # 50 idle
    add("serve.assemble", 1420, 1440, BATCHER, parent=batch)  # a second chunk's padding: 20 idle
    add("serve.deliver", 1650, 1700, BATCHER, parent=batch)  # 50 idle
    add("serve.wait", 1700, 1900, BATCHER)  # blocked: not the batcher's work
    add("serve.queue", 1000, 1950, BATCHER, req=0)  # a request's wait, recorded by the batcher
    add("serve.request", 1000, 2000, CLIENT, req=0)
    for d in range(1, 21):  # picked up in the window after d ms in the queue
        add("serve.queue", 1900 - 1000 * d, 1900, BATCHER, req=d)
    add("serve.queue", 2100 - 90_000, 2100, BATCHER, req=99)  # picked up after the window
    # detector: two calls in the window, one before it
    for a, tok, stage in ((500, 50.0, 50.0), (1100, 10.0, 5.0), (1600, 20.0, 5.0)):
        p = add("detect.batch", a, a + 300)
        add("detect.tokenize", a, a + tok, parent=p)
        add("detect.stage", a + tok, a + tok + stage, parent=p)
        add("detect.step", a + 100, a + 250, parent=p)  # not host staging
    # pipeline and decode
    for a, d in ((1010, 100), (1400, 300), (2500, 999)):
        add("pipeline.text_augment", a, a + d)
    for a, d in ((1200, 50), (1800, 150)):
        add("pipeline.text_augment.finalize", a, a + d)
    for a, d in ((900, 500), (1020, 10), (1040, 20), (1070, 30)):
        add("qwen.decode_step", a, a + d)
    return rec


@pytest.fixture
def ctx(tmp_path, monkeypatch):
    rec = _ring()
    monkeypatch.setattr(tracing, "spans", rec.spans)
    monkeypatch.setattr(tracing, "dropped", rec.dropped)
    return _trace(tmp_path)


def _read(name, ctx):
    return load_reader(name, common.BENCH_DIR)(ctx)


def test_clock_and_window(ctx):
    assert program_spans.base_ns(ctx.sub.path) == BASE
    spans = program_spans.window(ctx)
    assert all(s.b >= LO and s.a <= HI for s in spans)
    form = next(s for s in spans if s.name == "serve.form")
    assert (form.a, form.b) == pytest.approx((1150.0, 1250.0))
    # overlapping spans are in; the one after the window is not
    assert any(s.attrs.get("req") == 99 for s in spans) and not any(s.a > HI for s in spans)


def test_host_idle_share_arithmetic(ctx):
    # idle [1200, 1500] + [1600, 2000]; innermost on the batcher: form 50,
    # assemble 50 + 20, deliver 50; the batch's own time and the wait are not counted
    assert program_spans.idle(ctx) == [(1200.0, 1500.0), (1600.0, 2000.0)]
    batcher = [s for s in program_spans.window(ctx) if s.tid == BATCHER and s.name != "serve.queue"]
    split = program_spans.idle_by_span(ctx, batcher)
    assert split == pytest.approx({"serve.form": 50.0, "serve.batch": 300.0 - 120.0, "serve.assemble": 70.0,
                                   "serve.deliver": 50.0, "serve.wait": 200.0})
    assert _read("host_idle_share.serve", ctx) == pytest.approx((50 + 70 + 50) / 1000)


def test_minus():
    assert program_spans.minus([(0, 10), (20, 30)], [(2, 3), (5, 22), (25, 40)]) == [(0, 2), (3, 5), (22, 25)]
    assert program_spans.minus([(0, 10)], []) == [(0, 10)]
    assert program_spans.minus([(0, 10)], [(-5, 15)]) == []


def test_assemble_ms(ctx):
    # one batch in the window: its two serve.assemble children, 50 + 20 µs
    assert _read("assemble_ms.serve", ctx) == pytest.approx(0.07)


def test_queue_wait_p95(ctx):
    # 21 pickups in the window: 20 of 1..20 ms and one of 0.95 ms
    assert _read("queue_wait_p95_ms.serve", ctx) == pytest.approx(19.0)


def test_detect_host_ms(ctx):
    want = ((10 + 5) + (20 + 5)) / 2 / 1e3
    assert _read("detect_host_ms.detect", ctx) == pytest.approx(want)
    assert _read("detect_host_ms.tvc", ctx) == pytest.approx(want)


def test_text_augment_and_decode_step_ms(ctx):
    assert _read("text_augment_ms.tvc", ctx) == pytest.approx((100 + 300) / 2 / 1e3 + (50 + 150) / 2 / 1e3)
    assert _read("decode_step_host_ms.tvc", ctx) == pytest.approx(0.02)


NAMES = ("queue_wait_p95_ms.serve", "host_idle_share.serve", "assemble_ms.serve", "detect_host_ms.detect",
         "detect_host_ms.tvc", "text_augment_ms.tvc", "decode_step_host_ms.tvc")


@pytest.mark.parametrize("case", ["no_recorder", "no_base", "dropped_into_window"])
def test_nothing_to_read(case, tmp_path, monkeypatch):
    rec = _ring()
    if case == "dropped_into_window":  # the oldest kept span ended inside the window
        rec = _ring(capacity=8)
        assert rec.dropped() and rec.spans()[0].t1 >= ns(LO)
    monkeypatch.setattr(tracing, "spans", rec.spans)
    monkeypatch.setattr(tracing, "dropped", rec.dropped)
    if case == "no_recorder":  # a checkout older than the recorder
        monkeypatch.delattr(tvc_torch.utils, "tracing")
        monkeypatch.setitem(sys.modules, "tvc_torch.utils.tracing", None)
    c = _trace(tmp_path, base=None if case == "no_base" else BASE)
    assert program_spans.window(c) is None
    assert all(_read(n, c) is None for n in NAMES)


def test_dropped_before_the_window_still_reads(tmp_path, monkeypatch):
    rec = tracing.Recorder(capacity=4)
    for i in range(6):  # dropped spans all ended before the window
        rec._add("early", ns(100 + i), ns(101 + i), MAIN, i + 1, 0, {})
    for i, d in enumerate((10, 30)):
        rec._add("qwen.decode_step", ns(1100), ns(1100 + d), MAIN, 100 + i, 0, {})
    assert rec.dropped() == 4
    monkeypatch.setattr(tracing, "spans", rec.spans)
    monkeypatch.setattr(tracing, "dropped", rec.dropped)
    assert _read("decode_step_host_ms.tvc", _trace(tmp_path)) == pytest.approx(0.02)
