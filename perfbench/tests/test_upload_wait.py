"""``upload_wait_ms.detect`` and ``upload_wait_ms.tvc`` on a synthetic trace
and ring (``test_program_spans``'s): the mean blocked time a ``detect.batch``
of the sub-window, and nothing where no upload was waited on."""

import pytest

from perfbench.tests.test_program_spans import MAIN, _read, _trace, ns
from tvc_torch.utils import tracing

NAMES = ("upload_wait_ms.detect", "upload_wait_ms.tvc")
WORKER = 44  # the stager's thread


def _ring(waits):
    """Three ``detect.batch`` calls, one before the sub-window; each with
    the given ``detect.upload_wait`` children (µs) and a worker upload."""
    rec = tracing.Recorder()
    sid = iter(range(1, 10_000))
    for a, ws in zip((500, 1100, 1600), waits):
        p = next(sid)
        rec._add("detect.upload", ns(a), ns(a + 40), WORKER, next(sid), p, {"bytes": 1 << 20})
        rec._add("detect.tokenize", ns(a), ns(a + 10), MAIN, next(sid), p, {})
        at = a + 100
        for w in ws:
            rec._add("detect.upload_wait", ns(at), ns(at + w), MAIN, next(sid), p, {})
            at += w
        rec._add("detect.step", ns(a + 90), ns(a + 250), MAIN, next(sid), p, {})
        rec._add("detect.batch", ns(a), ns(a + 300), MAIN, p, 0, {})
    return rec


@pytest.fixture
def with_ring(tmp_path, monkeypatch):
    def use(waits):
        rec = _ring(waits)
        monkeypatch.setattr(tracing, "spans", rec.spans)
        monkeypatch.setattr(tracing, "dropped", rec.dropped)
        return _trace(tmp_path)

    return use


@pytest.mark.parametrize("name", NAMES)
def test_mean_wait_of_the_window_batches(with_ring, name):
    # the batch before the window (900 µs) is not read; in the window one
    # batch waited 30 µs, the other twice, 5 + 7 µs
    ctx = with_ring([(900,), (30,), (5, 7)])
    assert _read(name, ctx) == pytest.approx((30 + 12) / 2 / 1e3)


@pytest.mark.parametrize("name", NAMES)
def test_a_batch_that_did_not_wait_reads_zero(with_ring, name):
    ctx = with_ring([(900,), (0,), (20,)])
    assert _read(name, ctx) == pytest.approx(0.01)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read_without_upload_waits(with_ring, name):
    # the parent commit: no stager, so no detect.upload_wait in the window
    assert _read(name, with_ring([(), (), ()])) is None
    # the only wait is a child of the batch that started before the window
    assert _read(name, with_ring([(900,), (), ()])) is None


@pytest.mark.parametrize("name", NAMES)
def test_no_recorder_reads_nothing(name, tmp_path, monkeypatch):
    import sys

    import tvc_torch.utils

    monkeypatch.delattr(tvc_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "tvc_torch.utils.tracing", None)
    assert _read(name, _trace(tmp_path)) is None
