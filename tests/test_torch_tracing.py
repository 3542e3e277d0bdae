"""``tvc_torch.utils.tracing``: the one recorder of the port's spans and
counters, and the spans the serving runtime, the detector, the pipeline,
the Qwen2 decode and the kernel build record into it."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

import tvc_torch.core.kernels._build as build
from tvc_torch.augment import TextAugmentConfig, TextAugmenter
from tvc_torch.detector import AdversarialDetector, DetectorConfig
from tvc_torch.models import qwen as tq
from tvc_torch.models.clip import CLIPConfig, CLIPModel
from tvc_torch.pipeline import MultiModalDetectionPipeline, PipelineConfig
from tvc_torch.retrieval import MultiModalRetriever
from tvc_torch.serving import ServingConfig, ServingRuntime
from tvc_torch.utils import tracing

TEXTS = [f"a photo of a {w} on the grass" for w in ("dog", "cat", "bike", "kite", "boy", "ball")]


def _names(spans):
    return [s.name for s in spans]


# -- the recorder -------------------------------------------------------------------------
def test_nesting_parents_and_threads():
    rec = tracing.Recorder()
    with rec.span("outer", batch=1) as outer:
        with rec.span("inner") as inner:
            pass
        rec.record("stamped", 10, 20, req=3)
        inner.set(rows=4)

    def other():
        with rec.span("thread"):
            pass

    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    got = {s.name: s for s in rec.spans()}
    assert _names(rec.spans()) == ["inner", "stamped", "outer", "thread"]  # in the order they ended
    assert got["outer"].parent == 0 and got["inner"].parent == outer.id == got["outer"].id
    assert got["stamped"].parent == outer.id and (got["stamped"].t0, got["stamped"].t1) == (10, 20)
    assert got["inner"].attrs == {"rows": 4} and got["outer"].attrs == {"batch": 1}
    assert got["thread"].parent == 0 and got["thread"].tid != got["outer"].tid == threading.get_ident()
    assert len({s.id for s in rec.spans()}) == 4
    assert got["outer"].t0 <= got["inner"].t0 <= got["inner"].t1 <= got["outer"].t1
    assert outer.seconds == got["outer"].seconds > 0


def test_explicit_parent_across_threads():
    """A span for work another span started names that span: on another
    thread, or nested elsewhere on this one, without changing what the
    thread's next span nests in."""
    rec = tracing.Recorder()
    assert rec.current() == 0
    with rec.span("batch") as batch:
        origin = rec.current()
        with rec.span("step") as step:
            with rec.span("wait", parent=origin):
                assert rec.current() not in (0, origin, step.id)
            with rec.span("next"):
                pass

    def other():
        with rec.span("upload", parent=origin):
            pass

    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and rec.current() == 0 and origin == batch.id
    got = {s.name: s for s in rec.spans()}
    assert got["wait"].parent == got["upload"].parent == batch.id
    assert got["next"].parent == step.id and got["step"].parent == batch.id


def test_ring_bound_dropped_and_running_aggregates():
    rec = tracing.Recorder(capacity=8)
    for i in range(20):
        rec.record("s", 100 * i, 100 * i + i + 1, i=i)
    rec.count("c")
    rec.count("c", 4)
    assert rec.dropped() == 12
    kept = rec.spans()
    assert [s.attrs["i"] for s in kept] == list(range(12, 20))  # the newest, oldest first
    assert rec.counters() == {"c": 5}  # counters are never dropped
    # the running aggregates (``PipelineProfiler``'s) of all 20 durations
    d = np.arange(1, 21) * 1e-9
    agg = tracing.RunningStats()
    for x in d:
        agg.add(float(x))
    st = agg.summary()
    assert st["count"] == 20 and st["total"] == pytest.approx(d.sum())
    assert (st["min"], st["max"]) == pytest.approx((1e-9, 20e-9))
    assert st["mean"] == pytest.approx(d.mean()) and st["std"] == pytest.approx(d.std(), rel=1e-6)
    # the window reads: spans that overlap [since, until], of the names asked
    assert [s.attrs["i"] for s in rec.spans(since_ns=1400, until_ns=1700)] == [14, 15, 16, 17]
    assert rec.spans(names=("other",)) == []


def test_disabled_records_nothing_but_still_times():
    rec = tracing.Recorder()
    rec.enabled = False
    with rec.span("off") as s:
        time.sleep(0.001)
    rec.record("off", 1, 2)
    rec.count("off")
    assert rec.spans() == [] and rec.counters() == {}
    assert s.seconds >= 0.001


def test_threads_lose_no_span(monkeypatch):
    """More threads than cores, switching every microsecond: every span and
    count arrives once."""
    rec = tracing.Recorder(capacity=4096)
    n_threads, each = 16, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(each):
                with rec.span("a"):
                    rec.count("n")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    total = n_threads * each
    assert rec.counters() == {"n": total}
    assert rec.dropped() == total - 4096 and len({s.id for s in rec.spans()}) == 4096


def test_range_only_while_the_profiler_records(tmp_path, monkeypatch):
    opened = []
    real = tracing.record_function

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(tracing, "record_function", counting)
    rec = tracing.Recorder()
    with rec.span("tvc.test.off"):
        pass
    assert opened == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(20):
            with rec.span("tvc.test.on"):
                torch.ones(8).sum()
    assert opened == ["tvc.test.on"] * 20
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace["baseTimeNanoseconds"])
    ranges = sorted(float(e["ts"]) for e in trace["traceEvents"]
                    if e.get("cat") == "user_annotation" and e.get("name") == "tvc.test.on")
    ring = sorted(s.t0 for s in rec.spans(names=("tvc.test.on",)))
    assert len(ranges) == len(ring) == 20
    # the ring's stamp and the range's start, on the trace's clock (the
    # session's first range also carries the profiler's one-time set-up)
    gaps_us = sorted(abs((base + ts * 1e3) - t0) / 1e3 for ts, t0 in zip(ranges, ring))
    assert gaps_us[10] <= 200.0, gaps_us


# -- the program's spans ------------------------------------------------------------------
@pytest.fixture(scope="module")
def clip():
    model = CLIPModel(CLIPConfig.tiny(), seed=0, device="cpu")
    retriever = MultiModalRetriever(model)
    emb = np.random.default_rng(1).standard_normal((40, model.config.embed_dim)).astype(np.float32)
    retriever.build_image_index(embeddings=emb)
    images = np.random.default_rng(2).random((8, 32, 32, 3)).astype(np.float32)
    return model, retriever, images


def test_serving_spans_share_request_ids(clip):
    model, retriever, images = clip
    det = AdversarialDetector(model, DetectorConfig(num_text_variants=3, text_bucket=16), retriever=retriever,
                              device="cpu")
    rt = ServingRuntime(ServingConfig(batch_max_size=8, drift_window=0), detector=det, device="cpu")
    t_start = time.time_ns()
    rt.start(http=False)
    errors = []

    def client(k):
        try:
            for j in range(3):
                n = 1 + (k + j) % 3
                rt.submit(images[:n], TEXTS[:n], timeout=60)
        except Exception as e:  # reported below
            errors.append(e)

    try:
        threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        rt.stop()
    assert not errors and not any(t.is_alive() for t in threads)
    mine = tracing.spans(since_ns=t_start)
    requests = {s.attrs["req"]: s for s in mine if s.name == "serve.request" and s.attrs["rt"] == rt._rt}
    queued = {s.attrs["req"]: s for s in mine if s.name == "serve.queue"}
    assert sorted(requests) == sorted(queued) == list(range(12))
    for rid, s in requests.items():  # enqueue -> pickup inside enqueue -> answer
        q = queued[rid]
        assert q.t0 == s.t0 and q.t1 <= s.t1
    batches = [s for s in mine if s.name == "serve.batch"]
    assert sorted(r for b in batches for r in b.attrs["reqs"]) == list(range(12))
    assert sum(b.attrs["rows"] for b in batches) == rt.stats()["queries"] == 24
    assert all(b.attrs["bucket"] >= b.attrs["rows"] for b in batches)
    by_id = {s.id: s for s in mine}
    # one chunk a batch: the concatenation and the chunk's padding; the
    # chunk's scatter and the answers
    for name, each in (("serve.assemble", 2), ("detect.batch", 1), ("serve.deliver", 2)):
        kids = [s for s in mine if s.name == name]
        assert len(kids) == each * len(batches) and all(by_id[s.parent].name == "serve.batch" for s in kids)
    # the pixels staged, then the tokens: a detect.stage each
    for name, each in (("detect.tokenize", 1), ("detect.stage", 2), ("detect.step", 1), ("detect.readback", 1)):
        kids = [s for s in mine if s.name == name]
        assert len(kids) == each * len(batches) and all(by_id[s.parent].name == "detect.batch" for s in kids)
    batcher = {s.tid for s in batches}
    assert len(batcher) == 1 and {s.tid for s in mine if s.name in ("serve.form", "serve.wait")} <= batcher
    st = rt.stats()
    assert 0 < st["latency_p50_ms"] <= st["latency_p99_ms"]


def test_batcher_wait_share(clip):
    model, retriever, images = clip
    det = AdversarialDetector(model, DetectorConfig(num_text_variants=3, text_bucket=16), retriever=retriever,
                              device="cpu")
    rt = ServingRuntime(ServingConfig(batch_max_size=8, drift_window=0), detector=det, device="cpu")
    assert rt.stats()["batcher_wait_share"] == 0.0  # not started
    rt.start(http=False)
    try:
        rt.submit(images[:2], TEXTS[:2], timeout=60)  # a recorded wait, then a batch
        time.sleep(0.3)  # idle: the open wait counts too
        st = rt.stats()
        waits = [s for s in tracing.spans(names=("serve.wait",)) if s.tid == rt._batcher.ident]
    finally:
        rt.stop()
    assert waits
    assert 0.2 < st["batcher_wait_share"] < 1.0
    assert rt.stats()["batcher_wait_share"] == 0.0  # stopped


def test_process_stream_records_text_augment(clip):
    model, retriever, images = clip
    qwen = tq.QwenModel(tq.QwenConfig.tiny(), seed=0, max_new_tokens=8, device="cpu")
    pipe = MultiModalDetectionPipeline(
        model, PipelineConfig(num_text_variants=3, retrieval_top_k=4, num_reference_images=2), retriever=retriever,
        device="cpu",
        text_augmenter=TextAugmenter(TextAugmentConfig(enable_template=False, max_variants=3),
                                     paraphrase_generator=tq.ParaphraseAdapter(qwen, 0.0)),
    )
    t_start = time.time_ns()
    results = pipe.process_stream([(images[:3], TEXTS[:3]), (images[3:6], TEXTS[3:6])])
    stats = pipe.profiler.get_stats()
    assert stats["text_augment"]["count"] == stats["text_augment.finalize"]["count"] == 2
    mine = tracing.spans(since_ns=t_start)
    det = [s for s in mine if s.name == "pipeline.detection"]
    assert stats["detection"]["count"] == len(det) == 2
    assert stats["detection"]["total"] == pytest.approx(sum(s.seconds for s in det), abs=1e-6)
    for r, d in zip(results, det):
        assert set(r.timings) == {"text_augment", "detection", "retrieval"}
        assert r.timings["detection"] == pytest.approx(d.seconds, abs=1e-6)
    by_id = {s.id: s for s in mine}
    steps = {}  # one span a step, each decode's under its dispatch
    for s in mine:
        if s.name == "qwen.decode_step":
            steps.setdefault(s.parent, []).append(s.attrs["step"])
    assert len(steps) == 2 and all(v == list(range(len(v))) for v in steps.values())
    assert len(steps[max(steps)]) == qwen.last_decode_steps
    for name, parent in (("qwen.prepare", "pipeline.text_augment"), ("qwen.prefill", "pipeline.text_augment"),
                         ("qwen.decode_step", "pipeline.text_augment"),
                         ("qwen.readback", "pipeline.text_augment.finalize")):
        kids = [s for s in mine if s.name == name]
        assert kids and all(by_id[s.parent].name == parent for s in kids), name


def test_kernel_build_is_counted_and_shown(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\na = sys.argv\nopen(a[a.index('-o') + 1], 'wb').close()\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    before = tracing.counters()
    t_start = time.time_ns()
    build.build_all(["consistency", "mha"])
    build.build_all(["consistency"])  # current: nothing to build, nothing recorded
    after = tracing.counters()
    assert after["kernel.builds"] == before.get("kernel.builds", 0) + 2
    spans = tracing.spans(since_ns=t_start, names=("kernel.build",))
    assert len(spans) == 1 and spans[-1].attrs["sources"] == ["consistency", "mha"]
    assert after["kernel.build_ns"] - before.get("kernel.build_ns", 0) == spans[-1].t1 - spans[-1].t0 > 0
    rt = ServingRuntime(ServingConfig(), detector=object(), device="cpu")
    shown = rt.stats()["kernel_builds"]
    assert shown["sources"] == after["kernel.builds"]
    assert shown["seconds"] == round(after["kernel.build_ns"] * 1e-9, 3)
