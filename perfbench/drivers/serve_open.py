"""The serving runtime under open-loop Poisson arrivals: ``ServingRuntime``
built as ``serve --int8`` builds it (the CLI's defaults otherwise), started
without HTTP and driven through ``submit()`` from client threads. A request
is sent when it is due, or as soon as a client is free where all are
waiting; once the window's time is up nothing more is sent, the clock is
read after every sent request has returned, and the answered queries over
that time are the served rate. Each request is timed from when it was due
and from when it was sent to when its answer returned; the generator's
lateness (sent minus due) is kept too."""

from __future__ import annotations

import gc
import itertools
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import weights
from perfbench.drivers import sample_rows
from perfbench.drivers.detect_closed import build_clip, clip_section
from perfbench.reference import clip_int8 as ref
from perfbench.traffic import Traffic

#: the sub-window of a traced run is counted in steps of this many seconds
STEP_S = 0.25


class Driver:
    def __init__(self, cfg: Dict, wl: Dict, mix: Dict, seed: int, device, spans):
        self.cfg, self.wl, self.mix, self.seed, self.device, self.spans = cfg, wl, mix, seed, device, spans
        self.c = clip_section(cfg)
        self.s = self.c["serving"]

    def setup(self) -> None:
        from tvc_torch.detector import AdversarialDetector, DetectorConfig
        from tvc_torch.serving import ServingConfig, ServingRuntime

        s, dev = self.s, self.device
        self.model, self.retriever = build_clip(self.c, self.seed, dev)
        det = AdversarialDetector(self.model, retriever=self.retriever, device=dev,
                                  config=DetectorConfig(num_text_variants=s["num_text_variants"],
                                                        text_bucket=s["text_bucket"]))
        self.rt = ServingRuntime(
            ServingConfig(clip_model=self.c["name"], bank_size=self.c["bank_rows"], int8_serving=True,
                          batch_max_size=s["batch_max_size"], batch_max_wait_ms=s["batch_max_wait_ms"],
                          drift_window=s["drift_window"], num_text_variants=s["num_text_variants"],
                          text_bucket=s["text_bucket"]),
            detector=det, device=dev)
        self.rt.warmup()
        self.rt.start(http=False)
        self.images = self._pool()

    def _pool(self) -> np.ndarray:
        """The seeded image pool, its first ``max_queries`` images repeated at
        its end, so that every request's images are one contiguous slice: a
        client hands the runtime a view and copies nothing."""
        n = int(self.mix["image_pool"])
        px = weights.images(n, self.c["image_size"], self.seed, self.device).cpu().numpy()
        return np.concatenate([px, px[: int(self.mix["max_queries"])]])

    def instrument(self) -> None:
        # one range on the batcher thread names the idle gaps; the serving
        # cell's metrics read counters and the device, not layer shapes
        det = self.rt.detector
        orig, sp = det.detect_batch, self.spans

        def detect_batch(*a, **k):
            with sp.span("serve.detect_batch"):
                return orig(*a, **k)

        det.detect_batch = detect_batch

    def _requests(self, seconds: float, rate: Optional[float]):
        mix = dict(self.mix)
        if rate is not None:
            mix["rate_qps"] = rate
        sched = Traffic(mix, self.seed).schedule(seconds)
        n = int(self.mix["image_pool"])
        reqs, off = [], 0
        for due, caps in sched:  # request k's images: pool rows off .. off + len - 1, modulo the pool
            idx = np.arange(off % n, off % n + len(caps))
            reqs.append((due, caps, idx))
            off += len(caps)
        return reqs

    def window(self, seconds: float, sub, rate: Optional[float] = None) -> Dict:
        reqs = self._requests(seconds, rate)
        n = len(reqs)
        sent = np.full(n, np.nan)
        done = np.full(n, np.inf)
        answers: List = [None] * n
        counter = itertools.count()
        lock = threading.Lock()
        c0 = dict(self.rt.stats())
        t0 = time.perf_counter() + 0.05
        t_end = t0 + seconds

        def client():
            while True:
                with lock:
                    i = next(counter)
                if i >= n:
                    return
                due, caps, idx = reqs[i]
                wait = t0 + due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                if time.perf_counter() >= t_end:  # the window has closed: send nothing more
                    return
                sent[i] = time.perf_counter()
                try:
                    answers[i] = self.rt.submit(self.images[idx[0]: idx[-1] + 1], caps, timeout=120.0)
                    done[i] = time.perf_counter()
                except Exception as e:  # a failed request counts as never answered
                    answers[i] = e

        threads = [threading.Thread(target=client, daemon=True) for _ in range(int(self.mix["clients"]))]
        for t in threads:
            t.start()
        started = None  # the profiler's start can take a second: count from it
        while any(t.is_alive() for t in threads):
            now = time.perf_counter()
            if started is None:
                k = int(max(0.0, now - t0) / STEP_S)
                sub.step(k)
                if getattr(sub, "_prof", None) is not None:
                    started, first = time.perf_counter(), k
            else:
                sub.step(first + int((now - started) / STEP_S))
            time.sleep(0.01)
        sub.stop()
        for t in threads:
            t.join()
        elapsed = time.perf_counter() - t0
        c1 = self.rt.stats()
        self.reqs, self.answers = reqs, answers
        was_sent = np.isfinite(sent)
        dues = t0 + np.array([d for d, _, _ in reqs])
        self.req_latency = (done - dues)[was_sent] * 1e3
        self.answer_ms = np.sort((done - sent)[was_sent & np.isfinite(done)] * 1e3)
        lat = np.sort(self.req_latency)
        self.late_ms = (sent - dues)[was_sent] * 1e3
        attempted = int(was_sent.sum())
        failed = int(np.sum(was_sent & ~np.isfinite(done)))
        padded = sum(int(b) * (v - c0["batch_bucket_counts"].get(b, 0)) for b, v in c1["batch_bucket_counts"].items())
        self.fill = (c1["batch_size_sum"] - c0["batch_size_sum"]) / padded if padded else None
        p95 = float(lat[int(np.ceil(0.95 * attempted)) - 1]) if attempted else float("inf")
        answered = int(sum(len(c) for (_, c, _), a in zip(reqs, answers) if isinstance(a, dict)))
        queries = int(sum(len(c) for (_, c, _), s_ in zip(reqs, sent) if np.isfinite(s_)))
        late = np.sort(self.late_ms)
        return {"e2e": {"serve_qps": answered / elapsed, "serve_p95_ms": p95}, "attempted": attempted,
                "failed": failed, "window_s": elapsed, "latency_ms": lat, "queries": queries,
                # how late the open-loop generator sent (sent minus due): near 0
                # the offered load is the cell's; large, every client was waiting
                # on an answer and the runtime set the pace
                "generator": {"offered_qps": float(self.mix["rate_qps"] if rate is None else rate),
                              "sent_qps": queries / elapsed, "requests": attempted,
                              "late_p50_ms": float(late[len(late) // 2]) if len(late) else None,
                              "late_p99_ms": float(late[int(np.ceil(0.99 * len(late))) - 1]) if len(late) else None}}

    def free(self) -> None:
        if "rt" in self.__dict__:
            self.rt.stop()
        for name in ("rt", "retriever", "model"):
            self.__dict__.pop(name, None)
        gc.collect()
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    def check(self, limits: Dict[str, float], n_rows: int) -> Dict[str, float]:
        from perfbench.reference.tokenizers import ClipBPE

        # a request with no answer is counted in the run's ``failed``, which
        # makes it incorrect by itself; the comparison holds the answered
        rows = [(i, j) for i, (_, caps, _) in enumerate(self.reqs) if isinstance(self.answers[i], dict)
                for j in range(len(caps))]
        pick = [rows[r] for r in sample_rows(len(rows), n_rows, self.seed)]
        texts = [self.reqs[i][1][j] for i, j in pick]
        pixels = np.stack([self.images[self.reqs[i][2][j]] for i, j in pick])
        agg = np.array([self.answers[i]["scores"][j] for i, j in pick])
        flags = np.array([self.answers[i]["is_adversarial"][j] for i, j in pick], bool)
        c, dev = self.c, self.device
        p = weights.clip_params(c, self.seed, dev)
        bank = weights.bank(c["bank_rows"], c["embed_dim"], self.seed, dev)
        out = ref.judge_answers(ref.ClipInt8(c, p, bits=8), ClipBPE(c["context_length"]), bank,
                                torch.as_tensor(pixels), texts, agg, flags, self.c["serving"]["num_reference_images"],
                                self.s["text_bucket"], self.c["detector"]["detection_threshold"],
                                limits["score_gap"], float(self.wl["check"]["tie"]))
        return out

    def control(self, limits: Dict[str, float], n_rows: int, batches: int, bits: int = 4) -> Dict[str, float]:
        """The int4 reference answering the rows a window would be sampled
        from (no ties to resolve: it answers with its own top-k)."""
        from perfbench.reference.tokenizers import ClipBPE

        self.images = self._pool()
        reqs = self._requests(float(batches), None)
        rows = [(i, j) for i, (_, caps, _) in enumerate(reqs) for j in range(len(caps))]
        pick = [rows[r] for r in sample_rows(len(rows), n_rows, self.seed)]
        texts = [reqs[i][1][j] for i, j in pick]
        px = torch.as_tensor(np.stack([self.images[reqs[i][2][j]] for i, j in pick]))
        c, dev, R = self.c, self.device, self.c["serving"]["num_reference_images"]
        p = weights.clip_params(c, self.seed, dev)
        bank = weights.bank(c["bank_rows"], c["embed_dim"], self.seed, dev)
        bpe, thr = ClipBPE(c["context_length"]), self.c["detector"]["detection_threshold"]
        out4, _ = ref.answer_rows(ref.ClipInt8(c, p, bits=bits), bpe, bank, px, texts, [[] for _ in texts], 0, R, R,
                                  self.s["text_bucket"], thr)
        got = ref.judge_answers(ref.ClipInt8(c, p, bits=8), bpe, bank, px, texts, out4["aggregated"],
                                out4["is_adversarial"], R, self.s["text_bucket"], thr, limits["score_gap"],
                                float(self.wl["check"]["tie"]))
        return got

    def work(self, steps: int) -> Dict:
        return {"batch_fill": self.fill, "answer_ms": self.answer_ms}
