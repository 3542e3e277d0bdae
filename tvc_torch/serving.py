"""Serving runtime: dynamic micro-batching HTTP service over the fused
detection path (port of ``tvc/serving.py``).

- Requests arriving within a short window coalesce into one batched
  detector call, padded up to a power-of-two bucket, so the serving step
  always runs at batch size.
- ``start()`` / ``stop()`` / ``warmup()`` (runs every bucket once).
- ``/health`` and ``/stats`` (uptime, counters, batch-size histogram,
  P50/P99 latency, kernel builds, the pixel uploads staged through pinned
  memory and those that were not, the batcher's wait share) and a rolling
  KS score-drift monitor.
- Spans (``tvc_torch.utils.tracing``): ``serve.request`` (a request from
  enqueue to answer, on the client's thread), and on the batcher's thread
  ``serve.wait`` (blocked on an empty queue), ``serve.queue`` (a request's
  enqueue to its pickup), ``serve.form`` (first pickup to the batch
  closed) and ``serve.batch`` with its children ``serve.assemble``,
  ``detect.batch`` and ``serve.deliver``.

The HTTP layer is stdlib-only and binds localhost by default; ``submit()``
serves embedded users.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import queue
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from tvc_torch._device import resolve_device
from tvc_torch.utils import tracing

#: requests of ``stats()``'s latency percentiles (the newest)
LATENCY_WINDOW = 1024
#: seconds of the newest history that ``stats()``'s ``batcher_wait_share`` covers
WAIT_WINDOW_S = 10.0
_RUNTIME_IDS = itertools.count()


@dataclasses.dataclass
class ServingConfig:
    clip_model: str = "tiny"
    #: embedding bank: path to a persisted EmbeddingBank, else a random
    #: placeholder bank of this many rows
    bank_path: Optional[str] = None
    bank_size: int = 1024
    #: micro-batcher: flush at this many queued queries ...
    batch_max_size: int = 64
    #: ... or when the oldest queued request has waited this long
    batch_max_wait_ms: float = 5.0
    host: str = "127.0.0.1"
    port: int = 0  # 0 = ephemeral
    detection_threshold: Optional[float] = None
    num_text_variants: int = 5
    #: int8 W8A8 serving towers (the production tower kernels): builds the
    #: model with fused_attention and int8_serving
    int8_serving: bool = False
    #: fixed text-token bucket (multiple of 8)
    text_bucket: int = 32
    #: captions of the hub-probe pool (AdversarialDetector.set_hub_probe)
    hub_probe_texts: tuple = ()
    #: score-drift monitor window (0 disables), minimum fill, KS alert level
    drift_window: int = 512
    drift_min_samples: int = 64
    drift_ks_alert: float = 0.25
    seed: int = 0


class _Request:
    __slots__ = ("id", "images", "texts", "event", "result", "error", "t_enqueue", "cancelled")

    def __init__(self, rid: int, images: np.ndarray, texts: List[str]):
        self.id = rid
        self.images = images
        self.texts = texts
        self.event = threading.Event()
        self.result: Optional[Dict[str, Any]] = None
        self.error: Optional[str] = None
        self.t_enqueue = time.time_ns()  # the recorder's clock
        self.cancelled = False  # set by a timed-out submit(); batcher skips


class ServingRuntime:
    """Owns the detector and the micro-batching loop.

    ``detector`` may be injected (any object with ``detect_batch(images,
    texts)`` returning ``.aggregated_score`` / ``.is_adversarial``);
    otherwise one is built from the config on ``device`` (the card unless
    ``device="cpu"``).
    """

    def __init__(
        self,
        config: Optional[ServingConfig] = None,
        detector=None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.config = config or ServingConfig()
        self.device = resolve_device(device)
        det_device = getattr(detector, "device", self.device)
        if det_device != self.device:
            raise ValueError(f"detector is on {det_device}, runtime on {self.device}")
        self.detector = detector or self._build_detector()
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self._batcher: Optional[threading.Thread] = None
        self._server: Optional[ThreadingHTTPServer] = None
        self._server_thread: Optional[threading.Thread] = None
        self._t_start = time.time()
        self._warm = False
        self._lock = threading.Lock()
        self._enqueue_lock = threading.Lock()
        # request and batch ids in this runtime's spans; ``_rt`` tells its
        # requests from another runtime's in the shared recorder
        self._rt = next(_RUNTIME_IDS)
        self._request_ids = itertools.count()
        self._batch_ids = itertools.count()
        self._t_wait: Optional[int] = None  # since when the batcher has found the queue empty
        self.counters: Dict[str, Any] = {
            "requests": 0,
            "queries": 0,
            "batches": 0,
            "batch_size_sum": 0,
            "errors": 0,
            "batch_bucket_counts": {},
        }
        self._drift_scores: deque = deque(maxlen=max(self.config.drift_window, 1))
        self._drift_ref: Optional[np.ndarray] = None
        self._drift_ref_source: Optional[str] = None

    @property
    def _max_bucket(self) -> int:
        """Largest power-of-two bucket <= batch_max_size."""
        b = 1
        while b * 2 <= self.config.batch_max_size:
            b *= 2
        return b

    def _build_detector(self):
        from tvc_torch.detector import AdversarialDetector, DetectorConfig
        from tvc_torch.models.clip import CLIPConfig, CLIPModel
        from tvc_torch.retrieval import MultiModalRetriever, RetrievalConfig

        cfg = self.config
        if cfg.clip_model == "tiny_coco_trained":
            from tvc_torch.fixtures import load_trained_tiny_coco

            # served as loaded (CLIPConfig.tiny_coco(): the module towers),
            # whatever int8_serving says, as the JAX package serves it
            model = load_trained_tiny_coco(seed=cfg.seed, device=self.device)
        else:
            model = CLIPModel(
                CLIPConfig.from_name(
                    cfg.clip_model, int8_serving=cfg.int8_serving, fused_attention=cfg.int8_serving
                ),
                seed=cfg.seed,
                device=self.device,
            )
        retriever = MultiModalRetriever(model, RetrievalConfig())
        if cfg.bank_path:
            retriever.load(cfg.bank_path)
        else:
            rng = np.random.default_rng(cfg.seed)
            embs = rng.standard_normal((cfg.bank_size, model.config.embed_dim), dtype=np.float32)
            embs /= np.linalg.norm(embs, axis=-1, keepdims=True)
            retriever.build_image_index(embeddings=embs)
        det_kw: Dict[str, Any] = {
            "num_text_variants": cfg.num_text_variants,
            "text_bucket": cfg.text_bucket,
        }
        if cfg.detection_threshold is not None:
            det_kw["detection_threshold"] = cfg.detection_threshold
        det = AdversarialDetector(
            model, retriever=retriever, config=DetectorConfig(**det_kw), device=self.device
        )
        if cfg.hub_probe_texts:
            det.set_hub_probe(texts=list(cfg.hub_probe_texts))
        return det

    def calibrate_hub_probe(self, clean_images, quantile: float = 0.995) -> float:
        return self.detector.calibrate_hub_probe(clean_images, quantile=quantile)

    # -- score-drift monitor ---------------------------------------------------------
    def set_drift_reference(self, clean_scores) -> None:
        """Pin the drift monitor's clean reference distribution."""
        ref = np.asarray(clean_scores, np.float64).ravel()
        if ref.size < 2:
            raise ValueError("drift reference needs >= 2 clean scores")
        with self._lock:
            self._drift_ref = ref
            self._drift_ref_source = "calibration"

    def _drift_feed(self, scores: np.ndarray) -> None:
        if self.config.drift_window <= 0:
            return
        with self._lock:
            self._drift_scores.extend(float(s) for s in scores)
            if self._drift_ref is None and len(self._drift_scores) >= self._drift_scores.maxlen:
                # no calibration reference: the first full window of live
                # traffic becomes the baseline (reported as such)
                self._drift_ref = np.fromiter(self._drift_scores, np.float64)
                self._drift_ref_source = "first_served_traffic"
                self._drift_scores.clear()

    def drift_status(self) -> Dict[str, Any]:
        """Two-sample KS test of the served-score window against the clean
        reference; ``alert`` means the score distribution has shifted."""
        with self._lock:
            ref = self._drift_ref
            src = self._drift_ref_source
            win = np.fromiter(self._drift_scores, np.float64)
        out: Dict[str, Any] = {
            "enabled": self.config.drift_window > 0,
            "reference_source": src,
            "reference_n": 0 if ref is None else int(ref.size),
            "window_n": int(win.size),
            "ks": None,
            "p_value": None,
            "alert": False,
        }
        if ref is None or win.size < self.config.drift_min_samples:
            return out
        from scipy.stats import ks_2samp

        ks = ks_2samp(ref, win)
        out["ks"] = round(float(ks.statistic), 4)
        out["p_value"] = float(ks.pvalue)
        out["alert"] = bool(ks.statistic > self.config.drift_ks_alert and ks.pvalue < 0.01)
        return out

    # -- lifecycle -----------------------------------------------------------------------
    def warmup(self) -> None:
        """Run every power-of-two batch bucket once."""
        model = getattr(self.detector, "model", None)
        size = getattr(getattr(model, "config", None), "image_size", 32)
        b = 1
        while b <= self._max_bucket:
            self.detector.detect_batch(np.zeros((b, size, size, 3), np.float32), ["warmup"] * b)
            b *= 2
        self._warm = True

    def start(self, http: bool = True) -> None:
        self._stop.clear()
        self._t_start = time.time()
        self._t_wait = None
        self._batcher = threading.Thread(target=self._batch_loop, name="tvc-batcher", daemon=True)
        self._batcher.start()
        if http:
            self._server = ThreadingHTTPServer((self.config.host, self.config.port), _make_handler(self))
            self._server_thread = threading.Thread(
                target=self._server.serve_forever, name="tvc-http", daemon=True
            )
            self._server_thread.start()

    @property
    def address(self) -> Optional[str]:
        if self._server is None:
            return None
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def stop(self) -> None:
        self._stop.set()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._batcher is not None:
            self._batcher.join(timeout=5)
            self._batcher = None
        # fail fast for anything still queued (the enqueue lock in submit()
        # closes the race with a request that passed the running check)
        with self._enqueue_lock:
            while True:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                req.error = "serving runtime stopped"
                req.event.set()

    # -- request path -------------------------------------------------------------------
    def submit(self, images, texts: Sequence[str], timeout: float = 60.0):
        """Enqueue one request (any number of queries) and block for its
        results. Thread-safe; concurrent submits coalesce."""
        images = np.asarray(images, np.float32)
        texts = [str(t) for t in texts]
        if images.ndim != 4 or len(texts) != images.shape[0]:
            raise ValueError(
                f"need images [B, H, W, C] with len(texts) == B; got "
                f"images {images.shape} and {len(texts)} texts"
            )
        req = _Request(next(self._request_ids), images, texts)
        with self._enqueue_lock:
            if self._batcher is None or self._stop.is_set():
                raise RuntimeError("serving runtime is not running")
            self._queue.put(req)
        if not req.event.wait(timeout):
            req.cancelled = True
            raise TimeoutError("serving request timed out")
        if req.error is not None:
            raise RuntimeError(req.error)
        tracing.record("serve.request", req.t_enqueue, time.time_ns(), req=req.id, rt=self._rt)
        return req.result

    @staticmethod
    def _picked(req: _Request) -> _Request:
        tracing.record("serve.queue", req.t_enqueue, time.time_ns(), req=req.id)
        return req

    def _batch_loop(self) -> None:
        cfg = self.config
        cap = self._max_bucket
        carry: Optional[_Request] = None  # admitted but overshot the last batch
        while not self._stop.is_set():
            if carry is not None:
                first, carry = carry, None
            else:
                if self._t_wait is None:
                    self._t_wait = time.time_ns()
                try:
                    first = self._queue.get(timeout=0.05)
                except queue.Empty:
                    continue
                # one span for the whole wait, however many timeouts it took
                tracing.record("serve.wait", self._t_wait, time.time_ns())
                self._t_wait = None
                self._picked(first)
            if first.cancelled:
                continue
            batch = [first]
            total = first.images.shape[0]
            deadline = first.t_enqueue + int(cfg.batch_max_wait_ms * 1e6)
            with tracing.span("serve.form"):
                while total < cap:
                    try:
                        # drain already-queued requests even past the deadline
                        nxt = self._picked(self._queue.get_nowait())
                    except queue.Empty:
                        wait = (deadline - time.time_ns()) * 1e-9
                        if wait <= 0:
                            break
                        try:
                            nxt = self._picked(self._queue.get(timeout=wait))
                        except queue.Empty:
                            break
                    if nxt.cancelled:
                        continue
                    if total + nxt.images.shape[0] > cap:
                        carry = nxt
                        break
                    batch.append(nxt)
                    total += nxt.images.shape[0]
            self._run_batch(batch)
        if carry is not None:
            carry.error = "serving runtime stopped"
            carry.event.set()

    @staticmethod
    def _bucket(n: int) -> int:
        """Smallest power of two >= n."""
        b = 1
        while b < n:
            b *= 2
        return b

    def _run_batch(self, batch: List[_Request]) -> None:
        try:
            with tracing.span("serve.batch", batch=next(self._batch_ids), reqs=[r.id for r in batch]) as sb:
                with tracing.span("serve.assemble"):
                    images = np.concatenate([r.images for r in batch])
                    texts: List[str] = sum((r.texts for r in batch), [])
                n = images.shape[0]
                cap = self._max_bucket
                scores = np.empty((n,), np.float64)
                is_adv = np.empty((n,), bool)
                padded = 0
                # chunk to the largest bucket, padding each chunk to a power of two
                for off in range(0, n, cap):
                    with tracing.span("serve.assemble"):
                        part_img = images[off : off + cap]
                        part_txt = texts[off : off + cap]
                        m = part_img.shape[0]
                        b = self._bucket(m)
                        if b > m:
                            pad_img = np.zeros((b - m,) + part_img.shape[1:], part_img.dtype)
                            part_img = np.concatenate([part_img, pad_img])
                            part_txt = part_txt + ["pad"] * (b - m)
                    padded += b
                    det = self.detector.detect_batch(part_img, part_txt)
                    with tracing.span("serve.deliver"):
                        scores[off : off + m] = np.asarray(det.aggregated_score)[:m]
                        is_adv[off : off + m] = np.asarray(det.is_adversarial)[:m]
                        self._drift_feed(scores[off : off + m])
                        with self._lock:
                            self.counters["batches"] += 1
                            self.counters["batch_size_sum"] += m
                            hist = self.counters["batch_bucket_counts"]
                            hist[b] = hist.get(b, 0) + 1
                sb.set(rows=n, bucket=padded)
                with tracing.span("serve.deliver"):
                    off = 0
                    for r in batch:
                        k = r.images.shape[0]
                        r.result = {
                            "scores": scores[off : off + k].tolist(),
                            "is_adversarial": is_adv[off : off + k].tolist(),
                        }
                        off += k
                        r.event.set()
                    with self._lock:
                        self.counters["requests"] += len(batch)
                        self.counters["queries"] += n
        except Exception as e:  # deliver the failure to every waiter
            with self._lock:
                self.counters["errors"] += 1
            for r in batch:
                r.error = f"{type(e).__name__}: {e}"
                r.event.set()

    # -- observability --------------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        served = [s for s in tracing.spans(names=("serve.request",)) if s.attrs.get("rt") == self._rt]
        lat = sorted(s.seconds for s in served[-LATENCY_WINDOW:])
        with self._lock:
            c = dict(self.counters)
            c["batch_bucket_counts"] = {
                str(k): v for k, v in sorted(c["batch_bucket_counts"].items())
            }
        out = {
            "uptime_s": round(time.time() - self._t_start, 3),
            "warm": self._warm,
            **c,
            "mean_batch_size": (
                round(c["batch_size_sum"] / c["batches"], 2) if c["batches"] else 0.0
            ),
        }
        if lat:
            out["latency_p50_ms"] = round(1e3 * lat[len(lat) // 2], 3)
            out["latency_p99_ms"] = round(1e3 * lat[min(len(lat) - 1, int(len(lat) * 0.99))], 3)
        built = tracing.counters()
        out["kernel_builds"] = {
            "sources": built.get("kernel.builds", 0),
            "seconds": round(built.get("kernel.build_ns", 0) * 1e-9, 3),
        }
        # pixel uploads through the pinned stager, and those that took the plain copy
        out["upload"] = {k: built.get(f"upload.{k}", 0) for k in ("staged", "staged_bytes", "fallback")}
        out["batcher_wait_share"] = self._wait_share()
        out["drift"] = self.drift_status()
        return out


    def _wait_share(self) -> float:
        """Share of the last ``WAIT_WINDOW_S`` seconds (since ``start()`` if
        later) the batcher spent blocked on an empty queue: its ``serve.wait``
        spans and the wait it is in now. Near 0, the batcher is the limit."""
        batcher = self._batcher
        now = time.time_ns()
        lo = max(now - int(WAIT_WINDOW_S * 1e9), int(self._t_start * 1e9))
        if batcher is None or now <= lo:
            return 0.0
        waited = sum(min(s.t1, now) - max(s.t0, lo) for s in tracing.spans(since_ns=lo, names=("serve.wait",))
                     if s.tid == batcher.ident)
        t_wait = self._t_wait
        if t_wait is not None:
            waited += now - max(t_wait, lo)
        return round(waited / (now - lo), 4)


def _make_handler(runtime: ServingRuntime):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, payload: Dict[str, Any]):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._send(200, {"status": "ok", "warm": runtime._warm})
            elif self.path == "/stats":
                self._send(200, runtime.stats())
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/v1/detect":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                images = np.asarray(req["images"], np.float32)
                texts = list(req["texts"])
                t0 = time.time()
                result = runtime.submit(images, texts)
                result["latency_ms"] = round(1e3 * (time.time() - t0), 3)
                self._send(200, result)
            except (KeyError, ValueError, TypeError) as e:
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve_args(argv: Optional[Sequence[str]] = None):
    """``serve_main``'s command line -> (ServingConfig, device, warmup)."""
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--clip-model", default="tiny")
    p.add_argument("--bank-path", default=None)
    p.add_argument("--bank-size", type=int, default=1024)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8787)
    p.add_argument("--batch-max-size", type=int, default=64)
    p.add_argument("--batch-max-wait-ms", type=float, default=5.0)
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--int8", action="store_true", help="int8 W8A8 serving towers")
    p.add_argument("--drift-window", type=int, default=512)
    p.add_argument("--drift-ks-alert", type=float, default=0.25)
    p.add_argument("--device", default=None, help="default: the card")
    args = p.parse_args(argv)
    cfg = ServingConfig(
        clip_model=args.clip_model,
        bank_path=args.bank_path,
        bank_size=args.bank_size,
        host=args.host,
        port=args.port,
        batch_max_size=args.batch_max_size,
        batch_max_wait_ms=args.batch_max_wait_ms,
        int8_serving=args.int8,
        drift_window=args.drift_window,
        drift_ks_alert=args.drift_ks_alert,
    )
    return cfg, args.device, not args.no_warmup


def serve_main(argv: Optional[Sequence[str]] = None) -> None:
    """Stand up the micro-batching detection service on the card
    (``--int8``: the W8A8 serving towers)."""
    cfg, device, warmup = serve_args(argv)
    rt = ServingRuntime(cfg, device=device)
    if warmup:
        print("warming up...")
        rt.warmup()
    rt.start()
    print(f"serving on {rt.address}  (POST /v1/detect, GET /health /stats)")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        rt.stop()


if __name__ == "__main__":
    serve_main()
