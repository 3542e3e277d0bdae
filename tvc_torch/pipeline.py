"""The end-to-end defense pipeline, full TVC (port of ``tvc/pipeline.py``):
text augmentation (host strategies plus the LLM paraphrases, one decode
batch for all queries) -> detection (one fused serving step: encode, bank
top-k, consistency kernel) -> the retrieved items, mapped from the fused
step's top-k indices.

Batch-first: each stage consumes the whole batch and ``process_single``
is a B = 1 wrapper. Runs on the card unless ``device="cpu"`` (the model
must be on the same device).

Each stage runs inside a span (``tvc_torch.utils.tracing``):
``pipeline.text_augment`` (in ``process_stream`` the decode's dispatch,
then ``pipeline.text_augment.finalize``), ``pipeline.detection`` and
``pipeline.retrieval``; a result's ``timings`` and the profiler's stats
come from those spans.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

import torch

from tvc_torch.augment import TextAugmenter
from tvc_torch.detector import AdversarialDetector, DetectionResult, DetectorConfig
from tvc_torch.models.clip import CLIPModel
from tvc_torch.retrieval import MultiModalRetriever
from tvc_torch.utils import tracing


@dataclasses.dataclass
class PipelineConfig:
    """(reference src/pipeline.py:32-77)"""

    steps: Sequence[str] = ("text_augment", "retrieval", "detection")
    batch_size: int = 256
    enable_profiling: bool = True
    num_text_variants: int = 5
    retrieval_top_k: int = 5
    num_reference_images: int = 3
    detection_threshold: float = 0.5
    save_intermediate: bool = False
    output_dir: str = "./results/pipeline"


@dataclasses.dataclass
class PipelineResult:
    """Per-batch result (reference src/pipeline.py:78-134, batched)."""

    is_adversarial: np.ndarray
    scores: np.ndarray
    method_scores: Dict[str, np.ndarray]
    variants: List[List[str]]
    retrieved: Optional[List[List[Any]]]
    timings: Dict[str, float]
    errors: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class BatchProcessingResult:
    """(reference src/pipeline.py:135-178)"""

    total: int
    adversarial_count: int
    error_count: int
    results: List[PipelineResult]
    total_time: float

    @property
    def throughput(self) -> float:
        return self.total / self.total_time if self.total_time > 0 else 0.0


class PipelineProfiler:
    """Thread-safe per-step wall-clock stats (reference src/pipeline.py:179-253)
    of one pipeline, kept as running sums. Step ``name`` is recorded as the
    span ``pipeline.<name>``, whose duration the stats take."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._stats: Dict[str, tracing.RunningStats] = {}
        self._open: Dict[str, Any] = {}

    def _add(self, name: str, seconds: float) -> None:
        if self.enabled:
            with self._lock:
                self._stats.setdefault(name, tracing.RunningStats()).add(seconds)

    @contextlib.contextmanager
    def step(self, name: str):
        """Run the body as step ``name``; yields the open span."""
        with tracing.span("pipeline." + name) as s:
            yield s
        self._add(name, s.seconds)

    def start_step(self, name: str) -> None:
        """Open ``step(name)``; ``end_step(name)``, on the same thread, closes it."""
        cm = self.step(name)
        cm.__enter__()
        with self._lock:
            self._open[name] = cm

    def end_step(self, name: str) -> None:
        with self._lock:
            cm = self._open.pop(name, None)
        if cm is not None:
            cm.__exit__(None, None, None)

    def get_stats(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {name: st.summary() for name, st in self._stats.items()}


class MultiModalDetectionPipeline:
    """text_augment -> retrieval -> (sd_reference) -> detection, batched."""

    def __init__(
        self,
        model: CLIPModel,
        config: Optional[PipelineConfig] = None,
        text_augmenter: Optional[TextAugmenter] = None,
        retriever: Optional[MultiModalRetriever] = None,
        sd_generator=None,
        detector: Optional[AdversarialDetector] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        """device: the built detector's (None: the card); ignored when a
        detector is given."""
        self.model = model
        self.config = config or PipelineConfig()
        self.text_augmenter = text_augmenter or TextAugmenter()
        self.retriever = retriever
        self.sd_generator = sd_generator  # callable (texts, n) -> [B, n, D]
        self.profiler = PipelineProfiler(self.config.enable_profiling)
        if detector is None:
            detector = AdversarialDetector(
                model,
                DetectorConfig(
                    detection_threshold=self.config.detection_threshold,
                    num_text_variants=self.config.num_text_variants,
                    num_reference_images=self.config.num_reference_images,
                    retrieval_top_k=self.config.retrieval_top_k,
                ),
                text_augmenter=self.text_augmenter,
                # SD/host generators go through reference_generator; the
                # retriever is passed separately so bank top-k runs INSIDE
                # the detector's fused serving program
                reference_generator=self._reference_generator(),
                retriever=self.retriever,
                device=device,
            )
        self.detector = detector
        self.stats = {"batches": 0, "queries": 0, "adversarial": 0, "errors": 0}

    def _reference_generator(self):
        """SD-synthesized reference embeddings for the detector (the
        retrieval-bank refs come from the retriever passed alongside)."""
        if self.sd_generator is None:
            return None

        def gen(texts: List[str], n: int) -> np.ndarray:
            out = self.sd_generator(texts, n)
            return out.detach().cpu().numpy() if torch.is_tensor(out) else np.asarray(out)

        return gen

    # -- processing -----------------------------------------------------------
    def _generate_variants(self, texts: Sequence[str]) -> List[List[str]]:
        if "text_augment" not in self.config.steps:
            return [[] for _ in texts]
        return self.text_augmenter.batch_generate_variants(
            texts, self.config.num_text_variants
        )

    def process_batch(self, images, texts: Sequence[str]) -> PipelineResult:
        with self.profiler.step("text_augment") as s:
            variants = self._generate_variants(texts)
        return self._detect_and_retrieve(images, texts, variants, {"text_augment": s.seconds}, [])

    def _generate_variants_async(self, texts: Sequence[str]):
        """Dispatch-now/finalize-later form of _generate_variants (see
        TextAugmenter.batch_generate_variants_async)."""
        if "text_augment" not in self.config.steps:
            return lambda: [[] for _ in texts]
        return self.text_augmenter.batch_generate_variants_async(
            texts, self.config.num_text_variants
        )

    def process_stream(self, batches) -> List[PipelineResult]:
        """Serving loop over an iterable of (images, texts) batches in the
        JAX package's dispatch order: batch i+1's paraphrase decode is
        started before batch i's variants are finalized and its detection
        runs. The port's decode is synchronous up to its last queued chunk
        (``QwenModel.generate_async``), so the host does not yet overlap
        batch i's detection with batch i+1's decode; the results equal
        ``process_batch`` on each batch (with an empty variant cache).
        Results return in input order; a result's ``text_augment`` timing
        is its dispatch and its finalize together."""
        out: List[PipelineResult] = []
        it = iter(batches)
        try:
            images, texts = next(it)
        except StopIteration:
            return out
        pending = self._dispatch(images, texts)
        for nxt_images, nxt_texts in it:
            nxt = self._dispatch(nxt_images, nxt_texts)  # dispatch i+1
            out.append(self._finalize(*pending))
            pending = nxt
        out.append(self._finalize(*pending))
        return out

    def _dispatch(self, images, texts):
        texts = list(texts)
        with self.profiler.step("text_augment") as s:
            handle = self._generate_variants_async(texts)
        return images, texts, handle, s.seconds

    def _finalize(self, images, texts, handle, dispatch_s: float) -> PipelineResult:
        with self.profiler.step("text_augment.finalize") as s:
            variants = handle()
        return self._detect_and_retrieve(images, texts, variants, {"text_augment": dispatch_s + s.seconds}, [])

    def _detect_and_retrieve(
        self, images, texts, variants, timings, errors
    ) -> PipelineResult:
        with self.profiler.step("detection") as s:
            det: DetectionResult = self.detector.detect_batch(
                images,
                texts,
                # reuse the text_augment step's output — regenerating inside the
                # detector would run the batched LLM decode twice per batch AND
                # score different variants than the ones reported
                variants=variants if "text_augment" in self.config.steps else None,
            )
        timings["detection"] = s.seconds

        retrieved = None
        if "retrieval" in self.config.steps and self.retriever is not None:
            with self.profiler.step("retrieval") as s:
                ref_idx = det.details.get("ref_idx")
                if (
                    ref_idx is not None
                    and self.retriever.image_items
                    and ref_idx.shape[1] >= self.config.retrieval_top_k
                ):
                    # the fused detection program already ran the bank top-k —
                    # map its indices to items with zero extra device dispatches
                    items = self.retriever.image_items
                    k = min(self.config.retrieval_top_k, ref_idx.shape[1])
                    retrieved = [
                        [items[int(j)] for j in row[:k] if 0 <= int(j) < len(items)]
                        for row in ref_idx
                    ]
                else:
                    try:
                        r = self.retriever.retrieve_images_by_text(
                            list(texts), top_k=self.config.retrieval_top_k
                        )
                        retrieved = r.items
                    except Exception as e:  # degraded-mode continue (reference :389-392)
                        errors.append(f"retrieval: {e}")
            timings["retrieval"] = s.seconds

        self.stats["batches"] += 1
        self.stats["queries"] += len(texts)
        self.stats["adversarial"] += int(det.is_adversarial.sum())
        self.stats["errors"] += len(errors)
        return PipelineResult(
            is_adversarial=det.is_adversarial,
            scores=det.aggregated_score,
            method_scores=det.method_scores,
            variants=variants,
            retrieved=retrieved,
            timings=timings,
            errors=errors,
        )

    def process_single(self, image, text: str) -> Dict[str, Any]:
        """(reference src/pipeline.py:333-421 shape)"""
        res = self.process_batch(
            image if isinstance(image, (list, tuple)) else [image], [text]
        )
        return {
            "is_adversarial": bool(res.is_adversarial[0]),
            "score": float(res.scores[0]),
            "method_scores": {k: float(v[0]) for k, v in res.method_scores.items()},
            "variants": res.variants[0],
            "retrieved": res.retrieved[0] if res.retrieved else None,
            "timings": res.timings,
            "errors": res.errors,
        }

    def evaluate_pipeline(
        self, images, texts: Sequence[str], labels: Sequence[int]
    ) -> Dict[str, Any]:
        """Run + score against ground truth (reference :605-666)."""
        from tvc_torch.metrics import DetectionEvaluator

        t0 = time.time()
        results: List[PipelineResult] = []
        bs = self.config.batch_size
        all_scores, all_flags = [], []
        n = len(texts)
        for i in range(0, n, bs):
            chunk_imgs = images[i : i + bs]
            chunk_txts = list(texts[i : i + bs])
            r = self.process_batch(chunk_imgs, chunk_txts)
            results.append(r)
            all_scores.append(r.scores)
            all_flags.append(r.is_adversarial)
        total_time = time.time() - t0
        scores = np.concatenate(all_scores)
        flags = np.concatenate(all_flags)
        metrics = DetectionEvaluator.evaluate(np.asarray(labels), scores)
        return {
            "metrics": metrics,
            "throughput_qps": n / total_time if total_time > 0 else 0.0,
            "total_time": total_time,
            "n_queries": n,
            "detection_rate": float(flags[np.asarray(labels) == 1].mean())
            if np.any(np.asarray(labels) == 1)
            else float("nan"),
            "false_positive_rate": float(flags[np.asarray(labels) == 0].mean())
            if np.any(np.asarray(labels) == 0)
            else float("nan"),
            "profiler": self.profiler.get_stats(),
        }

    def generate_report(self, evaluation: Dict[str, Any], path: Optional[str] = None) -> Dict[str, Any]:
        """JSON report (reference :667-780)."""
        m = evaluation["metrics"]
        report = {
            "summary": {
                "auroc": m.auroc,
                "accuracy": m.accuracy,
                "f1": m.f1,
                "fpr_at_95_tpr": m.fpr_at_95_tpr,
                "throughput_qps": evaluation["throughput_qps"],
                "n_queries": evaluation["n_queries"],
            },
            "detection_rate": evaluation["detection_rate"],
            "false_positive_rate": evaluation["false_positive_rate"],
            "profiler": evaluation["profiler"],
            "pipeline_stats": self.stats,
        }
        if path:
            p = Path(path)
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(json.dumps(report, indent=2, default=str))
        return report

    def get_stats(self) -> Dict[str, Any]:
        return {**self.stats, "profiler": self.profiler.get_stats()}


# reference alias (src/pipeline.py:805)
DefensePipeline = MultiModalDetectionPipeline


def create_detection_pipeline(
    model: CLIPModel, config: Optional[PipelineConfig] = None, **kw
) -> MultiModalDetectionPipeline:
    """(reference src/pipeline.py:808)"""
    return MultiModalDetectionPipeline(model, config, **kw)
