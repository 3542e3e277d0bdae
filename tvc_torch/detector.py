"""Adversarial detector (port of ``tvc/detector.py``: the primary-stack
``AdversarialDetector`` with its fused serving path, the staged path, the
hub probe, two-sided and Youden calibration, the single-query
``detect_adversarial`` with its LRU result cache and the JSON save / load;
the threshold managers, ``EnsembleDetector`` and ``create_detector``).

``detect_batch`` routes through one serving step (``make_serving_step``:
encode + bank top-k + consistency kernel) whenever the inputs allow it;
host stages remain only for tokenizing the variant texts and staging
the tokens, the latter while the pixels go to the device
(``tvc_torch.core.staging``). A retriever
whose image bank is sharded over a mesh serves through the mesh step (the
batch padded to a multiple of the ``data`` axis, the outputs trimmed).
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tvc_torch._device import resolve_device
from tvc_torch.core import consistency as C
from tvc_torch.core.kernels.consistency_kernel import fused_consistency_scores
from tvc_torch.core.staging import stager
from tvc_torch.metrics import DetectionEvaluator
from tvc_torch.models.clip import CLIPModel, preprocess_images
from tvc_torch.parallel.mesh import DATA_AXIS, axis_size
from tvc_torch.utils import tracing


@dataclasses.dataclass
class DetectorConfig:
    detection_threshold: float = C.DEFAULT_THRESHOLD
    score_aggregation: str = "weighted_mean"  # mean | max | min | weighted_mean
    weights: Tuple[float, float, float] = (0.4, 0.4, 0.2)  # tv, sd, consistency
    num_text_variants: int = 5
    num_reference_images: int = 3
    #: bank indices retrieved in the fused step (>= num_reference_images);
    #: None = num_reference_images
    retrieval_top_k: Optional[int] = None
    methods: Tuple[str, ...] = ("text_variants", "sd_reference", "consistency")
    #: route detect_batch through the fused serving step when inputs allow
    use_fused_step: bool = True
    #: detect_adversarial keeps its results in an LRU cache of cache_size
    cache_enabled: bool = True
    cache_size: int = 1000
    #: fixed text-sequence bucket for the fused step (rounded up to a
    #: multiple of 8; None = per-batch adaptive). Overlong texts truncate
    #: with EOT pinned in-window.
    text_bucket: Optional[int] = None
    #: two-sided detection: also flag abnormally HIGH consistency
    two_sided: bool = False
    lower_threshold: float = -1.0


@dataclasses.dataclass
class DetectionResult:
    is_adversarial: np.ndarray  # [B] bool
    aggregated_score: np.ndarray  # [B]
    method_scores: Dict[str, np.ndarray]  # each [B]
    details: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _first_row(v):
    """Batch detail -> single-query detail: scalars pass through, [B]
    arrays -> float, [B, K] arrays (the fused ref_idx) -> list of K."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    arr = np.asarray(v)
    if arr.ndim == 0:
        return float(arr)
    row = arr[0]
    return float(row) if row.ndim == 0 else row.tolist()


class ThresholdManager:
    """Fixed threshold with history."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self.history: List[float] = []

    def get_threshold(self) -> float:
        return self.threshold

    def update(self, threshold: float) -> None:
        self.history.append(self.threshold)
        self.threshold = threshold


class AdaptiveThresholdManager(ThresholdManager):
    """EMA-adaptive threshold from recent clean-score statistics."""

    def __init__(self, threshold: float = 0.5, momentum: float = 0.9, margin: float = 2.0):
        super().__init__(threshold)
        self.momentum = momentum
        self.margin = margin
        self._mean = None
        self._var = None

    def observe_clean_scores(self, scores: np.ndarray) -> None:
        m, v = float(np.mean(scores)), float(np.var(scores))
        if self._mean is None:
            self._mean, self._var = m, v
        else:
            self._mean = self.momentum * self._mean + (1 - self.momentum) * m
            self._var = self.momentum * self._var + (1 - self.momentum) * v
        self.update(self._mean + self.margin * np.sqrt(max(self._var, 1e-12)))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


class AdversarialDetector:
    """Primary-stack detector (batched); runs on the card unless
    ``device="cpu"`` (the model must be on the same device)."""

    def __init__(
        self,
        model: CLIPModel,
        config: Optional[DetectorConfig] = None,
        text_augmenter=None,
        reference_generator=None,
        retriever=None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        """reference_generator: ``(texts, n) -> [B, n, D]`` embeddings;
        retriever: a MultiModalRetriever whose image bank gives the
        retrieval references inside the fused step."""
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, detector on {self.device}")
        self.model = model
        self.config = config or DetectorConfig()
        self.text_augmenter = text_augmenter
        self.reference_generator = reference_generator
        self.retriever = retriever
        self.threshold_manager = ThresholdManager(self.config.detection_threshold)
        self._cache: Dict[str, Dict[str, Any]] = {}  # detect_adversarial results, oldest first
        self._serving = None  # (key, step) lazy cache
        self._probe: Optional[torch.Tensor] = None  # [P, D] hub-probe caption embeddings
        self._probe_top_m = 8
        self._probe_threshold = None
        self.stats = {"detections": 0, "adversarial_detected": 0, "cache_hits": 0}

    # -- hub probe --------------------------------------------------------------
    def set_hub_probe(self, texts=None, embeddings=None, top_m: int = 8):
        """Arm the hub-probe branch: score each query image by the mean of
        its top-``top_m`` cosines to a held-out caption pool; an
        adversarial hub aligns with the caption cone, so the score is
        anomalously high."""
        if embeddings is None:
            if not texts:
                raise ValueError("set_hub_probe needs texts or embeddings")
            embeddings = self.model.encode_text(list(texts))
        emb = np.array(_np(embeddings), np.float32)
        emb /= np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-12)
        self._probe = torch.as_tensor(emb, device=self.device)
        self._probe_top_m = int(min(top_m, emb.shape[0]))
        return self

    @torch.no_grad()
    def hub_probe_scores(self, img_feats) -> np.ndarray:
        """Mean of each image feature's top-m cosines to the probe pool."""
        if self._probe is None:
            raise ValueError("hub probe not armed: call set_hub_probe first")
        img = torch.as_tensor(img_feats, dtype=torch.float32, device=self.device)
        top = torch.topk(img @ self._probe.T, self._probe_top_m, dim=-1).values
        return _np(top.mean(dim=-1))

    def calibrate_hub_probe(self, clean_images, quantile: float = 0.995) -> float:
        feats = self.model.encode_image(self._raw_pixels(clean_images))
        self._probe_threshold = float(np.quantile(self.hub_probe_scores(feats), quantile))
        return self._probe_threshold

    # -- embedding assembly (staged path) -----------------------------------------
    def _variant_lists(self, texts, variants) -> List[List[str]]:
        V = self.config.num_text_variants
        if variants is not None:
            return [list(v)[:V] for v in variants]
        return self.text_augmenter.batch_generate_variants(texts, V)

    def _embed_variants(
        self, texts: Sequence[str], variants: Optional[Sequence[Sequence[str]]] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """All queries' variants in one text encode: ([B, V, D], [B, V] mask)."""
        V = self.config.num_text_variants
        B = len(texts)
        D = self.model.config.embed_dim
        emb = np.zeros((B, V, D), np.float32)
        mask = np.zeros((B, V), bool)
        if variants is None and self.text_augmenter is None:
            return emb, mask
        variant_lists = self._variant_lists(texts, variants)
        flat = [v for vl in variant_lists for v in vl]
        if flat:
            flat_emb = _np(self.model.encode_text(flat))
            pos = 0
            for b, vl in enumerate(variant_lists):
                n = len(vl)
                emb[b, :n] = flat_emb[pos : pos + n]
                mask[b, :n] = True
                pos += n
        return emb, mask

    def _embed_references(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """Retrieval-bank refs + generated refs, merged and trimmed to R."""
        R = self.config.num_reference_images
        B = len(texts)
        D = self.model.config.embed_dim
        parts = []
        if self.retriever is not None and self.retriever.image_bank is not None:
            parts.append(self.retriever.retrieve_reference_embeddings(texts, top_k=R))
        if self.reference_generator is not None:
            parts.append(_np(self.reference_generator(list(texts), R)))
        if not parts:
            return np.zeros((B, R, D), np.float32), np.zeros((B, R), bool)
        refs = np.concatenate(parts, axis=1)[:, :R]
        return refs.astype(np.float32), np.any(refs != 0, axis=-1)

    # -- fused serving path --------------------------------------------------------
    def _can_fuse(self) -> bool:
        cfg = self.config
        if not cfg.use_fused_step or cfg.score_aggregation != "weighted_mean":
            return False
        if self.reference_generator is not None:
            return False  # host generators stay on the staged path
        if "sd_reference" in cfg.methods and self.retriever is not None:
            bank = self.retriever.image_bank
            if bank is None:
                return False
            if bank.size < max(cfg.num_reference_images, cfg.retrieval_top_k or 0):
                return False
        return True

    def _raw_pixels(self, images) -> np.ndarray:
        """PIL list / raw array -> [B,H,W,3] float32 in [0, 1] (the step
        CLIP-normalizes on the device)."""
        if isinstance(images, (list, tuple)):
            return preprocess_images(images, self.model.config.image_size, normalize=False)
        arr = np.asarray(images, np.float32)
        return arr[None] if arr.ndim == 3 else arr

    def _variant_tokens(
        self, texts: Sequence[str], variants: Optional[Sequence[Sequence[str]]] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Host stage: tokenize the variants: ([B, V, T] int32, [B, V] bool)."""
        cfg = self.config
        B = len(texts)
        V = cfg.num_text_variants
        T = self.model.config.context_length
        tokens = np.zeros((B, V, T), np.int32)
        mask = np.zeros((B, V), bool)
        no_source = variants is None and self.text_augmenter is None
        if no_source or "text_variants" not in cfg.methods:
            return tokens[:, :1], mask[:, :1]
        variant_lists = self._variant_lists(texts, variants)
        flat = [v for vl in variant_lists for v in vl]
        if flat:
            flat_tok = np.asarray(self.model.tokenize(flat))
            pos = 0
            for b, vl in enumerate(variant_lists):
                n = len(vl)
                tokens[b, :n, : flat_tok.shape[1]] = flat_tok[pos : pos + n]
                mask[b, :n] = True
                pos += n
        return tokens, mask

    def _serving_step(self, with_bank: bool):
        """The cached serving step for (with_bank, R, K) and the current
        parameter tree.

        In int8 serving the step holds the int8 weights quantized from
        ``model.params`` when it was built, so the key holds the tree itself
        and compares it with ``is``: assigning new parameters builds a new
        step with new int8 weights (an ``id()`` of a freed tree could be
        reused by the new one and serve stale weights)."""
        from tvc_torch.parallel.steps import make_serving_step

        cfg = self.config
        R = cfg.num_reference_images
        K = max(R, cfg.retrieval_top_k or 0)
        mesh = self._mesh(with_bank)
        key = ((with_bank, R, K) if with_bank else (False, 0, 0), self.model.params, mesh)
        if self._serving is None or not (
            self._serving[0][0] == key[0] and self._serving[0][1] is key[1] and self._serving[0][2] is key[2]
        ):
            mcfg = self.model.config
            # quantize the serving weights once per step, not per batch
            qp = self.model.qparams() if mcfg.int8_serving and mcfg.fused_attention else None
            step = make_serving_step(
                self.model, mesh=mesh, top_k=K, num_refs=R, with_bank=with_bank, qparams=qp,
                device=self.device,
            )
            self._serving = (key, step)
        return self._serving[1]

    def _mesh(self, with_bank: bool):
        """The mesh of the retriever's image bank: a sharded bank serves
        through the mesh step (batch over ``data``, bank rows where the bank
        keeps them)."""
        return self.retriever.image_bank.mesh if with_bank else None

    def _detect_batch_fused(
        self, images, texts: Sequence[str], variants: Optional[Sequence[Sequence[str]]] = None
    ) -> DetectionResult:
        """One serving step: encode + bank top-k + consistency kernel."""
        cfg = self.config
        with_bank = (
            "sd_reference" in cfg.methods
            and self.retriever is not None
            and self.retriever.image_bank is not None
        )
        mesh = self._mesh(with_bank)
        with tracing.span("detect.tokenize"):
            tokens = np.asarray(self.model.tokenize(list(texts)))
            var_tokens, var_mask = self._variant_tokens(texts, variants)
        with tracing.span("detect.stage"):
            pixels = self._raw_pixels(images)
            B_real = pixels.shape[0]
            # mesh serving: the batch shards over ``data``; pad B up to a
            # multiple (masked pad rows) and trim the outputs back
            pad = (-B_real) % axis_size(mesh, DATA_AXIS) if mesh is not None else 0
            if pad:
                pixels = np.concatenate([pixels, np.zeros_like(pixels[:pad])])
        # the pixels go to the device while the host stages the tokens,
        # buckets them and launches the text tower (the tokenizer's own
        # threads fill every core, so the copy waits for it); the upload's
        # spans are children of detect.batch
        pixels = stager(self.device).start(pixels)
        with tracing.span("detect.stage"):
            step = self._serving_step(with_bank)
            # real length = EOT position + 1 (EOT is the highest id)
            real = max(int(tokens.argmax(-1).max()) + 1, int(var_tokens.argmax(-1).max()) + 1)
            if cfg.text_bucket is not None:
                # fixed serving bucket; pin EOT in-window for rows truncation cuts
                T_b = min(-(-cfg.text_bucket // 8) * 8, tokens.shape[-1])
                eot = getattr(self.model.tokenizer, "eot_id", None)
                if eot is not None and real > T_b:
                    tokens = tokens.copy()
                    var_tokens = var_tokens.copy()
                    tokens[tokens.argmax(-1) >= T_b, T_b - 1] = eot
                    vflat = var_tokens.reshape(-1, var_tokens.shape[-1])
                    vflat[vflat.argmax(-1) >= T_b, T_b - 1] = eot
            else:
                T_b = min(-(-real // 8) * 8, tokens.shape[-1])
            tokens = np.ascontiguousarray(tokens[:, :T_b])
            var_tokens = np.ascontiguousarray(var_tokens[:, :, :T_b])

            if pad:
                tokens = np.concatenate([tokens, np.zeros_like(tokens[:pad])])
                var_tokens = np.concatenate([var_tokens, np.zeros_like(var_tokens[:pad])])
                var_mask = np.concatenate([var_mask, np.zeros_like(var_mask[:pad])])

            if with_bank:
                bank_obj = self.retriever.image_bank
                bank, valid = bank_obj._bank, bank_obj.valid
            else:
                D = self.model.config.embed_dim
                bank, valid = np.zeros((1, D), np.float32), np.zeros((1,), bool)
            upper = np.float32(self.threshold_manager.get_threshold())
            lower = np.float32(cfg.lower_threshold) if cfg.two_sided else np.float32(-np.inf)
        with tracing.span("detect.step"):
            out = step(
                self.model.params, pixels, tokens, var_tokens, var_mask, bank, valid,
                np.asarray(cfg.weights, np.float32), lower, upper,
            )
            out = {k: v[:B_real] for k, v in out.items()}
        with tracing.span("detect.readback"):
            return self._fused_result(out, texts, upper, with_bank, mesh)

    def _fused_result(self, out, texts, upper, with_bank: bool, mesh) -> DetectionResult:
        """The step's outputs read back to the host (the first read waits on
        the device), the hub probe applied."""
        flags = _np(out["is_adversarial"])
        agg = _np(out["aggregated"])
        probe_scores = None
        if self._probe is not None:
            probe_scores = self.hub_probe_scores(out["img"])
            if self._probe_threshold is not None:
                flags = flags | (probe_scores > self._probe_threshold)
        self.stats["detections"] += len(texts)
        self.stats["adversarial_detected"] += int(flags.sum())
        details = {
            "orig_similarity": _np(out["orig_similarity"]),
            "variant_mean": _np(out["variant_mean"]),
            "variant_std": _np(out["variant_std"]),
            "threshold": float(upper),
            "ref_idx": _np(out["ref_idx"]) if with_bank else None,
            "fused": True,
            "mesh": mesh is not None,
        }
        if probe_scores is not None:
            details.update(hub_probe_score=probe_scores, hub_probe_threshold=self._probe_threshold)
        return DetectionResult(
            is_adversarial=flags,
            aggregated_score=agg,
            method_scores={
                "text_variants": _np(out["tv_score"]),
                "sd_reference": _np(out["sd_score"]),
                "consistency": _np(out["consistency_score"]),
            },
            details=details,
        )

    # -- detection ------------------------------------------------------------------
    def detect_batch(
        self, images, texts: Sequence[str], variants: Optional[Sequence[Sequence[str]]] = None
    ) -> DetectionResult:
        """images: PIL list or [B,H,W,3] raw pixels; texts: list[str];
        variants: optional precomputed per-query variant lists. Runs inside
        a ``detect.batch`` span; the fused path splits it into
        ``detect.tokenize``, ``detect.stage`` (the pixels; their upload
        starts after it), ``detect.stage`` (the tokens), ``detect.step``
        (in it the step's ``detect.upload_wait``, recorded as a child of
        ``detect.batch``) and ``detect.readback``."""
        with tracing.span("detect.batch", rows=len(texts)):
            if self._can_fuse():
                return self._detect_batch_fused(images, texts, variants)
            return self._detect_batch_staged(images, texts, variants)

    def _detect_batch_staged(self, images, texts, variants) -> DetectionResult:
        cfg = self.config
        dev = self.device
        img_emb = self.model.encode_image(images)
        txt_emb = self.model.encode_text(list(texts))
        B, D = img_emb.shape
        empty = (np.zeros((B, 1, D), np.float32), np.zeros((B, 1), bool))
        var_emb, var_mask = (
            self._embed_variants(texts, variants) if "text_variants" in cfg.methods else empty
        )
        ref_emb, ref_mask = (
            self._embed_references(texts) if "sd_reference" in cfg.methods else empty
        )
        threshold = self.threshold_manager.get_threshold()
        var_mask_t = torch.as_tensor(var_mask, device=dev)
        ref_mask_t = torch.as_tensor(ref_mask, device=dev)
        out = fused_consistency_scores(
            img_emb.contiguous(), txt_emb.contiguous(),
            torch.as_tensor(var_emb, device=dev), torch.as_tensor(ref_emb, device=dev),
            variant_mask=var_mask_t, ref_mask=ref_mask_t,
            weights=cfg.weights, threshold=threshold,
        )
        method_scores = {
            "text_variants": _np(out["tv_score"]),
            "sd_reference": _np(out["sd_score"]),
            "consistency": _np(out["consistency_score"]),
        }
        if cfg.score_aggregation == "weighted_mean":
            agg = _np(out["aggregated"])
            flags = _np(out["is_adversarial"])
        else:
            # other aggregations recombine the per-method scores ([B, 3])
            stacked = torch.stack([out["tv_score"], out["sd_score"], out["consistency_score"]], dim=-1)
            present = torch.stack(
                [var_mask_t.any(-1), ref_mask_t.any(-1), torch.ones(B, dtype=torch.bool, device=dev)],
                dim=-1,
            )
            agg = _np(C.aggregate_scores(stacked, present, method=cfg.score_aggregation))
            flags = agg > threshold
        if cfg.two_sided:
            flags = flags | (agg < cfg.lower_threshold)
        probe_scores = None
        if self._probe is not None:
            probe_scores = self.hub_probe_scores(img_emb)
            if self._probe_threshold is not None:
                flags = flags | (probe_scores > self._probe_threshold)
        self.stats["detections"] += B
        self.stats["adversarial_detected"] += int(flags.sum())
        details = {
            "orig_similarity": _np(out["orig_similarity"]),
            "variant_mean": _np(out["variant_mean"]),
            "variant_std": _np(out["variant_std"]),
            "threshold": threshold,
        }
        if probe_scores is not None:
            details.update(hub_probe_score=probe_scores, hub_probe_threshold=self._probe_threshold)
        return DetectionResult(
            is_adversarial=flags, aggregated_score=agg, method_scores=method_scores, details=details
        )

    # -- single-query result cache -------------------------------------------------
    def _cache_key(self, image, text: str, methods: Sequence[str]) -> str:
        """md5 of the text, the methods, the decision parameters (thresholds
        and weights: a calibration update invalidates stale decisions) and
        the image bytes, as the JAX package keys it."""
        h = hashlib.md5()
        h.update(text.encode("utf-8"))
        h.update("|".join(methods).encode())
        cfg = self.config
        h.update(
            np.asarray(
                [self.threshold_manager.get_threshold(), cfg.lower_threshold if cfg.two_sided else -np.inf,
                 *cfg.weights],
                np.float64,
            ).tobytes()
        )
        if hasattr(image, "tobytes"):  # PIL image or ndarray
            h.update(np.asarray(image).tobytes())
        else:
            h.update(repr(image).encode())
        return h.hexdigest()

    def detect_adversarial(self, image, text: str, methods: Optional[Sequence[str]] = None) -> Dict[str, Any]:
        """Single-query wrapper over :meth:`detect_batch`: ``{"is_adversarial",
        "aggregated_score", "scores", "threshold", "details"}``.

        With ``config.cache_enabled`` results are cached per (image, text,
        methods, thresholds, weights), evicting the least recently used past
        ``config.cache_size``; the cache holds and returns deep copies, so a
        caller's edits never reach it. ``methods`` overrides
        ``config.methods`` for this call only."""
        cfg0 = self.config
        key = None
        if cfg0.cache_enabled and not isinstance(image, (list, tuple)):
            key = self._cache_key(image, text, methods or cfg0.methods)
            hit = self._cache.pop(key, None)
            if hit is not None:
                self._cache[key] = hit  # most recent again
                self.stats["cache_hits"] += 1
                return copy.deepcopy(hit)
        if methods is not None:
            saved = self.config
            self.config = dataclasses.replace(saved, methods=tuple(methods))
        try:
            res = self.detect_batch(image if isinstance(image, (list, tuple)) else [image], [text])
        finally:
            if methods is not None:
                self.config = saved
        out = {
            "is_adversarial": bool(res.is_adversarial[0]),
            "aggregated_score": float(res.aggregated_score[0]),
            "scores": {k: float(v[0]) for k, v in res.method_scores.items()},
            "threshold": res.details["threshold"],
            "details": {k: _first_row(v) for k, v in res.details.items()},
        }
        if key is not None:
            self._cache[key] = copy.deepcopy(out)
            while len(self._cache) > cfg0.cache_size:
                self._cache.pop(next(iter(self._cache)))  # the least recently used
        return out

    # -- calibration ----------------------------------------------------------------
    def calibrate_two_sided(
        self, clean_scores: np.ndarray, quantile: float = 0.995
    ) -> Tuple[float, float]:
        """Set (lower, upper) from clean-score quantiles and enable two-sided
        detection: anything outside the clean band flags adversarial."""
        lo = float(np.quantile(clean_scores, 1.0 - quantile))
        hi = float(np.quantile(clean_scores, quantile))
        self.config = dataclasses.replace(self.config, two_sided=True, lower_threshold=lo)
        self.threshold_manager.update(hi)
        return lo, hi

    def compute_optimal_threshold(self, clean_scores: np.ndarray, adv_scores: np.ndarray) -> float:
        """Set the threshold to the ROC Youden-J point of known clean (label
        0) and adversarial (label 1) scores; returns it."""
        labels = np.concatenate([np.zeros(len(clean_scores)), np.ones(len(adv_scores))])
        scores = np.concatenate([clean_scores, adv_scores])
        thr = DetectionEvaluator.optimal_threshold_youden(labels, scores)
        self.threshold_manager.update(thr)
        return thr

    # -- persistence: the config, threshold and stats as JSON -------------------------
    def save_model(self, path: str) -> None:
        """The JAX package's JSON keys; ``use_pallas`` is written as true
        (the port always runs its kernels on the card)."""
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        data = {
            "config": {
                **dataclasses.asdict(self.config),
                "use_pallas": True,
                "weights": list(self.config.weights),
                "methods": list(self.config.methods),
            },
            "threshold": self.threshold_manager.get_threshold(),
            "stats": self.stats,
        }
        Path(path).write_text(json.dumps(data))

    def load_model(self, path: str) -> None:
        """Reads what either package's ``save_model`` wrote (``use_pallas``
        is ignored)."""
        data = json.loads(Path(path).read_text())
        cfg = dict(data["config"])
        cfg.pop("use_pallas", None)
        cfg["weights"] = tuple(cfg["weights"])
        cfg["methods"] = tuple(cfg["methods"])
        self.config = DetectorConfig(**cfg)
        self.threshold_manager = ThresholdManager(data["threshold"])
        self.stats = data["stats"]

    def get_stats(self) -> Dict[str, Any]:
        return dict(self.stats)


class EnsembleDetector:
    """Weighted mean or majority vote over several detectors, each with its
    own threshold: ``mean`` flags where the weighted score exceeds the
    weighted threshold; ``majority`` flags a weighted majority of votes and
    scores the weighted mean threshold margin (> 0 means adversarial)."""

    def __init__(
        self,
        detectors: Sequence[AdversarialDetector],
        strategy: str = "mean",
        weights: Optional[Sequence[float]] = None,
    ):
        if not detectors:
            raise ValueError("need at least one detector")
        if weights is not None and len(weights) != len(detectors):
            raise ValueError("weights must match detectors")
        self.detectors = list(detectors)
        self.strategy = strategy
        self.weights = (
            np.asarray(weights, np.float64) / np.sum(weights)
            if weights is not None
            else np.full(len(detectors), 1.0 / len(detectors))
        )

    def detect_batch(self, images, texts) -> DetectionResult:
        results = [d.detect_batch(images, texts) for d in self.detectors]
        scores = np.stack([r.aggregated_score for r in results])  # [M, B]
        thresholds = np.asarray([d.threshold_manager.get_threshold() for d in self.detectors])
        w = self.weights[:, None]
        if self.strategy == "mean":
            agg = (scores * w).sum(axis=0)
            flags = agg > float((thresholds * self.weights).sum())
        else:  # majority: weighted vote; score = mean threshold margin
            votes = np.stack([r.is_adversarial for r in results]).astype(np.float64)
            flags = (votes * w).sum(axis=0) > 0.5
            agg = ((scores - thresholds[:, None]) * w).sum(axis=0)
        return DetectionResult(
            is_adversarial=flags, aggregated_score=agg, method_scores={},
            details={"n_detectors": len(self.detectors)},
        )


def create_detector(model: CLIPModel, config: Optional[DetectorConfig] = None, **kw) -> AdversarialDetector:
    return AdversarialDetector(model, config, **kw)
