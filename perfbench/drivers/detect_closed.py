"""One caller, closed loop: back-to-back ``AdversarialDetector.detect_batch``
calls of the int8 serving detector, each batch with its captions and their
given variants and a set-up image batch."""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import weights
from perfbench.drivers import sample_rows
from perfbench.reference import clip_int8 as ref
from perfbench.traffic import Traffic

#: the program's method_scores keys -> the reference's names
SCORES = {"text_variants": "tv_score", "sd_reference": "sd_score", "consistency": "consistency_score"}
DETAILS = ("orig_similarity", "variant_mean", "variant_std")


def clip_section(cfg: Dict) -> Dict:
    return cfg.get("clip", cfg)


def build_clip(c: Dict, seed: int, device):
    """The program's int8 serving CLIP model on the benchmark's seeded
    weights, and its retriever over the seeded bank."""
    from tvc_torch.models.clip import CLIPConfig, CLIPModel
    from tvc_torch.retrieval import MultiModalRetriever, RetrievalConfig

    keys = ("image_size", "patch_size", "vision_width", "vision_layers", "vision_heads", "vocab_size",
            "context_length", "text_width", "text_layers", "text_heads", "embed_dim")
    mcfg = CLIPConfig(**{k: c[k] for k in keys}, dtype=torch.bfloat16, model_name=c["name"],
                      fused_attention=True, int8_serving=True)
    model = CLIPModel(mcfg, params=weights.nest(weights.clip_params(c, seed, device)), device=device)
    retriever = MultiModalRetriever(model, RetrievalConfig())
    retriever.build_image_index(embeddings=weights.bank(c["bank_rows"], c["embed_dim"], seed, device).cpu().numpy())
    return model, retriever


def host_images(n_batches: int, batch: int, c: Dict, seed: int, device) -> List[np.ndarray]:
    imgs = weights.images(n_batches * batch, c["image_size"], seed, device).cpu().numpy()
    return [imgs[i * batch : (i + 1) * batch] for i in range(n_batches)]


class Driver:
    def __init__(self, cfg: Dict, wl: Dict, mix: Dict, seed: int, device, spans):
        self.cfg, self.wl, self.mix, self.seed, self.device, self.spans = cfg, wl, mix, seed, device, spans
        self.c = clip_section(cfg)
        self.B, self.V = int(mix["batch"]), int(mix["variants"])
        d = self.c["detector"]
        self.R, self.K, self.bucket = d["num_reference_images"], d["retrieval_top_k"], d["text_bucket"]
        self.threshold = d["detection_threshold"]

    def setup(self) -> None:
        from tvc_torch.detector import AdversarialDetector, DetectorConfig

        self.model, self.retriever = build_clip(self.c, self.seed, self.device)
        self.det = AdversarialDetector(
            self.model, retriever=self.retriever, device=self.device,
            config=DetectorConfig(num_text_variants=self.V, num_reference_images=self.R,
                                  retrieval_top_k=self.K, text_bucket=self.bucket,
                                  detection_threshold=self.threshold),
        )
        self.traffic = Traffic(self.mix, self.seed)
        self.images = host_images(int(self.mix["image_batches"]), self.B, self.c, self.seed, self.device)
        for k in range(int(self.mix.get("warmup_batches", 2))):
            texts, variants = self.traffic.variant_batch(k)
            self.det.detect_batch(self.images[k % len(self.images)], texts, variants)
        torch.cuda.synchronize(self.device) if self.device.type == "cuda" else None

    def instrument(self) -> None:
        import tvc_torch.models.clip as clip_mod

        from perfbench.spans import i8_layer_shapes

        i8_layer_shapes(self.spans, clip_mod)

    def window(self, seconds: float, sub) -> Dict:
        self.out: List = []
        k = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            sub.step(k)
            texts, variants = self.traffic.variant_batch(k)
            with self.spans.span("detect_batch"):
                res = self.det.detect_batch(self.images[k % len(self.images)], texts, variants)
            self.out.append(res)
            k += 1
            if time.perf_counter() >= deadline:
                break
        sub.stop()
        elapsed = time.perf_counter() - t0
        self.batches = k
        return {"e2e": {"detect_qps": k * self.B / elapsed}, "attempted": k * self.B, "failed": 0,
                "window_s": elapsed}

    def free(self) -> None:
        for name in ("det", "retriever", "model"):
            self.__dict__.pop(name, None)
        gc.collect()
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    def answers(self, rows: List[int]):
        """The program's per-row answers of the sampled window rows."""
        out = {k: [] for k in ref.SCORE_KEYS + ("is_adversarial",)}
        chosen, texts, variants, pixels = [], [], [], []
        for r in rows:
            k, j = divmod(r, self.B)
            res = self.out[k]
            out["aggregated"].append(res.aggregated_score[j])
            out["is_adversarial"].append(res.is_adversarial[j])
            for s, name in SCORES.items():
                out[name].append(res.method_scores[s][j])
            for s in DETAILS:
                out[s].append(res.details[s][j])
            chosen.append(res.details["ref_idx"][j])
            t, v = self.traffic.variant_batch(k)
            texts.append(t[j])
            variants.append(v[j])
            pixels.append(self.images[k % len(self.images)][j])
        return {k: np.asarray(v) for k, v in out.items()}, np.stack(chosen), texts, variants, np.stack(pixels)

    def check(self, limits: Dict[str, float], n_rows: int) -> Dict[str, float]:
        rows = sample_rows(self.batches * self.B, n_rows, self.seed)
        out, chosen, texts, variants, pixels = self.answers(rows)
        c, dev = self.c, self.device
        p = weights.clip_params(c, self.seed, dev)
        bank = weights.bank(c["bank_rows"], c["embed_dim"], self.seed, dev)
        model = ref.ClipInt8(c, p, bits=8)
        from perfbench.reference.tokenizers import ClipBPE

        return ref.judge_rows(model, ClipBPE(c["context_length"]), bank, torch.as_tensor(pixels), texts, variants,
                              self.V, out, chosen, self.R, self.bucket, self.threshold, limits["score_gap"])

    # -- what the per-layer metrics read ----------------------------------------------
    def work(self, steps: int) -> Dict:
        from perfbench import work

        c = self.c
        calls = [work.i8_attention_layer(*s) for s in self.spans.shapes["i8_attention_layer"]]
        calls += [work.i8_mlp_layer(*s) for s in self.spans.shapes["i8_mlp_layer"]]
        layers = [ops for ops, _ in calls]
        other = [work.clip_embed_and_bank(self.B, c, c["bank_rows"], self.B * (self.V + 1)) for _ in range(steps)]
        return {
            "ops": work.add(*layers, *other),
            "i8_layers_bound_s": sum(work.bound_s(ops, nbytes) for ops, nbytes in calls),
            "i8_layer_calls": len(calls),
        }

    # -- the control: the reference one precision below, in the program's place ---------
    def control(self, limits: Dict[str, float], n_rows: int, batches: int, bits: int = 4) -> Dict[str, float]:
        """The numbers the check reads when the int4 reference answers the
        rows a window of ``batches`` batches would be sampled from."""
        from perfbench.reference.tokenizers import ClipBPE

        self.traffic = Traffic(self.mix, self.seed)
        self.images = host_images(int(self.mix["image_batches"]), self.B, self.c, self.seed, self.device)
        rows = sample_rows(batches * self.B, n_rows, self.seed)
        texts, variants, pixels = [], [], []
        for r in rows:
            k, j = divmod(r, self.B)
            t, v = self.traffic.variant_batch(k)
            texts.append(t[j])
            variants.append(v[j])
            pixels.append(self.images[k % len(self.images)][j])
        c, dev = self.c, self.device
        p = weights.clip_params(c, self.seed, dev)
        bank = weights.bank(c["bank_rows"], c["embed_dim"], self.seed, dev)
        bpe = ClipBPE(c["context_length"])
        px = torch.as_tensor(np.stack(pixels))
        out, chosen = ref.answer_rows(ref.ClipInt8(c, p, bits=bits), bpe, bank, px, texts, variants, self.V,
                                      self.R, self.K, self.bucket, self.threshold)
        return ref.judge_rows(ref.ClipInt8(c, p, bits=8), bpe, bank, px, texts, variants, self.V, out, chosen,
                              self.R, self.bucket, self.threshold, limits["score_gap"])
