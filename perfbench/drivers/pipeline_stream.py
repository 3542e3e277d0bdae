"""Full TVC: ``MultiModalDetectionPipeline.process_stream`` over a stream
of caption batches, the variants made by the Qwen2 w8 paraphrase decode
(through the augmenter's batched path) and scored by the int8 detector.

The driver wraps the paraphrase adapter's ``batch_async`` and the model's
``decode`` in pass-throughs that keep the texts each decode received and
the tokens it served, for the check; in the traced run the wrapper also
times the host inside ``batch_async`` and inside the finalizer it returns."""

from __future__ import annotations

import functools
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import weights
from perfbench.drivers import sample_rows
from perfbench.drivers.detect_closed import SCORES, build_clip, host_images
from perfbench.reference import clip_int8 as ref
from perfbench.reference import qwen2 as qref
from perfbench.traffic import Traffic


def qwen_config(cfg: Dict):
    from tvc_torch.models.qwen import QwenConfig

    q = cfg["qwen"]
    return QwenConfig(
        vocab_size=q["vocab_size"], hidden_size=q["hidden_size"], intermediate_size=q["intermediate_size"],
        num_layers=q["num_hidden_layers"], num_heads=q["num_attention_heads"],
        num_kv_heads=q["num_key_value_heads"], max_seq_len=cfg["max_seq_len"], rope_theta=q["rope_theta"],
        rms_eps=q["rms_norm_eps"], tie_embeddings=q["tie_word_embeddings"], dtype=torch.bfloat16,
        model_name=cfg["name"], quant_gemm="w8",
    )


class Driver:
    def __init__(self, cfg: Dict, wl: Dict, mix: Dict, seed: int, device, spans):
        self.cfg, self.wl, self.mix, self.seed, self.device, self.spans = cfg, wl, mix, seed, device, spans
        self.c, self.q, self.pc = cfg["clip"], cfg["qwen"], cfg["pipeline"]
        self.B = int(mix["batch"])
        self.V = self.pc["num_text_variants"]
        self.R = self.pc["num_reference_images"]
        self.threshold = self.pc["detection_threshold"]
        self.decodes: List = []

    # -- the program ------------------------------------------------------------------
    def setup(self) -> None:
        from tvc_torch.augment import TextAugmentConfig, TextAugmenter
        from tvc_torch.models.qwen import QwenModel
        from tvc_torch.pipeline import MultiModalDetectionPipeline, PipelineConfig

        dev = self.device
        self.model, self.retriever = build_clip(self.c, self.seed, dev)
        self.qwen = QwenModel(qwen_config(self.cfg), params=weights.nest(weights.qwen_params(self.q, self.seed, dev)),
                              max_new_tokens=self.cfg["max_new_tokens"], cast_params_bf16=True, device=dev)
        self.qwen.quantize_weights_int8()
        gc.collect()
        torch.cuda.empty_cache() if dev.type == "cuda" else None
        self.adapter = self.qwen.as_paraphrase_generator()
        self._spy()
        pc = self.pc
        self.pipe = MultiModalDetectionPipeline(
            self.model,
            PipelineConfig(num_text_variants=pc["num_text_variants"], retrieval_top_k=pc["retrieval_top_k"],
                           num_reference_images=pc["num_reference_images"],
                           detection_threshold=pc["detection_threshold"]),
            text_augmenter=TextAugmenter(TextAugmentConfig(), paraphrase_generator=self.adapter),
            retriever=self.retriever,
            device=dev,
        )
        self.traffic = Traffic(self.mix, self.seed)
        self.images = host_images(int(self.mix["image_batches"]), self.B, self.c, self.seed, dev)
        warm = self.traffic.warmup_batches()
        self.pipe.process_stream([(self.images[i % len(self.images)], t) for i, t in enumerate(warm)])
        torch.cuda.synchronize(dev) if dev.type == "cuda" else None
        self.decodes.clear()

    def _spy(self) -> None:
        """Keep each decode's texts and served tokens; time the paraphrase
        layer's host work while the traced sub-window records."""
        decode, batch_async = self.qwen.decode, self.adapter.batch_async
        drv = self

        def spy_decode(inp, *a, **k):
            rows = decode(inp, *a, **k)
            drv.decodes[-1]["rows"] = rows
            if drv.spans.recording:
                drv.spans.shapes["decode_calls"].append((int(inp.tokens.shape[0]), int(inp.n_samples),
                                                         int(drv.qwen.last_decode_steps)))
            return rows

        def spy_batch_async(texts, n):
            drv.decodes.append({"texts": list(texts), "n": int(n)})
            spans = drv.spans
            t0 = time.perf_counter()
            with spans.span("paraphrase"):
                handle = batch_async(texts, n)
            t1 = time.perf_counter()
            rec = spans.recording

            def finalize():
                t2 = time.perf_counter()
                with spans.span("paraphrase.finalize"):
                    out = handle()
                if rec:
                    spans.shapes["paraphrase_host_s"].append((t1 - t0) + (time.perf_counter() - t2))
                return out

            return finalize

        self.qwen.decode = spy_decode
        self.adapter.batch_async = spy_batch_async

    def instrument(self) -> None:
        import tvc_torch.models.clip as clip_mod
        import tvc_torch.models.qwen as qwen_mod

        from perfbench.spans import i8_layer_shapes

        i8_layer_shapes(self.spans, clip_mod)
        sp = self.spans
        sp.wrap(qwen_mod, "w8_matmul", "w8_gemm", lambda x, w, s: (int(x.shape[0]), *map(int, w.shape)))
        sp.wrap(qwen_mod, "w8_matmul_stacked", "w8_gemm",
                lambda x, w, s, l: (int(x.shape[0]), int(w.shape[1]), int(w.shape[2])))
        sp.wrap(qwen_mod, "w8_matmul_reference", "w8_dequant_gemm",
                lambda x, w, s: (int(np.prod(x.shape[:-1])), int(w.shape[0]), int(w.shape[1])))
        sp.wrap(qwen_mod, "decode_gqa_attention_stacked", "decode_attention",
                lambda q, ck, cv, mask, l: (int(q.shape[0]), int(mask.shape[-1])))
        sp.wrap(qwen_mod, "_gqa_attention", "prefill_attention",
                lambda qg, k, v, mask, dt: (int(qg.shape[0]), int(qg.shape[1]), int(k.shape[2])))
        self.pipe.detector.detect_batch = _spanned(self.pipe.detector.detect_batch, sp, "detection")

    def window(self, seconds: float, sub, max_batches: int = None) -> Dict:
        before = self.pipe.profiler.get_stats().get("detection", {"count": 0, "total": 0.0})
        t0 = time.perf_counter()
        deadline = t0 + seconds
        sent = []

        def batches():
            k = 0
            while k == 0 or (time.perf_counter() < deadline and (max_batches is None or k < max_batches)):
                sub.step(k)
                texts = self.traffic.next_batch()
                sent.append(texts)
                yield self.images[k % len(self.images)], texts
                k += 1

        self.results = self.pipe.process_stream(batches())
        sub.stop()
        elapsed = time.perf_counter() - t0
        after = self.pipe.profiler.get_stats()["detection"]
        n_det = after["count"] - before["count"]
        self.detection_ms = 1e3 * (after["total"] - before["total"]) / n_det if n_det else None
        self.sent = sent
        n = sum(len(t) for t in sent)
        failed = sum(len(t) for t, r in zip(sent, self.results) if r.errors)
        return {"e2e": {"tvc_qps": n / elapsed}, "attempted": n, "failed": failed, "window_s": elapsed}

    def free(self) -> None:
        for d in self.decodes:
            if "rows" in d:
                d["rows"] = d["rows"].cpu().numpy()
        for name in ("pipe", "adapter", "qwen", "retriever", "model"):
            self.__dict__.pop(name, None)
        gc.collect()
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    # -- the check ---------------------------------------------------------------------
    def detection_rows(self, rows: List[int]):
        out = {k: [] for k in ("aggregated", "is_adversarial") + tuple(SCORES.values())}
        chosen, texts, variants, pixels = [], [], [], []
        for r in rows:
            k, j = divmod(r, self.B)
            res = self.results[k]
            out["aggregated"].append(res.scores[j])
            out["is_adversarial"].append(res.is_adversarial[j])
            for s, name in SCORES.items():
                out[name].append(res.method_scores[s][j])
            chosen.append(res.retrieved[j])
            texts.append(self.sent[k][j])
            variants.append(res.variants[j])
            pixels.append(self.images[k % len(self.images)][j])
        return {k: np.asarray(v) for k, v in out.items()}, np.asarray(chosen), texts, variants, np.stack(pixels)

    def served(self, n_seq: int):
        """A sample, drawn from the seed, of the served sequences, with the
        longest in it: ``(caption, served tokens)``."""
        seqs = []
        if n_seq <= 0:
            return seqs
        for d in self.decodes:
            if "rows" not in d:
                continue
            rows = np.asarray(d["rows"])
            for i in range(rows.shape[0]):
                seqs.append((d["texts"][i // d["n"]], rows[i].tolist()))
        if not seqs:
            return []
        eos = qref_eos()
        lengths = [len(qref.served_positions(s, eos)) for _, s in seqs]
        pick = set(sample_rows(len(seqs), n_seq - 1, self.seed + 5)) | {int(np.argmax(lengths))}
        return [seqs[i] for i in sorted(pick)]

    def check(self, limits: Dict[str, float], n_rows: int) -> Dict[str, float]:
        c, dev = self.c, self.device
        n_total = sum(len(t) for t in self.sent)
        rows = sample_rows(n_total, n_rows, self.seed)
        out, chosen, texts, variants, pixels = self.detection_rows(rows)
        from perfbench.reference.tokenizers import ClipBPE, QwenBPE

        readings = {}
        if limits.get("decode_gap") is not None:
            seqs = self.served(int(self.wl["check"]["sequences"]))
            readings["decode_gap"] = decode_gap(self.q, self.seed, dev, seqs, QwenBPE(), bits=8, top_k=self.cfg["top_k"])
        p = weights.clip_params(c, self.seed, dev)
        bank = weights.bank(c["bank_rows"], c["embed_dim"], self.seed, dev)
        det = ref.judge_rows(ref.ClipInt8(c, p, bits=8), ClipBPE(c["context_length"]), bank,
                             torch.as_tensor(pixels), texts, variants, self.V, out, chosen, self.R, None,
                             self.threshold, limits["score_gap"])
        readings.update(det)
        return readings

    # -- the control ----------------------------------------------------------------------
    def control(self, limits: Dict[str, float], n_rows: int, batches: int) -> Dict[str, float]:
        """A short window of the program, then, on the same sampled rows and
        served tokens, the readings of the program and of the int4
        reference put in its place."""
        from perfbench.drivers import SubWindow
        from perfbench.reference.tokenizers import ClipBPE, QwenBPE

        self.setup()
        self.window(1e9, SubWindow(False, 0, 0, None, self.spans), max_batches=batches)
        self.free()
        program = self.check(limits, n_rows)
        c, dev = self.c, self.device
        n_total = sum(len(t) for t in self.sent)
        rows = sample_rows(n_total, n_rows, self.seed)
        _, _, texts, variants, pixels = self.detection_rows(rows)
        p = weights.clip_params(c, self.seed, dev)
        bank = weights.bank(c["bank_rows"], c["embed_dim"], self.seed, dev)
        bpe = ClipBPE(c["context_length"])
        px = torch.as_tensor(pixels)
        out4, chosen4 = ref.answer_rows(ref.ClipInt8(c, p, bits=4), bpe, bank, px, texts, variants, self.V,
                                        self.R, self.pc["retrieval_top_k"], None, self.threshold)
        ctl = ref.judge_rows(ref.ClipInt8(c, p, bits=8), bpe, bank, px, texts, variants, self.V, out4, chosen4,
                             self.R, None, self.threshold, limits["score_gap"])
        if "decode_gap" in limits:
            seqs = self.served(int(self.wl["check"]["sequences"]))
            ctl["decode_gap"] = decode_gap(self.q, self.seed, dev, seqs, QwenBPE(), bits=4,
                                           temperature=self.cfg["temperature"], top_k=self.cfg["top_k"])
        return {"program": program, "control": ctl}

    # -- what the per-layer metrics read --------------------------------------------------
    def work(self, steps: int) -> Dict:
        from perfbench import work

        q, sh = self.q, self.spans.shapes
        H, nh = q["hidden_size"], q["num_attention_heads"]
        Dh = H // nh
        gemms = [work.w8_gemm(*s) for s in sh["w8_gemm"]]
        ops = [g for g, _ in gemms]
        ops += [work.gemm(*s, "bf16") for s in sh["w8_dequant_gemm"]]
        ops += [work.gqa_decode(rows, S, nh, Dh) for rows, S in sh["decode_attention"]]
        ops += [work.gqa_prefill(B, T, S, nh, Dh) for B, T, S in sh["prefill_attention"]]
        for B, n, steps_ in sh["decode_calls"]:
            ops.append(work.head(B + steps_ * B * n, H, q["vocab_size"]))
        for B, T, W, heads, causal in sh["i8_attention_layer"]:
            ops.append(work.i8_attention_layer(B, T, W, heads, causal)[0])
        for B, T, W, hidden in sh["i8_mlp_layer"]:
            ops.append(work.i8_mlp_layer(B, T, W, hidden)[0])
        n_det = len(self.spans.host_s.get("detection", []))
        ops += [work.clip_embed_and_bank(self.B, self.c, self.c["bank_rows"], self.B * (self.V + 1))] * n_det
        host = sh["paraphrase_host_s"]
        return {
            "ops": work.add(*ops),
            "w8_bound_s": sum(work.bound_s(g, b) for g, b in gemms),
            "w8_calls": len(gemms),
            "paraphrase_ms": 1e3 * sum(host) / len(host) if host else None,
            "detection_ms": self.detection_ms,
        }


def _spanned(fn, spans, name):
    def wrapper(*a, **k):
        with spans.span(name):
            return fn(*a, **k)
    return wrapper


@functools.lru_cache(maxsize=1)
def qref_eos() -> int:
    from perfbench.reference.tokenizers import QwenBPE

    return QwenBPE().eos


def decode_gap(q: Dict, seed: int, device, seqs, bpe, bits: int, temperature: float = 0.8, top_k: int = 50) -> float:
    """The widest gap by which a served token's logit lies below the
    reference's ``top_k``-th best at its position (0 inside the set the
    program samples from). At ``bits`` below 8 the tokens are instead the
    ones the lower precision samples at each position of the same
    sequences: the control."""
    p = weights.qwen_params(q, seed, device)
    model8 = qref.Qwen2(q, p, bits=8)
    low = qref.Qwen2(q, p, bits=bits) if bits != 8 else None
    gen = torch.Generator(device=device).manual_seed(int(seed) + 7)
    worst = 0.0
    for text, served in seqs:
        prompt = bpe.encode(qref.PARAPHRASE_PROMPT.format(text=text))
        toks = qref.served_positions(served, bpe.eos)
        ids = prompt + toks[:-1]
        lg = model8.logits(ids)[len(prompt) - 1 :]
        if low is not None:
            toks = qref.sample_topk(low.logits(ids)[len(prompt) - 1 :], top_k, temperature, gen)
        worst = max(worst, float(qref.topk_gaps(lg, toks, top_k).max().item()))
    return worst
