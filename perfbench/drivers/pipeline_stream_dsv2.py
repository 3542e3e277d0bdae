"""Full TVC with DeepSeek-V2 as the paraphraser:
``MultiModalDetectionPipeline.process_stream`` over a stream of caption
batches, the variants made by ``DeepseekV2Model``'s w8 decode (latent
cache, routed experts through the grouped GEMM) through the augmenter's
batched path and scored by the int8 detector. The stream, the spies on
the paraphrase layer and the detection check are ``pipeline_stream``'s;
the model, its weights (one part at a time from ``(seed, part)``), its
ranges, its reference (``reference/deepseek_v2.py``, one layer at a time)
and its work model (``work_moe.py``) are this file's.

Besides ``pipeline_stream``'s, the traced run opens the ranges
``expert_gemm`` (each grouped GEMM), ``mla_decode_attention`` (each latent
attention), ``moe_block`` (routing, both grouped GEMMs, the combine and the
shared experts) and reads the program's ``moe.*`` counters where the
profiled sub-window starts and stops."""

from __future__ import annotations

import gc
from typing import Dict, List

import numpy as np
import torch

from perfbench import weights, weights_dsv2, work, work_moe
from perfbench.drivers import sample_rows
from perfbench.drivers import pipeline_stream as base
from perfbench.drivers.detect_closed import build_clip, host_images
from perfbench.reference import clip_int8 as ref
from perfbench.reference import deepseek_v2 as dref
from perfbench.reference import qwen2 as qref
from perfbench.traffic import Traffic

COUNTERS = ("moe.assignments", "moe.rows_max", "moe.layer_steps")


def model_config(cfg: Dict):
    from tvc_torch.models.deepseek_v2 import DeepseekV2Config

    rs = cfg["rope_scaling"]
    return DeepseekV2Config(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"], intermediate_size=cfg["intermediate_size"],
        moe_intermediate_size=cfg["moe_intermediate_size"], num_layers=cfg["num_hidden_layers"],
        first_k_dense=cfg["first_k_dense_replace"], num_heads=cfg["num_attention_heads"],
        kv_lora_rank=cfg["kv_lora_rank"], qk_nope_head_dim=cfg["qk_nope_head_dim"],
        qk_rope_head_dim=cfg["qk_rope_head_dim"], v_head_dim=cfg["v_head_dim"],
        n_routed_experts=cfg["n_routed_experts"], n_shared_experts=cfg["n_shared_experts"],
        num_experts_per_tok=cfg["num_experts_per_tok"], routed_scaling_factor=cfg["routed_scaling_factor"],
        rope_theta=cfg["rope_theta"], rope_factor=rs["factor"],
        rope_original_max_positions=rs["original_max_position_embeddings"], rope_beta_fast=rs["beta_fast"],
        rope_beta_slow=rs["beta_slow"], rope_mscale=rs["mscale"], rope_mscale_all_dim=rs["mscale_all_dim"],
        rms_eps=cfg["rms_norm_eps"], max_seq_len=cfg["max_seq_len"], dtype=torch.bfloat16, model_name=cfg["name"],
    )


class _CountedWindow:
    """The sub-window, with the program's counters read where its profile
    starts and where it stops."""

    def __init__(self, sub, spans):
        self.sub, self.spans = sub, spans
        self.at_start = self.at_stop = None

    def _read(self) -> Dict[str, int]:
        from tvc_torch.utils import tracing

        return tracing.counters()

    def step(self, i: int) -> None:
        was = self.spans.recording
        self.sub.step(i)
        if not was and self.spans.recording:
            self.at_start = self._read()
        elif was and not self.spans.recording and self.at_stop is None:
            self.at_stop = self._read()

    def stop(self) -> None:
        if self.spans.recording and self.at_stop is None:
            self.at_stop = self._read()
        self.sub.stop()


class Driver(base.Driver):
    def __init__(self, cfg: Dict, wl: Dict, mix: Dict, seed: int, device, spans):
        self.cfg, self.wl, self.mix, self.seed, self.device, self.spans = cfg, wl, mix, seed, device, spans
        self.c, self.q, self.pc = cfg["clip"], cfg, cfg["pipeline"]
        self.B = int(mix["batch"])
        self.V = self.pc["num_text_variants"]
        self.R = self.pc["num_reference_images"]
        self.threshold = self.pc["detection_threshold"]
        self.decodes: List = []
        self.counted = None

    # -- the program ------------------------------------------------------------------
    def setup(self) -> None:
        from tvc_torch.models.deepseek_v2 import DeepseekV2Model  # a checkout without it stops here

        from tvc_torch.augment import TextAugmentConfig, TextAugmenter
        from tvc_torch.pipeline import MultiModalDetectionPipeline, PipelineConfig

        dev, cfg = self.device, self.cfg
        self.model, self.retriever = build_clip(self.c, self.seed, dev)
        self.qwen = DeepseekV2Model(model_config(cfg), params=lambda p: weights_dsv2.part(cfg, self.seed, p, dev),
                                    max_new_tokens=cfg["max_new_tokens"], device=dev)
        gc.collect()
        torch.cuda.empty_cache() if dev.type == "cuda" else None
        self.adapter = self.qwen.as_paraphrase_generator()
        self.adapter.temperature = cfg["temperature"]
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

    def instrument(self) -> None:
        import tvc_torch.models.clip as clip_mod
        import tvc_torch.models.deepseek_v2 as ds_mod

        from perfbench.spans import i8_layer_shapes

        i8_layer_shapes(self.spans, clip_mod)
        sp = self.spans
        sp.wrap(ds_mod, "w8_matmul", "w8_gemm", lambda x, w, s: (int(x.shape[0]), *map(int, w.shape)))
        sp.wrap(ds_mod, "w8_matmul_reference", "w8_dequant_gemm",
                lambda x, w, s: (int(np.prod(x.shape[:-1])), int(w.shape[0]), int(w.shape[1])))
        # the offsets stay on the device; work() reads them once the window is over
        sp.wrap(ds_mod, "moe_w8_grouped_gemm", "expert_gemm",
                lambda x, w, s, off: (int(x.shape[0]), int(w.shape[1]), int(w.shape[2]), off))
        sp.wrap(ds_mod, "mla_decode_attention", "mla_decode_attention",
                lambda q_lat, q_pe, cache, mask, layer, scale: (int(q_lat.shape[0]), int(cache.shape[2])))
        sp.wrap(ds_mod.DeepseekV2Model, "_moe", "moe_block", lambda m, L, x, *a: int(x.shape[0] * x.shape[1]))
        self.pipe.detector.detect_batch = base._spanned(self.pipe.detector.detect_batch, sp, "detection")

    def window(self, seconds: float, sub, max_batches: int = None) -> Dict:
        self.counted = _CountedWindow(sub, self.spans)
        return super().window(seconds, self.counted, max_batches)

    # -- the check ---------------------------------------------------------------------
    def served(self, n_seq: int):
        """A sample, drawn from the seed, of the served sequences, with the
        longest in it: ``(caption, served tokens)``."""
        seqs = []
        for d in self.decodes:
            if "rows" not in d:
                continue
            rows = np.asarray(d["rows"])
            for i in range(rows.shape[0]):
                seqs.append((d["texts"][i // d["n"]], rows[i].tolist()))
        if n_seq <= 0 or not seqs:
            return []
        lengths = [len(qref.served_positions(s, dref.EOS)) for _, s in seqs]
        pick = set(sample_rows(len(seqs), n_seq - 1, self.seed + 5)) | {int(np.argmax(lengths))}
        return [seqs[i] for i in sorted(pick)]

    def _detection(self, limits: Dict[str, float], n_rows: int, bits: int) -> Dict[str, float]:
        """The detection rows' check (``bits`` 4: the int4 reference's
        answers judged in the program's place)."""
        from perfbench.reference.tokenizers import ClipBPE

        c, dev = self.c, self.device
        rows = sample_rows(sum(len(t) for t in self.sent), n_rows, self.seed)
        out, chosen, texts, variants, pixels = self.detection_rows(rows)
        p = weights.clip_params(c, self.seed, dev)
        bank = weights.bank(c["bank_rows"], c["embed_dim"], self.seed, dev)
        bpe, px = ClipBPE(c["context_length"]), torch.as_tensor(pixels)
        if bits != 8:
            out, chosen = ref.answer_rows(ref.ClipInt8(c, p, bits=bits), bpe, bank, px, texts, variants, self.V,
                                          self.R, self.pc["retrieval_top_k"], None, self.threshold)
        return ref.judge_rows(ref.ClipInt8(c, p, bits=8), bpe, bank, px, texts, variants, self.V, out, chosen,
                              self.R, None, self.threshold, limits["score_gap"])

    def check(self, limits: Dict[str, float], n_rows: int) -> Dict[str, float]:
        readings = {}
        if limits.get("decode_gap") is not None:
            seqs = self.served(int(self.wl["check"]["sequences"]))
            readings["decode_gap"] = decode_gap(self.cfg, self.seed, self.device, seqs, bits=8,
                                                top_k=self.cfg["top_k"])
        readings.update(self._detection(limits, n_rows, 8))
        return readings

    def control(self, limits: Dict[str, float], n_rows: int, batches: int) -> Dict[str, float]:
        """A short window of the program, then, on the same sampled rows and
        served tokens, the readings of the program and of the int4
        reference put in its place."""
        from perfbench.drivers import SubWindow

        self.setup()
        self.window(1e9, SubWindow(False, 0, 0, None, self.spans), max_batches=batches)
        self.free()
        program = self.check(limits, n_rows)
        ctl = self._detection(limits, n_rows, 4)
        if "decode_gap" in limits:
            seqs = self.served(int(self.wl["check"]["sequences"]))
            ctl["decode_gap"] = decode_gap(self.cfg, self.seed, self.device, seqs, bits=4,
                                           temperature=self.cfg["temperature"], top_k=self.cfg["top_k"])
        return {"program": program, "control": ctl}

    # -- what the per-layer metrics read --------------------------------------------------
    def work(self, steps: int) -> Dict:
        cfg, sh = self.cfg, self.spans.shapes
        H, E, nh = cfg["hidden_size"], cfg["n_routed_experts"], cfg["num_attention_heads"]
        gemms = [work.w8_gemm(*s) for s in sh["w8_gemm"]]
        ops = [g for g, _ in gemms]
        ops += [work.gemm(*s, "bf16") for s in sh["w8_dequant_gemm"]]
        experts = []
        if sh["expert_gemm"]:
            offs = torch.stack([s[3] for s in sh["expert_gemm"]]).cpu()
            busy = (offs[:, 1:] > offs[:, :-1]).sum(dim=1).tolist()
            experts = [work_moe.expert_gemm(M, K, N, b) for (M, K, N, _), b in zip(sh["expert_gemm"], busy)]
        ops += [g for g, _ in experts]
        mla = [work_moe.mla_decode(rows, S, nh, cfg["kv_lora_rank"], cfg["qk_rope_head_dim"])
               for rows, S in sh["mla_decode_attention"]]
        ops += [o for o, _ in mla]
        ops += [work_moe.absorbed(rows, nh, cfg["qk_nope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"])
                for rows, _ in sh["mla_decode_attention"]]
        ops += [work_moe.router(n, H, E) for n in sh["moe_block"]]
        for B, T, W, heads, causal in sh["i8_attention_layer"]:
            ops.append(work.i8_attention_layer(B, T, W, heads, causal)[0])
        for B, T, W, hidden in sh["i8_mlp_layer"]:
            ops.append(work.i8_mlp_layer(B, T, W, hidden)[0])
        n_det = len(self.spans.host_s.get("detection", []))
        ops += [work.clip_embed_and_bank(self.B, self.c, self.c["bank_rows"], self.B * (self.V + 1))] * n_det
        load = None
        cw = self.counted
        if cw is not None and cw.at_start is not None and cw.at_stop is not None:
            d = {k: cw.at_stop.get(k, 0) - cw.at_start.get(k, 0) for k in COUNTERS}
            if d["moe.layer_steps"] > 0 and d["moe.assignments"] > 0:
                load = (d["moe.rows_max"] / d["moe.layer_steps"]) / (d["moe.assignments"] / (d["moe.layer_steps"] * E))
        return {
            "ops": work.add(*ops),
            "expert_bound_s": sum(work.bound_s(g, b) for g, b in experts),
            "expert_calls": len(experts),
            "mla_bound_s": sum(b / work.PEAK_BYTES_PER_S for _, b in mla),
            "mla_calls": len(mla),
            "expert_load": load,
            # what the full-TVC readers of the Qwen2 cells read (w8_gemm_roofline, detection_ms.tvc)
            "w8_bound_s": sum(work.bound_s(g, b) for g, b in gemms),
            "w8_calls": len(gemms),
            "detection_ms": self.detection_ms,
        }


def decode_gap(cfg: Dict, seed: int, device, seqs, bits: int, temperature: float = 0.8, top_k: int = 50) -> float:
    """The widest gap by which a served token's logit lies below the
    reference's ``top_k``-th best at its position (0 inside the set the
    program samples from). At ``bits`` below 8 the tokens are instead the
    ones the lower precision samples at each position of the same
    sequences: the control. The reference runs every sequence through one
    layer before the next."""
    if not seqs:
        return 0.0
    bpe = dref.CutQwenBPE()
    prompts, toks, ids = [], [], []
    for text, served in seqs:
        prompt = bpe.prompt(qref.PARAPHRASE_PROMPT.format(text=text))
        t = qref.served_positions(served, dref.EOS)
        prompts.append(prompt)
        toks.append(t)
        ids.append(prompt + t[:-1])

    def part(name):
        return weights_dsv2.part(cfg, seed, name, device)

    lg8 = dref.DeepseekV2(cfg, part, bits=8, device=device).logits(ids)
    if bits != 8:
        gen = torch.Generator(device=device).manual_seed(int(seed) + 7)
        low = dref.DeepseekV2(cfg, part, bits=bits, device=device).logits(ids)
        toks = [qref.sample_topk(lo[len(p) - 1 :], top_k, temperature, gen) for lo, p in zip(low, prompts)]
    worst = 0.0
    for lg, p, t in zip(lg8, prompts, toks):
        worst = max(worst, float(qref.topk_gaps(lg[len(p) - 1 :], t, top_k).max().item()))
    return worst
