"""Full TVC with Nemotron-H as the paraphraser:
``MultiModalDetectionPipeline.process_stream`` over a stream of caption
batches, the variants made by ``NemotronHModel``'s w8 decode (Mamba-2
state beside the attention blocks' KV cache, 128 non-gated routed experts
through the grouped GEMM) through the augmenter's batched path and scored
by the int8 detector. The stream, the spies on the paraphrase layer, the
detection check, the counted sub-window and the logged routes are
``pipeline_stream_kimi``'s (and through it ``pipeline_stream_dsv2``'s and
``pipeline_stream``'s); the model, its weights (one part at a time from
``(seed, part)``, ``weights_nemotron``), its ranges, its reference
(``reference/nemotron_h.py``, one block at a time) and its work model
(``work_moe.py``, ``work_ssm.py``) are this file's.

The traced run opens the ranges ``w8_gemm`` / ``w8_dequant_gemm``,
``expert_gemm`` (each grouped GEMM), ``relu2`` (each experts' squared
ReLU), ``gqa_decode_attention``, ``moe_block`` (routing, both grouped GEMMs,
the combine and the shared expert), ``ssm_block`` (one Mamba-2 block from
its W_in GEMM through W_out), ``ssm_prepare``, ``ssm_recurrent`` and
``ssm_gated_norm``, and reads the program's ``moe.*`` counters where the
profiled sub-window starts and stops. The SSM kernels' work counts each
prefill call's real tokens from the program's ``ssm.token_updates``, read
around each recorded decode's readback.

The check routes the reference through the experts the program chose in
the timed decodes (``pipeline_stream_kimi``'s logged routes, keyed by MoE
block)."""

from __future__ import annotations

import gc
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from perfbench import weights_nemotron, work, work_kda, work_moe, work_ssm
from perfbench.drivers import pipeline_stream as base
from perfbench.drivers import pipeline_stream_dsv2 as dsv2
from perfbench.drivers import pipeline_stream_kimi as kimi
from perfbench.drivers import sample_rows
from perfbench.drivers.detect_closed import build_clip, host_images
from perfbench.reference import nemotron_h as nref
from perfbench.reference import qwen2 as qref
from perfbench.traffic import Traffic


def model_config(cfg: Dict):
    from tvc_torch.models.nemotron_h import published_config

    return published_config(cfg, max_seq_len=cfg["max_seq_len"], dtype=torch.bfloat16, model_name=cfg["name"])


class Driver(kimi.Driver):
    # -- the program ------------------------------------------------------------------
    def setup(self) -> None:
        from tvc_torch.models.nemotron_h import NemotronHModel  # a checkout without it stops here

        from tvc_torch.augment import TextAugmentConfig, TextAugmenter
        from tvc_torch.pipeline import MultiModalDetectionPipeline, PipelineConfig

        dev, cfg = self.device, self.cfg
        self.model, self.retriever = build_clip(self.c, self.seed, dev)
        self.qwen = NemotronHModel(model_config(cfg),
                                   params=lambda p: weights_nemotron.part(cfg, self.seed, p, dev),
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

    def _spy(self) -> None:
        """``pipeline_stream``'s spies, and for each decode the ids of its
        ``moe_route`` calls, its prompt layout and the change of
        ``ssm.token_updates`` over its readback (kept for the recorded
        decodes, with their prefix length)."""
        from tvc_torch.utils import tracing

        base.Driver._spy(self)
        decode, batch_async = self.qwen.decode, self.adapter.batch_async
        drv = self

        def spy_decode(inp, *a, **k):
            d = drv.decodes[-1]
            d["calls"] = []
            with kimi.logged_routes(d["calls"]):
                rows = decode(inp, *a, **k)
            d["layout"] = (int(inp.P), *map(int, inp.tokens.shape), inp.lengths)
            return rows

        def spy_batch_async(texts, n):
            rec = drv.spans.recording
            handle = batch_async(texts, n)
            d = drv.decodes[-1]

            def finalize():
                before = tracing.counters().get("ssm.token_updates", 0)
                out = handle()
                if rec:
                    drv.spans.shapes["ssm_prefills"].append(
                        (d["layout"][0], tracing.counters().get("ssm.token_updates", 0) - before))
                return out

            return finalize

        self.qwen.decode = spy_decode
        self.adapter.batch_async = spy_batch_async

    def instrument(self) -> None:
        import tvc_torch.models.clip as clip_mod
        import tvc_torch.models.deepseek_v2 as ds_mod
        import tvc_torch.models.nemotron_h as nem_mod

        from perfbench.spans import i8_layer_shapes

        i8_layer_shapes(self.spans, clip_mod)
        sp = self.spans
        # the experts and every w8 GEMM run DeepSeek-V2's paths, which call these names
        sp.wrap(ds_mod, "w8_matmul", "w8_gemm", lambda x, w, s: (int(x.shape[0]), *map(int, w.shape)))
        sp.wrap(ds_mod, "w8_matmul_reference", "w8_dequant_gemm",
                lambda x, w, s: (int(np.prod(x.shape[:-1])), int(w.shape[0]), int(w.shape[1])))
        sp.wrap(ds_mod, "moe_w8_grouped_gemm", "expert_gemm",
                lambda x, w, s, off: (int(x.shape[0]), int(w.shape[1]), int(w.shape[2]), off))
        sp.wrap(ds_mod, "relu2", "relu2", lambda u: (int(u.numel()), int(u.element_size())))
        # q [rows, KV, R, D], over the mask's S slots
        sp.wrap(nem_mod, "decode_gqa_attention_stacked", "gqa_decode_attention",
                lambda q, ck, cv, mask, l: (int(q.shape[0]), int(mask.shape[-1]), *map(int, q.shape[1:])))
        sp.wrap(nem_mod.NemotronHModel, "_moe", "moe_block", lambda m, L, x, *a: int(x.shape[0] * x.shape[1]))
        sp.wrap(nem_mod.NemotronHModel, "_ssm", "ssm_block", lambda m, L, j, x, *a: int(x.shape[0] * x.shape[1]))
        # whether the call was given lengths (a prompt's suffix): work() counts its tokens from ssm.token_updates
        sp.wrap(nem_mod, "ssm_prepare", "ssm_prepare",
                lambda y, cw, cb, dtb, cs, lengths, xc, dc: (*map(int, y.shape[:2]), int(cw.shape[0]),
                                                             int(dtb.shape[0]), int(cw.shape[1]),
                                                             lengths is not None))
        sp.wrap(nem_mod, "ssm_recurrent", "ssm_recurrent",
                lambda xbc, dt, al, d, state, lengths, groups, dtype: (*map(int, xbc.shape[:2]),
                                                                       *map(int, state.shape[1:]), int(groups),
                                                                       lengths is not None))
        sp.wrap(nem_mod, "ssm_gated_norm", "ssm_gated_norm", lambda y, z, w, groups, eps: tuple(map(int, y.shape)))
        self.pipe.detector.detect_batch = base._spanned(self.pipe.detector.detect_batch, sp, "detection")

    # -- the check ---------------------------------------------------------------------
    def _picked(self, n_seq: int) -> List[Tuple[int, int]]:
        """A sample, drawn from the seed, of the served sequences, with the
        longest in it: ``(decode call, row)``."""
        where, lengths = [], []
        for k, d in enumerate(self.decodes):
            if "rows" not in d:
                continue
            rows = d["rows"].cpu().numpy() if torch.is_tensor(d["rows"]) else np.asarray(d["rows"])
            for i in range(rows.shape[0]):
                where.append((k, i))
                lengths.append(len(qref.served_positions(rows[i].tolist(), nref.EOS)))
        if n_seq <= 0 or not where:
            return []
        pick = set(sample_rows(len(where), n_seq - 1, self.seed + 5)) | {int(np.argmax(lengths))}
        return [where[i] for i in sorted(pick)]

    def check(self, limits: Dict[str, float], n_rows: int) -> Dict[str, float]:
        readings = {}
        if limits.get("decode_gap") is not None:
            seqs = self.served(int(self.wl["check"]["sequences"]))
            readings["decode_gap"], readings["route_gap"] = decode_gap(
                self.cfg, self.seed, self.device, seqs, bits=8, top_k=self.cfg["top_k"], routes=self.routes)
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
            ctl["decode_gap"], ctl["route_gap"] = decode_gap(
                self.cfg, self.seed, self.device, seqs, bits=4, temperature=self.cfg["temperature"],
                top_k=self.cfg["top_k"])
        return {"program": program, "control": ctl}

    # -- what the per-layer metrics read --------------------------------------------------
    def work(self, steps: int) -> Dict:
        cfg, sh = self.cfg, self.spans.shapes
        H, E = cfg["hidden_size"], cfg["n_routed_experts"]
        gemms = [work.w8_gemm(*s) for s in sh["w8_gemm"]]
        ops = [g for g, _ in gemms]
        ops += [work.gemm(*s, "bf16") for s in sh["w8_dequant_gemm"]]
        experts = []
        if sh["expert_gemm"]:
            offs = torch.stack([s[3] for s in sh["expert_gemm"]]).cpu()
            busy = (offs[:, 1:] > offs[:, :-1]).sum(dim=1).tolist()
            experts = [work_moe.expert_gemm(M, K, N, b) for (M, K, N, _), b in zip(sh["expert_gemm"], busy)]
        ops += [g for g, _ in experts]
        attention = [work_ssm.gqa_decode(*s) for s in sh["gqa_decode_attention"]]
        ops += [o for o, _ in attention]
        ops += [work_moe.router(n, H, E) for n in sh["moe_block"]]
        suffix = work_kda.suffix_tokens(sh["ssm_prefills"])
        tokens = lambda calls: work_kda.call_tokens(  # noqa: E731
            [(s[0], s[1], s[-1]) for s in calls], suffix, cfg["hybrid_override_pattern"].count("M"))
        prep = [work_ssm.prepare(B, T, C, heads, K, n)
                for (B, T, C, heads, K, _), n in zip(sh["ssm_prepare"], tokens(sh["ssm_prepare"]))]
        rec = [work_ssm.recurrent(B, T, heads, P, N, groups, n)
               for (B, T, heads, P, N, groups, _), n in zip(sh["ssm_recurrent"], tokens(sh["ssm_recurrent"]))]
        norm = [work_ssm.gated_norm(B, T, W) for B, T, W in sh["ssm_gated_norm"]]
        relu = [work_ssm.relu2(n, size) for n, size in sh["relu2"]]
        ops += [o for o, _ in prep + rec + norm + relu]
        for B, T, W, heads, causal in sh["i8_attention_layer"]:
            ops.append(work.i8_attention_layer(B, T, W, heads, causal)[0])
        for B, T, W, hidden in sh["i8_mlp_layer"]:
            ops.append(work.i8_mlp_layer(B, T, W, hidden)[0])
        n_det = len(self.spans.host_s.get("detection", []))
        ops += [work.clip_embed_and_bank(self.B, self.c, self.c["bank_rows"], self.B * (self.V + 1))] * n_det
        load = None
        cw = self.counted
        if cw is not None and cw.at_start is not None and cw.at_stop is not None:
            d = {k: cw.at_stop.get(k, 0) - cw.at_start.get(k, 0) for k in dsv2.COUNTERS}
            if d["moe.layer_steps"] > 0 and d["moe.assignments"] > 0:
                load = (d["moe.rows_max"] / d["moe.layer_steps"]) / (d["moe.assignments"] / (d["moe.layer_steps"] * E))
        bound = lambda calls: sum(work.bound_s(o, b) for o, b in calls)  # noqa: E731
        host = sh["paraphrase_host_s"]
        return {
            "ops": work.add(*ops),
            "expert_bound_s": bound(experts),
            "expert_calls": len(experts),
            "ssm_prepare_bound_s": bound(prep),
            "ssm_prepare_calls": len(prep),
            "ssm_bound_s": bound(rec),
            "ssm_calls": len(rec),
            "ssm_gated_norm_bound_s": bound(norm),
            "ssm_gated_norm_calls": len(norm),
            "relu2_bound_s": bound(relu),
            "relu2_calls": len(relu),
            "expert_load": load,
            "gqa_bound_s": bound(attention),
            "gqa_calls": len(attention),
            "w8_bound_s": bound(gemms),
            "w8_calls": len(gemms),
            "paraphrase_ms": 1e3 * sum(host) / len(host) if host else None,
            "detection_ms": self.detection_ms,
        }


def decode_gap(cfg: Dict, seed: int, device, seqs, bits: int, temperature: float = 0.8, top_k: int = 50,
               routes: Optional[List[Dict[int, torch.Tensor]]] = None) -> Tuple[float, float]:
    """``(decode_gap, route_gap)`` as ``pipeline_stream_kimi.decode_gap``
    reads them, against the Nemotron-H reference: the widest gap by which a
    served token's logit lies below the reference's ``top_k``-th best at its
    position, the reference routed through the experts the program chose
    (``routes``, per sequence, per MoE block); and how far below the
    reference's k-th choice value the weakest of those experts lies. At
    ``bits`` below 8 the tokens and experts are the ones the lower
    precision samples and chooses on the same sequences: the control."""
    if not seqs:
        return 0.0, 0.0
    bpe = nref.NemotronQwenBPE()
    prompts, toks, ids = [], [], []
    for text, served in seqs:
        prompt = bpe.prompt(qref.PARAPHRASE_PROMPT.format(text=text))
        t = qref.served_positions(served, nref.EOS)
        prompts.append(prompt)
        toks.append(t)
        ids.append(prompt + t[:-1])

    def part(name):
        return weights_nemotron.part(cfg, seed, name, device)

    if bits != 8:
        gen = torch.Generator(device=device).manual_seed(int(seed) + 7)
        low_model = nref.NemotronH(cfg, part, bits=bits, device=device)
        low = low_model.logits(ids)
        toks = [qref.sample_topk(lo[len(p) - 1 :], top_k, temperature, gen) for lo, p in zip(low, prompts)]
        routes = [{li: r[j][0] for li, r in low_model.routes.items()} for j in range(len(ids))]
    ref8 = nref.NemotronH(cfg, part, bits=8, device=device)
    lg8 = ref8.logits(ids, routes)
    worst = 0.0
    for lg, p, t in zip(lg8, prompts, toks):
        worst = max(worst, float(qref.topk_gaps(lg[len(p) - 1 :], t, top_k).max().item()))
    return worst, ref8.route_gap
