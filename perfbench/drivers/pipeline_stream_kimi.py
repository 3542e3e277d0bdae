"""Full TVC with Kimi-Linear as the paraphraser:
``MultiModalDetectionPipeline.process_stream`` over a stream of caption
batches, the variants made by ``KimiLinearModel``'s w8 decode (KDA state
beside the latent cache, 256 routed experts through the grouped GEMM)
through the augmenter's batched path and scored by the int8 detector. The
stream, the spies on the paraphrase layer, the detection check and the
counted sub-window are ``pipeline_stream_dsv2``'s (and through it
``pipeline_stream``'s); the model, its weights (one part at a time from
``(seed, part)``, ``weights_kimi``), its ranges, its reference
(``reference/kimi_linear.py``, one layer at a time) and its work model
(``work_moe.py``, ``work_kda.py``) are this file's.

The traced run opens the ranges ``w8_gemm`` / ``w8_dequant_gemm``,
``expert_gemm`` (each grouped GEMM), ``mla_decode_attention``, ``moe_block``
(routing, both grouped GEMMs, the combine and the shared expert),
``kda_block`` (one KDA layer from its merged GEMM through ``o W_o``),
``kda_prepare``, ``kda_recurrent`` and ``kda_gated_norm``, and reads the
program's ``moe.*`` counters where the profiled sub-window starts and
stops. The KDA kernels' work counts each prefill call's real tokens from
the program's ``kda.token_updates``, read around each recorded decode's
readback.

The check routes the reference through the experts the program chose in
the timed decodes: the spy on the decode keeps the ids of every
``moe_route`` call (a copy each, on the device), and the sampled rows'
are taken from them once the window is over."""

from __future__ import annotations

import gc
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from perfbench import weights_kimi, work, work_kda, work_moe
from perfbench.drivers import sample_rows
from perfbench.drivers import pipeline_stream as base
from perfbench.drivers import pipeline_stream_dsv2 as dsv2
from perfbench.drivers.detect_closed import build_clip, host_images
from perfbench.reference import kimi_linear as kref
from perfbench.reference import qwen2 as qref
from perfbench.traffic import Traffic

def model_config(cfg: Dict):
    from tvc_torch.models.kimi_linear import published_config

    return published_config(cfg, max_seq_len=cfg["max_seq_len"], dtype=torch.bfloat16, model_name=cfg["name"])


class Driver(dsv2.Driver):
    # -- the program ------------------------------------------------------------------
    def setup(self) -> None:
        from tvc_torch.models.kimi_linear import KimiLinearModel  # a checkout without it stops here

        from tvc_torch.augment import TextAugmentConfig, TextAugmenter
        from tvc_torch.pipeline import MultiModalDetectionPipeline, PipelineConfig

        dev, cfg = self.device, self.cfg
        self.model, self.retriever = build_clip(self.c, self.seed, dev)
        self.qwen = KimiLinearModel(model_config(cfg), params=lambda p: weights_kimi.part(cfg, self.seed, p, dev),
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
        ``kda.token_updates`` over its readback (kept for the recorded
        decodes, with their prefix length)."""
        from tvc_torch.utils import tracing

        super()._spy()
        decode, batch_async = self.qwen.decode, self.adapter.batch_async
        drv = self

        def spy_decode(inp, *a, **k):
            d = drv.decodes[-1]
            d["calls"] = []
            with logged_routes(d["calls"]):
                rows = decode(inp, *a, **k)
            d["layout"] = (int(inp.P), *map(int, inp.tokens.shape), inp.lengths)
            return rows

        def spy_batch_async(texts, n):
            rec = drv.spans.recording
            handle = batch_async(texts, n)
            d = drv.decodes[-1]

            def finalize():
                before = tracing.counters().get("kda.token_updates", 0)
                out = handle()
                if rec:
                    drv.spans.shapes["kda_prefills"].append(
                        (d["layout"][0], tracing.counters().get("kda.token_updates", 0) - before))
                return out

            return finalize

        self.qwen.decode = spy_decode
        self.adapter.batch_async = spy_batch_async

    def instrument(self) -> None:
        import tvc_torch.models.clip as clip_mod
        import tvc_torch.models.deepseek_v2 as ds_mod
        import tvc_torch.models.kimi_linear as kimi_mod

        from perfbench.spans import i8_layer_shapes

        i8_layer_shapes(self.spans, clip_mod)
        sp = self.spans
        # the latent layers, the experts and every w8 GEMM run DeepSeek-V2's paths, which call these names
        sp.wrap(ds_mod, "w8_matmul", "w8_gemm", lambda x, w, s: (int(x.shape[0]), *map(int, w.shape)))
        sp.wrap(ds_mod, "w8_matmul_reference", "w8_dequant_gemm",
                lambda x, w, s: (int(np.prod(x.shape[:-1])), int(w.shape[0]), int(w.shape[1])))
        sp.wrap(ds_mod, "moe_w8_grouped_gemm", "expert_gemm",
                lambda x, w, s, off: (int(x.shape[0]), int(w.shape[1]), int(w.shape[2]), off))
        sp.wrap(ds_mod, "mla_decode_attention", "mla_decode_attention",
                lambda q_lat, q_pe, cache, mask, layer, scale: (int(q_lat.shape[0]), int(cache.shape[2]),
                                                                 int(q_lat.shape[1])))
        sp.wrap(kimi_mod.KimiLinearModel, "_moe", "moe_block", lambda m, L, x, *a: int(x.shape[0] * x.shape[1]))
        sp.wrap(kimi_mod.KimiLinearModel, "_kda", "kda_block", lambda m, L, j, x, *a: int(x.shape[0] * x.shape[1]))
        # whether the call was given lengths (a prompt's suffix): work() counts its tokens from kda.token_updates
        sp.wrap(kimi_mod, "kda_prepare", "kda_prepare",
                lambda y, f, cw, al, dtb, cs, lengths, heads, b_col: (*map(int, y.shape[:2]), int(heads),
                                                                     int(cw.shape[0]), int(cw.shape[1]),
                                                                     lengths is not None))
        sp.wrap(kimi_mod, "kda_recurrent", "kda_recurrent",
                lambda qkvg, beta, state, lengths, dt: (*map(int, qkvg.shape[:3]), int(qkvg.shape[-1]),
                                                        lengths is not None))
        sp.wrap(kimi_mod, "kda_gated_norm", "kda_gated_norm",
                lambda o, gate, w, eps: tuple(int(n) for n in o.shape))
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
                lengths.append(len(qref.served_positions(rows[i].tolist(), kref.EOS)))
        if n_seq <= 0 or not where:
            return []
        pick = set(sample_rows(len(where), n_seq - 1, self.seed + 5)) | {int(np.argmax(lengths))}
        return [where[i] for i in sorted(pick)]

    def served(self, n_seq: int):
        """The sampled sequences: ``(caption, served tokens)``."""
        out = []
        for k, i in self._picked(n_seq):
            d = self.decodes[k]
            rows = d["rows"].cpu().numpy() if torch.is_tensor(d["rows"]) else np.asarray(d["rows"])
            out.append((d["texts"][i // d["n"]], rows[i].tolist()))
        return out

    def free(self) -> None:
        """Before the program goes: the experts it chose at every position
        of the sampled sequences, read off the ids its timed decodes
        logged; the rest of the logs dropped."""
        self.routes = []
        picked = self._picked(int(self.wl["check"]["sequences"]))
        for k in sorted({k for k, _ in picked}):
            d = self.decodes[k]
            P, B, T, lengths = d["layout"]
            self.routes += routes_of(d["calls"], self.qwen.config, P, B, T, lengths.tolist(), d["n"],
                                     [i for kk, i in picked if kk == k])
        for d in self.decodes:
            d.pop("calls", None)
        super().free()

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
        H, E = cfg["hidden_size"], cfg["num_experts"]
        gemms = [work.w8_gemm(*s) for s in sh["w8_gemm"]]
        ops = [g for g, _ in gemms]
        ops += [work.gemm(*s, "bf16") for s in sh["w8_dequant_gemm"]]
        experts = []
        if sh["expert_gemm"]:
            offs = torch.stack([s[3] for s in sh["expert_gemm"]]).cpu()
            busy = (offs[:, 1:] > offs[:, :-1]).sum(dim=1).tolist()
            experts = [work_moe.expert_gemm(M, K, N, b) for (M, K, N, _), b in zip(sh["expert_gemm"], busy)]
        ops += [g for g, _ in experts]
        mla = [work_moe.mla_decode(rows, S, heads, cfg["kv_lora_rank"], cfg["qk_rope_head_dim"])
               for rows, S, heads in sh["mla_decode_attention"]]
        ops += [o for o, _ in mla]
        ops += [work_moe.absorbed(rows, heads, cfg["qk_nope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"])
                for rows, _, heads in sh["mla_decode_attention"]]
        ops += [work_moe.router(n, H, E) for n in sh["moe_block"]]
        suffix = work_kda.suffix_tokens(sh["kda_prefills"])
        tokens = lambda calls: work_kda.call_tokens(  # noqa: E731
            [(s[0], s[1], s[-1]) for s in calls], suffix, len(cfg["linear_attn_config"]["kda_layers"]))
        prep = [work_kda.prepare(B, T, heads, C, K, n)
                for (B, T, heads, C, K, _), n in zip(sh["kda_prepare"], tokens(sh["kda_prepare"]))]
        rec = [work_kda.recurrent(B, T, heads, d, n)
               for (B, T, heads, d, _), n in zip(sh["kda_recurrent"], tokens(sh["kda_recurrent"]))]
        norm = [work_kda.gated_norm(B, T, heads, d) for B, T, heads, d in sh["kda_gated_norm"]]
        ops += [o for o, _ in prep + rec + norm]
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
        return {
            "ops": work.add(*ops),
            "expert_bound_s": sum(work.bound_s(g, b) for g, b in experts),
            "expert_calls": len(experts),
            "kda_prepare_bound_s": sum(work.bound_s(o, b) for o, b in prep),
            "kda_prepare_calls": len(prep),
            "kda_bound_s": sum(work.bound_s(o, b) for o, b in rec),
            "kda_calls": len(rec),
            "kda_gated_norm_bound_s": sum(work.bound_s(o, b) for o, b in norm),
            "kda_gated_norm_calls": len(norm),
            "mla_bound_s": sum(b / work.PEAK_BYTES_PER_S for _, b in mla),
            "mla_calls": len(mla),
            "expert_load": load,
            "w8_bound_s": sum(work.bound_s(g, b) for g, b in gemms),
            "w8_calls": len(gemms),
            "detection_ms": self.detection_ms,
        }


@contextmanager
def logged_routes(calls: List[torch.Tensor]):
    """Inside: the expert ids ``[N, k]`` of every ``moe_route`` call the
    model layers make, a copy each, appended to ``calls`` in order."""
    import tvc_torch.models.deepseek_v2 as ds_mod

    route = ds_mod.moe_route

    def spy(*a, **k):
        out = route(*a, **k)
        calls.append(out[1].clone())
        return out

    ds_mod.moe_route = spy
    try:
        yield calls
    finally:
        ds_mod.moe_route = route


def routes_of(calls: List[torch.Tensor], c, P: int, B: int, T: int, lengths: List[int], n: int,
              rows: List[int]) -> List[Dict[int, torch.Tensor]]:
    """The experts of decode rows ``rows`` from one decode call's logged
    ``moe_route`` ids (``P`` prefix tokens, ``B`` prompts padded to ``T``
    suffix slots, real ``lengths`` counting the prefix, ``n`` samples a
    prompt): per row, per layer, ``[positions, k]`` (the prompt, then each
    step's input token). The calls come a layer at a time: the prefix's
    block, the suffixes', then one block a decode step."""
    L = c.n_moe_layers
    blocks = [calls[i : i + L] for i in range(0, len(calls), L)]
    prefix = blocks.pop(0) if P else None
    suffix, steps = blocks[0], blocks[1:]
    out = []
    for r in rows:
        p = r // n
        per = {}
        for li in range(L):
            parts = ([prefix[li][:P]] if P else []) + [suffix[li].view(B, T, -1)[p, : lengths[p] - P]]
            per[c.first_k_dense + li] = torch.cat(parts + [s[li][r : r + 1] for s in steps]).cpu()
        out.append(per)
    return out


def decode_routes(model, texts: List[str], n: int, served, rows: List[int]) -> List[Dict[int, torch.Tensor]]:
    """The experts ``model`` chooses for decode rows ``rows`` of a
    paraphrase call over ``texts`` (``n`` samples each) that served
    ``served`` [rows, steps]: the call's decode run with those tokens
    forced, its routing logged (:func:`routes_of`)."""
    from tvc_torch.models.decoding import PARAPHRASE_PREFIX, PARAPHRASE_PROMPT

    inp = model.prepare([PARAPHRASE_PROMPT.format(text=t) for t in texts], n, None, PARAPHRASE_PREFIX)
    forced = torch.as_tensor(served.cpu().numpy() if torch.is_tensor(served) else np.asarray(served),
                             device=model.device).T
    calls = []
    with logged_routes(calls):
        type(model).decode(model, inp, forced=forced)  # the class's: not through a driver's spy on the instance
    B, T = inp.tokens.shape
    return routes_of(calls, model.config, inp.P, B, T, inp.lengths.tolist(), n, rows)


def decode_gap(cfg: Dict, seed: int, device, seqs, bits: int, temperature: float = 0.8, top_k: int = 50,
               routes: Optional[List[Dict[int, torch.Tensor]]] = None) -> Tuple[float, float]:
    """``(decode_gap, route_gap)``. ``decode_gap``: the widest gap by which a
    served token's logit lies below the reference's ``top_k``-th best at
    its position (0 inside the set the program samples from), the
    reference routing each token through the experts the program chose
    (``routes``, per sequence); ``route_gap``: how far below the
    reference's k-th choice value (sigmoid + bias) the weakest of those
    experts lies, at worst (0 where the two chose alike; the program's
    rounding moves a near-tie by its own size, while a wrong route lies
    far below). At ``bits`` below 8 the tokens and the experts are instead
    the ones the lower precision samples and chooses on the same
    sequences: the control. The reference runs every sequence through one
    layer before the next."""
    if not seqs:
        return 0.0, 0.0
    bpe = kref.KimiQwenBPE()
    prompts, toks, ids = [], [], []
    for text, served in seqs:
        prompt = bpe.prompt(qref.PARAPHRASE_PROMPT.format(text=text))
        t = qref.served_positions(served, kref.EOS)
        prompts.append(prompt)
        toks.append(t)
        ids.append(prompt + t[:-1])

    def part(name):
        return weights_kimi.part(cfg, seed, name, device)

    if bits != 8:
        gen = torch.Generator(device=device).manual_seed(int(seed) + 7)
        low_model = kref.KimiLinear(cfg, part, bits=bits, device=device)
        low = low_model.logits(ids)
        toks = [qref.sample_topk(lo[len(p) - 1 :], top_k, temperature, gen) for lo, p in zip(low, prompts)]
        routes = [{li: r[j] for li, r in low_model.routes.items()} for j in range(len(ids))]
    ref8 = kref.KimiLinear(cfg, part, bits=8, device=device)
    lg8 = ref8.logits(ids, routes)
    worst = 0.0
    for lg, p, t in zip(lg8, prompts, toks):
        worst = max(worst, float(qref.topk_gaps(lg[len(p) - 1 :], t, top_k).max().item()))
    return worst, ref8.route_gap
