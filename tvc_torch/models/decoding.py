"""The host side and the token loop that the port's decoder LMs share.

:class:`CausalDecoder` holds everything around a model's layer stack:
``prepare`` (tokenizing, the shared-prefix split, the prompt bucket, the
vocabulary mask as an allowed-id list), ``decode`` (the prefix-shared
prefill, ``n_samples`` tiling of the prefilled cache, top-k sampling, the
early exit, teacher forcing), ``generate_async`` and the paraphrase and
translation entry points, and :class:`ParaphraseAdapter`, the batched
paraphrase generator a text augmenter takes.

A model supplies its weights, its GEMM, its cache and its layers through
these methods:

* ``_decode_state()`` -> ``(non_layer, stacked)``: the weights the decode
  reads; ``_mm(x3, leaf)``: ``x [..., K]`` @ a weight leaf, an int8 leaf
  through the model's own kernel where :func:`takes_kernel` says so;
* ``_new_cache(B, S)``: a zeroed cache of B rows and S slots;
  ``_put_prefix(cache, pre, P)``: the batch-1 prefix cache ``pre`` into
  every row's slots ``[0, P)``; ``_tile_cache(cache, n)``: each row
  repeated ``n`` times, in place of the row;
* ``_run_layers(stacked, x, positions, mask, cache, cache_index, ctx=0,
  step=None)``: every layer on ``x [B, T, H]``, writing slots
  ``cache_index .. cache_index + T`` (mask ``[B, 1, T, S]`` for a block,
  ``[B, S]`` for one step; ``ctx`` cached slots ahead of the block;
  ``step`` the decode step, None in the prefill); returns ``(h, y)``, the
  residual stream and the last layer's branch output not yet added to it
  (None where it is), so that the add goes into the final norm's launch.

The hooks both models share are written here once, for a model to
override where it differs (Qwen2's tied head, ``tvc_torch.parallel.tp``'s
tensor-parallel Qwen2): ``_embed(non_layer, tokens)``, ``_head(non_layer,
allowed)`` (a callable from the final hidden state to f32 logits) and
``_final_norm(non_layer, h, y)`` (the final RMSNorm of ``h + y``, of ``h``
where ``y`` is None).

``SPANS`` names the model's four spans (prepare, prefill, one decode step,
readback); ``_begin_decode(steps)`` runs before the first step;
``_readback(rows, aux)`` reads the tokens back (``aux`` is what
``_decode_aux()`` gave right after the decode call was queued).

Both models also share the weight-tree helpers below (dotted names, w8
leaves ``{"int8", "scale"}``)."""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from tvc_torch.core.kernels.decode_fused_kernel import add_rmsnorm, rmsnorm
from tvc_torch.utils import tracing

#: the largest activation block (B * T rows) the weight-only kernels take;
#: larger blocks dequantize, then matmul (the JAX package's VMEM limit,
#: ``tvc/models/qwen.py`` ``mm`` / ``mm_stacked``); read at each call of
#: :func:`takes_kernel`, so a test may patch it here
W8_MAX_ROWS = 1024

#: early-exit decode granularity: the decode loop checks the
#: all-sequences-done flag every DECODE_CHUNK steps, when max_new_tokens is
#: a larger multiple of it
DECODE_CHUNK = 4


def _stable_seed(text: str) -> int:
    """FNV-1a digest -> [0, 2^31): stable across processes, unlike hash()."""
    h = 0xCBF29CE484222325
    for b in text.encode("utf-8"):
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h % (2**31)


def _is_q(x) -> bool:
    return isinstance(x, Mapping) and "int8" in x


def takes_kernel(rows: int, quant_gemm: str = "w8") -> bool:
    """Whether an int8 GEMM of ``rows`` activation rows runs its kernel:
    every W8A8 one; a weight-only one up to ``W8_MAX_ROWS`` rows (a larger
    block dequantizes, then multiplies, as the JAX package routes it)."""
    return quant_gemm == "w8a8" or rows <= W8_MAX_ROWS


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    """Dotted names -> leaves; an ``{"int8", "scale"}`` dict is one leaf."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping) and not _is_q(v):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = v
    return out


def _unflatten(flat: Dict[str, Any]) -> Dict:
    tree: Dict = {}
    for name, v in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _to(t, device):
    if _is_q(t):
        return {"int8": t["int8"].to(device), "scale": t["scale"].to(device)}
    return t.to(device) if torch.is_tensor(t) else torch.as_tensor(np.asarray(t), device=device)


#: the instruction prefix shared by every paraphrase prompt (prefilled once
#: at batch 1); it ends on a byte-level-BPE pre-tokenizer boundary, so
#: tokenize(prefix) + tokenize(suffix) == tokenize(prefix + suffix)
PARAPHRASE_PREFIX = (
    "Rewrite the following sentence with the same meaning but different "
    "wording.\nSentence:"
)
PARAPHRASE_PROMPT = PARAPHRASE_PREFIX + " {text}\nRewrite:"

TRANSLATE_PREFIX = (
    "Translate the following sentence from {src} to {dst}. Reply with only "
    "the translation.\nSentence:"
)
TRANSLATE_PROMPT = TRANSLATE_PREFIX + " {text}\nTranslation:"

_LANG_NAMES = {
    "en": "English",
    "de": "German",
    "fr": "French",
    "es": "Spanish",
    "zh": "Chinese",
    "ja": "Japanese",
}


@dataclasses.dataclass
class DecodeInputs:
    """One decode call's prompt block, built on the host by
    :meth:`CausalDecoder.prepare`: ``prefix`` [P] shared ids (P may be 0),
    ``tokens`` [B, plen - P] padded suffixes (or whole prompts), ``lengths``
    [B] real lengths counting the prefix, ``plen`` the cache slots the
    prompt takes, ``allowed`` the padded allowed-id list (or None) with its
    ``n_real`` real entries."""

    prefix: Tensor
    tokens: Tensor
    lengths: Tensor
    plen: int
    n_samples: int
    allowed: Optional[Tensor]
    n_real: int

    @property
    def P(self) -> int:
        return int(self.prefix.shape[0])


class CausalDecoder:
    """The decode loop and the host side of a decoder LM (see the module
    docstring for what a model supplies). Subclasses set ``config``
    (``vocab_size``, ``max_seq_len``), ``tokenizer``, ``device`` and
    ``max_new_tokens``."""

    SPANS: Tuple[str, str, str, str] = ("lm.prepare", "lm.prefill", "lm.decode_step", "lm.readback")

    def _chunk(self) -> int:
        return DECODE_CHUNK

    def _begin_decode(self, steps: int) -> None:
        """Called once a decode call, before its first step."""

    def _decode_aux(self) -> Any:
        return None

    def _readback(self, rows: Tensor, aux: Any) -> np.ndarray:
        return rows.cpu().numpy()

    def _embed(self, non_layer: Dict, tokens: Tensor) -> Tensor:
        """Take, then dequantize: only the gathered rows are converted."""
        e = non_layer["embed"]["embedding"]
        dt = self.config.dtype
        if _is_q(e):
            return e["int8"][tokens].to(dt) * e["scale"].to(dt)
        return e[tokens].to(dt)

    def _head(self, non_layer: Dict, allowed: Optional[Tensor]) -> Callable[[Tensor], Tensor]:
        """The f32 logits of the untied head: over the whole vocabulary or,
        for constrained decoding, over the allowed columns gathered once."""
        kern = non_layer["lm_head"]["kernel"]
        if allowed is not None:
            kern = {"int8": kern["int8"][:, allowed].contiguous(), "scale": kern["scale"][allowed].contiguous()} \
                if _is_q(kern) else kern[:, allowed]
        return lambda x: self._mm(x, kern).float()

    def _final_norm(self, non_layer: Dict, h: Tensor, y: Optional[Tensor]) -> Tensor:
        scale, eps = non_layer["ln_f"]["scale"], self.config.rms_eps
        return rmsnorm(h, scale, eps) if y is None else add_rmsnorm(h, y, scale, eps)[1]

    @staticmethod
    def _sample(lg: Tensor, gen: torch.Generator, temperature: float, top_k: int,
                allowed: Optional[Tensor], n_real: int) -> Tensor:
        """Top-k (exact) sampling at ``temperature`` by the Gumbel-max trick
        (``jax.random.categorical``'s method), or argmax at or below 1e-4;
        padded allowed-id slots are never chosen."""
        if allowed is not None:
            pad = torch.arange(lg.shape[-1], device=lg.device) >= n_real
            lg = lg.masked_fill(pad, float("-inf"))
        if temperature > 1e-4:
            topv, topi = torch.topk(lg, top_k, dim=-1)
            u = torch.rand(topv.shape, generator=gen, device=lg.device).clamp_(min=torch.finfo(torch.float32).tiny)
            choice = torch.argmax(topv / max(temperature, 1e-4) - torch.log(-torch.log(u)), dim=-1)
            loc = topi.gather(1, choice[:, None])[:, 0]
        else:
            loc = torch.argmax(lg, dim=-1)
        return allowed[loc] if allowed is not None else loc

    @torch.no_grad()
    def decode(
        self,
        inp: DecodeInputs,
        temperature: float = 0.8,
        seed: int = 0,
        forced: Optional[Tensor] = None,
        on_logits: Optional[Callable[[int, Tensor], None]] = None,
    ) -> Tensor:
        """Prefill + the token loop on the device; returns the tokens
        ``[B * n_samples, max_new_tokens]`` (EOT after a sequence ends).

        ``forced`` [n, B * n_samples]: take these tokens instead of sampling
        and stop after n steps (teacher forcing, to hold two runs of the
        same path against each other); ``on_logits(step, logits)`` sees the
        f32 logits each step samples from. ``self.last_decode_steps`` is
        the number of steps the loop ran (fewer after an early exit)."""
        _, prefill_span, step_span, _ = self.SPANS
        with tracing.span(prefill_span, rows=int(inp.tokens.shape[0])):
            c, dev = self.config, self.device
            non_layer, stacked = self._decode_state()
            eot = getattr(self.tokenizer, "eot_id", -1)
            P, plen = inp.P, inp.plen
            S = plen + self.max_new_tokens
            B = inp.tokens.shape[0]
            head = self._head(non_layer, inp.allowed)
            cache = self._new_cache(B, S)
            ks = torch.arange(S, device=dev)
            lengths = inp.lengths
            T = plen - P
            t_idx = torch.arange(T, device=dev)
            if P:
                # prefix-shared prefill: the prefix at batch 1, broadcast into
                # every row's slots [0, P); then the suffixes at offset P
                kp = torch.arange(P, device=dev)
                pre_mask = torch.zeros((1, 1, P, P), device=dev).masked_fill(kp[None, :] > kp[:, None], float("-inf"))
                pre = self._new_cache(1, P)
                self._run_layers(stacked, self._embed(non_layer, inp.prefix[None]), kp[None], pre_mask, pre, 0)
                self._put_prefix(cache, pre, P)
            keep = (ks[None, None, :] <= P + t_idx[None, :, None]) & (ks[None, None, :] < lengths[:, None, None])
            if P:
                keep = keep | (ks < P)[None, None, :]
            prefill_mask = torch.zeros(keep.shape, device=dev).masked_fill(~keep, float("-inf"))[:, None]
            positions = (P + t_idx)[None].expand(B, T)
            x = self._final_norm(non_layer, *self._run_layers(
                stacked, self._embed(non_layer, inp.tokens), positions, prefill_mask, cache, P, ctx=P))
            x = x[torch.arange(B, device=dev), lengths - P - 1][:, None]
            next_logits = head(x)[:, 0]

        n = inp.n_samples
        if n > 1:  # each prompt's prefilled cache serves n sampling chains
            cache = self._tile_cache(cache, n)
            next_logits = next_logits.repeat_interleave(n, dim=0)
            lengths = lengths.repeat_interleave(n, dim=0)
        top_k = min(50, inp.allowed.shape[0] if inp.allowed is not None else c.vocab_size)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        Bn = next_logits.shape[0]
        done = torch.zeros(Bn, dtype=torch.bool, device=dev)
        tokens = torch.full((self.max_new_tokens, Bn), eot, dtype=torch.long, device=dev)
        steps = self.max_new_tokens if forced is None else min(self.max_new_tokens, forced.shape[0])
        self._begin_decode(steps)
        chunk = self._chunk()
        early_exit = self.max_new_tokens > chunk and self.max_new_tokens % chunk == 0
        self.last_decode_steps = 0
        for i in range(steps):
            if early_exit and i and i % chunk == 0 and bool(done.all()):
                break  # every sequence has ended: the rest is the EOT fill
            with tracing.span(step_span, step=i, rows=Bn):
                self.last_decode_steps = i + 1
                if on_logits is not None:
                    on_logits(i, next_logits)
                if forced is not None:
                    tok = forced[i].to(dev, torch.long)
                else:
                    tok = self._sample(next_logits, gen, temperature, top_k, inp.allowed, inp.n_real)
                tok = torch.where(done, torch.full_like(tok, eot), tok)
                done = done | (tok == eot)
                tokens[i] = tok
                cache_pos = plen + i
                valid = (ks[None] < lengths[:, None]) | ((ks[None] >= plen) & (ks[None] <= cache_pos))
                step_mask = torch.zeros(valid.shape, device=dev).masked_fill(~valid, float("-inf"))
                h, y = self._run_layers(stacked, self._embed(non_layer, tok[:, None]), (lengths + i)[:, None],
                                        step_mask, cache, cache_pos, step=i)
                next_logits = head(self._final_norm(non_layer, h, y))[:, 0]
        return tokens.T

    # -- host side -----------------------------------------------------------------------
    def _prefix_ids(self, prefix: str) -> np.ndarray:
        """Token ids of a shared prompt prefix (a few fixed strings, cached)."""
        cache = self.__dict__.setdefault("_prefix_ids_cache", {})
        ids = cache.get(prefix)
        if ids is None:
            row = self.tokenizer([prefix])[0]
            pad = getattr(self.tokenizer, "pad_id", 0)
            ids = row[: int((row != pad).sum())].astype(np.int32)
            if len(cache) >= 8:
                cache.clear()
            cache[prefix] = ids
        return ids

    def prepare(
        self,
        prompts: List[str],
        n_samples: int = 1,
        token_mask: Optional[np.ndarray] = None,
        shared_prefix: Optional[str] = None,
    ) -> DecodeInputs:
        """Tokenize, split off the shared prefix where the split is
        token-exact (checked on the first prompt, verdict cached per
        prefix), bucket the prompt length to a multiple of 8 and turn the
        vocabulary mask into a padded allowed-id list. A tokenizer that
        opens every text with a BOS offers ``without_bos``, which the
        suffixes are tokenized with."""
        pad = getattr(self.tokenizer, "pad_id", 0)
        prefix_ids = np.zeros((0,), np.int32)
        if shared_prefix:
            bad = next((p for p in prompts if not p.startswith(shared_prefix)), None)
            if bad is not None:
                raise ValueError(f"shared_prefix {shared_prefix!r} is not a prefix of prompt {bad!r}")
            ok_cache = self.__dict__.setdefault("_prefix_ok_cache", {})
            if ok_cache.get(shared_prefix, True):
                prefix_ids = self._prefix_ids(shared_prefix)
                suffix_tokenizer = getattr(self.tokenizer, "without_bos", self.tokenizer)
                tok = suffix_tokenizer([p[len(shared_prefix):] for p in prompts])
                if prompts and shared_prefix not in ok_cache:
                    full0 = self.tokenizer([prompts[0]])[0]
                    n0 = int((full0 != pad).sum())
                    split0 = np.concatenate([prefix_ids, tok[0, : int((tok[0] != pad).sum())]])
                    ok_cache[shared_prefix] = bool(n0 == len(split0) and np.array_equal(full0[:n0], split0))
            if not ok_cache.get(shared_prefix, True):
                prefix_ids = np.zeros((0,), np.int32)  # not token-exact: plain prefill
                tok = self.tokenizer(prompts)
        else:
            tok = self.tokenizer(prompts)
        P = len(prefix_ids)
        lengths = (tok != pad).sum(axis=1)
        plen = min(-(-max(int(lengths.max()), 4) // 8) * 8, self.config.max_seq_len - self.max_new_tokens - P)
        tok = tok[:, :plen]
        allowed, n_real = None, 0
        if token_mask is not None:
            m_np = np.asarray(token_mask, bool)
            if m_np.shape != (self.config.vocab_size,):
                raise ValueError(f"token_mask must be bool [{self.config.vocab_size}], got shape {m_np.shape}")
            if not m_np.any():
                raise ValueError("token_mask allows no vocabulary ids")
            if not m_np.all():
                key = m_np.tobytes()
                cached = self.__dict__.get("_allowed_cache")
                if cached is not None and cached[0] == key:
                    _, allowed, n_real = cached
                else:
                    ids = np.nonzero(m_np)[0]
                    n_real = len(ids)
                    va = -(-n_real // 128) * 128  # padded with copies of ids[0], never sampled
                    ids = np.pad(ids, (0, va - n_real), constant_values=int(ids[0]))
                    allowed = torch.as_tensor(ids, dtype=torch.long, device=self.device)
                    self._allowed_cache = (key, allowed, n_real)
        dev = self.device
        return DecodeInputs(
            prefix=torch.as_tensor(prefix_ids, dtype=torch.long, device=dev),
            tokens=torch.as_tensor(tok, dtype=torch.long, device=dev),
            lengths=torch.as_tensor(np.minimum(lengths, plen) + P, dtype=torch.long, device=dev),
            plen=plen + P, n_samples=n_samples, allowed=allowed, n_real=n_real,
        )

    def generate_async(
        self,
        prompts: List[str],
        temperature: float = 0.8,
        seed: int = 0,
        n_samples: int = 1,
        token_mask: Optional[np.ndarray] = None,
        shared_prefix: Optional[str] = None,
    ) -> Callable[[], List[str]]:
        """Run the batched decode and return a zero-arg callable that reads
        the tokens back and detokenizes them. The decode is queued on the
        card's stream, but its early-exit check every DECODE_CHUNK steps
        waits for the device, so this call returns after the decode's
        last chunk is queued; only the readback and the detokenization
        are left to the callable. Spans (``SPANS``): prepare (tokenizing),
        prefill and one decode step a step (``decode``), readback (the
        callable)."""
        prepare_span, _, _, readback_span = self.SPANS
        with tracing.span(prepare_span, rows=len(prompts)):
            inp = self.prepare(prompts, n_samples, token_mask, shared_prefix)
        rows = self.decode(inp, temperature, seed)
        aux = self._decode_aux()

        def result() -> List[str]:
            with tracing.span(readback_span):
                out = self._readback(rows, aux)
                batch_decode = getattr(self.tokenizer, "decode_batch", None)
                if batch_decode is not None:
                    eot = getattr(self.tokenizer, "eot_id", -1)
                    return batch_decode([[i for i in row if i != eot] for row in out.tolist()])
                return [self._detokenize(row) for row in out]

        return result

    def generate(
        self,
        prompts: List[str],
        temperature: float = 0.8,
        seed: int = 0,
        n_samples: int = 1,
        token_mask: Optional[np.ndarray] = None,
        shared_prefix: Optional[str] = None,
    ) -> List[str]:
        """Batched prompt -> continuation decode; ``n_samples > 1`` gives n
        sampled continuations per prompt (rows ``i*n .. (i+1)*n`` belong to
        prompt i) from one shared prefill; ``token_mask`` (bool [vocab])
        constrains sampling to the allowed ids (see ascii_token_mask)."""
        return self.generate_async(prompts, temperature, seed, n_samples, token_mask, shared_prefix)()

    def ascii_token_mask(self) -> np.ndarray:
        """Bool [vocab] mask of the ids whose decoded text is printable
        ASCII (or empty), plus EOT; all True for a tokenizer that cannot
        decode single ids. Cached per instance."""
        cached = self.__dict__.get("_ascii_mask")
        if cached is not None:
            return cached
        vocab = self.config.vocab_size
        mask = np.ones((vocab,), bool)
        token_texts = getattr(self.tokenizer, "token_texts", None)
        if token_texts is not None:
            n = min(vocab, len(self.tokenizer))
            mask = np.zeros((vocab,), bool)
            mask[:n] = np.fromiter(
                ((t.isascii() and t.isprintable()) or t == "" for t in token_texts(n)), bool, count=n
            )
        eot = getattr(self.tokenizer, "eot_id", None)
        if eot is not None:
            mask[int(eot)] = True  # chains must be able to terminate
        self._ascii_mask = mask
        return mask

    def _detokenize(self, ids: np.ndarray) -> str:
        eot = getattr(self.tokenizer, "eot_id", -1)
        ids = [int(i) for i in ids if int(i) != eot]
        decode = getattr(self.tokenizer, "decode", None)
        if decode is not None:
            return decode(ids)
        # the hash tokenizer is not invertible: deterministic placeholder words
        return " ".join(f"tok{i}" for i in ids)

    def generate_paraphrases(self, text: str, num_paraphrases: int = 3, temperature: float = 0.8) -> List[str]:
        """N samples of the paraphrase prompt, batched into one decode."""
        outs = self.generate(
            [PARAPHRASE_PROMPT.format(text=text)], temperature=temperature,
            seed=_stable_seed(text), n_samples=num_paraphrases,
        )
        return [o.strip() for o in outs if o.strip()]

    def generate_paraphrases_batch(
        self,
        texts: List[str],
        num_paraphrases: int = 3,
        temperature: float = 0.8,
        seed: int = 0,
        token_mask: Optional[np.ndarray] = None,
    ) -> List[List[str]]:
        """Every query's paraphrases in one decode batch of B * N sequences."""
        return self.generate_paraphrases_batch_async(texts, num_paraphrases, temperature, seed, token_mask)()

    def generate_paraphrases_batch_async(
        self,
        texts: List[str],
        num_paraphrases: int = 3,
        temperature: float = 0.8,
        seed: int = 0,
        token_mask: Optional[np.ndarray] = None,
    ) -> Callable[[], List[List[str]]]:
        """:meth:`generate_paraphrases_batch` through :meth:`generate_async`:
        one prefill per prompt (the instruction prefix once for the batch),
        n sampling chains each."""
        n = num_paraphrases
        if not texts:
            return lambda: []
        handle = self.generate_async(
            [PARAPHRASE_PROMPT.format(text=t) for t in texts], temperature=temperature, seed=seed,
            n_samples=n, token_mask=token_mask, shared_prefix=PARAPHRASE_PREFIX,
        )

        def result() -> List[List[str]]:
            outs = handle()
            return [[o.strip() for o in outs[i * n : (i + 1) * n] if o.strip()] for i in range(len(texts))]

        return result

    def translate(self, texts: List[str], src: str, dst: str, temperature: float = 0.0) -> List[str]:
        """Batched prompt-based translation (greedy by default); an empty
        output keeps its input, so outputs align with inputs."""
        sn, dn = _LANG_NAMES.get(src, src), _LANG_NAMES.get(dst, dst)
        outs = self.generate(
            [TRANSLATE_PROMPT.format(src=sn, dst=dn, text=t) for t in texts], temperature=temperature,
            seed=_stable_seed(f"{src}->{dst}:" + "\x00".join(texts)),
            shared_prefix=TRANSLATE_PREFIX.format(src=sn, dst=dn),
        )
        return [o.strip() or texts[i] for i, o in enumerate(outs)]

    def as_translator(self):
        """Callable ``(texts, src, dst) -> list[str]``."""
        return self.translate

    def as_paraphrase_generator(self) -> "ParaphraseAdapter":
        return ParaphraseAdapter(self)


class ParaphraseAdapter:
    """Callable ``(text, n) -> list[str]`` plus ``batch(texts, n)`` so a
    text augmenter can run one decode across a whole query batch."""

    def __init__(self, model: CausalDecoder, temperature: float = 0.8):
        self.model = model
        self.temperature = temperature

    def __call__(self, text: str, n: int) -> List[str]:
        return self.model.generate_paraphrases(text, n, self.temperature)

    def batch(self, texts: List[str], n: int) -> List[List[str]]:
        return self.batch_async(texts, n)()

    def batch_async(self, texts: List[str], n: int) -> Callable[[], List[List[str]]]:
        return self.model.generate_paraphrases_batch_async(
            texts, n, self.temperature, seed=_stable_seed("\x00".join(texts))
        )
