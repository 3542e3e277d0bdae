"""Text-variant generation, the first stage of TVC (port of
``tvc/augment/text_augment.py``).

The strategies run in a fixed order: synonym substitution (the port's own
lexicon, ``tvc_torch/attacks/text_attack.py``; draws from numpy's seeded
generator, so the strings are the JAX package's), syntax transforms,
templates, LLM paraphrases from an injected generator (any callable
``(text, n) -> list[str]``; ``ParaphraseAdapter`` over the port's Qwen2
decode adds ``batch`` / ``batch_async``, one decode batch for all queries)
and round-trip back-translation (off by default). Each strategy's output
passes the quality filter and the dedup; without a CLIP model the later
strategies are skipped once enough variants survive; with one, one
batched text encode ranks and band-filters the pool. An md5-keyed LRU
cache returns a repeated text's variants without running any strategy or
decode. ``generate_variants`` is the public name, ``augment`` its alias.

Unlike the JAX package, which drops a strategy whose paraphrase generator
or translator raises, the port lets the error through: a decode whose
kernel fails to build or launch raises instead of quietly serving
host-only variants.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from tvc_torch.attacks.text_attack import STOPWORDS, get_synonyms


@dataclasses.dataclass
class TextAugmentConfig:
    """(reference src/text_augment.py:40-80)"""

    max_variants: int = 5
    min_similarity_threshold: float = 0.7
    max_similarity_threshold: float = 0.95
    enable_synonym_replacement: bool = True
    enable_paraphrase_generation: bool = True
    enable_syntax_transformation: bool = True
    enable_template: bool = True  # experiments/defenses/text_variants.py:138
    enable_back_translation: bool = False
    synonym_replacement_ratio: float = 0.3
    min_word_length: int = 3
    enable_quality_filter: bool = True
    min_text_length: int = 5
    max_text_length: int = 1000
    filter_duplicates: bool = True
    seed: int = 42
    # md5-keyed LRU variant cache: the steady-state serving surface (the
    # reference declares per-component caches and clears them through
    # pipeline.clear_cache, src/pipeline.py:742-751, and amortizes repeat
    # queries through md5 caches, src/sd_ref.py:454-483) — a repeated text
    # returns its variants without re-running any strategy or LLM decode
    cache_enabled: bool = True
    cache_size: int = 4096


TEMPLATES = [
    "a photo of {}",
    "an image showing {}",
    "a picture of {}",
    "{} in the scene",
    "this image depicts {}",
]


def normalize_text(text: str) -> str:
    # str.split() collapses all whitespace runs like re \s+ but ~4x faster
    # (this runs per candidate variant on the serving hot path)
    return " ".join(text.lower().split())


_TWO_WORDS = re.compile(r"\w+\W+\w+")


def is_valid_text(text: str, min_len: int = 5, max_len: int = 1000) -> bool:
    """(reference src/text_augment.py:118-133)"""
    if not text:
        return False
    n = len(text.strip())
    if n < min_len or n > max_len:
        return False
    # >= 2 \w+ groups, without materializing every match like findall
    return _TWO_WORDS.search(text) is not None


class SynonymReplacer:
    """WordNet/builtin synonym substitution (reference :139-268)."""

    def __init__(self, config: TextAugmentConfig):
        self.config = config
        self._rng = np.random.default_rng(config.seed)

    def augment(self, text: str, num_variants: int) -> List[str]:
        words = text.split()
        # one synonym lookup per unique word (the scan + per-variant lookups
        # previously hit get_synonyms twice per replaced word; this path runs
        # per query on the serving hot path)
        syn_map: Dict[str, List[str]] = {}
        replaceable = []
        for i, w in enumerate(words):
            wl = w.lower()
            if len(w) < self.config.min_word_length or wl in STOPWORDS:
                continue
            syns = syn_map.get(wl)
            if syns is None:
                syns = get_synonyms(wl, 10)
                syn_map[wl] = syns
            if syns:
                replaceable.append(i)
        if not replaceable:
            return []
        variants = []
        n_replace = min(
            max(1, int(len(replaceable) * self.config.synonym_replacement_ratio)),
            len(replaceable),
        )
        for v in range(num_variants * 2):  # oversample; filter dedups
            idxs = self._rng.permutation(len(replaceable))[:n_replace]
            cand = list(words)
            for j in idxs:
                i = replaceable[j]
                syns = syn_map[words[i].lower()]
                cand[i] = syns[int(self._rng.integers(len(syns)))]
            variants.append(" ".join(cand))
        return variants


class SyntaxTransformer:
    """Regex passive-voice + clause reorder (reference :320-377)."""

    PASSIVE_PATTERNS = [
        (re.compile(r"(\w+)\s+(\w+ed)\s+(\w+)$", re.IGNORECASE), r"\3 is \2 by \1"),
        (re.compile(r"(\w+)\s+makes?\s+(\w+)", re.IGNORECASE), r"\2 is made by \1"),
        (re.compile(r"(\w+)\s+creates?\s+(\w+)", re.IGNORECASE), r"\2 is created by \1"),
    ]

    def __init__(self, config: TextAugmentConfig):
        self.config = config

    def augment(self, text: str, num_variants: int) -> List[str]:
        variants = []
        for pattern, repl in self.PASSIVE_PATTERNS:
            out, nsub = pattern.subn(repl, text)
            if nsub:
                if out != text:
                    variants.append(out)
                break
        if " and " in text:
            a, _, b = text.partition(" and ")
            variants.append(f"{b.strip()} and {a.strip()}")
        if " but " in text:
            a, _, b = text.partition(" but ")
            variants.append(f"Although {a.strip()}, {b.strip()}")
        return variants[:num_variants]


class TemplateAugmenter:
    """Template wrapping (reference experiments/defenses/text_variants.py:138-156)."""

    def __init__(self, config: TextAugmentConfig):
        self.config = config

    def augment(self, text: str, num_variants: int) -> List[str]:
        core = text.strip().rstrip(".")
        lowered = core[0].lower() + core[1:] if core else core
        return [t.format(lowered) for t in TEMPLATES[:num_variants]]


class BackTranslator:
    """Round-trip translation variants (reference src/text_augment.py:380-460
    uses Helsinki-NLP HF pipelines, disabled by default). The translator is
    injected (``(texts, src, dst) -> list[str]``); TextAugmenter derives one
    automatically from a Qwen-backed paraphrase generator
    (QwenModel.translate round-trip), so no separate translation weights are
    needed. With no backend at all the strategy stays inactive."""

    def __init__(
        self,
        config: "TextAugmentConfig",
        translator: Optional[Callable[[List[str], str, str], List[str]]] = None,
        languages: Sequence[str] = ("de", "fr", "es"),
    ):
        self.config = config
        self.translator = translator
        self.languages = list(languages)

    def augment(self, text: str, num_variants: int) -> List[str]:
        if self.translator is None:
            return []
        out = []
        for lang in self.languages[:num_variants]:
            back = self.translator(self.translator([text], "en", lang), lang, "en")
            if back and back[0].strip():
                out.append(back[0].strip())
        return out


class ParaphraseGenerator:
    """LLM paraphrases via an injected generator (reference :269-319 uses
    QwenModel.generate_paraphrases; tvc_torch/models/qwen.py provides it)."""

    def __init__(
        self,
        config: TextAugmentConfig,
        generator: Optional[Callable[[str, int], List[str]]] = None,
    ):
        self.config = config
        self.generator = generator

    def augment(self, text: str, num_variants: int) -> List[str]:
        if self.generator is None:
            return []
        return list(self.generator(text, num_variants))


class TextAugmenter:
    """Multi-strategy variant generator with quality filter + dedup + optional
    CLIP-semantic ranking (reference src/text_augment.py:462-580)."""

    def __init__(
        self,
        config: Optional[TextAugmentConfig] = None,
        paraphrase_generator: Optional[Callable[[str, int], List[str]]] = None,
        clip_model=None,
        translator: Optional[Callable[[List[str], str, str], List[str]]] = None,
    ):
        self.config = config or TextAugmentConfig()
        self.clip_model = clip_model  # optional: semantic filter/ranking
        self.strategies: Dict[str, object] = {}
        if self.config.enable_synonym_replacement:
            self.strategies["synonym"] = SynonymReplacer(self.config)
        if self.config.enable_syntax_transformation:
            self.strategies["syntax"] = SyntaxTransformer(self.config)
        if self.config.enable_template:
            self.strategies["template"] = TemplateAugmenter(self.config)
        if self.config.enable_paraphrase_generation:
            self.strategies["paraphrase"] = ParaphraseGenerator(
                self.config, paraphrase_generator
            )
        if self.config.enable_back_translation:
            if translator is None:
                # derive a Qwen-prompted round-trip translator from the
                # paraphrase generator's model (QwenModel.translate)
                # so all four reference strategies run with no extra
                # injection (reference loads Helsinki-NLP HF pipelines,
                # src/text_augment.py:389-410 — unavailable zero-egress)
                qwen = getattr(paraphrase_generator, "model", None) or (
                    paraphrase_generator
                    if hasattr(paraphrase_generator, "translate")
                    else None
                )
                if qwen is not None and hasattr(qwen, "translate"):
                    translator = qwen.translate
            self.strategies["back_translation"] = BackTranslator(
                self.config, translator
            )
        self.stats = {
            "calls": 0,
            "variants_generated": 0,
            "variants_filtered": 0,
            "cache_hits": 0,
        }
        # md5(text)+n keyed LRU (insertion-ordered dict; hits re-inserted)
        self._cache: Dict[str, List[str]] = {}

    @staticmethod
    def _cache_key(text: str, n: int) -> str:
        import hashlib

        return f"{hashlib.md5(text.encode()).hexdigest()}:{n}"

    def clear_cache(self) -> None:
        """(reference pipeline.clear_cache → text_augmenter.clear_cache,
        src/pipeline.py:742-745 — declared there but absent from the
        reference augmenter; here it is real)"""
        self._cache.clear()

    # canonical public name (SURVEY.md §0 API-drift resolution)
    def generate_variants(
        self,
        text: str,
        num_variants: Optional[int] = None,
        _paraphrases: Optional[List[str]] = None,
    ) -> List[str]:
        if not text or not text.strip():
            # reference rejects empty/blank input before any strategy runs
            # (src/text_augment.py:502-503) — otherwise TemplateAugmenter
            # happily wraps "" into a "valid" variant
            return []
        n = num_variants or self.config.max_variants
        self.stats["calls"] += 1
        key = self._cache_key(text, n) if self.config.cache_enabled else None
        if key is not None:
            hit = self._cache.get(key)
            if hit is not None:
                self._cache.pop(key)  # LRU: re-insert at the tail
                self._cache[key] = hit
                self.stats["cache_hits"] += 1
                return list(hit)
        n_raw = 0
        filtered: List[str] = []
        seen = {normalize_text(text)}
        lazy = self.clip_model is None  # ranking needs the full pool
        for name, strategy in self.strategies.items():
            if name == "paraphrase" and _paraphrases is not None:
                batch = list(_paraphrases)  # pre-generated in one batched decode
            else:
                batch = strategy.augment(text, n)
            n_raw += len(batch)
            self._filter_into(batch, filtered, seen)
            # _filter preserves order and the caller takes [:n], so once n
            # candidates survive the filter the later strategies can't change
            # the output — skip them (serving hot path: one call per query)
            if lazy and len(filtered) >= n:
                break
        self.stats["variants_generated"] += n_raw
        if self.clip_model is not None and filtered:
            filtered = self._rank_by_semantic_similarity(text, filtered)
        self.stats["variants_filtered"] += n_raw - len(filtered)
        out = filtered[:n]
        if key is not None:
            self._cache[key] = list(out)
            while len(self._cache) > self.config.cache_size:
                self._cache.pop(next(iter(self._cache)))
        return out

    augment = generate_variants  # reference alias (text_augment.py:491)

    def batch_generate_variants(
        self, texts: Sequence[str], num_variants: Optional[int] = None
    ) -> List[List[str]]:
        """Batch path: when the injected paraphrase generator supports
        ``batch(texts, n)`` (tvc_torch.models.qwen.ParaphraseAdapter), ALL
        queries' LLM paraphrases run as ONE decode batch instead of one
        decode per query."""
        return self.batch_generate_variants_async(texts, num_variants)()

    def batch_generate_variants_async(
        self, texts: Sequence[str], num_variants: Optional[int] = None
    ) -> Callable[[], List[List[str]]]:
        """Dispatch-now/finalize-later batch path: if the paraphrase
        generator exposes ``batch_async`` (ParaphraseAdapter over
        QwenModel.generate_async), the LLM decode runs HERE (queued on the
        card's stream; the port's decode waits for the device at each
        early-exit check, so it returns once its last chunk is queued) and
        everything host-side (readback, detok, host strategies, filter)
        happens in the returned finalizer, in the order the pipeline's
        ``process_stream`` dispatches batches."""
        n = num_variants or self.config.max_variants
        texts = list(texts)
        # steady-state fast path: texts whose variants are already cached
        # never reach the LLM — only the UNCACHED subset is decoded (this is
        # where the md5-cache amortization the reference reports in its
        # component times, README.md:903-909, actually happens)
        need = (
            [
                i
                for i, t in enumerate(texts)
                if self._cache_key(t, n) not in self._cache
            ]
            if self.config.cache_enabled
            else list(range(len(texts)))
        )
        para = self.strategies.get("paraphrase")
        gen = getattr(para, "generator", None)
        pre_handle: Optional[Callable[[], List[List[str]]]] = None
        async_fn = getattr(gen, "batch_async", None)
        if async_fn is not None and need:
            pre_handle = async_fn([texts[i] for i in need], n)
        batch_fn = (
            getattr(gen, "batch", None) if pre_handle is None and need else None
        )

        def finalize() -> List[List[str]]:
            pre: Optional[List[List[str]]] = None
            if pre_handle is not None:
                pre = pre_handle()
            elif batch_fn is not None:
                pre = batch_fn([texts[i] for i in need], n)
            pos = {i: j for j, i in enumerate(need)}
            return [
                self.generate_variants(
                    t,
                    n,
                    _paraphrases=(
                        pre[pos[i]] if pre is not None and i in pos else None
                    ),
                )
                for i, t in enumerate(texts)
            ]

        return finalize

    batch_augment = batch_generate_variants

    def _filter(self, original: str, variants: List[str]) -> List[str]:
        """Quality filter + dedup (reference :95-117, :516-528)."""
        out: List[str] = []
        self._filter_into(variants, out, {normalize_text(original)})
        return out

    def _filter_into(
        self, variants: List[str], out: List[str], seen: set
    ) -> None:
        """Incremental form of _filter: appends survivors to ``out``,
        tracking dedup keys in ``seen`` across calls (the lazy per-strategy
        path in generate_variants filters each strategy's batch as it
        arrives instead of re-scanning the accumulated pool)."""
        if not self.config.enable_quality_filter:
            out.extend(variants)
            return
        for v in variants:
            if not is_valid_text(
                v, self.config.min_text_length, self.config.max_text_length
            ):
                continue
            key = normalize_text(v)
            if self.config.filter_duplicates and key in seen:
                continue
            seen.add(key)
            out.append(v)

    def _rank_by_semantic_similarity(
        self, original: str, variants: List[str]
    ) -> List[str]:
        """One batched CLIP text encode ranks + band-filters all variants
        (reference experiments/defenses/text_variants.py:206-300: keep
        variants semantically close to, but not duplicates of, the
        original)."""
        feats = self.clip_model.encode_text([original] + variants).detach().cpu().numpy()
        sims = feats[1:] @ feats[0]
        lo, hi = (
            self.config.min_similarity_threshold,
            self.config.max_similarity_threshold,
        )
        keep = [
            (float(s), v)
            for s, v in zip(sims, variants)
            if lo <= float(s) <= hi
        ]
        if not keep:  # fall back to closest-first if the band is empty
            keep = sorted(zip(map(float, sims), variants), reverse=True)
        return [v for _, v in sorted(keep, reverse=True)]

    def get_stats(self) -> Dict[str, int]:
        return dict(self.stats)


def create_text_augmenter(
    config: Optional[TextAugmentConfig] = None, **kw
) -> TextAugmenter:
    return TextAugmenter(config, **kw)
