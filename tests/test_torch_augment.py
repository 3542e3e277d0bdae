"""tvc_torch's text augmenter (``tvc_torch/augment``) and synonym lexicon
(``tvc_torch/attacks/text_attack.py``) against the JAX package's on the
bundled COCO captions: every strategy alone and the defaults give the same
strings; the cache, its evictions and the stats behave alike; the batched
paths decode only uncached texts; the CLIP ranking orders the same."""

import jax
import numpy as np
import pytest

import chip_smoke
import tvc.attacks.text_attack as j_lex
from tvc.augment import TextAugmentConfig as JConfig, TextAugmenter as JAugmenter
from tvc.models.clip import CLIPConfig as JClipConfig, CLIPModel as JClip
from tvc_torch.attacks import text_attack as t_lex
from tvc_torch.augment import (
    TextAugmentConfig,
    TextAugmenter,
    create_text_augmenter,
    is_valid_text,
    normalize_text,
)
from tvc_torch.models.clip import CLIPConfig, CLIPModel, params_from_jax

CAPTIONS = chip_smoke.coco_captions(500)


class StubParaphraser:
    """A deterministic paraphrase generator with the adapter's surface;
    records what it was asked to decode."""

    def __init__(self):
        self.decoded = []

    def __call__(self, text, n):
        return [f"{w} {text.lower()}" for w in ("indeed", "truly", "surely", "really", "plainly")[:n]] + [text]

    def batch(self, texts, n):
        return self.batch_async(texts, n)()

    def batch_async(self, texts, n):
        self.decoded.append(list(texts))
        return lambda: [self(t, n) for t in texts]


def translator(texts, src, dst):
    return [f"{t} ({src}>{dst})" for t in texts]


STRATEGIES = {
    "synonym": dict(enable_syntax_transformation=False, enable_template=False, enable_paraphrase_generation=False),
    "syntax": dict(enable_synonym_replacement=False, enable_template=False, enable_paraphrase_generation=False),
    "template": dict(enable_synonym_replacement=False, enable_syntax_transformation=False,
                     enable_paraphrase_generation=False),
    "paraphrase": dict(enable_synonym_replacement=False, enable_syntax_transformation=False, enable_template=False),
    "back_translation": dict(enable_synonym_replacement=False, enable_syntax_transformation=False,
                             enable_template=False, enable_paraphrase_generation=False,
                             enable_back_translation=True),
    "defaults": {},
    "no_filter": dict(enable_quality_filter=False, cache_enabled=False, seed=7),
}


def _pair(cfg_kw, **kw):
    return (JAugmenter(JConfig(**cfg_kw), **kw), TextAugmenter(TextAugmentConfig(**cfg_kw), **kw))


@pytest.mark.parametrize("name", list(STRATEGIES))
def test_variants_equal_jax_on_500_captions(name):
    kw = {"paraphrase_generator": StubParaphraser()} if name in ("paraphrase", "defaults") else {}
    if name == "back_translation":
        kw["translator"] = translator
    j, t = _pair(STRATEGIES[name], **kw)
    want = [j.generate_variants(c) for c in CAPTIONS]
    got = [t.generate_variants(c) for c in CAPTIONS]
    assert got == want
    assert sum(map(len, got)) > 0 and t.get_stats() == j.get_stats()
    assert list(t.strategies) == list(j.strategies)


def test_batched_variants_equal_jax_and_decode_only_uncached_texts():
    j_gen, t_gen = StubParaphraser(), StubParaphraser()
    j = JAugmenter(JConfig(), paraphrase_generator=j_gen)
    t = TextAugmenter(TextAugmentConfig(), paraphrase_generator=t_gen)
    first, second = CAPTIONS[:64], CAPTIONS[32:96]
    for texts in (first, second):
        handle = t.batch_generate_variants_async(texts, 5)
        assert callable(handle)
        assert handle() == j.batch_generate_variants_async(texts, 5)()
    # the second batch decoded only its 32 texts the first left uncached
    assert t_gen.decoded == [first, CAPTIONS[64:96]] == j_gen.decoded
    assert t.batch_generate_variants(first) == j.batch_generate_variants(first)
    assert t_gen.decoded[-1:] == [CAPTIONS[64:96]]  # nothing new: every text cached
    assert t.get_stats() == j.get_stats() and t.get_stats()["cache_hits"] == 32 + 64


def test_cache_hits_evictions_and_clear():
    j, t = _pair(dict(cache_size=4))
    texts = CAPTIONS[:6]
    for aug in (j, t):
        for c in texts:
            aug.generate_variants(c)
        aug.generate_variants(texts[5])  # a hit, moved to the tail
        aug.generate_variants(texts[0])  # evicted: recomputed, evicts texts[2]
    assert list(t._cache) == list(j._cache) and len(t._cache) == 4
    assert t.get_stats() == j.get_stats() and t.get_stats()["cache_hits"] == 1
    t.clear_cache()
    assert not t._cache
    assert t.generate_variants("") == [] and t.generate_variants("   ") == []
    assert t.augment is not None and TextAugmenter.augment is TextAugmenter.generate_variants


def test_lexicon_and_text_helpers_equal_jax():
    assert t_lex.STOPWORDS == j_lex.STOPWORDS and t_lex.BUILTIN_SYNONYMS == j_lex.BUILTIN_SYNONYMS
    words = sorted({w.lower() for c in CAPTIONS[:100] for w in c.split()})
    assert [t_lex.get_synonyms(w) for w in words] == [j_lex.get_synonyms(w) for w in words]
    assert t_lex.get_synonyms("man", 2) == ["guy", "male"] or t_lex._wordnet_corpus()
    from tvc.augment import is_valid_text as j_valid, normalize_text as j_norm

    for c in CAPTIONS[:100] + ["", "ab", "one", "two words", "x" * 1200]:
        assert is_valid_text(c) == j_valid(c) and normalize_text(c) == j_norm(c)
    assert isinstance(create_text_augmenter(TextAugmentConfig(seed=1)), TextAugmenter)


def test_clip_ranking_equals_jax():
    """A CLIP model ranks and band-filters the whole pool with one text
    encode; the port's encode returns a tensor, read back to numpy."""
    jm = JClip(JClipConfig.tiny(), seed=0)
    cfg = CLIPConfig.tiny()
    tm = CLIPModel(cfg, params=params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params), cfg), device="cpu")
    kw = dict(min_similarity_threshold=0.3, max_similarity_threshold=0.999)
    j = JAugmenter(JConfig(**kw), clip_model=jm)
    t = TextAugmenter(TextAugmentConfig(**kw), clip_model=tm)
    got = [t.generate_variants(c) for c in CAPTIONS[:12]]
    assert got == [j.generate_variants(c) for c in CAPTIONS[:12]]
    assert sum(map(len, got)) > 0


def test_generator_errors_propagate():
    """The JAX augmenter drops a paraphrase generator that raises; the
    port's lets the error through, so a failed decode is never served as
    host-only variants."""

    class Failing(StubParaphraser):
        def batch_async(self, texts, n):
            raise RuntimeError("decode failed")

        def __call__(self, text, n):
            raise RuntimeError("decode failed")

    cfg = dict(enable_template=False)
    j, t = _pair(cfg, paraphrase_generator=Failing())
    assert j.batch_generate_variants(CAPTIONS[:4]) == j.batch_generate_variants(CAPTIONS[:4])
    with pytest.raises(RuntimeError, match="decode failed"):
        t.batch_generate_variants(CAPTIONS[:4])
    with pytest.raises(RuntimeError, match="decode failed"):
        t.generate_variants(CAPTIONS[0])
    with pytest.raises(RuntimeError, match="decode failed"):
        TextAugmenter(TextAugmentConfig(**STRATEGIES["back_translation"]),
                      translator=lambda *a: Failing()("", 1)).generate_variants(CAPTIONS[0])
