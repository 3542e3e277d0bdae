"""The text attack (port of ``tvc/attacks/text_attack.py``): the synonym
lexicon (``STOPWORDS``, ``BUILTIN_SYNONYMS``, the lazily probed WordNet
corpus and ``get_synonyms``), which the text augmenter's synonym strategy
draws from too, and the TextFooler-style attacker: word importance by
deletion, then greedy synonym substitution under a word budget, each
round's candidates scored in one batched text encode.

WordNet synonyms are gated on the NLTK corpus being present, probed once
at the first lookup (never at import); without it the built-in table
serves, so every code path runs without downloads.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

STOPWORDS = {
    "a", "an", "the", "is", "are", "was", "were", "be", "been", "being",
    "of", "in", "on", "at", "to", "for", "with", "by", "from", "and", "or",
    "but", "not", "no", "this", "that", "these", "those", "it", "its",
}

# built-in fallback synonym table (used when WordNet data is unavailable)
BUILTIN_SYNONYMS: Dict[str, List[str]] = {
    "man": ["guy", "male", "gentleman", "person"],
    "woman": ["lady", "female", "person"],
    "dog": ["canine", "puppy", "hound"],
    "cat": ["feline", "kitten", "kitty"],
    "car": ["automobile", "vehicle", "auto"],
    "big": ["large", "huge", "giant", "enormous"],
    "small": ["little", "tiny", "miniature"],
    "fast": ["quick", "rapid", "speedy"],
    "slow": ["sluggish", "unhurried"],
    "happy": ["glad", "joyful", "cheerful"],
    "sad": ["unhappy", "sorrowful"],
    "walk": ["stroll", "amble", "march"],
    "run": ["sprint", "dash", "jog"],
    "eat": ["consume", "devour"],
    "look": ["gaze", "stare", "glance"],
    "street": ["road", "avenue", "lane"],
    "house": ["home", "residence", "dwelling"],
    "child": ["kid", "youngster"],
    "picture": ["photo", "image", "photograph"],
    "beautiful": ["pretty", "lovely", "gorgeous"],
    "old": ["aged", "elderly", "ancient"],
    "young": ["youthful", "juvenile"],
    "red": ["crimson", "scarlet"],
    "blue": ["azure", "navy"],
    "table": ["desk", "counter"],
    "sit": ["rest", "perch"],
    "stand": ["rise", "pose"],
    "hold": ["grip", "grasp", "clutch"],
    "play": ["frolic", "sport"],
    "ride": ["mount", "cycle"],
}


#: resolved ONCE: None = not probed yet, False = corpus unavailable,
#: otherwise the loaded wordnet corpus reader. nltk's LazyCorpusLoader
#: re-probes the whole data path on EVERY access when the corpus is
#: missing (~70 stat() calls per word — measured 4 ms/query of pure
#: filesystem probing in the zero-egress image), so the failure must be
#: cached, not rediscovered per lookup.
_WORDNET: object = None


def _wordnet_corpus():
    global _WORDNET
    if _WORDNET is None:
        try:
            from nltk.corpus import wordnet

            wordnet.synsets("test")  # force the lazy load exactly once
            _WORDNET = wordnet
        except Exception:  # corpus unavailable / import error
            _WORDNET = False
    return _WORDNET


def _wordnet_synonyms(word: str, max_count: int) -> List[str]:
    """WordNet synonyms, gated on corpus availability."""
    wordnet = _wordnet_corpus()
    if not wordnet:
        return []
    try:
        synonyms = []
        for syn in wordnet.synsets(word):
            for lemma in syn.lemmas():
                name = lemma.name().replace("_", " ").lower()
                if name != word and name.isalpha() and name not in synonyms:
                    synonyms.append(name)
        return synonyms[:max_count]
    except Exception:
        return []


@functools.lru_cache(maxsize=65536)
def _synonyms_cached(word: str, max_count: int) -> Tuple[str, ...]:
    syns = _wordnet_synonyms(word, max_count)
    if syns:
        return tuple(syns)
    return tuple(BUILTIN_SYNONYMS.get(word, ())[:max_count])


def get_synonyms(word: str, max_count: int = 10) -> List[str]:
    return list(_synonyms_cached(word, max_count))


@dataclasses.dataclass(frozen=True)
class TextAttackConfig:
    """(reference src/attacks/text_attack.py:45-86)"""

    max_perturbation_ratio: float = 0.3  # fraction of words replaceable
    num_synonyms: int = 10
    min_word_length: int = 3
    preserve_stopwords: bool = True
    min_text_similarity: float = 0.7  # perturbed text must stay this close
    success_threshold: float = 0.3  # sim(image, text) below => success
    attack_method: str = "textfooler"  # textfooler | synonym_replacement


@dataclasses.dataclass
class TextAttackResult:
    adv_texts: List[str]
    original_texts: List[str]
    success: np.ndarray
    final_similarity: np.ndarray
    num_words_changed: np.ndarray
    info: dict = dataclasses.field(default_factory=dict)

    @property
    def success_rate(self) -> float:
        return float(np.mean(self.success)) if self.success.size else 0.0


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


class TextAttacker:
    """Per (image, caption): perturb the caption with synonyms until the
    CLIP similarity to the image drops below ``success_threshold``, keeping
    each candidate within ``min_text_similarity`` of the original text."""

    def __init__(self, model, config: Optional[TextAttackConfig] = None):
        self.model = model
        self.config = config or TextAttackConfig()

    # -- scoring (batched on device) ----------------------------------------
    def _sims(self, texts: Sequence[str], image_feat: np.ndarray) -> np.ndarray:
        return _np(self.model.encode_text(list(texts))) @ image_feat

    def _replaceable(self, words: List[str]) -> List[int]:
        idxs = []
        for i, w in enumerate(words):
            if len(w) < self.config.min_word_length:
                continue
            if self.config.preserve_stopwords and w.lower() in STOPWORDS:
                continue
            idxs.append(i)
        return idxs

    def attack_single(self, image, text: str) -> Tuple[str, dict]:
        cfg = self.config
        image_feat = _np(self.model.encode_image(image if isinstance(image, (list, np.ndarray)) else [image]))[0]
        words = text.split()
        candidates_idx = self._replaceable(words)
        if not candidates_idx:
            sim = float(self._sims([text], image_feat)[0])
            return text, {"similarity": sim, "changed": 0}

        orig_text_feat = _np(self.model.encode_text([text]))[0]
        orig_sim = float(self._sims([text], image_feat)[0])

        # 1. word importance: similarity drop when the word is deleted —
        #    ALL deletion variants scored in ONE batched encode
        deleted = [" ".join(words[:i] + words[i + 1:]) for i in candidates_idx]
        del_sims = self._sims(deleted, image_feat)
        importance = orig_sim - del_sims  # high drop = important word
        order = [candidates_idx[j] for j in np.argsort(-importance)]

        # 2. greedy substitution under budget
        budget = max(1, int(len(words) * cfg.max_perturbation_ratio))
        current = list(words)
        current_sim = orig_sim
        changed = 0
        for i in order:
            if changed >= budget:
                break
            syns = get_synonyms(words[i].lower(), cfg.num_synonyms)
            if not syns:
                continue
            variants = []
            for s in syns:
                cand = list(current)
                cand[i] = s
                variants.append(" ".join(cand))
            # batch-score all candidate sentences at once
            cand_sims = self._sims(variants, image_feat)
            cand_tfeats = _np(self.model.encode_text(variants))
            text_sims = cand_tfeats @ orig_text_feat
            valid = text_sims >= cfg.min_text_similarity
            if not np.any(valid):
                continue
            scores = np.where(valid, cand_sims, np.inf)
            best = int(np.argmin(scores))
            if cand_sims[best] < current_sim:
                current[i] = syns[best]
                current_sim = float(cand_sims[best])
                changed += 1
                if current_sim < cfg.success_threshold:
                    break

        return " ".join(current), {
            "similarity": current_sim,
            "original_similarity": orig_sim,
            "changed": changed,
        }

    def attack(self, images, texts: Sequence[str]) -> TextAttackResult:
        t0 = time.time()
        adv_texts, sims, changed = [], [], []
        img_list = images if isinstance(images, (list, tuple)) else list(images)
        for image, text in zip(img_list, texts):
            adv, info = self.attack_single(image, text)
            adv_texts.append(adv)
            sims.append(info["similarity"])
            changed.append(info["changed"])
        sims = np.asarray(sims)
        return TextAttackResult(
            adv_texts=adv_texts,
            original_texts=list(texts),
            success=sims < self.config.success_threshold,
            final_similarity=sims,
            num_words_changed=np.asarray(changed),
            info={"elapsed": time.time() - t0},
        )

    batch_attack = attack


def create_text_attacker(model, config: Optional[TextAttackConfig] = None) -> TextAttacker:
    return TextAttacker(model, config)
