"""The synonym lexicon of the text attack (port of the lexicon half of
``tvc/attacks/text_attack.py``: ``STOPWORDS``, ``BUILTIN_SYNONYMS``, the
lazily probed WordNet corpus and ``get_synonyms``), which the text
augmenter's synonym strategy draws from. The attack itself comes with the
attacks slice.

WordNet synonyms are gated on the NLTK corpus being present, probed once
at the first lookup (never at import); without it the built-in table
serves, so every code path runs without downloads.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

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
