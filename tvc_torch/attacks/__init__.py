"""Attacks (port of ``tvc/attacks``): so far the text attack's synonym lexicon."""

from tvc_torch.attacks.text_attack import BUILTIN_SYNONYMS, STOPWORDS, get_synonyms  # noqa: F401
