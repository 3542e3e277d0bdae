"""The two byte-pair encodings, written out plainly for the reference:
CLIP's (lowercased, ``</w>`` word ends) and Qwen2's byte-level BPE. They
read the published vocabulary files bundled with the repository and agree
with the ``transformers`` tokenizers on the COCO captions."""

from __future__ import annotations

import functools
import json
import re
import sys
import unicodedata
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

from perfbench.common import ROOT

ASSETS = ROOT / "tvc" / "assets"


def bytes_to_unicode() -> Dict[int, str]:
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1)) + list(
        range(ord("\xae"), ord("\xff") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _merge(word: List[str], ranks: Dict) -> List[str]:
    """Merge the lowest-ranked adjacent pair, every occurrence left to
    right, until no ranked pair is left."""
    while len(word) > 1:
        best = min(range(len(word) - 1), key=lambda i: ranks.get((word[i], word[i + 1]), sys.maxsize))
        pair = (word[best], word[best + 1])
        if pair not in ranks:
            break
        out, i = [], 0
        while i < len(word):
            if i < len(word) - 1 and (word[i], word[i + 1]) == pair:
                out.append(word[i] + word[i + 1])
                i += 2
            else:
                out.append(word[i])
                i += 1
        word = out
    return word


class ClipBPE:
    """``[B, context]`` int32 rows: SOT, the BPE ids cut to context - 2, EOT,
    zero padding. EOT is the highest id."""

    PATTERN = re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\w]+|[^\s\w]+",
                         re.IGNORECASE)

    def __init__(self, context_length: int = 77, root: Path = ASSETS / "clip_tokenizer"):
        with open(root / "vocab.json", encoding="utf-8") as f:
            self.encoder = json.load(f)
        with open(root / "merges.txt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(p) for p in (ln.strip().split() for ln in lines) if len(p) == 2]
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.bytes = bytes_to_unicode()
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self.context = context_length
        self._cache: Dict[str, List[int]] = {}

    def _word(self, token: str) -> List[int]:
        ids = self._cache.get(token)
        if ids is None:
            word = _merge(list(token[:-1]) + [token[-1] + "</w>"], self.ranks)
            ids = self._cache[token] = [self.encoder.get(t, 0) for t in word]
        return ids

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in self.PATTERN.findall(text.lower().strip()):
            ids.extend(self._word("".join(self.bytes[b] for b in tok.encode("utf-8"))))
        return ids

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.context), np.int64)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode(t)[: self.context - 2] + [self.eot]
            out[i, : len(ids)] = ids
        return out


def _classes(categories: str) -> str:
    out, start, prev = [], None, None
    for cp in range(sys.maxunicode + 1):
        if unicodedata.category(chr(cp))[0] in categories:
            if start is None:
                start = cp
            prev = cp
        elif start is not None:
            out.append(f"\\U{start:08x}-\\U{prev:08x}" if prev > start else f"\\U{start:08x}")
            start = None
    if start is not None:
        out.append(f"\\U{start:08x}-\\U{prev:08x}")
    return "".join(out)


@functools.lru_cache(maxsize=1)
def _qwen_split() -> "re.Pattern":
    """Qwen2's pre-tokenizer: ``(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\\r\\n\\p{L}\\p{N}]?\\p{L}+|\\p{N}|
    ?[^\\s\\p{L}\\p{N}]+[\\r\\n]*|\\s*[\\r\\n]+|\\s+(?!\\S)|\\s+``."""
    L, N = _classes("L"), _classes("N")
    return re.compile(rf"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n{L}{N}]?[{L}]+|[{N}]| ?[^\s{L}{N}]+[\r\n]*"
                      rf"|\s*[\r\n]+|\s+(?!\S)|\s+")


class QwenBPE:
    """Qwen2's byte-level BPE: added tokens split out whole, NFC, the
    pre-tokenizer, merges by rank; no BOS or EOS added."""

    def __init__(self, root: Path = ASSETS / "qwen_tokenizer"):
        with open(root / "vocab.json", encoding="utf-8") as f:
            self.encoder = json.load(f)
        with open(root / "merges.txt", encoding="utf-8") as f:
            pairs = [ln.rstrip("\n").split(" ") for ln in f if not ln.startswith("#version")]
        self.ranks = {(p[0], p[1]): i for i, p in enumerate(pairs) if len(p) == 2}
        with open(root / "tokenizer_config.json", encoding="utf-8") as f:
            cfg = json.load(f)
        self.added = {t["content"]: int(i) for i, t in cfg.get("added_tokens_decoder", {}).items()}
        self.eos = self.added[cfg["eos_token"]]
        self._split = re.compile("(" + "|".join(re.escape(t) for t in sorted(self.added, key=len, reverse=True)) + ")")
        self.bytes = bytes_to_unicode()
        self._cache: Dict[str, List[int]] = {}

    def _piece(self, piece: str) -> List[int]:
        ids = self._cache.get(piece)
        if ids is None:
            ids = self._cache[piece] = [self.encoder[t] for t in _merge(list(piece), self.ranks)]
        return ids

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for j, seg in enumerate(self._split.split(text)):
            if j % 2:
                ids.append(self.added[seg])
                continue
            for piece in _qwen_split().findall(unicodedata.normalize("NFC", seg)):
                ids.extend(self._piece("".join(self.bytes[b] for b in piece.encode("utf-8"))))
        return ids
