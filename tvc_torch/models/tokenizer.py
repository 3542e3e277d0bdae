"""Text tokenizers for the CLIP text tower (port of ``tvc/models/tokenizer.py``).

* ``BPETokenizer`` — the published CLIP byte-pair encoding, reading the
  bundled ``vocab.json`` + ``merges.txt`` from ``tvc/assets/clip_tokenizer``
  (data files, read by path). Lowercased ASCII strings without special
  tokens go through the native C++ tokenizer (``tvc_torch.native``), the
  rest through Python, as the JAX package routes them; the ids are the
  same on both paths and equal the JAX package's.
* ``HashTokenizer`` — deterministic FNV-1a word hashing into the vocab
  (tiny test configs and any vocab without bundled assets).

Both produce right-padded int32 ``[B, context_length]`` with EOT as the
highest id, so CLIP's feature-at-argmax pooling holds.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

#: the JAX package's asset directory, read in place
ASSET_DIR = Path(__file__).resolve().parents[2] / "tvc" / "assets"

_BPE_PATTERN = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\w]+|[^\s\w]+",
    re.IGNORECASE,
)


def _fnv1a(word: str) -> int:
    h = 0xCBF29CE484222325
    for b in word.encode("utf-8"):
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class HashTokenizer:
    """Deterministic hash tokenizer (test / random-weight operation)."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77):
        if vocab_size < 8:
            raise ValueError("vocab_size too small")
        self.vocab_size = vocab_size
        self.context_length = context_length
        self.pad_id = 0
        self.sot_id = vocab_size - 2
        self.eot_id = vocab_size - 1

    def _word_ids(self, text: str) -> List[int]:
        words = "".join(ch if ch.isalnum() else " " for ch in text.lower()).split()
        span = self.sot_id - 1  # ids in [1, sot_id)
        return [1 + (_fnv1a(w) % span) for w in words]

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        out = np.full((len(texts), self.context_length), self.pad_id, dtype=np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot_id] + self._word_ids(t)[: self.context_length - 2] + [self.eot_id]
            out[i, : len(ids)] = ids
        return out


class BPETokenizer:
    """CLIP-style BPE over a merges file, with an HF ``vocab.json`` for the
    token -> id map or, without one, the vocab rebuilt OpenAI-style from
    byte units + merges."""

    def __init__(
        self,
        merges_path: str,
        vocab_size: int = 49408,
        context_length: int = 77,
        vocab_path: Optional[str] = None,
        native: bool = True,
    ):
        """``native=False``: every string through the Python path."""
        self.vocab_size = vocab_size
        self.context_length = context_length
        byte_list = self._bytes_to_unicode()
        with open(merges_path, "r", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(p) for p in (line.strip().split() for line in lines) if len(p) == 2]
        if vocab_path:
            with open(vocab_path, encoding="utf-8") as f:
                self.encoder: Dict[str, int] = json.load(f)
        else:
            vocab = list(byte_list.values())
            vocab.extend([v + "</w>" for v in vocab])
            merges = merges[: vocab_size - len(vocab) - 2]
            vocab.extend("".join(m) for m in merges)
            vocab.extend(["<|startoftext|>", "<|endoftext|>"])
            self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = byte_list
        self.sot_id = self.encoder["<|startoftext|>"]
        self.eot_id = self.encoder["<|endoftext|>"]
        self.pad_id = 0
        self._cache: Dict[str, List[str]] = {}
        self.native = native
        #: strings encoded by the native library (the tests read it)
        self.native_texts = 0
        if native:
            from tvc_torch import native as _native

            _native.bpe_init(self.encoder, self.bpe_ranks)

    @staticmethod
    def _bytes_to_unicode() -> Dict[int, str]:
        bs = (
            list(range(ord("!"), ord("~") + 1))
            + list(range(ord("\xa1"), ord("\xac") + 1))
            + list(range(ord("\xae"), ord("\xff") + 1))
        )
        cs = bs[:]
        n = 0
        for b in range(256):
            if b not in bs:
                bs.append(b)
                cs.append(256 + n)
                n += 1
        return dict(zip(bs, [chr(c) for c in cs]))

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            new_word = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        self._cache[token] = list(word)
        return list(word)

    def _encode_text(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in _BPE_PATTERN.findall(text.lower().strip()):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder.get(t, 0) for t in self._bpe(token))
        return ids

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        out = np.full((len(texts), self.context_length), self.pad_id, dtype=np.int32)
        rest = range(len(texts))
        if self.native:
            # the native library takes lowercased ASCII strings without
            # special tokens; the others keep the Python path
            lowered = [t.lower() for t in texts]
            fast = [i for i, t in enumerate(lowered) if t.isascii() and "<|" not in t]
            if fast:
                from tvc_torch import native as _native

                out[fast] = _native.bpe_encode_batch(
                    [lowered[i] for i in fast], self.context_length, self.sot_id, self.eot_id, self.pad_id
                )
                self.native_texts += len(fast)
                fast_set = set(fast)
                rest = [i for i in rest if i not in fast_set]
        for i in rest:
            ids = [self.sot_id] + self._encode_text(texts[i])[: self.context_length - 2] + [self.eot_id]
            out[i, : len(ids)] = ids
        return out


def get_tokenizer(
    vocab_size: int = 49408,
    context_length: int = 77,
    merges_path: Optional[str] = None,
) -> Callable[[Sequence[str]], np.ndarray]:
    """The real CLIP BPE for vocab 49408 (bundled assets, overridable by
    argument or ``$TVC_CLIP_BPE``); the hash tokenizer otherwise."""
    if vocab_size == 49408:
        merges_path = merges_path or os.environ.get("TVC_CLIP_BPE")
        if merges_path and os.path.exists(merges_path):
            vocab_json = Path(merges_path).parent / "vocab.json"
            return BPETokenizer(
                merges_path, vocab_size, context_length,
                vocab_path=str(vocab_json) if vocab_json.exists() else None,
            )
        bundled = ASSET_DIR / "clip_tokenizer"
        if (bundled / "merges.txt").exists():
            return BPETokenizer(
                str(bundled / "merges.txt"), vocab_size, context_length,
                vocab_path=str(bundled / "vocab.json"),
            )
    return HashTokenizer(vocab_size, context_length)
