"""Text tokenizers for the CLIP text tower and the Qwen2 LM (port of
``tvc/models/tokenizer.py``).

* ``BPETokenizer`` — the published CLIP byte-pair encoding, reading the
  bundled ``vocab.json`` + ``merges.txt`` from ``tvc/assets/clip_tokenizer``
  (data files, read by path). Lowercased ASCII strings without special
  tokens go through the native C++ tokenizer (``tvc_torch.native``), the
  rest through Python, as the JAX package routes them; the ids are the
  same on both paths and equal the JAX package's.
* ``QwenBPETokenizer`` — the Qwen2 byte-level BPE from the bundled
  ``tvc/assets/qwen_tokenizer`` files, in pure Python: the port's
  counterpart of the JAX package's ``HFTokenizerWrapper`` (which needs
  ``transformers``), with the same ids and the same decoded text.
* ``CutQwenBPETokenizer`` — that BPE cut to DeepSeek-V2's vocabulary of
  102,400 with its BOS / EOS ids, which stands in for DeepSeek-V2's own
  tokenizer (its files are not in the repository).
* ``HashTokenizer`` — deterministic FNV-1a word hashing into the vocab
  (tiny test configs and any vocab without bundled assets).

All produce right-padded int32 ``[B, context_length]``. For CLIP, EOT is
the highest id, so CLIP's feature-at-argmax pooling holds.
"""

from __future__ import annotations

import functools
import json
import os
import re
import sys
import unicodedata
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


def _class_ranges(categories: str) -> str:
    r"""The code points whose Unicode general category starts with one of
    ``categories``, as the inside of a ``re`` character class (``\p{L}``
    for "L"; ``re`` has no property classes)."""
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
def _qwen_pretokenizer() -> "re.Pattern":
    """The Qwen2 pre-tokenizer split, built from ``unicodedata``:
    ``(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\\r\\n\\p{L}\\p{N}]?\\p{L}+|\\p{N}|
    ?[^\\s\\p{L}\\p{N}]+[\\r\\n]*|\\s*[\\r\\n]+|\\s+(?!\\S)|\\s+``."""
    L, N = _class_ranges("L"), _class_ranges("N")
    return re.compile(
        rf"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n{L}{N}]?[{L}]+|[{N}]| ?[^\s{L}{N}]+[\r\n]*"
        rf"|\s*[\r\n]+|\s+(?!\S)|\s+"
    )


class QwenBPETokenizer:
    """The Qwen2 tokenizer as ``transformers`` builds it from the bundled
    ``vocab.json`` / ``merges.txt`` / ``tokenizer_config.json``: the added
    tokens split out whole, NFC normalization, the Qwen2 pre-tokenizer
    split, byte-level BPE by merge rank. ``__call__(texts)`` gives
    right-padded int32 ``[B, context_length]`` (no BOS / EOS added);
    ``pad_id`` is ``<|endoftext|>``, ``eot_id`` ``<|im_end|>`` and, as the
    config has no BOS, ``sot_id`` the EOS too."""

    def __init__(self, path: str, context_length: int = 512):
        root = Path(path)
        with open(root / "vocab.json", encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        with open(root / "merges.txt", encoding="utf-8") as f:
            pairs = [line.rstrip("\n").split(" ") for line in f if not line.startswith("#version")]
        self.bpe_ranks = {(p[0], p[1]): i for i, p in enumerate(pairs) if len(p) == 2}
        with open(root / "tokenizer_config.json", encoding="utf-8") as f:
            config = json.load(f)
        #: added tokens (id -> text), split out before normalization
        self.added = {int(i): t["content"] for i, t in config.get("added_tokens_decoder", {}).items()}
        self.special_ids = {
            int(i) for i, t in config.get("added_tokens_decoder", {}).items() if t.get("special")
        }
        self._added_ids = added_ids = {t: i for i, t in self.added.items()}
        self.decoder = {i: t for t, i in self.encoder.items()}
        self.decoder.update(self.added)
        self.context_length = context_length
        self.eot_id = added_ids[config["eos_token"]]
        self.pad_id = added_ids[config["pad_token"]] if config.get("pad_token") else self.eot_id
        self.sot_id = added_ids[config["bos_token"]] if config.get("bos_token") else self.eot_id
        self.vocab_size = len(self)
        self.byte_encoder = BPETokenizer._bytes_to_unicode()
        self.byte_decoder = {c: b for b, c in self.byte_encoder.items()}
        self._added_split = re.compile(
            "(" + "|".join(re.escape(t) for t in sorted(added_ids, key=len, reverse=True)) + ")"
        )
        self._cache: Dict[str, List[int]] = {}

    def __len__(self) -> int:
        return len(self.decoder)

    def _bpe(self, piece: str) -> List[int]:
        """Byte-level BPE of one pre-token (its bytes as byte-level
        characters): merge the lowest-ranked adjacent pair, every
        occurrence left to right, until no ranked pair is left."""
        ids = self._cache.get(piece)
        if ids is not None:
            return ids
        word = list(piece)
        ranks = self.bpe_ranks
        while len(word) > 1:
            best = min(range(len(word) - 1), key=lambda i: ranks.get((word[i], word[i + 1]), sys.maxsize))
            first, second = word[best], word[best + 1]
            if (first, second) not in ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        ids = [self.encoder[t] for t in word]
        self._cache[piece] = ids
        return ids

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        pattern = _qwen_pretokenizer()
        for j, segment in enumerate(self._added_split.split(text)):
            if j % 2:  # an added token, matched whole
                ids.append(self._added_ids[segment])
                continue
            for piece in pattern.findall(unicodedata.normalize("NFC", segment)):
                ids.extend(self._bpe("".join(self.byte_encoder[b] for b in piece.encode("utf-8"))))
        return ids

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        out = np.full((len(texts), self.context_length), self.pad_id, dtype=np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t)[: self.context_length]
            out[i, : len(ids)] = ids
        return out

    def _text(self, ids: Sequence[int], skip_special: bool) -> str:
        """Byte-level decode; ids outside the vocabulary are skipped (as
        ``transformers`` does: random weights sample ids up to the model's
        padded vocab), invalid UTF-8 becomes U+FFFD."""
        out = bytearray()
        for i in ids:
            tok = self.decoder.get(int(i))
            if tok is None or (skip_special and int(i) in self.special_ids):
                continue
            if int(i) in self.added:
                out += tok.encode("utf-8")
            else:
                out += bytes(self.byte_decoder[c] for c in tok)
        return out.decode("utf-8", errors="replace")

    def decode(self, ids: Sequence[int]) -> str:
        return self._text([i for i in ids if int(i) != self.pad_id], skip_special=True)

    def decode_batch(self, ids_batch) -> List[str]:
        return [self.decode(row) for row in ids_batch]

    def token_texts(self, n: int) -> List[str]:
        """The text of each id below ``n`` alone, special tokens kept."""
        return [self._text([i], skip_special=False) for i in range(n)]


#: the real Qwen2 tokenizer's vocab size (bundled assets)
QWEN2_VOCAB = 151936

#: DeepSeek-V2's vocabulary and its BOS / EOS ids
DEEPSEEK_V2_VOCAB, DEEPSEEK_V2_BOS, DEEPSEEK_V2_EOS = 102400, 100000, 100001
#: Kimi-Linear's vocabulary and the BOS / EOS ids the port gives it, above
#: the bundled Qwen2 BPE's range
KIMI_LINEAR_VOCAB, KIMI_LINEAR_BOS, KIMI_LINEAR_EOS = 163840, 163584, 163585
#: Nemotron-H's vocabulary and the BOS / EOS ids the port gives it, its
#: last two rows
NEMOTRON_H_VOCAB, NEMOTRON_H_BOS, NEMOTRON_H_EOS = 131072, 131070, 131071


class CutQwenBPETokenizer(QwenBPETokenizer):
    """The Qwen2 byte-level BPE cut to ids below 100,000: every merge whose
    result has an id at or above it dropped, no added tokens split out, a
    BOS prepended to every text. It stands in for DeepSeek-V2's own
    tokenizer (vocabulary 102,400, BOS 100,000, EOS 100,001), whose files
    the repository does not hold; ``without_bos`` tokenizes without the BOS
    (a prompt's suffix after a shared prefix)."""

    #: ids at or above CUT dropped (None: the BPE kept whole); BOS and EOS
    CUT, BOS, EOS = DEEPSEEK_V2_BOS, DEEPSEEK_V2_BOS, DEEPSEEK_V2_EOS
    BOS_TEXT, EOS_TEXT = "<\uff5cbegin\u2581of\u2581sentence\uff5c>", "<\uff5cend\u2581of\u2581sentence\uff5c>"

    def __init__(self, path: str, context_length: int = 512):
        super().__init__(path, context_length)
        cut, bos, eos = self.CUT, self.BOS, self.EOS
        if cut is not None:
            self.bpe_ranks = {p: r for p, r in self.bpe_ranks.items() if self.encoder.get(p[0] + p[1], cut) < cut}
            self.encoder = {t: i for t, i in self.encoder.items() if i < cut}
        self.added = {bos: self.BOS_TEXT, eos: self.EOS_TEXT}
        self.special_ids = {bos, eos}
        self._added_ids = {}
        self._added_split = re.compile("((?!))")  # nothing is split out
        self.decoder = {i: t for t, i in self.encoder.items()}
        self.decoder.update(self.added)
        self.sot_id = self.bos_id = bos
        self.eot_id = self.pad_id = eos
        self.vocab_size = len(self)
        self._cache = {}

    def _rows(self, texts: Sequence[str], bos: bool) -> np.ndarray:
        out = np.full((len(texts), self.context_length), self.pad_id, dtype=np.int32)
        head = [self.bos_id] if bos else []
        for i, t in enumerate(texts):
            ids = (head + self.encode(t))[: self.context_length]
            out[i, : len(ids)] = ids
        return out

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        return self._rows(texts, True)

    def without_bos(self, texts: Sequence[str]) -> np.ndarray:
        return self._rows(texts, False)


class KimiQwenBPETokenizer(CutQwenBPETokenizer):
    """The Qwen2 byte-level BPE kept whole (its regular vocabulary, ids
    below 151,643), no added tokens split out, BOS 163,584 opening every
    text and EOS 163,585: it stands in for Kimi-Linear's own tokenizer
    (vocabulary 163,840), whose files the repository does not hold."""

    CUT, BOS, EOS = None, KIMI_LINEAR_BOS, KIMI_LINEAR_EOS
    BOS_TEXT, EOS_TEXT = "[BOS]", "[EOS]"


class NemotronQwenBPETokenizer(CutQwenBPETokenizer):
    """The Qwen2 byte-level BPE cut to ids below 131,070, no added tokens
    split out, BOS 131,070 opening every text and EOS 131,071, the last two
    of the 131,072 rows: it stands in for Nemotron-H's own tokenizer, whose
    files the repository does not hold."""

    CUT, BOS, EOS = NEMOTRON_H_BOS, NEMOTRON_H_BOS, NEMOTRON_H_EOS
    BOS_TEXT, EOS_TEXT = "<s>", "</s>"


def get_tokenizer(
    vocab_size: int = 49408,
    context_length: int = 77,
    merges_path: Optional[str] = None,
) -> Callable[[Sequence[str]], np.ndarray]:
    """The real CLIP BPE for vocab 49408 (bundled assets, overridable by
    argument or ``$TVC_CLIP_BPE``); the Qwen2 BPE for vocab 151936
    (``merges_path`` or ``$TVC_QWEN_TOKENIZER``, a directory or a
    ``merges.txt`` in one, then the bundled assets); for DeepSeek-V2's
    vocab 102400 the Qwen2 BPE cut to it (``CutQwenBPETokenizer``, from
    ``merges_path`` or the bundled assets); for Kimi-Linear's vocab 163840
    the Qwen2 BPE whole with BOS / EOS above it (``KimiQwenBPETokenizer``);
    for Nemotron-H's vocab 131072 the Qwen2 BPE cut below its last two rows
    (``NemotronQwenBPETokenizer``); the hash tokenizer otherwise."""
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
    if vocab_size == QWEN2_VOCAB:
        for cand in (merges_path or os.environ.get("TVC_QWEN_TOKENIZER"), ASSET_DIR / "qwen_tokenizer"):
            if not cand:
                continue
            p = Path(cand)
            if p.is_file():  # a merges.txt path: use its directory
                p = p.parent
            if (p / "vocab.json").exists():
                return QwenBPETokenizer(str(p), context_length)
    cut_kinds = {DEEPSEEK_V2_VOCAB: CutQwenBPETokenizer, KIMI_LINEAR_VOCAB: KimiQwenBPETokenizer,
                 NEMOTRON_H_VOCAB: NemotronQwenBPETokenizer}
    if vocab_size in cut_kinds:
        kind = cut_kinds[vocab_size]
        for cand in (merges_path, ASSET_DIR / "qwen_tokenizer"):
            p = Path(cand) if cand else None
            if p is not None and p.is_file():
                p = p.parent
            if p is not None and (p / "vocab.json").exists():
                return kind(str(p), context_length)
    return HashTokenizer(vocab_size, context_length)
