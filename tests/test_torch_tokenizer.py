"""tvc_torch tokenizers and text bucketing against the JAX package: token
ids and bucket plans identical."""

import gzip
import json
from pathlib import Path

import numpy as np
import pytest

from tvc.models import clip as jclip
from tvc.models import tokenizer as jtok
from tvc_torch.models import clip as tclip
from tvc_torch.models import tokenizer as ttok

ASSETS = Path(__file__).resolve().parent.parent / "tvc" / "assets"
ODD = [
    "",
    "Hello, World!!",
    "it's a dog's life -- isn't it?",
    "café crème brûlée 🍰 naïve",
    "<|startoftext|> special tokens <|endoftext|>",
    "numbers 12345 and 3.14159 and tabs\tand\nnewlines",
    "a " * 60,
]


@pytest.fixture(scope="module")
def captions():
    with gzip.open(ASSETS / "coco_captions_val2017.json.gz", "rt") as f:
        pairs = json.load(f)
    return [c for _, c in pairs[:300]] + ODD


@pytest.mark.parametrize("context", [77, 32])
def test_bpe_ids_identical(captions, context):
    want = jtok.get_tokenizer(vocab_size=49408, context_length=context)
    got = ttok.get_tokenizer(vocab_size=49408, context_length=context)
    assert isinstance(got, ttok.BPETokenizer)
    assert (got.sot_id, got.eot_id, got.pad_id) == (want.sot_id, want.eot_id, want.pad_id)
    np.testing.assert_array_equal(got(captions), np.asarray(want(captions)))


@pytest.fixture(scope="module")
def captions_5000():
    with gzip.open(ASSETS / "coco_captions_val2017.json.gz", "rt") as f:
        return [c for _, c in json.load(f)[:5000]]


@pytest.fixture(scope="module")
def bpe_pair():
    jax_tok = jtok.get_tokenizer(vocab_size=49408, context_length=77)
    return jax_tok, ttok.get_tokenizer(vocab_size=49408, context_length=77)


def test_native_bpe_ids_identical_on_5000_coco_captions(bpe_pair, captions_5000):
    jax_tok, tok = bpe_pair
    assert tok.native
    before = tok.native_texts
    got = tok(captions_5000)
    assert tok.native_texts - before == sum(c.isascii() for c in captions_5000) > 4900
    np.testing.assert_array_equal(got, np.asarray(jax_tok(captions_5000)))


@pytest.mark.parametrize("context", [77, 32, 16])
def test_native_bpe_mixed_batches_route_per_string(bpe_pair, captions, context):
    """Non-ASCII and special-token strings keep the Python path inside a
    batch whose other strings go native; the ids match the pure-Python
    tokenizer and the JAX package's."""
    merges = ASSETS / "clip_tokenizer" / "merges.txt"
    vocab = ASSETS / "clip_tokenizer" / "vocab.json"
    tok = ttok.BPETokenizer(str(merges), 49408, context, vocab_path=str(vocab))
    plain = ttok.BPETokenizer(str(merges), 49408, context, vocab_path=str(vocab), native=False)
    batch = captions[:40] + ODD + ["A Dog <|endoftext|> runs", "CAPS and\x1cseparators", "naïve ÉCOLE"]
    got = tok(batch)
    n_python = sum(not (t.lower().isascii() and "<|" not in t.lower()) for t in batch)
    assert 0 < n_python < len(batch)
    assert tok.native_texts == len(batch) - n_python and plain.native_texts == 0
    np.testing.assert_array_equal(got, plain(batch))
    np.testing.assert_array_equal(got, np.asarray(jtok.get_tokenizer(vocab_size=49408, context_length=context)(batch)))


def test_hash_ids_identical_at_tiny(captions):
    want = jtok.get_tokenizer(vocab_size=512, context_length=16)
    got = ttok.get_tokenizer(vocab_size=512, context_length=16)
    assert isinstance(got, ttok.HashTokenizer)
    np.testing.assert_array_equal(got(captions), np.asarray(want(captions)))


def _rows(seed, S, T, dup_every=0):
    """S token rows of mixed real lengths (EOT = the highest id), some
    duplicated."""
    rng = np.random.default_rng(seed)
    out = np.zeros((S, T), np.int32)
    lens = np.where(rng.random(S) < 0.8, rng.integers(3, 14, S), rng.integers(15, T, S))
    for i, n in enumerate(lens):
        out[i, : n - 1] = rng.integers(1, 500, n - 1)
        out[i, n - 1] = 511
        if dup_every and i % dup_every == 0 and i:
            out[i] = out[i - 1]
    return out


@pytest.mark.parametrize(
    "seed,S,T,dedup,dup_every",
    [(0, 512, 32, False, 0), (1, 700, 32, True, 3), (2, 1024, 24, True, 0), (3, 600, 32, True, 2),
     (4, 100, 32, False, 0), (5, 512, 16, True, 0)],
)
def test_bucket_text_tokens_identical(seed, S, T, dedup, dup_every):
    rows = _rows(seed, S, T, dup_every)
    want = jclip.bucket_text_tokens(rows, dedup=dedup)
    got = tclip.bucket_text_tokens(rows, dedup=dedup)
    assert (got is None) == (want is None)
    if want is not None:
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
        # the plan restores the input order
        enc = np.concatenate([np.pad(got["short"], ((0, 0), (0, T - got["short"].shape[1]))), got["long"]])
        np.testing.assert_array_equal(enc[got["inv"]], rows)
