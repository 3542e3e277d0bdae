"""tvc_torch's Qwen2 byte-level BPE against the JAX package's tokenizer
(``HFTokenizerWrapper`` over ``transformers``, from the same bundled
files): ids, decoded text, the prompt-prefix split and the ASCII mask."""

import gzip
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from tvc.models import qwen as jqwen
from tvc.models import tokenizer as jtok
from tvc_torch.models import qwen as tqwen
from tvc_torch.models import tokenizer as ttok

ASSETS = Path(__file__).resolve().parent.parent / "tvc" / "assets"
ODD = [
    "", "Hello, World!!", "it's a dog's LIFE -- isn't it?  I'LL", "café crème brûlée 🍰 naïve",
    "Café (decomposed)", "<|im_start|>user\nhi<|im_end|><|endoftext|>x",
    "numbers 12345 and 3.14159 and tabs\tand\nnewlines\n\n  end  ", "a " * 60,
    "日本語のテキスト、中文文本。", "  leading and trailing   ", "x\r\n\r\ny", "emoji 👍🏽 ZWJ 👨‍👩‍👧",
    "١٢٣ ²³ Ⅻ", " nbsp em", "don'T 'Re 'VE", "$%^&*()_+{}|:\"<>?", "tab\t\t\tend",
]


@pytest.fixture(scope="module")
def toks():
    return jtok.get_tokenizer(151936, 128), ttok.get_tokenizer(151936, 128)


@pytest.fixture(scope="module")
def captions():
    with gzip.open(ASSETS / "coco_captions_val2017.json.gz", "rt") as f:
        return [c for _, c in json.load(f)]


def test_get_tokenizer_returns_the_qwen_bpe(toks, tmp_path, monkeypatch):
    hf, port = toks
    assert isinstance(port, ttok.QwenBPETokenizer)
    assert (port.pad_id, port.eot_id, port.sot_id) == (hf.pad_id, hf.eot_id, hf.sot_id) == (151643, 151645, 151645)
    assert len(port) == len(hf.tok) == 151646
    # $TVC_QWEN_TOKENIZER: a directory, or a merges.txt inside one
    for name in ("vocab.json", "merges.txt", "tokenizer_config.json"):
        (tmp_path / name).write_bytes((ASSETS / "qwen_tokenizer" / name).read_bytes())
    for where in (tmp_path, tmp_path / "merges.txt"):
        monkeypatch.setenv("TVC_QWEN_TOKENIZER", str(where))
        assert isinstance(ttok.get_tokenizer(151936, 16), ttok.QwenBPETokenizer)
    assert isinstance(ttok.get_tokenizer(512, 16), ttok.HashTokenizer)


def test_ids_equal_on_every_coco_caption(toks, captions):
    hf, port = toks
    np.testing.assert_array_equal(port(captions), hf(captions))


def test_ids_equal_on_prompts_and_odd_strings(toks, captions):
    hf, port = toks
    texts = ODD + [jqwen.PARAPHRASE_PROMPT.format(text=c) for c in captions[:200]]
    texts += [jqwen.TRANSLATE_PROMPT.format(src="English", dst=d, text=c) for d in ("German", "French")
              for c in captions[:50]]
    np.testing.assert_array_equal(port(texts), hf(texts))
    assert tqwen.PARAPHRASE_PROMPT == jqwen.PARAPHRASE_PROMPT and tqwen.TRANSLATE_PROMPT == jqwen.TRANSLATE_PROMPT


@pytest.mark.parametrize("prefix,template", [
    (tqwen.PARAPHRASE_PREFIX, tqwen.PARAPHRASE_PROMPT),
    (tqwen.TRANSLATE_PREFIX.format(src="English", dst="German"),
     tqwen.TRANSLATE_PROMPT.replace("{src}", "English").replace("{dst}", "German")),
])
def test_prefix_split_is_token_exact(toks, captions, prefix, template):
    """prefix ids + suffix ids == the whole prompt's ids, over real captions."""
    port = toks[1]
    pad = port.pad_id
    real = lambda r: r[: int((r != pad).sum())]
    pids = real(port([prefix])[0])
    fulls = [template.format(text=c) for c in captions[:500]]
    for full, f_ids, s_ids in zip(fulls, port(fulls), port([f[len(prefix):] for f in fulls])):
        np.testing.assert_array_equal(np.concatenate([pids, real(s_ids)]), real(f_ids), err_msg=full)
    assert len(pids) == 15 or prefix != tqwen.PARAPHRASE_PREFIX


def test_decode_equal(toks):
    hf, port = toks
    rng = np.random.default_rng(0)
    rows = [list(rng.integers(0, 151936, size=int(rng.integers(0, 40)))) for _ in range(200)]
    rows += [[40, 151900, 1000, 151645], [151643, 151644, 151645], [], [220, 220, 198, 151643, 9707]]
    rows += [list(rng.integers(0, 300, size=20)) for _ in range(50)]  # byte tokens: partial UTF-8
    assert port.decode_batch(rows) == hf.decode_batch(rows)
    assert [port.decode(r) for r in rows[:60]] == [hf.decode(r) for r in rows[:60]]
    assert port.decode([40, 151900, 1000, 151645]) == "Iatus"


def test_ascii_token_mask_equals_jax(toks):
    hf, port = toks
    cfg = SimpleNamespace(vocab_size=151936)
    want = jqwen.QwenModel.ascii_token_mask(SimpleNamespace(config=cfg, tokenizer=hf))
    got = tqwen.QwenModel.ascii_token_mask(SimpleNamespace(config=cfg, tokenizer=port))
    assert got.shape == (151936,) and got.dtype == bool
    np.testing.assert_array_equal(got, want)
    assert got[port.eot_id] and not got[151646:].any()
