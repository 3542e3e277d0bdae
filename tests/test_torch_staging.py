"""``tvc_torch.core.staging``: the pinned stager of the serving step's pixel
upload, and the serving step and detector that use it.

On the CPU a stager takes the plain copy; the tests that drive its worker
and buffer here set ``engaged`` on a stager of their own, which runs the
same code minus the pinning, the copy stream and the events. The ``cuda``
tests hold the staged int8 ViT-B/32 step to the step on pixels already on
the card, bit for bit, and run on the card with:

    python -m pytest --noconftest -m cuda tests/test_torch_staging.py
"""

import dataclasses
import gzip
import json
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from tvc_torch.core import staging
from tvc_torch.detector import AdversarialDetector, DetectorConfig
from tvc_torch.models.clip import CLIPConfig, CLIPModel
from tvc_torch.parallel.steps import make_serving_step
from tvc_torch.retrieval import MultiModalRetriever
from tvc_torch.utils import tracing

ASSETS = Path(__file__).resolve().parent.parent / "tvc" / "assets"
KEYS = ("is_adversarial", "aggregated", "tv_score", "sd_score", "consistency_score",
        "orig_similarity", "variant_mean", "variant_std", "ref_idx", "img")


def _delta(before, names=("upload.staged", "upload.staged_bytes", "upload.fallback")):
    now = tracing.counters()
    return {n: now.get(n, 0) - before.get(n, 0) for n in names}


@pytest.fixture
def engaged():
    """A CPU stager whose host arrays go through its worker and buffer."""
    st = staging.PinnedStager("cpu")
    st.engaged = True
    yield st
    st.close()


def _captions(n):
    with gzip.open(ASSETS / "coco_captions_val2017.json.gz", "rt") as f:
        return [c for _, c in json.load(f)[:n]]


# -- the stager ---------------------------------------------------------------------------
def test_cpu_device_takes_the_plain_copy_and_counts_it():
    st = staging.stager("cpu")
    assert not st.engaged
    x = np.random.default_rng(0).random((3, 4, 4, 3)).astype(np.float32)
    before = tracing.counters()
    up = st.start(x)
    assert torch.equal(up.wait(), torch.as_tensor(x)) and up.shape == x.shape
    assert _delta(before) == {"upload.staged": 0, "upload.staged_bytes": 0, "upload.fallback": 1}
    t = torch.as_tensor(x)
    before = tracing.counters()
    assert st.start(t).wait() is t  # already on the device: passed through, not counted
    assert _delta(before) == {"upload.staged": 0, "upload.staged_bytes": 0, "upload.fallback": 0}
    assert st._worker is None and st.allocations == 0


def test_staged_bytes_are_the_input(engaged):
    rng = np.random.default_rng(1)
    x = rng.random((5, 6, 7, 3)).astype(np.float32)
    before = tracing.counters()
    got = engaged.start(x).wait()
    assert torch.equal(got, torch.as_tensor(x)) and got.dtype == torch.float32
    assert _delta(before) == {"upload.staged": 1, "upload.staged_bytes": x.nbytes, "upload.fallback": 0}
    x[:] = 0  # the upload owns its bytes: nothing aliases the caller's array or the buffer
    assert not torch.equal(got, torch.as_tensor(x))
    # another dtype is staged as it lies and converted on the device
    x64 = rng.random((2, 3)).astype(np.float64)
    assert torch.equal(engaged.start(x64).wait(), torch.as_tensor(x64, dtype=torch.float32))


@pytest.mark.parametrize("view", ["strided", "transposed", "reversed", "read_only", "cpu_tensor"])
def test_non_contiguous_and_other_host_inputs(engaged, view):
    base = np.random.default_rng(2).random((8, 6, 5, 3)).astype(np.float32)
    x = {
        "strided": base[::2, :, 1:4],
        "transposed": base.transpose(1, 0, 2, 3),
        "reversed": base[::-1],
        "read_only": np.broadcast_to(base[:1], base.shape),
        "cpu_tensor": torch.as_tensor(base).permute(2, 1, 0, 3),
    }[view]
    want = torch.as_tensor(np.ascontiguousarray(np.asarray(x)))
    got = engaged.start(x).wait()
    assert got.shape == want.shape and torch.equal(got, want)


def test_the_buffer_grows_and_is_reused(engaged):
    rng = np.random.default_rng(3)
    small, big = rng.random((16, 8, 8, 3)).astype(np.float32), rng.random((64, 8, 8, 3)).astype(np.float32)
    for x, allocations in ((small, 1), (big, 2), (big, 2), (small, 2), (big, 2)):
        assert torch.equal(engaged.start(x).wait(), torch.as_tensor(x))
        assert engaged.allocations == allocations
    assert engaged._buf.numel() == 1 << (big.nbytes - 1).bit_length()


def test_over_the_cap_takes_the_plain_copy(engaged, monkeypatch):
    monkeypatch.setattr(staging, "CAP_BYTES", 64)
    x = np.arange(32, dtype=np.float32)
    before = tracing.counters()
    assert torch.equal(engaged.start(x).wait(), torch.as_tensor(x))
    assert _delta(before) == {"upload.staged": 0, "upload.staged_bytes": 0, "upload.fallback": 1}
    assert engaged.allocations == 0
    assert torch.equal(engaged.start([1.0, 2.0]).wait(), torch.tensor([1.0, 2.0]))  # a list is a host array
    assert _delta(before) == {"upload.staged": 1, "upload.staged_bytes": 16, "upload.fallback": 1}


def test_a_failed_upload_raises_in_wait(engaged, monkeypatch):
    def refuse(nbytes):
        raise RuntimeError("no buffer")

    monkeypatch.setattr(engaged, "_buffer", refuse)
    up = engaged.start(np.ones((2, 2), np.float32))
    with pytest.raises(RuntimeError, match="no buffer"):
        up.wait()
    monkeypatch.undo()
    assert torch.equal(engaged.start(np.ones((2, 2), np.float32)).wait(), torch.ones(2, 2))  # the worker lives on


def test_threads_staging_at_once_get_their_own_bytes(engaged):
    n_threads, each = 12, 15
    errors, old = [], sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def work(k):
            try:
                for j in range(each):
                    x = np.full((4 + k % 3, 16, 16, 3), k * 1000 + j, np.float32)
                    ups = [engaged.start(x), engaged.start(x + 0.5)]
                    got = [u.wait() for u in ups[::-1]][::-1]
                    if not (torch.equal(got[0], torch.as_tensor(x)) and torch.equal(got[1], torch.as_tensor(x + 0.5))):
                        errors.append((k, j))
            except Exception as e:  # reported below
                errors.append(e)

        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


# -- the serving step and the detector ------------------------------------------------------
@pytest.fixture(scope="module")
def int8_tiny():
    """The tiny_coco int8 model (seeded weights), its int8 weights, and one
    batch of serving inputs whose text rows take the bucketed program."""
    cfg = dataclasses.replace(CLIPConfig.tiny_coco(), fused_attention=True, int8_serving=True)
    model = CLIPModel(cfg, seed=0, device="cpu")
    B, V = 128, 3
    caps = _captions(B * (V + 1))
    rng = np.random.default_rng(4)
    bank = rng.standard_normal((40, cfg.embed_dim)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    d = dict(
        pixels=rng.random((B, 32, 32, 3)).astype(np.float32),
        tokens=np.asarray(model.tokenize(caps[:B])),
        vtok=np.asarray(model.tokenize(caps[B:])).reshape(B, V, -1),
        vmask=rng.random((B, V)) > 0.2, bank=bank, valid=np.ones(40, bool),
        weights=np.asarray([0.4, 0.4, 0.2], np.float32),
    )
    return model, model.qparams(), d


def _serve(step, model, d, pixels, tokens, vtok):
    return step(model.params, pixels, tokens, vtok, d["vmask"], d["bank"], d["valid"], d["weights"],
                np.float32(-np.inf), np.float32(0.5))


@pytest.mark.parametrize("bucketed", [True, False])
def test_step_outputs_equal_for_every_form_of_pixels(int8_tiny, engaged, bucketed):
    model, qp, d = int8_tiny
    step = make_serving_step(model, top_k=5, num_refs=3, qparams=qp, device="cpu")
    # host tokens take the bucketed program; tensor tokens the single batch
    tok, vtok = (d["tokens"], d["vtok"]) if bucketed else (torch.as_tensor(d["tokens"]), torch.as_tensor(d["vtok"]))
    want = _serve(step, model, d, d["pixels"], tok, vtok)
    forms = {
        "tensor": torch.as_tensor(d["pixels"]),
        "handle": engaged.start(d["pixels"]),
        "plain handle": staging.stager("cpu").start(d["pixels"]),
    }
    for name, px in forms.items():
        got = _serve(step, model, d, px, tok, vtok)
        for k in KEYS:
            assert torch.equal(got[k], want[k]), (name, k)
    assert step.bucketed_calls == (4 if bucketed else 0)


def test_upload_spans_are_children_of_the_detect_batch(monkeypatch, engaged):
    model = CLIPModel(CLIPConfig.tiny(), seed=0, device="cpu")
    retriever = MultiModalRetriever(model)
    retriever.build_image_index(embeddings=np.random.default_rng(5).standard_normal((20, 32)).astype(np.float32))
    det = AdversarialDetector(model, DetectorConfig(num_text_variants=3), retriever=retriever, device="cpu")
    images = np.random.default_rng(6).random((4, 32, 32, 3)).astype(np.float32)
    texts = ["a dog", "a cat on a mat", "two birds", "a boat"]
    want = det.detect_batch(images, texts)
    monkeypatch.setitem(staging._STAGERS, torch.device("cpu"), engaged)
    since = tracing.counters()
    got = det.detect_batch(images, texts)
    np.testing.assert_array_equal(got.aggregated_score, want.aggregated_score)
    assert _delta(since) == {"upload.staged": 1, "upload.staged_bytes": images.nbytes, "upload.fallback": 0}
    spans = tracing.spans()
    batch = [s for s in spans if s.name == "detect.batch"][-1]
    mine = [s for s in spans if s.parent == batch.id]
    waits = [s for s in mine if s.name == "detect.upload_wait"]
    uploads = [s for s in mine if s.name == "detect.upload"]
    assert len(waits) == len(uploads) == 1 and uploads[0].attrs == {"bytes": images.nbytes}
    assert waits[0].tid == batch.tid != uploads[0].tid
    step = next(s for s in mine if s.name == "detect.step")
    assert step.t0 <= waits[0].t0 <= waits[0].t1 <= step.t1  # blocks inside the step, counted to the batch
    # the texts tokenized, the pixels staged, then the tokens
    assert [s.name for s in mine if s.name in ("detect.stage", "detect.tokenize")] == [
        "detect.tokenize", "detect.stage", "detect.stage"]


# -- on the card --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def card_step():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the pinned buffer, the copy stream and its events exist only there")
    dev = torch.device("cuda", 0)
    cfg = CLIPConfig.vit_b32(dtype=torch.bfloat16, fused_attention=True, int8_serving=True)
    model = CLIPModel(cfg, seed=0, device=dev)
    B, V = 256, 6
    caps = _captions(B * (V + 1))
    rng = np.random.default_rng(7)
    bank = torch.nn.functional.normalize(torch.randn(8192, cfg.embed_dim, device=dev), dim=1)
    d = dict(
        tokens=np.asarray(model.tokenize(caps[:B]))[:, :32],
        vtok=np.asarray(model.tokenize(caps[B:])).reshape(B, V, -1)[:, :, :32],
        vmask=np.ones((B, V), bool), bank=bank, valid=torch.ones(8192, dtype=torch.bool, device=dev),
        weights=np.asarray([0.4, 0.4, 0.2], np.float32),
    )
    pixels = [rng.random((B, 224, 224, 3)).astype(np.float32) for _ in range(2)]
    step = make_serving_step(model, top_k=10, num_refs=3, qparams=model.qparams(), device=dev)
    return dev, model, step, d, pixels


def _host(out):
    torch.cuda.synchronize()
    return {k: v.cpu() for k, v in out.items()}


def _equal(got, want):
    for k in KEYS:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_card_staged_step_equals_the_step_on_device_pixels(card_step):
    dev, model, step, d, pixels = card_step
    before = tracing.counters()
    staged = _host(_serve(step, model, d, pixels[0], d["tokens"], d["vtok"]))
    assert _delta(before)["upload.staged"] == 1 and _delta(before)["upload.fallback"] == 0
    plain = _host(_serve(step, model, d, torch.as_tensor(pixels[0], device=dev), d["tokens"], d["vtok"]))
    _equal(staged, plain)


@pytest.mark.cuda
def test_card_back_to_back_uploads_without_readback(card_step):
    """Two steps (and two uploads started before either) with no readback
    between them equal the same steps one at a time: the second upload
    waits for the first copy out of the buffer."""
    dev, model, step, d, pixels = card_step
    alone = [_host(_serve(step, model, d, px, d["tokens"], d["vtok"])) for px in pixels]
    outs = [_serve(step, model, d, px, d["tokens"], d["vtok"]) for px in pixels]
    for got, want in zip([_host(o) for o in outs], alone):
        _equal(got, want)
    st = staging.stager(dev)
    ups = [st.start(px) for px in pixels]
    outs = [_serve(step, model, d, up, d["tokens"], d["vtok"]) for up in ups]
    for got, want in zip([_host(o) for o in outs], alone):
        _equal(got, want)


@pytest.mark.cuda
def test_card_buffer_grows_once_then_is_reused(card_step):
    dev, _, _, _, pixels = card_step
    st = staging.PinnedStager(dev)
    try:
        for rows, allocations in ((64, 1), (256, 2), (256, 2), (64, 2), (256, 2)):
            x = pixels[rows % 2][:rows]
            got = st.start(x).wait()
            assert torch.equal(got.cpu(), torch.as_tensor(x))
            assert st.allocations == allocations
        assert st._buf.is_pinned()
    finally:
        st.close()


@pytest.mark.cuda
def test_card_a_device_tensor_is_never_staged(card_step):
    dev, _, _, _, pixels = card_step
    t = torch.as_tensor(pixels[0][:8], device=dev)
    before = tracing.counters()
    assert staging.stager(dev).start(t).wait() is t
    assert _delta(before) == {"upload.staged": 0, "upload.staged_bytes": 0, "upload.fallback": 0}
