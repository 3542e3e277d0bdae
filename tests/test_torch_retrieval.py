"""tvc_torch MultiModalRetriever against tvc.retrieval at tiny_coco (the
full CLIP BPE vocab): the text index from COCO captions (duplicates
included), image -> text retrieval from raw pixels and from PIL photos of
other sizes (resized natively on both sides), the image index from PIL
images, the similarity matrix, save / load of both banks (each package
loads the other's files), the cache switch and create_retriever. Indices
and items exact, scores 2e-5."""

import gzip
import json
from pathlib import Path

import jax
import numpy as np
import pytest
from PIL import Image

from test_torch_native_ready import jax_native_ready
from tvc.models.clip import CLIPConfig as JConfig, CLIPModel as JModel
from tvc.retrieval import MultiModalRetriever as JRetriever, RetrievalConfig as JRetrievalConfig
from tvc_torch.models.clip import CLIPConfig, CLIPModel, params_from_jax
from tvc_torch.retrieval import MultiModalRetriever, RetrievalConfig, create_retriever

ASSETS = Path(__file__).resolve().parent.parent / "tvc" / "assets"
TOL = 2e-5


def _photos_and_pixels():
    rng = np.random.default_rng(5)
    pixels = rng.random((6, 32, 32, 3)).astype(np.float32)
    photos = [Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)) for h, w in
              ((48, 64), (37, 50), (32, 32), (90, 60))]
    return photos, pixels


def _image_index_inputs(photos, pixels):
    return photos + [Image.fromarray((p * 255).astype(np.uint8)) for p in pixels]


@pytest.fixture(scope="module")
def pair():
    # the JAX side resizes the off-size photos natively, as the port does
    jax_native_ready()
    jm = JModel(JConfig.tiny_coco(), seed=0)
    cfg = CLIPConfig.tiny_coco()
    tm = CLIPModel(cfg, params=params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params), cfg), device="cpu")
    with gzip.open(ASSETS / "coco_captions_val2017.json.gz", "rt") as f:
        caps = [c.strip() for _, c in json.load(f)[:90]]
    caps += caps[:6]  # duplicated captions: equal embeddings, ties in every search
    photos, pixels = _photos_and_pixels()
    kw = dict(top_k=7, batch_size=40)
    jr, tr = JRetriever(jm, JRetrievalConfig(**kw)), MultiModalRetriever(tm, RetrievalConfig(**kw))
    for r in (jr, tr):
        r.build_text_index(caps)
        r.build_image_index(_image_index_inputs(photos, pixels))
    return jr, tr, caps, pixels, photos


def _same(got, want):
    np.testing.assert_array_equal(got.indices, np.asarray(want.indices))
    np.testing.assert_allclose(got.scores, np.asarray(want.scores), atol=TOL, rtol=0)
    assert got.items == want.items


def test_indexes_match_jax(pair):
    jr, tr, caps, *_ = pair
    assert tr.text_items == jr.text_items == caps
    assert tr.text_bank.size == jr.text_bank.size == len(caps)
    for j, t in ((jr.text_bank, tr.text_bank), (jr.image_bank, tr.image_bank)):
        np.testing.assert_allclose(t._bank[: t.size].numpy(), np.asarray(j._bank)[: j.size], atol=TOL, rtol=0)


def test_image_index_matches_jax_after_a_lost_build_race(pair):
    """A process that lost the race to build tvc.native's library (the
    loader's failure remembered) recovers through jax_native_ready, and the
    JAX image index built after it equals the port's."""
    from tvc import native

    jr, tr, *_ = pair
    native._TRIED, native._LIB = True, None
    jax_native_ready()
    photos, pixels = _photos_and_pixels()
    fresh = JRetriever(jr.model, JRetrievalConfig(top_k=7, batch_size=40))
    fresh.build_image_index(_image_index_inputs(photos, pixels))
    t = tr.image_bank
    np.testing.assert_allclose(t._bank[: t.size].numpy(), np.asarray(fresh.image_bank._bank)[: t.size], atol=TOL,
                               rtol=0)


def test_retrieve_texts_by_image_matches_jax(pair):
    jr, tr, caps, pixels, photos = pair
    _same(tr.retrieve_texts_by_image(pixels), jr.retrieve_texts_by_image(pixels))
    _same(tr.retrieve_texts_by_image(photos, top_k=12), jr.retrieve_texts_by_image(photos, top_k=12))
    _same(tr.retrieve_texts_by_image(photos[0]), jr.retrieve_texts_by_image(photos[0]))


def test_duplicated_captions_come_out_lower_index_first(pair):
    """Captions i and 90 + i are equal: wherever both are retrieved, the
    lower index comes first, as lax.top_k orders ties."""
    jr, tr, caps, pixels, photos = pair
    res = tr.retrieve_texts_by_image(pixels, top_k=len(caps))
    for row in res.indices:
        pos = {int(j): n for n, j in enumerate(row)}
        for i in range(6):
            assert pos[i] < pos[90 + i]


def test_retrieve_images_and_similarity_matrix_match_jax(pair):
    jr, tr, caps, *_ = pair
    _same(tr.retrieve_images_by_text(caps[:5], top_k=4), jr.retrieve_images_by_text(caps[:5], top_k=4))
    np.testing.assert_allclose(tr.compute_similarity_matrix(caps[:9]), np.asarray(jr.compute_similarity_matrix(caps[:9])),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(tr.compute_similarity_matrix(caps[3]), np.asarray(jr.compute_similarity_matrix(caps[3])),
                               atol=TOL, rtol=0)


def test_save_load_both_banks_across_packages(pair, tmp_path):
    jr, tr, caps, pixels, _ = pair
    tr.save(str(tmp_path / "torch"))
    jr.save(str(tmp_path / "jax"))
    t2 = MultiModalRetriever(tr.model)
    t2.load(str(tmp_path / "jax"))  # the JAX package's files
    j2 = JRetriever(jr.model)
    j2.load(str(tmp_path / "torch"))  # the port's files
    assert t2.config == tr.config and t2.text_items == caps
    _same(t2.retrieve_texts_by_image(pixels), jr.retrieve_texts_by_image(pixels))
    _same(tr.retrieve_texts_by_image(pixels), j2.retrieve_texts_by_image(pixels))
    np.testing.assert_allclose(t2.compute_similarity_matrix(caps[:3]), tr.compute_similarity_matrix(caps[:3]),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("enabled", [True, False])
def test_cache_switch(pair, enabled):
    _, tr, caps, *_ = pair
    r = create_retriever(tr.model, RetrievalConfig(top_k=3, cache_enabled=enabled))
    assert isinstance(r, MultiModalRetriever) and r.config.index_type == "exact"
    r.build_image_index(embeddings=tr.image_bank._bank[: tr.image_bank.size].numpy())
    first = r.retrieve_images_by_text(caps[0])
    second = r.retrieve_images_by_text(caps[0])
    assert r.get_stats()["cache_hits"] == int(enabled)
    assert (second is first) == enabled
    np.testing.assert_array_equal(first.indices, second.indices)


def test_retriever_single_device_only(pair):
    _, tr, *_ = pair
    with pytest.raises(NotImplementedError):
        create_retriever(tr.model, mesh=object())
    with pytest.raises(RuntimeError, match="text index"):
        MultiModalRetriever(tr.model).retrieve_texts_by_image(np.zeros((1, 32, 32, 3), np.float32))
