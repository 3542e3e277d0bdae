"""tvc_torch.sd_ref against tvc.sd_ref: ``assess_image_quality`` equal,
``ImageCache`` keys equal and each package reading the other's files, the
quality filter's counts (its keep-one degraded mode too), and the
generated references through ``generate_reference_vectors`` into the
staged detector of each package (tiny CLIP) with flags equal and scores
within 2e-5. The generation itself is held in tests/test_torch_sd.py; here
both packages' generators read the same images from one stub model."""

import jax
import numpy as np
import pytest

from tvc.detector import AdversarialDetector as JDetector, DetectorConfig as JDetConfig
from tvc.models.clip import CLIPConfig as JConfig, CLIPModel as JModel
from tvc.sd_ref import (
    ImageCache as JCache,
    SDReferenceConfig as JRefConfig,
    SDReferenceGenerator as JGenerator,
    assess_image_quality as j_quality,
)
from tvc_torch.detector import AdversarialDetector, DetectorConfig
from tvc_torch.models.clip import CLIPConfig, CLIPModel, params_from_jax
from tvc_torch.models.sd import SDConfig, StableDiffusionModel
from tvc_torch.sd_ref import ImageCache, SDReferenceConfig, SDReferenceGenerator, assess_image_quality

TOL = 2e-5
TEXTS = ["a dog runs on the beach", "two cats on a red couch", "a man riding a wave"]


def _images(seed: int, n: int, blank=()):
    """n 32 px images in [0, 1] (multiples of 1/255, as the sampler gives);
    the listed ones blank."""
    rng = np.random.default_rng(seed)
    out = [np.round(rng.random((32, 32, 3)) * 255).astype(np.float32) / 255 for _ in range(n)]
    for i in blank:
        out[i] = np.full((32, 32, 3), 0.5, np.float32)
    return out


class _StubSD:
    """generate_images_batch of a fixed image set: prompt p gets images
    seeded by (its length, p), blanks where ``blank`` says."""

    def __init__(self, blank=None):
        self.blank = blank or {}
        self.calls = []

    def generate_images_batch(self, prompts, num_images=1, seed=0, num_inference_steps=None, guidance_scale=None):
        self.calls.append((list(prompts), num_images, seed, num_inference_steps, guidance_scale))
        return [_images(len(p) + seed, num_images, self.blank.get(i, ())) for i, p in enumerate(prompts)]


def test_assess_image_quality_equals_jax():
    rng = np.random.default_rng(0)
    cases = [rng.random((16, 16, 3)).astype(np.float32), rng.integers(0, 256, (16, 16, 3)).astype(np.uint8),
             np.full((8, 8, 3), 0.3, np.float32), rng.random((20, 20)).astype(np.float32),
             rng.random((12, 12, 3)).astype(np.float32) * 0.2]
    for im in cases:
        assert assess_image_quality(im) == j_quality(im)
    assert assess_image_quality(cases[2]) == 0.0  # blank


def test_image_cache_files_across_packages(tmp_path):
    key = ImageCache.key("a cat", 42, None, 7.5, 3)
    assert key == JCache.key("a cat", 42, None, 7.5, 3)
    imgs = np.stack(_images(1, 3))
    t_cache, j_cache = ImageCache(str(tmp_path / "t")), JCache(str(tmp_path / "j"))
    t_cache.put(key, imgs)
    j_cache.put(key, imgs[::-1])
    np.testing.assert_array_equal(JCache(str(tmp_path / "t")).get(key), imgs)
    np.testing.assert_array_equal(ImageCache(str(tmp_path / "j")).get(key), imgs[::-1])
    c = ImageCache(str(tmp_path / "t"))
    assert c.get("missing") is None and (c.hits, c.misses) == (0, 1)


@pytest.mark.parametrize("blank,kept", [({0: (1,)}, [2, 3]), ({1: (0, 1, 2)}, [3, 3])])
def test_quality_filter_counts_equal_jax(blank, kept):
    """One blank image of the first prompt filtered out; a prompt whose
    images all fail keeps them all (the degraded mode)."""
    out = []
    for gen_cls, cfg_cls in ((JGenerator, JRefConfig), (SDReferenceGenerator, SDReferenceConfig)):
        gen = gen_cls(_StubSD(blank), cfg_cls(enable_cache=False))
        res = gen.generate_reference_images_batch(TEXTS[:2])
        out.append((res, gen.get_stats()))
    (jres, jstats), (tres, tstats) = out
    assert [len(r["images"]) for r in tres] == [len(r["images"]) for r in jres] == kept
    for t, j in zip(tres, jres):
        assert t["quality_scores"] == j["quality_scores"] and t["seeds"] == j["seeds"] == [42, 43, 44]
        for a, b in zip(t["images"], j["images"]):
            np.testing.assert_array_equal(a, b)
    assert {k: v for k, v in tstats.items() if k != "total_time"} == \
        {k: v for k, v in jstats.items() if k != "total_time"}


def test_generate_reference_images_cache_hit(tmp_path):
    sd = _StubSD()
    gen = SDReferenceGenerator(sd, SDReferenceConfig(cache_dir=str(tmp_path)))
    first = gen.generate_reference_images(TEXTS[0])
    again = gen.generate_reference_images(TEXTS[0])
    assert not first["cache_hit"] and again["cache_hit"] and len(sd.calls) == 1
    for a, b in zip(first["images"], again["images"]):
        np.testing.assert_array_equal(a, b)
    assert gen.get_stats()["cache"] == {"hits": 1, "misses": 1}
    # the JAX package's generator reads the same cache entry
    jgen = JGenerator(_StubSD(), JRefConfig(cache_dir=str(tmp_path)))
    assert jgen.generate_reference_images(TEXTS[0])["cache_hit"]


@pytest.fixture(scope="module")
def clips():
    jm = JModel(JConfig.tiny(), seed=0)
    tm = CLIPModel(CLIPConfig.tiny(), params=params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params),
                                                             CLIPConfig.tiny()), device="cpu")
    return jm, tm


def test_reference_vectors_into_the_staged_detector_equal_jax(clips):
    """generate_reference_vectors (CLIP embeddings of the kept images,
    zero rows where a prompt kept fewer) feeding each package's detector
    through as_reference_generator: the staged path, flags equal."""
    jm, tm = clips
    blank = {1: (2,)}
    jgen = JGenerator(_StubSD(blank), JRefConfig(enable_cache=False), clip_model=jm)
    tgen = SDReferenceGenerator(_StubSD(blank), SDReferenceConfig(enable_cache=False), clip_model=tm)
    jv, tv = np.asarray(jgen.generate_reference_vectors(TEXTS)), tgen.generate_reference_vectors(TEXTS)
    assert tv.shape == (3, 3, 32) and tv.dtype == np.float32
    np.testing.assert_allclose(tv, jv, atol=TOL, rtol=0)
    assert np.all(tv[1, 2] == 0)  # the filtered image leaves a zero row

    images = np.random.default_rng(3).random((3, 32, 32, 3)).astype(np.float32)
    variants = [[f"{t} again", f"a photo: {t}"] for t in TEXTS]
    kw = dict(num_text_variants=2, num_reference_images=3)
    jd = JDetector(jm, JDetConfig(**kw), reference_generator=jgen.as_reference_generator())
    td = AdversarialDetector(tm, DetectorConfig(**kw), reference_generator=tgen.as_reference_generator(),
                             device="cpu")
    want, got = jd.detect_batch(images, TEXTS, variants), td.detect_batch(images, TEXTS, variants)
    assert not td._can_fuse()  # a reference generator keeps the staged path
    np.testing.assert_allclose(got.aggregated_score, np.asarray(want.aggregated_score), atol=TOL, rtol=0)
    np.testing.assert_allclose(got.method_scores["sd_reference"], np.asarray(want.method_scores["sd_reference"]),
                               atol=TOL, rtol=0)
    s = np.sort(got.aggregated_score)
    assert s[1] - s[0] > 1e-3
    thr = float(s[0] + s[1]) / 2  # splits the batch, far from every score
    for d in (jd, td):
        d.threshold_manager.update(thr)
    np.testing.assert_array_equal(td.detect_batch(images, TEXTS, variants).is_adversarial,
                                  np.asarray(jd.detect_batch(images, TEXTS, variants).is_adversarial))


def test_off_size_references_are_resized_as_clip_preprocessing(clips):
    """16 px references for the 32 px tiny CLIP: the port encodes them
    resized from their 8-bit pixels (the native resize of
    preprocess_images); the JAX package's tower refuses them."""
    jm, tm = clips

    class Small(_StubSD):
        def generate_images_batch(self, prompts, num_images=1, **kw):
            return [[im[:16, :16] for im in imgs] for imgs in super().generate_images_batch(prompts, num_images, **kw)]

    gen = SDReferenceGenerator(Small(), SDReferenceConfig(enable_cache=False), clip_model=tm)
    vecs = gen.generate_reference_vectors(TEXTS[:2], 2)
    imgs = [im for p in Small().generate_images_batch(TEXTS[:2], 2, seed=42) for im in p]
    want = tm.encode_image([np.round(im * 255).astype(np.uint8) for im in imgs]).numpy().reshape(2, 2, -1)
    np.testing.assert_array_equal(vecs, want)
    with pytest.raises(Exception):
        JGenerator(Small(), JRefConfig(enable_cache=False), clip_model=jm).generate_reference_vectors(TEXTS[:2], 2)


def test_generator_over_the_port_sd_model(clips):
    """The real (tiny) sampler behind the generator: one loop for every
    prompt, the variant-prompt switch, VAE latent vectors, the detector
    adapter's shape."""
    _, tm = clips
    sd = StableDiffusionModel(SDConfig.tiny(), seed=0, device="cpu")
    gen = SDReferenceGenerator(sd, SDReferenceConfig(num_images=2, num_inference_steps=2, enable_cache=False),
                               clip_model=tm)
    vecs = gen.as_reference_generator()(TEXTS[:2], 2)
    assert vecs.shape == (2, 2, 32) and np.all(np.isfinite(vecs))
    assert sd.get_stats()["batches"] == 1
    lat = gen.vae_reference_vectors(TEXTS[:1], 2)
    assert lat.shape[0] == 1 and 1 <= lat.shape[1] <= 2 and lat.shape[2] == 16 * 16 * 4
    assert gen._prompts_for("a cat") == ["a cat"]
