"""The port's image preprocessing against the JAX package's: the native
resize + normalize library (its three functions against ``tvc.native``'s)
and ``preprocess_images`` on PIL images and uint8 / float arrays of sizes
above and below the model's, in both branches."""

import numpy as np
import pytest
from PIL import Image

from tvc import native as jax_native
from tvc.models import clip as jax_clip
from tvc_torch import native
from tvc_torch.models import clip as torch_clip

SIZES = [(48, 64), (17, 23), (32, 32), (100, 37)]


def _inputs(seed: int):
    """PIL images, uint8 arrays and [0, 1] float arrays of every size."""
    rng = np.random.default_rng(seed)
    out = []
    for h, w in SIZES:
        u8 = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        out += [Image.fromarray(u8), u8, rng.random((h, w, 3), dtype=np.float32)]
    return out


def test_native_library_matches_jax_native():
    if not jax_native.available():
        pytest.skip("the JAX package's native image library is not built here")
    rng = np.random.default_rng(0)
    batch = rng.integers(0, 256, (3, 40, 57, 3), dtype=np.uint8)
    for size in (32, 64):
        np.testing.assert_allclose(
            native.resize_normalize_batch(batch, size), jax_native.resize_normalize_batch(batch, size), atol=1e-5
        )
    varied = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in SIZES]
    np.testing.assert_allclose(
        native.resize_normalize_varied(varied, 32), jax_native.resize_normalize_varied(varied, 32), atol=1e-5
    )
    rows = rng.standard_normal((9, 33)).astype(np.float32)
    rows[4] = 0.0
    np.testing.assert_allclose(
        native.l2_normalize_rows(rows.copy()), jax_native.l2_normalize_rows(rows.copy()), atol=1e-6
    )


@pytest.mark.parametrize("size", [32, 24])
def test_preprocess_normalized_takes_the_native_resize(size):
    """normalize=True: every input is an [h, w, 3] image, so both sides
    resize natively (1e-5)."""
    if not jax_native.available():
        pytest.skip("the JAX package's native image library is not built here")
    images = _inputs(1)
    got = torch_clip.preprocess_images(images, size)
    want = jax_clip.preprocess_images(images, size)
    assert got.shape == (len(images), size, size, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("size", [32, 24])
def test_preprocess_raw_takes_pil_resize(size):
    """normalize=False (the detector's call): PIL's resize on both sides,
    exactly."""
    images = _inputs(2)
    got = torch_clip.preprocess_images(images, size, normalize=False)
    want = jax_clip.preprocess_images(images, size, normalize=False)
    assert got.shape == (len(images), size, size, 3)
    np.testing.assert_array_equal(got, want)


def test_preprocess_non_rgb_arrays_take_pil_branch():
    """A grayscale PIL image converts to RGB; a 2-D array sends the whole
    batch to the PIL branch (normalize=True), as in the JAX package."""
    rng = np.random.default_rng(3)
    gray = Image.fromarray(rng.integers(0, 256, (20, 30), dtype=np.uint8))
    images = [gray, rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)]
    if jax_native.available():
        np.testing.assert_allclose(
            torch_clip.preprocess_images(images, 16), jax_clip.preprocess_images(images, 16), atol=1e-5
        )
    np.testing.assert_array_equal(
        torch_clip.preprocess_images(images, 16, normalize=False),
        jax_clip.preprocess_images(images, 16, normalize=False),
    )


def test_detector_takes_photo_sized_pil_images():
    """The port's detector resizes what the JAX package's detector resizes
    (it used to raise for any image not at image_size)."""
    from tvc_torch.detector import AdversarialDetector
    from tvc_torch.models.clip import CLIPConfig, CLIPModel

    model = CLIPModel(CLIPConfig.tiny_coco(), device="cpu")
    det = AdversarialDetector(model, device="cpu")
    images = [Image.fromarray(np.full((48, 64, 3), 100, np.uint8)), Image.fromarray(np.zeros((30, 20, 3), np.uint8))]
    px = det._raw_pixels(images)
    assert px.shape == (2, 32, 32, 3)
    res = det.detect_batch(images, ["a dog on a mat", "two cats"])
    assert res.aggregated_score.shape == (2,) and np.all(np.isfinite(res.aggregated_score))
