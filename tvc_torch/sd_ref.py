"""SD reference generation (port of ``tvc/sd_ref.py``): diffusion-
synthesized reference images and vectors.

* per-prompt (+ optional variant prompts) image synthesis with fixed
  deterministic seeds;
* heuristic quality score = 0.4 * contrast + 0.3 * brightness centering +
  0.3 * color richness, blank images rejected;
* an md5-keyed on-disk image cache (the JAX package's keys and files);
* ``generate_reference_vectors`` -> CLIP embeddings of the generated
  references, the form the detector consumes.

One batched denoising loop generates all prompts x num_images.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from tvc_torch.models.sd import StableDiffusionModel


@dataclasses.dataclass
class SDReferenceConfig:
    num_images: int = 3
    num_inference_steps: Optional[int] = None  # None -> model default
    guidance_scale: Optional[float] = None
    base_seed: int = 42
    quality_threshold: float = 0.3
    enable_quality_filter: bool = True
    enable_cache: bool = True
    cache_dir: Optional[str] = None
    use_variant_prompts: bool = False


def assess_image_quality(image: np.ndarray) -> float:
    """Heuristic quality score in [0, 1].

    image: [H, W, 3] float in [0, 1] or uint8.
    """
    arr = np.asarray(image, dtype=np.float32)
    if arr.max() <= 1.5:
        arr = arr * 255.0
    if arr.std() < 10:  # blank
        return 0.0
    contrast = arr.std() / 255.0
    brightness = arr.mean() / 255.0
    brightness_score = 1.0 - abs(brightness - 0.5) * 2.0
    if arr.ndim == 3:
        color_variance = np.var(arr, axis=(0, 1)).mean()
        color_score = min(color_variance / 1000.0, 1.0)
    else:
        color_score = 0.5
    return float(min(contrast * 0.4 + brightness_score * 0.3 + color_score * 0.3, 1.0))


class ImageCache:
    """md5-keyed on-disk npz cache."""

    def __init__(self, cache_dir: str):
        self.dir = Path(cache_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(prompt: str, seed: int, steps: Any, guidance: Any, n: int) -> str:
        raw = f"{prompt}|{seed}|{steps}|{guidance}|{n}"
        return hashlib.md5(raw.encode()).hexdigest()

    def get(self, key: str) -> Optional[np.ndarray]:
        p = self.dir / f"{key}.npz"
        if p.exists():
            self.hits += 1
            return np.load(p)["images"]
        self.misses += 1
        return None

    def put(self, key: str, images: np.ndarray) -> None:
        np.savez_compressed(self.dir / f"{key}.npz", images=images)


class SDReferenceGenerator:
    def __init__(
        self,
        sd_model: StableDiffusionModel,
        config: Optional[SDReferenceConfig] = None,
        clip_model=None,
        text_augmenter=None,
    ):
        self.sd = sd_model
        self.config = config or SDReferenceConfig()
        self.clip_model = clip_model
        self.text_augmenter = text_augmenter
        self.cache = (
            ImageCache(self.config.cache_dir)
            if (self.config.enable_cache and self.config.cache_dir)
            else None
        )
        self.stats = {"generated": 0, "filtered_out": 0, "cache_hits": 0, "total_time": 0.0}

    def _prompts_for(self, text: str) -> List[str]:
        if self.config.use_variant_prompts and self.text_augmenter is not None:
            variants = self.text_augmenter.generate_variants(text, 2)
            return [text] + variants
        return [text]

    def generate_reference_images(
        self, text: str, num_images: Optional[int] = None
    ) -> Dict[str, Any]:
        """-> {'images': [HW3 arrays], 'seeds', 'quality_scores',
        'cache_hit', 'generation_time'}"""
        t0 = time.time()
        n = num_images or self.config.num_images
        cfg = self.config
        seed = cfg.base_seed  # deterministic per (text via cache key, base seed)
        cache_key = None
        if self.cache is not None:
            cache_key = ImageCache.key(
                text, seed, cfg.num_inference_steps, cfg.guidance_scale, n
            )
            cached = self.cache.get(cache_key)
            if cached is not None:
                self.stats["cache_hits"] += 1
                return {
                    "images": list(cached),
                    "seeds": list(range(seed, seed + n)),
                    "quality_scores": [assess_image_quality(im) for im in cached],
                    "cache_hit": True,
                    "generation_time": time.time() - t0,
                }
        result = self.generate_reference_images_batch([text], n)[0]
        if self.cache is not None and result["images"]:
            self.cache.put(cache_key, np.stack(result["images"]))
        result["generation_time"] = time.time() - t0
        return result

    def generate_reference_images_batch(
        self, texts: Sequence[str], num_images: Optional[int] = None
    ) -> List[Dict[str, Any]]:
        """All texts x images in one batched denoising loop."""
        t0 = time.time()
        n = num_images or self.config.num_images
        cfg = self.config
        per_prompt = self.sd.generate_images_batch(
            list(texts),
            num_images=n,
            seed=cfg.base_seed,
            num_inference_steps=cfg.num_inference_steps,
            guidance_scale=cfg.guidance_scale,
        )
        out = []
        for text, images in zip(texts, per_prompt):
            scores = [assess_image_quality(im) for im in images]
            if cfg.enable_quality_filter:
                kept = [
                    (im, s) for im, s in zip(images, scores) if s >= cfg.quality_threshold
                ]
                self.stats["filtered_out"] += len(images) - len(kept)
                if kept:  # keep at least something if all fail (degraded mode)
                    images = [im for im, _ in kept]
                    scores = [s for _, s in kept]
            self.stats["generated"] += len(images)
            out.append(
                {
                    "images": images,
                    "seeds": list(range(cfg.base_seed, cfg.base_seed + n)),
                    "quality_scores": scores,
                    "cache_hit": False,
                    "generation_time": 0.0,
                }
            )
        self.stats["total_time"] += time.time() - t0
        return out

    def generate_reference_vectors(
        self, texts: Sequence[str], num_images: Optional[int] = None
    ) -> np.ndarray:
        """[B, n, D] CLIP embeddings of the generated references: the
        detector's ``reference_generator`` contract (CLIP space is what the
        consistency scores compare in; ``vae_reference_vectors`` gives the
        VAE latents). Every prompt's kept images go through one encode;
        images of another size than the CLIP tower's (512 px SD-1.5 images
        for a 224 px ViT) are resized as CLIP preprocessing resizes photos,
        from the sampler's 8-bit pixels (the JAX package passes them
        unresized, and its vision tower refuses them)."""
        n = num_images or self.config.num_images
        results = self.generate_reference_images_batch(texts, n)
        D = self.clip_model.config.embed_dim
        out = np.zeros((len(texts), n, D), np.float32)
        kept = [im for res in results for im in res["images"][:n]]
        if not kept:
            return out
        batch = np.stack(kept)
        size = self.clip_model.config.image_size
        if batch.shape[1:3] != (size, size):
            batch = [np.round(im * 255.0).astype(np.uint8) for im in batch]
        emb = self.clip_model.encode_image(batch).float().cpu().numpy()
        pos = 0
        for b, res in enumerate(results):
            k = min(len(res["images"]), n)
            out[b, :k] = emb[pos : pos + k]
            pos += k
        return out

    def vae_reference_vectors(
        self, texts: Sequence[str], num_images: Optional[int] = None
    ) -> np.ndarray:
        """Flattened VAE-latent vectors."""
        n = num_images or self.config.num_images
        results = self.generate_reference_images_batch(texts, n)
        vecs = []
        for res in results:
            lat = self.sd.encode_image(np.stack(res["images"])).cpu().numpy()
            vecs.append(lat.reshape(len(res["images"]), -1))
        return np.stack(vecs)

    def as_reference_generator(self):
        """Adapter for AdversarialDetector(reference_generator=...)."""
        return lambda texts, n: self.generate_reference_vectors(texts, n)

    def get_stats(self) -> Dict[str, Any]:
        stats = dict(self.stats)
        if self.cache is not None:
            stats["cache"] = {"hits": self.cache.hits, "misses": self.cache.misses}
        return stats
