"""Trained tiny-CLIP quality fixtures (port of ``tvc/fixtures.py``, the
loading and evaluation half).

The JAX package trains the tiny CLIPs contrastively on caption-conditioned
rendered images (``tvc_torch.data.loaders``) and checkpoints their
parameters under ``tvc/assets/`` as ``flax.serialization.to_bytes``
msgpack. The port reads those files in place with its own msgpack reader
(``tvc_torch._flax_msgpack``; the card's machine has neither ``msgpack``
nor ``flax``) and carries the parameters over with ``params_from_jax``:

* :func:`load_trained_tiny` — ``CLIPConfig.tiny()`` trained on the
  synthetic combos (``clip_tiny_synthetic.msgpack``);
* :func:`load_trained_tiny_coco` — ``CLIPConfig.tiny_coco()`` trained on
  real COCO captions (``clip_tiny_coco.msgpack``), held out on the first
  :data:`EVAL_HOLDOUT` captions of ``load_coco_captions``' fixed order;
* :func:`evaluate_fixture` / :func:`evaluate_fixture_coco` — the quality
  metrics the JAX package records beside each checkpoint
  (``clip_tiny_*.json``): retrieval accuracy, pair and variant similarity,
  and for COCO the embedding-geometry stats the hubness evaluation reads.

Training (``train_clip_fixture*``) needs the training step, which is not
ported yet: ``train_if_missing=True`` with a missing asset raises
``NotImplementedError``. The assets are committed, so nothing trains.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

#: the JAX package's asset directory, read in place
ASSET_DIR = Path(__file__).resolve().parents[1] / "tvc" / "assets"
FIXTURE_PATH = ASSET_DIR / "clip_tiny_synthetic.msgpack"
FIXTURE_META_PATH = ASSET_DIR / "clip_tiny_synthetic.json"
FIXTURE_COCO_PATH = ASSET_DIR / "clip_tiny_coco.msgpack"
FIXTURE_COCO_META_PATH = ASSET_DIR / "clip_tiny_coco.json"
#: held-out window: the first EVAL_HOLDOUT captions of the fixed
#: load_coco_captions order are never trained on — eval windows draw from
#: them
EVAL_HOLDOUT = 1024

#: template phrasings the TextAugmenter applies (augment/text_augment.py
#: TEMPLATES) — trained in so template variants embed near the original
_TRAIN_TEMPLATES = (
    "a photo of {}",
    "an image showing {}",
    "a picture of {}",
    "{} in the scene",
    "this image depicts {}",
)

Device = Optional[Union[str, torch.device]]


def _augmented_captions(caption: str, rng: np.random.Generator) -> List[str]:
    """Original + the defense-time text transforms as positive captions."""
    from tvc_torch.attacks.text_attack import BUILTIN_SYNONYMS

    out = [caption]
    core = caption.rstrip(".")
    out.extend(t.format(core) for t in _TRAIN_TEMPLATES)
    # synonym substitutions on content words (same table the augmenter uses)
    words = caption.split()
    for i, w in enumerate(words):
        syns = BUILTIN_SYNONYMS.get(w.lower())
        if not syns:
            continue
        for s in syns:
            cand = list(words)
            cand[i] = s
            out.append(" ".join(cand))
    return out


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _variant_similarity(model, texts, tfeat: np.ndarray) -> float:
    rng = np.random.default_rng(0)
    vsims = []
    for t, tf in zip(texts[:16], tfeat[:16]):
        variants = _augmented_captions(t, rng)[1:6]
        vf = _np(model.encode_text(variants))
        vsims.append(float(np.mean(vf @ tf)))
    return float(np.mean(vsims))


def evaluate_fixture(model, n: int = 50, seed: int = 42) -> Dict[str, float]:
    """Quality metrics of a (trained) CLIP on the synthetic eval split:

    * ``retrieval_accuracy`` — text->image top-1 within the n-batch;
    * ``variant_similarity`` — mean cos(variant text emb, original text
      emb) over TextAugmenter-style variants (defense soundness);
    * ``pair_similarity`` — mean cos(image, paired text).
    """
    from tvc_torch.data import DataConfig, SyntheticDataset

    ds = SyntheticDataset(DataConfig(image_size=model.config.image_size, max_samples=n, seed=seed))
    batch = next(ds.batches(batch_size=n))
    images, texts = batch["images"], batch["texts"]
    ifeat = _np(model.encode_image(images))
    tfeat = _np(model.encode_text(list(texts)))
    sims = ifeat @ tfeat.T
    return {
        "retrieval_accuracy": float(np.mean(np.argmax(sims, axis=1) == np.arange(len(texts)))),
        "pair_similarity": float(np.mean(np.diag(sims))),
        "variant_similarity": _variant_similarity(model, texts, tfeat),
    }


def evaluate_fixture_coco(model, n: int = 50, skip: int = 0) -> Dict[str, float]:
    """Quality metrics on HELD-OUT real COCO captions (never trained on):
    text->image top-1 retrieval within the n-batch over rendered pairs,
    variant similarity, and the embedding-geometry stats the hubness
    evaluation depends on:

    * ``cross_text_cos`` — mean pairwise cos over a disjoint caption pool
      (text-embedding anisotropy);
    * ``galmax_mean`` — mean over pool queries of their best gallery-image
      cos (the bar an adversarial hub must beat);
    * ``hub_feasible_frac`` — fraction of pool queries the single best hub
      DIRECTION (top eigenvector of the query gram) would win."""
    from tvc_torch.data import DataConfig
    from tvc_torch.data.loaders import COCOCaptionsDataset, load_coco_captions

    ds = COCOCaptionsDataset(DataConfig(image_size=model.config.image_size, max_samples=n), skip=skip)
    batch = next(ds.batches(batch_size=n))
    images, texts = batch["images"], batch["texts"]
    ifeat = _np(model.encode_image(images))
    tfeat = _np(model.encode_text(list(texts)))
    sims = ifeat @ tfeat.T
    acc = float(np.mean(np.argmax(sims, axis=1) == np.arange(len(texts))))
    variant = _variant_similarity(model, texts, tfeat)
    pool_caps = [c for _, c in load_coco_captions()[skip + n: skip + n + 2 * 100] if c not in set(texts)][:100]
    qf = _np(model.encode_text(pool_caps))
    off = (qf @ qf.T)[~np.eye(len(qf), dtype=bool)]
    galmax = (qf @ ifeat.T).max(-1)
    _, vecs = np.linalg.eigh(qf.T @ qf)
    qu = qf @ vecs[:, -1]
    return {
        "retrieval_accuracy": acc,
        "pair_similarity": float(np.mean(np.diag(sims))),
        "variant_similarity": variant,
        "cross_text_cos": float(off.mean()),
        "galmax_mean": float(galmax.mean()),
        "hub_feasible_frac": max(float(np.mean(qu > galmax)), float(np.mean(-qu > galmax))),
    }


def _load(config, path: Path, train_if_missing: bool, seed: int, device: Device):
    from tvc_torch._flax_msgpack import read_state_dict
    from tvc_torch.models.clip import CLIPModel, params_from_jax

    if not path.exists():
        if train_if_missing:
            raise NotImplementedError(
                f"no trained fixture at {path}, and training one needs the training step, "
                "which is not ported yet"
            )
        raise FileNotFoundError(f"no trained fixture at {path}")
    params = params_from_jax(read_state_dict(path), config)
    return CLIPModel(config, params=params, seed=seed, device=device)


def load_trained_tiny_coco(train_if_missing: bool = True, seed: int = 0, device: Device = None):
    """Trained tiny_coco fixture (REAL caption distributions), on the card
    unless ``device="cpu"``."""
    from tvc_torch.models.clip import CLIPConfig

    return _load(CLIPConfig.tiny_coco(), FIXTURE_COCO_PATH, train_if_missing, seed, device)


def load_trained_tiny(train_if_missing: bool = True, seed: int = 0, device: Device = None):
    """The default quality fixture: tiny CLIP with TRAINED params, on the
    card unless ``device="cpu"``."""
    from tvc_torch.models.clip import CLIPConfig

    return _load(CLIPConfig.tiny(), FIXTURE_PATH, train_if_missing, seed, device)
