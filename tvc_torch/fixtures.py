"""Trained tiny-CLIP quality fixtures (port of ``tvc/fixtures.py``).

The tiny CLIPs are trained contrastively on caption-conditioned rendered
images (``tvc_torch.data.loaders``) through ``make_train_step``; the JAX
package checkpoints its trained parameters under ``tvc/assets/`` as
``flax.serialization.to_bytes`` msgpack. The port reads those files in
place with its own msgpack reader (``tvc_torch._flax_msgpack``; the
card's machine has neither ``msgpack`` nor ``flax``) and carries the
parameters over with ``params_from_jax``:

* :func:`load_trained_tiny` — ``CLIPConfig.tiny()`` trained on the
  synthetic combos (``clip_tiny_synthetic.msgpack``);
* :func:`load_trained_tiny_coco` — ``CLIPConfig.tiny_coco()`` trained on
  real COCO captions (``clip_tiny_coco.msgpack``), held out on the first
  :data:`EVAL_HOLDOUT` captions of ``load_coco_captions``' fixed order;
* :func:`evaluate_fixture` / :func:`evaluate_fixture_coco` — the quality
  metrics the JAX package records beside each checkpoint
  (``clip_tiny_*.json``): retrieval accuracy, pair and variant similarity,
  and for COCO the embedding-geometry stats the hubness evaluation reads;
* :func:`train_clip_fixture` / :func:`train_clip_fixture_coco` — the
  training loops, the host draws (``default_rng(seed)``: ``choice``,
  ``random``, ``integers``) call for call the JAX package's, so the same
  seed draws the same batches and captions; the initial parameters are
  the port's seeded ``init_params``, not JAX's bits, so a port-trained
  fixture is held to the quality bars, not to the recorded values;
* :func:`save_fixture` — the msgpack tree (the bytes flax writes) and its
  ``.json`` of metrics.

A missing asset with ``train_if_missing=True`` trains one and saves it
under :data:`TRAINED_DIR` (the JAX package's asset directory is only
read), where the next load finds it.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple, Union

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
#: where the port saves the fixtures it trains
TRAINED_DIR = Path(__file__).resolve().parents[1] / "build" / "fixtures"

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


def _training_corpus(image_size: int) -> Tuple[np.ndarray, List[List[str]]]:
    """All caption combos -> (base images [N,s,s,3] noise-free,
    per-combo caption pools [original + augmented])."""
    from tvc_torch.data.loaders import SyntheticDataset, render_synthetic_image

    rng = np.random.default_rng(0)
    combos = SyntheticDataset.all_combos()
    images = np.stack([render_synthetic_image(c, image_size, noise_seed=None) for c in combos])
    captions = [_augmented_captions(SyntheticDataset.caption_for_combo(c), rng) for c in combos]
    return images, captions


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


def _train(model, images: np.ndarray, pools: List[List[str]], step_fn, opt_state, steps: int, batch_size: int,
           seed: int, noise: float, eval_every: int, eval_fn: Callable, log, done: Callable[[Dict], bool]):
    """The JAX package's training loop: each step draws ``batch_size``
    distinct corpus rows, their images plus ``noise`` uniform noise (clipped
    to [0, 1]) and one caption of each row's pool, from
    ``default_rng(seed)`` in the JAX package's order; every ``eval_every``
    steps (and at the last) the parameters are installed and evaluated,
    stopping once ``done(metrics)``. Returns (params, final metrics,
    history)."""
    rng = np.random.default_rng(seed)
    params = model.params
    t0 = time.time()
    history: List[Dict[str, float]] = []
    final: Dict[str, float] = {}
    for step in range(1, steps + 1):
        idx = rng.choice(len(images), size=batch_size, replace=False)
        px = images[idx] + noise * rng.random((batch_size,) + images.shape[1:], dtype=np.float32)
        np.clip(px, 0.0, 1.0, out=px)
        texts = [pools[i][int(rng.integers(len(pools[i])))] for i in idx]
        params, opt_state, loss = step_fn(params, opt_state, px, model.tokenize(texts))
        if step % eval_every == 0 or step == steps:
            model.params = params
            m = eval_fn(model)
            m.update(step=step, loss=float(loss), seconds=time.time() - t0)
            history.append(m)
            if log:
                log(f"step {step}: loss {float(loss):.4f} retrieval {m['retrieval_accuracy']:.3f} "
                    f"variant_sim {m['variant_similarity']:.3f}")
            final = m
            if done(m):
                break
    model.params = params
    return final, history


def train_clip_fixture(
    steps: int = 1500,
    batch_size: int = 128,
    seed: int = 0,
    learning_rate: float = 3e-3,
    target_accuracy: float = 0.98,
    eval_every: int = 250,
    noise: float = 0.05,
    log: Optional[Callable[[str], None]] = None,
    device: Device = None,
):
    """Train the tiny CLIP on the synthetic corpus until retrieval works,
    on the card unless ``device="cpu"``.

    Returns ``(CLIPModel, metrics dict)``. Early-stops once eval retrieval
    accuracy >= target_accuracy.
    """
    from tvc_torch.models.clip import CLIPConfig, CLIPModel
    from tvc_torch.optim import adamw
    from tvc_torch.parallel.steps import make_train_step

    model = CLIPModel(CLIPConfig.tiny(), seed=seed, device=device)
    images, caption_pools = _training_corpus(model.config.image_size)
    step_fn, opt_state = make_train_step(model, None, adamw(learning_rate), device=model.device)
    final, history = _train(model, images, caption_pools, step_fn, opt_state, steps, batch_size, seed, noise,
                            eval_every, evaluate_fixture, log,
                            lambda m: m["retrieval_accuracy"] >= target_accuracy)
    final["history"] = history
    return model, final


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


def geometry_regularizer(img, txt, target_aniso=0.5, pair_cap=0.55, xmodal_floor=0.10, weight=3.0):
    """Keep the fixture's embedding geometry at real-CLIP statistics.

    Plain contrastive training on a tiny corpus collapses to uniformity
    (near-orthogonal text embeddings, saturated pair similarities), a
    geometry in which an adversarial hub cannot win more than a few
    orthogonal queries. Real CLIP's captions share a narrow anisotropic
    cone with a cross-modal gap. Three hinges reproduce it on L2-normed
    features ``img`` / ``txt`` [B, D]: mean off-diagonal text cos >=
    ``target_aniso``, mean pair sim <= ``pair_cap``, mean off-pair
    cross-modal sim >= ``xmodal_floor``.
    """
    B = txt.shape[0]
    g = txt @ txt.T
    off = (g.sum() - torch.trace(g)) / (B * (B - 1))
    x = img @ txt.T
    pair = torch.mean(torch.diagonal(x))
    xoff = (x.sum() - torch.trace(x)) / (B * (B - 1))
    return weight * (
        torch.clamp(target_aniso - off, min=0.0)
        + torch.clamp(pair - pair_cap, min=0.0)
        + torch.clamp(xmodal_floor - xoff, min=0.0)
    )


def train_clip_fixture_coco(
    steps: int = 8000,
    batch_size: int = 256,
    seed: int = 0,
    learning_rate: float = 2e-3,
    target_accuracy: float = 0.92,
    eval_every: int = 500,
    noise: float = 0.03,
    log: Optional[Callable[[str], None]] = None,
    eval_fn: Optional[Callable] = None,
    extra_loss: Optional[Callable] = geometry_regularizer,
    device: Device = None,
):
    """Train tiny_coco CLIP on REAL COCO captions + caption-conditioned
    rendered images, on the card unless ``device="cpu"``. Eval is on
    held-out captions: the model must generalize through word composition.

    Training uses all val2017 captions (~25k; rendering is
    caption-conditioned, so the 5 captions of one image are 5 distinct
    pairs) minus the eval-holdout caption texts; the learning rate is
    warmup (200 steps) + cosine. Early stop needs both quality bars:
    retrieval >= ``target_accuracy`` and, with the geometry regularizer
    on and an eval that reports it, ``cross_text_cos`` >= 0.45."""
    from tvc_torch.data.loaders import load_coco_captions, render_caption_image
    from tvc_torch.models.clip import CLIPConfig, CLIPModel
    from tvc_torch.optim import adamw, warmup_cosine_decay_schedule
    from tvc_torch.parallel.steps import make_train_step

    model = CLIPModel(CLIPConfig.tiny_coco(), seed=seed, device=device)
    holdout = {c for _, c in load_coco_captions()[:EVAL_HOLDOUT]}
    captions = [c for _, c in load_coco_captions(all_captions=True) if c not in holdout]
    s = model.config.image_size
    base_images = np.stack([render_caption_image(c, s, noise_seed=None) for c in captions])
    caption_pools = [_augmented_captions(c, np.random.default_rng(0)) for c in captions]
    schedule = warmup_cosine_decay_schedule(0.0, learning_rate, warmup_steps=200, decay_steps=steps)
    step_fn, opt_state = make_train_step(model, None, adamw(schedule), extra_loss=extra_loss, device=model.device)

    def done(m: Dict) -> bool:
        # a fixture that stops before the text cone forms resists hubness
        # for the wrong reason
        geom_ok = extra_loss is not geometry_regularizer or m.get("cross_text_cos", 1.0) >= 0.45
        return m["retrieval_accuracy"] >= target_accuracy and geom_ok

    final, history = _train(model, base_images, caption_pools, step_fn, opt_state, steps, batch_size, seed, noise,
                            eval_every, eval_fn or evaluate_fixture_coco, log, done)
    final["history"] = history
    final["n_train_captions"] = len(captions)
    final["eval"] = "held-out COCO val2017 captions [0:50]"
    return model, final


def save_fixture(model, metrics: Dict, path: Optional[Path] = None) -> None:
    """The parameters as ``flax.serialization.to_bytes`` msgpack at ``path``
    (default: the synthetic fixture's name under :data:`TRAINED_DIR`) and
    the metrics, less the history, with the model's name beside it as
    ``.json``."""
    from tvc_torch._flax_msgpack import write_state_dict

    path = Path(path) if path is not None else TRAINED_DIR / FIXTURE_PATH.name
    write_state_dict(path, model.params)
    meta = {k: v for k, v in metrics.items() if k != "history"}
    meta["model"] = model.config.model_name
    path.with_suffix(".json").write_text(json.dumps(meta, indent=2, default=float))


def _load(config, path: Path, train_if_missing: bool, seed: int, device: Device, train: Callable):
    from tvc_torch._flax_msgpack import read_state_dict
    from tvc_torch.models.clip import CLIPModel, params_from_jax

    if not path.exists():
        path = TRAINED_DIR / path.name
    if not path.exists():
        if not train_if_missing:
            raise FileNotFoundError(f"no trained fixture at {path}")
        model, metrics = train(device=device)
        save_fixture(model, metrics, path=path)
        return model
    params = params_from_jax(read_state_dict(path), config)
    return CLIPModel(config, params=params, seed=seed, device=device)


def load_trained_tiny_coco(train_if_missing: bool = True, seed: int = 0, device: Device = None):
    """Trained tiny_coco fixture (REAL caption distributions), on the card
    unless ``device="cpu"``: the asset, else the one the port trained
    before, else (``train_if_missing``) one trained now and saved."""
    from tvc_torch.models.clip import CLIPConfig

    return _load(CLIPConfig.tiny_coco(), FIXTURE_COCO_PATH, train_if_missing, seed, device, train_clip_fixture_coco)


def load_trained_tiny(train_if_missing: bool = True, seed: int = 0, device: Device = None):
    """The default quality fixture: tiny CLIP with TRAINED params, on the
    card unless ``device="cpu"``: the asset, else the one the port trained
    before, else (``train_if_missing``) one trained now and saved."""
    from tvc_torch.models.clip import CLIPConfig

    return _load(CLIPConfig.tiny(), FIXTURE_PATH, train_if_missing, seed, device, train_clip_fixture)
