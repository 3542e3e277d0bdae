"""Dataset loaders (port of ``tvc/data/loaders.py``): COCO / Flickr30k /
CC3M / Visual Genome from their on-disk formats, the synthetic and
COCO-caption rendered fixtures, and a host-side numpy batch iterator with
background prefetch.

Host code only: numpy arrays in, numpy arrays out, as in the JAX package,
so a rendered image and the caption order are the same bits in both
packages. The bundled COCO caption asset is read in place from the JAX
package's ``tvc/assets`` directory. Images on disk load lazily through
PIL (imported at first use).
"""

from __future__ import annotations

import dataclasses
import json
import threading
from pathlib import Path
from queue import Queue
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class DataConfig:
    """(reference src/utils/config.py:41-70)"""

    dataset: str = "synthetic"
    data_dir: str = "./data"
    split: str = "val"
    image_size: int = 224
    batch_size: int = 256
    max_samples: Optional[int] = None
    num_workers: int = 4
    seed: int = 42
    drop_remainder: bool = False


@dataclasses.dataclass
class Sample:
    image_path: Optional[str]
    caption: str
    image_id: Any = None


class BaseDataset:
    """Pairs of (image, caption). Images load lazily (PIL) or generate
    synthetically; ``batches`` yields pixel arrays in [0, 1]."""

    def __init__(self, config: DataConfig):
        self.config = config
        self.samples: List[Sample] = []

    def __len__(self) -> int:
        return len(self.samples)

    def load_image(self, sample: Sample) -> np.ndarray:
        from PIL import Image

        s = self.config.image_size
        im = Image.open(sample.image_path).convert("RGB").resize((s, s))
        return np.asarray(im, dtype=np.float32) / 255.0

    def batches(
        self, batch_size: Optional[int] = None, shuffle: bool = False
    ) -> Iterator[Dict[str, Any]]:
        bs = batch_size or self.config.batch_size
        idx = np.arange(len(self.samples))
        if shuffle:
            np.random.default_rng(self.config.seed).shuffle(idx)
        for i in range(0, len(idx), bs):
            chunk = idx[i : i + bs]
            if self.config.drop_remainder and len(chunk) < bs:
                break
            images = np.stack([self.load_image(self.samples[j]) for j in chunk])
            yield {
                "images": images,
                "texts": [self.samples[j].caption for j in chunk],
                "ids": [self.samples[j].image_id for j in chunk],
            }

    def prefetch_batches(
        self, batch_size: Optional[int] = None, shuffle: bool = False, depth: int = 2
    ) -> Iterator[Dict[str, Any]]:
        """Background-thread prefetch (replaces torch DataLoader workers):
        image decode overlaps device compute."""
        q: Queue = Queue(maxsize=depth)
        stop = object()

        def producer():
            try:
                for batch in self.batches(batch_size, shuffle):
                    q.put(batch)
            finally:
                q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item


#: distinct foreground colors, one per adjective (render_synthetic_image)
_FG_COLORS = np.array(
    [
        [0.90, 0.10, 0.10],
        [0.10, 0.10, 0.90],
        [0.10, 0.80, 0.10],
        [0.90, 0.80, 0.10],
        [0.80, 0.10, 0.80],
        [0.10, 0.80, 0.80],
    ],
    dtype=np.float32,
)
#: background gradient colors, one per location
_BG_COLORS = np.array(
    [
        [0.20, 0.30, 0.55],
        [0.55, 0.20, 0.30],
        [0.30, 0.55, 0.20],
        [0.55, 0.55, 0.20],
        [0.20, 0.55, 0.55],
        [0.55, 0.20, 0.55],
    ],
    dtype=np.float32,
)


def render_synthetic_image(
    combo: Tuple[int, int, int],
    image_size: int,
    noise_seed: Optional[int] = None,
    noise: float = 0.05,
) -> np.ndarray:
    """Deterministic caption-conditioned rendering for SyntheticDataset.

    Each caption slot controls an orthogonal visual channel so the
    text<->image correspondence is learnable by a contrastively trained
    CLIP (tvc_torch/fixtures.py): adjective -> foreground color, noun -> stripe
    texture (spatial frequency + orientation), location -> background
    gradient (direction + color). Small per-sample noise keeps image
    statistics non-degenerate for attacks/detectors.
    """
    a, n, l = combo
    s = image_size
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
    theta = np.pi * (l % 6) / 6.0
    grad = (np.cos(theta) * xx + np.sin(theta) * yy + 1.0) / 2.4
    bg = grad[..., None] * _BG_COLORS[l % len(_BG_COLORS)]
    axis = xx if n % 2 == 0 else yy
    freq = float(n // 2 + 1)
    stripes = 0.5 + 0.5 * np.sin(2.0 * np.pi * freq * axis)
    fg = stripes[..., None] * _FG_COLORS[a % len(_FG_COLORS)]
    img = 0.55 * fg + 0.45 * bg
    if noise_seed is not None and noise > 0:
        r = np.random.default_rng(noise_seed)
        img = img + noise * r.random((s, s, 3)).astype(np.float32)
    return np.clip(img, 0.0, 1.0).astype(np.float32)


class SyntheticDataset(BaseDataset):
    """Deterministic caption-CONDITIONED synthetic image-text pairs.

    The image is a rendering of the caption's (adjective, noun, location)
    combo — see ``render_synthetic_image`` — so pairs carry learnable
    cross-modal structure: a CLIP fine-tuned on them (tvc_torch/fixtures.py)
    reaches real retrieval accuracy, making quality numbers meaningful in
    the zero-egress environment (the reference instead depends on
    downloaded COCO + pretrained weights for its measured 0.8875 clean
    retrieval, results/.../four_scenarios_1754481353.json scenario_2).

    Combos are drawn WITHOUT replacement while n <= num_combos() (= 288),
    so captions are unique and retrieval ground truth is unambiguous;
    beyond that combos repeat.
    """

    CAPTION_PARTS = (
        ("a big", "a small", "an old", "a young", "a red", "a blue"),
        ("dog", "cat", "car", "man", "woman", "house", "bird", "tree"),
        ("on the street", "in the park", "near the river", "at the beach",
         "on a table", "under the sky"),
    )

    @classmethod
    def num_combos(cls) -> int:
        n = 1
        for parts in cls.CAPTION_PARTS:
            n *= len(parts)
        return n

    @classmethod
    def all_combos(cls) -> List[Tuple[int, int, int]]:
        import itertools

        return list(
            itertools.product(*(range(len(p)) for p in cls.CAPTION_PARTS))
        )

    @classmethod
    def caption_for_combo(cls, combo: Tuple[int, int, int]) -> str:
        return " ".join(
            parts[i] for parts, i in zip(cls.CAPTION_PARTS, combo)
        )

    def __init__(self, config: DataConfig, n: int = 256):
        super().__init__(config)
        rng = np.random.default_rng(config.seed)
        n = config.max_samples or n
        combos = self.all_combos()
        order = rng.permutation(len(combos))
        self.combos: List[Tuple[int, int, int]] = [
            combos[int(order[i % len(combos)])] for i in range(n)
        ]
        self._noise_seeds = rng.integers(0, 2**31, size=n)
        for i, combo in enumerate(self.combos):
            self.samples.append(
                Sample(
                    image_path=None,
                    caption=self.caption_for_combo(combo),
                    image_id=i,
                )
            )

    def load_image(self, sample: Sample) -> np.ndarray:
        return render_synthetic_image(
            self.combos[sample.image_id],
            self.config.image_size,
            noise_seed=int(self._noise_seeds[sample.image_id]),
        )


#: small builtin stopword list (function words carry no visual content and
#: dominate caption word counts — hashing them into the rendering would
#: waste most of the signal on "a"/"the"/"of")
_RENDER_STOPWORDS = frozenset(
    "a an the of on in at is are was were with and to from for by as it its "
    "this that there their his her he she they them then than into onto over "
    "under near next be been being has have had do does did not no".split()
)

#: spatial modes of the caption renderer: 8 low-frequency 2D Fourier bases
#: (kx, ky, phase) x 3 color channels = 24 continuous visual channels
_RENDER_MODES = (
    (0.0, 1.0, 0.0),
    (1.0, 0.0, 0.8),
    (1.0, 1.0, 1.6),
    (0.0, 2.0, 2.4),
    (2.0, 0.0, 3.2),
    (1.0, 2.0, 4.0),
    (2.0, 1.0, 4.8),
    (2.0, 2.0, 5.6),
)


def _fnv1a(text: str) -> int:
    h = 0xCBF29CE484222325
    for b in text.encode("utf-8"):
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def caption_render_vector(caption: str) -> np.ndarray:
    """Caption -> unit vector in R^24 by SUMMING per-word pseudo-embeddings
    (seeded by a stable word hash). Additive-by-word composition is the
    point: a contrastive text tower can learn it as word embeddings + sum
    pooling, so a tiny CLIP trained on rendered pairs generalizes to
    UNSEEN captions made of seen words — which makes real-caption quality
    numbers meaningful without downloading COCO images."""
    import re

    words = [
        w
        for w in re.findall(r"[a-z0-9]+", caption.lower())
        if w not in _RENDER_STOPWORDS
    ]
    if not words:
        words = ["empty"]
    v = np.zeros(24, np.float64)
    for w in set(words):  # set: caption is a bag of distinct content words
        rng = np.random.default_rng(_fnv1a(w) % (2**63))
        v += rng.standard_normal(24)
    n = np.linalg.norm(v)
    return (v / max(n, 1e-9)).astype(np.float32)


def render_caption_image(
    caption: str,
    image_size: int,
    noise_seed: Optional[int] = None,
    noise: float = 0.03,
) -> np.ndarray:
    """Deterministic caption-conditioned rendering for REAL captions.

    The caption's 24-dim render vector drives 8 low-frequency Fourier
    modes per RGB channel; contrast is normalized per image. Distinct
    content-word multisets give distinct images (continuous channels, no
    combinatorial collisions), and the text->image map is compositional,
    so it is learnable by the trained tiny-CLIP fixture (tvc_torch/fixtures.py).
    """
    v = caption_render_vector(caption).reshape(8, 3)
    s = image_size
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
    acc = np.zeros((s, s, 3), np.float32)
    for (kx, ky, phase), weights in zip(_RENDER_MODES, v):
        basis = np.cos(2.0 * np.pi * (kx * xx + ky * yy) + phase)
        acc += basis[..., None] * weights
    img = 0.5 + 0.45 * acc / (np.abs(acc).max() + 1e-6)
    if noise_seed is not None and noise > 0:
        r = np.random.default_rng(noise_seed)
        img = img + noise * r.random((s, s, 3)).astype(np.float32)
    return np.clip(img, 0.0, 1.0).astype(np.float32)


#: bundled caption asset (public COCO annotation TEXT, extracted once from
#: the standard captions_val2017.json — images are not needed)
_CAPTION_ASSET = Path(__file__).resolve().parents[2] / "tvc" / "assets" / "coco_captions_val2017.json.gz"


def load_coco_captions(
    data_dir: str = "./data", split: str = "val", all_captions: bool = False
) -> List[Tuple[int, str]]:
    """Real COCO caption strings as (image_id, caption) pairs, in a FIXED
    pseudorandom order (stable across seeds so train/eval windows never
    overlap). Probes ``{data_dir}/coco/annotations/captions_{split}2017.json``
    first, then the bundled asset. ``all_captions=False`` keeps one caption
    per image (COCODataset parity)."""
    import gzip

    ann_path = (
        Path(data_dir) / "coco" / "annotations" / f"captions_{split}2017.json"
    )
    if ann_path.exists():
        with open(ann_path) as f:
            ann = json.load(f)
        pairs = [(a["image_id"], a["caption"].strip()) for a in ann["annotations"]]
    elif _CAPTION_ASSET.exists() and split == "val":
        with gzip.open(_CAPTION_ASSET, "rt") as f:
            pairs = [tuple(p) for p in json.load(f)]
    else:
        raise FileNotFoundError(
            f"no COCO captions: {ann_path} missing and no bundled asset"
        )
    if not all_captions:
        seen, out = set(), []
        for img_id, cap in pairs:
            if img_id in seen:
                continue
            seen.add(img_id)
            out.append((img_id, cap))
        pairs = out
    order = np.random.default_rng(12345).permutation(len(pairs))
    return [pairs[int(i)] for i in order]


class COCOCaptionsDataset(BaseDataset):
    """REAL COCO val2017 captions paired with caption-conditioned rendered
    images: natural-language text distributions (variable length, real
    vocabulary, >16-token sequences) with zero image downloads. This is
    the default quality-fixture dataset — the reference's measured
    artifact is COCO n=50 (results/comprehensive_defense_evaluation/
    four_scenarios_1754481353.json), and its captions ship in the repo's
    annotation JSON."""

    def __init__(self, config: DataConfig, skip: int = 0, all_captions: bool = False):
        super().__init__(config)
        pairs = load_coco_captions(
            config.data_dir, config.split, all_captions=all_captions
        )
        if skip:
            pairs = pairs[skip:]
        if config.max_samples:
            pairs = pairs[: config.max_samples]
        for img_id, cap in pairs:
            self.samples.append(Sample(image_path=None, caption=cap, image_id=img_id))

    def load_image(self, sample: Sample) -> np.ndarray:
        # noise seed from the stable image_id, not list position
        return render_caption_image(
            sample.caption,
            self.config.image_size,
            noise_seed=int(sample.image_id) % (2**31),
        )


class COCODataset(BaseDataset):
    """COCO captions (reference src/utils/data_loader.py:108-194).

    Expects ``{data_dir}/coco/annotations/captions_{split}2017.json`` and
    images under ``{data_dir}/coco/{split}2017/``.
    """

    def __init__(self, config: DataConfig):
        super().__init__(config)
        root = Path(config.data_dir) / "coco"
        ann_path = root / "annotations" / f"captions_{config.split}2017.json"
        with open(ann_path) as f:
            ann = json.load(f)
        id_to_file = {im["id"]: im["file_name"] for im in ann["images"]}
        img_dir = root / f"{config.split}2017"
        seen_images = set()
        for a in ann["annotations"]:
            img_id = a["image_id"]
            if config.max_samples and len(self.samples) >= config.max_samples:
                break
            if img_id in seen_images:
                continue  # one caption per image (reference behavior)
            seen_images.add(img_id)
            self.samples.append(
                Sample(
                    image_path=str(img_dir / id_to_file[img_id]),
                    caption=a["caption"].strip(),
                    image_id=img_id,
                )
            )


class Flickr30kDataset(BaseDataset):
    """Flickr30k (reference :195-257). Expects
    ``{data_dir}/flickr30k/results_20130124.token`` and images under
    ``{data_dir}/flickr30k/images/``."""

    def __init__(self, config: DataConfig):
        super().__init__(config)
        root = Path(config.data_dir) / "flickr30k"
        token = root / "results_20130124.token"
        seen = set()
        with open(token, encoding="utf-8") as f:
            for line in f:
                if config.max_samples and len(self.samples) >= config.max_samples:
                    break
                try:
                    key, caption = line.rstrip("\n").split("\t", 1)
                    fname, _ = key.split("#")
                except ValueError:
                    continue
                if fname in seen:
                    continue
                seen.add(fname)
                self.samples.append(
                    Sample(
                        image_path=str(root / "images" / fname),
                        caption=caption.strip(),
                        image_id=fname,
                    )
                )


class CC3MDataset(BaseDataset):
    """Conceptual Captions TSV: ``caption\\turl_or_path`` (reference :258-342)."""

    def __init__(self, config: DataConfig):
        super().__init__(config)
        root = Path(config.data_dir) / "cc3m"
        tsv = root / f"{config.split}.tsv"
        with open(tsv, encoding="utf-8") as f:
            for i, line in enumerate(f):
                if config.max_samples and len(self.samples) >= config.max_samples:
                    break
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 2:
                    continue
                caption, path = parts[0], parts[1]
                local = root / "images" / Path(path).name
                self.samples.append(
                    Sample(image_path=str(local), caption=caption.strip(), image_id=i)
                )


class VisualGenomeDataset(BaseDataset):
    """VG region descriptions (reference :343-441). Expects
    ``{data_dir}/visual_genome/region_descriptions.json`` + ``images/``."""

    def __init__(self, config: DataConfig):
        super().__init__(config)
        root = Path(config.data_dir) / "visual_genome"
        with open(root / "region_descriptions.json") as f:
            regions = json.load(f)
        for entry in regions:
            if config.max_samples and len(self.samples) >= config.max_samples:
                break
            img_id = entry.get("id") or entry.get("image_id")
            descs = entry.get("regions", [])
            if not descs:
                continue
            caption = descs[0].get("phrase", "").strip()
            if not caption:
                continue
            self.samples.append(
                Sample(
                    image_path=str(root / "images" / f"{img_id}.jpg"),
                    caption=caption,
                    image_id=img_id,
                )
            )


DATASETS = {
    "synthetic": SyntheticDataset,
    "coco": COCODataset,
    "coco_captions": COCOCaptionsDataset,
    "flickr30k": Flickr30kDataset,
    "cc3m": CC3MDataset,
    "visual_genome": VisualGenomeDataset,
}


class DataLoaderManager:
    """(reference src/utils/data_loader.py:442-706)"""

    def __init__(self, config: Optional[DataConfig] = None):
        self.config = config or DataConfig()

    def load_dataset(self, name: Optional[str] = None, **overrides) -> BaseDataset:
        name = name or self.config.dataset
        if name not in DATASETS:
            raise ValueError(f"unknown dataset {name!r}; available: {sorted(DATASETS)}")
        cfg = dataclasses.replace(self.config, dataset=name, **overrides)
        return DATASETS[name](cfg)

    def create_dataloader(
        self, dataset: BaseDataset, batch_size: Optional[int] = None, shuffle: bool = False
    ) -> Iterator[Dict[str, Any]]:
        return dataset.prefetch_batches(batch_size, shuffle)


def loader_to_list(
    dataset: BaseDataset, max_samples: Optional[int] = None
) -> List[Tuple[np.ndarray, str, bool]]:
    """Materialize (image, text, is_adversarial=False) tuples
    (reference experiments/run_experiments.py:324)."""
    out = []
    for batch in dataset.batches(batch_size=64):
        for img, txt in zip(batch["images"], batch["texts"]):
            out.append((img, txt, False))
            if max_samples and len(out) >= max_samples:
                return out
    return out
