"""The one traffic generator. A mix is a data file, ``traffic/<mix>.json``;
its keys say which captions a batch or request carries, how many, and when
it is due. Every draw comes from the run's seed: the same seed gives the
same traffic, and every seed gives the same sizes and arrivals in another
order of captions.

Captions are the 25,014 COCO val2017 captions of ``data/`` (5,000 images,
five captions each; a copy of the asset the program's tests use).

``captions`` of a mix:

* ``variants``: a query is the first caption of an image, its variants the
  image's other captions repeated to ``variants`` (the caption itself where
  an image has no other). The images are permuted by the seed and taken in
  consecutive slices, so consecutive batches differ.
* ``fresh``: every distinct caption, permuted by the seed, taken in order
  and never twice in a run; the warm-up batches come from the far end of the
  permutation, which the window does not reach.
* ``pool``: a pool of ``pool_batches`` batches of captions (the start of the
  seed's permutation); set-up serves the pool once, and each window batch
  draws ``batch`` distinct captions of the pool uniformly.
* ``uniform``: each query a caption drawn uniformly from the distinct ones.

``arrivals``: ``closed`` (the next batch when the last returns) or
``poisson`` (open loop at ``rate_qps`` queries a second, each request
carrying a Zipf(``zipf_s``) number of queries on 1..``max_queries``; the
same gaps and sizes for every seed, in the seed's order).
"""

from __future__ import annotations

import functools
import gzip
import json
from typing import Dict, List, Tuple

import numpy as np

from perfbench.common import BENCH_DIR

CAPTIONS = BENCH_DIR / "data" / "coco_captions_val2017.json.gz"


@functools.lru_cache(maxsize=1)
def coco_pairs() -> Tuple[Tuple[int, str], ...]:
    with gzip.open(CAPTIONS, "rt") as f:
        return tuple((int(i), c.strip()) for i, c in json.load(f))


def all_captions() -> List[str]:
    return [c for _, c in coco_pairs()]


def distinct_captions() -> List[str]:
    """The 24,794 distinct caption strings, in file order (220 of the
    25,014 repeat another image's caption word for word)."""
    return list(dict.fromkeys(all_captions()))


def caption_groups() -> List[List[str]]:
    """Captions of each image with two or more, by image id."""
    by_img: Dict[int, List[str]] = {}
    for img_id, cap in coco_pairs():
        by_img.setdefault(img_id, []).append(cap)
    return [by_img[i] for i in sorted(i for i, c in by_img.items() if len(c) >= 2)]


def _rng(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**63 - 1), salt])


class Traffic:
    """The draws of one mix under one seed."""

    def __init__(self, mix: Dict, seed: int):
        self.mix = mix
        self.seed = int(seed)
        self.batch = int(mix.get("batch", 0))
        self.kind = mix["captions"]
        if self.kind == "variants":
            groups = caption_groups()
            order = _rng(seed, 1).permutation(len(groups))
            self._groups = [groups[i] for i in order]
        elif self.kind in ("fresh", "pool", "uniform"):
            caps = distinct_captions()
            self._caps = [caps[i] for i in _rng(seed, 2).permutation(len(caps))]
            self._warm_end = len(self._caps) - int(mix.get("warmup_batches", 0)) * self.batch
            if self.kind == "pool":
                self.pool = self._caps[: int(mix["pool_batches"]) * self.batch]
        else:
            raise ValueError(f"unknown captions kind {self.kind!r}")
        self._draw = _rng(seed, 3)
        self._next = 0

    # -- batches (closed loop) ------------------------------------------------------
    def variant_batch(self, k: int) -> Tuple[List[str], List[List[str]]]:
        """Batch k of a ``variants`` mix: (captions, variant lists)."""
        B, V, n = self.batch, int(self.mix["variants"]), len(self._groups)
        pick = [self._groups[(k * B + j) % n] for j in range(B)]
        return [g[0] for g in pick], [((g[1:] or g) * V)[:V] for g in pick]

    def warmup_batches(self) -> List[List[str]]:
        """The warm-up batches of a ``fresh`` mix (never drawn by the window)
        or the pool of a ``pool`` mix, in batches."""
        if self.kind == "pool":
            return [self.pool[i : i + self.batch] for i in range(0, len(self.pool), self.batch)]
        return [self._caps[i : i + self.batch] for i in range(self._warm_end, len(self._caps), self.batch)]

    def next_batch(self) -> List[str]:
        """The next window batch of a ``fresh`` or ``pool`` mix."""
        if self.kind == "fresh":
            lo, hi = self._next, self._next + self.batch
            if hi > self._warm_end:
                raise RuntimeError(
                    f"the fresh mix ran out of unseen captions after {lo}: widen the pool or shorten the window"
                )
            self._next = hi
            return self._caps[lo:hi]
        if self.kind == "pool":
            idx = self._draw.choice(len(self.pool), self.batch, replace=False)
            return [self.pool[i] for i in idx]
        raise ValueError(f"next_batch on a {self.kind!r} mix")

    # -- requests (open loop) ----------------------------------------------------------
    def schedule(self, seconds: float) -> List[Tuple[float, List[str]]]:
        """Open-loop requests due within ``seconds``: ``(due offset in s,
        captions)``, Poisson arrivals at ``rate_qps`` queries a second.

        The work is fixed, and only its order comes from the seed: every
        seed gets the same number of requests, the same inter-arrival gaps
        and the same request sizes, each permuted by the seed (the arrivals
        of a Poisson process given its count in the window), and captions
        drawn from the seed."""
        m = self.mix
        s, top = float(m["zipf_s"]), int(m["max_queries"])
        sizes_p = np.arange(1, top + 1, dtype=np.float64) ** -s
        sizes_p /= sizes_p.sum()
        mean_q = float((np.arange(1, top + 1) * sizes_p).sum())
        n = int(round(seconds * float(m["rate_qps"]) / mean_q))
        fixed = _rng(0, 5)  # the same gaps and sizes for every seed
        gaps = fixed.exponential(1.0, n + 1)
        sizes = fixed.choice(top, size=n, p=sizes_p) + 1
        rng = _rng(self.seed, 4)
        gaps, sizes = gaps[rng.permutation(n + 1)], sizes[rng.permutation(n)]
        due = np.cumsum(gaps)[:n] * (seconds / gaps.sum())
        return [(float(due[i]), [self._caps[int(j)] for j in rng.integers(0, len(self._caps), int(sizes[i]))])
                for i in range(n)]


def mean_zipf(s: float, top: int) -> float:
    p = np.arange(1, top + 1, dtype=np.float64) ** -s
    return float((np.arange(1, top + 1) * p).sum() / p.sum())

