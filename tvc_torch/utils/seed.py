"""Reproducibility utilities (port of ``tvc/utils/seed.py``).

``set_random_seed`` seeds Python's ``random``, numpy's global state and
torch (every device's generator); ``SeedContext`` restores all three on
exit. ``derive_key`` replaces the JAX package's threefry key chain with a
seeded ``torch.Generator``: deterministic per (seed, folds), not the same
bits as ``jax.random.fold_in``.
"""

from __future__ import annotations

import contextlib
import random
from typing import Iterator

import numpy as np
import torch


def set_random_seed(seed: int) -> None:
    """Seed the host RNGs and torch's generators (CPU and every card)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


@contextlib.contextmanager
def SeedContext(seed: int) -> Iterator[None]:
    """Scoped seeding; restores the prior ``random``, numpy and torch RNG
    states (the cards' too, where CUDA is initialized) on exit."""
    py_state = random.getstate()
    np_state = np.random.get_state()
    torch_state = torch.get_rng_state()
    cuda_states = torch.cuda.get_rng_state_all() if torch.cuda.is_initialized() else None
    set_random_seed(seed)
    try:
        yield
    finally:
        random.setstate(py_state)
        np.random.set_state(np_state)
        torch.set_rng_state(torch_state)
        if cuda_states is not None:
            torch.cuda.set_rng_state_all(cuda_states)


def derive_key(seed: int, *folds: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` seeded from (seed, *folds): the port's
    stand-in for a root key and its ``fold_in`` chain (e.g. fixed seeds per
    (prompt, image)). The same arguments give the same draws; the bits are
    not threefry's. On the card unless ``device="cpu"``."""
    from tvc_torch._device import resolve_device

    # the count first: SeedSequence reads (0, 1) and (0, 1, 0) alike
    words = [len(folds), int(seed) & 0xFFFFFFFF] + [int(f) & 0xFFFFFFFF for f in folds]
    mixed = int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=resolve_device(device)).manual_seed(mixed)
