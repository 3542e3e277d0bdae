"""AdamW and the warmup-cosine schedule, as optax computes them.

The JAX package trains with ``optax.adamw`` (``make_train_step``'s
default is ``adamw(1e-5)``) and, for the COCO fixture,
``optax.warmup_cosine_decay_schedule``. The port carries its own copy of
both, functional like optax (``init(params) -> state``,
``update(grads, state, params) -> (updates, state)``, nothing mutated):

* optax's defaults, not torch's: b1 0.9, b2 0.999, eps 1e-8 added outside
  the square root, and weight decay **1e-4** (``torch.optim.AdamW`` takes
  1e-2) added to every leaf's update before the learning rate scales it;
* the bias corrections ``1 - b^t`` in f32 at the incremented count;
* a schedule is read at the count *before* the update, so the first
  update of a warmup from 0 is zero (``LambdaLR`` steps once ahead).

State: ``{"count": int, "mu": tree, "nu": tree}``, tensors like the
parameters' and a Python int, which ``tvc_torch.utils.CheckpointManager``
saves and restores.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple, Union

import numpy as np
import torch
from torch import Tensor

Schedule = Callable[[int], float]


def _leaves(tree: Dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _rebuild(names, values) -> Dict:
    tree: Dict = {}
    for name, v in zip(names, values):
        node = tree
        *path, leaf = name.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _tree_map(fn: Callable[[Tensor], Any], tree: Dict) -> Dict:
    names, values = zip(*_leaves(tree)) if tree else ((), ())
    return _rebuild(names, [fn(v) for v in values])


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``optax.adamw``: scale_by_adam, add_decayed_weights,
    scale_by_learning_rate (a constant or a schedule of the count)."""

    learning_rate: Union[float, Schedule]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4

    def lr(self, count: int) -> float:
        """The learning rate of the update made at ``count`` (f32)."""
        lr = self.learning_rate(count) if callable(self.learning_rate) else self.learning_rate
        return float(np.float32(lr))

    def init(self, params: Dict) -> Dict:
        zeros = _tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        return {"count": 0, "mu": zeros, "nu": _tree_map(torch.clone, zeros)}

    def update(self, grads: Dict, state: Dict, params: Dict) -> Tuple[Dict, Dict]:
        names, g = zip(*_leaves(grads))
        p, mu, nu = ([by_name[n] for n in names] for by_name in (dict(_leaves(t)) for t in (params, state["mu"], state["nu"])))
        count = int(state["count"]) + 1
        f = torch._foreach_add
        mu = f(torch._foreach_mul(g, 1 - self.b1), torch._foreach_mul(mu, self.b1))
        nu = f(torch._foreach_mul(torch._foreach_mul(g, g), 1 - self.b2), torch._foreach_mul(nu, self.b2))
        one = np.float32(1.0)
        bc1 = float(one - np.power(np.float32(self.b1), np.float32(count)))
        bc2 = float(one - np.power(np.float32(self.b2), np.float32(count)))
        u = torch._foreach_div(torch._foreach_div(mu, bc1), f(torch._foreach_sqrt(torch._foreach_div(nu, bc2)), self.eps))
        if self.weight_decay:
            u = f(u, torch._foreach_mul(p, self.weight_decay))
        u = torch._foreach_mul(u, -self.lr(count - 1))
        return _rebuild(names, u), {"count": count, "mu": _rebuild(names, mu), "nu": _rebuild(names, nu)}


def adamw(learning_rate: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> AdamW:
    """``optax.adamw`` with its defaults (``eps_root`` 0, no mask)."""
    return AdamW(learning_rate, b1, b2, eps, weight_decay)


def apply_updates(params: Dict, updates: Dict) -> Dict:
    """New tensors ``p + u`` in ``p``'s dtype; ``params`` is not touched."""
    names, p = zip(*_leaves(params))
    by_name = dict(_leaves(updates))
    u = [by_name[n] for n in names]
    return _rebuild(names, [(a + b).to(a.dtype) for a, b in zip(p, u)])


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0, exponent: float = 1.0) -> Schedule:
    """optax's: linear from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then a cosine to ``end_value`` over ``decay_steps -
    warmup_steps`` steps, held there after; computed in f32."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"the cosine needs positive decay_steps - warmup_steps, got {decay_steps - warmup_steps}")
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = f32(decay_steps - warmup_steps)

    def schedule(count: int) -> float:
        count = int(count)
        if count < warmup_steps:
            if warmup_steps <= 0:
                return float(f32(init_value))
            frac = f32(1) - f32(min(max(count, 0), warmup_steps)) / f32(warmup_steps)
            return float(f32(init_value - peak_value) * frac + f32(peak_value))
        c = min(f32(count - warmup_steps), cos_steps)
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / cos_steps, dtype=np.float32))
        return float(f32(peak_value) * (f32(1 - alpha) * cosine ** f32(exponent) + f32(alpha)))

    return schedule
