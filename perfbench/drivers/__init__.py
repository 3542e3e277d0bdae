"""Drivers: one per way of calling the program (a closed loop over the
detector, the pipeline's stream, the serving runtime under open-loop
arrivals). A cell names its driver in ``workloads/<cell>.json``; the
driver reads the cell's configuration and mix, builds the program from
seeded inputs, warms it up, runs the window and judges a sample of what the
window returned against the plain reference."""

from __future__ import annotations

from typing import List

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from perfbench.trace import WINDOW_RANGE


class SubWindow:
    """Profiles a steady stretch of a traced run: from the start of step
    ``first`` to the start of step ``first + count`` (or the end of the
    window), inside one ``perfbench.window`` range."""

    def __init__(self, enabled: bool, first: int, count: int, path, spans):
        self.enabled, self.first, self.count, self.path, self.spans = enabled, first, count, path, spans
        self._prof = None
        self._rf = None
        self.steps = 0
        self.done = False

    def step(self, i: int) -> None:
        """Call at the start of step ``i`` of the window."""
        if not self.enabled or self.done:
            return
        if self._prof is None and i >= self.first and i < self.first + self.count:
            torch.cuda.synchronize()
            self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._rf = record_function(WINDOW_RANGE)
            self._rf.__enter__()
            self.spans.recording = True
            self._started = i
        elif self._prof is not None and i >= self.first + self.count:
            self.stop()
        if self._prof is not None:
            self.steps = i - self._started + 1

    def stop(self) -> None:
        if self._prof is None or self.done:
            return
        torch.cuda.synchronize()
        self.spans.recording = False
        self._rf.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.steps = min(self.steps, self.count)
        self._prof.export_chrome_trace(str(self.path))
        self._prof = None
        self.done = True


def sample_rows(n_total: int, n: int, seed: int) -> List[int]:
    """``n`` distinct row numbers of ``n_total``, drawn from the seed."""
    import numpy as np

    rng = np.random.default_rng([int(seed) & (2**63 - 1), 99])
    return sorted(rng.choice(n_total, size=min(n, n_total), replace=False).tolist())
