"""The benchmark's spans around the calls into each layer of the program,
installed for the traced run only: each wraps a function of a program
module in a ``torch.profiler.record_function`` range of its own name and,
while recording, keeps the call's host seconds and the shapes the work
model needs. Nothing of the program changes: the wrapper calls through
and returns what the function returned."""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional

from torch.profiler import record_function


class Spans:
    def __init__(self):
        self.recording = False
        self.host_s: Dict[str, List[float]] = defaultdict(list)
        self.shapes: Dict[str, List[Any]] = defaultdict(list)
        self._undo: List = []

    def wrap(self, owner, attr: str, name: str, shape: Optional[Callable[..., Any]] = None) -> None:
        """Replace ``owner.attr`` by a pass-through inside range ``name``."""
        orig = getattr(owner, attr)
        spans = self

        def wrapper(*args, **kwargs):
            with record_function(name):
                if spans.recording and shape is not None:
                    spans.shapes[name].append(shape(*args, **kwargs))
                return orig(*args, **kwargs)

        setattr(owner, attr, wrapper)
        self._undo.append((owner, attr, orig))

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        with record_function(name):
            yield
        if self.recording:
            self.host_s[name].append(time.perf_counter() - t0)

    def restore(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()


def i8_layer_shapes(spans: Spans, clip_mod) -> None:
    """Ranges around the int8 CLIP layer calls, keeping ``(B, T, W, heads,
    causal)`` / ``(B, T, W, hidden)``."""
    spans.wrap(clip_mod, "fused_attention_layer_i8", "i8_attention_layer",
               lambda x, *a, heads, causal=False, **k: (*x.shape, heads, bool(causal)))
    spans.wrap(clip_mod, "fused_mlp_layer_i8", "i8_mlp_layer",
               lambda x, ls, lb, wfc, *a, **k: (*x.shape, int(wfc.shape[1])))
