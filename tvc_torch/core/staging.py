"""Host-to-device uploads of batch inputs through a reused pinned buffer.

A pageable host array reaches the card through a synchronous copy that the
driver stages itself, and the host and every later launch wait for all of
it. ``PinnedStager.start`` instead hands the array to one persistent worker
thread, which copies it into a page-locked host buffer (``copy_``, which
releases the interpreter lock and runs on the intra-op threads) and issues
the copy to the device on a copy stream of its own, then records an event.
The caller goes on with its own host work meanwhile, best work that runs
on one thread, since the copy wants the other cores; ``Upload.wait`` joins
the worker and makes the current stream wait on the event, so the copy
engine's tail overlaps the kernels launched before it.

    up = stager(device).start(pixels)  # once the tokenizer's threads are done
    ...                                # stage the tokens, launch the text tower
    px = up.wait()                     # the pixels, on the device

What is staged follows the input: a host array (numpy or a CPU tensor) for
a CUDA device goes through the buffer; a tensor already on the device
passes through; a host array for a CPU device, or one larger than
``CAP_BYTES``, takes the plain copy (counted as ``upload.fallback``).

The buffer grows to the largest input seen, rounded up to a power of two,
and never shrinks. Before the worker writes into it, it waits on the event
of the copy that read it last, so no later upload overwrites bytes a copy
still reads, whether or not the earlier caller ever waited. Nothing is
cached by the caller's array: every upload copies its bytes anew.

Spans: ``detect.upload`` (worker: wait for the buffer, host copy, issue of
the device copy; ``bytes``) and ``detect.upload_wait`` (the caller, the time
``wait`` blocks), both children of the span open where ``start`` was
called. Counters: ``upload.staged``, ``upload.staged_bytes``,
``upload.fallback``.
"""

from __future__ import annotations

import queue
import threading
import warnings
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from tvc_torch._device import resolve_device
from tvc_torch.utils import tracing

#: inputs larger than this take the plain copy (and no buffer that large is pinned)
CAP_BYTES = 1 << 30


class Upload:
    """An input on its way to the device (``PinnedStager.start``)."""

    __slots__ = ("shape", "_tensor", "_event", "_done", "_error", "_parent")

    def __init__(self, shape: Tuple[int, ...], tensor: Optional[Tensor] = None, parent: int = 0):
        #: the shape of what ``wait`` returns
        self.shape = tuple(shape)
        self._tensor, self._event, self._error, self._parent = tensor, None, None, parent
        self._done = None if tensor is not None else threading.Event()

    def wait(self) -> Tensor:
        """The input on the device as f32, ordered on the current stream
        after its copy; blocks the host only until the worker has issued
        that copy."""
        if self._done is not None:
            with tracing.span("detect.upload_wait", parent=self._parent):
                self._done.wait()
            self._done = None
            if self._error is not None:
                raise self._error
            if self._event is not None:
                stream = torch.cuda.current_stream(self._tensor.device)
                stream.wait_event(self._event)
                self._tensor.record_stream(stream)  # allocated on the copy stream
            self._tensor = self._tensor.float()  # staged as it lay on the host
        return self._tensor


def _host_tensor(x) -> Optional[Tensor]:
    """A CPU tensor over the bytes of a host array (no copy where it can be
    avoided); None for a tensor on a device."""
    if torch.is_tensor(x):
        return x if x.device.type == "cpu" else None
    arr = np.asarray(x)
    if any(s < 0 for s in arr.strides):
        arr = np.ascontiguousarray(arr)
    if arr.flags.writeable:
        return torch.from_numpy(arr)
    with warnings.catch_warnings():  # read only: torch warns of writes it never makes
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(arr)


class PinnedStager:
    """Uploads to one device through one reused pinned host buffer; one per
    device (:func:`stager`), shared by every caller and thread. ``start``
    may be called from any thread; the worker takes the uploads in order."""

    def __init__(self, device: Union[str, torch.device]):
        self.device = torch.device(device)
        #: whether host arrays go through the worker and the buffer (CUDA
        #: devices); a CPU device takes the plain copy, unpinned
        self.engaged = self.device.type == "cuda"
        #: pinned buffers allocated so far (the buffer grows, never shrinks)
        self.allocations = 0
        self._buf: Optional[Tensor] = None
        self._last = None  # the event of the last device copy out of the buffer
        self._jobs: "queue.SimpleQueue" = queue.SimpleQueue()
        self._worker: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def start(self, x) -> Upload:
        """Begin moving ``x`` to the device; an :class:`Upload` whose
        ``wait()`` returns it there, as f32."""
        if torch.is_tensor(x) and x.device == self.device:
            return Upload(x.shape, x.float())
        src = _host_tensor(x)
        nbytes = src.numel() * src.element_size() if src is not None else 0
        if src is None or not self.engaged or nbytes > CAP_BYTES:
            if not torch.is_tensor(x) or x.device.type == "cpu":  # a host array not staged
                tracing.count("upload.fallback")
            t = torch.as_tensor(x, dtype=torch.float32, device=self.device)
            return Upload(t.shape, t)
        up = Upload(src.shape, parent=tracing.current())
        tracing.count("upload.staged")
        tracing.count("upload.staged_bytes", nbytes)
        with self._lock:
            if self._worker is None:
                self._worker = threading.Thread(target=self._serve, name="tvc-upload", daemon=True)
                self._worker.start()
            self._jobs.put((src, up))
        return up

    def close(self) -> None:
        """Stop the worker once it has taken every upload started before."""
        with self._lock:
            worker, self._worker = self._worker, None
            if worker is not None:
                self._jobs.put(None)
        if worker is not None:
            worker.join()

    # -- the worker -------------------------------------------------------------------------
    def _serve(self) -> None:
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.set_device(self.device)
            stream = torch.cuda.Stream(self.device)
        while True:
            job = self._jobs.get()
            if job is None:
                return
            src, up = job
            try:
                nbytes = src.numel() * src.element_size()
                with tracing.span("detect.upload", parent=up._parent, bytes=nbytes):
                    if self._last is not None:
                        self._last.synchronize()
                    host = self._buffer(nbytes)[:nbytes].view(src.dtype).view(src.shape)
                    host.copy_(src)
                    if cuda:
                        with torch.cuda.stream(stream):
                            dev = torch.empty(src.shape, dtype=src.dtype, device=self.device)
                            dev.copy_(host, non_blocking=True)
                            self._last = up._event = torch.cuda.Event()
                            up._event.record(stream)
                    else:
                        dev = host.clone()
                up._tensor = dev
            except Exception as e:  # handed to the caller, which raises it in wait()
                up._error = e
            finally:
                up._done.set()

    def _buffer(self, nbytes: int) -> Tensor:
        """The host buffer, grown to hold ``nbytes``."""
        if self._buf is None or self._buf.numel() < nbytes:
            size = 1 << max(nbytes - 1, 1).bit_length()
            self._buf = None  # the old one goes back to the host allocator first
            self._buf = torch.empty(size, dtype=torch.uint8, pin_memory=self.device.type == "cuda")
            self.allocations += 1
        return self._buf


_STAGERS: Dict[torch.device, PinnedStager] = {}
_STAGERS_LOCK = threading.Lock()


def stager(device: Union[str, torch.device]) -> PinnedStager:
    """The process's stager for ``device``."""
    device = resolve_device(device)
    with _STAGERS_LOCK:
        st = _STAGERS.get(device)
        if st is None:
            st = _STAGERS[device] = PinnedStager(device)
        return st
