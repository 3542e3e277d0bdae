"""Hardware detection + device runtime surface, on CUDA.

Port of ``tvc/utils/hardware.py`` (reference src/utils/hardware_detector.py:
HardwareDetector :32, GPUInfo :511, SystemInfo :537, detect_and_configure
:561, and the memory stats / batch auto-tuning of src/utils/cuda_utils.py
:167+, :561). The detector reads ``torch.cuda`` and reports platform
``"gpu"``, JAX's name for a CUDA backend, so the profile tiers select on the
same word; with no card it reports ``"cpu"``. ``psutil`` is optional.
"""

from __future__ import annotations

import dataclasses
import os
import platform
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class DeviceInfo:
    """(reference GPUInfo :511, generalized)"""

    index: int
    platform: str  # gpu | cpu
    kind: str  # e.g. "NVIDIA H100 80GB HBM3"
    memory_bytes: Optional[int] = None
    coords: Optional[tuple] = None


@dataclasses.dataclass
class SystemInfo:
    """(reference SystemInfo :537)"""

    platform: str
    num_devices: int
    devices: List[DeviceInfo]
    host_count: int
    cpu_count: int
    memory_gb: float
    python_version: str
    torch_version: str


class HardwareDetector:
    """Probes the CUDA devices (reference HardwareDetector :32)."""

    def __init__(self):
        self._info: Optional[SystemInfo] = None

    def detect(self) -> SystemInfo:
        if self._info is not None:
            return self._info
        infos = []
        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                props = torch.cuda.get_device_properties(i)
                infos.append(
                    DeviceInfo(index=i, platform="gpu", kind=torch.cuda.get_device_name(i),
                               memory_bytes=int(props.total_memory))
                )
        else:
            infos.append(DeviceInfo(index=0, platform="cpu", kind=platform.processor() or "cpu"))
        try:
            import psutil

            mem_gb = psutil.virtual_memory().total / 1e9
            cpus = psutil.cpu_count() or os.cpu_count() or 1
        except ImportError:
            mem_gb = 0.0
            cpus = os.cpu_count() or 1
        self._info = SystemInfo(
            platform=infos[0].platform,
            num_devices=len(infos),
            devices=infos,
            host_count=1,
            cpu_count=cpus,
            memory_gb=mem_gb,
            python_version=platform.python_version(),
            torch_version=torch.__version__,
        )
        return self._info

    def has_tpu(self) -> bool:
        """Kept for the reference's surface: a CUDA host has no TPU."""
        return self.detect().platform == "tpu"

    def get_available_devices(self) -> List[DeviceInfo]:
        return self.detect().devices

    def summary(self) -> Dict[str, Any]:
        info = self.detect()
        return {
            "platform": info.platform,
            "num_devices": info.num_devices,
            "device_kinds": sorted({d.kind for d in info.devices}),
            "hosts": info.host_count,
            "torch": info.torch_version,
        }


def probe_device_health(
    timeout_s: float = 30.0, rtt_probes: int = 3, device: Optional[str] = None
) -> Dict[str, Any]:
    """Bounded end-to-end device health probe.

    A device that enumerates is not yet a device that computes: the only
    valid liveness signal is a completed dispatch + readback, so that is what
    this runs, on a daemon thread with a hard bound, never hanging the caller.
    The card unless ``device="cpu"``; with no card and no explicit CPU the
    result is unhealthy.

    Returns ``{"healthy": bool, "first_readback_s": float | None,
    "rtt_ms": [...], "platform": str, "device": str, "diagnosis": str}``.
    """
    out: Dict[str, Any] = {
        "healthy": False,
        "first_readback_s": None,
        "rtt_ms": [],
        "platform": None,
        "device": None,
        "diagnosis": "",
    }
    if device is None and not torch.cuda.is_available():
        out["platform"] = "cpu"
        out["diagnosis"] = "CUDA is not available; pass device='cpu' to probe the CPU"
        return out
    dev = torch.device("cuda" if device is None else device)
    out["platform"] = "gpu" if dev.type == "cuda" else dev.type
    out["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    done = threading.Event()
    errors: List[str] = []
    t0 = time.perf_counter()

    def _readback():
        try:
            x = torch.zeros((8, 8), device=dev)
            float((x + 1.0)[0, 0])
            out["first_readback_s"] = round(time.perf_counter() - t0, 3)
            for _ in range(rtt_probes):
                t1 = time.perf_counter()
                float((x + 1.0)[0, 0])
                out["rtt_ms"].append(round((time.perf_counter() - t1) * 1e3, 3))
        except Exception as e:  # reported through the result, never raised
            errors.append(f"{type(e).__name__}: {e}")
        done.set()

    threading.Thread(target=_readback, daemon=True).start()
    if not done.wait(timeout_s):
        out["diagnosis"] = f"dispatch+readback still pending after {timeout_s:.0f}s"
        return out
    if errors:
        out["diagnosis"] = f"dispatch+readback failed: {errors[0]}"
        return out
    out["healthy"] = True
    out["diagnosis"] = "ok"
    return out


def device_memory_stats(device=None) -> Dict[str, int]:
    """Live device memory stats (replaces GPUMonitor, reference
    cuda_utils.py:167+): ``torch.cuda.memory_stats`` with the reference's
    ``bytes_in_use`` / ``peak_bytes_in_use`` / ``bytes_limit`` keys added.
    Empty without a card."""
    if not torch.cuda.is_available():
        return {}
    dev = torch.device("cuda" if device is None else device)
    stats = dict(torch.cuda.memory_stats(dev))
    stats["bytes_in_use"] = int(stats.get("allocated_bytes.all.current", 0))
    stats["peak_bytes_in_use"] = int(stats.get("allocated_bytes.all.peak", 0))
    stats["bytes_limit"] = int(torch.cuda.get_device_properties(dev).total_memory)
    return stats


class DeviceMonitor:
    """Background device-memory polling (GPUMonitor role, reference
    cuda_utils.py:167+). Samples ``device_memory_stats`` on an interval;
    ``summary()`` reports peak/current usage."""

    def __init__(self, interval_s: float = 1.0):
        self.interval_s = interval_s
        self._samples: List[Dict[str, int]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def _poll(self) -> None:
        while not self._stop.wait(self.interval_s):
            stats = device_memory_stats()
            if stats:
                with self._lock:
                    self._samples.append(stats)

    def start(self) -> "DeviceMonitor":
        self._stop.clear()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def __enter__(self) -> "DeviceMonitor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            samples = list(self._samples)
        if not samples:
            return {"samples": 0}
        in_use = [s.get("bytes_in_use", 0) for s in samples]
        return {
            "samples": len(samples),
            "peak_bytes_in_use": max(in_use),
            "mean_bytes_in_use": int(np.mean(in_use)) if in_use else 0,
            "limit": samples[-1].get("bytes_limit"),
        }


def optimize_batch_size(
    run: Callable[[int], Any],
    initial: int = 1024,
    min_size: int = 1,
    max_tries: int = 8,
) -> int:
    """Find the largest batch size that executes without a memory error
    (reference cuda_utils.py:561 ``optimize_batch_size`` + the OOM
    retry-with-shrink loop :106-143, shrink factor here 1/2)."""
    size = initial
    for _ in range(max_tries):
        if size < min_size:
            break
        try:
            run(size)
            return size
        except Exception as e:  # torch.cuda.OutOfMemoryError and allocator errors
            if not isinstance(e, torch.cuda.OutOfMemoryError) and "out of memory" not in str(e).lower():
                raise
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            size //= 2
    return max(size, min_size)


def detect_and_configure() -> Dict[str, Any]:
    """(reference hardware_detector.py:561) -> config fragment for the
    dynamic profile system."""
    det = HardwareDetector()
    info = det.detect()
    from tvc_torch.utils.profiles import select_profile

    profile = select_profile(info)
    return {"hardware": det.summary(), "profile": dataclasses.asdict(profile)}
