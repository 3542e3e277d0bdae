"""Device resolution and the f32 matmul policy shared by the port's entry
points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the card. Without CUDA, only an explicit CPU device is
    accepted: an entry point never carries on on the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def disable_tf32(device: torch.device) -> None:
    """On the card, every f32 matmul and convolution in full f32: no TF32.
    The f32 plain paths are the references the kernels are held against,
    and TF32's 10-bit mantissa would move them by far more than the f32
    tolerances. Process-wide flags, set by each model built on the card."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
