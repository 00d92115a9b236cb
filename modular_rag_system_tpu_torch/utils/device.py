"""Explicit device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a visible
    card raises.  Entry points default to ``"cuda"`` and never fall back
    to the CPU on their own: a caller that wants the CPU asks for it.
    On a CUDA device it also turns TF32 off for matmuls and cuDNN."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA device is visible; "
                "pass device='cpu' to run on the CPU")
        # true-f32 products everywhere: the exact tier, the master
        # rescore and the plain kernel versions assume them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
