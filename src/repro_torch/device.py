"""Device resolution and the kernel-backend switch.

``KERNEL_BACKEND`` mirrors ``repro.core.compressors.KERNEL_BACKEND``:

  * ``"auto"``  — a CUDA tensor goes through the hand-written kernel, a CPU
    tensor through the kernel's plain PyTorch version.  A CUDA tensor never
    falls back: its wrapper launches the kernel or raises.
  * ``"plain"`` — every wrapper runs its plain version, on any device (the
    tests, and ``chip_smoke.py``'s kernel-vs-plain comparison).
"""
from __future__ import annotations

import numpy as np
import torch

KERNEL_BACKEND = "auto"
BACKENDS = ("auto", "plain")


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``.  Asking for CUDA where there is none raises:
    nothing carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain versions")
    return dev


def use_kernel(t: torch.Tensor) -> bool:
    """Whether a wrapper given ``t`` launches its CUDA kernel."""
    if KERNEL_BACKEND == "plain":
        return False
    if KERNEL_BACKEND != "auto":
        raise ValueError(f"KERNEL_BACKEND={KERNEL_BACKEND!r}; "
                         f"valid: {BACKENDS}")
    return t.is_cuda


def host_ints(a, device: torch.device) -> torch.Tensor:
    """A copy of the host integers ``a`` as an int64 tensor on ``device``.
    On CUDA the copy goes through pinned memory and does not wait for the
    work already queued on the card (a copy from pageable memory would)."""
    t = torch.from_numpy(np.array(a, np.int64))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
