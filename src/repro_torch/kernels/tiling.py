"""Logical tile shapes of the boundary kernels.

Port of ``repro/kernels/tiling.py`` (``lane_block``, ``pow2_row_block``).
These fix the SEMANTICS of the per-tile quantization scales and the
per-tile TopK budget, so the port must choose exactly the reference's
tiles; how a CUDA kernel maps a tile onto blocks and threads is its own
business (``csrc/``).
"""
from __future__ import annotations

from typing import Optional

LANE_BLOCKS = (2048, 1024, 512, 256, 128)
MAX_ROW_BLOCK = 256


def pow2_row_block(m: int, cap: int = MAX_ROW_BLOCK) -> int:
    """Largest power-of-two divisor of ``m``, capped at ``cap``."""
    return min(cap, m & -m) if m > 0 else 1


def lane_block(n: int) -> Optional[int]:
    """The widest of ``LANE_BLOCKS`` dividing ``n``; None when ``n`` is not
    a multiple of 128 (the caller then takes one whole-tensor tile)."""
    for c in LANE_BLOCKS:
        if n % c == 0:
            return c
    return None
