"""Logical tile shapes of the boundary kernels.

Port of ``repro/kernels/tiling.py`` (``lane_block``, ``pow2_row_block``,
``wire_tiling``).  These fix the SEMANTICS of the per-tile quantization
scales, the per-tile TopK budget and the q8 wire format, so the port must
choose exactly the reference's tiles; how a CUDA kernel maps a tile onto
blocks and threads is its own business (``csrc/``).
"""
from __future__ import annotations

from typing import Optional, Tuple

LANE_BLOCKS = (2048, 1024, 512, 256, 128)
MIN_SUBLANES = 8               # native f32 sublane tile of the reference
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


def wire_tiling(flat_shape) -> Optional[Tuple[int, int]]:
    """(bm, bn) for the tiled wire kernels, or None when no tiling fits
    (feature dim not a 128-multiple, or the row block would under-fill
    the native 8-sublane tile).  None sends the q8 codec to its
    per-tensor format."""
    m, n = flat_shape
    bn = lane_block(n)
    if bn is None:
        return None
    bm = pow2_row_block(m)
    if bm < MIN_SUBLANES:
        return None
    return bm, bn
