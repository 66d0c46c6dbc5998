"""Block-local TopK mask: CUDA kernel (``csrc/topk_mask.cu``) + plain
version.

Port of ``repro/kernels/topk_mask.py::topk_block``, the C(x) of a TopK
stage cut in training.  Each row of each ``bn``-wide tile keeps the
entries with ``|x| >= lo``, where ``lo`` comes from 24 float32 bisection
steps towards the ``k``-th largest magnitude, ``k = ceil(k_frac * bn)``:
at least ``k`` entries, every tie at ``lo`` included.
:func:`topk_block_plain` repeats the TPU kernel's arithmetic step for step
and agrees bitwise with it and with ``kernels/ref.py::topk_block_ref``.

The kernel takes the same ``lo`` by another road: a bisection step's
count ``#(|x| >= mid) > k`` holds exactly when the (row, tile) has a
(k+1)-th largest non-NaN magnitude ``a`` and ``mid <= a``, so it finds
``a`` by a radix select over the magnitudes' bits and runs the 24 steps
as scalar arithmetic (``tests/test_torch_topk_mask.py`` holds that
identity to :func:`topk_block_plain`).  Bound on the H100: memory bytes
(see the note in ``csrc/topk_mask.cu``).
"""
from __future__ import annotations

import math

import torch

from repro_torch import device as D
from repro_torch.kernels import _build

ITERS = 24
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "topk_block_launch": (_build.P, _build.P, _build.I32)
    + (_build.I64,) * 4 + (_build.P,),
}


def _tile(flat: torch.Tensor, k_frac: float, block):
    """``(bn, k)`` for ``flat``, after checking what the kernel takes.
    Rows are independent, so the row block does not matter."""
    if flat.ndim != 2 or flat.dtype not in _DTYPE_CODE:
        raise ValueError(f"topk_block takes a 2-D float32/bfloat16 "
                         f"tensor, got {tuple(flat.shape)} {flat.dtype}")
    m, n = flat.shape
    bn = min(block[1], n)
    if not (1 <= m < 1 << 16 and 1 <= bn < 1 << 31) or n % bn:
        raise ValueError(f"tile width {bn} does not tile {(m, n)} "
                         "(or 65536 rows or more)")
    return bn, max(1, int(math.ceil(k_frac * bn)))


def topk_block_plain(flat: torch.Tensor, k_frac: float,
                     block=(256, 512)) -> torch.Tensor:
    """Plain PyTorch version of :func:`topk_block` (a mirror of
    ``repro/kernels/ref.py::topk_block_ref``)."""
    bn, k = _tile(flat, k_frac, block)
    m, n = flat.shape
    t = flat.reshape(m, n // bn, bn)
    mag = t.to(torch.float32).abs()
    hi = mag.amax(dim=2, keepdim=True)
    lo = torch.zeros_like(hi)
    for _ in range(ITERS):
        mid = 0.5 * (lo + hi)
        gt = (mag >= mid).sum(dim=2, keepdim=True) > k
        lo = torch.where(gt, mid, lo)
        hi = torch.where(gt, hi, mid)
    return torch.where(mag >= lo, t, torch.zeros_like(t)).reshape(m, n)


def topk_block(flat: torch.Tensor, k_frac: float,
               block=(256, 512)) -> torch.Tensor:
    """flat: (M, N) float32/bfloat16; ``block[1]``: the tile width, capped
    at N, which must divide it.  Returns the masked tensor."""
    if not D.use_kernel(flat):
        return topk_block_plain(flat, k_frac, block)
    bn, k = _tile(flat, k_frac, block)
    flat = flat.contiguous()
    m, n = flat.shape
    out = torch.empty_like(flat)
    lib = _build.library("topk_mask", _SIGNATURES)
    with torch.cuda.device(flat.device):
        _build.call(lib, "topk_block_launch", flat.data_ptr(),
                    out.data_ptr(), _DTYPE_CODE[flat.dtype], m, n, bn, k,
                    torch.cuda.current_stream().cuda_stream)
    _build.count("topk_block")
    return out
