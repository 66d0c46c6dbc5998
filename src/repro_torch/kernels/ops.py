"""Boundary-tensor entry points of the training-cut kernels.

Port of ``repro/kernels/ops.py``.  A boundary tensor of any rank is
flattened per example to ``(B, N)``; the tile is ``(pow2_row_block(B),
lane_block(N))`` as in the reference, and when ``N`` is not a multiple of
128 the whole tensor is one tile (the reference's jnp fallback; here the
same kernel on one tile).  The ``_st`` functions are straight-through
estimators: C(x) forward, identity backward.  The ``_ad`` functions give
C(x) the gradient the reference defines for a bare ``Compressor`` call
under autodiff (the whisper encoder's memory hop): autodiff of its
per-tile oracles ``kernels/ref.py::quant_dequant_ref`` and
``topk_block_ref`` at the same tile, written out as torch reductions
over the tile view, so the card and the CPU give the same gradient (a
kernel's output carries no autograd history of its own).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quantize import quant_dequant
from repro_torch.kernels.tiling import lane_block, pow2_row_block
from repro_torch.kernels.topk_mask import ITERS, block_k, topk_block


def _tile(flat: torch.Tensor):
    m, n = flat.shape
    bn = lane_block(n)
    return (m, n) if bn is None else (pow2_row_block(m), bn)


def quant_dequant_op(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-tile fused quant-dequant of a boundary tensor (any rank)."""
    flat = x.reshape(x.shape[0], -1)
    return quant_dequant(flat, bits, _tile(flat)).reshape(x.shape)


def topk_block_op(x: torch.Tensor, k_frac: float) -> torch.Tensor:
    """Block-local TopK of a boundary tensor (any rank)."""
    flat = x.reshape(x.shape[0], -1)
    return topk_block(flat, k_frac, _tile(flat)).reshape(x.shape)


class _QuantDequantST(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bits):
        return quant_dequant_op(x, bits)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _TopKBlockST(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k_frac):
        return topk_block_op(x, k_frac)

    @staticmethod
    def backward(ctx, g):
        return g, None


def quant_dequant_st(x: torch.Tensor, bits: int) -> torch.Tensor:
    return _QuantDequantST.apply(x, bits)


def topk_block_st(x: torch.Tensor, k_frac: float) -> torch.Tensor:
    return _TopKBlockST.apply(x, k_frac)


def _tile_view(x: torch.Tensor):
    """``x`` flattened per example as float32 ``(gm, bm, gn, bn)`` tiles,
    and the tile ``(bm, bn)``."""
    flat = x.reshape(x.shape[0], -1)
    (m, n), (bm, bn) = flat.shape, _tile(flat)
    return flat.reshape(m // bm, bm, n // bn, bn).to(torch.float32), (bm, bn)


def quant_dequant_vjp(x: torch.Tensor, g: torch.Tensor,
                      bits: int) -> torch.Tensor:
    """The gradient of the per-tile quant-dequant at ``x`` for the
    cotangent ``g``: ``y = round((x - mn) / s) * s + mn`` with the round's
    derivative 0, so only each tile's min and max receive gradient --
    the min ``sum(g) - sum(g * codes) / levels``, the max ``sum(g *
    codes) / levels`` (nothing through the scale of a constant tile) --
    split evenly among the entries tied for them (JAX's rule for
    ``min`` / ``max``).  The codes are computed again from ``x``, as the
    forward computes them (a tensor divisor: IEEE division on the card
    too): the bf16 output ``codes * s + mn`` does not give them back."""
    t, _ = _tile_view(x)
    gt = g.reshape(t.shape).to(torch.float32)
    levels = (1 << bits) - 1
    xmin = t.amin(dim=(1, 3), keepdim=True)
    xmax = t.amax(dim=(1, 3), keepdim=True)
    span = xmax - xmin
    lv = torch.full_like(span, levels)
    scale = torch.where(span > 0, span / lv, torch.ones_like(span))
    codes = torch.clamp(torch.round((t - xmin) / scale), 0, levels)
    d_scale = (gt * codes).sum(dim=(1, 3), keepdim=True)
    d_span = torch.where(span > 0, d_scale / lv, torch.zeros_like(d_scale))
    d_min = gt.sum(dim=(1, 3), keepdim=True) - d_span
    at_min, at_max = (t == xmin).to(torch.float32), (t == xmax).to(
        torch.float32)
    gx = (at_min * (d_min / at_min.sum(dim=(1, 3), keepdim=True))
          + at_max * (d_span / at_max.sum(dim=(1, 3), keepdim=True)))
    return gx.to(x.dtype).reshape(x.shape)


def topk_block_vjp(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                   k_frac: float) -> torch.Tensor:
    """The gradient of the block-local TopK at ``x`` (``y`` its output)
    for the cotangent ``g``: ``g`` on the kept entries (``|x| >= lo``),
    0 elsewhere.  A non-zero entry is kept where ``y`` holds it; a zero
    one where the (row, tile)'s ``lo`` stayed 0, i.e. where no bisection
    midpoint ``mid > 0`` counted more than k magnitudes ``>= mid``: while
    ``lo`` is 0 the midpoints are the row's max halved again and again,
    and the counts only grow as they fall, so the last positive one
    decides."""
    t, (_, bn) = _tile_view(x)
    k = block_k(k_frac, bn)
    mag = t.abs()
    mid = mag.amax(dim=3, keepdim=True)
    last = torch.zeros_like(mid)
    for _ in range(ITERS):
        mid = mid * 0.5
        last = torch.where(mid > 0, mid, last)
    zeros_kept = (last == 0) | ((mag >= last).sum(dim=3, keepdim=True) <= k)
    kept = (y.reshape(t.shape) != 0) | ((t == 0) & zeros_kept)
    return torch.where(kept.reshape(x.shape), g, torch.zeros_like(g))


class _QuantDequantAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bits):
        ctx.save_for_backward(x)
        ctx.bits = bits
        return quant_dequant_op(x, bits)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return quant_dequant_vjp(x, g, ctx.bits), None


class _TopKBlockAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k_frac):
        y = topk_block_op(x, k_frac)
        ctx.save_for_backward(x, y)
        ctx.k_frac = k_frac
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return topk_block_vjp(x, y, g, ctx.k_frac), None


def quant_dequant_ad(x: torch.Tensor, bits: int) -> torch.Tensor:
    return _QuantDequantAD.apply(x, bits)


def topk_block_ad(x: torch.Tensor, k_frac: float) -> torch.Tensor:
    return _TopKBlockAD.apply(x, k_frac)
