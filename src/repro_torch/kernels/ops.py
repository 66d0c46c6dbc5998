"""Boundary-tensor entry points of the training-cut kernels.

Port of ``repro/kernels/ops.py``.  A boundary tensor of any rank is
flattened per example to ``(B, N)``; the tile is ``(pow2_row_block(B),
lane_block(N))`` as in the reference, and when ``N`` is not a multiple of
128 the whole tensor is one tile (the reference's jnp fallback; here the
same kernel on one tile).  The ``_st`` functions are straight-through
estimators: C(x) forward, identity backward.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quantize import quant_dequant
from repro_torch.kernels.tiling import lane_block, pow2_row_block
from repro_torch.kernels.topk_mask import topk_block


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
