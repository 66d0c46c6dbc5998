"""Per-tile min-max k-bit quantization: CUDA kernels (``csrc/quantize.cu``)
+ plain versions.

Port of ``repro/kernels/quantize.py``.  :func:`quant_dequant` is the C(x)
of a quantizing stage cut in training; :func:`quantize_wire` is the sender
side of the per-tile q8 wire format of the real pipeline (uint8 codes and a
``(gm, 2*gn)`` float32 meta array holding each tile's min and scale), and
:func:`dequantize_wire` its receiver side, torch ops as the reference's
jnp.  In :func:`quant_dequant`  Each ``(bm, bn)`` tile of the
``(M, N)`` input gets its own min/max scale; codes are
``clamp(round((x - min) / scale), 0, levels)`` and the result is
``codes * scale + min`` in the input type.

The scale is ``span / levels`` by IEEE division, as the reference's eager
oracle ``kernels/ref.py::quant_dequant_ref`` computes it; a jitted
reference computes ``span * f32(1/levels)`` instead (XLA's rewrite of a
division by a constant), which moves codes at rounding boundaries in the
tiles where the two scales differ.  The kernel and :func:`quant_dequant_plain`
agree bitwise with each other and with the eager oracle.

Bound on the H100: memory bytes (see the note in ``csrc/quantize.cu``).
"""
from __future__ import annotations

import torch

from repro_torch import device as D
from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "quant_dequant_launch": (_build.P, _build.P, _build.I32, _build.I32)
    + (_build.I64,) * 4 + (_build.P,),
    "quantize_wire_launch": (_build.P, _build.P, _build.P, _build.I32,
                             _build.I32) + (_build.I64,) * 4 + (_build.P,),
}


def _tiles(flat: torch.Tensor, bits: int, block):
    """The ``(bm, bn)`` tile of ``flat`` (``block`` capped at its shape),
    after checking what the kernel takes."""
    if flat.ndim != 2 or flat.dtype not in _DTYPE_CODE:
        raise ValueError(f"quant_dequant takes a 2-D float32/bfloat16 "
                         f"tensor, got {tuple(flat.shape)} {flat.dtype}")
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be in 1..8, got {bits}")
    m, n = flat.shape
    bm, bn = min(block[0], m), min(block[1], n)
    if bm < 1 or bn < 1 or m % bm or n % bn or m // bm >= 1 << 16:
        raise ValueError(f"block {(bm, bn)} does not tile {(m, n)} "
                         "(or makes 65536 row tiles or more)")
    return bm, bn


def _tile_codes(flat: torch.Tensor, bits: int, bm: int, bn: int):
    """Per-tile ``(codes, min, scale)`` of ``flat`` as float32 tensors of
    shape (gm, bm, gn, bn), (gm, 1, gn, 1), (gm, 1, gn, 1)."""
    m, n = flat.shape
    levels = (1 << bits) - 1
    t = flat.reshape(m // bm, bm, n // bn, bn).to(torch.float32)
    xmin = t.amin(dim=(1, 3), keepdim=True)
    span = t.amax(dim=(1, 3), keepdim=True) - xmin
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not IEEE division
    scale = torch.where(span > 0, span / torch.full_like(span, levels),
                        torch.ones_like(span))
    codes = torch.clamp(torch.round((t - xmin) / scale), 0, levels)
    return codes, xmin, scale


def quant_dequant_plain(flat: torch.Tensor, bits: int,
                        block=(256, 256)) -> torch.Tensor:
    """Plain PyTorch version of :func:`quant_dequant` (a mirror of
    ``repro/kernels/ref.py::quant_dequant_ref``)."""
    bm, bn = _tiles(flat, bits, block)
    codes, xmin, scale = _tile_codes(flat, bits, bm, bn)
    return (codes * scale + xmin).to(flat.dtype).reshape(flat.shape)


def quant_dequant(flat: torch.Tensor, bits: int,
                  block=(256, 256)) -> torch.Tensor:
    """flat: (M, N) float32/bfloat16; ``block``: the (bm, bn) tile, capped
    at (M, N), which must tile it.  Returns C(x) with per-tile scales."""
    if not D.use_kernel(flat):
        return quant_dequant_plain(flat, bits, block)
    bm, bn = _tiles(flat, bits, block)
    flat = flat.contiguous()
    m, n = flat.shape
    out = torch.empty_like(flat)
    lib = _build.library("quantize", _SIGNATURES)
    with torch.cuda.device(flat.device):
        _build.call(lib, "quant_dequant_launch", flat.data_ptr(),
                    out.data_ptr(), _DTYPE_CODE[flat.dtype], bits, m, n, bm,
                    bn, torch.cuda.current_stream().cuda_stream)
    _build.count("quant_dequant")
    return out


def quantize_wire_plain(flat: torch.Tensor, bits: int, block=(256, 256)):
    """Plain PyTorch version of :func:`quantize_wire` (a mirror of
    ``repro/kernels/ref.py::quantize_wire_ref``)."""
    bm, bn = _tiles(flat, bits, block)
    m, n = flat.shape
    codes, xmin, scale = _tile_codes(flat, bits, bm, bn)
    meta = torch.stack([xmin.reshape(m // bm, n // bn),
                        scale.reshape(m // bm, n // bn)], dim=-1)
    return (codes.to(torch.uint8).reshape(m, n),
            meta.reshape(m // bm, 2 * (n // bn)))


def quantize_wire(flat: torch.Tensor, bits: int, block=(256, 256)):
    """flat: (M, N) float32/bfloat16; ``block``: the (bm, bn) tile, capped
    at (M, N), which must tile it.  Returns (codes uint8 (M, N), meta
    float32 (M/bm, 2*N/bn)): tile (i, j)'s min at ``meta[i, 2j]``, its
    scale at ``meta[i, 2j+1]``."""
    if not D.use_kernel(flat):
        return quantize_wire_plain(flat, bits, block)
    bm, bn = _tiles(flat, bits, block)
    flat = flat.contiguous()
    m, n = flat.shape
    codes = torch.empty((m, n), dtype=torch.uint8, device=flat.device)
    meta = torch.empty((m // bm, 2 * (n // bn)), dtype=torch.float32,
                       device=flat.device)
    lib = _build.library("quantize", _SIGNATURES)
    with torch.cuda.device(flat.device):
        _build.call(lib, "quantize_wire_launch", flat.data_ptr(),
                    codes.data_ptr(), meta.data_ptr(),
                    _DTYPE_CODE[flat.dtype], bits, m, n, bm, bn,
                    torch.cuda.current_stream().cuda_stream)
    _build.count("quantize_wire")
    return codes, meta


def dequantize_wire(codes: torch.Tensor, meta: torch.Tensor,
                    dtype=torch.float32, block=(256, 256)) -> torch.Tensor:
    """Receiver side of :func:`quantize_wire`, torch ops as the reference's
    jnp: ``codes * scale + min`` per tile, in ``dtype``.  Two separate
    eager ops, so the dequant is never contracted into an FMA."""
    m, n = codes.shape
    bm, bn = min(block[0], m), min(block[1], n)
    gm, gn = m // bm, n // bn
    mins = meta[:, 0::2].to(dtype).reshape(gm, 1, gn, 1)
    scales = meta[:, 1::2].to(dtype).reshape(gm, 1, gn, 1)
    c = codes.reshape(gm, bm, gn, bn).to(dtype)
    return (c * scales + mins).reshape(m, n)
