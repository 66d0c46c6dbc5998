"""Compression operators for model-parallel boundary communication.

Port of ``repro/core/compressors.py``: uniform k-bit min-max quantization
(paper Sec. 2.2) and TopK sparsification (Sec. 2.3) as plain functions on
tensors, plus :class:`Compressor` with its wire-cost model.

``Compressor.__call__`` -- the C(x) of a training cut and of
``boundary_eval`` -- goes through ``kernels/ops.py`` on EVERY device:
per-``(bm, bn)``-tile quantization scales and the block-local TopK
bisection, the kernels on a CUDA tensor and their plain versions on a CPU
tensor.  That is the function the reference computes on its accelerator
(``KERNEL_BACKEND`` "pallas" / a TPU), not the per-tensor quantization and
exact per-example TopK its jnp path runs on a CPU.  Where autograd
differentiates a bare call (the encoder-decoder's memory hop), its
gradient is autodiff of the reference's per-tile oracle at the same tile
(the ``_ad`` functions there), on every device; under ``no_grad`` or
inside a cut's own backward only the forward runs.  Those two,
:func:`quantize_dequantize` and :func:`topk_mask` / :func:`topk_compress`,
stay for the callers that use them directly in the reference too: the
EF-mixed message (``core/feedback.py``), the ``reuse_indices`` mask
(``transport/simulated.py``) and the wire codecs.

Rounding matches the reference: ``torch.round`` is half-to-even like
``jnp.round``, and ``k = max(1, int(round(k_frac * n)))`` uses Python's
banker's ``round``.  ``lax.top_k`` breaks ties toward the lower index;
``torch.topk`` promises no tie order, so selection here is a stable sort.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.kernels.ops import quant_dequant_ad, topk_block_ad


def quantize_kbit(x: torch.Tensor, bits: int, dim=None):
    """Uniform k-bit quantization with min-max scaling.  ``dim=None``: one
    per-tensor min/max (the paper); ``dim``: per-slice stats, kept dims.
    Returns ``(codes, x_min, scale)`` with ``dequant = codes*scale + x_min``.
    """
    levels = (1 << bits) - 1
    if dim is None:
        x_min, x_max = x.min(), x.max()
    else:
        x_min, x_max = x.amin(dim=dim, keepdim=True), x.amax(dim=dim,
                                                             keepdim=True)
    span = x_max - x_min
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not IEEE division
    scale = torch.where(span > 0, span / torch.full_like(span, levels),
                        torch.ones_like(span))
    codes = torch.clamp(torch.round((x - x_min) / scale), 0, levels)
    return codes.to(torch.uint8 if bits <= 8 else torch.uint16), x_min, scale


def dequantize_kbit(codes, x_min, scale, dtype=torch.float32):
    return codes.to(dtype) * scale.to(dtype) + x_min.to(dtype)


def quantize_dequantize(x: torch.Tensor, bits: int, dim=None) -> torch.Tensor:
    """The C(x) of the convergence experiments: quantize then dequantize."""
    codes, x_min, scale = quantize_kbit(x, bits, dim=dim)
    return dequantize_kbit(codes, x_min, scale, dtype=x.dtype)


def topk_count(k_frac: float, n: int) -> int:
    return max(1, int(round(k_frac * n)))


def topk_mask(x: torch.Tensor, k_frac: float) -> torch.Tensor:
    """Per-example mask of the largest-|.| ``k_frac`` entries, keeping every
    tie at the threshold (``mag >= thresh``)."""
    flat = x.reshape(x.shape[0], -1)
    mag = flat.abs()
    k = topk_count(k_frac, flat.shape[1])
    thresh = torch.sort(mag, dim=1, descending=True)[0][:, k - 1:k]
    return (mag >= thresh).reshape(x.shape)


def topk_compress(x: torch.Tensor, k_frac: float) -> torch.Tensor:
    """C(x) for TopK: zero all but the largest-|.| K% entries."""
    return torch.where(topk_mask(x, k_frac), x, torch.zeros_like(x))


def topk_values_indices(x: torch.Tensor, k_frac: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, int32 indices) of the largest-|.| entries per example, in
    ``lax.top_k`` order: descending magnitude, ties by lower index."""
    flat = x.reshape(x.shape[0], -1)
    k = topk_count(k_frac, flat.shape[1])
    order = torch.sort(flat.abs(), dim=1, descending=True, stable=True)[1]
    idx = order[:, :k]
    return flat.gather(1, idx), idx.to(torch.int32)


def topk_scatter(vals: torch.Tensor, idx: torch.Tensor, shape,
                 dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`topk_values_indices`: scatter into dense zeros."""
    b = vals.shape[0]
    n = 1
    for s in shape[1:]:
        n *= s
    flat = torch.zeros((b, n), dtype=dtype, device=vals.device)
    flat.scatter_(1, idx.long(), vals.to(dtype))
    return flat.reshape(shape)


@dataclasses.dataclass(frozen=True)
class Compressor:
    """A named compression operator C(x) plus its wire-cost model.

    ``kind``: "none" | "quant" | "topk"; ``bits`` (quant); ``k_frac`` (topk).
    """
    kind: str = "none"
    bits: int = 8
    k_frac: float = 1.0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "none":
            return x
        if self.kind == "quant":
            return quant_dequant_ad(x, self.bits)
        if self.kind == "topk":
            return topk_block_ad(x, self.k_frac)
        raise ValueError(f"unknown compressor kind: {self.kind}")

    def wire_bytes_per_elem(self, elem_bytes: int = 2,
                            n: Optional[int] = None) -> float:
        """Bytes communicated per original element (bf16 baseline = 2);
        a TopK index is uint16 when ``n`` fits in 16 bits, else int32."""
        if self.kind == "none":
            return float(elem_bytes)
        if self.kind == "quant":
            return self.bits / 8.0
        if self.kind == "topk":
            idx_bytes = 2 if (n is not None and n <= (1 << 16)) else 4
            return self.k_frac * (elem_bytes + idx_bytes)
        raise ValueError(self.kind)

    @property
    def name(self) -> str:
        if self.kind == "none":
            return "none"
        if self.kind == "quant":
            return f"q{self.bits}"
        return f"top{int(round(self.k_frac * 100))}%"


IDENTITY = Compressor("none")


def quant(bits: int) -> Compressor:
    return Compressor("quant", bits=bits)


def topk(k_frac: float) -> Compressor:
    return Compressor("topk", k_frac=k_frac)
