"""Inference-time compression boundaries.

Port of the serving half of ``repro/core/boundary.py``.  The training
boundary (``boundary_apply``, a ``custom_vjp`` in the reference) comes with
the training slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.policy import BoundaryPolicy
from repro_torch.transport.codecs import codec_for


def boundary_eval(policy: BoundaryPolicy, x: torch.Tensor, compress: bool):
    """Inference-time boundary: plain fw compressor or identity."""
    return policy.fw(x) if compress else x


def boundary_wire_eval(policy: BoundaryPolicy, x: torch.Tensor,
                       compress: bool) -> torch.Tensor:
    """Serve-time boundary through the wire-codec registry: pack the
    stage-cut tensor into its real payload and unpack it on the
    "receiving" stage.

    Packing is PER REQUEST: row ``b`` of the ``(B, ...)`` tensor is request
    ``b``'s own payload (the reference's ``jax.vmap`` over the batch,
    written out as a batch dimension), so q4/q8 carry one (min, scale) per
    request and a slot's numerics never depend on its batch neighbours.
    """
    if not compress or policy.fw.kind == "none":
        return x
    codec = codec_for(policy.fw)
    payload = codec.pack(x, policy.fw.k_frac, per_request=True)
    return codec.unpack(payload, x.shape, x.dtype)


def boundary_wire_bytes_per_token(policy, d_model: int,
                                  num_cuts: Optional[int] = None) -> float:
    """Bytes per decoded token crossing the stage cuts of a
    :class:`~repro_torch.core.policy.CompressionPolicy`.  ``num_cuts``: the
    effective cut count (``segment_bounds`` caps the stage count at the
    group count); defaults to ``policy.num_boundaries``."""
    total = 0.0
    cuts = policy.num_boundaries if num_cuts is None else num_cuts
    for i in range(cuts):
        bp = policy.at(i)
        codec = codec_for(bp.fw)
        total += codec.wire_bytes_per_elem(d_model, 2, bp.fw.k_frac) * d_model
    return total
