"""Compression boundaries at the pipeline-stage cuts.

Port of ``repro/core/boundary.py``.  In training, :func:`boundary_apply`
compresses the forward activation through the policy's
:class:`~repro_torch.transport.simulated.SimulatedTransport` and, during
backward, the activation-gradient through the same transport's ``bw``:

  forward : y  = F(x)   F: the fw compressor, optionally wrapped in
                         EF / EF21 / EF-mixed / AQ-SGD feedback;
  backward: gx = G(gy)  G: the bw compressor, optionally wrapped in
                         EF / EF21 / EF-mixed feedback, or the forward TopK
                         mask under ``reuse_indices``.

State threading.  The forward buffer's update is returned with ``y``.  The
backward buffer's update is only known during backward: the reference
returns it as the cotangent of ``bw_buf``; the port writes it into a
:class:`BwSlot` that :func:`boundary_apply` returns, and the train step
reads the slot after ``backward()``.

At inference, :func:`boundary_eval` applies the plain fw compressor and
:func:`boundary_wire_eval` packs and unpacks the real wire payload, per
request; :func:`boundary_wire_eval_tokens` per (request, token), for
multi-token decode spans.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.feedback import FeedbackState, init_feedback
from repro_torch.core.policy import BoundaryPolicy
from repro_torch.transport.codecs import codec_for
from repro_torch.transport.simulated import simulated_transport


@dataclasses.dataclass
class BwSlot:
    """One cut's backward feedback state: the state the cut was given
    until backward runs through the cut, the new state after."""
    state: FeedbackState


class _Boundary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, policy, fw_state, ids, slot):
        m, new_fw, mask = simulated_transport(policy).fw(x, fw_state, ids)
        ctx.policy, ctx.mask, ctx.slot = policy, mask, slot
        return m, new_fw

    @staticmethod
    def backward(ctx, g, _g_new_fw):
        gx, ctx.slot.state = simulated_transport(ctx.policy).bw(
            g, ctx.slot.state, ctx.mask)
        return gx, None, None, None, None


def boundary_apply(policy: BoundaryPolicy, x: torch.Tensor,
                   fw_state: FeedbackState, bw_state: FeedbackState, ids):
    """Training-time boundary.  Returns ``(y, new_fw_state, bw_slot)``.

    ``y`` is the forward message, computed without autograd; the gradient
    that leaves the cut is exactly the bw transport's message.
    ``ids``: (B,) example ids (AQ-SGD only; may be None otherwise).
    ``bw_slot.state`` holds the new backward state once backward has run
    through the cut."""
    slot = BwSlot(bw_state)
    y, new_fw = _Boundary.apply(x, policy, fw_state, ids, slot)
    # EF21 / AQ-SGD keep the message itself as their buffer: store it
    # without the autograd history that ``y`` now carries
    return y, new_fw.map(torch.Tensor.detach), slot


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


def boundary_wire_eval_tokens(policy: BoundaryPolicy, x: torch.Tensor,
                              compress: bool) -> torch.Tensor:
    """Per-(request, token) wire packing for multi-token decode spans.

    ``x``: (B, T, d).  Each token's cut tensor is its OWN payload: the
    ``(B, T, d)`` tensor is packed as ``B * T`` rows of one ``(1, d)``
    payload each (``per_request=True``), the granularity
    :func:`boundary_wire_eval` gives a T = 1 decode tick (the reference's
    double ``jax.vmap``).  Scales and TopK counts are then those of
    per-token decode, which keeps a speculative verification span's
    numerics those of plain greedy decode, and a prefill's independent
    of its chunking.
    """
    if not compress or policy.fw.kind == "none":
        return x
    b, t = x.shape[:2]
    rows = x.reshape(b * t, *x.shape[2:])
    return boundary_wire_eval(policy, rows, compress).reshape(x.shape)


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


def empty_boundary_state(dtype=torch.float32, device=None):
    """Buffer-free ``{'fw', 'bw'}`` state pair of a cut without feedback."""
    return {d: init_feedback("none", (), direction=d, dtype=dtype,
                             device=device) for d in ("fw", "bw")}


def init_boundary_state(policy: BoundaryPolicy, feat_shape, *, batch: int,
                        num_samples: int = 0, dtype=torch.float32,
                        device=None):
    """``{'fw': FeedbackState, 'bw': FeedbackState}`` for one cut
    (``resid`` is size 0 when the direction has no feedback)."""
    kw = dict(dtype=dtype, num_samples=num_samples, batch=batch,
              device=device)
    return {"fw": init_feedback(policy.feedback, feat_shape, direction="fw",
                                **kw),
            "bw": init_feedback(policy.bw_feedback, feat_shape,
                                direction="bw", **kw)}


def init_all_boundary_states(comp_policy, feat_shape, *, batch: int,
                             num_samples: int = 0, dtype=torch.float32,
                             device=None):
    """One state dict per cut of a CompressionPolicy."""
    return [init_boundary_state(comp_policy.at(i), feat_shape, batch=batch,
                                num_samples=num_samples, dtype=dtype,
                                device=device)
            for i in range(comp_policy.num_boundaries)]
