"""Real pipeline with compressed, differentiable stage handoffs.

Port of ``repro/transport/pipeline.py``.  The pipeline x DP step
(``train/steps.py``) calls :func:`pipeline_apply` once per replica row,
on the row's batch shard, stack copy and buffer rows: the reference's
``dp_axis``.  With ``tp_axis`` every stage runs tensor-parallel over its
own ring of ranks (``transport/tp_collectives.py``), and each rank's
sequence shard crosses the stage cut on its own hop.  The reference runs
the pipeline as one SPMD program over a mesh of S devices: every stage
cut is a ``ppermute`` of a packed payload inside ``shard_map``.  This
port is a SINGLE-CONTROLLER pipeline in one process: every logical stage
runs on the device the caller's tensors live on, and a hop is what the
wire would carry.  The sender packs the payload with the boundary
policy's codec and, when the schedule fuses its hops (1f1b,
interleaved), frames it into one uint8 buffer (``codecs.fuse_payload``);
the receiver unframes and unpacks it.  The bytes of every hop are
counted, per direction, in the :class:`PipelineSlot` that
:func:`pipeline_apply` returns.  Placing the stages on several cards and
moving the payloads with ``torch.distributed`` point-to-point sends is a
later slice (NCCL refuses two ranks on one card, and gloo sends CPU
tensors only).

The loop is driven by the schedule's plan in the reference's ``(tick,
device)`` order, but it computes only the VALID (microbatch, logical
stage) pairs.  The reference also computes the fill/drain ticks and the
wrap-around hop of the last device (gpipe, 1f1b), then masks them
(``pipeline.py:404-416``, ``:742``).  Here they do not exist, so each step
makes exactly ``microbatches * (v*S - 1)`` hops per direction.  One
visible difference: the reference's masked wrap-around hop writes its
payload into two buffer slots that no real cut uses (the last logical
stage's fw ``resid`` and logical stage 0's fw ``mirror``); here those
slots stay zero.

Each hop is a ``torch.autograd.Function`` (:class:`_Hop`): its forward is
the forward hop (feedback gather, pack, frame, unframe, unpack, feedback
write); its backward packs the activation-gradient with the policy's
``bw`` codec and sends it back, and with ``reuse_indices`` (paper Table 5)
sends the VALUES only, gathered at the forward TopK indices.  The
rematerialized schedules wrap only the stage body in
``torch.utils.checkpoint``, never the hop, so a recompute launches no wire
kernel and writes no buffer twice.

Error feedback (paper Sec. 2.4/2.5, Tables 3-4) over the wire: the
stage-stacked buffers of :func:`init_feedback_state` hold, for the cut
from device ``d`` (chunk ``k``) to device ``d'`` (chunk ``k'``) of
microbatch ``j``:

  ============  =================
  fw ``resid``  ``[d][k, j]``
  fw ``mirror`` ``[d'][k', j]``
  bw ``resid``  ``[d'][k', j]``
  bw ``mirror`` ``[d][k, j]``
  ============  =================

(rows are example ids for AQ-SGD).  What crosses the wire is the
COMPENSATED message: EF packs ``x + e``; EF-mixed two half-K payloads
``{x, e}``; EF21 / AQ-SGD a compressed delta that the receiver adds to its
MIRROR of the sender's buffer.  The buffers are updated IN PLACE (the
reference returns new arrays, the backward ones as the cotangent of
``bw_state``): the forward ones as the forward hops run, the backward ones
as ``backward()`` runs through the hops.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.compressors import topk_count, topk_scatter
from repro_torch.core.feedback import (FeedbackState, gather_rows, get_mode,
                                       needs_recv_mirror, scatter_rows)
from repro_torch.core.policy import BoundaryPolicy, quant_policy, topk_policy
from repro_torch.obs import trace
from repro_torch.obs.keyed import trace_time_instant
from repro_torch.optim.optimizers import tree_map
from repro_torch.transport.base import Transport
from repro_torch.transport.codecs import (LeafStruct, codec_for,
                                          fuse_payload, payload_leaves,
                                          payload_struct, unfuse_payload,
                                          wire_bytes)
from repro_torch.transport.schedules import Schedule, as_schedule
from repro_torch.transport.tp_collectives import tp_local

# the boundary policy of each wire scheme, both directions alike
SCHEME_POLICIES = {
    "none": lambda k: BoundaryPolicy(),
    "q8": lambda k: quant_policy(8, 8),
    "q4": lambda k: quant_policy(4, 4),
    "topk": lambda k: topk_policy(k),
    "topk_reuse": lambda k: topk_policy(k, reuse_indices=True),
}


# ---------------------------------------------------------------------------
# Feedback state
# ---------------------------------------------------------------------------

def init_feedback_state(policy: BoundaryPolicy, feat_shape, *,
                        num_stages: int, batch: int,
                        microbatches: Optional[int] = None,
                        num_samples: int = 0, dtype=torch.float32,
                        virtual_stages: int = 1, dp: int = 1, device=None):
    """Per-stage feedback buffers for the pipeline: ``{"fw", "bw"}``
    feedback states whose ``resid`` / ``mirror`` carry leading
    dim ``num_stages`` (device ``d``'s slice), then a chunk dim when
    ``virtual_stages > 1``.  Global modes (ef/ef21/efmixed) keep
    ``(S, [v,] mb, B/(mb*dp), *feat)``, AQ-SGD ``(S, [v,]
    num_samples/dp, *feat)``; unused buffers are size-0 ``(S, 0)``
    placeholders.  The reference's shapes.

    ``dp > 1`` (the pipeline x DP step) puts a replica dim first: replica
    row ``r`` compensates its own contiguous batch shard, and AQ-SGD's
    buffer splits BY EXAMPLE ID (row ``r`` owns ids ``[r*ns/dp,
    (r+1)*ns/dp)``, addressed with ids localized by
    ``core/feedback.shard_ids``)."""
    mb = microbatches or num_stages
    if batch % (mb * dp):
        raise ValueError(f"batch {batch} not divisible by microbatches "
                         f"{mb} x dp {dp}")
    mbsz = batch // (mb * dp)
    chunk = () if virtual_stages == 1 else (virtual_stages,)
    rep = () if dp == 1 else (dp,)

    def buf(mode: str, mirror: bool):
        if mode == "none" or (mirror and not needs_recv_mirror(mode)):
            shape = (*rep, num_stages, 0)
        elif get_mode(mode).per_example:
            if num_samples <= 0:
                raise ValueError("aqsgd needs the dataset size "
                                 "(num_samples > 0)")
            if num_samples % dp:
                raise ValueError(
                    f"aqsgd + dp shards the per-example buffer by id: "
                    f"num_samples {num_samples} must be divisible by "
                    f"dp {dp}")
            shape = (*rep, num_stages, *chunk, num_samples // dp,
                     *feat_shape)
        else:
            shape = (*rep, num_stages, *chunk, mb, mbsz, *feat_shape)
        return torch.zeros(shape, dtype=dtype, device=device)

    def fbs(mode: str, direction: str) -> FeedbackState:
        return FeedbackState(resid=buf(mode, False), mirror=buf(mode, True),
                             agg=torch.zeros((0,), dtype=dtype,
                                             device=device),
                             scope="boundary", direction=direction,
                             mode=mode)

    return {"fw": fbs(policy.feedback, "fw"),
            "bw": fbs(policy.bw_feedback, "bw")}


def _empty_state(num_stages: int, dtype, direction: str,
                 device=None) -> FeedbackState:
    z = torch.zeros((num_stages, 0), dtype=dtype, device=device)
    return FeedbackState(resid=z, mirror=z,
                         agg=torch.zeros((0,), dtype=dtype, device=device),
                         scope="boundary", direction=direction, mode="none")


# ---------------------------------------------------------------------------
# The wire at one stage cut
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Cut:
    """One hop's addressing: microbatch ``j`` (example ``ids``) crosses
    from device ``d`` chunk ``k`` to device ``d2`` chunk ``k2``."""
    d: int
    k: int
    d2: int
    k2: int
    j: int
    ids: torch.Tensor


@dataclasses.dataclass
class PipelineSlot:
    """What a :func:`pipeline_apply` call leaves for after ``backward()``:
    the backward feedback state (its buffers written in place as the
    backward hops run) and the wire counters of the step, per direction
    (``fw_hops``, ``fw_bytes``, ``bw_hops``, ``bw_bytes``)."""
    state: FeedbackState
    wire: dict


class PipelineTransport(Transport):
    """The real wire at a stage cut: a packed payload each direction.

    ``fused=True`` (the 1f1b/interleaved default) frames each hop's
    payload into ONE contiguous uint8 buffer, byte-identical on the wire.
    ``wire`` counts the hops and bytes this transport moved."""

    def __init__(self, policy: BoundaryPolicy, num_stages: int, *,
                 virtual_stages: int = 1, fused: bool = False):
        if policy.reuse_indices and (policy.feedback != "none"
                                     or policy.bw_feedback != "none"):
            raise NotImplementedError(
                f"reuse_indices=True conflicts with feedback="
                f"{policy.feedback!r} / bw_feedback={policy.bw_feedback!r} "
                "on the real pipeline: the backward payload is values-only, "
                "gathered at the forward TopK indices, but a compensated "
                "message C(x + e) keeps different coordinates than C(x).  "
                "Valid: reuse_indices with no feedback (paper Table 5), or "
                "feedback without reuse_indices (paper Tables 3-4).")
        for mode, comp, nm in ((policy.feedback, policy.fw, "fw"),
                               (policy.bw_feedback, policy.bw, "bw")):
            if mode == "efmixed" and comp.kind != "topk":
                raise ValueError(f"EF-mixed needs a TopK {nm} compressor")
        self.policy = policy
        self.num_stages = num_stages
        self.virtual_stages = virtual_stages
        self.fused = fused
        self._fw_codec = codec_for(policy.fw)
        self._bw_codec = codec_for(policy.bw)
        self.wire = {"fw_hops": 0, "fw_bytes": 0, "bw_hops": 0,
                     "bw_bytes": 0}

    def _hop(self, payload, direction: str):
        """One hop of a packed payload: counted, and framed into one byte
        buffer and back when the schedule fuses its hops."""
        self.wire[f"{direction}_hops"] += 1
        self.wire[f"{direction}_bytes"] += wire_bytes(payload)
        if not self.fused:
            return payload
        return unfuse_payload(fuse_payload(payload), payload_struct(payload))

    # -- wire framing -------------------------------------------------------

    def pack_fw_message(self, y, buf_slice):
        """Compensated forward payload + the new send-buffer slice."""
        p, kf = self.policy, self.policy.fw.k_frac
        pack = self._fw_codec.pack
        unpack = lambda pl: self._fw_codec.unpack(pl, y.shape, y.dtype)
        if p.feedback == "none":
            return pack(y, kf), buf_slice
        if p.feedback == "ef":
            xe = y + buf_slice.to(y.dtype)
            payload = pack(xe, kf)
            return payload, xe - unpack(payload)
        if p.feedback == "efmixed":
            e = buf_slice.to(y.dtype)
            payload = {"x": pack(y, kf / 2.0), "e": pack(e, kf / 2.0)}
            return payload, (y + e) - (unpack(payload["x"])
                                       + unpack(payload["e"]))
        # delta-coded: ef21 / aqsgd — the wire carries C(x - buf) only
        b = buf_slice.to(y.dtype)
        payload = pack(y - b, kf)
        return payload, b + unpack(payload)

    def unpack_fw_message(self, moved, shape, dtype, recv_slice):
        """Receiver-side decode of :meth:`pack_fw_message`'s payload.
        Returns (message, new recv-mirror slice or None)."""
        p = self.policy
        unpack = lambda pl: self._fw_codec.unpack(pl, shape, dtype)
        if p.feedback in ("none", "ef"):
            return unpack(moved), None
        if p.feedback == "efmixed":
            return unpack(moved["x"]) + unpack(moved["e"]), None
        m = recv_slice.to(dtype) + unpack(moved)
        return m, m

    def pack_bw_message(self, g, buf_slice):
        """Compensated gradient payload + new bw send-buffer slice."""
        p, kb = self.policy, self.policy.bw.k_frac
        pack = self._bw_codec.pack
        unpack = lambda pl: self._bw_codec.unpack(pl, g.shape, g.dtype)
        if p.bw_feedback == "none":
            return pack(g, kb), buf_slice
        if p.bw_feedback == "ef":
            ge = g + buf_slice.to(g.dtype)
            payload = pack(ge, kb)
            return payload, ge - unpack(payload)
        if p.bw_feedback == "efmixed":
            e = buf_slice.to(g.dtype)
            payload = {"g": pack(g, kb / 2.0), "e": pack(e, kb / 2.0)}
            return payload, (g + e) - (unpack(payload["g"])
                                       + unpack(payload["e"]))
        b = buf_slice.to(g.dtype)                           # ef21
        payload = pack(g - b, kb)
        return payload, b + unpack(payload)

    def unpack_bw_message(self, moved, shape, dtype, recv_slice):
        p = self.policy
        unpack = lambda pl: self._bw_codec.unpack(pl, shape, dtype)
        if p.bw_feedback in ("none", "ef"):
            return unpack(moved), None
        if p.bw_feedback == "efmixed":
            return unpack(moved["g"]) + unpack(moved["e"]), None
        m = recv_slice.to(dtype) + unpack(moved)
        return m, m

    def fw_payload_struct(self, shape):
        """The forward wire payload's :class:`LeafStruct` tree for an
        activation of ``shape`` (feedback framing included), worked out
        from the shape alone: the exact bytes-on-wire source."""
        st, kf = self._fw_codec.payload_struct, self.policy.fw.k_frac
        if self.policy.feedback == "efmixed":
            return {"x": st(shape, kf / 2.0), "e": st(shape, kf / 2.0)}
        return st(shape, kf)

    def bw_payload_struct(self, shape):
        st, kb = self._bw_codec.payload_struct, self.policy.bw.k_frac
        if self.policy.bw_feedback == "efmixed":
            return {"g": st(shape, kb / 2.0), "e": st(shape, kb / 2.0)}
        return st(shape, kb)

    # -- hops ---------------------------------------------------------------

    def fw_hop(self, y, fw_st: FeedbackState, cut: Cut):
        """Forward hop of ``cut``: pack, move, unpack.  Under feedback the
        message is compensated and the new fw ``resid`` / ``mirror``
        slices are written in place.  Returns (message, ctx): ``ctx``
        carries the (sent, received) TopK indices under
        ``reuse_indices``."""
        mode = self.policy.feedback
        if mode == "none":
            payload = self._fw_codec.pack(y, self.policy.fw.k_frac)
            moved = self._hop(payload, "fw")
            out = self._fw_codec.unpack(moved, y.shape, y.dtype)
            ctx = None
            if self.policy.reuse_indices:
                ctx = (payload["idx"], moved["idx"])
            return out, ctx
        v = self.virtual_stages
        send_buf = fw_st.resid[cut.d]
        send_sl = gather_rows(send_buf, cut.k, cut.j, cut.ids, mode, v)
        payload, new_send = self.pack_fw_message(y, send_sl)
        moved = self._hop(payload, "fw")
        recv_buf = fw_st.mirror[cut.d2]
        recv_sl = (gather_rows(recv_buf, cut.k2, cut.j, cut.ids, mode, v)
                   if needs_recv_mirror(mode) else None)
        out, new_recv = self.unpack_fw_message(moved, y.shape, y.dtype,
                                               recv_sl)
        scatter_rows(send_buf, cut.k, cut.j, cut.ids, mode, v, new_send)
        if new_recv is not None:
            scatter_rows(recv_buf, cut.k2, cut.j, cut.ids, mode, v,
                         new_recv)
        return out, None

    def bw_hop(self, g, bw_st: FeedbackState, cut: Cut, ctx):
        """Backward hop of ``cut``: the fw receiver (``d2``, chunk ``k2``)
        sends the gradient back to the fw sender.  With ``reuse_indices``
        the payload is values only; under feedback it is compensated and
        the new bw ``resid`` / ``mirror`` slices are written in place.
        Returns the gradient of the fw sender's activation."""
        if self.policy.reuse_indices:
            idx_sent, idx_recv = ctx
            b = g.shape[0]
            vals = torch.gather(g.reshape(b, -1), 1,
                                idx_recv.to(torch.int64)).to(torch.bfloat16)
            vals_back = self._hop(vals, "bw")
            return topk_scatter(vals_back.to(torch.float32),
                                idx_sent.to(torch.int32), g.shape,
                                torch.float32).to(g.dtype)
        mode = self.policy.bw_feedback
        if mode == "none":
            payload = self._bw_codec.pack(g, self.policy.bw.k_frac)
            moved = self._hop(payload, "bw")
            return self._bw_codec.unpack(moved, g.shape, g.dtype)
        v = self.virtual_stages
        send_buf = bw_st.resid[cut.d2]
        send_sl = gather_rows(send_buf, cut.k2, cut.j, cut.ids, mode, v)
        payload, new_send = self.pack_bw_message(g, send_sl)
        moved = self._hop(payload, "bw")
        recv_buf = bw_st.mirror[cut.d]
        recv_sl = (gather_rows(recv_buf, cut.k, cut.j, cut.ids, mode, v)
                   if needs_recv_mirror(mode) else None)
        g_y, new_recv = self.unpack_bw_message(moved, g.shape, g.dtype,
                                               recv_sl)
        scatter_rows(send_buf, cut.k2, cut.j, cut.ids, mode, v, new_send)
        if new_recv is not None:
            scatter_rows(recv_buf, cut.k, cut.j, cut.ids, mode, v, new_recv)
        return g_y


class _Hop(torch.autograd.Function):
    """The differentiable wire hop of one cut: the forward hop in the
    forward, the backward hop on the gradient."""

    @staticmethod
    def forward(ctx, y, transport, cut, fw_state, bw_state):
        out, reuse = transport.fw_hop(y, fw_state, cut)
        if out.untyped_storage().data_ptr() == y.untyped_storage().data_ptr():
            out = out.clone()       # a raw bf16 payload: the receiver's copy
        ctx.transport, ctx.cut, ctx.bw_state, ctx.reuse = (
            transport, cut, bw_state, reuse)
        return out

    @staticmethod
    def backward(ctx, g):
        g_y = ctx.transport.bw_hop(g.contiguous(), ctx.bw_state, ctx.cut,
                                   ctx.reuse)
        return g_y, None, None, None, None


# ---------------------------------------------------------------------------
# Differentiable pipelined apply
# ---------------------------------------------------------------------------

def wire_telemetry(transport: PipelineTransport, sched: Schedule,
                   feat_shape, *, microbatches: int, dp: int = 1) -> dict:
    """Host-side wire facts of one pipeline configuration: the chosen
    codecs, EXACT payload bytes per hop (from the payload structs, the
    same source as the reference's) and buffers moved per hop.  Each step
    makes ``microbatches * wire_cuts`` hops per direction and replica row
    (``dp`` rows on the pipeline x DP grid)."""
    fw_pl = transport.fw_payload_struct(feat_shape)
    if transport.policy.reuse_indices:
        # the backward hop moves VALUES ONLY (bf16, forward k): the
        # indices already sit at both ends of the wire
        n = 1
        for s in feat_shape[1:]:
            n *= s
        k = topk_count(transport.policy.fw.k_frac, n)
        bw_pl = LeafStruct((feat_shape[0], k), torch.bfloat16)
    else:
        bw_pl = transport.bw_payload_struct(feat_shape)
    return {
        "axis": "stage", "stages": transport.num_stages,
        "virtual_stages": transport.virtual_stages,
        "schedule": sched.name, "microbatches": microbatches, "dp": dp,
        "fw_codec": transport.policy.fw.name,
        "bw_codec": transport.policy.bw.name,
        "feedback": transport.policy.feedback,
        "fw_payload_bytes_per_hop": wire_bytes(fw_pl),
        "bw_payload_bytes_per_hop": wire_bytes(bw_pl),
        "launches_per_fw_hop": (1 if transport.fused
                                else len(payload_leaves(fw_pl))),
        "launches_per_bw_hop": (1 if transport.fused
                                else len(payload_leaves(bw_pl))),
        "wire_cuts": sched.wire_cuts(transport.num_stages),
    }


def _trace_wire(transport, sched, feat_shape, mb: int, dp: int) -> None:
    """Emit the ``pipeline.wire`` event when tracing is on, as the
    reference does at trace time: once per new input key of the running
    step (``obs/keyed.py``)."""
    if trace.get_tracer() is None:
        return
    trace_time_instant("pipeline.wire", cat="wire",
                       **wire_telemetry(transport, sched, feat_shape,
                                        microbatches=mb, dp=dp))


def _index_tree(tree, i: int):
    """Slice ``i`` of every leaf of a (nested dict) tree: views."""
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]


def _leading_dims(tree) -> set:
    if isinstance(tree, dict):
        return set().union(*(_leading_dims(v) for v in tree.values()))
    return {tree.shape[0]}


def pipeline_apply(stage_fn: Callable, params_stacked, x, *,
                   num_stages: int, policy: BoundaryPolicy,
                   microbatches: Optional[int] = None,
                   schedule: Union[str, Schedule] = "gpipe",
                   virtual_stages: Optional[int] = None,
                   fw_state: Optional[FeedbackState] = None,
                   bw_state: Optional[FeedbackState] = None, ids=None,
                   tp_axis: Optional[int] = None, tp_param_dims=None,
                   seq_dim: int = 1, dp: int = 1):
    """Run ``stage_fn(stage_params, x) -> x`` as a pipelined stage stack
    of ``num_stages`` stages, packed payloads crossing every cut in both
    directions.  Returns ``(out, fw_state, slot)``: the last stage's
    output ``(B, ...)``, the fw feedback state (its buffers updated in
    place) and the :class:`PipelineSlot` whose ``state`` is the bw
    feedback state once ``backward()`` has run through the hops.

    ``params_stacked``: a tree with leading dim ``S * v`` in LOGICAL stage
    order (``v = virtual_stages``, 1 unless the schedule is interleaved);
    logical stage ``l`` runs as chunk ``l // S`` of device ``l % S``.
    ``policy`` selects the wire format of every cut (``SCHEME_POLICIES``
    names one per codec).  ``microbatches`` defaults to
    the stage count.  With a feedback policy pass ``fw_state`` /
    ``bw_state`` from :func:`init_feedback_state` (built with the same
    ``virtual_stages``) and, for AQ-SGD, ``ids``: the (B,) example ids.

    ``tp_axis``: the size ``T`` of a tensor ring every stage runs over
    (the reference's 3D mesh; it takes the axis' name).  ``stage_fn`` is
    then TP-aware, ``stage_fn(rank_params, xs) -> ys`` over the ranks'
    lists (``models/transformer.tp_stage_stack_fn`` closed over a
    :class:`~repro_torch.transport.tp_collectives.TPCollectives` of size
    ``T``, recomputing its local compute itself under a rematerializing
    schedule, so that no collective runs twice): ``xs`` are the
    microbatch's ``T`` shards along dim ``seq_dim`` of the activation,
    and ``rank_params`` the stage's weights cut by ``tp_param_dims`` (a
    tree matching ``params_stacked`` of each leaf's tensor dim, -1 =
    replicated; ``models/transformer.tp_param_dims``).  Each rank's shard
    crosses every cut on its own hop, packed alone: ``T`` times the hops,
    each ``1/T`` of the cut.  Boundary feedback buffers are refused on
    this path, as in the reference.

    ``dp``: the replica rows of the pipeline x DP step this call is one
    row of; it only sets the ``dp`` of the traced ``pipeline.wire``
    event, which the reference emits once for all rows."""
    s_stages = num_stages
    tp = tp_axis or 1
    if tp_axis is not None:
        if policy.needs_fw_buffer or policy.needs_bw_buffer:
            raise ValueError(
                f"policy {policy.name!r} carries boundary feedback "
                "buffers; the tensor-parallel pipeline path supports "
                "buffer-free boundary policies only")
        if tp_param_dims is None:
            raise ValueError("tp_axis needs tp_param_dims (see "
                             "models/transformer.tp_param_dims)")
        if x.shape[seq_dim] % tp:
            raise ValueError(f"sequence dim {seq_dim} ({x.shape[seq_dim]})"
                             f" not divisible by tp={tp}")
    sched = as_schedule(schedule, virtual_stages)
    v = sched.virtual_stages
    transport = PipelineTransport(policy, s_stages, virtual_stages=v,
                                  fused=sched.fused_wire)
    if microbatches is None:
        mb = s_stages
    else:
        if not isinstance(microbatches, int) or microbatches <= 0:
            raise ValueError(
                "microbatches must be a positive int, got "
                f"{microbatches!r}: pass None (or omit it) to default to "
                "the stage count")
        mb = microbatches
    sched.validate(mb, s_stages)
    b = x.shape[0]
    if b % mb:
        raise ValueError(f"batch {b} is not divisible by microbatch count "
                         f"{mb} (microbatches defaults to the stage count)")
    mbsz = b // mb
    lead = _leading_dims(params_stacked)
    if lead != {s_stages * v}:
        raise ValueError(
            "params_stacked must have leading dim num_stages * "
            f"virtual_stages = {s_stages}*{v} = {s_stages * v} (logical "
            f"stage slices); got leading dims {sorted(lead)}")

    with_state = fw_state is not None or bw_state is not None
    if (policy.needs_fw_buffer or policy.needs_bw_buffer) and not with_state:
        raise ValueError(
            f"policy {policy.name!r} carries feedback buffers: pass "
            "fw_state/bw_state from init_feedback_state()")
    if fw_state is None:
        fw_state = _empty_state(s_stages, x.dtype, "fw", x.device)
    if bw_state is None:
        bw_state = _empty_state(s_stages, x.dtype, "bw", x.device)
    for st, nm in ((fw_state, "fw_state"), (bw_state, "bw_state")):
        if st.resid.numel() and st.resid.shape[0] != s_stages:
            raise ValueError(
                f"{nm} was built for a different pipeline: expected "
                f"leading dim {s_stages}, got shape {tuple(st.resid.shape)}")
    if ids is None:
        ids = torch.zeros((b,), dtype=torch.int32, device=x.device)
    ids_mb = ids.reshape(mb, mbsz)
    x_mb = x.reshape(mb, mbsz, *x.shape[1:])
    feat_shape = list(x_mb.shape[1:])
    # with a tensor axis the cut carries the sequence shard
    feat_shape[seq_dim] //= tp
    _trace_wire(transport, sched, tuple(feat_shape), mb, dp)

    # the reference lays the slices out device-major (device d's chunks
    # k = 0..v-1 are logical stages d, d+S, ...); here every slice stays
    # addressable by its logical index.  Every stage takes and returns its
    # microbatch as the ranks' shards, a list of one without a tensor axis
    if tp_axis is None:
        dense = stage_fn
        if sched.remat_ticks:
            def dense(p, h):
                return checkpoint(stage_fn, p, h, use_reentrant=False)

        def stage(p, hs):
            return [dense(p, hs[0])]
    else:
        # the ranks' weights of logical stage lg; the TP stage remats its
        # own local compute
        dims = tree_map(lambda d: d - 1 if d >= 0 else d, tp_param_dims)

        def stage(p, hs):
            return stage_fn([tp_local(p, dims, tp, r) for r in range(tp)],
                            hs)

    def split(h):
        if tp == 1:
            return [h]
        w = h.shape[seq_dim] // tp
        return [h.narrow(seq_dim, r * w, w) for r in range(tp)]

    inbox = {}          # (logical stage, microbatch) -> its received input
    outs = [None] * mb
    for t in range(sched.num_ticks(mb, s_stages)):
        for d in range(s_stages):
            pl = sched.plan(t, d, mb, s_stages)
            if not pl.valid:
                continue
            lg = pl.k * s_stages + d
            x_in = (split(x_mb[pl.j]) if pl.inject
                    else inbox.pop((lg, pl.j)))
            y = stage(_index_tree(params_stacked, lg), x_in)
            if pl.last:
                outs[pl.j] = y[0] if tp == 1 else torch.cat(y, dim=seq_dim)
                continue
            nxt = lg + 1
            cut = Cut(d=d, k=pl.k, d2=nxt % s_stages, k2=nxt // s_stages,
                      j=pl.j, ids=ids_mb[pl.j])
            inbox[(nxt, pl.j)] = [_Hop.apply(yr, transport, cut, fw_state,
                                             bw_state) for yr in y]
    out = torch.stack(outs).reshape(b, *x.shape[1:])
    return out, fw_state, PipelineSlot(bw_state, transport.wire)
