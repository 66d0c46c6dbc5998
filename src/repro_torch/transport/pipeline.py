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
:func:`pipeline_apply` returns.

:func:`pipeline_apply_rank` runs the same pipeline with one PROCESS a
stage: rank ``d`` of a ``transport/p2p.py::StageGroup`` computes only its
logical stages ``d, d+S, ...``, and every hop is a real message, the
sender's packed (and, when the schedule fuses, framed) payload sent with
``torch.distributed`` point-to-point to the receiver, which unframes and
unpacks it.  Its backends are named by the caller: ``nccl``, one card a
rank, sends from the cards; ``gloo`` runs anywhere, and on a card it
stages each payload leaf through pinned host memory (the card's bytes
copied to the host, sent, received on the host, copied back), which is
how several ranks share one card.  The wire's bytes, codecs, framing and
kernel launches are those of :func:`pipeline_apply`, summed over ranks.

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
from typing import Callable, Optional, Tuple, Union

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
from repro_torch.transport.p2p import StageGroup
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
                        virtual_stages: int = 1, dp: int = 1, device=None,
                        stage: Optional[int] = None):
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
    ``core/feedback.shard_ids``).

    ``stage``: only that device's rows, without the stage dim (what rank
    ``stage`` of :func:`pipeline_apply_rank` holds: fw ``resid[stage]``
    and ``mirror[stage]``, bw ``resid[stage]`` and ``mirror[stage]``)."""
    if stage is not None and not 0 <= stage < num_stages:
        raise ValueError(f"stage {stage} is not one of {num_stages}")
    mb = microbatches or num_stages
    if batch % (mb * dp):
        raise ValueError(f"batch {batch} not divisible by microbatches "
                         f"{mb} x dp {dp}")
    mbsz = batch // (mb * dp)
    chunk = () if virtual_stages == 1 else (virtual_stages,)
    lead = () if dp == 1 else (dp,)
    if stage is None:
        lead += (num_stages,)

    def buf(mode: str, mirror: bool):
        if mode == "none" or (mirror and not needs_recv_mirror(mode)):
            shape = (*lead, 0)
        elif get_mode(mode).per_example:
            if num_samples <= 0:
                raise ValueError("aqsgd needs the dataset size "
                                 "(num_samples > 0)")
            if num_samples % dp:
                raise ValueError(
                    f"aqsgd + dp shards the per-example buffer by id: "
                    f"num_samples {num_samples} must be divisible by "
                    f"dp {dp}")
            shape = (*lead, *chunk, num_samples // dp, *feat_shape)
        else:
            shape = (*lead, *chunk, mb, mbsz, *feat_shape)
        return torch.zeros(shape, dtype=dtype, device=device)

    def fbs(mode: str, direction: str) -> FeedbackState:
        return FeedbackState(resid=buf(mode, False), mirror=buf(mode, True),
                             agg=torch.zeros((0,), dtype=dtype,
                                             device=device),
                             scope="boundary", direction=direction,
                             mode=mode)

    return {"fw": fbs(policy.feedback, "fw"),
            "bw": fbs(policy.bw_feedback, "bw")}


def _empty_state(lead: tuple, dtype, direction: str,
                 device=None) -> FeedbackState:
    """A feedback-free state: size-0 buffers of shape ``(*lead, 0)``."""
    z = torch.zeros((*lead, 0), dtype=dtype, device=device)
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

    def count(self, payload, direction: str) -> None:
        """Count one hop of ``payload`` in ``wire``: the sender's tally."""
        self.wire[f"{direction}_hops"] += 1
        self.wire[f"{direction}_bytes"] += wire_bytes(payload)

    def _hop(self, payload, direction: str):
        """One hop of a packed payload: counted, and framed into one byte
        buffer and back when the schedule fuses its hops."""
        self.count(payload, direction)
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

    def bw_wire_struct(self, shape):
        """What a backward hop carries for an activation of ``shape``: the
        bw payload's struct, or with ``reuse_indices`` the VALUES only
        (bf16, the forward's k a row): the indices already sit at both
        ends of the wire."""
        if not self.policy.reuse_indices:
            return self.bw_payload_struct(shape)
        n = 1
        for s in shape[1:]:
            n *= s
        k = topk_count(self.policy.fw.k_frac, n)
        return LeafStruct((shape[0], k), torch.bfloat16)

    # -- the two ends of a hop ----------------------------------------------
    #
    # ``send_buf`` / ``recv_buf``: the sending / receiving device's rows of
    # the direction's ``resid`` / ``mirror`` buffer; their microbatch slice
    # is read and the new one written in place.

    def fw_send(self, y, send_buf, cut: Cut):
        """Sender end of the forward hop of ``cut``: the (compensated)
        payload of ``y``."""
        mode = self.policy.feedback
        if mode == "none":
            return self._fw_codec.pack(y, self.policy.fw.k_frac)
        v = self.virtual_stages
        send_sl = gather_rows(send_buf, cut.k, cut.j, cut.ids, mode, v)
        payload, new_send = self.pack_fw_message(y, send_sl)
        scatter_rows(send_buf, cut.k, cut.j, cut.ids, mode, v, new_send)
        return payload

    def fw_recv(self, moved, shape, dtype, recv_buf, cut: Cut):
        """Receiver end of the forward hop of ``cut``: the message."""
        mode = self.policy.feedback
        if mode == "none":
            return self._fw_codec.unpack(moved, shape, dtype)
        v = self.virtual_stages
        recv_sl = (gather_rows(recv_buf, cut.k2, cut.j, cut.ids, mode, v)
                   if needs_recv_mirror(mode) else None)
        out, new_recv = self.unpack_fw_message(moved, shape, dtype, recv_sl)
        if new_recv is not None:
            scatter_rows(recv_buf, cut.k2, cut.j, cut.ids, mode, v, new_recv)
        return out

    def bw_send(self, g, send_buf, cut: Cut, idx_recv=None):
        """Sender end (the forward's receiver) of the backward hop of
        ``cut``: the (compensated) payload of ``g``, or with
        ``reuse_indices`` its values at the forward's received TopK
        indices ``idx_recv``."""
        if self.policy.reuse_indices:
            b = g.shape[0]
            return torch.gather(g.reshape(b, -1), 1,
                                idx_recv.to(torch.int64)).to(torch.bfloat16)
        mode = self.policy.bw_feedback
        if mode == "none":
            return self._bw_codec.pack(g, self.policy.bw.k_frac)
        v = self.virtual_stages
        send_sl = gather_rows(send_buf, cut.k2, cut.j, cut.ids, mode, v)
        payload, new_send = self.pack_bw_message(g, send_sl)
        scatter_rows(send_buf, cut.k2, cut.j, cut.ids, mode, v, new_send)
        return payload

    def bw_recv(self, moved, shape, dtype, recv_buf, cut: Cut,
                idx_sent=None):
        """Receiver end (the forward's sender) of the backward hop of
        ``cut``: the gradient of the sender's activation (with
        ``reuse_indices`` the values scattered at the forward's sent TopK
        indices ``idx_sent``)."""
        if self.policy.reuse_indices:
            return topk_scatter(moved.to(torch.float32),
                                idx_sent.to(torch.int32), shape,
                                torch.float32).to(dtype)
        mode = self.policy.bw_feedback
        if mode == "none":
            return self._bw_codec.unpack(moved, shape, dtype)
        v = self.virtual_stages
        recv_sl = (gather_rows(recv_buf, cut.k, cut.j, cut.ids, mode, v)
                   if needs_recv_mirror(mode) else None)
        g_y, new_recv = self.unpack_bw_message(moved, shape, dtype, recv_sl)
        if new_recv is not None:
            scatter_rows(recv_buf, cut.k, cut.j, cut.ids, mode, v, new_recv)
        return g_y

    # -- hops ---------------------------------------------------------------

    def fw_hop(self, y, fw_st: FeedbackState, cut: Cut):
        """Forward hop of ``cut``: pack, move, unpack.  Under feedback the
        message is compensated and the new fw ``resid`` / ``mirror``
        slices are written in place.  Returns (message, ctx): ``ctx``
        carries the (sent, received) TopK indices under
        ``reuse_indices``."""
        payload = self.fw_send(y, fw_st.resid[cut.d], cut)
        moved = self._hop(payload, "fw")
        out = self.fw_recv(moved, y.shape, y.dtype, fw_st.mirror[cut.d2],
                           cut)
        ctx = None
        if self.policy.reuse_indices:
            ctx = (payload["idx"], moved["idx"])
        return out, ctx

    def bw_hop(self, g, bw_st: FeedbackState, cut: Cut, ctx):
        """Backward hop of ``cut``: the fw receiver (``d2``, chunk ``k2``)
        sends the gradient back to the fw sender.  With ``reuse_indices``
        the payload is values only; under feedback it is compensated and
        the new bw ``resid`` / ``mirror`` slices are written in place.
        Returns the gradient of the fw sender's activation."""
        idx_sent, idx_recv = ctx if ctx is not None else (None, None)
        payload = self.bw_send(g, bw_st.resid[cut.d2], cut, idx_recv)
        moved = self._hop(payload, "bw")
        return self.bw_recv(moved, g.shape, g.dtype, bw_st.mirror[cut.d],
                            cut, idx_sent)


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
    bw_pl = transport.bw_wire_struct(feat_shape)
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


def _microbatch_count(microbatches, num_stages: int) -> int:
    if microbatches is None:
        return num_stages
    if not isinstance(microbatches, int) or microbatches <= 0:
        raise ValueError(
            "microbatches must be a positive int, got "
            f"{microbatches!r}: pass None (or omit it) to default to "
            "the stage count")
    return microbatches


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
    mb = _microbatch_count(microbatches, s_stages)
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
        fw_state = _empty_state((s_stages,), x.dtype, "fw", x.device)
    if bw_state is None:
        bw_state = _empty_state((s_stages,), x.dtype, "bw", x.device)
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


def pipeline_forward(stage_fn: Callable, params_stacked, x, *,
                     num_stages: int, scheme: str = "none",
                     k_frac: float = 0.1,
                     microbatches: Optional[int] = None,
                     schedule: Union[str, Schedule] = "gpipe",
                     virtual_stages: Optional[int] = None):
    """The reference's forward-only entry point (differentiable too):
    :func:`pipeline_apply` with the wire ``scheme`` (a name of
    ``SCHEME_POLICIES``) compressing BOTH directions alike.  Returns the
    last stage's output ``(B, ...)``."""
    try:
        policy = SCHEME_POLICIES[scheme](k_frac)
    except KeyError:
        raise ValueError(f"unknown scheme {scheme!r}; "
                         f"known: {sorted(SCHEME_POLICIES)}") from None
    return pipeline_apply(stage_fn, params_stacked, x, num_stages=num_stages,
                          policy=policy, microbatches=microbatches,
                          schedule=schedule,
                          virtual_stages=virtual_stages)[0]


# ---------------------------------------------------------------------------
# One rank a stage
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Tick:
    """What one forward tick of a rank keeps for its backward: the stage
    input ``h`` (the received message as a leaf; None when injected), the
    stage output ``y``, the hops that brought ``h`` and took ``y`` (None
    on the first / last logical stage) and, under ``reuse_indices``, the
    TopK indices each end of those hops holds."""
    h: Optional[torch.Tensor]
    y: torch.Tensor
    cut_in: Optional[Cut]
    cut_out: Optional[Cut]
    idx_in: Optional[torch.Tensor]
    idx_out: Optional[torch.Tensor]


class RankSlot:
    """What :func:`pipeline_apply_rank` leaves for its backward: the
    rank's bw feedback rows ``state`` (written in place as
    :meth:`backward` runs), ``wire``, the hops and bytes THIS rank sent
    per direction (summed over the ranks, the one-process
    :class:`PipelineSlot`'s ``wire``), and :meth:`backward`."""

    def __init__(self, run_backward: Callable, state: FeedbackState,
                 wire: dict):
        self._run, self.state, self.wire = run_backward, state, wire

    def backward(self, grad_out: Optional[torch.Tensor] = None) -> None:
        """Run this rank's backward, in reverse tick order, exchanging
        the gradient payloads with its neighbours: the last rank passes
        the gradient of the output it was given, every other rank None.
        Rank 0 ends by back-propagating its input's gradient into ``x``.
        Call it once, on every rank."""
        run, self._run = self._run, None
        if run is None:
            raise RuntimeError("RankSlot.backward runs once")
        run(grad_out)


def _check_rank_rows(st: FeedbackState, name: str, v: int,
                     feat_dims: int) -> None:
    """A rank takes ITS rows of the stage-stacked buffers: ``([v,] mb,
    mb_rows, *feat)``, or ``([v,] num_samples, *feat)`` for AQ-SGD."""
    if not st.resid.numel():
        return
    rows = 1 if get_mode(st.mode).per_example else 2
    want = (v > 1) + rows + feat_dims
    if st.resid.dim() != want:
        raise ValueError(
            f"{name} has shape {tuple(st.resid.shape)}: a rank takes its "
            "own rows of the stage-stacked buffers (init_feedback_state("
            "..., stage=rank))")


def pipeline_apply_rank(stage_fn: Callable, params_local, x=None, *,
                        group: StageGroup, num_stages: int,
                        policy: BoundaryPolicy,
                        microbatches: Optional[int] = None,
                        schedule: Union[str, Schedule] = "gpipe",
                        virtual_stages: Optional[int] = None,
                        fw_state: Optional[FeedbackState] = None,
                        bw_state: Optional[FeedbackState] = None, ids=None,
                        shape: Optional[Tuple[int, ...]] = None,
                        dtype: Optional[torch.dtype] = None):
    """:func:`pipeline_apply` with one process a stage: this process is
    rank ``d = group.rank`` of ``num_stages`` (``transport/p2p.py``) and
    runs only its logical stages ``d, d+S, ...`` (``lg % S == d``).
    Returns ``(out, fw_state, slot)``: on the last rank the last logical
    stage's output ``(B, ...)``, DETACHED (elsewhere None); the rank's fw
    feedback rows, updated in place; and the :class:`RankSlot` whose
    ``backward(grad_out)`` every rank then calls.

    ``params_local``: the rank's stage slices, a tree with leading dim
    ``v`` (chunk ``k`` is logical stage ``k*S + d``).  ``x``: the input
    ``(B, ...)`` on rank 0, which injects its microbatches (None
    elsewhere: pass the input's ``shape`` and ``dtype``).  ``fw_state`` /
    ``bw_state``: the rank's rows of :func:`init_feedback_state`
    (``stage=d``): fw ``resid[d]`` / ``mirror[d]``, bw ``resid[d]`` /
    ``mirror[d]``.  ``ids``: the (B,) example ids, the same on every rank.

    Forward, in tick order (``Schedule.column``): rank 0 injects chunk 0,
    the others receive, unpack (their fw mirror under EF21 / AQ-SGD) and
    take the message as a leaf; the stage runs (wrapped in
    ``torch.utils.checkpoint`` under a rematerializing schedule); the
    sender packs the (compensated) payload and sends it.  Backward, in
    reverse tick order: receive the gradient payload from the next rank,
    unpack it, ``torch.autograd.backward`` the stage, then pack the
    input's gradient and send it to the previous rank (the wrap-around
    hop of interleaved included).  Each stage slice thus accumulates its
    microbatches' gradients in the order autograd does in one process.
    Each tick's sends and receives go out together
    (:meth:`StageGroup.exchange`), framed into one buffer when the
    schedule fuses its hops, leaf by leaf otherwise.  Under
    ``reuse_indices`` each end keeps its own copy of the TopK indices.
    The sender counts its hops in ``slot.wire``."""
    d, s_stages = group.rank, num_stages
    if group.world != s_stages:
        raise ValueError(f"a pipeline of {s_stages} stages runs one rank a "
                         f"stage; the group has {group.world} ranks")
    if s_stages < 2:
        raise ValueError("a rank-per-stage pipeline needs 2 stages or more")
    sched = as_schedule(schedule, virtual_stages)
    v = sched.virtual_stages
    transport = PipelineTransport(policy, s_stages, virtual_stages=v,
                                  fused=sched.fused_wire)
    mb = _microbatch_count(microbatches, s_stages)
    sched.validate(mb, s_stages)
    if d == 0:
        if x is None:
            raise ValueError("rank 0 injects the batch: pass x")
        shape, dtype = tuple(x.shape), x.dtype
    elif shape is None or dtype is None:
        raise ValueError("the ranks past 0 receive their inputs: pass the "
                         "shape and dtype of the pipeline's input")
    b = shape[0]
    if b % mb:
        raise ValueError(f"batch {b} is not divisible by microbatch count "
                         f"{mb} (microbatches defaults to the stage count)")
    mbsz = b // mb
    mb_shape = (mbsz, *shape[1:])
    lead = _leading_dims(params_local)
    if lead != {v}:
        raise ValueError(
            f"params_local must hold this rank's {v} stage slice(s) "
            f"(leading dim virtual_stages); got leading dims {sorted(lead)}")
    with_state = fw_state is not None or bw_state is not None
    if (policy.needs_fw_buffer or policy.needs_bw_buffer) and not with_state:
        raise ValueError(
            f"policy {policy.name!r} carries feedback buffers: pass this "
            "rank's fw_state/bw_state (init_feedback_state(..., stage=))")
    dev = group.device
    if fw_state is None:
        fw_state = _empty_state((), dtype, "fw", dev)
    if bw_state is None:
        bw_state = _empty_state((), dtype, "bw", dev)
    for st, nm in ((fw_state, "fw_state"), (bw_state, "bw_state")):
        _check_rank_rows(st, nm, v, len(mb_shape) - 1)
    if ids is None:
        ids = torch.zeros((b,), dtype=torch.int32, device=dev)
    ids_mb = ids.reshape(mb, mbsz)
    reuse, fused = policy.reuse_indices, sched.fused_wire
    fw_wire = transport.fw_payload_struct(mb_shape)
    bw_wire = transport.bw_wire_struct(mb_shape)

    def framed(struct):
        """What the wire carries: the payload, or its one framed buffer."""
        if not fused:
            return struct
        return LeafStruct((wire_bytes(struct),), torch.uint8)

    def on_wire(payload):
        return fuse_payload(payload) if fused else payload

    def off_wire(moved, struct):
        return unfuse_payload(moved, struct) if fused else moved

    dense = stage_fn
    if sched.remat_ticks:
        def dense(p, h):
            return checkpoint(stage_fn, p, h, use_reentrant=False)

    prev, nxt = (d - 1) % s_stages, (d + 1) % s_stages
    x_leaf = x_mb = None
    if d == 0:
        x_leaf = x.detach().requires_grad_(x.requires_grad)
        x_mb = x_leaf.reshape(mb, *mb_shape)
    column = dict(sched.column(d, mb, s_stages))
    ticks = sched.num_ticks(mb, s_stages)
    kept, outs, outgoing = {}, {}, None
    # boundary t: send what tick t-1 made, receive what tick t takes
    for t in range(ticks + 1):
        pl = column.get(t)
        recvs = ([(prev, framed(fw_wire))] if pl is not None
                 and not pl.inject else [])
        sends = [] if outgoing is None else [(nxt, outgoing)]
        got = group.exchange(sends, recvs)
        outgoing = None
        if pl is None:
            continue
        lg = pl.k * s_stages + d
        h = cut_in = cut_out = idx_in = idx_out = None
        if pl.inject:
            x_in = x_mb[pl.j]
        else:
            cut_in = Cut(d=prev, k=(lg - 1) // s_stages, d2=d, k2=pl.k,
                         j=pl.j, ids=ids_mb[pl.j])
            with torch.no_grad():
                moved = off_wire(got[0], fw_wire)
                h = transport.fw_recv(moved, mb_shape, dtype,
                                      fw_state.mirror, cut_in)
            x_in = h = h.detach().requires_grad_(True)
            idx_in = moved["idx"] if reuse else None
        y = dense(_index_tree(params_local, pl.k), x_in)
        if pl.last:
            outs[pl.j] = y
        else:
            cut_out = Cut(d=d, k=pl.k, d2=nxt, k2=(lg + 1) // s_stages,
                          j=pl.j, ids=ids_mb[pl.j])
            with torch.no_grad():
                payload = transport.fw_send(y, fw_state.resid, cut_out)
                transport.count(payload, "fw")
                outgoing = on_wire(payload)
            idx_out = payload["idx"] if reuse else None
        kept[t] = _Tick(h, y, cut_in, cut_out, idx_in, idx_out)

    def run_backward(grad_out):
        if outs and grad_out is None:
            raise ValueError("the last rank's backward needs grad_out, the "
                             "gradient of its output")
        g_mb = (grad_out.reshape(mb, *mb_shape) if outs else None)
        outgoing = None
        # boundary t: send what tick t+1 made, receive what tick t takes
        for t in range(ticks - 1, -2, -1):
            pl = column.get(t)
            recvs = ([(nxt, framed(bw_wire))] if pl is not None
                     and not pl.last else [])
            sends = [] if outgoing is None else [(prev, outgoing)]
            got = group.exchange(sends, recvs)
            outgoing = None
            if pl is None:
                continue
            tk = kept.pop(t)
            if pl.last:
                g = g_mb[pl.j]
            else:
                with torch.no_grad():
                    g = transport.bw_recv(off_wire(got[0], bw_wire),
                                          mb_shape, tk.y.dtype,
                                          bw_state.mirror, tk.cut_out,
                                          tk.idx_out)
            torch.autograd.backward(tk.y, g)
            if tk.h is not None:
                with torch.no_grad():
                    payload = transport.bw_send(tk.h.grad.contiguous(),
                                                bw_state.resid, tk.cut_in,
                                                tk.idx_in)
                    transport.count(payload, "bw")
                    outgoing = on_wire(payload)
        if x_leaf is not None and x.requires_grad:
            torch.autograd.backward(x, x_leaf.grad)

    out = None
    if outs:
        out = torch.stack([outs[j].detach() for j in range(mb)]).reshape(
            shape)
    return out, fw_state, RankSlot(run_backward, bw_state, transport.wire)
