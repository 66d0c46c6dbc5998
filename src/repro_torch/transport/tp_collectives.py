"""Compressed tensor-parallel collectives over the wire codecs.

Port of ``repro/transport/tp_collectives.py``: the third communication
axis.  The attention and MLP weights shard over ``tensor`` (Megatron
column / row parallelism, the residual stream SEQUENCE-sharded), and what
crosses the tensor ring is a PACKED payload from the wire-codec registry
the stage cuts and the DP reduce use (``transport/codecs.py``, framed into
one uint8 buffer a hop by ``fuse_payload``):

  * activation path: an ALL-GATHER of the sequence-sharded residual before
    each sharded matmul group.  Every rank packs its own ``(B, S/tp, d)``
    shard, the buffers ride a ring of ``tp - 1`` hops, and the ``tp``
    payloads are decoded in source-rank order and concatenated, so every
    rank holds the same gathered activation;
  * gradient path: a REDUCE-SCATTER of the partial outputs.  Rank ``s``
    packs the slice meant for each rank (its own included), and rank ``r``
    sums the ``tp`` decoded contributions to its slice in source-rank
    order, in the activation's dtype, one addend at a time.

Both are differentiable: the gradient of the compressed all-gather is the
compressed reduce-scatter of the cotangents, and the other way round, so
activations compress forward and activation-gradients backward.

Single controller.  The reference is SPMD inside ``shard_map``; here the
``tp`` ranks are a LIST, run in lock step between collectives: a
collective takes every rank's tensor and returns every rank's result,
one ``torch.autograd.Function`` over all ranks at once.  The ring is
counted, not sent: ``tp * (tp - 1)`` hops a collective.  The gathered
activation is decoded once and handed to every rank as a view of one
tensor (the ranks hold the same bits by construction).

Error feedback (``FeedbackState(scope="tp")``, :func:`init_tp_state`)
compensates the forward all-gather:

  * ``ef``   -- send C(x + e);  e' = x + e - C(x + e)   (``resid`` is
               sequence-sharded like x);
  * ``ef21`` -- send C(x - M_r) against a model M of every rank's shard;
               M is REPLICATED over the ring and the gathered activation
               IS the updated model.

``codec="none"`` is a RAW passthrough (dtype kept), so an uncompressed TP
step sums the partial outputs in the same rank order as a single-device
program that associates them that way.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.feedback import FEEDBACK_REGISTRY, FeedbackState
from repro_torch.obs import trace
from repro_torch.obs.keyed import trace_time_instant
from repro_torch.optim.optimizers import tree_map
from repro_torch.transport.codecs import (LeafStruct, fuse_payload,
                                          get_codec, payload_leaves,
                                          payload_struct, unfuse_payload,
                                          wire_bytes)
from repro_torch.transport.collectives import (_leaf_n, _ring_gather,
                                               grad_payload_structs,
                                               pack_grad_leaf,
                                               unpack_grad_leaf)

# The modes whose registry entry admits the "tp" scope (core/feedback.py).
TP_FEEDBACK_MODES = tuple(m.name for m in FEEDBACK_REGISTRY.values()
                          if "tp" in m.scopes)


def tp_payload_struct(shard_shape, codec_name: str, *, k_frac: float = 0.1,
                      dtype=torch.bfloat16):
    """The :class:`LeafStruct` tree of one packed activation shard, from
    its shape alone: the exact bytes-on-wire source."""
    return grad_payload_structs([LeafStruct(tuple(shard_shape), dtype)],
                                codec_name, k_frac)[0]


def tp_wire_report(feat_shape, tp: int, codec_name: str, *,
                   k_frac: float = 0.1, dtype=torch.bfloat16,
                   seq_dim: int = 1, sites: int = 1) -> dict:
    """Exact and modeled wire bytes of the TP collectives for one FULL
    activation of shape ``feat_shape`` (dim ``seq_dim`` shards over the
    ring), per device, as the reference reports them.

    Per collective (all-gather OR reduce-scatter) each rank sends ``tp -
    1`` payloads of one packed shard; ``sites`` is the number of gather
    (and of scatter) cut points a forward pass crosses."""
    if feat_shape[seq_dim] % tp:
        raise ValueError(f"feat dim {seq_dim} ({feat_shape[seq_dim]}) "
                         f"not divisible by tp={tp}")
    codec = get_codec(codec_name)
    shard = list(feat_shape)
    shard[seq_dim] //= tp
    struct = tp_payload_struct(tuple(shard), codec_name, k_frac=k_frac,
                               dtype=dtype)
    exact = wire_bytes(struct)
    n = _leaf_n(shard)
    elem = dtype.itemsize if codec.name == "none" else 2
    model = codec.wire_bytes_per_elem(n, elem, k_frac) * n
    return {
        "tp_codec": codec_name, "k_frac": k_frac, "tp": tp,
        "shard_elems": n,
        "n_payload_leaves": len(payload_leaves(struct)),
        "payload_bytes_per_hop": exact,
        "model_bytes": round(model),
        "hops_per_collective": tp - 1,
        "wire_bytes_per_collective": (tp - 1) * exact,
        "sites_per_forward": sites,
        "wire_bytes_per_forward": sites * 2 * (tp - 1) * exact,
    }


def init_tp_state(feat_shape, sites: int, feedback: str = "none",
                  dtype=torch.float32, device=None) -> FeedbackState:
    """Per-site TP feedback state, carried beside the train state.

    ``feat_shape``: the FULL activation entering the layer stack (global
    batch; the batch dim splits over the data lanes, the sequence dim over
    the tensor ranks).  ``resid`` (EF) is ``(sites, *feat)``, each rank
    owning its sequence shard; ``mirror`` (EF21's model M) is ``(sites,
    *feat)``, replicated over the ring.  Unused slots are ``(0,)``."""
    if feedback not in TP_FEEDBACK_MODES:
        raise ValueError(f"unknown tp feedback {feedback!r}; "
                         f"known: {TP_FEEDBACK_MODES}")
    z = torch.zeros((0,), dtype=dtype, device=device)
    if feedback == "none":
        return FeedbackState(resid=z, mirror=z, agg=z, scope="tp",
                             direction="act", mode=feedback)
    buf = torch.zeros((sites, *feat_shape), dtype=dtype, device=device)
    if feedback == "ef":
        return FeedbackState(resid=buf, mirror=z, agg=z, scope="tp",
                             direction="act", mode=feedback)
    return FeedbackState(resid=z, mirror=buf, agg=z, scope="tp",
                         direction="act", mode=feedback)


def tp_local(params, param_dims, tp: int, r: int):
    """Rank ``r``'s weights: every leaf narrowed to its ``1/tp`` slice
    along its ``param_dims`` entry (a view, so that autograd assembles the
    full gradient), or the whole leaf where the entry is -1 (replicated:
    its gradient is the sum of every rank's, the reference's
    ``shard_map`` transpose psum)."""
    def one(a, d):
        if d < 0:
            return a
        if a.shape[d] % tp:
            raise ValueError(f"tensor-sharded dim {d} of a leaf of shape "
                             f"{tuple(a.shape)} is not divisible by tp={tp}")
        w = a.shape[d] // tp
        return a.narrow(d, r * w, w)
    return tree_map(one, params, param_dims)


class _Gather(torch.autograd.Function):
    """``(tpc, base, adds, *xs) -> tp views of base + all_gather(C(x +
    add))``; the gradient of every ``x`` is the compressed reduce-scatter
    of the ranks' cotangents.  ``base`` (EF21's model) and ``adds`` (the
    feedback terms) carry no gradient."""

    @staticmethod
    def forward(ctx, tpc, base, adds, *xs):
        if adds is not None:
            xs = [x + a for x, a in zip(xs, adds)]
        full = tpc.all_gather_wire(list(xs))
        if base is not None:
            full = base + full
        ctx.tpc = tpc
        return tuple(full.view_as(full) for _ in xs)

    @staticmethod
    def backward(ctx, *dfull):
        dx = ctx.tpc.reduce_scatter_wire([g.contiguous() for g in dfull])
        return (None, None, None, *dx)


class _Scatter(torch.autograd.Function):
    """``(tpc, *partials) -> the tp reduced shards``; the gradient of
    every partial is the compressed all-gather of the shards' cotangents
    (the same tensor for every rank)."""

    @staticmethod
    def forward(ctx, tpc, *partials):
        ctx.tpc = tpc
        return tuple(tpc.reduce_scatter_wire(list(partials)))

    @staticmethod
    def backward(ctx, *dshard):
        full = ctx.tpc.all_gather_wire([g.contiguous() for g in dshard])
        return (None, *[full] * len(dshard))


@dataclasses.dataclass
class TPCollectives:
    """The compressed TP wire of one tensor ring of ``tp`` ranks (the
    reference takes a mesh and an axis name; on one card the ring is its
    size).  ``seq_dim`` is the activation dim sharded over the ring.
    Every hop's payload is framed into one byte buffer (the reference's
    default ``fused=True``; nothing runs it unfused).  ``wire`` counts the
    ring's hops and bytes (``tp_hops``, ``tp_bytes``) until
    :meth:`reset_wire`."""

    tp: int
    codec: str = "none"
    k_frac: float = 0.1
    feedback: str = "none"
    seq_dim: int = 1

    def __post_init__(self):
        if not isinstance(self.tp, int) or self.tp < 1:
            raise ValueError(f"tp must be the tensor ring's size, a "
                             f"positive int, got {self.tp!r}")
        if self.feedback not in TP_FEEDBACK_MODES:
            raise ValueError(f"unknown tp feedback {self.feedback!r}; "
                             f"known: {TP_FEEDBACK_MODES}")
        if self.feedback != "none" and self.codec == "none":
            raise ValueError(
                "tp feedback compensates a LOSSY tp codec; with "
                "codec='none' there is nothing to compensate")
        self._codec = get_codec(self.codec)
        self.reset_wire()

    def reset_wire(self) -> None:
        self.wire = {"tp_hops": 0, "tp_bytes": 0}

    # -- wire primitives (no autograd) --------------------------------------

    def _pack(self, x):
        return pack_grad_leaf(self._codec, x, self.k_frac)

    def _decode(self, payload, shape, dtype):
        return unpack_grad_leaf(self._codec, payload, shape).to(dtype)

    def _hop(self, payload):
        """One point-to-point hop of a payload: counted, and framed into
        one byte buffer and back."""
        self.wire["tp_hops"] += 1
        self.wire["tp_bytes"] += wire_bytes(payload)
        return unfuse_payload(fuse_payload(payload), payload_struct(payload))

    def all_gather_wire(self, shards):
        """Ring all-gather of the ranks' packed ``shards``: each rank packs
        and frames its own shard once; the ``tp`` buffers are unframed and
        decoded in source-rank order and concatenated.  Returns the one
        gathered activation every rank holds."""
        if self.tp == 1:
            return shards[0]
        if len(shards) != self.tp:
            raise ValueError(f"all-gather over tp={self.tp} ranks got "
                             f"{len(shards)} shards")
        x0 = shards[0]
        payloads = [self._pack(x) for x in shards]
        struct = payload_struct(payloads[0])
        bank, ring = _ring_gather([fuse_payload(p) for p in payloads],
                                  self.tp)
        self.wire["tp_hops"] += ring["dp_hops"]
        self.wire["tp_bytes"] += ring["dp_bytes"]
        parts = [self._decode(unfuse_payload(bank[s], struct), x0.shape,
                              x0.dtype) for s in range(self.tp)]
        return torch.cat(parts, dim=self.seq_dim)

    def reduce_scatter_wire(self, partials):
        """Packed-slice exchange + source-rank-ordered sum: rank ``r``
        keeps ``sum_s C(partials[s][slice r])``.  Every contribution, the
        rank's own included, goes through the codec; each one that leaves
        its rank makes one hop.  Returns the ``tp`` shards."""
        tp, dim = self.tp, self.seq_dim
        if tp == 1:
            return list(partials)
        if len(partials) != tp:
            raise ValueError(f"reduce-scatter over tp={tp} ranks got "
                             f"{len(partials)} partial outputs")
        p0 = partials[0]
        if p0.shape[dim] % tp:
            raise ValueError(f"reduce-scatter dim {dim} ({p0.shape[dim]}) "
                             f"not divisible by tp={tp}")
        sl = p0.shape[dim] // tp
        shard_shape = list(p0.shape)
        shard_shape[dim] = sl
        # payloads[s][j]: source s's packed slice for rank j
        payloads = [[self._pack(p.narrow(dim, j * sl, sl)) for j in range(tp)]
                    for p in partials]
        out = []
        for r in range(tp):
            acc = None
            for s in range(tp):
                pl = payloads[s][r] if s == r else self._hop(payloads[s][r])
                m = self._decode(pl, tuple(shard_shape), p0.dtype)
                acc = m if acc is None else acc + m
            out.append(acc)
        return out

    # -- differentiable collectives ------------------------------------------

    def _own_slice(self, full, r: int, sl: int):
        return full.narrow(self.seq_dim, r * sl, sl)

    def gather(self, xs, resid=None, mirror=None):
        """Differentiable compressed all-gather of the ranks' shards
        ``xs`` with feedback.  ``resid`` / ``mirror``: ONE site's buffer
        (the full activation's shape) or None.  Returns ``(fulls,
        new_resid, new_mirror)``: one gathered activation per rank (views
        of one tensor); the state updates carry no gradient."""
        xs = list(xs)
        if self.feedback == "none" or self.tp == 1:
            if self.tp == 1:
                return xs, resid, mirror
            return list(_Gather.apply(self, None, None, *xs)), resid, mirror
        sl = xs[0].shape[self.seq_dim]
        if self.feedback == "ef":
            es = [self._own_slice(resid, r, sl).to(x.dtype)
                  for r, x in enumerate(xs)]
            fulls = list(_Gather.apply(self, None, es, *xs))
            with torch.no_grad():
                new_resid = torch.cat(
                    [(x + e - self._own_slice(fulls[0], r, sl)).to(
                        resid.dtype) for r, (x, e) in enumerate(zip(xs, es))],
                    dim=self.seq_dim)
            return fulls, new_resid, mirror
        # ef21: the wire carries the delta against the replicated model M;
        # the gathered activation IS the updated model
        dt = xs[0].dtype
        neg = [-self._own_slice(mirror, r, sl).to(dt) for r in range(self.tp)]
        fulls = list(_Gather.apply(self, mirror.to(dt), neg, *xs))
        new_mirror = fulls[0].detach().to(mirror.dtype)
        return fulls, resid, new_mirror

    def gather_site(self, xs, buf=None):
        """One cut point's :meth:`gather` with its single ACTIVE buffer
        (EF's resid, EF21's mirror, ignored for "none")."""
        if self.feedback == "ef":
            fulls, buf, _ = self.gather(xs, resid=buf)
        elif self.feedback == "ef21":
            fulls, _, buf = self.gather(xs, mirror=buf)
        else:
            fulls, _, _ = self.gather(xs)
        return fulls, buf

    def scatter(self, partials):
        """Differentiable compressed reduce-scatter of the ranks' partial
        outputs (no feedback, as in the reference)."""
        if self.tp == 1:
            return list(partials)
        return list(_Scatter.apply(self, *partials))

    def wire_report(self, feat_shape, *, sites: int = 1,
                    dtype=torch.bfloat16) -> dict:
        return tp_wire_report(feat_shape, self.tp, self.codec,
                              k_frac=self.k_frac, dtype=dtype,
                              seq_dim=self.seq_dim, sites=sites)


def _trace_wire(tpc: TPCollectives, feat_shape, dtype, sites: int) -> None:
    """Emit the ``tp.wire`` event when tracing is on (none at tp = 1), as
    the reference does at trace time: once per new input key of the
    running step (``obs/keyed.py``)."""
    if trace.get_tracer() is None or tpc.tp == 1:
        return
    # every hop's payload is framed into one buffer: one launch a hop
    trace_time_instant("tp.wire", cat="wire", axis="tensor",
                       feedback=tpc.feedback, fused=True, launches_per_hop=1,
                       **tpc.wire_report(feat_shape, sites=sites,
                                         dtype=dtype))


def tp_apply(fn: Callable, params, x, tpc: TPCollectives, *, param_dims,
             state: Optional[FeedbackState] = None, sites: int = 0,
             rows: int = 1):
    """Run a TP stage function over the tensor ring.

    ``fn(rank_params, xs, resid, mirror) -> (ys, new_resid, new_mirror)``
    computes the layer stack on the ranks' sequence shards ``xs``, calling
    ``tpc.gather`` / ``tpc.scatter`` at the cut points
    (``models/transformer.tp_stage_stack_fn``); ``rank_params`` is the
    list of the ranks' weights, each leaf of ``params`` cut by
    ``param_dims`` (:func:`tp_local`).

    ``state``: a scope-"tp" :class:`FeedbackState` (or None) for this
    ``x``'s batch.  Returns ``(y, new_state)`` with ``y`` the shards
    concatenated back into the full activation.  The reference's
    ``batch_axis`` (DP x TP) is the caller's loop over data lanes here
    (``train/steps.py``); ``rows``, the number of those lanes, only sizes
    the traced ``tp.wire`` event, which the reference reports once for the
    whole batch."""
    seq_dim, tp = tpc.seq_dim, tpc.tp
    if x.shape[seq_dim] % tp:
        raise ValueError(f"sequence dim {seq_dim} ({x.shape[seq_dim]}) "
                         f"not divisible by tp={tp}")
    if state is not None and state.scope != "tp":
        raise ValueError(f"tp_apply needs scope='tp' state, got "
                         f"{state.scope!r}")
    _trace_wire(tpc, (x.shape[0] * rows, *x.shape[1:]), x.dtype, sites)
    if state is None:
        state = init_tp_state(x.shape, max(sites, 1), "none",
                              device=x.device)
    sl = x.shape[seq_dim] // tp
    xs = [x.narrow(seq_dim, r * sl, sl) for r in range(tp)]
    rank_params = [tp_local(params, param_dims, tp, r) for r in range(tp)]
    ys, new_resid, new_mirror = fn(rank_params, xs, state.resid,
                                   state.mirror)
    return (torch.cat(ys, dim=seq_dim),
            state.replace(resid=new_resid, mirror=new_mirror))
