"""Compressed data-parallel gradient all-reduce over the wire codecs.

Port of ``repro/transport/collectives.py``.  Every replica owns the
gradient of its batch shard, and what crosses the data axis is a PACKED
payload from the same wire-codec registry the stage cuts use
(``transport/codecs.py``).  The scheme (compress, then exchange):

  1. every replica packs each parameter-leaf gradient with one codec call
     (per-leaf per-tensor scales; odd leaves take the q4 pad path),
     optionally error-compensated by per-replica residual buffers;
  2. all of a replica's per-leaf payloads are FUSED into one contiguous
     uint8 buffer (``fuse_payload``: one buffer per ring hop);
  3. the buffers ride a ring of ``dp - 1`` hops, each replica banking the
     buffer in flight by SOURCE rank ``(r - h) % dp``;
  4. the bank is decoded and summed in source-rank order -- a fixed
     association -- by ``kernels/dp_reduce.decode_sum_fused`` when every
     leaf rides the per-tensor q8/q4 format, else by the reference's loop
     (``unfuse_payload`` -> ``unpack_grad_leaf`` -> add, rank by rank).
     Both give the same bits.

Single controller.  On one card there is no mesh: ``make_grad_all_reduce``
takes ``dp`` where the reference takes ``(mesh, axis)``, and ``reduce``
takes gradient trees whose leaves are ``(dp, *leaf)``, one lane per
replica.  The ring is counted, not sent: ``dp * (dp - 1)`` hops of each
source's buffer bytes.  Every replica's bank is then the same tensor, so
it is decoded once; "replicas bitwise identical" holds here by
construction, and becomes a test in the multi-card slice.

``codec="none"`` is a RAW passthrough (native dtype), so an uncompressed
reduce is bitwise the serial sum.  Error feedback:

  * ``ef``   -- send C(g + e);                 e' = g + e - C(g + e)
  * ``ef21`` -- send the delta C(g - w);       w' = w + C(g - w), and the
               reduced gradient is G + sum_r C(g_r - w_r), which becomes
               the REPLICATED aggregate G (``FeedbackState.agg``).

``average=True`` divides each replica's contribution by a tensor holding
``dp``: on CUDA, PyTorch multiplies by the reciprocal when it divides by
a Python scalar, which is not IEEE division.

``shard_axis=S`` (the pipeline x DP reduce) splits the reduce into ``S``
stage columns, as the reference's ``shard_map`` over ``P(stage)`` does:
a leaf ``(dp, n, ...)`` whose ``n`` divides ``S`` gives column ``c`` its
rows ``[c*n/S, (c+1)*n/S)``, and every column packs, fuses, rings,
decodes and sums only its own slice (per-tensor scales, q4 row stats and
TopK's ``k`` are the slice's).  A leaf that does not divide stays
stage-replicated: every column carries all of it.

``tp_axis=T`` with ``tp_dims`` (the DP x TP and 3D reduces) splits it
further by tensor coordinate: a leaf whose ``tp_dims`` entry ``d >= 1``
(an index into the ``(dp, *leaf)`` array) gives coordinate ``t`` its
``1/T`` slice along ``d``, and each coordinate rings only its own weight
shards over the data axis (scales and ``k`` are the shard's).  A
replicated leaf (-1) rings whole in every coordinate, which all get the
same bits.  The reduce runs once per (stage column, tensor coordinate).
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.core.feedback import FEEDBACK_REGISTRY, FeedbackState
from repro_torch.kernels.dp_reduce import build_decode_plans, decode_sum_fused
from repro_torch.obs import trace
from repro_torch.obs.keyed import trace_time_instant
from repro_torch.transport.codecs import (LeafStruct, WireCodec,
                                          fuse_payload, get_codec,
                                          payload_leaves, payload_struct,
                                          tree_unflatten, unfuse_payload,
                                          wire_bytes)

# The modes whose registry entry admits the "dp" scope (core/feedback.py).
DP_FEEDBACK_MODES = tuple(m.name for m in FEEDBACK_REGISTRY.values()
                          if "dp" in m.scopes)


def _leaf_n(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def pack_grad_leaf(codec: WireCodec, a: torch.Tensor, k_frac: float = 0.1):
    """One parameter leaf -> wire payload.  ``none`` passes the RAW leaf
    through (dtype kept: the uncompressed reduce stays bitwise); lossy
    codecs flatten to ``(1, n)`` float32 -- one per-tensor scale per leaf,
    the q4 pad path for odd ``n``, uint16 TopK indices when ``n`` fits."""
    if codec.name == "none":
        return a
    return codec.pack(a.reshape(1, -1).to(torch.float32), k_frac)


def unpack_grad_leaf(codec: WireCodec, payload, shape) -> torch.Tensor:
    """Inverse of :func:`pack_grad_leaf`; lossy codecs decode to f32."""
    if codec.name == "none":
        return payload
    n = _leaf_n(shape)
    return codec.unpack(payload, (1, n), torch.float32).reshape(shape)


def grad_payload_structs(grads_like, codec_name: str,
                         k_frac: float = 0.1) -> List:
    """Every leaf's packed payload as :class:`LeafStruct` trees, worked out
    from shapes alone: the bytes-on-wire source of :func:`dp_wire_report`.
    ``grads_like``: a tree of tensors or ``LeafStruct``s."""
    codec = get_codec(codec_name)
    out = []
    for leaf in payload_leaves(grads_like):
        shape = tuple(leaf.shape)
        out.append(LeafStruct(shape, leaf.dtype) if codec.name == "none"
                   else codec.payload_struct((1, _leaf_n(shape)), k_frac))
    return out


def _sharded(shape, s_shard: int) -> bool:
    """Does a leaf of ``shape`` (replica dim stripped) split into
    ``s_shard`` stage columns along its dim 0?"""
    return (s_shard > 1 and len(shape) > 0 and shape[0] > 0
            and shape[0] % s_shard == 0)


def _column_struct(grads_like, s_shard: int, t_shard: int = 1,
                   tdims=None) -> list:
    """One (stage column, tensor coordinate) block's leaves as
    :class:`LeafStruct`s: dim 0 cut to ``1/s_shard`` where the leaf
    splits, the tensor dim ``tdims[i]`` (of the leaf, -1 for none) cut to
    ``1/t_shard``.  Every block has these shapes."""
    out = []
    for i, leaf in enumerate(payload_leaves(grads_like)):
        shape = list(leaf.shape)
        if _sharded(tuple(shape), s_shard):
            shape[0] //= s_shard
        if tdims is not None and tdims[i] >= 0:
            shape[tdims[i]] //= t_shard
        out.append(LeafStruct(tuple(shape), leaf.dtype))
    return out


def dp_wire_report(grads_like, codec_name: str, *, k_frac: float = 0.1,
                   dp: int = 2, shard_axis: int = None, tp_axis: int = None,
                   tp_dims=None) -> dict:
    """Exact and modeled wire bytes of ONE compressed DP all-reduce.

    ``payload_bytes_per_hop``: the fused uint8 buffer each replica sends
    per ring hop (exact, from the packed payload shapes).  ``model_bytes``:
    sum over leaves of ``n * wire_bytes_per_elem``.  One reduce = ``dp -
    1`` hops per replica.

    ``shard_axis=S``: the numbers of ONE stage column, and ``columns`` =
    S (all columns alike).  ``tp_axis=T`` with ``tp_dims`` (the leaves'
    tensor dims in ``grads_like``'s own layout, ``tp_param_dims`` of it):
    the numbers of ONE tensor coordinate's shards, per device, and
    ``tensor_columns`` = T.  The whole ring then makes ``S * T * dp * (dp
    - 1)`` hops and moves ``S * T * dp * wire_bytes_per_reduce`` bytes,
    which is what the steps' ``metrics["wire"]`` counts."""
    if (tp_axis is None) != (tp_dims is None):
        raise ValueError("tp_axis and tp_dims come together (see "
                         "models/transformer.tp_param_dims)")
    s_shard, t_shard = shard_axis or 1, tp_axis or 1
    if s_shard > 1 or t_shard > 1:
        grads_like = _column_struct(
            grads_like, s_shard, t_shard,
            None if tp_dims is None else payload_leaves(tp_dims))
    codec = get_codec(codec_name)
    structs = grad_payload_structs(grads_like, codec_name, k_frac)
    exact = wire_bytes(structs)
    model = 0.0
    for leaf in payload_leaves(grads_like):
        n = _leaf_n(leaf.shape)
        elem = leaf.dtype.itemsize if codec.name == "none" else 2
        model += codec.wire_bytes_per_elem(n, elem, k_frac) * n
    rep = {
        "dp_codec": codec_name, "k_frac": k_frac, "dp": dp,
        "n_param_leaves": len(structs),
        "n_payload_leaves": len(payload_leaves(structs)),
        "payload_bytes_per_hop": exact,
        "model_bytes": round(model),
        "hops_per_reduce": dp - 1,
        "wire_bytes_per_reduce": (dp - 1) * exact,
    }
    if shard_axis is not None:
        rep["columns"] = s_shard
    if tp_axis is not None:
        rep["tensor_columns"] = t_shard
    return rep


def init_dp_state(grads_like, dp: int, feedback: str = "none",
                  dtype=torch.float32, device=None) -> FeedbackState:
    """Per-replica DP feedback state, carried beside the train state.

    A :class:`~repro_torch.core.feedback.FeedbackState` at scope ``"dp"``:
    ``resid`` holds ``(dp, *leaf)`` per-replica buffers (EF's error e_r /
    EF21's gradient model w_r) in the gradient tree's layout; ``agg`` is
    EF21's replicated aggregate ``G = sum_r w_r``.  ``mirror`` and unused
    slots are size 0.  ``device``: default, that of ``grads_like``'s
    first tensor (the CPU for ``LeafStruct`` trees)."""
    if feedback not in DP_FEEDBACK_MODES:
        raise ValueError(f"unknown dp feedback {feedback!r}; "
                         f"known: {DP_FEEDBACK_MODES}")
    if device is None:
        first = next(iter(payload_leaves(grads_like)), None)
        device = getattr(first, "device", None)
    z = torch.zeros((0,), dtype=dtype, device=device)
    if feedback == "none":
        return FeedbackState(resid=torch.zeros((dp, 0), dtype=dtype,
                                               device=device),
                             mirror=z, agg=z, scope="dp", direction="grad",
                             mode=feedback)

    def zeros(lead):
        return tree_unflatten(grads_like, iter(
            torch.zeros((*lead, *a.shape), dtype=dtype, device=device)
            for a in payload_leaves(grads_like)))

    return FeedbackState(resid=zeros((dp,)), mirror=z,
                         agg=zeros(()) if feedback == "ef21" else z,
                         scope="dp", direction="grad", mode=feedback)


def _ring_gather(payloads: list, dp: int):
    """All-gather by a ring of ``dp - 1`` hops, banking the buffer in
    flight by SOURCE rank.  ``payloads[r]``: replica r's fused uint8
    buffer (or its payload tree).  Returns the bank -- ``(dp, nbytes)``
    for buffers, the list of payloads by source rank otherwise -- and the
    hops and bytes the ring moves.  Every replica's bank is this one: at
    hop h replica r receives source ``(r - h) % dp``'s buffer into the
    slot that already holds it."""
    slots = list(payloads)                   # each replica's own slot
    hops = nbytes = 0
    for h in range(1, dp):
        for r in range(dp):
            src = (r - h) % dp               # in flight at r after h hops
            hops += 1
            nbytes += wire_bytes(slots[src])
    bank = (torch.stack(slots) if isinstance(slots[0], torch.Tensor)
            else slots)
    return bank, {"dp_hops": hops, "dp_bytes": nbytes}


def make_grad_all_reduce(dp: int, codec: str = "none", *,
                         k_frac: float = 0.1, feedback: str = "none",
                         average: bool = False, fused: bool = True,
                         shard_axis: int = None, tp_axis: str = None,
                         tp_dims=None):
    """Build ``reduce(grads_dp, dp_state) -> (reduced, new_dp_state,
    wire)``.

    ``grads_dp``: a gradient tree whose leaves carry a leading replica dim
    ``(dp, *leaf)``.  The reduced gradient comes back replica-free, in the
    leaves' dtype.  ``wire``: ``{"dp_hops", "dp_bytes"}`` of the ring.

    ``average=True`` scales each replica's contribution by ``1/dp`` before
    compression (per-replica mean losses); default is a plain sum.
    ``fused=False`` rings the per-leaf payload trees instead of one fused
    buffer -- same bytes -- and always decodes with the loop.

    ``shard_axis``: the size ``S`` of the stage axis of the pipeline x DP
    step (the reference takes the axis' name and reads its size from the
    mesh).  The reduce then runs once per stage column on the column's
    slices (module doc), and ``wire`` counts ``S * dp * (dp - 1)`` hops:
    the sum over columns of each column's ring.

    ``tp_axis``: the size ``T`` of the tensor axis (the DP x TP and 3D
    reduces), with ``tp_dims``: a tree matching ``grads_dp`` of each
    leaf's tensor-sharded dim as an index into its ``(dp, *leaf)`` array,
    -1 for a replicated leaf (``models/transformer.tp_param_dims`` of the
    replica-stacked tree).  The reduce then also runs once per tensor
    coordinate on its shards (module doc), and ``wire`` counts ``S * T *
    dp * (dp - 1)`` hops."""
    for nm, axis, size in (("shard_axis", "stage", shard_axis),
                           ("tp_axis", "tensor", tp_axis)):
        if size is not None and (not isinstance(size, int) or size < 1):
            raise ValueError(f"{nm} must be the {axis} axis' size, a "
                             f"positive int, got {size!r}")
    if (tp_axis is None) != (tp_dims is None):
        raise ValueError("tp_axis and tp_dims come together (see "
                         "models/transformer.tp_param_dims)")
    if feedback not in DP_FEEDBACK_MODES:
        raise ValueError(f"unknown dp feedback {feedback!r}; "
                         f"known: {DP_FEEDBACK_MODES}")
    if feedback != "none" and codec == "none":
        raise ValueError("dp_feedback compensates a LOSSY dp_codec; "
                         "with dp_codec='none' there is nothing to "
                         "compensate — drop dp_feedback")
    codec_obj = get_codec(codec)
    lossy = codec_obj.name != "none"
    s_shard, t_shard = shard_axis or 1, tp_axis or 1

    def contribution(a, e):
        """Replica ``a``'s compensated leaf, as the reference computes
        it: the raw leaf (divided in its dtype) for ``none``, f32 else."""
        if not lossy:
            return a / a.new_full((), dp) if average else a
        x = a.to(torch.float32)
        if average:
            x = x / x.new_full((), dp)
        if feedback == "ef":
            x = x + e
        elif feedback == "ef21":
            x = x - e                              # resid holds w_r
        return x

    def reduce_leaves(gl, rl, al):
        """One ring's reduce of the leaves ``gl`` (each ``(dp, *leaf)``)
        with their residuals ``rl`` and aggregates ``al``.  Returns the
        reduced leaves, the new residuals and aggregates, and the ring's
        counts."""
        shapes = [tuple(a.shape[1:]) for a in gl]

        # -- compensate + pack, replica by replica --------------------------
        xs, payloads = [], []
        for r in range(dp):
            xr = [contribution(a[r], None if e is None else e[r])
                  for a, e in zip(gl, rl)]
            payloads.append([pack_grad_leaf(codec_obj, x, k_frac)
                             for x in xr])
            xs.append(xr if feedback == "ef" else None)

        # -- exchange: one fused buffer per replica (or the payloads) -------
        struct = payload_struct(payloads[0])
        if fused:
            bank, wire = _ring_gather([fuse_payload(p) for p in payloads],
                                      dp)
        else:
            bank, wire = _ring_gather(payloads, dp)

        # -- decode + sum in source-rank order ------------------------------
        plans = (build_decode_plans(struct, shapes)
                 if fused and codec_obj.name in ("q8", "q4") else None)
        if plans is not None:
            acc = [d.reshape(s) for d, s in
                   zip(decode_sum_fused(bank, plans, dp), shapes)]
        else:
            acc = [None] * len(gl)
            for s in range(dp):
                pls = unfuse_payload(bank[s], struct) if fused else bank[s]
                for i, shape in enumerate(shapes):
                    m = unpack_grad_leaf(codec_obj, pls[i], shape)
                    acc[i] = m if acc[i] is None else acc[i] + m

        # -- feedback updates (own decode == own slot, same bits) ----------
        out, new_rl, new_al = [], [], []
        for i, (a, shape) in enumerate(zip(gl, shapes)):
            if feedback == "none":
                out.append(acc[i].to(a.dtype))
                continue
            m_own = [unpack_grad_leaf(codec_obj, payloads[r][i], shape)
                     for r in range(dp)]
            if feedback == "ef":
                new_rl.append(torch.stack([xs[r][i] - m_own[r]
                                           for r in range(dp)]))
                out.append(acc[i].to(a.dtype))
            else:                                  # ef21
                reduced = al[i] + acc[i]           # G + sum_r C(g_r - w_r)
                new_rl.append(torch.stack([rl[i][r] + m_own[r]
                                           for r in range(dp)]))
                new_al.append(reduced)
                out.append(reduced.to(a.dtype))
        return out, new_rl, new_al, wire

    def reduce_columns(gl, rl, al, tdims):
        """:func:`reduce_leaves` once per (stage column, tensor
        coordinate) on its slices, the results put back together along
        the split dims (one block of whole leaves without ``shard_axis``
        and ``tp_axis``).  ``tdims[i]``: leaf i's tensor dim in its
        ``(dp, *leaf)`` array, or -1."""
        cut = [_sharded(tuple(a.shape[1:]), s_shard) for a in gl]
        tcut = [t_shard > 1 and d >= 1 for d in tdims]
        for a, d, tc in zip(gl, tdims, tcut):
            if tc and a.shape[d] % t_shard:
                raise ValueError(f"tensor dim {d} of gradient leaf "
                                 f"{tuple(a.shape)} is not divisible by "
                                 f"tp_axis={t_shard}")
        blocks = [(c, t) for c in range(s_shard) for t in range(t_shard)]

        def part(a, c, t, i, lead):
            """Block (c, t) of leaf i of an array with ``lead`` replica
            dims (1: gradients, residuals; 0: aggregates)."""
            if cut[i]:
                w = a.shape[lead] // s_shard
                a = a.narrow(lead, c * w, w)
            if tcut[i]:
                d = tdims[i] - 1 + lead
                w = a.shape[d] // t_shard
                a = a.narrow(d, t * w, w)
            return a

        res = [reduce_leaves(
            [part(a, c, t, i, 1) for i, a in enumerate(gl)],
            [None if e is None else part(e, c, t, i, 1)
             for i, e in enumerate(rl)],
            None if al is None else [part(g, c, t, i, 0)
                                     for i, g in enumerate(al)])
            for c, t in blocks]

        def join(j, lead):
            out = []
            for i in range(len(res[0][j])):
                rows = []
                for c in range(s_shard if cut[i] else 1):
                    ts = [res[c * t_shard + t][j][i]
                          for t in range(t_shard if tcut[i] else 1)]
                    rows.append(torch.cat(ts, tdims[i] - 1 + lead)
                                if tcut[i] else ts[0])
                out.append(torch.cat(rows, lead) if cut[i] else rows[0])
            return out

        wire = {k: sum(r[3][k] for r in res) for k in res[0][3]}
        return join(0, 0), join(1, 1), join(2, 0), wire

    def _trace_wire(gl) -> None:
        """Emit the ``dp.wire`` event when tracing is on, as the reference
        does at trace time: once per new input key of the running step
        (``obs/keyed.py``), with the report of the whole gradient tree and
        the reference's axis names."""
        if trace.get_tracer() is None:
            return
        rep = dp_wire_report([LeafStruct(tuple(a.shape[1:]), a.dtype)
                              for a in gl], codec, k_frac=k_frac, dp=dp)
        trace_time_instant(
            "dp.wire", cat="wire", axis="data", feedback=feedback,
            fused=fused, shard_axis="" if shard_axis is None else "stage",
            launches_per_hop=1 if fused else rep["n_payload_leaves"], **rep)

    def reduce(grads_dp, dp_state: FeedbackState):
        gl = payload_leaves(grads_dp)
        for a in gl:
            if a.shape[0] != dp:
                raise ValueError(f"gradient leaf {tuple(a.shape)} has no "
                                 f"leading replica dim of {dp}")
        _trace_wire(gl)
        rl = (payload_leaves(dp_state.resid) if feedback != "none"
              else [None] * len(gl))
        al = payload_leaves(dp_state.agg) if feedback == "ef21" else None
        tdims = (payload_leaves(tp_dims) if tp_dims is not None
                 else [-1] * len(gl))
        out, new_rl, new_al, wire = reduce_columns(gl, rl, al, tdims)
        reduced_tree = tree_unflatten(grads_dp, iter(out))
        if feedback != "none":
            dp_state = dp_state.replace(
                resid=tree_unflatten(dp_state.resid, iter(new_rl)),
                agg=(tree_unflatten(dp_state.agg, iter(new_al))
                     if feedback == "ef21" else dp_state.agg))
        return reduced_tree, dp_state, wire

    return reduce
