"""LM and CNN train and eval steps with the paper's boundary compression.

Port of ``repro/train/steps.py``: ``make_lm_train_step`` on the
simulated transport (with gradient accumulation) and on the real
pipeline (alone, or on the ``(data, stage)`` grid), with or without a
tensor axis,
``make_lm_eval_step``, and the CNN's
``make_cnn_train_step`` (simulated and pipeline) and
``make_cnn_eval_step``.  The LM steps run the decoder-only stack or,
for an encoder-decoder config, ``models/encdec.py`` (simulated cuts,
gradient accumulation and DP lanes; the pipeline and the tensor axis
refuse it, as in the reference).  The step is eager
PyTorch: one forward, the chunked LM loss, one backward, then the
optimizer.  On the simulated transport each cut is a ``boundary_apply``
in ``forward_hidden``; on the pipeline the embedding and the loss run on
the whole batch and the layer stack runs through ``pipeline_apply``.  The
new backward feedback state is read after the backward from the cuts'
``BwSlot``s or the pipeline's ``PipelineSlot`` (the reference reads it
out of the gradient w.r.t. the bw buffers).

Data parallelism on the simulated transport (``parallel=`` a
:class:`~repro_torch.core.parallel.ParallelSpec` with ``data`` > 1, or
the deprecated ``dp``/``dp_codec``/``dp_feedback``/``dp_k_frac``
kwargs): the global batch splits into ``dp`` contiguous shards, each
lane computes its gradient, and one compressed all-reduce
(``transport/collectives.py``) feeds one optimizer update.  On the
pipeline, ``data`` > 1 runs the pipeline x DP step: each replica row
pipelines its batch shard through its own copy of the layer stack, and
the per-replica stack gradients cross the stage-column-sharded reduce.
A :class:`~repro_torch.core.policy.PolicyRules` policy resolves per
cut through ``boundary_feat=`` before the step is built.

The tensor axis (``parallel=`` with ``tensor`` > 1): the layer stack
runs tensor-parallel over a ring of ``tp`` ranks with the compressed
all-gather / reduce-scatter (``transport/tp_collectives.py``), alone, on
``dp`` data lanes (the DP x TP step: each lane's stack gradient crosses
the tensor-sharded reduce), or inside every pipeline stage (pipeline x
TP and the 3D step).

The train steps come back wrapped by ``obs/keyed.keyed_step``: with
tracing on, their wire events fire once per new input key, as the
reference's fire once per jit compilation.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.feedback import FeedbackState, get_mode, shard_ids
from repro_torch.core.parallel import ParallelSpec, from_legacy, warn_legacy
from repro_torch.core.policy import (NO_COMPRESSION, BoundaryPolicy,
                                     CompressionPolicy, PolicyRules,
                                     resolve_policy)
from repro_torch.models import cnn, encdec, transformer
from repro_torch.obs.keyed import keyed_step
from repro_torch.optim.optimizers import (OptimizerConfig, apply_updates,
                                          tree_leaves, tree_map)
from repro_torch.transport.collectives import make_grad_all_reduce
from repro_torch.transport.pipeline import pipeline_apply
from repro_torch.transport.schedules import as_schedule
from repro_torch.transport.tp_collectives import TPCollectives, tp_apply

# Sentinel distinguishing "caller passed the legacy kwarg" (deprecation
# shim -> ParallelSpec) from "default" on make_lm_train_step.
_UNSET = object()

_LEGACY_DEFAULTS = {"dp": 1, "dp_codec": "none", "dp_feedback": "none",
                    "dp_k_frac": 0.1}


def _keyed(make_step):
    """``make_step`` whose steps fire their trace-time events once per new
    input key (``obs/keyed.py``)."""
    @functools.wraps(make_step)
    def make(*args, **kwargs):
        return keyed_step(make_step(*args, **kwargs))
    return make


def _resolve_parallel(api: str, parallel, policy, transport: str, legacy):
    """Fold ``parallel=`` and the deprecated ``dp_*`` kwarg family into
    one ``(ParallelSpec, policy, transport)`` triple, as the reference
    does.  Legacy kwargs (``_UNSET`` when not passed) build the equivalent
    spec and warn; passing both families is an error.  A spec with
    ``stages > 1`` implies the pipeline transport; its stage wire
    (``spec.stage_policy()``) becomes the boundary policy unless the
    caller already supplied a compressing ``policy`` (conflict)."""
    explicit = tuple(sorted(k for k, v in legacy.items() if v is not _UNSET))
    if parallel is not None:
        if explicit:
            raise ValueError(
                f"{api}: both parallel= and the legacy kwarg(s) "
                f"{list(explicit)} were passed — drop the legacy kwargs")
        if not isinstance(parallel, ParallelSpec):
            raise TypeError(f"{api}: parallel= must be a ParallelSpec, "
                            f"got {type(parallel).__name__}")
        spec = parallel
    else:
        if explicit:
            warn_legacy(api, explicit)
        vals = {k: (legacy[k] if legacy[k] is not _UNSET else d)
                for k, d in _LEGACY_DEFAULTS.items()}
        spec = from_legacy(
            num_stages=(policy.num_stages if transport == "pipeline" else 1),
            **vals)
    for name in ("data", "stage", "tensor"):
        if spec.axis(name).is_rules:
            raise ValueError(
                f"{api}: the {name!r} axis codec is an unresolved rule "
                "spec — call ParallelSpec.resolved(wire_sizes, bandwidth) "
                "first (run_lm_experiment does this per epoch)")
    if parallel is not None and spec.stages > 1:
        if transport == "simulated":
            transport = "pipeline"
        sp = spec.stage_policy()
        if sp is not None:
            if (policy.num_stages > 1 or policy.overrides
                    or policy.boundary != NO_COMPRESSION):
                raise ValueError(
                    f"{api}: both the stage axis wire "
                    f"({spec.stage.codec}+{spec.stage.feedback}) and a "
                    f"compressing policy= ({policy.name}) were given — "
                    "configure the stage boundary in ONE place")
            policy = sp
        elif policy.num_stages == 1:
            policy = dataclasses.replace(policy, num_stages=spec.stages)
        elif policy.num_stages != spec.stages:
            raise ValueError(
                f"{api}: policy.num_stages={policy.num_stages} != "
                f"parallel stage size {spec.stages}")
    return spec, policy, transport


def _resolve_rules(policy, boundary_feat):
    """A :class:`~repro_torch.core.policy.PolicyRules` rule set resolved
    into a concrete :class:`CompressionPolicy` before the step is built.

    ``boundary_feat``: per-cut tensor element count (one int for uniform
    cuts, or one entry per cut).  A plain ``CompressionPolicy`` passes
    through untouched, so a one-rule set gives a static policy's run bit
    for bit."""
    if isinstance(policy, PolicyRules):
        if boundary_feat is None:
            raise ValueError(
                "policy is a PolicyRules rule set — pass boundary_feat= "
                "(elements crossing each cut, e.g. seq_len * d_model for "
                "the LM) so rules can resolve to concrete codecs")
        return resolve_policy(policy, boundary_feat)
    return policy


def _map_tensors(f, tree):
    """``f`` over every tensor of nested dicts / lists / FeedbackStates."""
    if isinstance(tree, dict):
        return {k: _map_tensors(f, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tensors(f, v) for v in tree]
    if isinstance(tree, FeedbackState):
        return tree.map(f)
    return f(tree)


def _split_leading(tree, k: int):
    """Reshape every tensor ``(N, ...) -> (k, N/k, ...)`` (a view): the
    replica-lane split of DP.  Size-0 placeholders become ``(k, 0)``."""
    return _map_tensors(
        lambda a: a.reshape(k, a.shape[0] // k, *a.shape[1:]), tree)


def _labels_and_mask(tokens):
    """Next-token labels (``roll(tokens, -1)``) and a mask that drops the
    last position, whose label wrapped around."""
    labels = torch.roll(tokens, -1, dims=1)
    mask = torch.ones(labels.shape, dtype=torch.float32,
                      device=tokens.device)
    mask[:, -1] = 0.0
    return labels, mask


def _resolve_grad_accum(grad_accum: int,
                        microbatches: Optional[int]) -> int:
    """``microbatches=`` is the deprecated name of the grad-accumulation
    knob (it collided with the pipeline's GPipe microbatch count)."""
    if microbatches is None:
        return grad_accum
    if grad_accum != 1:
        raise ValueError(
            f"both grad_accum={grad_accum} and its deprecated alias "
            f"microbatches={microbatches} were passed — drop microbatches=")
    warnings.warn(
        "microbatches= is deprecated (it means gradient accumulation, not "
        "pipeline microbatches): pass grad_accum= instead, and "
        "pipeline_microbatches= for the GPipe microbatch count",
        DeprecationWarning, stacklevel=3)
    return microbatches


@_keyed
def make_lm_train_step(cfg, policy: CompressionPolicy, opt: OptimizerConfig,
                       aux_weight: float = 0.01, remat: bool = True,
                       grad_accum: int = 1,
                       microbatches: Optional[int] = None,
                       transport: str = "simulated",
                       pipeline_microbatches: Optional[int] = None,
                       schedule: str = "gpipe", virtual_stages: int = 1,
                       dp=_UNSET, dp_codec=_UNSET, dp_feedback=_UNSET,
                       dp_k_frac=_UNSET, boundary_feat=None,
                       parallel: Optional[ParallelSpec] = None,
                       donate: bool = False):
    """Returns ``step(params, opt_state, bstates, batch, ids) -> (params,
    opt_state, bstates, metrics)``.

    ``policy`` may be a :class:`~repro_torch.core.policy.PolicyRules`
    rule set, resolved against ``boundary_feat`` (the elements crossing
    each cut per example: ``seq * d_model`` for the LM's uniform cuts).

    batch: {"tokens": (B, S) int}; ``bstates``: one ``{"fw", "bw"}`` dict
    per cut (``[]`` without compression); ``ids``: (B,) example ids.  The
    caller's params are not modified; AQ-SGD's fw buffer is updated in
    place (``core/feedback.aqsgd_message``).  ``donate`` is the port of
    the reference's ``donate`` argument (its ``donate_argnums``; the
    reference defaults to it, the port does not, since an eager tensor
    cannot be invalidated): with ``donate=True`` (simulated transport)
    the params and optimizer state are updated in place instead
    (``optim.apply_updates(donate=True)``, the same bits), and the
    caller's old params and state then hold the new values.

    ``grad_accum > 1`` (simulated transport): the batch, ids and feedback
    buffers split along B into ``grad_accum`` pieces, run one after the
    other; the gradients sum in f32, are divided by ``grad_accum`` and
    cast to bfloat16, as the reference's are, and loss and aux are the
    pieces' means.  ``microbatches=`` is its deprecated alias.

    ``transport="pipeline"`` trains through the real compressed pipeline
    (``transport/pipeline.py``) under ``schedule`` (gpipe | 1f1b |
    interleaved; ``virtual_stages`` slices per device for interleaved;
    ``pipeline_microbatches`` defaults to the stage count).  ``bstates``
    is then ``[]`` for a feedback-free policy, else the
    ``init_feedback_state`` dict, whose buffers the step updates in
    place; ``metrics["wire"]`` holds the step's hops and bytes per
    direction.

    ``dp > 1`` (``parallel=`` or the deprecated ``dp_*`` kwargs, which
    warn with ``ParallelDeprecationWarning``) adds a data-parallel
    dimension with the compressed gradient all-reduce: the step becomes
    ``step(params, opt_state, bstates, batch, ids, dp_state) -> (params,
    opt_state, bstates, dp_state, metrics)`` with ``dp_state`` from
    ``train/loop.init_lm_dp_state``, and ``metrics["wire"]`` holds the
    ring's ``dp_hops`` / ``dp_bytes``.  On the simulated transport the
    replicas are lanes around the cuts (``grad_accum`` composes per lane:
    accumulate locally, reduce once); on the pipeline it is the
    ``(data, stage)`` grid, whose reduced tree is the layer stack (see
    :func:`_make_dp_pipeline_lm_train_step`).

    ``tp > 1`` (``parallel=`` with a tensor axis) shards the dense layer
    stack over the tensor ring (sequence-sharded residual, head / d_ff
    sharded weights) with the all-gather / reduce-scatter packed by the
    tensor wire codec.  On the simulated transport the step gains a
    trailing ``tp_state`` (``transport/tp_collectives.init_tp_state``):
    ``step(params, opt_state, bstates, batch, ids[, dp_state], tp_state)
    -> (params, opt_state, bstates[, dp_state], tp_state, metrics)``; on
    the pipeline the tensor wire is feedback-free and the signature stays.
    ``metrics["wire"]`` adds the ring's ``tp_hops`` / ``tp_bytes`` (both
    collectives, forward and backward, every rank)."""
    transformer.check_supported(cfg)
    mod = encdec if cfg.enc_dec else transformer
    policy = _resolve_rules(policy, boundary_feat)
    grad_accum = _resolve_grad_accum(grad_accum, microbatches)
    spec, policy, transport = _resolve_parallel(
        "make_lm_train_step", parallel, policy, transport,
        {"dp": dp, "dp_codec": dp_codec, "dp_feedback": dp_feedback,
         "dp_k_frac": dp_k_frac})
    t_ax = spec.tensor
    if transport == "pipeline":
        if grad_accum > 1:
            raise NotImplementedError(
                "grad_accum > 1 is not supported with transport='pipeline' "
                "— bound activation memory with pipeline_microbatches (the "
                "1f1b schedule keeps the stash at the boundary tensors)")
        if cfg.enc_dec:
            raise NotImplementedError("pipeline transport: decoder-only "
                                      "archs")
        if spec.tp > 1 and t_ax.feedback != "none":
            raise NotImplementedError(
                "pipeline + tensor parallelism: feedback-free tensor wires "
                "only (EF/EF21 state does not thread through pipeline_apply "
                "yet)")
        tp_kw = dict(tp=spec.tp, tp_codec=t_ax.codec, tp_k_frac=t_ax.k_frac)
        if spec.dp > 1:
            d_ax = spec.data
            return _make_dp_pipeline_lm_train_step(
                cfg, _uniform_boundary(policy), opt,
                microbatches=pipeline_microbatches, schedule=schedule,
                virtual_stages=virtual_stages, dp=spec.dp,
                dp_codec=d_ax.codec, dp_feedback=d_ax.feedback,
                dp_k_frac=d_ax.k_frac, s_stages=policy.num_stages, **tp_kw)
        return _make_pipeline_lm_train_step(
            cfg, policy, opt, microbatches=pipeline_microbatches,
            schedule=schedule, virtual_stages=virtual_stages, **tp_kw)
    if transport != "simulated":
        raise ValueError(f"unknown transport {transport!r}")
    if spec.tp > 1:
        if grad_accum > 1:
            raise NotImplementedError("grad_accum > 1 + tensor parallelism")
        d_ax = spec.data
        return _make_tp_lm_train_step(
            cfg, policy, opt, dp=spec.dp, tp=spec.tp, dp_codec=d_ax.codec,
            dp_feedback=d_ax.feedback, dp_k_frac=d_ax.k_frac,
            tp_codec=t_ax.codec, tp_feedback=t_ax.feedback,
            tp_k_frac=t_ax.k_frac)

    def piece_grads(params, bstates, batch, ids):
        """One replica's (grads, new bstates, metrics) over its batch,
        from fresh leaf tensors (``p.grad`` never adds lanes together)."""
        params = tree_map(lambda p: p.detach().requires_grad_(True), params)
        labels, mask = _labels_and_mask(batch["tokens"])
        x, aux, new_fw, slots = mod.forward_hidden(
            params, batch, cfg, policy, bstates or None, ids, remat=remat)
        loss = transformer.hidden_lm_loss(params, x, labels, cfg, mask)
        total = loss + aux_weight * aux
        total.backward()
        grads = tree_map(lambda p: p.grad, params)
        # as the reference's zip: one state per cut the caller gave
        new_states = [{"fw": f, "bw": slot.state}
                      for f, slot, _ in zip(new_fw, slots, bstates)]
        metrics = {"loss": loss.detach(), "aux": aux.detach(),
                   "total": total.detach()}
        return grads, new_states, metrics

    def compute_grads(params, bstates, batch, ids):
        """One replica's (grads, new bstates, metrics) over its batch:
        :func:`piece_grads` over the whole of it, or over ``grad_accum``
        pieces of it, one after the other, as the reference's scan."""
        if grad_accum == 1:
            return piece_grads(params, bstates, batch, ids)
        if ids.shape[0] % grad_accum:
            raise ValueError(f"batch {ids.shape[0]} is not divisible by "
                             f"grad_accum {grad_accum}")
        split = lambda t: _split_leading(t, grad_accum)  # noqa: E731
        b_sh, ids_sh, st_sh = split(batch), split(ids), split(bstates)
        gacc, loss_s, aux_s, piece_states = None, None, None, []
        for i in range(grad_accum):
            piece = lambda t: _map_tensors(lambda a: a[i], t)  # noqa: E731
            g, new_states, m = piece_grads(params, piece(st_sh),
                                           piece(b_sh), ids_sh[i])
            g32 = tree_map(lambda a: a.to(torch.float32), g)
            gacc = g32 if gacc is None else tree_map(torch.add, gacc, g32)
            loss_s = m["loss"] if loss_s is None else loss_s + m["loss"]
            aux_s = m["aux"] if aux_s is None else aux_s + m["aux"]
            piece_states.append(new_states)
        div = loss_s.new_full((), grad_accum)
        grads = tree_map(lambda a: (a / div).to(torch.bfloat16), gacc)
        # one state a cut that exists: a preset's stages stop at the
        # model's groups, and the caller may hand in more states (the
        # reference's scan returns the pieces' own)
        new_states = [{d: _merge_lanes(st[d], [ps[j][d] for ps in
                                               piece_states])
                       for d in ("fw", "bw")}
                      for j, st in enumerate(bstates[:len(piece_states[0])])]
        metrics = {"loss": loss_s / div, "aux": aux_s / div,
                   "total": (loss_s + aux_weight * aux_s) / div}
        return grads, new_states, metrics

    if grad_accum > 1 and policy.num_boundaries and any(
            policy.at(i).feedback == "aqsgd"
            for i in range(policy.num_boundaries)):
        raise NotImplementedError("aqsgd + gradient accumulation")

    if spec.dp > 1:
        d_ax = spec.data
        return _make_dp_simulated_step(policy, opt, compute_grads, spec.dp,
                                       d_ax.codec, d_ax.feedback,
                                       d_ax.k_frac, donate)

    def step(params, opt_state, bstates, batch, ids):
        grads, new_states, metrics = compute_grads(params, bstates, batch,
                                                   ids)
        params, opt_state = apply_updates(opt, params, grads, opt_state,
                                          donate=donate)
        return params, opt_state, new_states, metrics

    return step


def _merge_lanes(orig: FeedbackState, lanes) -> FeedbackState:
    """One direction's new state from its lanes' new states: the lanes'
    rows concatenated (the reference's ``_merge_leading`` of the stacked
    lanes).  AQ-SGD's lanes wrote their id-shard rows into views of
    ``orig`` in place, so ``orig`` already is the new state."""
    if get_mode(orig.mode).per_example:
        return orig
    return lanes[0].replace(
        **{slot: (torch.cat([getattr(s, slot) for s in lanes])
                  if getattr(orig, slot).numel() else getattr(orig, slot))
           for slot in ("resid", "mirror", "agg")})


def _make_dp_simulated_step(policy, opt, compute_grads, dp, dp_codec,
                            dp_feedback, dp_k_frac, donate=False):
    """Data-parallel wrapper around the simulated-boundary gradient: ``dp``
    lanes, one per contiguous batch shard (the reference's ``jax.vmap``,
    written out as a loop), then one compressed all-reduce of the lanes'
    gradients.  Global feedback buffers split by batch shard (views);
    AQ-SGD's ``(num_samples, *feat)`` buffer splits BY EXAMPLE ID: lane r
    owns rows ``[r*ns/dp, (r+1)*ns/dp)`` and addresses them with ids
    localized by ``shard_ids``, writing them in place."""
    aqsgd = [i for i in range(policy.num_boundaries)
             if policy.at(i).feedback == "aqsgd"]
    reduce_fn = make_grad_all_reduce(dp, dp_codec, k_frac=dp_k_frac,
                                     feedback=dp_feedback, average=True)

    def step_dp(params, opt_state, bstates, batch, ids, dp_state):
        if ids.shape[0] % dp:
            raise ValueError(f"batch {ids.shape[0]} is not divisible by "
                             f"dp {dp}")
        ids_sh = _split_leading(ids, dp)
        if aqsgd and bstates:
            ns = bstates[aqsgd[0]]["fw"].resid.shape[0]
            ids_sh = torch.stack([shard_ids(ids_sh[r], r, ns, dp)
                                  for r in range(dp)])
        states_sh = _split_leading(bstates, dp)
        batch_sh = _split_leading(batch, dp)
        grads_dp, lane_states, lane_metrics = None, [], []
        for r in range(dp):
            lane = lambda t: _map_tensors(lambda a: a[r], t)  # noqa: E731
            g, new_states, m = compute_grads(params, lane(states_sh),
                                             lane(batch_sh), ids_sh[r])
            if grads_dp is None:
                grads_dp = tree_map(lambda a: a.new_empty((dp, *a.shape)),
                                    g)
            for buf, a in zip(tree_leaves(grads_dp), tree_leaves(g)):
                buf[r].copy_(a)
            lane_states.append(new_states)
            lane_metrics.append(m)
        grads, dp_state, wire = reduce_fn(grads_dp, dp_state)
        params, opt_state = apply_updates(opt, params, grads, opt_state,
                                          donate=donate)
        new_states = [{d: _merge_lanes(st[d], [ls[i][d] for ls in
                                               lane_states])
                       for d in ("fw", "bw")}
                      for i, st in enumerate(bstates)]
        metrics = {k: torch.stack([m[k] for m in lane_metrics]).mean()
                   for k in lane_metrics[0]}
        metrics["wire"] = wire
        return params, opt_state, new_states, dp_state, metrics

    return step_dp


def _uniform_boundary(policy: CompressionPolicy) -> BoundaryPolicy:
    """The single per-cut policy the pipeline runs at every cut (a rule
    policy that resolved to different codecs per cut is refused)."""
    if policy.num_boundaries == 0:
        return BoundaryPolicy()
    bps = [policy.at(i) for i in range(policy.num_boundaries)]
    if any(bp != bps[0] for bp in bps):
        raise ValueError("the pipeline transport needs the same boundary "
                         "policy at every cut (one program)")
    return bps[0]


def _tp_stage_fn(cfg, tp: int, tp_codec: str, tp_k_frac: float,
                 remat: bool):
    """The pipeline's stage function and ``pipeline_apply`` kwargs for an
    optional tensor axis: the dense stage function and none for ``tp ==
    1``; else a feedback-free TP stage over a :class:`TPCollectives` of
    ``tp`` ranks (``remat``: the schedule rematerializes, and the stage
    recomputes its local compute itself) and the ``tp_axis`` /
    ``tp_param_dims`` / ``seq_dim`` kwargs.  Returns ``(stage_fn,
    tp_kwargs, tpc)``, ``tpc`` None for ``tp == 1``."""
    if tp == 1:
        return transformer.stage_stack_fn(cfg), lambda stack: {}, None
    tpc = TPCollectives(tp, codec=tp_codec, k_frac=tp_k_frac)
    tp_fn = transformer.tp_stage_stack_fn(cfg, tpc, remat=remat)

    def stage_fn(rank_stacks, xs):
        return tp_fn(rank_stacks, xs, None, None)[0]

    def tp_kwargs(stack):
        return {"tp_axis": tp,
                "tp_param_dims": transformer.tp_param_dims(stack),
                "seq_dim": 1}

    return stage_fn, tp_kwargs, tpc


def _pipeline_lm_grads(cfg, params, batch, n_slices: int, rows: int,
                       run_row):
    """The pipeline, TP and DP x TP LM steps' forward and backward.  The
    embedding, final norm, LM head and loss run once on the whole batch
    and keep exact gradients.  The stage-stacked layer stack goes to each
    of ``rows`` replica rows as the row's own leaves (the reference's
    ``broadcast_to(stack[None], (dp, ...))``), so autograd never sums
    the rows' stack gradients.  ``run_row(r, stack, x_r) -> (y_r, *out)``
    pipelines row ``r``'s contiguous batch shard.

    Returns ``(params, loss, grads, outs)``: ``params`` as leaves that
    took the gradients, ``grads["layers"]`` the stack's gradient per row
    ``(rows, S*v, ...)`` (fold it back with :func:`_unstack`), ``outs``
    each row's ``out``."""
    params = tree_map(lambda p: p.detach().requires_grad_(True), params)
    labels, mask = _labels_and_mask(batch["tokens"])
    x = transformer._embed_input(params, batch, cfg)
    stack = transformer.stack_layer_stages(params, n_slices)
    stacks = [tree_map(lambda a: a.detach().requires_grad_(True), stack)
              for _ in range(rows)]
    x_sh = x.reshape(rows, x.shape[0] // rows, *x.shape[1:])
    outs = [run_row(r, stacks[r], x_sh[r]) for r in range(rows)]
    y = torch.cat([o[0] for o in outs]) if rows > 1 else outs[0][0]
    loss = transformer.hidden_lm_loss(params, y, labels, cfg, mask)
    loss.backward()
    grads = {k: tree_map(lambda p: p.grad, v) for k, v in params.items()}
    grads["layers"] = tree_map(
        lambda *a: torch.stack([t.grad for t in a]), *stacks)
    return params, loss, grads, [o[1:] for o in outs]


def _unstack(stack):
    """A ``(S*v, groups/(S*v), ...)`` stage-stacked tree back in the
    ``(groups, ...)`` layout of ``params["layers"]``."""
    return tree_map(
        lambda a: a.reshape(a.shape[0] * a.shape[1], *a.shape[2:]), stack)


def _make_pipeline_lm_train_step(cfg, policy: CompressionPolicy,
                                 opt: OptimizerConfig, *,
                                 microbatches: Optional[int] = None,
                                 schedule: str = "gpipe",
                                 virtual_stages: int = 1, tp: int = 1,
                                 tp_codec: str = "none",
                                 tp_k_frac: float = 0.1):
    """LM training through the real compressed pipeline: the embedding
    and the chunked loss run on the whole batch, the layer stack as
    ``policy.num_stages * virtual_stages`` logical stage slices (one
    replica row of :func:`_pipeline_lm_grads`), each tensor-parallel over
    ``tp`` ranks when ``tp > 1`` (pipeline x TP).  MoE aux losses are not
    threaded through the pipeline, as in the reference."""
    bp = _uniform_boundary(policy)
    s_stages = policy.num_stages
    needs_state = bp.needs_fw_buffer or bp.needs_bw_buffer
    stage_fn, tp_kwargs, tpc = _tp_stage_fn(
        cfg, tp, tp_codec, tp_k_frac,
        as_schedule(schedule, virtual_stages).remat_ticks)

    def step(params, opt_state, bstates, batch, ids):
        if tpc is not None:
            tpc.reset_wire()

        def run_row(r, stack, x):
            return pipeline_apply(
                stage_fn, stack, x, num_stages=s_stages, policy=bp,
                microbatches=microbatches, schedule=schedule,
                virtual_stages=virtual_stages,
                fw_state=bstates["fw"] if needs_state else None,
                bw_state=bstates["bw"] if needs_state else None, ids=ids,
                **tp_kwargs(stack))

        params, loss, grads, [(new_fw, slot)] = _pipeline_lm_grads(
            cfg, params, batch, s_stages * virtual_stages, 1, run_row)
        grads["layers"] = _unstack(tree_map(lambda a: a[0],
                                            grads["layers"]))
        params, opt_state = apply_updates(opt, params, grads, opt_state)
        wire = dict(slot.wire)
        if tpc is not None:
            wire.update(tpc.wire)
        metrics = {"loss": loss.detach(), "aux": torch.zeros(()),
                   "total": loss.detach(), "wire": wire}
        new_states = ({"fw": new_fw, "bw": slot.state} if needs_state
                      else bstates)
        return params, opt_state, new_states, metrics

    return step


def _replica_row(state: Optional[FeedbackState], r: int):
    """Replica row ``r`` of a ``(dp, S, ...)`` pipeline feedback state:
    views, so the row's pipeline writes its buffers in place."""
    if state is None:
        return None
    return state.replace(resid=state.resid[r], mirror=state.mirror[r])


def _make_dp_pipeline_lm_train_step(cfg, bp: BoundaryPolicy,
                                    opt: OptimizerConfig, *,
                                    microbatches: Optional[int],
                                    schedule: str, virtual_stages: int,
                                    dp: int, dp_codec: str, dp_feedback: str,
                                    dp_k_frac: float, s_stages: int,
                                    tp: int = 1, tp_codec: str = "none",
                                    tp_k_frac: float = 0.1):
    """LM training on the ``(data, stage)`` grid: ``step(params,
    opt_state, bstates, batch, ids, dp_state) -> (params, opt_state,
    bstates, dp_state, metrics)``.

    :func:`_pipeline_lm_grads` with ``dp`` replica rows: row ``r``
    pipelines its contiguous batch shard (``microbatches`` microbatches
    of it) through its own leaves of the stage-stacked layer stack.  The
    rows' ``(dp, S*v, ...)`` stack gradients cross the compressed
    all-reduce sharded into ``S`` stage columns, with ``average=False``:
    the global mean loss already gives each row its ``1/dp`` share.  The
    reduced stack folds back into ``params["layers"]``; the other
    gradients are exact and skip the reduce.

    With a feedback policy ``bstates`` is ``init_feedback_state(...,
    dp=dp)``: row ``r`` reads and writes row ``r`` of every buffer in
    place (AQ-SGD with its ids localized by ``shard_ids``), and the step
    returns the same dict.  ``metrics["wire"]``: every row's hops and
    bytes per direction, and the ring's ``dp_hops`` / ``dp_bytes`` over
    the ``S`` columns.

    ``tp > 1`` (the 3D step): every stage of every row runs over its own
    ring of ``tp`` ranks, and the reduce splits by tensor coordinate too
    (``S * tp`` columns); ``metrics["wire"]`` adds ``tp_hops`` /
    ``tp_bytes`` over every ring."""
    needs_state = bp.needs_fw_buffer or bp.needs_bw_buffer
    per_example = needs_state and get_mode(bp.feedback).per_example
    stage_fn, tp_kwargs, tpc = _tp_stage_fn(
        cfg, tp, tp_codec, tp_k_frac,
        as_schedule(schedule, virtual_stages).remat_ticks)
    reduce_fn = _stack_reducer(dp, dp_codec, dp_k_frac, dp_feedback,
                               s_stages, tp)

    def step(params, opt_state, bstates, batch, ids, dp_state):
        if tpc is not None:
            tpc.reset_wire()
        b = ids.shape[0]
        if b % dp:
            raise ValueError(f"batch {b} is not divisible by dp {dp}")
        ids_sh = ids.reshape(dp, b // dp)
        fw = bstates["fw"] if needs_state else None
        bw = bstates["bw"] if needs_state else None

        def run_row(r, stack, x):
            ids_r = ids_sh[r]
            if per_example:
                ns_shard = fw.resid.shape[2 if virtual_stages == 1 else 3]
                ids_r = shard_ids(ids_r, r, ns_shard * dp, dp)
            y, _, slot = pipeline_apply(
                stage_fn, stack, x, num_stages=s_stages, policy=bp,
                microbatches=microbatches, schedule=schedule,
                virtual_stages=virtual_stages, fw_state=_replica_row(fw, r),
                bw_state=_replica_row(bw, r), ids=ids_r, dp=dp,
                **tp_kwargs(stack))
            return y, slot

        params, loss, grads, slots = _pipeline_lm_grads(
            cfg, params, batch, s_stages * virtual_stages, dp, run_row)
        # the rows' gradients live on only until the reduce
        g_stack, dp_state, ring = reduce_fn(grads["layers"], dp_state)
        grads["layers"] = _unstack(g_stack)
        params, opt_state = apply_updates(opt, params, grads, opt_state)
        wire = {k: sum(sl.wire[k] for (sl,) in slots)
                for k in slots[0][0].wire}
        wire.update(ring)
        if tpc is not None:
            wire.update(tpc.wire)
        metrics = {"loss": loss.detach(), "aux": torch.zeros(()),
                   "total": loss.detach(), "wire": wire}
        return params, opt_state, bstates, dp_state, metrics

    return step


def _stack_reducer(dp: int, codec: str, k_frac: float, feedback: str,
                   s_stages: Optional[int], tp: int):
    """``reduce(g_stack_dp, dp_state) -> (reduced, dp_state, ring
    counts)``: the replica rows' layer-stack gradients ``(dp, ...)``
    through the compressed all-reduce without averaging (the global mean
    loss already gives each row its ``1/dp``), split into ``s_stages``
    stage columns and, when ``tp > 1``, ``tp`` tensor coordinates.  The
    all-reduce is built once, at the first call, from the stack's
    ``tp_param_dims`` (leaf names and ranks, the same every step)."""
    built = []

    def reduce(g_stack_dp, dp_state):
        if not built:
            tp_kw = ({} if tp == 1 else
                     {"tp_axis": tp,
                      "tp_dims": transformer.tp_param_dims(g_stack_dp)})
            built.append(make_grad_all_reduce(
                dp, codec, k_frac=k_frac, feedback=feedback, average=False,
                shard_axis=s_stages, **tp_kw))
        return built[0](g_stack_dp, dp_state)

    return reduce


def _make_tp_lm_train_step(cfg, policy: CompressionPolicy,
                           opt: OptimizerConfig, *, dp: int, tp: int,
                           dp_codec: str, dp_feedback: str,
                           dp_k_frac: float, tp_codec: str,
                           tp_feedback: str, tp_k_frac: float):
    """LM training with the dense layer stack sharded over a tensor ring
    of ``tp`` ranks (``transport/tp_collectives.py``), alone or on ``dp``
    data lanes (DP x TP).

    :func:`_pipeline_lm_grads` with one stack slice and ``dp`` rows: the
    embedding and the chunked loss run on the whole batch with exact
    gradients; row ``r`` runs :func:`tp_apply` on its contiguous batch
    shard and its own copy of the stack, with its rows of ``tp_state``.
    With ``dp > 1`` the rows' stack gradients cross the compressed reduce
    split by tensor coordinate (``tp_param_dims``), without averaging.
    ``step(params, opt_state, bstates, batch, ids[, dp_state], tp_state)
    -> (params, opt_state, bstates[, dp_state], tp_state, metrics)``; the
    new ``tp_state`` is made of new tensors."""
    if cfg.enc_dec:
        raise NotImplementedError("tensor parallelism: decoder-only archs")
    if policy.num_boundaries:
        raise NotImplementedError(
            "simulated boundary cuts + tensor parallelism: run the stage "
            "wire through the pipeline transport (3D mesh) instead")
    tpc = TPCollectives(tp, codec=tp_codec, k_frac=tp_k_frac,
                        feedback=tp_feedback)
    stage_fn = transformer.tp_stage_stack_fn(cfg, tpc)
    sites = transformer.tp_sites(cfg)
    reduce_fn = (_stack_reducer(dp, dp_codec, dp_k_frac, dp_feedback, None,
                                tp) if dp > 1 else None)

    def step(params, opt_state, bstates, batch, ids, *states):
        dp_state, tp_state = states if dp > 1 else (None, states[0])
        b = ids.shape[0]
        if b % dp:
            raise ValueError(f"batch {b} is not divisible by dp {dp}")
        sh = b // dp
        tpc.reset_wire()
        dims = transformer.tp_param_dims(params["layers"])

        def lane(state, r):
            """Row ``r``'s batch rows of a (sites, B, ...) buffer."""
            return state if state.numel() == 0 else state[:, r * sh:
                                                         (r + 1) * sh]

        def run_row(r, stack, x):
            st = tp_state.replace(resid=lane(tp_state.resid, r),
                                  mirror=lane(tp_state.mirror, r))
            return tp_apply(stage_fn, _unstack(stack), x, tpc,
                            param_dims=dims, state=st, sites=sites, rows=dp)

        params, loss, grads, outs = _pipeline_lm_grads(
            cfg, params, batch, 1, dp, run_row)

        def merge(slot):
            parts = [getattr(st, slot) for (st,) in outs]
            return (parts[0] if parts[0].numel() == 0
                    else torch.cat(parts, dim=1))

        new_tp = tp_state.replace(resid=merge("resid"),
                                  mirror=merge("mirror"))
        wire = dict(tpc.wire)
        # (dp, 1, groups, ...) -> the rows' raw layer stacks
        g_stack = tree_map(lambda a: a[:, 0], grads["layers"])
        if dp > 1:
            g_stack, dp_state, ring = reduce_fn(g_stack, dp_state)
            wire.update(ring)
        else:
            g_stack = tree_map(lambda a: a[0], g_stack)
        grads["layers"] = g_stack
        params, opt_state = apply_updates(opt, params, grads, opt_state)
        metrics = {"loss": loss.detach(), "aux": torch.zeros(()),
                   "total": loss.detach(), "wire": wire}
        if dp > 1:
            return params, opt_state, bstates, dp_state, new_tp, metrics
        return params, opt_state, bstates, new_tp, metrics

    return step


def make_lm_eval_step(cfg, policy: CompressionPolicy, compress: bool):
    """Returns ``step(params, batch) -> loss``: the LM loss with the cuts
    compressed by the plain fw compressor (``compress``) or not."""
    mod = encdec if cfg.enc_dec else transformer

    @torch.no_grad()
    def step(params, batch):
        logits = mod.forward_eval(params, batch, cfg, policy,
                                  compress=compress)
        labels, mask = _labels_and_mask(batch["tokens"])
        return transformer.lm_loss(logits, labels, mask)

    return step


# ---------------------------------------------------------------------------
# Image-classification steps (the paper's ResNet18 / CIFAR-10 experiments)
# ---------------------------------------------------------------------------

def xent_loss(logits, labels):
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    return -logp.gather(1, labels.to(torch.int64)[:, None]).mean()


def _accuracy(logits, labels):
    return (logits.detach().argmax(-1) == labels).to(torch.float32).mean()


@_keyed
def make_cnn_train_step(policy: CompressionPolicy, opt: OptimizerConfig,
                        transport: str = "simulated",
                        pipeline_microbatches: Optional[int] = None,
                        schedule: str = "gpipe", virtual_stages: int = 1,
                        boundary_feat=None):
    """Returns ``step(params, opt_state, bstates, images, labels, ids) ->
    (params, opt_state, bstates, metrics)`` with ``metrics`` ``loss`` and
    ``acc``.  ``images``: (B, H, W, 3) NHWC float32; ``bstates``: one
    ``{"fw", "bw"}`` dict per cut (``[]`` without feedback).  A
    ``PolicyRules`` policy resolves against ``boundary_feat`` (one element
    count per cut: the CNN's cuts differ).

    ``transport="pipeline"`` trains the homogeneous-stage CNN
    (``models/cnn.py::init_pipeline_params``, ``num_stages *
    virtual_stages`` stacked slices) through the real compressed pipeline
    under ``schedule``; ``bstates`` is then ``[]`` or the
    ``init_feedback_state`` dict, and ``metrics["wire"]`` holds the
    step's hops and bytes per direction."""
    policy = _resolve_rules(policy, boundary_feat)
    if transport == "pipeline":
        return _make_pipeline_cnn_train_step(
            policy, opt, microbatches=pipeline_microbatches,
            schedule=schedule, virtual_stages=virtual_stages)
    if transport != "simulated":
        raise ValueError(f"unknown transport {transport!r}")

    def step(params, opt_state, bstates, images, labels, ids):
        params = tree_map(lambda p: p.detach().requires_grad_(True), params)
        logits, new_fw, slots = cnn.forward_train(params, images, policy,
                                                  bstates or None, ids)
        loss = xent_loss(logits, labels)
        loss.backward()
        grads = tree_map(lambda p: p.grad, params)
        params, opt_state = apply_updates(opt, params, grads, opt_state)
        new_states = [{"fw": f, "bw": slot.state}
                      for f, slot, _ in zip(new_fw, slots, bstates)]
        return params, opt_state, new_states, {
            "loss": loss.detach(), "acc": _accuracy(logits, labels)}

    return step


def _make_pipeline_cnn_train_step(policy: CompressionPolicy,
                                  opt: OptimizerConfig, *,
                                  microbatches: Optional[int] = None,
                                  schedule: str = "gpipe",
                                  virtual_stages: int = 1):
    """CNN training through the real compressed pipeline: stem and head
    on the whole batch, the residual stages as ``policy.num_stages *
    virtual_stages`` logical stage slices with packed payloads at every
    cut.  With a feedback policy the buffers of ``bstates`` are updated
    in place and come back with the new bw state."""
    bp = _uniform_boundary(policy)
    needs_state = bp.needs_fw_buffer or bp.needs_bw_buffer

    def step(params, opt_state, bstates, images, labels, ids):
        params = tree_map(lambda p: p.detach().requires_grad_(True), params)
        x = cnn.pipeline_stem(params, images)
        x, new_fw, slot = pipeline_apply(
            cnn.pipeline_stage_apply, params["stages"], x,
            num_stages=policy.num_stages, policy=bp,
            microbatches=microbatches, schedule=schedule,
            virtual_stages=virtual_stages,
            fw_state=bstates["fw"] if needs_state else None,
            bw_state=bstates["bw"] if needs_state else None, ids=ids)
        logits = cnn.pipeline_head(params, x)
        loss = xent_loss(logits, labels)
        loss.backward()
        grads = tree_map(lambda p: p.grad, params)
        params, opt_state = apply_updates(opt, params, grads, opt_state)
        new_states = ({"fw": new_fw, "bw": slot.state} if needs_state
                      else bstates)
        return params, opt_state, new_states, {
            "loss": loss.detach(), "acc": _accuracy(logits, labels),
            "wire": dict(slot.wire)}

    return step


def make_cnn_eval_step(policy: CompressionPolicy, compress: bool,
                       transport: str = "simulated"):
    """Returns ``step(params, images, labels) -> (accuracy, loss)`` with
    the cuts compressed by the plain fw compressor (``compress``) or
    not."""
    fwd = (cnn.pipeline_forward_eval if transport == "pipeline"
           else cnn.forward_eval)

    @torch.no_grad()
    def step(params, images, labels):
        logits = fwd(params, images, policy, compress=compress)
        return _accuracy(logits, labels), xent_loss(logits, labels)

    return step
