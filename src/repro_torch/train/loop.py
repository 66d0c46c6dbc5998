"""The paper's experiment loops: ResNet / CIFAR-10 (Sec. 3.1) and LM
fine-tuning (Sec. 3.2).

Port of ``run_cnn_experiment``, ``_cnn_eval``, ``_cnn_bstates``,
``run_lm_experiment``, ``_lm_eval``, ``pretrain_lm``,
``_pipeline_bstates`` and ``init_lm_dp_state`` from
``repro/train/loop.py`` on the simulated transport or the real pipeline,
the LM on either with or without the compressed data-parallel gradient
reduce, and with a tensor axis: train with boundary compression, then
evaluate with compression on AND off (finding F3: a model trained
compressed must be served compressed).  A rule policy (``PolicyRules``)
and rule-spec axis codecs resolve against the run's cut and gradient
sizes, and ``run_lm_experiment``'s ``ExperimentResult.policy_curve``
holds the resolved name per epoch.  Given a ``bandwidth_probe``,
``run_lm_experiment`` re-resolves them before every epoch against the
measured bytes/s (``obs/probes.py``) and rebuilds the step on a flip.
Every train step runs inside a ``train.step`` trace span that holds its
synced loss (LM) or accuracy (CNN).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.boundary import init_boundary_state
from repro_torch.core.parallel import ParallelSpec, from_legacy, warn_legacy
from repro_torch.core.policy import (NO_POLICY, BoundaryPolicy,
                                     CompressionPolicy, PolicyRules,
                                     resolve_policy)
from repro_torch.data.synthetic import ImageClassData, LMData
from repro_torch.device import resolve_device
from repro_torch.models import cnn, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.obs import trace
from repro_torch.obs.probes import boundary_bandwidth
from repro_torch.optim.optimizers import (OptimizerConfig, init_opt_state,
                                          tree_leaves, tree_map)
from repro_torch.train.steps import (_LEGACY_DEFAULTS, _UNSET,
                                     _resolve_parallel,
                                     make_cnn_eval_step, make_cnn_train_step,
                                     make_lm_eval_step, make_lm_train_step)
from repro_torch.transport.collectives import init_dp_state
from repro_torch.transport.pipeline import init_feedback_state
from repro_torch.transport.tp_collectives import init_tp_state


@dataclasses.dataclass
class ExperimentResult:
    name: str
    acc_off: float = 0.0           # eval accuracy (%) with compression OFF
    acc_on: float = 0.0            # eval accuracy (%) with compression ON
    loss_on: float = 0.0           # eval loss with compression ON
    loss_off: float = 0.0          # eval loss with compression OFF
    train_curve: List[float] = dataclasses.field(default_factory=list)
    seconds: float = 0.0
    # the LM run's resolved policy name per epoch (it moves only when a
    # bandwidth probe flips it); the CNN run leaves it empty, as the
    # reference does
    policy_curve: List[str] = dataclasses.field(default_factory=list)
    params: Optional[dict] = None

    def row(self) -> str:
        return (f"{self.name:32s}  off={self.acc_off:6.2f}%  "
                f"on={self.acc_on:6.2f}%")


def cnn_sgd(epochs: int, num_train: int, batch: int) -> OptimizerConfig:
    """``run_cnn_experiment``'s default optimizer, the reference's: SGD
    with momentum, cosine over the run's ``epochs * (num_train // batch)``
    steps."""
    return OptimizerConfig(kind="sgd", lr=0.02, momentum=0.9,
                           weight_decay=5e-4, schedule="cosine",
                           t_max=epochs * (num_train // batch))


def _cnn_eval(params, data, policy, compress, batch=100,
              transport="simulated", *, device) -> tuple:
    step = make_cnn_eval_step(policy, compress, transport=transport)
    accs, losses = [], []
    for x, y, _ in data.test_batches(batch):
        a, l = step(params, torch.from_numpy(x).to(device),
                    torch.from_numpy(y).to(device))
        accs.append(float(a))
        losses.append(float(l))
    return 100.0 * float(np.mean(accs)), float(np.mean(losses))


def _cnn_bstates(policy: CompressionPolicy, data: ImageClassData,
                 batch: int, width: int, device=None):
    shapes = cnn.boundary_shapes(width, data.image)
    return [init_boundary_state(policy.at(i), shapes[i], batch=batch,
                                num_samples=data.num_train, device=device)
            for i in range(policy.num_boundaries)]


def run_cnn_experiment(policy: CompressionPolicy, *, epochs: int = 8,
                       batch: int = 100, width: int = 16,
                       data: Optional[ImageClassData] = None,
                       warmup_params=None, name: str = "",
                       opt: Optional[OptimizerConfig] = None,
                       seed: int = 0, transport: str = "simulated",
                       pipeline_microbatches: Optional[int] = None,
                       schedule: str = "gpipe", virtual_stages: int = 1,
                       device=None) -> ExperimentResult:
    """Train the ResNet with boundary compression, then evaluate its test
    accuracy with compression on and off (the paper's protocol).

    ``warmup_params``: start from these (uncompressed-baseline) weights,
    a params tree (the paper's "warmup N" rows; simulated transport
    only).  ``transport="pipeline"`` trains the homogeneous-stage CNN
    through the real compressed pipeline under ``schedule`` (gpipe | 1f1b
    | interleaved, the latter with ``num_stages * virtual_stages`` stage
    slices), the same boundary policy at every cut.  A ``PolicyRules``
    policy resolves per cut against the real element counts: the three
    ResNet cuts differ (``cnn.boundary_shapes``), the pipeline's stages
    are homogeneous (``image² · width``).  Fresh params come from a
    generator seeded with ``seed``.  Runs on ``cuda`` unless ``device``
    says otherwise."""
    if transport not in ("simulated", "pipeline"):
        raise ValueError(f"unknown transport {transport!r}")
    dev = resolve_device(device)
    data = data or ImageClassData()
    if isinstance(policy, PolicyRules):
        sizes = (data.image * data.image * width
                 if transport == "pipeline" else
                 [int(np.prod(s)) for s in
                  cnn.boundary_shapes(width, data.image)])
        policy = resolve_policy(policy, sizes)
    opt = opt or cnn_sgd(epochs, data.num_train, batch)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if transport == "pipeline":
        if warmup_params is not None:
            raise ValueError("warmup_params: the homogeneous pipeline CNN "
                             "has a different param structure")
        params = cnn.init_pipeline_params(
            gen, policy.num_stages * virtual_stages, width=width)
        bstates = _pipeline_bstates(policy, (data.image, data.image, width),
                                    batch=batch,
                                    microbatches=pipeline_microbatches,
                                    num_samples=data.num_train,
                                    virtual_stages=virtual_stages,
                                    device=dev)
    else:
        params = (tree_map(lambda t: t.to(dev), warmup_params)
                  if warmup_params is not None
                  else cnn.init_params(gen, width=width))
        bstates = _cnn_bstates(policy, data, batch, width, dev)
    opt_state = init_opt_state(opt, params)
    step = make_cnn_train_step(policy, opt, transport=transport,
                               pipeline_microbatches=pipeline_microbatches,
                               schedule=schedule,
                               virtual_stages=virtual_stages)
    t0 = time.time()
    curve = []
    for ep in range(epochs):
        accs = []
        for x, y, ids in data.epoch(batch, ep):
            with trace.span("train.step", cat="train", epoch=ep) as sa:
                params, opt_state, bstates, m = step(
                    params, opt_state, bstates, torch.from_numpy(x).to(dev),
                    torch.from_numpy(y).to(dev),
                    torch.from_numpy(ids).to(dev))
                acc = float(m["acc"])            # sync inside the span
                sa["acc"] = round(acc, 6)
            accs.append(acc)
        curve.append(float(np.mean(accs)))
    res = ExperimentResult(name=name or policy.boundary.name,
                           train_curve=curve, seconds=time.time() - t0)
    res.acc_off, res.loss_off = _cnn_eval(params, data, policy, False, batch,
                                          transport, device=dev)
    res.acc_on, res.loss_on = _cnn_eval(params, data, policy, True, batch,
                                        transport, device=dev)
    res.params = params
    return res


def _lm_eval(params, cfg, data, policy, compress, batch=16,
             device=None) -> float:
    step = make_lm_eval_step(cfg, policy, compress)
    losses = [float(step(params, {"tokens": torch.from_numpy(toks)
                                  .to(device, torch.int64)}))
              for toks, _ in data.test_batches(batch)]
    return float(np.mean(losses))


def _pipeline_bstates(policy: CompressionPolicy, feat_shape, *, batch: int,
                      microbatches=None, num_samples: int = 0,
                      dtype=torch.float32, virtual_stages: int = 1,
                      dp: int = 1, device=None, stage=None):
    """Feedback state for the pipeline transport: the stage-stacked
    ``init_feedback_state`` dict (with a replica dim first when ``dp >
    1``; rank ``stage``'s rows only, for the rank-per-stage pipeline), or
    ``[]`` for feedback-free policies."""
    bp = policy.at(0) if policy.num_boundaries else BoundaryPolicy()
    if not (bp.needs_fw_buffer or bp.needs_bw_buffer):
        return []
    return init_feedback_state(bp, feat_shape, num_stages=policy.num_stages,
                               batch=batch, microbatches=microbatches,
                               num_samples=num_samples, dtype=dtype,
                               virtual_stages=virtual_stages, dp=dp,
                               device=device, stage=stage)


def init_lm_dp_state(cfg, params, policy: CompressionPolicy, dp: int,
                     dp_feedback: str = "none", *,
                     transport: str = "simulated", virtual_stages: int = 1,
                     tp: int = 1):
    """DP-reduce state for an LM train step: the residual / aggregate
    trees mirror what crosses the data axis, on ``params``' device: the
    FULL param tree on the simulated transport (every lane differentiates
    everything), the stage-stacked layer stack (``policy.num_stages *
    virtual_stages`` slices) on the pipeline, and the raw layer stack on
    the DP x TP step (``tp > 1``); in both sharded cases the embedding and
    head gradients stay exact."""
    if transport == "pipeline":
        like = transformer.stack_layer_stages(
            params, policy.num_stages * virtual_stages)
        return init_dp_state(like, dp, dp_feedback)
    if transport != "simulated":
        raise ValueError(f"unknown transport {transport!r}")
    return init_dp_state(params["layers"] if tp > 1 else params, dp,
                         dp_feedback)


def run_lm_experiment(cfg: ModelConfig, policy: CompressionPolicy, *,
                      pretrained_params=None, epochs: int = 2,
                      batch: int = 16, data: Optional[LMData] = None,
                      name: str = "", opt: Optional[OptimizerConfig] = None,
                      seed: int = 0, transport: str = "simulated",
                      pipeline_microbatches: Optional[int] = None,
                      schedule: str = "gpipe", virtual_stages: int = 1,
                      dp=_UNSET, dp_codec=_UNSET, dp_feedback=_UNSET,
                      dp_k_frac=_UNSET,
                      parallel: Optional[ParallelSpec] = None,
                      bandwidth_probe=None,
                      device=None) -> ExperimentResult:
    """Fine-tune a (pre-trained) LM with boundary compression and report
    the train curve and the eval loss with compression on and off.

    ``transport="pipeline"`` runs the layer stack as the real compressed
    pipeline under ``schedule`` (gpipe | 1f1b | interleaved).
    ``parallel=`` (a :class:`~repro_torch.core.parallel.ParallelSpec`)
    sizes and wires the data axis (the compressed gradient all-reduce),
    the stage axis and the tensor axis (the compressed TP collectives; the
    step threads a ``tp_state`` on the simulated transport, and
    ``policy_curve`` then names ``policy/spec``); the
    ``dp``/``dp_codec``/``dp_feedback``/``dp_k_frac``
    kwargs are its deprecated alias family (warns
    ``ParallelDeprecationWarning``; passing both is an error).
    ``policy`` may be a ``PolicyRules`` rule set, resolved against the
    LM's uniform cut ``seq_len * d_model``; axis codecs may be rule specs,
    resolved against the wire sizes (``data``: the gradient's element
    count; ``stage``: the cut; ``tensor``: the cut's ``1/tp`` sequence
    shard).

    ``bandwidth_probe``: a zero-arg callable returning a bandwidth
    measurement (an ``obs.probes.probe_mesh`` dict, a
    ``LinkMeasurement``, a plain bytes/s float, or None).  When ``policy``
    is a ``PolicyRules`` (or the spec has rule-coded axes) the probe runs
    before every epoch and the rules re-resolve against its reading.  A
    changed resolution (a flip) emits a ``policy.flip`` trace instant,
    rebuilds the step and rebuilds the boundary states from the new
    effective policy; an unchanged one keeps the step.  Without a probe
    a ``bandwidth>=X`` rule never fires and the resolution is the static
    one, made once; ``policy_curve`` then repeats its name each epoch.
    ``pretrained_params``: a params tree on ``device`` (default: fresh
    params from a generator seeded with ``seed``).  Every step runs in a
    ``train.step`` trace span holding its synced loss.  Runs on ``cuda``
    unless ``device`` says otherwise."""
    if transport not in ("simulated", "pipeline"):
        raise ValueError(f"unknown transport {transport!r}")
    dev = resolve_device(device)
    data = data or LMData()
    rules = policy if isinstance(policy, PolicyRules) else None
    bsize = data.seq_len * cfg.d_model
    legacy = {"dp": dp, "dp_codec": dp_codec, "dp_feedback": dp_feedback,
              "dp_k_frac": dp_k_frac}
    explicit = tuple(sorted(k for k, v in legacy.items() if v is not _UNSET))
    spec0 = parallel
    spec_has_rules = spec0 is not None and any(
        spec0.axis(n).is_rules for n in ("data", "stage", "tensor"))
    probe_bw = bandwidth_probe is not None and (rules is not None
                                                or spec_has_rules)
    bw = boundary_bandwidth(bandwidth_probe()) if probe_bw else None
    policy = resolve_policy(policy, bsize, bandwidth=bw)
    if spec0 is None:
        # fold the deprecated family into the equivalent spec HERE, so the
        # warning names this call site and make_lm_train_step never re-warns
        if explicit:
            warn_legacy("run_lm_experiment", explicit)
        vals = {k: (legacy[k] if legacy[k] is not _UNSET else d)
                for k, d in _LEGACY_DEFAULTS.items()}
        spec0 = from_legacy(
            num_stages=(policy.num_stages if transport == "pipeline" else 1),
            **vals)
    elif explicit:
        raise ValueError(
            f"run_lm_experiment: both parallel= and the legacy kwarg(s) "
            f"{list(explicit)} were passed — drop the legacy kwargs")
    opt = opt or OptimizerConfig(kind="adamw", lr=3e-4, weight_decay=0.01,
                                 schedule="constant", grad_clip=1.0)
    params = pretrained_params or transformer.init_params(
        torch.Generator(device=dev).manual_seed(seed), cfg)
    opt_state = init_opt_state(opt, params)
    # the data wire carries the gradient tree, the stage wire the cut, the
    # tensor wire the cut's 1/tp sequence shard
    n_grad = sum(p.numel() for p in tree_leaves(params))
    wire_sizes = {"data": n_grad, "stage": bsize,
                  "tensor": bsize // max(spec0.tp, 1)}
    spec = spec0.resolved(wire_sizes, bandwidth=bw)
    spec_eff, policy_eff, transport_eff = _resolve_parallel(
        "run_lm_experiment", spec, policy, transport, {})
    feat = (data.seq_len, cfg.d_model)

    def build_bstates(policy_eff):
        if transport_eff == "pipeline":
            return _pipeline_bstates(policy_eff, feat, batch=batch,
                                     microbatches=pipeline_microbatches,
                                     num_samples=data.num_train,
                                     dtype=torch.bfloat16,
                                     virtual_stages=virtual_stages,
                                     dp=spec_eff.dp, device=dev)
        return [init_boundary_state(policy_eff.at(i), feat, batch=batch,
                                    num_samples=data.num_train,
                                    dtype=torch.bfloat16, device=dev)
                for i in range(policy_eff.num_boundaries)]

    def build_step(policy, spec_eff):
        return make_lm_train_step(
            cfg, policy, opt, remat=False, transport=transport_eff,
            pipeline_microbatches=pipeline_microbatches, schedule=schedule,
            virtual_stages=virtual_stages, parallel=spec_eff)

    bstates = build_bstates(policy_eff)
    step = build_step(policy, spec_eff)
    dp_state = (init_lm_dp_state(cfg, params, policy_eff, spec_eff.dp,
                                 spec_eff.data.feedback,
                                 transport=transport_eff,
                                 virtual_stages=virtual_stages,
                                 tp=spec_eff.tp)
                if spec_eff.dp > 1 else None)
    tp_state = (init_tp_state((batch, data.seq_len, cfg.d_model),
                              transformer.tp_sites(cfg),
                              spec_eff.tensor.feedback, device=dev)
                if spec_eff.tp > 1 and transport_eff == "simulated" else None)
    t0 = time.time()
    curve, policy_curve = [], []
    for ep in range(epochs):
        if probe_bw and ep > 0:
            # the probe's reading re-resolves the rules; the step and the
            # boundary states are rebuilt only on a flip (rule policies
            # and rule axis codecs keep their shapes, so the DP and TP
            # states carry over)
            bw = boundary_bandwidth(bandwidth_probe())
            flipped = False
            if rules is not None:
                new_policy = resolve_policy(rules, bsize, bandwidth=bw)
                if new_policy.name != policy.name:
                    trace.instant("policy.flip", cat="policy", epoch=ep,
                                  bandwidth=bw, old=policy.name,
                                  new=new_policy.name)
                    policy, flipped = new_policy, True
            if spec_has_rules:
                new_spec = spec0.resolved(wire_sizes, bandwidth=bw)
                if new_spec.name != spec.name:
                    trace.instant("policy.flip", cat="policy", epoch=ep,
                                  bandwidth=bw, old=spec.name,
                                  new=new_spec.name)
                    spec, flipped = new_spec, True
            if flipped:
                spec_eff, policy_eff, transport_eff = _resolve_parallel(
                    "run_lm_experiment", spec, policy, transport, {})
                bstates = build_bstates(policy_eff)
                step = build_step(policy, spec_eff)
        policy_curve.append(policy_eff.name if spec_eff.tp == 1
                            else f"{policy_eff.name}/{spec_eff.name}")
        for toks, ids in data.epoch(batch, ep):
            with trace.span("train.step", cat="train", epoch=ep) as sa:
                args = [params, opt_state, bstates,
                        {"tokens": torch.from_numpy(toks).to(dev,
                                                             torch.int64)},
                        torch.from_numpy(ids).to(dev)]
                args += [s for s in (dp_state, tp_state) if s is not None]
                out = step(*args)
                params, opt_state, bstates, m = (out[0], out[1], out[2],
                                                 out[-1])
                rest = list(out[3:-1])
                if dp_state is not None:
                    dp_state = rest.pop(0)
                if tp_state is not None:
                    tp_state = rest.pop(0)
                loss = float(m["loss"])          # sync inside the span
                sa["loss"] = round(loss, 6)
            curve.append(loss)
    res = ExperimentResult(name=name or policy_eff.boundary.name,
                           train_curve=curve, seconds=time.time() - t0,
                           policy_curve=policy_curve)
    res.loss_on = _lm_eval(params, cfg, data, policy_eff, True, batch, dev)
    res.loss_off = _lm_eval(params, cfg, data, policy_eff, False, batch,
                            dev)
    res.params = params
    return res


def pretrain_lm(cfg: ModelConfig, *, steps: int = 300, batch: int = 16,
                data: Optional[LMData] = None, seed: int = 0, device=None):
    """Uncompressed pre-training for the fine-tuning experiments.
    Returns ``(params, last loss)``.  Runs on ``cuda`` unless ``device``
    says otherwise."""
    dev = resolve_device(device)
    data = data or LMData()
    opt = OptimizerConfig(kind="adamw", lr=1e-3, weight_decay=0.01,
                          schedule="constant", grad_clip=1.0)
    params = transformer.init_params(
        torch.Generator(device=dev).manual_seed(seed), cfg)
    opt_state = init_opt_state(opt, params)
    step = make_lm_train_step(cfg, NO_POLICY, opt, remat=False)
    n = ep = 0
    while n < steps:
        for toks, ids in data.epoch(batch, ep):
            params, opt_state, _, m = step(
                params, opt_state, [],
                {"tokens": torch.from_numpy(toks).to(dev, torch.int64)},
                torch.from_numpy(ids).to(dev))
            n += 1
            if n >= steps:
                break
        ep += 1
    return params, float(m["loss"])
