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
and rule-spec axis codecs resolve once, statically, against the run's
cut and gradient sizes, and ``run_lm_experiment``'s
``ExperimentResult.policy_curve`` holds the resolved name per epoch.
Bandwidth probes (which would re-resolve between epochs) and trace spans
are not ported yet.
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
    # the LM run's resolved policy name per epoch (flat: no probe
    # re-resolves it); the CNN run leaves it empty, as the reference does
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
            params, opt_state, bstates, m = step(
                params, opt_state, bstates, torch.from_numpy(x).to(dev),
                torch.from_numpy(y).to(dev), torch.from_numpy(ids).to(dev))
            accs.append(float(m["acc"]))
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
                      dp: int = 1, device=None):
    """Feedback state for the pipeline transport: the stage-stacked
    ``init_feedback_state`` dict (with a replica dim first when ``dp >
    1``), or ``[]`` for feedback-free policies."""
    bp = policy.at(0) if policy.num_boundaries else BoundaryPolicy()
    if not (bp.needs_fw_buffer or bp.needs_bw_buffer):
        return []
    return init_feedback_state(bp, feat_shape, num_stages=policy.num_stages,
                               batch=batch, microbatches=microbatches,
                               num_samples=num_samples, dtype=dtype,
                               virtual_stages=virtual_stages, dp=dp,
                               device=device)


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
    shard).  Without a bandwidth probe (not ported)
    the resolution is the static one, made once; ``policy_curve`` repeats
    its name each epoch.
    ``pretrained_params``: a params tree on ``device`` (default: fresh
    params from a generator seeded with ``seed``).  Runs on ``cuda``
    unless ``device`` says otherwise."""
    if transport not in ("simulated", "pipeline"):
        raise ValueError(f"unknown transport {transport!r}")
    dev = resolve_device(device)
    data = data or LMData()
    bsize = data.seq_len * cfg.d_model
    policy = resolve_policy(policy, bsize)
    legacy = {"dp": dp, "dp_codec": dp_codec, "dp_feedback": dp_feedback,
              "dp_k_frac": dp_k_frac}
    explicit = tuple(sorted(k for k, v in legacy.items() if v is not _UNSET))
    spec = parallel
    if spec is None:
        # fold the deprecated family into the equivalent spec HERE, so the
        # warning names this call site and make_lm_train_step never re-warns
        if explicit:
            warn_legacy("run_lm_experiment", explicit)
        vals = {k: (legacy[k] if legacy[k] is not _UNSET else d)
                for k, d in _LEGACY_DEFAULTS.items()}
        spec = from_legacy(
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
    spec = spec.resolved({"data": n_grad, "stage": bsize,
                          "tensor": bsize // max(spec.tp, 1)})
    spec, policy_eff, transport = _resolve_parallel(
        "run_lm_experiment", spec, policy, transport, {})
    feat = (data.seq_len, cfg.d_model)
    if transport == "pipeline":
        bstates = _pipeline_bstates(policy_eff, feat, batch=batch,
                                    microbatches=pipeline_microbatches,
                                    num_samples=data.num_train,
                                    dtype=torch.bfloat16,
                                    virtual_stages=virtual_stages,
                                    dp=spec.dp, device=dev)
    else:
        bstates = [init_boundary_state(policy_eff.at(i), feat, batch=batch,
                                       num_samples=data.num_train,
                                       dtype=torch.bfloat16, device=dev)
                   for i in range(policy_eff.num_boundaries)]
    step = make_lm_train_step(cfg, policy, opt, remat=False,
                              transport=transport,
                              pipeline_microbatches=pipeline_microbatches,
                              schedule=schedule,
                              virtual_stages=virtual_stages, parallel=spec)
    dp_state = (init_lm_dp_state(cfg, params, policy_eff, spec.dp,
                                 spec.data.feedback, transport=transport,
                                 virtual_stages=virtual_stages, tp=spec.tp)
                if spec.dp > 1 else None)
    tp_state = (init_tp_state((batch, data.seq_len, cfg.d_model),
                              transformer.tp_sites(cfg),
                              spec.tensor.feedback, device=dev)
                if spec.tp > 1 and transport == "simulated" else None)
    t0 = time.time()
    curve, policy_curve = [], []
    for ep in range(epochs):
        policy_curve.append(policy_eff.name if spec.tp == 1
                            else f"{policy_eff.name}/{spec.name}")
        for toks, ids in data.epoch(batch, ep):
            args = [params, opt_state, bstates,
                    {"tokens": torch.from_numpy(toks).to(dev, torch.int64)},
                    torch.from_numpy(ids).to(dev)]
            args += [s for s in (dp_state, tp_state) if s is not None]
            out = step(*args)
            params, opt_state, bstates, m = out[0], out[1], out[2], out[-1]
            rest = list(out[3:-1])
            if dp_state is not None:
                dp_state = rest.pop(0)
            if tp_state is not None:
                tp_state = rest.pop(0)
            curve.append(float(m["loss"]))
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
