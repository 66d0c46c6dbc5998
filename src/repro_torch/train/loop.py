"""The paper's LM experiment loop (Sec. 3.2).

Port of ``run_lm_experiment``, ``_lm_eval`` and ``_pipeline_bstates``
from ``repro/train/loop.py`` for a static policy on the simulated
transport or the real pipeline (``dp=1``): fine-tune with boundary
compression, then evaluate the loss with compression on AND off (finding
F3: a model trained compressed must be served compressed).  Rule
policies, bandwidth probes, the parallel spec and trace spans are not
ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.boundary import init_boundary_state
from repro_torch.core.policy import BoundaryPolicy, CompressionPolicy
from repro_torch.data.synthetic import LMData
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import OptimizerConfig, init_opt_state
from repro_torch.train.steps import make_lm_eval_step, make_lm_train_step
from repro_torch.transport.pipeline import init_feedback_state


@dataclasses.dataclass
class ExperimentResult:
    name: str
    loss_on: float = 0.0           # eval loss with compression ON
    loss_off: float = 0.0          # eval loss with compression OFF
    train_curve: List[float] = dataclasses.field(default_factory=list)
    seconds: float = 0.0
    params: Optional[dict] = None


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
                      device=None):
    """Feedback state for the pipeline transport: the stage-stacked
    ``init_feedback_state`` dict, or ``[]`` for feedback-free policies."""
    bp = policy.at(0) if policy.num_boundaries else BoundaryPolicy()
    if not (bp.needs_fw_buffer or bp.needs_bw_buffer):
        return []
    return init_feedback_state(bp, feat_shape, num_stages=policy.num_stages,
                               batch=batch, microbatches=microbatches,
                               num_samples=num_samples, dtype=dtype,
                               virtual_stages=virtual_stages, device=device)


def run_lm_experiment(cfg: ModelConfig, policy: CompressionPolicy, *,
                      pretrained_params=None, epochs: int = 2,
                      batch: int = 16, data: Optional[LMData] = None,
                      name: str = "", opt: Optional[OptimizerConfig] = None,
                      seed: int = 0, transport: str = "simulated",
                      pipeline_microbatches: Optional[int] = None,
                      schedule: str = "gpipe", virtual_stages: int = 1,
                      device=None) -> ExperimentResult:
    """Fine-tune a (pre-trained) LM with boundary compression and report
    the train curve and the eval loss with compression on and off.

    ``transport="pipeline"`` runs the layer stack as the real compressed
    pipeline under ``schedule`` (gpipe | 1f1b | interleaved).
    ``pretrained_params``: a params tree on ``device`` (default: fresh
    params from a generator seeded with ``seed``).  Runs on ``cuda``
    unless ``device`` says otherwise."""
    if transport not in ("simulated", "pipeline"):
        raise ValueError(f"unknown transport {transport!r}")
    dev = resolve_device(device)
    data = data or LMData()
    opt = opt or OptimizerConfig(kind="adamw", lr=3e-4, weight_decay=0.01,
                                 schedule="constant", grad_clip=1.0)
    params = pretrained_params or transformer.init_params(
        torch.Generator(device=dev).manual_seed(seed), cfg)
    opt_state = init_opt_state(opt, params)
    feat = (data.seq_len, cfg.d_model)
    if transport == "pipeline":
        bstates = _pipeline_bstates(policy, feat, batch=batch,
                                    microbatches=pipeline_microbatches,
                                    num_samples=data.num_train,
                                    dtype=torch.bfloat16,
                                    virtual_stages=virtual_stages, device=dev)
    else:
        bstates = [init_boundary_state(policy.at(i), feat, batch=batch,
                                       num_samples=data.num_train,
                                       dtype=torch.bfloat16, device=dev)
                   for i in range(policy.num_boundaries)]
    step = make_lm_train_step(cfg, policy, opt, remat=False,
                              transport=transport,
                              pipeline_microbatches=pipeline_microbatches,
                              schedule=schedule,
                              virtual_stages=virtual_stages)
    t0 = time.time()
    curve = []
    for ep in range(epochs):
        for toks, ids in data.epoch(batch, ep):
            params, opt_state, bstates, m = step(
                params, opt_state, bstates,
                {"tokens": torch.from_numpy(toks).to(dev, torch.int64)},
                torch.from_numpy(ids).to(dev))
            curve.append(float(m["loss"]))
    res = ExperimentResult(name=name or policy.boundary.name,
                           train_curve=curve, seconds=time.time() - t0)
    res.loss_on = _lm_eval(params, cfg, data, policy, True, batch, dev)
    res.loss_off = _lm_eval(params, cfg, data, policy, False, batch, dev)
    res.params = params
    return res
