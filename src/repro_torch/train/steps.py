"""LM train and eval steps with the paper's boundary compression.

Port of ``repro/train/steps.py``: ``make_lm_train_step`` with
``grad_accum=1`` on the simulated transport and on the real pipeline
(``dp=1``, ``tp=1``), and ``make_lm_eval_step``.  The step is eager
PyTorch: one forward, the chunked LM loss, one backward, then the
optimizer.  On the simulated transport each cut is a ``boundary_apply``
in ``forward_hidden``; on the pipeline the embedding and the loss run on
the whole batch and the layer stack runs through ``pipeline_apply``.  The
new backward feedback state is read after the backward from the cuts'
``BwSlot``s or the pipeline's ``PipelineSlot`` (the reference reads it
out of the gradient w.r.t. the bw buffers).  DP, TP and gradient
accumulation are not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.policy import BoundaryPolicy, CompressionPolicy
from repro_torch.models import transformer
from repro_torch.optim.optimizers import (OptimizerConfig, apply_updates,
                                          tree_map)
from repro_torch.transport.pipeline import pipeline_apply


def _labels_and_mask(tokens):
    """Next-token labels (``roll(tokens, -1)``) and a mask that drops the
    last position, whose label wrapped around."""
    labels = torch.roll(tokens, -1, dims=1)
    mask = torch.ones(labels.shape, dtype=torch.float32,
                      device=tokens.device)
    mask[:, -1] = 0.0
    return labels, mask


def make_lm_train_step(cfg, policy: CompressionPolicy, opt: OptimizerConfig,
                       aux_weight: float = 0.01, remat: bool = True,
                       transport: str = "simulated",
                       pipeline_microbatches: Optional[int] = None,
                       schedule: str = "gpipe", virtual_stages: int = 1):
    """Returns ``step(params, opt_state, bstates, batch, ids) -> (params,
    opt_state, bstates, metrics)``.

    batch: {"tokens": (B, S) int}; ``bstates``: one ``{"fw", "bw"}`` dict
    per cut (``[]`` without compression); ``ids``: (B,) example ids.  The
    caller's params are not modified; AQ-SGD's fw buffer is updated in
    place (``core/feedback.aqsgd_message``).

    ``transport="pipeline"`` trains through the real compressed pipeline
    (``transport/pipeline.py``) under ``schedule`` (gpipe | 1f1b |
    interleaved; ``virtual_stages`` slices per device for interleaved;
    ``pipeline_microbatches`` defaults to the stage count).  ``bstates``
    is then ``[]`` for a feedback-free policy, else the
    ``init_feedback_state`` dict, whose buffers the step updates in
    place; ``metrics["wire"]`` holds the step's hops and bytes per
    direction."""
    transformer.check_supported(cfg)
    if transport == "pipeline":
        return _make_pipeline_lm_train_step(
            cfg, policy, opt, microbatches=pipeline_microbatches,
            schedule=schedule, virtual_stages=virtual_stages)
    if transport != "simulated":
        raise ValueError(f"unknown transport {transport!r}")

    def step(params, opt_state, bstates, batch, ids):
        params = tree_map(lambda p: p.detach().requires_grad_(True), params)
        labels, mask = _labels_and_mask(batch["tokens"])
        x, aux, new_fw, slots = transformer.forward_hidden(
            params, batch, cfg, policy, bstates or None, ids, remat=remat)
        loss = transformer.hidden_lm_loss(params, x, labels, cfg, mask)
        total = loss + aux_weight * aux
        total.backward()
        grads = tree_map(lambda p: p.grad, params)
        params, opt_state = apply_updates(opt, params, grads, opt_state)
        # as the reference's zip: one state per cut the caller gave
        new_states = [{"fw": f, "bw": slot.state}
                      for f, slot, _ in zip(new_fw, slots, bstates)]
        metrics = {"loss": loss.detach(), "aux": aux.detach(),
                   "total": total.detach()}
        return params, opt_state, new_states, metrics

    return step


def _uniform_boundary(policy: CompressionPolicy) -> BoundaryPolicy:
    """The single per-cut policy the pipeline runs at every cut."""
    if policy.num_boundaries == 0:
        return BoundaryPolicy()
    bps = [policy.at(i) for i in range(policy.num_boundaries)]
    if any(bp != bps[0] for bp in bps):
        raise ValueError("the pipeline transport needs the same boundary "
                         "policy at every cut (one program)")
    return bps[0]


def _make_pipeline_lm_train_step(cfg, policy: CompressionPolicy,
                                 opt: OptimizerConfig, *,
                                 microbatches: Optional[int] = None,
                                 schedule: str = "gpipe",
                                 virtual_stages: int = 1):
    """LM training through the real compressed pipeline: the embedding
    and the chunked loss run on the whole batch, the layer stack as
    ``policy.num_stages * virtual_stages`` logical stage slices.  MoE aux
    losses are not threaded through the pipeline, as in the reference."""
    bp = _uniform_boundary(policy)
    s_stages = policy.num_stages
    needs_state = bp.needs_fw_buffer or bp.needs_bw_buffer
    stage_fn = transformer.stage_stack_fn(cfg)

    def step(params, opt_state, bstates, batch, ids):
        params = tree_map(lambda p: p.detach().requires_grad_(True), params)
        labels, mask = _labels_and_mask(batch["tokens"])
        x = transformer._embed(params, batch)
        stack = transformer.stack_layer_stages(params,
                                               s_stages * virtual_stages)
        x, new_fw, slot = pipeline_apply(
            stage_fn, stack, x, num_stages=s_stages, policy=bp,
            microbatches=microbatches, schedule=schedule,
            virtual_stages=virtual_stages,
            fw_state=bstates["fw"] if needs_state else None,
            bw_state=bstates["bw"] if needs_state else None, ids=ids)
        loss = transformer.hidden_lm_loss(params, x, labels, cfg, mask)
        loss.backward()
        grads = tree_map(lambda p: p.grad, params)
        params, opt_state = apply_updates(opt, params, grads, opt_state)
        metrics = {"loss": loss.detach(), "aux": torch.zeros(()),
                   "total": loss.detach(), "wire": dict(slot.wire)}
        new_states = ({"fw": new_fw, "bw": slot.state} if needs_state
                      else bstates)
        return params, opt_state, new_states, metrics

    return step


def make_lm_eval_step(cfg, policy: CompressionPolicy, compress: bool):
    """Returns ``step(params, batch) -> loss``: the LM loss with the cuts
    compressed by the plain fw compressor (``compress``) or not."""

    @torch.no_grad()
    def step(params, batch):
        logits = transformer.forward_eval(params, batch, cfg, policy,
                                          compress=compress)
        labels, mask = _labels_and_mask(batch["tokens"])
        return transformer.lm_loss(logits, labels, mask)

    return step
