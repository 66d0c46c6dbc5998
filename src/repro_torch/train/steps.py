"""LM train and eval steps with the paper's boundary compression.

Port of the simulated-transport branch of ``repro/train/steps.py``
(``make_lm_train_step`` with ``grad_accum=1``, ``make_lm_eval_step``).
The step is eager PyTorch: one forward through ``forward_hidden`` (each
cut a ``boundary_apply``), the chunked LM loss, one backward, then the
optimizer.  The cuts' new backward feedback states are read from their
``BwSlot``s after the backward (the reference reads them out of the
gradient w.r.t. the bw buffers).  The pipeline transport, DP, TP and
gradient accumulation are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core.policy import CompressionPolicy
from repro_torch.models import transformer
from repro_torch.optim.optimizers import (OptimizerConfig, apply_updates,
                                          tree_map)


def _labels_and_mask(tokens):
    """Next-token labels (``roll(tokens, -1)``) and a mask that drops the
    last position, whose label wrapped around."""
    labels = torch.roll(tokens, -1, dims=1)
    mask = torch.ones(labels.shape, dtype=torch.float32,
                      device=tokens.device)
    mask[:, -1] = 0.0
    return labels, mask


def make_lm_train_step(cfg, policy: CompressionPolicy, opt: OptimizerConfig,
                       aux_weight: float = 0.01, remat: bool = True):
    """Returns ``step(params, opt_state, bstates, batch, ids) -> (params,
    opt_state, bstates, metrics)``.

    batch: {"tokens": (B, S) int}; ``bstates``: one ``{"fw", "bw"}`` dict
    per cut (``[]`` without compression); ``ids``: (B,) example ids.  The
    caller's params are not modified; AQ-SGD's fw buffer is updated in
    place (``core/feedback.aqsgd_message``)."""
    transformer.check_supported(cfg)

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
