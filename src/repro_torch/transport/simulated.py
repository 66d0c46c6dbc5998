"""Single-device simulated transport (the paper's Sec. 2.1 setup).

Port of ``repro/transport/simulated.py``: the "wire" is a dense
compress-decompress round trip inside one program, convergence-equivalent
to the distributed system.  ``core/boundary.py`` wraps it in a
``torch.autograd.Function`` so that ``bw`` runs on the
activation-gradient during backward.
"""
from __future__ import annotations

from functools import lru_cache

import torch

from repro_torch.core.compressors import topk_mask
from repro_torch.core.feedback import FeedbackState, feedback_message
from repro_torch.core.policy import BoundaryPolicy
from repro_torch.transport.base import Transport


class SimulatedTransport(Transport):
    """Feedback-wrapped compressors at one cut, no real communication."""

    def __init__(self, policy: BoundaryPolicy):
        self.policy = policy

    def fw(self, x, fw_state: FeedbackState, ids=None):
        """Forward message + new fw state + ctx (TopK mask for reuse)."""
        p = self.policy
        if p.feedback == "aqsgd" and ids is None:
            raise ValueError("aqsgd feedback needs per-example ids")
        m, new_resid = feedback_message(p.feedback, p.fw, x,
                                        fw_state.resid, ids)
        mask = None
        if p.reuse_indices:
            # the exact per-example TopK mask of what the forward direction
            # compressed, as in the reference on every backend -- not the
            # block kernel's kept set (paper Table 5)
            mask = topk_mask(x if p.feedback == "none" else m, p.fw.k_frac)
        return m, fw_state.replace(resid=new_resid), mask

    def bw(self, g, bw_state: FeedbackState, ctx=None):
        """Backward gradient message + new bw state.  With
        ``reuse_indices`` the gradient is masked by the forward mask
        ``ctx``: no fresh TopK and no index bytes backward."""
        p = self.policy
        if p.reuse_indices:
            return (torch.where(ctx, g, torch.zeros_like(g)),
                    bw_state.map(torch.zeros_like))
        m, new_resid = feedback_message(p.bw_feedback, p.bw, g,
                                        bw_state.resid)
        return m, bw_state.replace(resid=new_resid)


@lru_cache(maxsize=None)
def simulated_transport(policy: BoundaryPolicy) -> SimulatedTransport:
    """Cached per-policy instance (policies are frozen and hashable)."""
    return SimulatedTransport(policy)
