"""Optimizers: SGD + momentum + weight decay, AdamW, cosine schedule.

Port of ``repro/optim/optimizers.py``.  Parameters and optimizer moments
are nested dicts and lists of tensors mirroring each other (the CNN's
``stages`` is a list of lists of dicts); every update is
computed in float32 and cast back to the parameter's (and the moment's)
dtype, step for step as in the reference.  Updates run under
``torch.no_grad``, one leaf at a time, the gradient clip's scale applied
per leaf, and return new tensors; with ``donate=True`` (the port of the
reference step's ``donate_argnums``) the params and moments are
overwritten in place instead, so a large model never holds two copies of
its AdamW state.  The arithmetic, and so every bit, is the same either
way.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "sgd"                   # sgd | adamw
    lr: float = 0.01
    momentum: float = 0.9               # sgd
    beta1: float = 0.9                  # adamw
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 5e-4
    grad_clip: float = 0.0              # 0 = off
    moment_dtype: Any = torch.float32
    # cosine schedule (paper: cosine annealing, T_max=200, lr0=0.01)
    schedule: str = "cosine"            # cosine | constant
    t_max: int = 200
    lr_min: float = 0.0
    warmup_steps: int = 0


def tree_map(f, *trees):
    """``f`` over the leaves of nested dicts and lists of the same
    structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(f, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], list):
        return [tree_map(f, *ts) for ts in zip(*trees)]
    return f(*trees)


def tree_leaves(tree):
    """Leaves of nested dicts and lists in ``jax.tree.leaves``' order:
    dict keys sorted, list items in index order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def schedule_lr(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor), float32."""
    step = step.to(torch.float32)
    lr = torch.full_like(step, cfg.lr)
    if cfg.schedule == "cosine":
        t = torch.clamp(step / max(cfg.t_max, 1), 0.0, 1.0)
        lr = cfg.lr_min + 0.5 * (cfg.lr - cfg.lr_min) * (
            1 + torch.cos(math.pi * t))
    if cfg.warmup_steps:
        lr = lr * torch.clamp(step / cfg.warmup_steps, 0.0, 1.0)
    return lr


def init_opt_state(cfg: OptimizerConfig, params):
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
    state = {"step": torch.zeros((), dtype=torch.int32,
                                 device=tree_leaves(params)[0].device)}
    if cfg.kind == "sgd":
        state["mu"] = tree_map(zeros, params)
    elif cfg.kind == "adamw":
        state["mu"] = tree_map(zeros, params)
        state["nu"] = tree_map(zeros, params)
    else:
        raise ValueError(cfg.kind)
    return state


def _square_sums(grads) -> list:
    """Each leaf's sum of squares, float32, in ``tree_leaves`` order."""
    return [torch.sum(torch.square(g.to(torch.float32)))
            for g in tree_leaves(grads)]


def _sqrt_of_sum(sq) -> torch.Tensor:
    total = sq[0]
    for v in sq[1:]:
        total = total + v
    return torch.sqrt(total)


def _global_norm(grads) -> torch.Tensor:
    return _sqrt_of_sum(_square_sums(grads))


def ranks_global_norm(grads, all_gather) -> torch.Tensor:
    """The global norm of a gradient tree whose leaves are split over
    ranks: each rank's per-leaf squared sums of ``grads`` (the leaves it
    owns) go to every rank through ``all_gather`` (a 1-D float32 tensor
    -> one such tensor a rank, in rank order: the rank step's wrapper of
    ``transport/p2p.py::StageGroup.all_gather_floats``) and are summed in
    one fixed order, rank by rank, leaf by leaf, so every rank gets the
    same bits.  One process sums each whole leaf in one reduction, so
    where a rank holds part of a leaf the two norms can part in the last
    bits (``tests/test_torch_pipeline_ranks.py`` states the bound)."""
    rows = all_gather(torch.stack(_square_sums(grads)))
    return _sqrt_of_sum([v for row in rows for v in row])


def _work(t: torch.Tensor, donate: bool) -> torch.Tensor:
    """``t`` as a float32 tensor the update may overwrite: ``t`` itself
    when donated and already float32, else a float32 copy."""
    if donate and t.dtype == torch.float32:
        return t
    return t.to(torch.float32, copy=True)


def _give(dst: torch.Tensor, new: torch.Tensor, dtype, donate: bool):
    """The updated leaf: ``new`` written into ``dst`` when donated, else
    ``new`` cast to ``dtype``."""
    if not donate:
        return new.to(dtype)
    if new is not dst:
        dst.copy_(new)
    return dst


@torch.no_grad()
def apply_updates(cfg: OptimizerConfig, params, grads, state,
                  donate: bool = False, grad_norm=None):
    """Returns ``(new_params, new_state)``.  ``donate``: ``params`` and
    ``state`` are updated in place and returned (the caller must not
    expect the old values), the same bits as without it.  ``grad_norm``:
    the global gradient norm the clip reads, when ``grads`` is one rank's
    part of the tree (:func:`ranks_global_norm`); by default the norm of
    ``grads``."""
    step = state["step"] + 1
    lr = schedule_lr(cfg, step)
    scale = None
    if cfg.grad_clip:
        norm = _global_norm(grads) if grad_norm is None else grad_norm
        scale = torch.clamp(cfg.grad_clip / (norm + 1e-9), max=1.0)

    def grad32(g):
        # the reference's bf16 grad times its f32 scale is promoted to f32
        gf = g.to(torch.float32)
        return gf if scale is None else gf * scale

    if cfg.kind == "sgd":
        def upd(p, g, m):
            gf = grad32(g)
            if cfg.weight_decay:
                gf = gf + cfg.weight_decay * p.to(torch.float32)
            m_new = cfg.momentum * m.to(torch.float32) + gf
            p_new = p.to(torch.float32) - lr * m_new
            return (_give(p, p_new, p.dtype, donate),
                    _give(m, m_new, cfg.moment_dtype, donate))
        out = tree_map(upd, params, grads, state["mu"])
        return (_pick(out, 0),
                {"step": step, "mu": _pick(out, 1)})

    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - torch.pow(torch.full_like(lr, b1), step.to(torch.float32))
    bc2 = 1 - torch.pow(torch.full_like(lr, b2), step.to(torch.float32))

    def upd(p, g, m, v):
        # b1 * m + (1 - b1) * g, b2 * v + (1 - b2) * g * g, then
        # p - lr * (m^ / (sqrt(v^) + eps) + wd * p), rounded op by op as
        # the expression would be, in at most three leaf-sized temporaries
        gf = grad32(g)
        m_new = _work(m, donate)
        m_new *= b1
        m_new += gf * (1 - b1)
        v_new = _work(v, donate)
        v_new *= b2
        t = gf * (1 - b2)
        t *= gf
        v_new += t
        del gf, t
        step_ = m_new / bc1
        den = v_new / bc2
        den.sqrt_()
        den += cfg.eps
        step_ /= den
        del den
        pf = p.to(torch.float32)
        step_ += cfg.weight_decay * pf
        step_ *= lr
        p_new = pf - step_
        return (_give(p, p_new, p.dtype, donate),
                _give(m, m_new, cfg.moment_dtype, donate),
                _give(v, v_new, cfg.moment_dtype, donate))

    out = tree_map(upd, params, grads, state["mu"], state["nu"])
    return (_pick(out, 0),
            {"step": step, "mu": _pick(out, 1), "nu": _pick(out, 2)})


def _pick(out, i):
    """Element ``i`` of every tuple leaf of ``out``."""
    if isinstance(out, dict):
        return {k: _pick(v, i) for k, v in out.items()}
    if isinstance(out, list):
        return [_pick(v, i) for v in out]
    return out[i]
