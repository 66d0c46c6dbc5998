"""Mixture-of-Experts FFN: GShard-style grouped capacity-based dispatch.

Port of ``repro/models/moe.py``.  Tokens are split into groups of
``group_size``; within a group, routing is materialized as dispatch /
combine one-hot tensors ``(g, E, C)`` applied with einsums, capacity
``C = max(top_k, ceil(cf * g * top_k / E))``.  The reference's mesh
``constrain`` calls are no-ops on one device and are dropped.

Supports mixtral (8 experts, top-2) and llama4-maverick (128 experts,
top-1, a shared expert, every 2nd layer).  Router in fp32 with the
Switch-style load-balance auxiliary loss.

Routing is integer state and is held bitwise to the reference:
  * ``jax.lax.top_k`` breaks ties toward the lower index; ``torch.topk``
    promises no tie order, so the top k come from a stable descending sort;
  * the gates are picked by a one-hot product (one non-zero term a row:
    exact), so autograd reaches the router without a scatter;
  * slot positions are an exclusive integer cumsum over the choices in
    priority order (every top-1 first, then every top-2 ...);
  * the dispatch / combine one-hots are the reference's einsums over k:
    for each (e, c) at most one k term is non-zero, so the sum is exact
    in any order, and no index_add / scatter_add (which deterministic
    mode serialises on the card) is involved.

Entry points:
  moe_init(gen, d, ff, num_experts, mlp_kind, num_shared, dtype, lead)
  moe_apply(params, x, num_experts, top_k, mlp_kind, capacity_factor,
            group_size, dispatch_quant, dropless)          -> (y, aux)
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.compressors import (dequantize_kbit, quantize_dequantize,
                                          quantize_kbit)
from repro_torch.models.common import DTYPE, dense_init, mlp_apply, mlp_init

GROUP_SIZE = 4096        # tokens per routing group (MaxText-like)


def dense_init_slices(gen: torch.Generator, in_dim: int, out_dim: int,
                      dtype=DTYPE, lead=()) -> torch.Tensor:
    """:func:`common.dense_init`'s distribution, drawn one ``(in, out)``
    slice at a time into a preallocated ``(*lead, in, out)`` leaf, so no
    f32 temporary of the whole leaf exists (llama4's expert stacks are
    (2, 128, 5120, 8192): 42.9 GB in f32)."""
    out = torch.empty((*lead, in_dim, out_dim), dtype=dtype,
                      device=gen.device)
    flat = out.view(-1, in_dim, out_dim)
    for i in range(flat.shape[0]):
        flat[i] = dense_init(gen, in_dim, out_dim, dtype)
    return out


def moe_init(gen: torch.Generator, d: int, ff: int, num_experts: int,
             mlp_kind: str, num_shared: int = 0, dtype=DTYPE, lead=()):
    """The reference's layout: ``router`` f32 (*lead, d, E), ``experts``
    an MLP tree whose leaves carry (*lead, E) in front, ``shared`` an MLP
    of width ``ff * num_shared``."""
    elead = (*lead, num_experts)
    experts = {"wi": dense_init_slices(gen, d, ff, dtype, elead)}
    if mlp_kind == "swiglu":
        experts["wg"] = dense_init_slices(gen, d, ff, dtype, elead)
    experts["wo"] = dense_init_slices(gen, ff, d, dtype, elead)
    params = {"router": dense_init(gen, d, num_experts, torch.float32, lead),
              "experts": experts}
    if num_shared:
        params["shared"] = mlp_init(gen, d, ff * num_shared, mlp_kind, dtype,
                                    lead)
    return params


def _top_k(probs: torch.Tensor, top_k: int):
    """``jax.lax.top_k`` on the last dim: indices by a stable descending
    sort (ties to the lower index) and the values picked by a one-hot
    product, differentiable in ``probs``.  Returns (vals, idx, onehot
    (..., k, E) f32)."""
    idx = torch.sort(probs.detach(), dim=-1, descending=True,
                     stable=True)[1][..., :top_k]
    onehot = F.one_hot(idx, probs.shape[-1]).to(probs.dtype)
    vals = (probs[..., None, :] * onehot).sum(-1)
    return vals, idx, onehot


def _gates(probs: torch.Tensor, top_k: int):
    vals, idx, onehot = _top_k(probs, top_k)
    vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    return vals, idx, onehot


def _route(logits: torch.Tensor, top_k: int, cap: int, num_experts: int):
    """logits: (G, g, E) fp32 -> dispatch (G, g, E, C) f32, combine
    (G, g, E, C) f32, aux loss scalar."""
    gg, g, e = logits.shape
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx, exp_oh = _gates(probs, top_k)         # (G,g,k)

    # Switch load-balance loss on the top-1 assignment
    me = probs.mean(dim=1)                                     # (G,E)
    ce = exp_oh[:, :, 0].mean(dim=1)                           # (G,E)
    aux = e * (me * ce).sum(-1).mean()

    # slot position of each (token, choice) within its expert, per group;
    # choices flattened in priority order: all top-1 first, then top-2 ...
    onehot = F.one_hot(gate_idx, e)                            # (G,g,k,E) int
    flat = onehot.transpose(1, 2).reshape(gg, g * top_k, e)
    pos = torch.cumsum(flat, dim=1) - flat                     # (G,g*k,E)
    pos = (pos * flat).sum(-1).reshape(gg, top_k, g).transpose(1, 2)
    keep = pos < cap                                           # (G,g,k)
    gate_vals = gate_vals * keep

    slot_oh = F.one_hot(torch.where(keep, pos, torch.full_like(pos, cap)),
                        cap + 1)[..., :cap].to(torch.float32)  # (G,g,k,C)
    # a (token, expert) pair is chosen by at most one k: one non-zero
    # product an (e, c) entry, exact in any order (float32 products)
    dispatch = torch.einsum("Ggke,Ggkc->Ggec", exp_oh,
                            slot_oh * keep[..., None].to(torch.float32))
    combine = torch.einsum("Ggke,Ggkc->Ggec", exp_oh,
                           slot_oh * gate_vals[..., None])
    return dispatch, combine, aux


def _qdq_rows(t: torch.Tensor) -> torch.Tensor:
    codes, mn, sc = quantize_kbit(t.to(torch.float32), 8, dim=(3,))
    return dequantize_kbit(codes, mn, sc, torch.float32)


class _QuantDispatch(torch.autograd.Function):
    """BEYOND-PAPER: the (E, G, C, d) expert-dispatch payload int8-coded
    per (e, G, c) row over d (one f32 min and scale a row), as it would
    cross an expert-parallel all-to-all; the backward payload, the
    gradient of the dispatched tokens, is coded the same way."""

    @staticmethod
    def forward(ctx, t):
        return _qdq_rows(t).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return _qdq_rows(g).to(g.dtype)


def _moe_apply_dense(params, x: torch.Tensor, *, num_experts: int,
                     top_k: int, mlp_kind: str, dispatch_quant: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropless dense routing (inference paths): every expert runs on
    every token, combined with the (renormalized) top-k gates; nothing is
    dropped, so prefill, decode and a span decode see the same expert math
    whatever the length (the capacity path's C and groups depend on it)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    logits = xt.to(torch.float32) @ params["router"]           # (T,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, _, onehot = _gates(probs, top_k)                # (T,k)
    combine = (onehot * gate_vals[..., None]).sum(1)           # (T,E)
    aux = num_experts * (probs.mean(0) * onehot[:, 0].mean(0)).sum()
    ex_in = xt
    if dispatch_quant:
        # the wire semantics of _QuantDispatch: the token vectors the
        # experts receive int8-coded along d (straight-through)
        qdq = quantize_dequantize(ex_in.to(torch.float32), 8,
                                  dim=(1,)).to(ex_in.dtype)
        ex_in = ex_in + (qdq - ex_in).detach()
    # einsum("etd,te->td") over the experts' outputs, bf16 operands (the
    # gates cast as the reference casts them), products and sum in f32: a
    # token has at most top_k non-zero terms, so the order of the sum over
    # e changes no bit, and one expert's (T, ff) activations are live at a
    # time instead of all E (llama4: 128)
    comb = combine.to(xt.dtype).to(torch.float32)
    y = torch.zeros((b * s, d), dtype=torch.float32, device=x.device)
    for e in range(num_experts):
        pe = {k: v[e] for k, v in params["experts"].items()}
        y = y + mlp_apply(pe, ex_in, mlp_kind).to(torch.float32) \
            * comb[:, e, None]
    y = y.to(x.dtype)
    if "shared" in params:
        y = y + mlp_apply(params["shared"], xt, mlp_kind)
    return y.reshape(b, s, d), aux


def moe_apply(params, x: torch.Tensor, *, num_experts: int, top_k: int,
              mlp_kind: str, capacity_factor: float = 1.25,
              group_size: int = GROUP_SIZE, dispatch_quant: bool = False,
              dropless: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d).  Returns (y, aux_loss).  ``dropless`` (inference)
    switches to dense routing (:func:`_moe_apply_dense`); single-token
    decode always routes densely (capacity degenerates to C = 1 there)."""
    b, s, d = x.shape
    if dropless or s == 1:
        return _moe_apply_dense(params, x, num_experts=num_experts,
                                top_k=top_k, mlp_kind=mlp_kind,
                                dispatch_quant=dispatch_quant)
    t = b * s
    g = min(group_size, t)
    while t % g:
        g //= 2
    gg = t // g
    cap = max(top_k, int(math.ceil(capacity_factor * g * top_k
                                   / num_experts)))

    xt = x.reshape(gg, g, d)
    logits = xt.to(torch.float32) @ params["router"]           # (G,g,E)
    dispatch, combine, aux = _route(logits, top_k, cap, num_experts)
    # every (e, c) row of dispatch holds at most one 1: ex_in is exact
    ex_in = torch.einsum("Ggd,Ggec->eGcd", xt, dispatch.to(xt.dtype))
    if dispatch_quant:
        ex_in = _QuantDispatch.apply(ex_in)
    ex_out = mlp_apply(params["experts"],
                       ex_in.reshape(num_experts, gg * cap, d),
                       mlp_kind).reshape(num_experts, gg, cap, d)
    # einsum("eGcd,Ggec->Ggd") on bf16 operands (combine cast as the
    # reference casts it), the products and sum in f32
    comb = combine.to(ex_out.dtype).to(torch.float32)
    y = torch.einsum("eGcd,Ggec->Ggd", ex_out.to(torch.float32),
                     comb).to(x.dtype)
    if "shared" in params:
        y = y + mlp_apply(params["shared"], xt, mlp_kind)
    return y.reshape(b, s, d), aux
