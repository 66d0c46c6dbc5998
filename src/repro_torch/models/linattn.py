"""Chunked linear attention: the core of RWKV6 (Finch) and Mamba2/SSD.

Port of ``repro/models/linattn.py``.  Recurrence (per head, state S in
R^{K x V}):

    S_t = diag(exp(w_t)) S_{t-1} + k_t v_t^T          (w_t <= 0, log decay)
    y_t = q_t (S_{t-1} + diag(u) k_t v_t^T)           [bonus mode, RWKV]
    y_t = q_t S_t                                      [include-current, SSD]

computed a chunk of L tokens at a time: inside a chunk everything is
products with non-positive exponents only,

    y_t  = (q_t . exp(cx_t)) S_0                      (inter-chunk)
         + sum_j q_t k_j exp(cx_t - c_j) v_j          (intra-chunk, cx>=c_j)
    S_L  = exp(c_L) . S_0 + sum_j (k_j exp(c_L - c_j)) v_j^T

with c_t = cumsum(w)_t and cx_t = c_{t-1} (bonus) or c_t (include-current).

Plain torch ops in f32, as the reference is plain XLA (it has no Pallas
kernel here).  The chunk's cumulative sum is a product with a
lower-triangular ones matrix: deterministic on CUDA (a floating
``torch.cumsum`` raises under ``torch.use_deterministic_algorithms``),
forward and backward, and the same sums in another order.  A Python loop
over chunks takes the reference's ``lax.scan``; each chunk materialises
the (B, H, L, L, K) f32 pair tensor, as the reference does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30
MIN_LOG_DECAY = -8.0     # clamp: exp(-8) ~ 3e-4 per step, effectively zero


def chunked_linear_attention(q, k, v, log_w, *, chunk: int = 32,
                             bonus: Optional[torch.Tensor] = None,
                             initial_state: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, log_w: (B, H, T, K); v: (B, H, T, V); bonus u: (H, K) or None.

    bonus given => RWKV semantics (y_t reads S_{t-1} + u-weighted current);
    bonus None  => SSD semantics (y_t reads S_t).  T is padded to a whole
    number of chunks with zero steps (k = v = 0, log_w = 0: the state
    passes through them unchanged).  Returns (y: (B, H, T, V) in v's
    dtype, final_state: (B, H, K, V) f32)."""
    b, h, t, kd = q.shape
    vd = v.shape[-1]
    dt = v.dtype
    f32 = torch.float32
    q, k, v = (a.to(f32) for a in (q, k, v))
    log_w = torch.clamp(log_w.to(f32), MIN_LOG_DECAY, 0.0)

    l = min(chunk, t)
    pad = (-t) % l
    if pad:
        q, k, v, log_w = (F.pad(a, (0, 0, 0, pad)) for a in (q, k, v, log_w))
    nc = q.shape[2] // l
    include_current = bonus is None
    ti = torch.arange(l, device=q.device)
    # intra-chunk pair mask: j < t (bonus) or j <= t (include-current)
    pair_mask = (ti[None, :] <= ti[:, None]) if include_current \
        else (ti[None, :] < ti[:, None])                        # (L, L)
    pair_mask = pair_mask[:, :, None]
    tri = (ti[None, :] <= ti[:, None]).to(f32)                  # cumsum
    u = None if bonus is None else bonus.to(f32)[None, :, None, :]

    s = (torch.zeros((b, h, kd, vd), dtype=f32, device=q.device)
         if initial_state is None else initial_state.to(f32))
    ys = []
    # one view a chunk (unbind: its backward is one stack, not a
    # full-size zero gradient a chunk)
    chunks = zip(*(a.unflatten(2, (nc, l)).unbind(2)
                   for a in (q, k, v, log_w)))
    for qi, ki, vi, wi in chunks:                               # (B,H,L,*)
        c = tri @ wi                                            # (B,H,L,K)
        cx = c if include_current else c - wi                   # c_t | c_{t-1}
        # inter-chunk
        y = (qi * torch.exp(cx)) @ s
        # intra-chunk: exponent cx[t] - c[j] (<= 0 wherever the pair is valid)
        expo = cx[:, :, :, None, :] - c[:, :, None, :, :]       # (B,H,L,L,K)
        expo = torch.where(pair_mask, expo, NEG_INF)
        att = (qi[:, :, :, None, :] * ki[:, :, None, :, :]
               * torch.exp(expo)).sum(-1)                       # (B,H,L,L)
        y = y + att @ vi
        if u is not None:
            ub = (qi * u * ki).sum(-1)                          # (B,H,L)
            y = y + ub[..., None] * vi
        # state to the end of the chunk
        c_last = c[:, :, -1:, :]                                # (B,H,1,K)
        decayed_k = ki * torch.exp(c_last - c)                  # (B,H,L,K)
        s = torch.exp(c_last[:, :, 0, :])[..., None] * s \
            + decayed_k.transpose(-1, -2) @ vi
        ys.append(y)
    y = torch.cat(ys, dim=2)[:, :, :t]
    return y.to(dt), s


def linear_attention_decode(q1, k1, v1, log_w1, state, *,
                            bonus: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the recurrence.  q1, k1, log_w1: (B, H, K); v1: (B, H,
    V); state: (B, H, K, V).  Returns (y (B, H, V) f32, new state)."""
    f32 = torch.float32
    q1, k1, v1 = (a.to(f32) for a in (q1, k1, v1))
    log_w1 = torch.clamp(log_w1.to(f32), MIN_LOG_DECAY, 0.0)
    kv = k1[..., :, None] * v1[..., None, :]                    # (B,H,K,V)
    new_state = torch.exp(log_w1)[..., None] * state + kv
    if bonus is not None:
        read = state + bonus.to(f32)[None, :, :, None] * kv
    else:
        read = new_state
    y = (q1[..., None, :] @ read)[..., 0, :]
    return y, new_state


def reference_linear_attention(q, k, v, log_w, *, bonus=None,
                               initial_state=None):
    """The O(T) sequential oracle for tests (same signature, f32)."""
    b, h, t, kd = q.shape
    vd = v.shape[-1]
    s = (torch.zeros((b, h, kd, vd), dtype=torch.float32, device=q.device)
         if initial_state is None else initial_state.to(torch.float32))
    ys = []
    for i in range(t):
        y, s = linear_attention_decode(q[:, :, i], k[:, :, i], v[:, :, i],
                                       log_w[:, :, i], s, bonus=bonus)
        ys.append(y)
    return torch.stack(ys, dim=2).to(v.dtype), s
