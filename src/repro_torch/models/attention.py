"""GQA attention: full / sliding-window / logit-softcap variants, for
full-sequence training, prefill, and one-token decode over a KV cache.

Port of ``repro/models/attention.py``.  The reference has no Pallas
attention, so this is plain torch ops following ``_sdpa_block``'s
arithmetic: bf16 einsums, fp32 logits / sqrt(hd), the logit softcap
``tanh(l / cap) * cap`` (gemma2), -1e30 mask, fp32 softmax cast back to
bf16, queries in chunks of ``_qchunk`` beyond 2048 tokens.  Under
autograd each such chunk is recomputed in the backward pass
(``torch.utils.checkpoint``), so a long sequence never keeps every
chunk's (S_chunk x T) logits at once: the bound the reference's chunking
is for.  Recomputation gives the same values.  On an H100 it costs 6-9%
of a 4-layer gemma2-27b step at 3,072-4,608 tokens, and without it a
step of 8,192 tokens runs out of the card's 80 GB
(``chip_gemma2_probe.py``, PERF.md).

Cache layout: ``{"k": (B, C, KV, hd), "v": (B, C, KV, hd)}``, RoPE applied
at write time, where C is the full context for global layers and
``min(window, cache_len)`` for sliding-window layers: a RING, absolute
position p at row ``p % C``.  Or a page pool ``(N, P, KV, hd)`` read
through a page map (:func:`attn_decode_span`, absolute positions only).
:func:`attn_decode` and :func:`attn_decode_span` write the new K/V rows
IN PLACE (the reference returns a new cache; its engine donates the old
one).  :func:`attn_train_tp` is the head-sharded attention of the tensor
axis.  :func:`cross_attn` is the whisper decoder's attention over the
encoder memory (and the encoder's bidirectional self-attention).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import DTYPE, apply_rope, dense_init, softcap

_MASKED = -1e30


def _project_qkv(params, x, num_heads, num_kv_heads, head_dim):
    b, s, _ = x.shape
    q = (x @ params["wq"]).reshape(b, s, num_heads, head_dim)
    k = (x @ params["wk"]).reshape(b, s, num_kv_heads, head_dim)
    v = (x @ params["wv"]).reshape(b, s, num_kv_heads, head_dim)
    return q, k, v


def _sdpa_block(q, k, v, mask, cap=None):
    """q: (B,S,H,hd); k,v: (B,T,KV,hd); mask (B|1, S, T) or broadcastable
    to the (B, KV, G, S, T) logits; ``cap``: the logit softcap or None."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).to(torch.float32)
    logits = logits / torch.sqrt(torch.tensor(hd, dtype=torch.float32))
    logits = softcap(logits, cap)
    if mask.ndim == 3:
        mask = mask[:, None, None, :, :]
    logits = torch.where(mask, logits, _MASKED)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, hd)


def _qchunk(s: int) -> int:
    """Query-chunk size: bounds the materialized (S_chunk x T) logits."""
    if s <= 2048:
        return s
    return max(2048, s // 4)


def _sdpa(q, k, v, mask, cap=None):
    s = q.shape[1]
    qc = _qchunk(s)
    if qc >= s:
        return _sdpa_block(q, k, v, mask, cap)
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    outs = []
    for i in range(0, s, qc):
        mi = mask[:, i:i + qc] if mask.ndim == 3 else mask
        if grad:
            outs.append(checkpoint(_sdpa_block, q[:, i:i + qc], k, v, mi,
                                   cap, use_reentrant=False))
        else:
            outs.append(_sdpa_block(q[:, i:i + qc], k, v, mi, cap))
    return torch.cat(outs, dim=1)


def _causal_mask(positions: torch.Tensor, window=None) -> torch.Tensor:
    """(1, S, S) bool: key position <= query position, and within
    ``window`` of it (``kp > qp - window``) when a window is given."""
    qp, kp = positions[:, None], positions[None, :]
    m = kp <= qp
    if window is not None:
        m = m & (kp > qp - window)
    return m[None]


def _attend(params, x, num_heads, num_kv_heads, head_dim, pos_embed,
            rope_theta, window, attn_softcap, pad_mask):
    """Causal self-attention over ``x``: (output, RoPE'd keys, values)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(params, x, num_heads, num_kv_heads, head_dim)
    if pos_embed == "rope":
        q = apply_rope(q, positions[None], rope_theta)
        k = apply_rope(k, positions[None], rope_theta)
    mask = _causal_mask(positions, window)
    if pad_mask is not None:
        mask = mask & pad_mask[:, None, :]                       # (B, S, S)
    out = _sdpa(q, k, v, mask, attn_softcap)
    out = out.reshape(b, s, num_heads * head_dim)
    return out @ params["wo"], k, v


def attn_train(params, x, *, num_heads, num_kv_heads, head_dim,
               pos_embed="rope", rope_theta=10_000.0, window=None,
               attn_softcap=None, pad_mask=None):
    """Full-sequence causal self-attention, each query over the last
    ``window`` positions when a window is given.  ``pad_mask``: optional
    (B, S) bool, True = real token; pad keys are masked out of every
    query (left-padded serving batches)."""
    return _attend(params, x, num_heads, num_kv_heads, head_dim, pos_embed,
                   rope_theta, window, attn_softcap, pad_mask)[0]


def tp_local_heads(num_heads, num_kv_heads, tp):
    """Per-rank head counts for tp-way head-sharded attention."""
    if num_heads % tp or num_kv_heads % tp:
        raise ValueError(
            f"tensor parallelism shards attention heads: num_heads "
            f"{num_heads} and num_kv_heads {num_kv_heads} must both be "
            f"divisible by tp={tp}")
    return num_heads // tp, num_kv_heads // tp


def attn_train_tp(ps, xs, tpc, *, num_heads, num_kv_heads, head_dim,
                  pos_embed="rope", rope_theta=10_000.0, window=None,
                  attn_softcap=None, buf=None, remat=False):
    """Column / row-parallel :func:`attn_train` over a compressed tensor
    ring (``transport/tp_collectives.py``), every rank in lock step.

    ``ps``: the ranks' weights (wq/wk/wv cut on the head out-dim, wo on
    its head in-dim); ``xs``: the ranks' sequence shards of the normed
    residual.  The in-gather crosses the compressed wire (``buf``: this
    site's feedback buffer), each rank attends with its local heads over
    the FULL sequence, and the partial ``wo`` outputs reduce-scatter back
    to the shards.  ``remat`` recomputes each rank's attention in the
    backward pass (never a collective).  Returns ``(shards, buf)``."""
    lh, lkv = tp_local_heads(num_heads, num_kv_heads, tpc.tp)
    fulls, buf = tpc.gather_site(xs, buf)

    def local(p, full):
        return attn_train(p, full, num_heads=lh, num_kv_heads=lkv,
                          head_dim=head_dim, pos_embed=pos_embed,
                          rope_theta=rope_theta, window=window,
                          attn_softcap=attn_softcap)

    partials = [checkpoint(local, p, f, use_reentrant=False) if remat
                else local(p, f) for p, f in zip(ps, fulls)]
    return tpc.scatter(partials), buf


def init_cache(batch: int, cache_len: int, num_kv_heads: int, head_dim: int,
               dtype=DTYPE, device=None):
    shape = (batch, cache_len, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_prefill(params, x, *, cache_len, num_heads, num_kv_heads, head_dim,
                 pos_embed="rope", rope_theta=10_000.0, window=None,
                 attn_softcap=None, pad_mask=None):
    """Full-sequence attention (:func:`attn_train`) that also fills a new
    cache: ``cache_len`` rows, or a ring of ``min(window, cache_len)``
    with position p at row ``p % C`` when a window is given.
    ``pad_mask``: optional (B, S) bool, True = real token (left-padded
    serving batches: pad keys are masked out of every query)."""
    b, s, _ = x.shape
    out, k, v = _attend(params, x, num_heads, num_kv_heads, head_dim,
                        pos_embed, rope_theta, window, attn_softcap,
                        pad_mask)
    ring = window is not None
    csize = min(window, cache_len) if ring else cache_len
    cache = init_cache(b, csize, num_kv_heads, head_dim, k.dtype, x.device)
    c = min(csize, s)
    klast, vlast = k[:, s - c:], v[:, s - c:]
    if ring and c == csize and s % c:
        # ring semantics: absolute position p lives at row p % c
        klast = torch.roll(klast, s % c, dims=1)
        vlast = torch.roll(vlast, s % c, dims=1)
    cache["k"][:, :c] = klast
    cache["v"][:, :c] = vlast
    return out, cache


def attn_decode(params, x1, cache, pos, *, num_heads, num_kv_heads,
                head_dim, pos_embed="rope", rope_theta=10_000.0,
                window=None, attn_softcap=None, pad_len=None):
    """One-token decode.  x1: (B, 1, d); ``pos``: the new token's index,
    an int (the same for every row) or a (B,) tensor, one position per
    slot (continuous batching: each slot decodes its own request at its
    own position, its K/V scattered one row per slot).

    ``window`` set: the cache is a ring of C = ``cache["k"].shape[1]``
    rows holding RoPE'd keys at their absolute positions, the new row at
    ``pos % C``; row i holds position ``pos - ((pos % C - i) % C)``, valid
    while that age is below ``min(pos + 1, C)``.  ``pad_len``: optional
    (B,) — cache rows holding absolute positions before it are
    left-padding and masked out.  Writes K/V in place."""
    b = x1.shape[0]
    c = cache["k"].shape[1]
    dev = x1.device
    per_slot = isinstance(pos, torch.Tensor)
    q, k, v = _project_qkv(params, x1, num_heads, num_kv_heads, head_dim)
    if pos_embed == "rope":
        posb = pos[:, None] if per_slot else torch.full((1, 1), pos,
                                                        device=dev)
        q = apply_rope(q, posb, rope_theta)
        k = apply_rope(k, posb, rope_theta)
    slot = pos % c if window is not None else pos
    if per_slot:
        rows = torch.arange(b, device=dev)
        cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
        posc, slotc = pos[:, None], slot[:, None]                # (B, 1)
    else:
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
        posc, slotc = pos, slot
    idx = torch.arange(c, device=dev)
    if window is None:
        valid, abs_pos = idx <= posc, idx                        # absolute
    else:
        age = (slotc - idx) % c                                  # ring
        if per_slot:
            valid = age < torch.clamp(posc + 1, max=c)
        else:
            valid = age < min(pos + 1, c)
        abs_pos = posc - age
    if valid.ndim == 1:
        valid = valid[None]                                      # (1, C)
    if pad_len is not None:
        valid = valid & (abs_pos >= pad_len[:, None])            # (B, C)
    mask = valid[:, None, None, None, :]                # (B|1,1,1,1,C)
    out = _sdpa_block(q, cache["k"], cache["v"], mask, attn_softcap)
    return out.reshape(b, 1, num_heads * head_dim) @ params["wo"], cache


def attn_decode_span(params, x, cache, pos, *, num_heads, num_kv_heads,
                     head_dim, pos_embed="rope", rope_theta=10_000.0,
                     window=None, attn_softcap=None, pad_len=None,
                     page_map=None, valid_len=None):
    """Multi-token decode: ``x`` (B, T, d) holds new tokens at absolute
    positions ``pos[b] + arange(T)`` (``pos``: a (B,) tensor).  One shape
    covers a chunked prefill (B = 1, T = chunk) and a speculative
    verification (T = k + 1); T = 1 gives :func:`attn_decode`'s output on
    the same cache contents.

    Cache forms:
      * slab  — ``cache["k"]: (B, C, KV, hd)`` (``page_map`` None);
        ``pad_len`` masks left-padding as in :func:`attn_decode`.
      * paged — ``cache["k"]: (N, P, KV, hd)``, a page POOL read and
        written through ``page_map: (B, n_pages)`` physical page ids:
        position t lives in page ``page_map[b, t // P]`` at offset
        ``t % P``.  Unallocated logical pages map to the trash page 0,
        never valid under the position mask.

    ``valid_len``: optional (B,) — only the first valid_len[b] tokens are
    real (a padded last prefill chunk).  In the paged form the others'
    K/V go to the trash page; the slab form needs every token valid.
    Their queries give logits the caller ignores.  K/V are written IN
    PLACE; sliding-window ring caches are not supported (pages need
    absolute positions) and raise."""
    if window is not None:
        raise ValueError("attn_decode_span: sliding-window ring caches "
                         "are unsupported (absolute positions only)")
    b, t, _ = x.shape
    dev = x.device
    wpos = pos[:, None] + torch.arange(t, device=dev)            # (B, T)
    q, k, v = _project_qkv(params, x, num_heads, num_kv_heads, head_dim)
    if pos_embed == "rope":
        q = apply_rope(q, wpos, rope_theta)
        k = apply_rope(k, wpos, rope_theta)
    if page_map is not None:
        p = cache["k"].shape[1]                                  # page size
        # a padded last chunk may run past the slot's last logical page:
        # those rows go to the trash page below (JAX's gather clamps too)
        lpage = (wpos // p).clamp_max(page_map.shape[1] - 1)
        phys = torch.gather(page_map, 1, lpage)                  # (B, T)
        if valid_len is not None:
            live = torch.arange(t, device=dev)[None] < valid_len[:, None]
            phys = torch.where(live, phys, torch.zeros_like(phys))
        off = wpos % p
        cache["k"][phys, off] = k.to(cache["k"].dtype)
        cache["v"][phys, off] = v.to(cache["v"].dtype)
        vk = cache["k"][page_map].reshape(b, -1, num_kv_heads, head_dim)
        vv = cache["v"][page_map].reshape(b, -1, num_kv_heads, head_dim)
    else:
        rows = torch.arange(b, device=dev)[:, None]
        cache["k"][rows, wpos] = k.to(cache["k"].dtype)
        cache["v"][rows, wpos] = v.to(cache["v"].dtype)
        vk, vv = cache["k"], cache["v"]
    idx = torch.arange(vk.shape[1], device=dev)
    mask = idx[None, None, :] <= wpos[:, :, None]                # (B, T, C)
    if pad_len is not None:
        mask = mask & (idx[None, None, :] >= pad_len[:, None, None])
    out = _sdpa(q, vk, vv, mask, attn_softcap)
    return out.reshape(b, t, num_heads * head_dim) @ params["wo"], cache


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder)
# ---------------------------------------------------------------------------

def cross_attn_init(gen: torch.Generator, d: int, num_heads: int,
                    head_dim: int, dtype=DTYPE, lead=()):
    """``wq`` / ``wk`` / ``wv`` / ``wo`` with as many KV heads as heads."""
    return {"wq": dense_init(gen, d, num_heads * head_dim, dtype, lead),
            "wk": dense_init(gen, d, num_heads * head_dim, dtype, lead),
            "wv": dense_init(gen, d, num_heads * head_dim, dtype, lead),
            "wo": dense_init(gen, num_heads * head_dim, d, dtype, lead)}


def cross_attn(params, x, memory, *, num_heads, head_dim):
    """x: (B, S, d) queries; memory: (B, T, d), every key visible (no
    causal mask)."""
    b, s, _ = x.shape
    t = memory.shape[1]
    q = (x @ params["wq"]).reshape(b, s, num_heads, head_dim)
    k = (memory @ params["wk"]).reshape(b, t, num_heads, head_dim)
    v = (memory @ params["wv"]).reshape(b, t, num_heads, head_dim)
    mask = torch.ones((1, 1, 1, t), dtype=torch.bool, device=x.device)
    out = _sdpa(q, k, v, mask).reshape(b, s, num_heads * head_dim)
    return out @ params["wo"]
