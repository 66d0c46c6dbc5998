"""GQA attention: full-sequence training, prefill, and one-token decode
over a KV cache.

Port of ``repro/models/attention.py`` (full attention).  The reference has
no Pallas attention, so this is plain torch ops following ``_sdpa_block``'s
arithmetic: bf16 einsums, fp32 logits / sqrt(hd), -1e30 mask, fp32 softmax
cast back to bf16, queries in chunks of ``_qchunk`` beyond 2048 tokens.
Sliding windows and softcaps are not ported yet.

Cache layout: ``{"k": (B, C, KV, hd), "v": (B, C, KV, hd)}``, RoPE applied
at write time, or a page pool ``(N, P, KV, hd)`` read through a page map
(:func:`attn_decode_span`).  :func:`attn_decode` and
:func:`attn_decode_span` write the new K/V rows IN PLACE (the reference
returns a new cache; its engine donates the old one).
:func:`attn_train_tp` is the head-sharded attention of the tensor axis.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import DTYPE, apply_rope

_MASKED = -1e30


def _project_qkv(params, x, num_heads, num_kv_heads, head_dim):
    b, s, _ = x.shape
    q = (x @ params["wq"]).reshape(b, s, num_heads, head_dim)
    k = (x @ params["wk"]).reshape(b, s, num_kv_heads, head_dim)
    v = (x @ params["wv"]).reshape(b, s, num_kv_heads, head_dim)
    return q, k, v


def _sdpa_block(q, k, v, mask):
    """q: (B,S,H,hd); k,v: (B,T,KV,hd); mask (B|1, S, T) or broadcastable
    to the (B, KV, G, S, T) logits."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).to(torch.float32)
    logits = logits / torch.sqrt(torch.tensor(hd, dtype=torch.float32))
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


def _sdpa(q, k, v, mask):
    s = q.shape[1]
    qc = _qchunk(s)
    if qc >= s:
        return _sdpa_block(q, k, v, mask)
    outs = []
    for i in range(0, s, qc):
        mi = mask[:, i:i + qc] if mask.ndim == 3 else mask
        outs.append(_sdpa_block(q[:, i:i + qc], k, v, mi))
    return torch.cat(outs, dim=1)


def _causal_mask(positions: torch.Tensor) -> torch.Tensor:
    """(1, S, S) bool: key position <= query position."""
    return (positions[None, :] <= positions[:, None])[None]


def _attend(params, x, num_heads, num_kv_heads, head_dim, pos_embed,
            rope_theta, pad_mask):
    """Causal self-attention over ``x``: (output, RoPE'd keys, values)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(params, x, num_heads, num_kv_heads, head_dim)
    if pos_embed == "rope":
        q = apply_rope(q, positions[None], rope_theta)
        k = apply_rope(k, positions[None], rope_theta)
    mask = _causal_mask(positions)
    if pad_mask is not None:
        mask = mask & pad_mask[:, None, :]                       # (B, S, S)
    out = _sdpa(q, k, v, mask).reshape(b, s, num_heads * head_dim)
    return out @ params["wo"], k, v


def attn_train(params, x, *, num_heads, num_kv_heads, head_dim,
               pos_embed="rope", rope_theta=10_000.0, pad_mask=None):
    """Full-sequence causal self-attention.  ``pad_mask``: optional (B, S)
    bool, True = real token; pad keys are masked out of every query."""
    return _attend(params, x, num_heads, num_kv_heads, head_dim, pos_embed,
                   rope_theta, pad_mask)[0]


def tp_local_heads(num_heads, num_kv_heads, tp):
    """Per-rank head counts for tp-way head-sharded attention."""
    if num_heads % tp or num_kv_heads % tp:
        raise ValueError(
            f"tensor parallelism shards attention heads: num_heads "
            f"{num_heads} and num_kv_heads {num_kv_heads} must both be "
            f"divisible by tp={tp}")
    return num_heads // tp, num_kv_heads // tp


def attn_train_tp(ps, xs, tpc, *, num_heads, num_kv_heads, head_dim,
                  pos_embed="rope", rope_theta=10_000.0, buf=None,
                  remat=False):
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
                          rope_theta=rope_theta)

    partials = [checkpoint(local, p, f, use_reentrant=False) if remat
                else local(p, f) for p, f in zip(ps, fulls)]
    return tpc.scatter(partials), buf


def init_cache(batch: int, cache_len: int, num_kv_heads: int, head_dim: int,
               dtype=DTYPE, device=None):
    shape = (batch, cache_len, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_prefill(params, x, *, cache_len, num_heads, num_kv_heads, head_dim,
                 pos_embed="rope", rope_theta=10_000.0, pad_mask=None):
    """Full-sequence causal attention that also fills a new cache.
    ``pad_mask``: optional (B, S) bool, True = real token (left-padded
    serving batches: pad keys are masked out of every query)."""
    b, s, _ = x.shape
    out, k, v = _attend(params, x, num_heads, num_kv_heads, head_dim,
                        pos_embed, rope_theta, pad_mask)
    cache = init_cache(b, cache_len, num_kv_heads, head_dim, k.dtype,
                       x.device)
    c = min(cache_len, s)
    cache["k"][:, :c] = k[:, s - c:]
    cache["v"][:, :c] = v[:, s - c:]
    return out, cache


def attn_decode(params, x1, cache, pos, *, num_heads, num_kv_heads,
                head_dim, pos_embed="rope", rope_theta=10_000.0,
                pad_len=None):
    """One-token decode.  x1: (B, 1, d); ``pos``: the new token's index,
    an int (the same for every row) or a (B,) tensor, one position per
    slot (continuous batching: each slot decodes its own request at its
    own position, its K/V scattered one row per slot).  ``pad_len``:
    optional (B,) — cache slots before it are left-padding and masked
    out.  Writes K/V in place."""
    b = x1.shape[0]
    c = cache["k"].shape[1]
    per_slot = isinstance(pos, torch.Tensor)
    q, k, v = _project_qkv(params, x1, num_heads, num_kv_heads, head_dim)
    if pos_embed == "rope":
        posb = pos[:, None] if per_slot else torch.full((1, 1), pos,
                                                        device=x1.device)
        q = apply_rope(q, posb, rope_theta)
        k = apply_rope(k, posb, rope_theta)
    idx = torch.arange(c, device=x1.device)
    if per_slot:
        rows = torch.arange(b, device=x1.device)
        cache["k"][rows, pos] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, pos] = v[:, 0].to(cache["v"].dtype)
        valid = idx[None] <= pos[:, None]                        # (B, C)
    else:
        cache["k"][:, pos] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, pos] = v[:, 0].to(cache["v"].dtype)
        valid = (idx <= pos)[None]                               # (1, C)
    if pad_len is not None:
        valid = valid & (idx[None] >= pad_len[:, None])          # (B, C)
    mask = valid[:, None, None, None, :]                # (B|1,1,1,1,C)
    out = _sdpa_block(q, cache["k"], cache["v"], mask)
    return out.reshape(b, 1, num_heads * head_dim) @ params["wo"], cache


def attn_decode_span(params, x, cache, pos, *, num_heads, num_kv_heads,
                     head_dim, pos_embed="rope", rope_theta=10_000.0,
                     pad_len=None, page_map=None, valid_len=None):
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
    absolute positions)."""
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
    out = _sdpa(q, vk, vv, mask)
    return out.reshape(b, t, num_heads * head_dim) @ params["wo"], cache
