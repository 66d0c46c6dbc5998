"""Per-layer blocks.

Port of the attention-family blocks of ``repro/models/blocks.py``
(``_attn_block_train`` / ``_prefill`` / ``_decode`` / ``_decode_span`` /
``_cache``): GQA attention + MLP with residuals, pre-norm, and gemma2's
sandwich norms (``pn1`` / ``pn2`` after each sublayer) when
``cfg.post_norm``; and the tensor-parallel twin
:func:`attn_block_train_tp`.  Kinds:

  dense        GQA attention (``cfg.window`` if any) + MLP
  attn_local   sliding-window attention, ``cfg.window or 4096``
               (gemma2's even layers), a ring cache of min(window, C)
  attn_global  full attention (gemma2's odd layers)
  moe          GQA attention + the MoE FFN (``models/moe.py``; mixtral,
               llama4's odd layers): capacity routing in training, dropless
               (dense) routing in prefill and span decode, and through
               ``s == 1`` in single-token decode

rwkv and hymba are not ported yet and raise.

Uniform interface, params stacked per group by the caller:
  block_init(gen, cfg, kind, groups)                   -> stacked params
  block_train(p, x, cfg, kind)                         -> (y, aux_loss)
  block_prefill(p, x, cfg, kind, cache_len, pad_mask)  -> (y, cache)
  block_decode(p, x1, cache, pos, cfg, kind, pad_len)  -> (y, cache)
  block_decode_span(p, x, cache, pos, cfg, kind, pad_len, page_map,
                    valid_len)                         -> (y, cache)
  block_cache(cfg, kind, batch, cache_len, dtype, device)
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models.common import (DTYPE, dense_init, mlp_apply, mlp_init,
                                       norm_apply, norm_init)
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import moe_apply, moe_init

PORTED_KINDS = ("dense", "attn_local", "attn_global", "moe")


def _check_kind(kind: str):
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"layer kind {kind!r} is not yet ported "
                                  f"to repro_torch (ported: {PORTED_KINDS})")


def _attn_kwargs(cfg: ModelConfig, kind: str):
    window = cfg.window
    if kind == "attn_local":
        window = cfg.window or 4096
    elif kind == "attn_global":
        window = None
    return dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim, pos_embed=cfg.pos_embed,
                rope_theta=cfg.rope_theta, window=window,
                attn_softcap=cfg.attn_softcap)


def block_init(gen, cfg: ModelConfig, kind: str, groups: int):
    _check_kind(kind)
    d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd, lead = cfg.resolved_head_dim, (groups,)
    p = {"ln1": norm_init(d, cfg.norm, gen.device, lead),
         "ln2": norm_init(d, cfg.norm, gen.device, lead),
         "attn": {"wq": dense_init(gen, d, h * hd, DTYPE, lead),
                  "wk": dense_init(gen, d, kv * hd, DTYPE, lead),
                  "wv": dense_init(gen, d, kv * hd, DTYPE, lead),
                  "wo": dense_init(gen, h * hd, d, DTYPE, lead)}}
    if cfg.post_norm:
        p["pn1"] = norm_init(d, cfg.norm, gen.device, lead)
        p["pn2"] = norm_init(d, cfg.norm, gen.device, lead)
    if kind == "moe":
        p["moe"] = moe_init(gen, d, cfg.d_ff, cfg.num_experts, cfg.mlp,
                            cfg.num_shared_experts, DTYPE, lead)
    else:
        p["mlp"] = mlp_init(gen, d, cfg.d_ff, cfg.mlp, DTYPE, lead)
    return p


def _maybe_post(p, name, h, cfg: ModelConfig):
    """gemma2's post-sublayer norm ``name`` on ``h`` when ``post_norm``."""
    return norm_apply(p[name], h, cfg.norm) if cfg.post_norm else h


def _ffn(p, h, cfg: ModelConfig, kind: str, dropless: bool = False):
    """The block's FFN: ``(y, aux)``, the MoE's load-balance loss or 0."""
    if kind == "moe":
        return moe_apply(p["moe"], h, num_experts=cfg.num_experts,
                         top_k=cfg.top_k, mlp_kind=cfg.mlp,
                         capacity_factor=cfg.capacity_factor,
                         dispatch_quant=cfg.moe_dispatch_quant,
                         dropless=dropless)
    return (mlp_apply(p["mlp"], h, cfg.mlp),
            h.new_zeros((), dtype=torch.float32))


def _attn_block_train(p, x, cfg: ModelConfig, kind: str):
    h = A.attn_train(p["attn"], norm_apply(p["ln1"], x, cfg.norm),
                     **_attn_kwargs(cfg, kind))
    x = x + _maybe_post(p, "pn1", h, cfg)
    h, aux = _ffn(p, norm_apply(p["ln2"], x, cfg.norm), cfg, kind)
    return x + _maybe_post(p, "pn2", h, cfg), aux


# Block kinds whose weights shard over the tensor ring (the dense family:
# heads over tp for attention, d_ff over tp for the MLP).  moe routes its
# parallelism over experts and stays off the compressed TP path.
TP_BLOCK_KINDS = ("dense", "attn_local", "attn_global")


def attn_block_train_tp(ps, xs, cfg: ModelConfig, kind: str, tpc,
                        bufs=(None, None), remat: bool = False):
    """The dense block on the ranks' SEQUENCE-SHARDED residuals ``xs``
    (Megatron-SP layout), every rank in lock step: norms and residual adds
    run on each shard; the attention and MLP in-gathers cross the
    compressed tensor wire and the partial outputs reduce-scatter back
    (``transport/tp_collectives.py``).

    ``ps``: the ranks' weights (``transport/tp_collectives.tp_local``);
    ``bufs``: this block's two per-site feedback buffers (attention
    gather, MLP gather) or Nones.  ``remat`` recomputes each rank's
    attention and MLP in the backward pass, never a collective."""
    if kind not in TP_BLOCK_KINDS:
        raise ValueError(
            f"tensor parallelism covers the dense family "
            f"{TP_BLOCK_KINDS}, got kind={kind!r}")
    _check_kind(kind)
    b1, b2 = bufs
    hs, b1 = A.attn_train_tp([p["attn"] for p in ps],
                             [norm_apply(p["ln1"], x, cfg.norm)
                              for p, x in zip(ps, xs)],
                             tpc, buf=b1, remat=remat,
                             **_attn_kwargs(cfg, kind))
    xs = [x + _maybe_post(p, "pn1", h, cfg) for p, x, h in zip(ps, xs, hs)]
    fulls, b2 = tpc.gather_site([norm_apply(p["ln2"], x, cfg.norm)
                                 for p, x in zip(ps, xs)], b2)

    def local(p, full):
        return mlp_apply(p, full, cfg.mlp)

    partials = [checkpoint(local, p["mlp"], f, use_reentrant=False) if remat
                else local(p["mlp"], f) for p, f in zip(ps, fulls)]
    hs = tpc.scatter(partials)
    return ([x + _maybe_post(p, "pn2", h, cfg)
             for p, x, h in zip(ps, xs, hs)], (b1, b2))


def _attn_block_prefill(p, x, cfg: ModelConfig, kind: str, cache_len: int,
                        pad_mask=None):
    h, cache = A.attn_prefill(p["attn"], norm_apply(p["ln1"], x, cfg.norm),
                              cache_len=cache_len, pad_mask=pad_mask,
                              **_attn_kwargs(cfg, kind))
    x = x + _maybe_post(p, "pn1", h, cfg)
    # inference: dropless routing, so decode continuations match prefill
    h, _ = _ffn(p, norm_apply(p["ln2"], x, cfg.norm), cfg, kind,
                dropless=True)
    return x + _maybe_post(p, "pn2", h, cfg), cache


def _attn_block_decode(p, x1, cache, pos, cfg: ModelConfig, kind: str,
                       pad_len=None):
    h, cache = A.attn_decode(p["attn"], norm_apply(p["ln1"], x1, cfg.norm),
                             cache, pos, pad_len=pad_len,
                             **_attn_kwargs(cfg, kind))
    x1 = x1 + _maybe_post(p, "pn1", h, cfg)
    # one token a row: the MoE routes densely through s == 1
    h, _ = _ffn(p, norm_apply(p["ln2"], x1, cfg.norm), cfg, kind)
    return x1 + _maybe_post(p, "pn2", h, cfg), cache


def _attn_block_decode_span(p, x, cache, pos, cfg: ModelConfig, kind: str,
                            pad_len=None, page_map=None, valid_len=None):
    h, cache = A.attn_decode_span(
        p["attn"], norm_apply(p["ln1"], x, cfg.norm), cache, pos,
        pad_len=pad_len, page_map=page_map, valid_len=valid_len,
        **_attn_kwargs(cfg, kind))
    x = x + _maybe_post(p, "pn1", h, cfg)
    # dropless, as the T = 1 decode: span and per-token decode see the
    # same expert math
    h, _ = _ffn(p, norm_apply(p["ln2"], x, cfg.norm), cfg, kind,
                dropless=True)
    return x + _maybe_post(p, "pn2", h, cfg), cache


def _attn_block_cache(cfg: ModelConfig, kind: str, batch: int,
                      cache_len: int, dtype, device):
    """``cache_len`` rows, or a ring of min(window, cache_len) rows."""
    window = _attn_kwargs(cfg, kind)["window"]
    c = cache_len if window is None else min(window, cache_len)
    return A.init_cache(batch, c, cfg.num_kv_heads, cfg.resolved_head_dim,
                        dtype, device)


def block_train(p, x, cfg: ModelConfig, kind: str):
    """Returns (y, aux_loss): the MoE's load-balance loss, 0 for the
    dense kinds."""
    _check_kind(kind)
    return _attn_block_train(p, x, cfg, kind)


def block_prefill(p, x, cfg: ModelConfig, kind: str, cache_len: int,
                  pad_mask=None):
    """``pad_mask``: (B, S) bool, True = real token."""
    _check_kind(kind)
    return _attn_block_prefill(p, x, cfg, kind, cache_len, pad_mask)


def block_decode(p, x1, cache, pos, cfg: ModelConfig, kind: str,
                 pad_len=None):
    """``pos``: an int or a (B,) tensor of per-slot positions;
    ``pad_len``: (B,) — cache slots before it are left-padding."""
    _check_kind(kind)
    return _attn_block_decode(p, x1, cache, pos, cfg, kind, pad_len)


def block_decode_span(p, x, cache, pos, cfg: ModelConfig, kind: str,
                      pad_len=None, page_map=None, valid_len=None):
    """Multi-token decode over a slab or paged KV cache (see
    attention.attn_decode_span).  Attention kinds only."""
    _check_kind(kind)
    return _attn_block_decode_span(p, x, cache, pos, cfg, kind, pad_len,
                                   page_map, valid_len)


def block_cache(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                dtype=DTYPE, device=None):
    _check_kind(kind)
    return _attn_block_cache(cfg, kind, batch, cache_len, dtype, device)
