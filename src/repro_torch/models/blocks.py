"""Per-layer blocks.

Port of ``repro/models/blocks.py``: the attention-family blocks
(``_attn_block_train`` / ``_prefill`` / ``_decode`` / ``_decode_span`` /
``_cache``: GQA attention + MLP with residuals, pre-norm, and gemma2's
sandwich norms (``pn1`` / ``pn2`` after each sublayer) when
``cfg.post_norm``; the tensor-parallel twin :func:`attn_block_train_tp`),
the RWKV6 (Finch) block and hymba's block.  Kinds:

  dense        GQA attention (``cfg.window`` if any) + MLP
  attn_local   sliding-window attention, ``cfg.window or 4096``
               (gemma2's even layers), a ring cache of min(window, C)
  attn_global  full attention (gemma2's odd layers)
  moe          GQA attention + the MoE FFN (``models/moe.py``; mixtral,
               llama4's odd layers): capacity routing in training, dropless
               (dense) routing in prefill and span decode, and through
               ``s == 1`` in single-token decode
  rwkv         RWKV6 time mix (token shift, the 5-way LoRA mix, the decay
               LoRA, the bonus ``u``, a per-head group norm) + channel
               mix; the chunked linear attention of ``models/linattn.py``
  hymba        windowed GQA heads beside Mamba2/SSD heads (scalar decay a
               head, the include-current chunked form), then an MLP

The recurrent kinds (rwkv, hymba's SSD heads) start from zero state in
training, ignore left-padding in prefill (it would enter their state, so
the serving engines keep them to equal-length batches) and carry their
state in the cache: decode writes it IN PLACE into the cache views it
is given, as attention writes its K/V rows.

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
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models.common import (DTYPE, dense_init, mlp_apply, mlp_init,
                                       norm_apply, norm_init)
from repro_torch.models.config import ModelConfig
from repro_torch.models.linattn import (chunked_linear_attention,
                                        linear_attention_decode)
from repro_torch.models.moe import moe_apply, moe_init

ATTN_KINDS = ("dense", "attn_local", "attn_global", "moe")
PORTED_KINDS = ATTN_KINDS + ("rwkv", "hymba")
RWKV_LORA = 32
RWKV_DECAY_LORA = 64
RWKV_HEAD = 64          # rwkv6 head size (K == V == 64)


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
    if kind == "rwkv":
        return _rwkv_block_init(gen, cfg, (groups,))
    p = _attn_block_init(gen, cfg, kind, (groups,))
    if kind == "hymba":
        _hymba_block_init(gen, cfg, p, (groups,))
    return p


def _attn_block_init(gen, cfg: ModelConfig, kind: str, lead):
    d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
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


# ===========================================================================
# RWKV6 (Finch) block
# ===========================================================================

def _rwkv_heads(cfg: ModelConfig):
    hs = cfg.ssm_state or RWKV_HEAD
    assert cfg.d_model % hs == 0
    return cfg.d_model // hs, hs            # (H, head_size)


def _rwkv_block_init(gen, cfg: ModelConfig, lead):
    """The reference's leaves; ``w0`` (a power of ``arange``) and the
    constants are its values, computed in f32 in the same order."""
    d, ff = cfg.d_model, cfg.d_ff
    h, hs = _rwkv_heads(cfg)
    f32, dev = torch.float32, gen.device

    def full(shape, value):
        return torch.full((*lead, *shape), value, dtype=f32, device=dev)

    def normal(shape, scale):
        return torch.randn((*lead, *shape), generator=gen, dtype=f32,
                           device=dev).mul_(scale)

    # decay base: spread in [-6, -0.3] across channels (rwkv init)
    dec = -6.0 + 5.7 * (torch.arange(d, dtype=f32, device=dev)
                        / max(d - 1, 1)) ** 1.3
    return {
        "ln1": norm_init(d, cfg.norm, dev, lead),
        "ln2": norm_init(d, cfg.norm, dev, lead),
        "tm": {
            "mu_x": full((d,), 0.5),
            "mu": full((5, d), 0.5),                            # r,k,v,g,w
            "lora_A": dense_init(gen, d, 5 * RWKV_LORA, f32, lead),
            "lora_B": normal((5, RWKV_LORA, d), 0.01),
            "wr": dense_init(gen, d, d, DTYPE, lead),
            "wk": dense_init(gen, d, d, DTYPE, lead),
            "wv": dense_init(gen, d, d, DTYPE, lead),
            "wg": dense_init(gen, d, d, DTYPE, lead),
            "wo": dense_init(gen, d, d, DTYPE, lead),
            "w0": dec.expand(*lead, d).clone(),
            "w_lora_A": dense_init(gen, d, RWKV_DECAY_LORA, f32, lead),
            "w_lora_B": normal((RWKV_DECAY_LORA, d), 0.01),
            "u": normal((h, hs), 0.1),
            "gn_scale": full((d,), 1.0),
            "gn_bias": full((d,), 0.0),
        },
        "cm": {
            "mu_k": full((d,), 0.5),
            "mu_r": full((d,), 0.5),
            "wk": dense_init(gen, d, ff, DTYPE, lead),
            "wv": dense_init(gen, ff, d, DTYPE, lead),
            "wr": dense_init(gen, d, d, DTYPE, lead),
        },
    }


def _sigmoid(x):
    """``jax.nn.sigmoid`` as the reference's graph computes it in x's
    dtype: 1 / (1 + exp(-x)), each op rounded (``torch.sigmoid`` rounds
    once and parts from it on a third of bf16 inputs)."""
    return 1 / (1 + torch.exp(-x))


def _silu(x):
    """``jax.nn.silu``: x * sigmoid(x), each op rounded as the
    reference's."""
    return x * _sigmoid(x)


def _shift(x, state):
    """x: (B, S, d); state: (B, d), the previous token (zeros at start)."""
    return torch.cat([state[:, None], x[:, :-1]], dim=1)


def _rwkv_time_mix(tm, x, sx, cfg: ModelConfig, state, decode: bool):
    """x: (B, S, d); sx: shifted x; state: (B, H, K, V).  The LoRA and
    decay paths in f32, the r / k / v / g projections in x's dtype."""
    b, s, d = x.shape
    h, hs = _rwkv_heads(cfg)
    f32 = torch.float32
    xf = x.to(f32)
    dx = sx.to(f32) - xf
    xx = xf + dx * tm["mu_x"]
    lora = torch.tanh(xx @ tm["lora_A"]).reshape(b, s, 5, RWKV_LORA)
    delta = torch.einsum("bsfr,frd->bsfd", lora, tm["lora_B"])  # (B,S,5,d)
    mixed = xf[:, :, None] + dx[:, :, None] * (tm["mu"] + delta)
    xr, xk, xv, xg, xw = (mixed[:, :, i].to(x.dtype) for i in range(5))

    def heads(t):
        return t.reshape(b, s, h, hs).transpose(1, 2)           # (B,H,S,K)

    r, k, v = heads(xr @ tm["wr"]), heads(xk @ tm["wk"]), heads(xv @ tm["wv"])
    g = _silu(xg @ tm["wg"])
    log_w = -torch.exp(tm["w0"] + torch.tanh(xw.to(f32) @ tm["w_lora_A"])
                       @ tm["w_lora_B"])                        # (B,S,d) <= 0
    log_w = heads(log_w)

    if decode:
        y, new_state = linear_attention_decode(
            r[:, :, 0], k[:, :, 0], v[:, :, 0], log_w[:, :, 0], state,
            bonus=tm["u"])
        y = y[:, None]                                          # (B,1,H,V)
    else:
        y, new_state = chunked_linear_attention(
            r, k, v, log_w, bonus=tm["u"], initial_state=state)
        y = y.transpose(1, 2)                                   # (B,S,H,V)

    # per-head group norm (the population variance)
    yf = y.to(f32)
    mu = yf.mean(-1, keepdim=True)
    var = ((yf - mu) ** 2).mean(-1, keepdim=True)
    yf = (yf - mu) * torch.rsqrt(var + 64e-5)
    yf = yf.reshape(b, -1, d) * tm["gn_scale"] + tm["gn_bias"]
    return (yf.to(x.dtype) * g) @ tm["wo"], new_state


def _rwkv_channel_mix(cm, x, sx):
    xf = x.to(torch.float32)
    dx = sx.to(torch.float32) - xf
    xk = (xf + dx * cm["mu_k"]).to(x.dtype)
    xr = (xf + dx * cm["mu_r"]).to(x.dtype)
    kk = torch.square(F.relu(xk @ cm["wk"]))
    return _sigmoid(xr @ cm["wr"]) * (kk @ cm["wv"])


def _rwkv_block_train(p, x, cfg: ModelConfig):
    """From zero state: ``(y, cache)``, the cache the state after the
    last token."""
    state = _rwkv_block_cache(cfg, x.shape[0], x.dtype, x.device)
    xn = norm_apply(p["ln1"], x, cfg.norm)
    h, new_s = _rwkv_time_mix(p["tm"], xn, _shift(xn, state["tm"]), cfg,
                              state["S"], decode=False)
    x = x + h
    xn2 = norm_apply(p["ln2"], x, cfg.norm)
    x = x + _rwkv_channel_mix(p["cm"], xn2, _shift(xn2, state["cm"]))
    return x, {"S": new_s, "tm": xn[:, -1], "cm": xn2[:, -1]}


def _rwkv_block_decode(p, x1, cache, cfg: ModelConfig):
    """One token; the new state written into ``cache`` in place."""
    xn = norm_apply(p["ln1"], x1, cfg.norm)
    h, new_s = _rwkv_time_mix(p["tm"], xn, cache["tm"][:, None], cfg,
                              cache["S"], decode=True)
    x1 = x1 + h
    xn2 = norm_apply(p["ln2"], x1, cfg.norm)
    x1 = x1 + _rwkv_channel_mix(p["cm"], xn2, cache["cm"][:, None])
    cache["S"].copy_(new_s)
    cache["tm"].copy_(xn[:, 0])
    cache["cm"].copy_(xn2[:, 0])
    return x1, cache


def _rwkv_block_cache(cfg: ModelConfig, batch, dtype, device):
    h, hs = _rwkv_heads(cfg)
    return {"S": torch.zeros((batch, h, hs, hs), dtype=torch.float32,
                             device=device),
            "tm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                              device=device),
            "cm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                              device=device)}


# ===========================================================================
# Hymba block: windowed GQA attention beside Mamba2/SSD heads
# ===========================================================================

def _hymba_dims(cfg: ModelConfig):
    nh = cfg.ssm_heads or cfg.num_heads
    return nh, cfg.resolved_head_dim, cfg.ssm_state or 16   # (heads, hd, N)


def _hymba_block_init(gen, cfg: ModelConfig, p, lead):
    """Adds the SSD heads and the two output norms to the attention
    block's params ``p``; ``a_log`` is log(linspace(1, 8, heads)), the
    linspace rounded once from float64."""
    d = cfg.d_model
    nh, hd, n = _hymba_dims(cfg)
    sd = nh * hd
    f32, dev = torch.float32, gen.device
    a_log = torch.log(torch.linspace(1.0, 8.0, nh, dtype=torch.float64,
                                     device=dev).to(f32))
    p["ssm"] = {
        "in_proj": dense_init(gen, d, 2 * sd, DTYPE, lead),
        "w_dt": dense_init(gen, d, nh, f32, lead),
        "dt_bias": torch.zeros((*lead, nh), dtype=f32, device=dev),
        "w_b": dense_init(gen, d, n, DTYPE, lead),
        "w_c": dense_init(gen, d, n, DTYPE, lead),
        "a_log": a_log.expand(*lead, nh).clone(),               # decay rates
        "d_skip": torch.ones((*lead, nh), dtype=f32, device=dev),
        "out_proj": dense_init(gen, sd, d, DTYPE, lead),
    }
    p["ln_attn_out"] = norm_init(d, cfg.norm, dev, lead)
    p["ln_ssm_out"] = norm_init(d, cfg.norm, dev, lead)


def _ssd_project(ssm, x, cfg: ModelConfig):
    """dt, B, C and the dt-scaled v in f32; softplus as ``logaddexp(x,
    0)`` (``F.softplus`` turns linear above its threshold)."""
    b, s, d = x.shape
    nh, hd, n = _hymba_dims(cfg)
    f32 = torch.float32
    xs, z = (x @ ssm["in_proj"]).chunk(2, dim=-1)              # (B,S,sd)
    pre = x.to(f32) @ ssm["w_dt"] + ssm["dt_bias"]
    dt = torch.logaddexp(pre, torch.zeros_like(pre))            # (B,S,H)
    log_w = -torch.exp(ssm["a_log"]) * dt                       # (B,S,H)
    bb = (x @ ssm["w_b"]).to(f32)                               # (B,S,N)
    cc = (x @ ssm["w_c"]).to(f32)                               # (B,S,N)
    xh = xs.reshape(b, s, nh, hd).to(f32)
    return z, xh * dt[..., None], bb, cc, log_w, xh


def _ssd_out(ssm, y, xh, z, x):
    b, s = x.shape[:2]
    y = y + ssm["d_skip"][None, None, :, None] * xh
    return (y.reshape(b, s, -1).to(x.dtype) * _silu(z)) @ ssm["out_proj"]


def _hymba_ssm_train(ssm, x, cfg: ModelConfig, state):
    b, s, _ = x.shape
    nh, hd, n = _hymba_dims(cfg)
    z, v, bb, cc, log_w, xh = _ssd_project(ssm, x, cfg)
    q = cc[:, None].expand(b, nh, s, n)
    k = bb[:, None].expand(b, nh, s, n)
    w = log_w.transpose(1, 2)[..., None].expand(b, nh, s, n)
    y, new_state = chunked_linear_attention(q, k, v.transpose(1, 2), w,
                                            initial_state=state)
    return _ssd_out(ssm, y.transpose(1, 2), xh, z, x), new_state


def _hymba_ssm_decode(ssm, x1, cfg: ModelConfig, state):
    b = x1.shape[0]
    nh, hd, n = _hymba_dims(cfg)
    z, v, bb, cc, log_w, xh = _ssd_project(ssm, x1, cfg)
    q = cc[:, 0, None].expand(b, nh, n)
    k = bb[:, 0, None].expand(b, nh, n)
    w = log_w[:, 0, :, None].expand(b, nh, n)
    y, new_state = linear_attention_decode(q, k, v[:, 0], w, state)
    return _ssd_out(ssm, y[:, None], xh, z, x1), new_state


def _hymba_mix(p, x, h_attn, h_ssm, cfg: ModelConfig):
    """The two branches' normed mean into the residual, then the MLP."""
    h = 0.5 * (norm_apply(p["ln_attn_out"], h_attn, cfg.norm)
               + norm_apply(p["ln_ssm_out"], h_ssm, cfg.norm))
    x = x + h
    return x + mlp_apply(p["mlp"], norm_apply(p["ln2"], x, cfg.norm),
                         cfg.mlp)


def _hymba_block_train(p, x, cfg: ModelConfig):
    """From zero SSD state: ``(y, final SSD state)``."""
    state = _hymba_block_cache(cfg, x.shape[0], 0, x.dtype,
                               x.device)["ssm"]
    xn = norm_apply(p["ln1"], x, cfg.norm)
    h_attn = A.attn_train(p["attn"], xn, **_attn_kwargs(cfg, "dense"))
    h_ssm, new_s = _hymba_ssm_train(p["ssm"], xn, cfg, state)
    return _hymba_mix(p, x, h_attn, h_ssm, cfg), new_s


def _hymba_block_prefill(p, x, cfg: ModelConfig, cache_len: int,
                         pad_mask=None):
    state = _hymba_block_cache(cfg, x.shape[0], 0, x.dtype,
                               x.device)["ssm"]
    xn = norm_apply(p["ln1"], x, cfg.norm)
    h_attn, kv = A.attn_prefill(p["attn"], xn, cache_len=cache_len,
                                pad_mask=pad_mask,
                                **_attn_kwargs(cfg, "dense"))
    h_ssm, new_s = _hymba_ssm_train(p["ssm"], xn, cfg, state)
    return (_hymba_mix(p, x, h_attn, h_ssm, cfg),
            {"k": kv["k"], "v": kv["v"], "ssm": new_s})


def _hymba_block_decode(p, x1, cache, pos, cfg: ModelConfig):
    """One token: K/V rows and the SSD state written into ``cache`` in
    place.  The attention takes no ``pad_len``, as in the reference."""
    xn = norm_apply(p["ln1"], x1, cfg.norm)
    h_attn, _ = A.attn_decode(p["attn"], xn, {"k": cache["k"],
                                              "v": cache["v"]},
                              pos, **_attn_kwargs(cfg, "dense"))
    h_ssm, new_s = _hymba_ssm_decode(p["ssm"], xn, cfg, cache["ssm"])
    cache["ssm"].copy_(new_s)
    return _hymba_mix(p, x1, h_attn, h_ssm, cfg), cache


def _hymba_block_cache(cfg: ModelConfig, batch, cache_len, dtype, device):
    nh, hd, n = _hymba_dims(cfg)
    c = {"ssm": torch.zeros((batch, nh, n, hd), dtype=torch.float32,
                            device=device)}
    if cache_len:
        c.update(_attn_block_cache(cfg, "dense", batch, cache_len, dtype,
                                   device))
    return c


# ===========================================================================
# Dispatch
# ===========================================================================

def block_train(p, x, cfg: ModelConfig, kind: str):
    """Returns (y, aux_loss): the MoE's load-balance loss, 0 for the
    other kinds.  Recurrent kinds start from zero state."""
    _check_kind(kind)
    if kind == "rwkv":
        return _rwkv_block_train(p, x, cfg)[0], _no_aux(x)
    if kind == "hymba":
        return _hymba_block_train(p, x, cfg)[0], _no_aux(x)
    return _attn_block_train(p, x, cfg, kind)


def _no_aux(x):
    return x.new_zeros((), dtype=torch.float32)


def block_prefill(p, x, cfg: ModelConfig, kind: str, cache_len: int,
                  pad_mask=None):
    """``pad_mask``: (B, S) bool, True = real token (attention only:
    rwkv and hymba's SSD heads carry their state through pads)."""
    _check_kind(kind)
    if kind == "rwkv":
        return _rwkv_block_train(p, x, cfg)
    if kind == "hymba":
        return _hymba_block_prefill(p, x, cfg, cache_len, pad_mask)
    return _attn_block_prefill(p, x, cfg, kind, cache_len, pad_mask)


def block_decode(p, x1, cache, pos, cfg: ModelConfig, kind: str,
                 pad_len=None):
    """``pos``: an int or a (B,) tensor of per-slot positions;
    ``pad_len``: (B,) — cache slots before it are left-padding (attention
    kinds only).  The cache is updated in place and returned."""
    _check_kind(kind)
    if kind == "rwkv":
        return _rwkv_block_decode(p, x1, cache, cfg)
    if kind == "hymba":
        return _hymba_block_decode(p, x1, cache, pos, cfg)
    return _attn_block_decode(p, x1, cache, pos, cfg, kind, pad_len)


def block_decode_span(p, x, cache, pos, cfg: ModelConfig, kind: str,
                      pad_len=None, page_map=None, valid_len=None):
    """Multi-token decode over a slab or paged KV cache (see
    attention.attn_decode_span).  Attention kinds only: recurrent state
    (rwkv, hymba) cannot jump to per-slot absolute positions."""
    _check_kind(kind)
    if kind not in ATTN_KINDS:
        raise ValueError(f"block_decode_span: unsupported kind {kind!r} "
                         "(attention-family layers only)")
    return _attn_block_decode_span(p, x, cache, pos, cfg, kind, pad_len,
                                   page_map, valid_len)


def block_cache(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                dtype=DTYPE, device=None):
    _check_kind(kind)
    if kind == "rwkv":
        return _rwkv_block_cache(cfg, batch, dtype, device)
    if kind == "hymba":
        return _hymba_block_cache(cfg, batch, cache_len, dtype, device)
    return _attn_block_cache(cfg, kind, batch, cache_len, dtype, device)
