"""Whisper-style encoder-decoder backbone (audio frontend stubbed).

Port of ``repro/models/encdec.py``.  The mel-spectrogram + conv feature
extractor is the reference's stub: ``batch["enc_embeds"]`` carries the
frame embeddings ``(B, enc_seq, d)``.  After it: a bidirectional encoder,
a causal decoder with cross-attention over the encoder's output (the
"memory"), and compression boundaries between decoder stages.

Boundaries: the decoder stack is cut into ``policy.num_stages`` stages
over its LAYERS, like the decoder-only stack's groups; the
encoder -> decoder memory handoff is a network crossing too, so the first
cut's fw compressor is applied to the memory once (no feedback state: it
is sent once a sequence).  In training that hop is a bare compressor call
whose gradient is autodiff of the per-tile C(x) (``Compressor.__call__``
through ``kernels/ops.py``'s ``_ad`` functions), as the reference's
``jax.value_and_grad`` defines it.

Params: the reference's tree, leaf for leaf -- ``embed``, ``dec_pos``
(learned absolute decoder positions), ``enc_layers`` / ``dec_layers``
(each leaf with a leading layer dim), ``enc_norm``, ``final_norm``.  A
Python loop over layers replaces the reference's ``lax.scan``, and
``torch.utils.checkpoint`` per decoder block its ``jax.checkpoint``; the
encoder is not rematerialized, as in the reference.  Decode writes the
self-attention K/V rows into the caches IN PLACE (the reference returns
new caches).

Entry points (those of ``models/transformer.py``):
  init_params(generator, cfg)
  encode(params, enc_embeds, cfg)                       -> memory
  forward_hidden(params, batch, cfg, policy, bstates, ids, remat)
                                      -> (hidden, aux, new_fw, bw_slots)
  forward_train(...)                  -> (logits, aux, new_fw, bw_slots)
  forward_eval(params, batch, cfg, policy, compress, wire) -> logits
  init_caches(cfg, batch, cache_len, dtype, device)
  prefill(params, batch, cfg, policy, cache_len, compress, pad_len, wire)
                                      -> (logits (B,1,V), (caches, memory))
  decode_step(params, token, state, pos, cfg, policy, compress, pad_len,
              wire)                   -> (logits (B,V), (caches, memory))
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.boundary import (boundary_apply, boundary_eval,
                                       boundary_wire_eval,
                                       empty_boundary_state)
from repro_torch.core.policy import CompressionPolicy, NO_POLICY
from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models.common import (DTYPE, embed_init, mlp_apply,
                                       mlp_init, norm_apply, norm_init,
                                       sinusoidal_pos)
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import _group, _lm_logits, segment_bounds


def _enc_block_init(gen, cfg: ModelConfig, lead):
    d, dev = cfg.d_model, gen.device
    return {"ln1": norm_init(d, cfg.norm, dev, lead),
            "ln2": norm_init(d, cfg.norm, dev, lead),
            # the encoder is bidirectional MHA (cross_attn on itself)
            "attn": A.cross_attn_init(gen, d, cfg.num_heads,
                                      cfg.resolved_head_dim, DTYPE, lead),
            "mlp": mlp_init(gen, d, cfg.d_ff, cfg.mlp, DTYPE, lead)}


def _dec_block_init(gen, cfg: ModelConfig, lead):
    p = _enc_block_init(gen, cfg, lead)
    p["lnx"] = norm_init(cfg.d_model, cfg.norm, gen.device, lead)
    p["xattn"] = A.cross_attn_init(gen, cfg.d_model, cfg.num_heads,
                                   cfg.resolved_head_dim, DTYPE, lead)
    return p


def init_params(generator: torch.Generator, cfg: ModelConfig, dtype=DTYPE):
    """Random params in the reference's tree layout, drawn from
    ``generator`` on its device (same layout, not the same numbers as
    ``jax.random``: use checkpoint.convert to carry reference params).
    ``dec_pos`` is N(0, 0.01) drawn in float32, then cast."""
    dev = generator.device
    dec_pos = torch.randn((cfg.max_seq, cfg.d_model), generator=generator,
                          dtype=torch.float32, device=dev)
    return {
        "embed": embed_init(generator, cfg.vocab_size, cfg.d_model, dtype),
        "dec_pos": dec_pos.mul_(0.01).to(dtype),
        "enc_layers": _enc_block_init(generator, cfg, (cfg.enc_layers,)),
        "dec_layers": _dec_block_init(generator, cfg, (cfg.num_layers,)),
        "enc_norm": norm_init(cfg.d_model, cfg.norm, dev),
        "final_norm": norm_init(cfg.d_model, cfg.norm, dev),
    }


def encode(params, enc_embeds, cfg: ModelConfig):
    """enc_embeds: (B, T_enc, d) stub frontend output -> the memory."""
    t = enc_embeds.shape[1]
    x = enc_embeds.to(DTYPE) + sinusoidal_pos(
        t, cfg.d_model, enc_embeds.device).to(DTYPE)
    for i in range(cfg.enc_layers):
        lp = _group(params["enc_layers"], i)
        xn = norm_apply(lp["ln1"], x, cfg.norm)
        # bidirectional: non-causal self-attention via cross_attn on itself
        x = x + A.cross_attn(lp["attn"], xn, xn, num_heads=cfg.num_heads,
                             head_dim=cfg.resolved_head_dim)
        x = x + mlp_apply(lp["mlp"], norm_apply(lp["ln2"], x, cfg.norm),
                          cfg.mlp)
    return norm_apply(params["enc_norm"], x, cfg.norm).to(DTYPE)


def _dec_block(lp, x, memory, cfg: ModelConfig, cache=None, pos=None,
               cache_len=0, mode="train"):
    # whisper is MHA throughout (kv == heads in the full config)
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_heads,
              head_dim=cfg.resolved_head_dim, pos_embed="abs")
    xn = norm_apply(lp["ln1"], x, cfg.norm)
    new_cache = cache
    if mode == "train":
        h = A.attn_train(lp["attn"], xn, **kw)
    elif mode == "prefill":
        h, new_cache = A.attn_prefill(lp["attn"], xn, cache_len=cache_len,
                                      **kw)
    else:
        h, new_cache = A.attn_decode(lp["attn"], xn, cache, pos, **kw)
    x = x + h
    x = x + A.cross_attn(lp["xattn"], norm_apply(lp["lnx"], x, cfg.norm),
                         memory, num_heads=cfg.num_heads,
                         head_dim=cfg.resolved_head_dim)
    x = x + mlp_apply(lp["mlp"], norm_apply(lp["ln2"], x, cfg.norm), cfg.mlp)
    return x, new_cache


def _dec_pos(params, pos0: int, s: int):
    """Rows ``pos0 .. pos0 + s`` of ``dec_pos``, the start clamped so the
    slice fits (``jax.lax.dynamic_slice_in_dim``'s rule: a position at or
    past ``max_seq`` reads the last rows)."""
    start = min(max(int(pos0), 0), params["dec_pos"].shape[0] - s)
    return params["dec_pos"][start:start + s]


def _embed_tokens(params, tokens, pos0: int = 0):
    x = params["embed"][tokens].to(DTYPE)
    return x + _dec_pos(params, pos0, tokens.shape[1]).to(x.dtype)


def forward_hidden(params, batch, cfg: ModelConfig,
                   policy: CompressionPolicy = NO_POLICY,
                   bstates: Optional[list] = None, ids=None,
                   remat: bool = True):
    """batch: {"enc_embeds": (B, T, d), "tokens": (B, S)}.  Returns
    ``(hidden, aux, new_fw_states, bw_slots)`` as
    ``transformer.forward_hidden`` does (aux 0): the train step takes the
    chunked loss from the hidden states."""
    memory = encode(params, batch["enc_embeds"], cfg)
    x = _embed_tokens(params, batch["tokens"])
    # enc -> dec memory crossing: compressed once (plain, no feedback)
    if policy.num_boundaries:
        memory = policy.at(0).fw(memory)
    segs = segment_bounds(cfg.num_layers, policy.num_stages)
    new_fw, slots = [], []

    def block(x, lp, memory):
        return _dec_block(lp, x, memory, cfg, mode="train")[0]

    for si, (l0, l1) in enumerate(segs):
        for i in range(l0, l1):
            lp = _group(params["dec_layers"], i)
            if remat:
                x = checkpoint(block, x, lp, memory, use_reentrant=False)
            else:
                x = block(x, lp, memory)
        if si < len(segs) - 1:
            st = (bstates[si] if bstates is not None
                  else empty_boundary_state(x.dtype, x.device))
            x, nf, slot = boundary_apply(policy.at(si), x, st["fw"],
                                         st["bw"], ids)
            new_fw.append(nf)
            slots.append(slot)
    return x, x.new_zeros((), dtype=torch.float32), new_fw, slots


def forward_train(params, batch, cfg: ModelConfig,
                  policy: CompressionPolicy = NO_POLICY,
                  bstates: Optional[list] = None, ids=None,
                  remat: bool = True):
    x, aux, new_fw, slots = forward_hidden(params, batch, cfg, policy,
                                           bstates, ids, remat)
    return _lm_logits(params, x, cfg), aux, new_fw, slots


def forward_eval(params, batch, cfg: ModelConfig,
                 policy: CompressionPolicy = NO_POLICY, compress: bool = True,
                 wire: bool = False):
    """Logits with the cuts (the memory hop included) compressed by the
    plain fw compressor (``compress``) or not at all; ``wire=True`` packs
    and unpacks the real payloads instead (the serve engine's cuts)."""
    beval = boundary_wire_eval if wire else boundary_eval
    memory = encode(params, batch["enc_embeds"], cfg)
    if policy.num_boundaries:
        memory = beval(policy.at(0), memory, compress)
    x = _embed_tokens(params, batch["tokens"])
    segs = segment_bounds(cfg.num_layers, policy.num_stages)
    for si, (l0, l1) in enumerate(segs):
        for i in range(l0, l1):
            x = _dec_block(_group(params["dec_layers"], i), x, memory, cfg,
                           mode="train")[0]
        if si < len(segs) - 1:
            x = beval(policy.at(si), x, compress)
    return _lm_logits(params, x, cfg)


def init_caches(cfg: ModelConfig, batch: int, cache_len: int, dtype=DTYPE,
                device=None):
    """``{"k", "v"}`` zeros of (num_layers, B, C, H, hd): the decoder's
    self-attention caches."""
    shape = (cfg.num_layers, batch, cache_len, cfg.num_heads,
             cfg.resolved_head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def prefill(params, batch, cfg: ModelConfig,
            policy: CompressionPolicy = NO_POLICY, cache_len: int = 0,
            compress: bool = True, pad_len=None, wire: bool = False):
    """Returns (last-token logits, (self_caches, memory)).

    ``pad_len`` is accepted for the engines' interface but must be zeros:
    the whisper decoder uses ABSOLUTE learned positions, so left-padding
    shifts real tokens to wrong position embeddings -- a mask cannot fix
    that.  Serve enc-dec prompts start-aligned (equal decoder lengths)."""
    beval = boundary_wire_eval if wire else boundary_eval
    memory = encode(params, batch["enc_embeds"], cfg)
    if policy.num_boundaries:
        memory = beval(policy.at(0), memory, compress)
    x = _embed_tokens(params, batch["tokens"])
    cache_len = cache_len or x.shape[1]
    segs = segment_bounds(cfg.num_layers, policy.num_stages)
    per_layer = []
    for si, (l0, l1) in enumerate(segs):
        for i in range(l0, l1):
            x, c = _dec_block(_group(params["dec_layers"], i), x, memory,
                              cfg, cache_len=cache_len, mode="prefill")
            per_layer.append(c)
        if si < len(segs) - 1:
            x = beval(policy.at(si), x, compress)
    caches = {k: torch.stack([c[k] for c in per_layer]) for k in ("k", "v")}
    return _lm_logits(params, x[:, -1:], cfg), (caches, memory)


def decode_step(params, token, state, pos, cfg: ModelConfig,
                policy: CompressionPolicy = NO_POLICY, compress: bool = True,
                pad_len=None, wire: bool = False):
    """token: (B,) int; ``pos``: the new token's index, an int (the same
    for every row; ``dec_pos`` clamps as the reference's slice does).
    ``state``: ``(caches, memory)`` from :func:`prefill`.  Returns
    (logits (B, V), state) -- the caches written IN PLACE."""
    beval = boundary_wire_eval if wire else boundary_eval
    caches, memory = state
    x = params["embed"][token][:, None].to(DTYPE) + \
        _dec_pos(params, pos, 1).to(DTYPE)
    segs = segment_bounds(cfg.num_layers, policy.num_stages)
    for si, (l0, l1) in enumerate(segs):
        for i in range(l0, l1):
            x, _ = _dec_block(_group(params["dec_layers"], i), x, memory,
                              cfg, cache=_group(caches, i), pos=pos,
                              mode="decode")
        if si < len(segs) - 1:
            x = beval(policy.at(si), x, compress)
    return _lm_logits(params, x, cfg)[:, 0], (caches, memory)
