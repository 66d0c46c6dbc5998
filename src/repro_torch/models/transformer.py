"""Decoder-only transformer stack with compressed pipeline-stage cuts:
serving entry points.

Port of ``repro/models/transformer.py`` (prefill / decode).  The stack is
``num_groups`` layer groups, evenly split into ``policy.num_stages``
stages; at each cut between stages the activation is compressed —
through the real wire codecs when ``wire`` is set (what the serve engine
does, core/boundary.boundary_wire_eval).  Layer params carry a leading
group dim; a Python loop over groups replaces the reference's
``lax.scan``.  The mesh ``constrain`` calls of the reference are no-ops
here and are dropped.

Entry points:
  init_params(generator, cfg)
  init_caches(cfg, batch, cache_len, dtype, device)
  prefill(params, batch, cfg, policy, cache_len, compress, pad_len, wire)
                                                  -> (logits (B,1,V), caches)
  decode_step(params, token, caches, pos, cfg, policy, compress, pad_len,
              wire)                               -> (logits (B,V), caches)
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.core.boundary import boundary_eval, boundary_wire_eval
from repro_torch.core.policy import CompressionPolicy, NO_POLICY
from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.common import DTYPE, embed_init, norm_apply, norm_init
from repro_torch.models.config import ModelConfig


def check_supported(cfg: ModelConfig) -> None:
    """Raise for architecture features this port does not have yet."""
    missing = [f"layer kind {k!r}" for k in cfg.layer_kinds()
               if k not in B.PORTED_KINDS]
    for feature, present in (("sliding window", cfg.window is not None),
                             ("attention softcap", cfg.attn_softcap),
                             ("final softcap", cfg.final_softcap),
                             ("post-norm", cfg.post_norm),
                             ("encoder-decoder", cfg.enc_dec),
                             (f"{cfg.frontend} frontend",
                              cfg.frontend != "none")):
        if present:
            missing.append(feature)
    if missing:
        raise NotImplementedError(f"{cfg.arch_id}: {', '.join(missing)} "
                                  "not yet ported to repro_torch")


def init_params(generator: torch.Generator, cfg: ModelConfig, dtype=DTYPE):
    """Random params in the reference's tree layout, drawn from
    ``generator`` on its device (same layout, not the same numbers as
    ``jax.random``: use checkpoint.convert to carry reference params)."""
    check_supported(cfg)
    layers = {f"b{i}": B.block_init(generator, cfg, kind, cfg.num_groups)
              for i, kind in enumerate(cfg.layer_kinds())}
    params = {"embed": embed_init(generator, cfg.vocab_size, cfg.d_model,
                                  dtype),
              "layers": layers,
              "final_norm": norm_init(cfg.d_model, cfg.norm,
                                      generator.device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(generator, cfg.vocab_size,
                                       cfg.d_model, dtype)
    return params


def segment_bounds(num_groups: int, num_stages: int) -> List[Tuple[int, int]]:
    """Even split of groups into stages: [(g0, g1), ...]."""
    stages = min(num_stages, num_groups)
    per = num_groups / stages
    cuts = [int(round(per * s)) for s in range(stages + 1)]
    return [(cuts[i], cuts[i + 1]) for i in range(stages)
            if cuts[i + 1] > cuts[i]]


def _group(tree, g: int):
    """Group ``g`` of a group-stacked tree (views: writes reach the stack)."""
    if isinstance(tree, dict):
        return {k: _group(v, g) for k, v in tree.items()}
    return tree[g]


def _lm_logits(params, x, cfg: ModelConfig):
    """Logits in bf16 (fp32 accumulation inside the matmul); tied head."""
    x = norm_apply(params["final_norm"], x, cfg.norm)
    head = params.get("lm_head", params["embed"])
    return x.to(DTYPE) @ head.to(DTYPE).T


def init_caches(cfg: ModelConfig, batch: int, cache_len: int, dtype=DTYPE,
                device=None):
    """``{"b<i>": {"k", "v": (G, B, C, KV, hd)}}`` zeros."""
    dev = resolve_device(device)
    caches = {}
    for i, kind in enumerate(cfg.layer_kinds()):
        one = B.block_cache(cfg, kind, batch, cache_len, dtype, dev)
        caches[f"b{i}"] = {k: torch.stack([v] * cfg.num_groups)
                           for k, v in one.items()}
    return caches


def prefill(params, batch, cfg: ModelConfig,
            policy: CompressionPolicy = NO_POLICY, cache_len: int = 0,
            compress: bool = True, pad_len=None, wire: bool = False):
    """``batch``: {"tokens": (B, S) int}.  ``pad_len``: optional (B,) — the
    first pad_len[b] positions are left-padding, masked out of attention
    in every layer (the padded slab still crosses the stage cuts, as in
    the reference).  ``wire=True``: the cuts pack/unpack real payloads."""
    kinds = cfg.layer_kinds()
    beval = boundary_wire_eval if wire else boundary_eval
    tokens = batch["tokens"]
    x = params["embed"][tokens].to(DTYPE)
    cache_len = cache_len or x.shape[1]
    pad_mask = None
    if pad_len is not None:
        pad_mask = (torch.arange(x.shape[1], device=x.device)[None, :]
                    >= pad_len[:, None])
    segs = segment_bounds(cfg.num_groups, policy.num_stages)
    per_group = {f"b{i}": [] for i in range(len(kinds))}
    for si, (g0, g1) in enumerate(segs):
        for g in range(g0, g1):
            gp = _group(params["layers"], g)
            for i, kind in enumerate(kinds):
                x, c = B.block_prefill(gp[f"b{i}"], x, cfg, kind, cache_len,
                                       pad_mask=pad_mask)
                per_group[f"b{i}"].append(c)
        if si < len(segs) - 1:
            x = beval(policy.at(si), x, compress)
    caches = {name: {k: torch.stack([c[k] for c in cs]) for k in cs[0]}
              for name, cs in per_group.items()}
    return _lm_logits(params, x[:, -1:], cfg), caches


def decode_step(params, token, caches, pos: int, cfg: ModelConfig,
                policy: CompressionPolicy = NO_POLICY, compress: bool = True,
                pad_len=None, wire: bool = False):
    """token: (B,) int; ``pos``: the new token's index (same for every
    row).  Returns (logits (B, V), caches) — the caches updated IN PLACE.
    ``pad_len``: optional (B,) left-padding lengths (see prefill)."""
    kinds = cfg.layer_kinds()
    beval = boundary_wire_eval if wire else boundary_eval
    x = params["embed"][token][:, None].to(DTYPE)
    segs = segment_bounds(cfg.num_groups, policy.num_stages)
    for si, (g0, g1) in enumerate(segs):
        for g in range(g0, g1):
            gp, cache = _group(params["layers"], g), _group(caches, g)
            for i, kind in enumerate(kinds):
                x, _ = B.block_decode(gp[f"b{i}"], x, cache[f"b{i}"], pos,
                                      cfg, kind, pad_len=pad_len)
        if si < len(segs) - 1:
            x = beval(policy.at(si), x, compress)
    return _lm_logits(params, x, cfg)[:, 0], caches
