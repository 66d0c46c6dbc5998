"""Decoder-only transformer stack with compressed pipeline-stage cuts.

Port of ``repro/models/transformer.py`` (the encoder-decoder stack is
``models/encdec.py``, which shares its segmenting, logits and loss).
The stack is ``num_groups`` layer groups, evenly split into
``policy.num_stages`` stages; at each cut between stages sits a
compression boundary: in training the
``core/boundary.boundary_apply`` autograd function, at inference the
plain fw compressor or, when ``wire`` is set, the real wire codecs (what
the serve engine does).  Layer params carry a leading group dim; a Python
loop over groups replaces the reference's ``lax.scan``, and
``torch.utils.checkpoint`` per group its ``jax.checkpoint``.  The mesh
``constrain`` calls of the reference are no-ops here and are dropped.

Entry points:
  init_params(generator, cfg)
  forward_hidden(params, batch, cfg, policy, bstates, ids, remat)
                                      -> (hidden, aux, new_fw, bw_slots)
  forward_train(...)                  -> (logits, aux, new_fw, bw_slots)
  forward_eval(params, batch, cfg, policy, compress)      -> logits
  hidden_lm_loss(params, hidden, labels, cfg, mask)       -> loss
  lm_loss(logits, labels, mask)                           -> loss
  stage_stack_fn(cfg)            -> stage_fn(gp_stack, x) -> x (pipeline)
  stack_layer_stages(params, num_slices)  -> (S*v, groups/(S*v), ...) views
  tp_param_dims(stack), tp_sites(cfg)        (the tensor axis)
  tp_stage_stack_fn(cfg, tpc, remat)
                   -> stage_fn(rank_stacks, xs, resid, mirror) (TP stages)
  init_caches(cfg, batch, cache_len, dtype, device)
  prefill(params, batch, cfg, policy, cache_len, compress, pad_len, wire)
                                                  -> (logits (B,1,V), caches)
  decode_step(params, token, caches, pos, cfg, policy, compress, pad_len,
              wire)                               -> (logits (B,V), caches)
  decode_span(params, tokens, caches, pos, cfg, policy, compress, pad_len,
              page_map, valid_len, wire)          -> (logits (B,T,V), caches)
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.boundary import (boundary_apply, boundary_eval,
                                       boundary_wire_eval,
                                       boundary_wire_eval_tokens,
                                       empty_boundary_state)
from repro_torch.core.policy import CompressionPolicy, NO_POLICY
from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.common import (DTYPE, embed_init, norm_apply,
                                       norm_init, softcap)
from repro_torch.models.config import ModelConfig


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a layer kind outside ``blocks.PORTED_KINDS`` or a
    frontend other than the stubbed vision and audio ones.  Every arch of
    the registry passes: the encoder-decoder stack (whisper) runs through
    ``models/encdec.py``."""
    missing = [f"layer kind {k!r}" for k in cfg.layer_kinds()
               if k not in B.PORTED_KINDS]
    if cfg.frontend not in ("none", "vision", "audio"):
        missing.append(f"{cfg.frontend} frontend")
    if missing:
        raise NotImplementedError(f"{cfg.arch_id}: {', '.join(missing)} "
                                  "not yet ported to repro_torch")


def init_params(generator: torch.Generator, cfg: ModelConfig, dtype=DTYPE):
    """Random params in the reference's tree layout, drawn from
    ``generator`` on its device (same layout, not the same numbers as
    ``jax.random``: use checkpoint.convert to carry reference params).
    MoE expert stacks are drawn an (in, out) slice at a time
    (``moe.dense_init_slices``); every other leaf whole, so the dense
    archs' draws are those they always were."""
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
    """Logits in bf16 (fp32 accumulation inside the matmul), through the
    ``lm_head`` or the tied embedding, softcapped in bf16 when the config
    has a final softcap (gemma2)."""
    x = norm_apply(params["final_norm"], x, cfg.norm)
    head = params.get("lm_head", params["embed"])
    return softcap(x.to(DTYPE) @ head.to(DTYPE).T, cfg.final_softcap)


def _embed_input(params, batch, cfg: ModelConfig):
    """batch: {"tokens": (B, S)} (+ "patch_embeds": (B, P, d) for the
    vision frontend, whose patch embeddings take the first P rows: P rows
    even when S < P, as in the reference)."""
    x = params["embed"][batch["tokens"]].to(DTYPE)
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        p = batch["patch_embeds"].shape[1]
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x[:, p:]], dim=1)
    return x


def forward_hidden(params, batch, cfg: ModelConfig,
                   policy: CompressionPolicy = NO_POLICY,
                   bstates: Optional[list] = None, ids=None,
                   remat: bool = True):
    """Returns ``(hidden, aux_loss, new_fw_states, bw_slots)``.

    ``bstates``: one ``{"fw", "bw"}`` state dict per cut
    (core.boundary.init_boundary_state).  ``bw_slots[i].state`` is cut
    ``i``'s new backward state once backward has run (the reference
    returns it as the cotangent of the bw buffer)."""
    kinds = cfg.layer_kinds()
    x = _embed_input(params, batch, cfg)
    aux = x.new_zeros((), dtype=torch.float32)
    segs = segment_bounds(cfg.num_groups, policy.num_stages)
    new_fw, slots = [], []

    def group_fn(x, gp):
        a = x.new_zeros((), dtype=torch.float32)
        for i, kind in enumerate(kinds):
            x, ai = B.block_train(gp[f"b{i}"], x, cfg, kind)
            a = a + ai
        return x, a

    for si, (g0, g1) in enumerate(segs):
        for g in range(g0, g1):
            gp = _group(params["layers"], g)
            if remat:
                x, a = checkpoint(group_fn, x, gp, use_reentrant=False)
            else:
                x, a = group_fn(x, gp)
            aux = aux + a
        if si < len(segs) - 1:
            st = (bstates[si] if bstates is not None
                  else empty_boundary_state(x.dtype, x.device))
            x, nf, slot = boundary_apply(policy.at(si), x, st["fw"],
                                         st["bw"], ids)
            new_fw.append(nf)
            slots.append(slot)
    return x, aux, new_fw, slots


def forward_train(params, batch, cfg: ModelConfig,
                  policy: CompressionPolicy = NO_POLICY,
                  bstates: Optional[list] = None, ids=None,
                  remat: bool = True):
    x, aux, new_fw, slots = forward_hidden(params, batch, cfg, policy,
                                           bstates, ids, remat)
    return _lm_logits(params, x, cfg), aux, new_fw, slots


def stage_stack_fn(cfg: ModelConfig):
    """``stage_fn(gp_stack, x) -> x`` applying a stacked slice of layer
    groups in order: the per-stage body of the real pipeline
    (``transport/pipeline.py``).  MoE aux losses are dropped on this
    path, as in the reference."""
    kinds = cfg.layer_kinds()

    def stage_fn(gp_stack, x):
        leaf = gp_stack
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        for g in range(leaf.shape[0]):
            gp = _group(gp_stack, g)
            for i, kind in enumerate(kinds):
                x, _ = B.block_train(gp[f"b{i}"], x, cfg, kind)
        return x

    return stage_fn


def stack_layer_stages(params, num_stages: int):
    """The (num_groups, ...) layer stack as (num_stages, groups/stages,
    ...) views: the pipeline's stage-stacked params (``num_stages`` is the
    number of logical slices, stages x virtual stages)."""
    def reshape(tree):
        if isinstance(tree, dict):
            return {k: reshape(v) for k, v in tree.items()}
        g = tree.shape[0]
        if g % num_stages:
            raise ValueError(
                f"num_groups={g} is not divisible by num_stages="
                f"{num_stages}; pick a stage count that divides the "
                "layer-group count (--stages for launch/train)")
        return tree.reshape(num_stages, g // num_stages, *tree.shape[1:])
    return reshape(params["layers"])


_TP_LAST_DIM = ("wq", "wk", "wv", "wi", "wg")


def tp_param_dims(stack):
    """The tensor-sharded dim of every leaf of a layer stack (any number
    of leading group / stage / replica dims), as a tree of ints: wq, wk,
    wv and the MLP in-projections split on their OUT dim (column
    parallel), every ``wo`` on its IN dim (row parallel), and -1
    (replicated) for the rest, the norms' scale and bias."""
    def dims(tree, name=None):
        if isinstance(tree, dict):
            return {k: dims(v, k) for k, v in tree.items()}
        if name in _TP_LAST_DIM:
            return tree.ndim - 1
        if name == "wo":
            return tree.ndim - 2
        return -1
    return dims(stack)


def tp_sites(cfg: ModelConfig, groups: Optional[int] = None) -> int:
    """All-gather cut points per forward pass: 2 per block (attention and
    MLP in-gathers), the ``sites`` of ``init_tp_state``."""
    g = cfg.num_groups if groups is None else groups
    return 2 * len(cfg.layer_kinds()) * g


def tp_stage_stack_fn(cfg: ModelConfig, tpc, remat: bool = False):
    """``stage_fn(rank_stacks, xs, resid, mirror) -> (xs, resid, mirror)``:
    the tensor-parallel twin of :func:`stage_stack_fn`.  ``rank_stacks``
    is every rank's group-stacked weights
    (``transport/tp_collectives.tp_local``), ``xs`` every rank's sequence
    shard, and ``resid`` / ``mirror`` the site-stacked feedback buffers
    (size-0 placeholders for feedback "none"); the new buffers come back
    as new tensors.  ``remat`` recomputes each rank's attention and MLP in
    the backward pass, never a collective."""
    kinds = cfg.layer_kinds()
    for kind in kinds:
        if kind not in B.TP_BLOCK_KINDS:
            raise ValueError(
                f"tensor parallelism covers the dense family "
                f"{B.TP_BLOCK_KINDS}; layer kind {kind!r} shards "
                f"differently (expert/state parallel) — run it with tp=1")
    nb = len(kinds)

    def stage_fn(rank_stacks, xs, resid, mirror):
        st = {"ef": resid, "ef21": mirror}.get(tpc.feedback)
        leaf = rank_stacks[0]
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        new_bufs = []
        for g in range(leaf.shape[0]):
            gps = [_group(p, g) for p in rank_stacks]
            for i, kind in enumerate(kinds):
                site = 2 * (g * nb + i)
                bufs = ((None, None) if st is None
                        else (st[site], st[site + 1]))
                xs, bufs = B.attn_block_train_tp(
                    [p[f"b{i}"] for p in gps], xs, cfg, kind, tpc,
                    bufs=bufs, remat=remat)
                new_bufs += bufs
        if st is None:
            return xs, resid, mirror
        st = torch.stack(new_bufs)
        return (xs, st, mirror) if tpc.feedback == "ef" else (xs, resid, st)

    return stage_fn


def forward_eval(params, batch, cfg: ModelConfig,
                 policy: CompressionPolicy = NO_POLICY,
                 compress: bool = True):
    """Logits with the cuts compressed by the plain fw compressor
    (``compress``) or not compressed at all."""
    kinds = cfg.layer_kinds()
    x = _embed_input(params, batch, cfg)
    segs = segment_bounds(cfg.num_groups, policy.num_stages)
    for si, (g0, g1) in enumerate(segs):
        for g in range(g0, g1):
            gp = _group(params["layers"], g)
            for i, kind in enumerate(kinds):
                x, _ = B.block_train(gp[f"b{i}"], x, cfg, kind)
        if si < len(segs) - 1:
            x = boundary_eval(policy.at(si), x, compress)
    return _lm_logits(params, x, cfg)


class _FusedXent(torch.autograd.Function):
    """Per-token -log p[label] from bf16 logits without an fp32 (B,S,V)
    copy: the forward keeps the fp32 logsumexp; the backward recomputes
    ``(softmax - onehot) * g`` from the saved bf16 logits."""

    @staticmethod
    def forward(ctx, logits, labels):
        lse = torch.logsumexp(logits.to(torch.float32), dim=-1)
        picked = logits.gather(-1, labels[..., None])[..., 0]
        ctx.save_for_backward(logits, labels, lse)
        return lse - picked.to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        d = torch.exp(logits.to(torch.float32) - lse[..., None])
        d.scatter_add_(-1, labels[..., None],
                       torch.full_like(lse[..., None], -1.0))
        return (d * g[..., None]).to(logits.dtype), None


def _fused_xent(logits, labels):
    return _FusedXent.apply(logits, labels.long())


def hidden_lm_loss(params, x, labels, cfg: ModelConfig, mask=None):
    """Chunked cross entropy straight from hidden states: each sequence
    chunk's logits are computed, reduced and recomputed in backward
    (``torch.utils.checkpoint``), so the (B,S,V) logits never exist."""
    b, s, _ = x.shape
    chunk = s if s <= 512 else max(512, s // 16)
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=x.device)

    def chunk_nll(xc, lc, mc):
        return (_fused_xent(_lm_logits(params, xc, cfg), lc) * mc).sum()

    total = x.new_zeros((), dtype=torch.float32)
    for i in range(0, s, chunk):
        total = total + checkpoint(chunk_nll, x[:, i:i + chunk],
                                   labels[:, i:i + chunk],
                                   mask[:, i:i + chunk], use_reentrant=False)
    return total / torch.clamp(mask.sum(), min=1.0)


def lm_loss(logits, labels, mask=None):
    """Next-token cross entropy.  logits: (B,S,V); labels: (B,S);
    processed in sequence chunks as in the reference."""
    s = labels.shape[1]
    chunk = s if s <= 512 else max(512, s // 8)
    nll = torch.cat([_fused_xent(logits[:, i:i + chunk],
                                 labels[:, i:i + chunk])
                     for i in range(0, s, chunk)], dim=1)
    if mask is None:
        return nll.mean()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def init_caches(cfg: ModelConfig, batch: int, cache_len: int, dtype=DTYPE,
                device=None):
    """``{"b<i>": {leaf: (G, B, ...)}}`` zeros: ``"k"`` / ``"v"`` (G, B,
    C, KV, hd) for attention; the recurrent state ``"S"`` (G, B, H, K, V)
    f32 and the token-shift rows ``"tm"`` / ``"cm"`` (G, B, d) for rwkv;
    ``"ssm"`` (G, B, H, N, hd) f32 beside hymba's ring of K/V rows."""
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
    x = _embed_input(params, batch, cfg)
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


def decode_step(params, token, caches, pos, cfg: ModelConfig,
                policy: CompressionPolicy = NO_POLICY, compress: bool = True,
                pad_len=None, wire: bool = False):
    """token: (B,) int; ``pos``: the new token's index, an int (the same
    for every row) or a (B,) tensor of per-slot positions (continuous
    batching).  Returns (logits (B, V), caches) — the caches updated IN
    PLACE: attention writes its K/V rows, rwkv and hymba's SSD heads
    their new state, into the group views of ``caches``.  ``pad_len``:
    optional (B,) left-padding lengths (see prefill)."""
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


def decode_span(params, tokens, caches, pos, cfg: ModelConfig,
                policy: CompressionPolicy = NO_POLICY, compress: bool = True,
                pad_len=None, page_map=None, valid_len=None,
                wire: bool = True):
    """Multi-token decode: ``tokens`` (B, T) at absolute positions
    ``pos[b] + arange(T)`` (``pos``: a (B,) tensor).  K/V of all T tokens
    are written into the caches IN PLACE and logits come back for every
    position, (B, T, V).

    One function serves a chunked prefill (B = 1, T = chunk, ``valid_len``
    masking the padded tail of the last chunk) and a speculative
    verification (B = slots, T = k + 1).  ``caches``: the slab layout
    (leaves (G, B, C, ...)) or, with ``page_map`` (B, n_pages), a page pool
    (leaves (G, N, P, ...)); see attention.attn_decode_span.

    The cuts pack per (request, token) (boundary_wire_eval_tokens), the
    payload granularity of a T = 1 decode tick.  Compression goes through
    the wire codecs only: ``compress`` without ``wire`` raises, as in the
    reference.
    """
    if compress and not wire:
        raise NotImplementedError(
            "decode_span compresses through the wire codecs only "
            "(wire=True) — the serve engines never use the in-process "
            "boundary at decode time")
    kinds = cfg.layer_kinds()
    x = params["embed"][tokens].to(DTYPE)                     # (B, T, d)
    segs = segment_bounds(cfg.num_groups, policy.num_stages)
    for si, (g0, g1) in enumerate(segs):
        for g in range(g0, g1):
            gp, cache = _group(params["layers"], g), _group(caches, g)
            for i, kind in enumerate(kinds):
                x, _ = B.block_decode_span(
                    gp[f"b{i}"], x, cache[f"b{i}"], pos, cfg, kind,
                    pad_len=pad_len, page_map=page_map,
                    valid_len=valid_len)
        if si < len(segs) - 1:
            x = boundary_wire_eval_tokens(policy.at(si), x, compress)
    return _lm_logits(params, x, cfg), caches
