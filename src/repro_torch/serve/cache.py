"""Slot-indexed KV cache for continuous-batching serve.

Port of ``repro/serve/cache.py``.  One decode row per serving slot: every
cache leaf is laid out ``(groups, num_slots, cache_len, ...)`` (the
transformer's per-group cache tree with the batch axis as the slot axis).
A slot is claimed by a request at admission, filled by a bucketed prefill
(:func:`write_slot`), advanced in place by the shared decode step, and
handed to the next request on eviction without touching the other slots.

Slot hygiene needs no explicit zeroing: the decode attention mask only
admits cache positions ``idx <= pos[slot]`` (and ``>= pad_len[slot]``),
and a refill overwrites exactly the positions the new request's prompt
occupies — stale keys of the previous occupant are never valid.
:func:`reset_slot` exists for callers that want hard isolation anyway.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.models.common import DTYPE
from repro_torch.models.config import ModelConfig


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _pairs(big, one):
    if isinstance(big, dict):
        for k in big:
            yield from _pairs(big[k], one[k])
    else:
        yield big, one


def init_slot_caches(mod, cfg: ModelConfig, num_slots: int, cache_len: int,
                     dtype=DTYPE, device=None):
    """The transformer's cache tree with ``num_slots`` batch slots."""
    return mod.init_caches(cfg, num_slots, cache_len, dtype, device)


def write_slot(caches, one_caches, slot: int):
    """Insert a prefilled batch-1 cache tree into slot ``slot`` IN PLACE:
    one slice write per leaf on axis 1.  ``one_caches`` leaves are
    ``(groups, 1, ...)``."""
    for big, one in _pairs(caches, one_caches):
        big[:, slot] = one[:, 0].to(big.dtype)
    return caches


def reset_slot(caches, slot: int):
    """Zero one slot's cache in place (optional hygiene; module doc)."""
    for big in _leaves(caches):
        big[:, slot] = 0
    return caches


def slot_bytes(caches, num_slots: int) -> int:
    """Per-slot cache footprint in bytes (engine metrics)."""
    total = sum(leaf.numel() * leaf.element_size()
                for leaf in _leaves(caches))
    return total // max(1, num_slots)


def prompt_buckets(max_prompt: int, min_bucket: int = 8) -> Tuple[int, ...]:
    """Power-of-two prompt-length buckets up to ``max_prompt``.

    A request's prefill runs at the smallest bucket >= its prompt length
    (left-padded inside the bucket), so prefill runs at a bounded set of
    shapes instead of one per distinct prompt length.
    """
    buckets = []
    b = min_bucket
    while b < max_prompt:
        buckets.append(b)
        b *= 2
    buckets.append(max_prompt)
    return tuple(buckets)


def bucket_for(length: int, buckets: Tuple[int, ...]) -> int:
    for b in buckets:
        if length <= b:
            return b
    raise ValueError(f"prompt length {length} exceeds the largest bucket "
                     f"{buckets[-1]} (raise max_prompt/max_seq)")
