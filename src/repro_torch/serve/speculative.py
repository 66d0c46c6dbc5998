"""Speculative decoding: draft proposer + greedy acceptance.

Port of ``repro/serve/speculative.py``.  A small DRAFT model proposes
``k`` greedy tokens per tick; the TARGET model scores all ``k + 1``
positions in ONE ``decode_span`` forward and accepts the longest matching
prefix.  Every emitted token is the target's own greedy argmax, so the
output is what plain per-token greedy decode produces — for any draft,
good or bad; the draft only sets how many target positions each forward
covers.

Compression semantics (paper finding F3): a draft trained with boundary
compression must also SERVE compressed, so the draft carries its own
CompressionPolicy and packs its stage cuts through the same wire codecs
as the target.  The target's verification span packs PER (request,
token) (``boundary_wire_eval_tokens``), the payload of a T = 1 decode
tick.

The draft keeps the slab cache (per-slot contiguous rows, bucketed
left-padded prefill) even when the target is paged: draft state is tiny
and never prefix-shared.  After each round the draft "rolls back" by
position arithmetic only — rejected positions hold garbage K/V that the
next propose overwrites before it ever becomes valid under the position
mask.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.policy import CompressionPolicy, NO_POLICY
from repro_torch.device import host_ints
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.serve import cache as C


def accept_greedy(proposals: np.ndarray, target_greedy: np.ndarray,
                  k: int) -> int:
    """Accepted-token count for one slot.

    ``proposals``: (k,) draft tokens d_1..d_k; ``target_greedy``: (k+1,)
    the target's argmax at every span position — g_j is the target's
    next token after seeing ...x0, d_1..d_j.  Returns ``a`` = longest
    prefix with d_{j+1} == g_j; the emitted tokens are g_0..g_{e-1} with
    ``e = min(a + 1, k)``.

    The bonus token (e = a + 1) is DROPPED when every proposal is
    accepted: capping e at k keeps the draft cache gap-free — position
    ``pd + e - 1`` was always written during propose, so the next round
    needs no backfill forward.
    """
    a = 0
    while a < k and int(proposals[a]) == int(target_greedy[a]):
        a += 1
    return a


class DraftWorker:
    """Per-slot draft state and its two steps (insert, propose).

    Mirrors the engine's slab path: bucketed left-padded prefill into a
    per-slot row, then ``spec_k`` greedy decode steps with the tokens kept
    on the device and one host sync at the end.  Bookkeeping (pos / pad)
    is host-side numpy; rollback after a verification round is position
    arithmetic only.
    """

    def __init__(self, params, cfg: ModelConfig,
                 policy: CompressionPolicy = NO_POLICY,
                 compress: bool = True, num_slots: int = 4,
                 max_seq: int = 256, buckets: Optional[List[int]] = None,
                 spec_k: int = 4, device=None):
        from repro_torch.serve.engine import left_pad_unsupported
        bad = left_pad_unsupported(cfg)
        if bad:
            raise ValueError(
                f"draft arch {cfg.arch_id}: speculative proposing needs "
                f"maskable left-padding; {sorted(bad)} supports none")
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1: {spec_k}")
        transformer.check_supported(cfg)
        self.params, self.cfg, self.policy = params, cfg, policy
        self.compress, self.spec_k = compress, spec_k
        self.num_slots, self.max_seq = num_slots, max_seq
        self.device = params["embed"].device if device is None else device
        self.buckets = buckets or C.prompt_buckets(max_seq // 2)
        self._caches = C.init_slot_caches(transformer, cfg, num_slots,
                                          max_seq, device=self.device)
        self.pos = np.zeros(num_slots, np.int64)
        self.pad = np.zeros(num_slots, np.int64)
        self.proposed = 0
        self.accepted = 0

    @torch.inference_mode()
    def insert(self, slot: int, prompt: np.ndarray) -> None:
        """Prefill ``prompt`` into the draft row for ``slot``; the prefill
        logits are dropped — the first propose round re-feeds the
        target's first emitted token."""
        bucket = C.bucket_for(len(prompt), self.buckets)
        if bucket + self.spec_k >= self.max_seq:
            raise ValueError(
                f"draft bucket {bucket} + spec_k {self.spec_k} exceeds "
                f"draft max_seq={self.max_seq}")
        toks = np.zeros((1, bucket), np.int64)
        toks[0, bucket - len(prompt):] = prompt
        pad = bucket - len(prompt)
        from repro_torch.serve.engine import _make_batch
        _, one = transformer.prefill(
            self.params, _make_batch(self.cfg, host_ints(toks, self.device)),
            self.cfg, self.policy, cache_len=self.max_seq,
            compress=self.compress, pad_len=host_ints([pad], self.device),
            wire=True)
        C.write_slot(self._caches, one, slot)
        self.pos[slot] = bucket
        self.pad[slot] = pad

    @torch.inference_mode()
    def propose(self, last_tok: np.ndarray) -> np.ndarray:
        """(B, k) greedy proposals continuing each slot from ``last_tok``.
        Inactive slots decode garbage into their own rows only (invalid
        under the position mask, overwritten on refill).  Does NOT advance
        ``self.pos`` — the engine commits the accepted count per slot via
        :meth:`commit`."""
        tok = host_ints(last_tok, self.device)
        pos = host_ints(self.pos, self.device)
        pad = host_ints(self.pad, self.device)
        hist = []
        for _ in range(self.spec_k):
            logits, self._caches = transformer.decode_step(
                self.params, tok, self._caches, pos, self.cfg, self.policy,
                compress=self.compress, pad_len=pad, wire=True)
            tok = torch.argmax(logits.to(torch.float32), dim=-1)
            hist.append(tok)
            pos = pos + 1
        return torch.stack(hist, dim=1).cpu().numpy()

    def commit(self, slot: int, emitted: int) -> None:
        """Advance ``slot`` past its ``emitted`` accepted tokens.  With
        ``e <= k`` (bonus capped, see :func:`accept_greedy`) position
        ``pos + e - 1`` was written during propose with the right token,
        so the draft cache is gap-free; positions beyond hold garbage the
        next propose overwrites (write-before-attend)."""
        self.pos[slot] += emitted

    def record(self, proposed: int, accepted: int) -> None:
        self.proposed += proposed
        self.accepted += accepted

    def stats(self) -> dict:
        return {"spec_k": self.spec_k,
                "draft_arch": self.cfg.arch_id,
                "proposed": self.proposed,
                "accepted": self.accepted,
                "acceptance_rate": (round(self.accepted / self.proposed, 3)
                                    if self.proposed else 0.0),
                "draft_cache_bytes": C.slot_bytes(self._caches,
                                                  self.num_slots)}
