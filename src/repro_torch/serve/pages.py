"""Prefix-sharing paged KV: refcounted page table + device page pool.

Port of ``repro/serve/pages.py``: :class:`PageTable` is a copy (host-side
numpy, ``hashlib``); the device pool is torch.  The slab cache gives every
serving slot a private, contiguous ``max_seq`` row.  Real fleets see
many concurrent requests sharing a common system-prompt prefix, so this
module replaces the slab with a PAGE POOL (modeled on MaxText's
``page_manager.PageState``):

  * every cache leaf is laid out ``(groups, num_pages, page_size, ...)`` —
    a global pool of fixed-size token pages instead of per-slot slabs;
  * a slot reads/writes through a per-slot PAGE MAP ``(max_pages,) int32``
    mapping logical page ``t // page_size`` to a physical page id;
  * full prompt pages are indexed by a POSITION-CHAINED hash of their
    token ids, so a new request sharing a prefix re-uses the cached pages
    (refcount++) instead of re-prefilling them;
  * pages are REFCOUNTED: a page is freed exactly when its last user
    releases it — unless it is prefix-indexed, in which case it parks in
    an LRU cache (refcount 0) and is reclaimed only when the free list
    runs dry;
  * a shared page is NEVER written in place: :meth:`PageTable.writable`
    returns a fresh private page (copy-on-write) whenever the mapped page
    has other users or sits in the prefix index.

Physical page 0 is reserved as the TRASH page: masked writes (chunk-pad
positions, inactive decode slots) scatter there, so one pool serves every
slot without conditional writes.  Unallocated logical pages map to 0 too —
their garbage is never valid under the position mask.

All bookkeeping is host-side (numpy + dicts); the only device code is
the pool constructor and the CoW page copy.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.models.common import DTYPE
from repro_torch.models.config import ModelConfig
from repro_torch.serve.cache import _leaves

TRASH_PAGE = 0


class PagePoolFull(RuntimeError):
    """No free page and nothing evictable — admission must wait."""


def _sha_chain(parent: bytes, chunk: np.ndarray) -> bytes:
    return hashlib.sha1(parent + chunk.astype(np.int32).tobytes()).digest()


class PageTable:
    """Host-side page allocator with prefix-hash sharing and CoW.

    ``hash_fn(parent_digest, chunk) -> digest`` is injectable so the
    collision fallback (full token-id comparison) is testable with a
    deliberately colliding hash.
    """

    def __init__(self, num_pages: int, page_size: int,
                 hash_fn: Optional[Callable] = None):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the trash page)")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1: {page_size}")
        self.num_pages, self.page_size = num_pages, page_size
        self._hash = hash_fn or _sha_chain
        # allocate low page ids first (deterministic for tests)
        self._free: List[int] = list(range(num_pages - 1, TRASH_PAGE, -1))
        self.ref = np.zeros(num_pages, np.int64)
        self._index: Dict[bytes, int] = {}       # chain digest -> page id
        self._meta: Dict[int, Tuple[bytes, np.ndarray]] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()  # rc==0, cached
        self.cow_copies = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0

    # -- queries ------------------------------------------------------------

    def available(self) -> int:
        """Pages allocatable right now (free + evictable cached)."""
        return len(self._free) + len(self._lru)

    def active_pages(self) -> int:
        return int((self.ref > 0).sum())

    def cached_pages(self) -> int:
        return len(self._lru)

    def stats(self) -> dict:
        return {"pages": self.num_pages - 1,
                "page_size": self.page_size,
                "active_pages": self.active_pages(),
                "cached_pages": self.cached_pages(),
                "free_pages": len(self._free),
                "cow_copies": self.cow_copies,
                "prefix_hits": self.prefix_hits,
                "prefix_hit_tokens": self.prefix_hit_tokens}

    # -- allocation ---------------------------------------------------------

    def alloc(self) -> int:
        """A fresh private page (refcount 1).  Evicts the least-recently
        used cached prefix page when the free list is empty."""
        if self._free:
            pid = self._free.pop()
        elif self._lru:
            pid, _ = self._lru.popitem(last=False)       # oldest
            digest, _toks = self._meta.pop(pid)
            del self._index[digest]
        else:
            raise PagePoolFull(
                f"all {self.num_pages - 1} pages active — wait for a "
                "release before admitting")
        assert self.ref[pid] == 0
        self.ref[pid] = 1
        return pid

    def release(self, page_ids) -> None:
        """Drop one reference per page.  A page whose refcount hits zero is
        freed — or parked in the LRU cache if it is prefix-indexed."""
        for pid in page_ids:
            if pid == TRASH_PAGE:
                continue
            if self.ref[pid] <= 0:
                raise ValueError(f"release of page {pid} with refcount "
                                 f"{self.ref[pid]}")
            self.ref[pid] -= 1
            if self.ref[pid] == 0:
                if pid in self._meta:
                    self._lru[pid] = None                # cached, evictable
                else:
                    self._free.append(pid)

    # -- prefix sharing -----------------------------------------------------

    def _chain(self, tokens: np.ndarray):
        """(digest, chunk) per FULL page of ``tokens[:-1]`` — the last
        prompt token is always recomputed (its logits seed generation), so
        only pages fully covered by ``tokens[:-1]`` are shareable."""
        p = self.page_size
        full = (len(tokens) - 1) // p
        out, parent = [], b""
        for i in range(full):
            chunk = np.asarray(tokens[i * p:(i + 1) * p], np.int32)
            parent = self._hash(parent, chunk)
            out.append((parent, chunk))
        return out

    def match_prefix(self, tokens: np.ndarray) -> List[int]:
        """Longest chain of cached pages matching ``tokens``'s leading full
        pages.  Matched pages are increfed (caller owns one reference each
        and must ``release`` them).  A digest hit whose stored token ids
        differ (hash collision) stops the match — correctness never rests
        on the hash alone."""
        matched: List[int] = []
        for digest, chunk in self._chain(np.asarray(tokens)):
            pid = self._index.get(digest)
            if pid is None:
                break
            _, stored = self._meta[pid]
            if not np.array_equal(stored, chunk):        # collision
                break
            if self.ref[pid] == 0:
                del self._lru[pid]
            self.ref[pid] += 1
            matched.append(pid)
        if matched:
            self.prefix_hits += 1
            self.prefix_hit_tokens += len(matched) * self.page_size
        return matched

    def register_prefix(self, tokens: np.ndarray, page_ids: List[int]) -> None:
        """Index ``tokens``'s full prompt pages (backed by ``page_ids``,
        the slot's allocated pages in logical order) for future sharing.
        Pages whose digest is already indexed keep the existing entry (the
        newer copy stays private)."""
        for (digest, chunk), pid in zip(self._chain(np.asarray(tokens)),
                                        page_ids):
            if digest in self._index or pid in self._meta:
                continue
            self._index[digest] = pid
            self._meta[pid] = (digest, chunk)

    # -- copy-on-write ------------------------------------------------------

    def shared(self, pid: int) -> bool:
        """Writing this page in place would corrupt another reader: it has
        more than one reference, or the prefix index points at it."""
        return pid == TRASH_PAGE or self.ref[pid] > 1 or pid in self._meta

    def writable(self, pid: int) -> Tuple[int, bool]:
        """(page to write, copy_needed).  Private unindexed pages are
        returned as-is; shared/indexed pages trigger CoW — a fresh page is
        allocated, the old reference dropped, and the caller must copy the
        old contents device-side before writing (``copy_pages``)."""
        if pid != TRASH_PAGE and self.ref[pid] == 1 and pid not in self._meta:
            return pid, False
        fresh = self.alloc()
        self.release([pid])
        self.cow_copies += 1
        return fresh, True

    # -- test support -------------------------------------------------------

    def check_invariants(self) -> None:
        """Every page is in exactly one state; refcounts never negative."""
        free = set(self._free)
        cached = set(self._lru)
        assert not free & cached, "page both free and cached"
        for pid in range(1, self.num_pages):
            rc = self.ref[pid]
            assert rc >= 0, f"page {pid}: negative refcount {rc}"
            states = [pid in free, pid in cached, rc > 0]
            assert sum(states) == 1, \
                f"page {pid} leak: free={states[0]} cached={states[1]} " \
                f"rc={rc}"
            if pid in cached:
                assert pid in self._meta, f"cached page {pid} not indexed"
        for digest, pid in self._index.items():
            assert self._meta[pid][0] == digest
        assert self.ref[TRASH_PAGE] == 0


# ---------------------------------------------------------------------------
# Device pool
# ---------------------------------------------------------------------------

def init_page_pool(mod, cfg: ModelConfig, num_pages: int, page_size: int,
                   dtype=DTYPE, device=None):
    """The transformer cache tree with the (batch, cache_len) axes as
    (num_pages, page_size) — one pool shared by every slot."""
    if cfg.window is not None:
        raise ValueError(
            f"{cfg.arch_id}: paged KV needs absolute cache positions; "
            "sliding-window ring buffers are unsupported (serve with the "
            "slab cache: --no-prefix-cache / prefill_chunk=None)")
    return mod.init_caches(cfg, num_pages, page_size, dtype, device)


def copy_pages(pool, src: int, dst: int):
    """CoW device copy IN PLACE: ``pool[:, dst] = pool[:, src]`` on every
    leaf (the page axis is 1, after the layer-group axis)."""
    for a in _leaves(pool):
        a[:, dst] = a[:, src]
    return pool


def pool_bytes(pool) -> int:
    return sum(leaf.numel() * leaf.element_size() for leaf in _leaves(pool))


def pages_for(max_seq: int, page_size: int) -> int:
    """Logical pages a slot needs to cover ``max_seq`` positions."""
    return -(-max_seq // page_size)
