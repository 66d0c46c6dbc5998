"""The port's host-side serving state against the JAX package, exactly:
the page table (page ids, refcounts, LRU order, prefix index, stats and
raised ``PagePoolFull``) driven by one random operation sequence beside
the reference's, the scheduler on one call sequence, the prompt buckets
and the speculative acceptance rule; then the device pool (copy-on-write
copy, the window refusal) and the slab-cache helpers.

The page-table property test releases a partly allocated span when
``PagePoolFull`` interrupts it and catches ``PagePoolFull`` at a
copy-on-write under a full pool.  (The reference's own property test,
``tests/test_serve_pages.py::TestPageTableProperties::
test_no_leaks_under_random_ops``, drops those pages itself, so it fails
on the test's leak, not the table's.)
"""
import dataclasses

import numpy as np
import pytest
import torch

from conftest import hypothesis_or_stubs
given, settings, st = hypothesis_or_stubs()

import repro.serve.cache as JC
import repro.serve.pages as JPG
from repro.serve.scheduler import Scheduler as JScheduler
from repro.serve.speculative import accept_greedy as j_accept

import repro_torch.serve.cache as TC
import repro_torch.serve.pages as TPG
from repro_torch.configs.registry import get
from repro_torch.models import transformer
from repro_torch.serve.scheduler import Scheduler as TScheduler
from repro_torch.serve.speculative import accept_greedy as t_accept

torch.set_num_threads(1)


def _prompt(rng, n):
    return rng.randint(0, 1000, n).astype(np.int32)


def _state(pt):
    return {"free": list(pt._free), "ref": pt.ref.tolist(),
            "lru": list(pt._lru), "index": dict(pt._index),
            "meta": {p: (d, c.tolist()) for p, (d, c) in pt._meta.items()},
            "stats": pt.stats(), "available": pt.available()}


class Twin:
    """One page-table operation on both packages' tables: the same
    result, the same exception, the same state after."""

    def __init__(self, num_pages, page_size, hash_fn=None):
        self.j = JPG.PageTable(num_pages, page_size, hash_fn)
        self.t = TPG.PageTable(num_pages, page_size, hash_fn)

    def __call__(self, op, *args):
        out = []
        for pt, full in ((self.j, JPG.PagePoolFull),
                         (self.t, TPG.PagePoolFull)):
            try:
                out.append(("ok", getattr(pt, op)(*args)))
            except full:
                out.append(("full", None))
        assert out[0] == out[1], (op, args, out)
        assert _state(self.j) == _state(self.t), (op, args)
        return out[1]


@pytest.mark.parametrize("seed", range(12))
def test_page_table_matches_reference_on_random_ops(seed):
    _random_ops(seed)


def test_random_ops_fill_the_pool():
    """The sequences above do run the tables out of pages."""
    assert sum(_random_ops(seed) for seed in range(12)) > 0


def _random_ops(seed):
    rng = np.random.RandomState(seed)
    page_size = int(rng.randint(1, 9))
    twin = Twin(int(2 ** rng.randint(2, 7)), page_size)
    held = []
    prompts = [_prompt(rng, rng.randint(1, 4 * page_size)) for _ in range(4)]
    fulls = 0
    for _ in range(120):
        op = rng.randint(5)
        if op == 0:                                   # a span, page by page
            span = []
            for _ in range(rng.randint(1, 4)):
                kind, pid = twin("alloc")
                if kind == "full":
                    fulls += 1
                    break
                span.append(pid)
            held.append(span)
        elif op == 1 and held:
            twin("release", held.pop(rng.randint(len(held))))
        elif op == 2:                                 # match + register
            p = prompts[rng.randint(len(prompts))]
            _, m = twin("match_prefix", p)
            span = list(m)
            for _ in range(TPG.pages_for(len(p), page_size) - len(m)):
                kind, pid = twin("alloc")
                if kind == "full":
                    break
                span.append(pid)
            else:
                twin("register_prefix", p, span)
            held.append(span)
        elif op == 3 and held and any(held):
            span = [s for s in held if s][rng.randint(sum(map(bool, held)))]
            i = rng.randint(len(span))
            twin("shared", span[i])
            kind, res = twin("writable", span[i])
            if kind == "ok":
                span[i] = res[0]
        else:
            twin("active_pages")
            twin("cached_pages")
        twin.t.check_invariants()
    for span in held:
        twin("release", span)
    twin.t.check_invariants()
    assert twin.t.active_pages() == 0
    return fulls


def test_collision_falls_back_to_token_ids():
    """A hash that collides for every chunk: the match stops at a stored
    chunk whose token ids differ, in both packages."""
    twin = Twin(16, 4, hash_fn=lambda parent, chunk: b"same")
    a = np.arange(9, dtype=np.int32)
    b = a + 100
    span = [twin("alloc")[1] for _ in range(3)]
    twin("register_prefix", a, span)
    assert twin("match_prefix", b)[1] == []
    assert twin("match_prefix", a)[1] == span[:1]


def test_pool_full_and_release_errors():
    twin = Twin(4, 2)
    pids = [twin("alloc")[1] for _ in range(3)]
    assert twin("alloc")[0] == "full"
    twin("release", pids)
    with pytest.raises(ValueError):
        twin.t.release([pids[0]])
    with pytest.raises(ValueError, match="2 pages"):
        TPG.PageTable(1, 4)
    with pytest.raises(ValueError, match="page_size"):
        TPG.PageTable(4, 0)


@given(st.integers(0, 500), st.integers(2, 6), st.integers(1, 8))
@settings(max_examples=40, deadline=None)
def test_no_leaks_under_random_ops(seed, log_pages, page_size):
    """The reference's property sequence, with the test's own page
    accounting kept: a span that ``PagePoolFull`` interrupts releases the
    pages it got, and a copy-on-write under a full pool is caught."""
    rng = np.random.RandomState(seed)
    num_pages = 2 ** log_pages
    pt = TPG.PageTable(num_pages, page_size)
    held = []
    prompts = [_prompt(rng, rng.randint(1, 4 * page_size)) for _ in range(4)]
    for _ in range(60):
        op = rng.randint(4)
        if op == 0:
            span = []
            try:
                for _ in range(rng.randint(1, 4)):
                    span.append(pt.alloc())
                held.append(span)
            except TPG.PagePoolFull:
                pt.release(span)
        elif op == 1 and held:
            pt.release(held.pop(rng.randint(len(held))))
        elif op == 2:
            p = prompts[rng.randint(len(prompts))]
            m = pt.match_prefix(p)
            fresh = []
            try:
                for _ in range(TPG.pages_for(len(p), page_size) - len(m)):
                    fresh.append(pt.alloc())
            except TPG.PagePoolFull:
                pt.release(m + fresh)
                continue
            pt.register_prefix(p, m + fresh)
            held.append(m + fresh)
        elif op == 3 and held:
            span = held[rng.randint(len(held))]
            if span:
                i = rng.randint(len(span))
                try:
                    span[i] = pt.writable(span[i])[0]
                except TPG.PagePoolFull:
                    pass
        pt.check_invariants()
    for span in held:
        pt.release(span)
    pt.check_invariants()
    assert pt.active_pages() == 0
    assert pt.available() == num_pages - 1


@pytest.mark.parametrize("seed", range(4))
def test_refcount_zero_exactly_at_last_release(seed):
    rng = np.random.RandomState(seed)
    pt = TPG.PageTable(32, 4)
    prompt = _prompt(rng, 4 * rng.randint(2, 5) + 1)
    n = TPG.pages_for(len(prompt), 4)
    base = [pt.alloc() for _ in range(n)]
    pt.register_prefix(prompt, base)
    users = [base]
    for _ in range(rng.randint(1, 4)):
        m = pt.match_prefix(prompt)
        users.append(m + [pt.alloc() for _ in range(n - len(m))])
    shared = base[:(len(prompt) - 1) // 4]
    for i, span in enumerate(users):
        for pid in shared:
            assert pt.ref[pid] == len(users) - i
        pt.release(span)
        pt.check_invariants()
    for pid in shared:                      # parked, not freed
        assert pt.ref[pid] == 0 and pid in pt._lru


def test_shared_page_never_handed_out_writable():
    rng = np.random.RandomState(1)
    pt = TPG.PageTable(64, 8)
    prompt = _prompt(rng, 33)
    n = TPG.pages_for(len(prompt), 8)
    base = [pt.alloc() for _ in range(n)]
    pt.register_prefix(prompt, base)
    m = pt.match_prefix(prompt)
    spans = [base, m + [pt.alloc() for _ in range(n - len(m))]]
    for span in spans:
        for i, pid in enumerate(span):
            was_shared = pt.shared(pid)
            new, copy = pt.writable(pid)
            assert copy == (new != pid) == was_shared
            assert pt.ref[new] == 1 and new not in pt._meta
            span[i] = new
            pt.check_invariants()
    for span in spans:
        pt.release(span)
    pt.check_invariants()


# ---------------------------------------------------------------------------
# the device pool and the slab cache
# ---------------------------------------------------------------------------

def test_copy_pages_copies_every_leaf_in_place():
    pool = {"b0": {"k": torch.arange(48, dtype=torch.float32)
                   .reshape(2, 4, 3, 2),
                   "v": -torch.arange(48, dtype=torch.float32)
                   .reshape(2, 4, 3, 2)}}
    before = {k: v.clone() for k, v in pool["b0"].items()}
    out = TPG.copy_pages(pool, 1, 3)
    assert out is pool
    for k, v in pool["b0"].items():
        assert torch.equal(v[:, 3], before[k][:, 1])
        assert torch.equal(v[:, :3], before[k][:, :3])
    assert TPG.pool_bytes(pool) == 2 * 48 * 4


def test_init_page_pool_refuses_window_archs():
    cfg = get("mixtral-8x7b", smoke=True)
    assert cfg.window is not None
    with pytest.raises(ValueError, match="sliding-window"):
        TPG.init_page_pool(transformer, cfg, 8, 4, device="cpu")
    pool = TPG.init_page_pool(transformer, get("gpt2-small", smoke=True),
                              8, 4, device="cpu")
    assert pool["b0"]["k"].shape[1:3] == (8, 4)


def test_pages_for_matches_reference():
    for n in range(1, 40):
        for p in (1, 4, 8, 16):
            assert TPG.pages_for(n, p) == JPG.pages_for(n, p)


def test_prompt_buckets_match_reference():
    for max_prompt in (1, 7, 8, 9, 16, 100, 128, 255, 256):
        for lo in (1, 4, 8):
            assert TC.prompt_buckets(max_prompt, lo) == \
                JC.prompt_buckets(max_prompt, lo)
    b = TC.prompt_buckets(100)
    for n in range(1, 101):
        assert TC.bucket_for(n, b) == JC.bucket_for(n, b)
    with pytest.raises(ValueError, match="largest bucket"):
        TC.bucket_for(101, b)


def test_write_and_reset_slot():
    cfg = dataclasses.replace(get("gpt2-small", smoke=True), num_layers=2)
    caches = TC.init_slot_caches(transformer, cfg, 3, 8, device="cpu")
    one = TC.init_slot_caches(transformer, cfg, 1, 8, device="cpu")
    for leaf in (one["b0"]["k"], one["b0"]["v"]):
        leaf.normal_()
    TC.write_slot(caches, one, 2)
    for key in ("k", "v"):
        assert torch.equal(caches["b0"][key][:, 2], one["b0"][key][:, 0])
        assert not caches["b0"][key][:, :2].any()
    TC.reset_slot(caches, 2)
    assert not caches["b0"]["k"].any()
    leaf = caches["b0"]["k"]
    assert TC.slot_bytes(caches, 3) == 2 * leaf.numel() * 2 // 3


# ---------------------------------------------------------------------------
# the scheduler and the acceptance rule
# ---------------------------------------------------------------------------

def _sched_state(s):
    slot = lambda r: None if r is None else (r.req_id, list(r.tokens),
                                             r.slot)
    return {"queue": [r.req_id for r in s.queue],
            "slots": [slot(r) for r in s.slots],
            "done": [(r.req_id, list(r.tokens), r.ttft_s, r.finish_t,
                      r.metrics()) for r in s.done],
            "snapshot": s.snapshot(), "stats": s.stats(),
            "active": s.active_slots, "idle": s.idle}


def test_scheduler_matches_reference_on_one_call_sequence():
    rng = np.random.RandomState(0)
    j, t = JScheduler(3), TScheduler(3)
    now = 0.0
    for step in range(80):
        now += 0.5
        op = rng.randint(4)
        if op == 0:
            kw = dict(max_new_tokens=int(rng.randint(1, 6)),
                      eos_token=int(rng.randint(0, 5)) if rng.rand() < .5
                      else None, seed=step, now=now)
            p = rng.randint(0, 9, rng.randint(1, 6))
            assert j.submit(p, **kw).req_id == t.submit(p, **kw).req_id
        elif op == 1:
            gate = (lambda r: len(r.prompt) < 4) if rng.rand() < .5 else None
            assert [(s, r.req_id) for s, r in j.fills(gate)] == \
                [(s, r.req_id) for s, r in t.fills(gate)]
        else:
            for slot in j.active_slots:
                tok = int(rng.randint(0, 5))
                call = "started" if not j.slots[slot].tokens else "token"
                a = getattr(j, call)(slot, tok, now=now)
                b = getattr(t, call)(slot, tok, now=now)
                assert (a is None) == (b is None)
        assert _sched_state(j) == _sched_state(t)
    with pytest.raises(ValueError, match="max_new_tokens"):
        t.submit(np.arange(3), max_new_tokens=0)


def test_accept_greedy_matches_reference():
    rng = np.random.RandomState(0)
    for _ in range(200):
        k = int(rng.randint(1, 6))
        props = rng.randint(0, 3, k)
        target = rng.randint(0, 3, k + 1)
        assert t_accept(props, target, k) == j_accept(props, target, k)
    props = np.asarray([7, 8, 9])
    assert t_accept(props, np.asarray([7, 8, 5, 1]), 3) == 2
    assert t_accept(props, np.asarray([7, 8, 9, 4]), 3) == 3
    assert t_accept(props, np.asarray([1, 2, 3, 4]), 3) == 0
