"""The port's continuous-batching serving against the JAX package.

Params go JAX -> numpy -> ``params_from_numpy``; the model is gpt2-small
smoke with ``num_layers=4``, so the 4-stage presets have 3 compressed cuts
as at full width.  Tolerances are ``tests/test_torch_serve.py``'s:
``LOGIT_ATOL`` (0.03) on logits, ``REL_TOL`` (2**-5 of the largest
magnitude) on KV caches and pools, the reference's cut inputs pinned into
the port's boundaries row by row (``PinnedRows``, which also covers the
per-(request, token) cuts of ``decode_span``), and greedy streams that
may part only at a step where the reference's top-2 logits are within
``2 * LOGIT_ATOL``.

The port's own invariants (continuous == solo, chunking, prefix hits,
tight pools, speculative == greedy, sampled streams) hold BITWISE on the
CPU, as the reference's do under XLA.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.models.transformer as JT
import repro.serve.engine as JE
from repro.configs.registry import get as jget
from repro.launch.train import POLICIES as JPOL

import repro_torch.models.transformer as TT
from repro_torch.checkpoint.convert import params_from_numpy, tensor_from_numpy
from repro_torch.configs.registry import get as tget
from repro_torch.core.policy import POLICIES as TPOL
from repro_torch.serve import pages as PG
from repro_torch.serve.engine import ContinuousEngine
from repro_torch.serve.sampling import SamplingConfig

from test_torch_serve import LOGIT_ATOL, REL_TOL, _assert_rel, _f32

torch.set_num_threads(1)

POLICY_NAMES = ["none", "q4q8", "top10"]


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jget("gpt2-small", smoke=True), num_layers=4)
    tcfg = dataclasses.replace(tget("gpt2-small", smoke=True), num_layers=4)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


class PinnedRows:
    """Pinned cuts (``test_torch_serve.PinnedCuts``) row by row, over both
    of the reference's serve boundaries: ``boundary_wire_eval`` (prefill,
    decode_step; a row is one request's payload) and
    ``boundary_wire_eval_tokens`` (decode_span; a row is one token's).

    The reference's (input, output) rows are recorded; each row of a
    port cut's input is matched to the recorded row nearest to it, and a
    match within ``REL_TOL`` of that row's largest magnitude is REPLACED
    by the reference's input, whose output must then be bitwise the
    reference's.  Rows are packed independently, so matching by content
    pins a run whose cut calls come in another order or batch (a
    speculative run against greedy decode) as well as one in lock step.
    A row with no match (a rejected proposal, a stream after a parting)
    keeps its own input: ``hits`` / ``misses`` count both.

    ``jitted=True`` (the engine streams): the reference ran under
    ``jax.jit``, whose q4 scale ``span * f32(1/15)`` may move a code (see
    ``test_torch_serve.PinnedCuts``), so a pinned row's OUTPUT is the
    reference's as well; the codec's own bits are held eagerly by the
    function-level tests here and in ``tests/test_torch_serve.py``."""

    def __init__(self, monkeypatch, jitted=False, modules=None,
                 names=("boundary_wire_eval", "boundary_wire_eval_tokens")):
        """``modules``: the (reference, port) modules whose boundaries are
        pinned, the decoder-only stacks' by default."""
        self.bank, self.hits, self.misses = {}, 0, 0
        self.jitted = jitted
        self.modules = modules or (JT, TT)
        for name in names:
            self._pin(monkeypatch, name)

    @staticmethod
    def _rows(name, a):
        lead = a.shape[0] if name == "boundary_wire_eval" else \
            a.shape[0] * a.shape[1]
        return a.reshape(lead, -1)

    def _pin(self, monkeypatch, name):
        jmod, tmod = self.modules
        orig_j, orig_t = getattr(jmod, name), getattr(tmod, name)

        def keep(x, y):
            xr, yr = self._rows(name, np.asarray(x)), self._rows(
                name, np.asarray(y))
            self.bank.setdefault((name, xr.shape[1]), []).append((xr, yr))

        def record(policy, x, compress):
            y = orig_j(policy, x, compress)
            if compress and policy.fw.kind != "none":
                jax.debug.callback(keep, x, y)      # runs under jit too
            return y

        def replay(policy, x, compress):
            if not compress or policy.fw.kind == "none":
                return orig_t(policy, x, compress)
            jax.effects_barrier()
            rows = self._rows(name, x).clone()
            bank = self.bank.get((name, rows.shape[1]), [])
            jx = np.concatenate([r for r, _ in bank]) if bank else \
                np.zeros((0, rows.shape[1]), np.float32)
            jy = np.concatenate([r for _, r in bank]) if bank else jx
            ref = jx.astype(np.float32)
            scale = np.maximum(np.abs(ref).max(1), 1e-6) if len(ref) else ref
            got = rows.float().numpy()
            pinned = {}
            for i, row in enumerate(got):
                if not len(ref):
                    break
                gap = np.abs(ref - row).max(1) / scale
                j = int(np.argmin(gap))
                if gap[j] <= REL_TOL:
                    pinned[i] = j
                    rows[i] = tensor_from_numpy(jx[j], x.device)
            self.hits += len(pinned)
            self.misses += len(got) - len(pinned)
            y = orig_t(policy, rows.reshape(x.shape), compress)
            yr = self._rows(name, y)
            for i, j in pinned.items():
                want = tensor_from_numpy(jy[j], x.device)
                if self.jitted:
                    yr[i] = want
                else:
                    assert torch.equal(yr[i], want), \
                        f"{name}: a pinned row's output is not the " \
                        "reference's"
            return yr.reshape(x.shape)

        monkeypatch.setattr(jmod, name, record)
        monkeypatch.setattr(tmod, name, replay)


# ---------------------------------------------------------------------------
# decode_step with per-slot positions, decode_span (slab and paged)
# ---------------------------------------------------------------------------

def _prefilled(models, rng, b=3, s=12, cache_len=32):
    """Both packages' slab caches after an uncompressed left-padded
    prefill (the decode under test is what crosses compressed cuts)."""
    jcfg, tcfg, jp, tp = models
    toks = rng.randint(0, jcfg.vocab_size, (b, s))
    pad = np.array([0, 4, 9])[:b]
    _, jc = JT.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jcfg,
                       cache_len=cache_len,
                       pad_len=jnp.asarray(pad, jnp.int32))
    _, tc = TT.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                       cache_len=cache_len, pad_len=torch.from_numpy(pad))
    for key in ("k", "v"):
        _assert_rel(tc["b0"][key], jc["b0"][key], f"prefill cache {key}")
    return jc, tc, pad


@pytest.mark.parametrize("policy", ["q4q8", "top10"])
def test_token_cuts_match_reference(policy):
    """``boundary_wire_eval_tokens``: bitwise the reference's (eager), and
    bitwise the port's per-request cut of each token alone."""
    from repro.core.boundary import boundary_wire_eval_tokens as jtokens
    from repro_torch.core import boundary as TB
    x = np.random.RandomState(8).randn(2, 5, 256).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = tensor_from_numpy(np.asarray(xj), "cpu")
    with jax.disable_jit():
        want = jtokens(JPOL[policy]().at(0), xj, True)
    got = TB.boundary_wire_eval_tokens(TPOL[policy]().at(0), xt, True)
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    assert torch.equal(got, tensor_from_numpy(np.asarray(want), "cpu"))
    for t in range(5):
        one = TB.boundary_wire_eval(TPOL[policy]().at(0), xt[:, t:t + 1],
                                    True)
        assert torch.equal(got[:, t:t + 1], one)


@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_decode_step_per_slot_positions_match(models, policy, monkeypatch):
    """Three decode steps, one position per slot, against the jitted
    reference with the cuts pinned row by row."""
    jcfg, tcfg, jp, tp = models
    rng = np.random.RandomState(3)
    jc, tc, pad = _prefilled(models, rng)
    cuts = PinnedRows(monkeypatch, jitted=True)
    step = jax.jit(lambda tok, c, pos: JT.decode_step(
        jp, tok, c, pos, jcfg, JPOL[policy](),
        pad_len=jnp.asarray(pad, jnp.int32), wire=True))
    pos = np.array([12, 15, 20])
    for i in range(3):
        tok = rng.randint(0, jcfg.vocab_size, 3)
        jl, jc = step(jnp.asarray(tok, jnp.int32), jc,
                      jnp.asarray(pos + i, jnp.int32))
        tl, tc = TT.decode_step(tp, torch.from_numpy(tok), tc,
                                torch.from_numpy(pos + i), tcfg,
                                TPOL[policy](),
                                pad_len=torch.from_numpy(pad), wire=True)
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=0,
                                   atol=LOGIT_ATOL)
    for key in ("k", "v"):
        _assert_rel(tc["b0"][key], jc["b0"][key], f"decode cache {key}")
    assert cuts.misses == 0
    assert cuts.hits == (0 if policy == "none" else 3 * 3 * 3)


def _paged_inputs(rng, vocab, page=8, slot_pages=4, pages=10):
    """Two slots of a page pool: slot 0 a 12-token chunk at position 0 of
    which 9 are valid, slot 1 a 12-token chunk at position 5 (pages out of
    order, one logical page left on the trash page)."""
    toks = rng.randint(0, vocab, (2, 12))
    pos = np.array([0, 5])
    page_map = np.array([[3, 1, 0, 0], [2, 7, 5, 0]])
    valid = np.array([9, 12])
    return toks, pos, page_map, valid, (pages, page)


@pytest.mark.parametrize("policy", POLICY_NAMES)
@pytest.mark.parametrize("form", ["slab", "paged"])
def test_decode_span_matches_reference(models, policy, form, monkeypatch):
    """Spans against the jitted reference, cuts pinned row by row (the
    per-token cut's own bits: test_token_cuts_match_reference)."""
    jcfg, tcfg, jp, tp = models
    rng = np.random.RandomState(4)
    if form == "slab":
        jc, tc, pad = _prefilled(models, rng)
        toks = rng.randint(0, jcfg.vocab_size, (3, 4))
        pos = np.array([12, 14, 17])
        jkw = dict(pad_len=jnp.asarray(pad, jnp.int32))
        tkw = dict(pad_len=torch.from_numpy(pad))
    else:
        toks, pos, pmap, valid, (n, p) = _paged_inputs(rng, jcfg.vocab_size)
        jc = JT.init_caches(jcfg, n, p)
        tc = TT.init_caches(tcfg, n, p, device="cpu")
        jkw = dict(page_map=jnp.asarray(pmap, jnp.int32),
                   valid_len=jnp.asarray(valid, jnp.int32))
        tkw = dict(page_map=torch.from_numpy(pmap),
                   valid_len=torch.from_numpy(valid))
    cuts = PinnedRows(monkeypatch, jitted=True)
    span = jax.jit(lambda c: JT.decode_span(
        jp, jnp.asarray(toks, jnp.int32), c, jnp.asarray(pos, jnp.int32),
        jcfg, JPOL[policy](), **jkw))
    jl, jc = span(jc)
    tl, tc = TT.decode_span(tp, torch.from_numpy(toks), tc,
                            torch.from_numpy(pos), tcfg, TPOL[policy](),
                            **tkw)
    assert tl.shape == (toks.shape[0], toks.shape[1], jcfg.vocab_size)
    live = np.ones(toks.shape, bool)
    if form == "paged":
        live = np.arange(toks.shape[1])[None] < valid[:, None]
    np.testing.assert_allclose(_f32(tl)[live], _f32(jl)[live], rtol=0,
                               atol=LOGIT_ATOL)
    for key in ("k", "v"):
        got, want = tc["b0"][key], jc["b0"][key]
        if form == "paged":     # the trash page takes colliding writes
            got, want = got[:, 1:], want[:, 1:]
        _assert_rel(got, want, f"{form} span cache {key}")
    assert cuts.misses == 0
    assert cuts.hits == (0 if policy == "none" else 3 * toks.size)


@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_decode_span_of_one_token_is_decode_step(models, policy):
    """T = 1 of ``decode_span`` over a slab cache is ``decode_step`` with
    per-slot positions, bit for bit (logits and caches)."""
    _, tcfg, _, tp = models
    rng = np.random.RandomState(5)
    toks = rng.randint(0, tcfg.vocab_size, (3, 12))
    pad = torch.tensor([0, 4, 9])
    _, caches = TT.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                           TPOL[policy](), cache_len=32, pad_len=pad,
                           wire=True)
    twin = {b: {k: v.clone() for k, v in c.items()}
            for b, c in caches.items()}
    pos = torch.tensor([12, 13, 16])
    for i in range(3):
        tok = torch.from_numpy(rng.randint(0, tcfg.vocab_size, 3))
        a, caches = TT.decode_step(tp, tok, caches, pos + i, tcfg,
                                   TPOL[policy](), pad_len=pad, wire=True)
        b, twin = TT.decode_span(tp, tok[:, None], twin, pos + i, tcfg,
                                 TPOL[policy](), pad_len=pad)
        assert torch.equal(a, b[:, 0])
    for key in ("k", "v"):
        assert torch.equal(caches["b0"][key], twin["b0"][key])


def test_decode_span_needs_the_wire(models):
    _, tcfg, _, tp = models
    with pytest.raises(NotImplementedError, match="wire"):
        TT.decode_span(tp, torch.zeros((1, 2), dtype=torch.int64),
                       TT.init_caches(tcfg, 1, 8, device="cpu"),
                       torch.tensor([0]), tcfg, TPOL["top10"](), wire=False)


def test_integer_decode_position_unchanged(models):
    """The static engine's int-position path: an int ``pos`` and the
    same position for every slot as a (B,) tensor give the same bits."""
    _, tcfg, _, tp = models
    rng = np.random.RandomState(6)
    toks = torch.from_numpy(rng.randint(0, tcfg.vocab_size, (2, 10)))
    pad = torch.tensor([0, 3])
    _, ca = TT.prefill(tp, {"tokens": toks}, tcfg, cache_len=16, pad_len=pad)
    cb = {b: {k: v.clone() for k, v in c.items()} for b, c in ca.items()}
    tok = torch.tensor([5, 9])
    la, ca = TT.decode_step(tp, tok, ca, 10, tcfg, pad_len=pad)
    lb, cb = TT.decode_step(tp, tok, cb, torch.tensor([10, 10]), tcfg,
                            pad_len=pad)
    assert torch.equal(la, lb)
    assert torch.equal(ca["b0"]["k"], cb["b0"]["k"])


# ---------------------------------------------------------------------------
# the engine against the reference's
# ---------------------------------------------------------------------------

class StreamGaps:
    """The reference engine's top-2 logit gap at every (request, step) of
    its greedy streams: its ``sample_tokens`` is wrapped to keep the last
    logits, its scheduler's ``started`` / ``token`` to read them for the
    slot the token belongs to (``tick_chunk=1``: no multi-tick scan)."""

    def __init__(self, monkeypatch, eng):
        self.gaps, self.last = {}, None
        orig = JE.sample_tokens

        def keep(a):
            self.last = np.asarray(a, np.float32)

        def sample(logits, keys, cfg):
            jax.debug.callback(keep, logits)        # runs under jit too
            return orig(logits, keys, cfg)

        monkeypatch.setattr(JE, "sample_tokens", sample)
        sched = eng.sched
        started, token = sched.started, sched.token

        def on_started(slot, tok, now=None):
            self._gap(sched.slots[slot], 0)
            return started(slot, tok, now)

        def on_token(slot, tok, now=None):
            self._gap(sched.slots[slot], slot)
            return token(slot, tok, now)

        monkeypatch.setattr(sched, "started", on_started)
        monkeypatch.setattr(sched, "token", on_token)

    def _gap(self, req, row):
        jax.effects_barrier()
        top2 = np.sort(self.last[row])[-2:]
        self.gaps[(req.req_id, len(req.tokens))] = float(top2[1] - top2[0])


def _assert_streams(got, want, gaps):
    """Equal token for token, except a parting at a near-tie (see module
    doc); later tokens of a parted stream are not compared."""
    compared = total = 0
    for rid, ref in want.items():
        out = got[rid]
        assert out.shape == ref.shape, (rid, out, ref)
        total += len(ref)
        for i in range(len(ref)):
            if out[i] != ref[i]:
                assert gaps[(rid, i)] <= 2 * LOGIT_ATOL, \
                    f"request {rid} parts at step {i} without a near-tie " \
                    f"(gap {gaps[(rid, i)]})"
                break
            compared += 1
    assert compared >= total // 2


def _workload(vocab, n=6, seed=7):
    rng = np.random.RandomState(seed)
    lens = [5, 19, 7, 30, 12, 3, 26, 9][:n]
    news = [6, 3, 9, 4, 1, 7, 5, 8][:n]
    return [rng.randint(1, vocab, l) for l in lens], news


def _drain(eng, prompts, news, eos=None, seeds=None):
    for i, (p, n) in enumerate(zip(prompts, news)):
        eng.submit(p, max_new_tokens=n, eos_token=eos,
                   seed=0 if seeds is None else seeds[i])
    return {r.req_id: np.asarray(r.out) for r in eng.drain()}


MODES = {   # engine keywords of both packages for each serving mode
    "slab": dict(num_slots=3, max_seq=96, tick_chunk=1),
    "paged": dict(num_slots=3, max_seq=96, tick_chunk=1, prefix_cache=True,
                  prefill_chunk=8, page_size=8),
    "speculative": dict(num_slots=3, max_seq=96, tick_chunk=1,
                        prefix_cache=True, prefill_chunk=8, page_size=8,
                        spec_k=3),
}


@pytest.mark.parametrize("mode,policy", [("slab", "none"), ("slab", "q4q8"),
                                         ("slab", "top10"),
                                         ("paged", "none"),
                                         ("paged", "top10"),
                                         ("speculative", "q4q8")])
def test_continuous_streams_match_reference(models, mode, policy,
                                            monkeypatch):
    """Greedy streams of the port's ContinuousEngine against the
    reference's on the same params and requests, cuts pinned row by row.
    The port's speculative run (a seed-9 draft) is held to the reference's
    PAGED greedy streams, which are the reference's speculative output."""
    jcfg, tcfg, jp, tp = models
    kw = dict(MODES[mode])
    spec_k = kw.pop("spec_k", None)
    prompts, news = _workload(jcfg.vocab_size)
    ref = JE.ContinuousEngine(jp, jcfg, JPOL[policy](), **kw)
    gaps = StreamGaps(monkeypatch, ref)
    cuts = PinnedRows(monkeypatch, jitted=True)
    want = _drain(ref, [p.astype(np.int32) for p in prompts], news)
    if spec_k:
        draft = TT.init_params(torch.Generator().manual_seed(9), tcfg)
        kw.update(spec_k=spec_k, draft_params=draft, draft_cfg=tcfg,
                  draft_policy=TPOL[policy]())
    eng = ContinuousEngine(tp, tcfg, TPOL[policy](), device="cpu", **kw)
    got = _drain(eng, prompts, news)
    _assert_streams(got, want, gaps.gaps)
    if policy != "none":            # the target's rows are pinned
        assert cuts.hits > (0 if spec_k else cuts.misses), \
            (cuts.hits, cuts.misses)
    if spec_k:
        assert eng.stats()["proposed"] > 0


# ---------------------------------------------------------------------------
# the port's own invariants, bitwise
# ---------------------------------------------------------------------------

TOP10 = "top10"


def _engine(models, policy=TOP10, **kw):
    _, tcfg, _, tp = models
    kw.setdefault("num_slots", 3)
    kw.setdefault("max_seq", 96)
    return ContinuousEngine(tp, tcfg, TPOL[policy](), device="cpu", **kw)


def _solo(models, prompts, news, seeds=None, **kw):
    eng = _engine(models, **kw)
    out = {}
    for i, (p, n) in enumerate(zip(prompts, news)):
        eng.submit(p, max_new_tokens=n, seed=0 if seeds is None else seeds[i])
        (r,) = eng.drain()
        out[i] = np.asarray(r.out)
    return out


def _assert_same(a, b, what):
    assert a.keys() == b.keys(), what
    for i in a:
        np.testing.assert_array_equal(a[i], b[i], err_msg=f"{what}: req {i}")


CONFIGS = {
    "slab greedy": {},
    "slab greedy, 4-tick chunks": {"tick_chunk": 4},
    "slab sampled": {"sampling": SamplingConfig(1.0, 50, 0.9)},
    "paged greedy, prefix cache": {"prefix_cache": True, "prefill_chunk": 8,
                                   "page_size": 8},
    "paged sampled": {"prefill_chunk": 8, "page_size": 8,
                      "sampling": SamplingConfig(0.8, 40)},
}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_continuous_equals_solo(models, config):
    """A request's tokens are those it gets alone: mixed prompt lengths,
    mixed max-new-tokens, greedy and sampled (its own generator, seeded
    with its seed)."""
    kw = CONFIGS[config]
    prompts, news = _workload(512, n=8)
    seeds = list(range(100, 108))
    batched = _drain(_engine(models, **kw), prompts, news, seeds=seeds)
    _assert_same(batched, _solo(models, prompts, news, seeds, **kw), config)
    if kw.get("sampling"):
        again = _drain(_engine(models, **kw), prompts, news, seeds=seeds)
        _assert_same(batched, again, f"{config}, twice")


def test_multi_tick_chunk_keeps_the_stream(models):
    """``tick_chunk`` decode steps with one host sync give the tokens of
    one tick at a time, greedy and sampled."""
    prompts, news = _workload(512, n=4)
    news = [12, 9, 10, 11]
    for smp in (SamplingConfig(), SamplingConfig(0.9, 30)):
        ticks = {}
        for chunk in (1, 4):
            eng = _engine(models, sampling=smp, tick_chunk=chunk)
            ticks[chunk] = _drain(eng, prompts, news, seeds=[1, 2, 3, 4])
        _assert_same(ticks[1], ticks[4], smp.name)


def test_chunk_size_never_changes_output(models):
    prompts, _ = _workload(512, n=4, seed=1)
    ref = None
    for chunk, prefix in ((None, True), (4, False), (8, True), (16, False)):
        out = _drain(_engine(models, num_slots=2, prefix_cache=prefix,
                             prefill_chunk=chunk), prompts, [6] * 4)
        if ref is None:
            ref = out
        _assert_same(ref, out, f"chunk={chunk} prefix={prefix}")


def test_prefix_hits_reuse_pages_and_keep_output(models):
    rng = np.random.RandomState(2)
    shared = rng.randint(1, 512, 24)
    prompts = [np.concatenate([shared, rng.randint(1, 512, n)])
               for n in (5, 9, 3)]
    kw = dict(prefix_cache=True, prefill_chunk=8, page_size=8)
    cold = _solo(models, prompts, [6] * 3, **kw)
    eng = _engine(models, num_slots=2, **kw)
    warm = _drain(eng, prompts, [6] * 3)
    warm2 = _drain(eng, prompts, [6] * 3)
    _assert_same(cold, warm, "prefix hit")
    _assert_same(cold, {i - 3: v for i, v in warm2.items()}, "second pass")
    s = eng.stats()
    assert s["prefix_hits"] >= 3 and s["prefix_hit_tokens"] >= 3 * 16
    eng.pages.check_invariants()
    assert eng.pages.active_pages() == 0


def test_tight_pool_backpressure_same_output(models):
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 512, rng.randint(3, 30)) for _ in range(8)]
    kw = dict(num_slots=2, max_seq=64, prefix_cache=True, prefill_chunk=8,
              page_size=8)
    big = _drain(_engine(models, **kw), prompts, [6] * 8)
    tight = _engine(models, num_pages=12, **kw)
    _assert_same(big, _drain(tight, prompts, [6] * 8), "tight pool")
    tight.pages.check_invariants()
    assert tight.stats()["active_pages"] == 0


def _filler(n, seed=13):
    return np.random.RandomState(seed + n).randint(1, 512, n)


FULL = {   # requests whose last write lands on max_seq - 1 (max_seq 32)
    "slab, last decode at the last row": (
        dict(tick_chunk=1), [(10, 17), (3, 25)]),
    "slab, 4-tick chunks": (dict(tick_chunk=4), [(10, 17), (3, 25)]),
    "slab, one token from a full bucket": (
        dict(tick_chunk=1), [(20, 1), (3, 10)]),
    "paged, last chunk padded past the last page": (
        dict(prefill_chunk=12, page_size=8), [(30, 2), (5, 9)]),
}


@pytest.mark.parametrize("case", list(FULL))
def test_requests_that_fill_the_cache(models, case):
    """A request may use the cache to its last row beside a longer one:
    its slot idles afterwards, and a padded prefill chunk may reach past
    the slot's last page; the streams are those of each request alone."""
    kw, reqs = FULL[case]
    kw = dict(kw, max_seq=32, max_prompt=32)
    prompts = [_filler(n) for n, _ in reqs]
    news = [n for _, n in reqs]
    _assert_same(_drain(_engine(models, **kw), prompts, news),
                 _solo(models, prompts, news, **kw), case)


def test_warmup_at_a_full_bucket(models):
    """Warm-up serves the largest bucket with the one token that fits
    and then runs an all-idle multi-tick decode; serving goes on as on a
    cold engine."""
    kw = dict(max_seq=32, max_prompt=32, tick_chunk=4)
    prompts, news = [_filler(20), _filler(5)], [1, 12]
    warm = _engine(models, **kw)
    warm.warmup()
    _assert_same(_drain(warm, prompts, news),
                 _drain(_engine(models, **kw), prompts, news), "warm-up")


def test_prefix_hit_bucket_past_the_last_page(models):
    """Without chunks, the prompt's tail after a prefix hit prefills at
    its bucket, which may reach past the slot's last page."""
    kw = dict(max_seq=64, max_prompt=64, prefix_cache=True, page_size=8)
    shared = _filler(40)
    first = np.concatenate([shared, _filler(8)])
    second = np.concatenate([shared, _filler(20)])
    eng = _engine(models, **kw)
    _drain(eng, [first], [2])
    got = _drain(eng, [second], [4])
    assert eng.stats()["prefix_hit_tokens"] == 40
    cold = _drain(_engine(models, **kw), [second], [4])
    np.testing.assert_array_equal(got[1], cold[0])
    eng.pages.check_invariants()


@pytest.mark.parametrize("draft", ["seed-9 draft", "the target itself"])
def test_speculative_equals_greedy(models, draft):
    _, tcfg, _, tp = models
    d = (tp if draft == "the target itself" else
         TT.init_params(torch.Generator().manual_seed(9), tcfg))
    prompts, news = _workload(512, n=5, seed=5)
    kw = dict(prefix_cache=True, prefill_chunk=8)
    spec = _engine(models, policy="q4q8", draft_params=d, draft_cfg=tcfg,
                   draft_policy=TPOL["q4q8"](), spec_k=3, **kw)
    plain = _engine(models, policy="q4q8", **kw)
    _assert_same(_drain(spec, prompts, news), _drain(plain, prompts, news),
                 f"speculative ({draft}) vs greedy")
    st = spec.stats()
    assert st["proposed"] > 0 and 0 <= st["acceptance_rate"] <= 1
    spec.pages.check_invariants()


def test_speculative_with_eos_truncates_identically(models):
    prompts, news = _workload(512, n=3, seed=5)
    probe = _drain(_engine(models, prefix_cache=True), prompts[:1], [6])
    eos = int(probe[0][3])
    d = TT.init_params(torch.Generator().manual_seed(9), models[1])
    spec = _engine(models, prefix_cache=True, draft_params=d,
                   draft_cfg=models[1], draft_policy=TPOL[TOP10](), spec_k=3)
    plain = _engine(models, prefix_cache=True)
    _assert_same(_drain(spec, prompts, news, eos=eos),
                 _drain(plain, prompts, news, eos=eos), "speculative + EOS")


def test_eos_frees_the_slot_early(models):
    """EOS ends a request before max_new_tokens (the stop token included)
    and its slot refills on the next tick."""
    prompts, _ = _workload(512, n=4, seed=11)
    ref = _drain(_engine(models, num_slots=2), prompts, [10] * 4)
    eos = int(ref[0][4])
    eng = _engine(models, num_slots=2)
    for p in prompts:
        eng.submit(p, max_new_tokens=10, eos_token=eos)
    placed, out = {}, {}
    while not eng.sched.idle:
        tick = eng.ticks
        for r in eng.step():
            out[r.req_id] = np.asarray(r.out)
        for slot, r in enumerate(eng.sched.slots):
            if r is not None:
                placed.setdefault(r.req_id, (slot, tick))
    stop = int(np.nonzero(ref[0] == eos)[0][0])
    np.testing.assert_array_equal(out[0], ref[0][:stop + 1])
    for i in (1, 2, 3):
        cut = np.nonzero(ref[i] == eos)[0]
        np.testing.assert_array_equal(
            out[i], ref[i][:cut[0] + 1] if len(cut) else ref[i])
    # request 2 takes request 0's slot right after request 0's last tick
    assert placed[2][0] == 0 and placed[2][1] == stop


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def test_overlong_requests_rejected(models):
    with pytest.raises(ValueError, match="max_seq"):
        _engine(models, max_seq=64).submit(np.zeros(30, np.int64),
                                           max_new_tokens=60)
    with pytest.raises(ValueError, match="max_seq"):
        _engine(models, max_seq=64, prefix_cache=True).submit(
            np.zeros(30, np.int64), max_new_tokens=40)
    with pytest.raises(ValueError, match="pages"):
        _engine(models, max_seq=64, prefix_cache=True, page_size=8,
                num_pages=3).submit(np.zeros(20, np.int64),
                                    max_new_tokens=4)


def test_speculation_is_greedy_only(models):
    _, tcfg, _, tp = models
    with pytest.raises(ValueError, match="greedy"):
        _engine(models, draft_params=tp, draft_cfg=tcfg,
                sampling=SamplingConfig(temperature=1.0))


def test_archs_without_maskable_padding_rejected():
    cfg = tget("rwkv6-3b", smoke=True)
    with pytest.raises(ValueError, match="continuous batching"):
        ContinuousEngine({"embed": torch.zeros(())}, cfg, num_slots=2,
                         device="cpu")


def test_stats_report_the_run(models):
    eng = _engine(models, prefix_cache=True, prefill_chunk=8, page_size=8)
    assert eng.warmup()["warm_s"] >= 0
    assert eng.stats()["ticks"] == 0 and eng.pages.active_pages() == 0
    prompts, news = _workload(512, n=3)
    _drain(eng, prompts, news)
    s = eng.stats()
    assert s["completed"] == 3 and s["sampling"] == "greedy"
    assert s["prefill_chunks"] > 0 and 0 < s["slot_utilization"] <= 1
    assert s["slot_cache_bytes"] == PG.pool_bytes(eng._pool) // 3
    assert not any(k.endswith("_compiles") for k in s)
