"""Gemma2's attention variants (sliding window with its ring cache, the
attention and final logit softcaps, post-norm) and pixtral's vision
frontend, against the JAX package on the same numpy inputs.

Function level, in float32 (``attn_init(..., dtype=float32)``, f32
inputs, d 64, 4 heads, 2 KV heads, head dim 16, window 8):
``attn_train``, ``attn_prefill`` (s < window, s == window, s % window !=
0, a cache shorter than the window) and ``attn_decode`` across the ring's
wrap (an int position and a (B,) position per slot, with ``pad_len``);
``attn_train`` at 4,100 queries, whose logits go in chunks recomputed in
backward, forward and ``jax.grad`` (and bitwise the chunks kept, also
inside a gemma2 train step's group remat at 2,100 tokens).
Outputs and caches within ``F32_RTOL`` = 1e-5 of their largest magnitude
(the two frameworks sum the f32 einsums in their own orders; measured at
most 4.3e-7).  ``softcap`` alone: f32 within ``F32_RTOL`` of the cap,
bf16 within one bf16 ulp of the cap (the jitted reference may turn
``/ cap`` into a product; measured 1.9e-7 of the cap and 0).

Model level, bf16, gemma2-27b smoke (2 local/global groups, window 16,
softcaps 50 and 30, post-norm) and pixtral-12b smoke (2 layers, 8
patches), reference params carried through numpy:
  * one post-norm block of each kind within ``REL_TOL`` = 2**-5 of its
    largest magnitude (tests/test_torch_serve.py's bf16 bound; measured
    0.0045 local, 0.0088 global);
  * greedy streams of a prefill plus 24 decode steps through the static
    ``ServeEngine`` and the slab ``ContinuousEngine`` against the
    reference's (the jitted ``prefill`` / ``decode_step`` loop of its
    static engine, its own ``ContinuousEngine``), under none and q4q8 with
    the cuts pinned row by row: equal, except a parting at a near-tie, as
    tests/test_torch_serve_continuous.py rules;
  * every refusal the reference makes for a window (pages, the prefix
    cache, chunked prefill, speculation, ``attn_decode_span``) and for the
    vision frontend (continuous batching, mixed-length static batches),
    with the reference's message;
  * pixtral's patch splice bitwise, with S >= P and with S < P (P rows
    then, as in the reference).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.models.attention as JA
import repro.models.blocks as JB
import repro.models.common as JCM
import repro.models.transformer as JT
import repro.serve.engine as JE
import repro.serve.pages as JPG
from repro.configs.registry import get as jget
from repro.launch.train import POLICIES as JPOL

import repro_torch.models.attention as TA
import repro_torch.models.blocks as TB
import repro_torch.models.common as TCM
import repro_torch.models.transformer as TT
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.registry import get as tget
from repro_torch.core.policy import POLICIES as TPOL
from repro_torch.serve import pages as TPG
from repro_torch.serve.engine import ContinuousEngine, Request, ServeEngine

from test_torch_serve import _assert_rel
from test_torch_serve_continuous import (PinnedRows, StreamGaps,
                                         _assert_streams)

# One intra-op thread: the suite runs in several worker processes at
# once, and a torch thread pool per worker that outnumbers the cores
# slows its CPU ops by an order of magnitude.
torch.set_num_threads(1)

F32_RTOL = 1e-5
D, H, KV, HD, W = 64, 4, 2, 16, 8
KW = dict(num_heads=H, num_kv_heads=KV, head_dim=HD)
NEW_TOKENS = 24


def _np(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, what, rtol=F32_RTOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    gap = float(np.abs(got - want).max()) if got.size else 0.0
    assert gap <= rtol * max(float(np.abs(want).max()), 1e-6), (what, gap)


@pytest.fixture(scope="module")
def attn():
    jp = JA.attn_init(jax.random.PRNGKey(0), D, H, KV, HD, dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _x(b, s, seed):
    return np.random.RandomState(seed).randn(b, s, D).astype(np.float32)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# the attention functions, float32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,cap", [(None, None), (W, None),
                                        (None, 2.0), (W, 2.0)])
def test_attn_train_matches_reference(attn, window, cap):
    jp, tp = attn
    jx, tx = _both(_x(3, 20, 1))
    pad = np.arange(20)[None] >= np.array([0, 3, 11])[:, None]
    for jm, tm in (_both(pad), (None, None)):
        want = JA.attn_train(jp, jx, window=window, attn_softcap=cap,
                             pad_mask=jm, **KW)
        got = TA.attn_train(tp, tx, window=window, attn_softcap=cap,
                            pad_mask=tm, **KW)
        _close(got, want, f"attn_train {window} {cap} pad {tm is not None}")


@pytest.mark.parametrize("s,cache_len", [(5, 32), (W, 32), (20, 32),
                                         (2 * W, 32), (20, 6)])
@pytest.mark.parametrize("window", [W, None])
def test_attn_prefill_ring_matches_reference(attn, s, cache_len, window):
    """The ring: ``min(window, cache_len)`` rows, position p at row
    ``p % C`` (the reference's roll when s % C != 0)."""
    jp, tp = attn
    jx, tx = _both(_x(2, s, 2))
    pad = np.array([0, min(2, s - 1)])
    jpm, tpm = _both(np.arange(s)[None] >= pad[:, None])
    wo, wc = JA.attn_prefill(jp, jx, cache_len=cache_len, window=window,
                             attn_softcap=2.0, pad_mask=jpm, **KW)
    go, gc = TA.attn_prefill(tp, tx, cache_len=cache_len, window=window,
                             attn_softcap=2.0, pad_mask=tpm, **KW)
    rows = cache_len if window is None else min(window, cache_len)
    assert gc["k"].shape == (2, rows, KV, HD)
    _close(go, wo, "prefill out")
    for key in ("k", "v"):
        _close(gc[key], wc[key], f"prefill cache {key}")


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("window", [W, None])
def test_attn_decode_across_the_ring_wrap(attn, per_slot, window):
    """Prefill 10 tokens, then 12 decode steps (the ring of 8 rows wraps
    more than once), with left-padding; an int position, or one position
    per slot as continuous batching gives them."""
    jp, tp = attn
    s, b, cache_len = 10, 3, 32
    jx, tx = _both(_x(b, s, 3))
    pad = np.array([0, 3, 6])
    jpm, tpm = _both(np.arange(s)[None] >= pad[:, None])
    kw = dict(window=window, attn_softcap=2.0, **KW)
    _, jc = JA.attn_prefill(jp, jx, cache_len=cache_len, pad_mask=jpm, **kw)
    _, tc = TA.attn_prefill(tp, tx, cache_len=cache_len, pad_mask=tpm, **kw)
    jpad, tpad = _both(pad)
    start = np.array([10, 12, 15]) if per_slot else 10
    for i in range(12):
        jx1, tx1 = _both(_x(b, 1, 10 + i))
        if per_slot:
            jpos, tpos = _both(start + i)
        else:
            jpos, tpos = start + i, start + i
        want, jc = JA.attn_decode(jp, jx1, jc, jpos, pad_len=jpad, **kw)
        got, tc = TA.attn_decode(tp, tx1, tc, tpos, pad_len=tpad, **kw)
        _close(got, want, f"decode step {i}")
        for key in ("k", "v"):
            _close(tc[key], jc[key], f"decode step {i} cache {key}")


def _no_chunk_checkpoint(fn, *args, use_reentrant):
    return fn(*args)


def test_long_sequence_chunks_match_reference(monkeypatch):
    """Beyond 2048 queries the logits go in chunks (4100 = 2048 + 2048 +
    4), each recomputed in backward: output and gradients within
    ``F32_RTOL`` of the reference's ``jax.grad``, and bitwise those of
    the same chunks kept instead of recomputed."""
    d, h, kv, hd, s = 16, 2, 1, 8, 4100
    kw = dict(num_heads=h, num_kv_heads=kv, head_dim=hd, window=W * 64,
              attn_softcap=2.0)
    jp = JA.attn_init(jax.random.PRNGKey(1), d, h, kv, hd, dtype=jnp.float32)
    x = np.random.RandomState(6).randn(1, s, d).astype(np.float32)
    cot = np.random.RandomState(7).randn(1, s, d).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(JA.attn_train(p, x, **kw) * cot)
    jout = JA.attn_train(jp, jnp.asarray(x), **kw)
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))

    def port():
        tp = {k: v.requires_grad_(True) for k, v in params_from_numpy(
            jax.tree.map(np.asarray, jp), "cpu").items()}
        tx = torch.from_numpy(x).requires_grad_(True)
        out = TA.attn_train(tp, tx, **kw)
        (out * torch.from_numpy(cot)).sum().backward()
        return out.detach(), {k: v.grad for k, v in tp.items()}, tx.grad

    out, gp, gx = port()
    _close(out, jout, "chunked out")
    _close(gx, jgx, "chunked d x")
    for k in gp:
        _close(gp[k], jgp[k], f"chunked d {k}")
    monkeypatch.setattr(TA, "checkpoint", _no_chunk_checkpoint)
    out2, gp2, gx2 = port()
    assert torch.equal(out, out2) and torch.equal(gx, gx2)
    assert all(torch.equal(gp[k], gp2[k]) for k in gp)


def test_chunk_recompute_nests_in_the_group_remat(gemma2, monkeypatch):
    """A gemma2 train step at 2100 tokens (the layer groups rematerialised,
    each attention's chunks recomputed inside them): the loss and every
    gradient bitwise those of the step without the chunks' recompute."""
    import repro_torch.train.steps as TS
    from repro_torch.optim import optimizers as TO
    _, tcfg, _, tp = gemma2
    grads = []
    monkeypatch.setattr(TS, "apply_updates",
                        lambda o, p, g, st, **kw: (grads.append(g), (p, st))[1])
    opt = TO.OptimizerConfig(kind="adamw", lr=1e-3)
    toks = torch.from_numpy(np.random.RandomState(8).randint(
        0, tcfg.vocab_size, (1, 2100)))
    losses = []
    for _ in range(2):
        _, _, _, m = TS.make_lm_train_step(tcfg, TPOL["none"](), opt)(
            tp, TO.init_opt_state(opt, tp), [], {"tokens": toks},
            torch.arange(1))
        losses.append(float(m["loss"]))
        monkeypatch.setattr(TA, "checkpoint", _no_chunk_checkpoint)
    assert losses[0] == losses[1]
    for a, b in zip(TO.tree_leaves(grads[0]), TO.tree_leaves(grads[1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cap", [None, 30.0, 50.0])
def test_softcap_matches_reference(dtype, cap):
    x = np.random.RandomState(4).randn(4096).astype(np.float32) * 40.0
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got, want = TCM.softcap(tx, cap), JCM.softcap(jx, cap)
    assert got.dtype == tx.dtype
    if cap is None:
        assert got is tx
        return
    # one bf16 ulp at the cap is 2**-7 of it (its exponent's ulp)
    tol = F32_RTOL if dtype == "float32" else 2.0 ** -7
    assert float(np.abs(_np(got) - _np(want)).max()) <= tol * cap
    assert float(np.abs(_np(got)).max()) <= cap


# ---------------------------------------------------------------------------
# gemma2 and pixtral at their smoke configs, bf16
# ---------------------------------------------------------------------------

def _pair(arch):
    jcfg, tcfg = jget(arch, smoke=True), tget(arch, smoke=True)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                             "cpu")


@pytest.fixture(scope="module")
def gemma2():
    return _pair("gemma2-27b")


@pytest.fixture(scope="module")
def pixtral():
    return _pair("pixtral-12b")


def test_gemma2_smoke_config(gemma2):
    jcfg, tcfg, _, tp = gemma2
    assert tcfg.layer_kinds() == ("attn_local", "attn_global")
    assert (tcfg.window, tcfg.attn_softcap, tcfg.final_softcap,
            tcfg.post_norm) == (16, 50.0, 30.0, True)
    assert sorted(tp["layers"]["b0"]) == ["attn", "ln1", "ln2", "mlp",
                                          "pn1", "pn2"]
    caches = TT.init_caches(tcfg, 2, 40, device="cpu")
    jc = JT.init_caches(jcfg, 2, 40)
    for name in ("b0", "b1"):
        for key in ("k", "v"):
            assert tuple(caches[name][key].shape) == jc[name][key].shape
    assert caches["b0"]["k"].shape[2] == 16          # local: the window
    assert caches["b1"]["k"].shape[2] == 40          # global: cache_len


@pytest.mark.parametrize("kind", ["attn_local", "attn_global"])
def test_post_norm_block_matches_reference(gemma2, kind):
    jcfg, tcfg, _, _ = gemma2
    i = jcfg.layer_kinds().index(kind)
    jblk = JB.block_init(jax.random.PRNGKey(3 + i), jcfg, kind)
    tblk = params_from_numpy(jax.tree.map(np.asarray, jblk), "cpu")
    x = np.random.RandomState(5).randn(2, 40, jcfg.d_model) \
        .astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    want, _ = JB.block_train(jblk, jx, jcfg, kind)
    got, aux = TB.block_train(tblk, tx, tcfg, kind)
    assert float(aux) == 0.0
    _assert_rel(got, want, f"{kind} block")


def _reference_static(jp, jcfg, policy, prompts, new):
    """The reference static engine's greedy loop (``ServeEngine.generate``:
    jitted prefill and decode_step) with each step's top-2 logit gap."""
    plen = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), plen), np.int32)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    pad = jnp.asarray([plen - len(p) for p in prompts], jnp.int32)
    prefill = jax.jit(lambda t, pl: JT.prefill(
        jp, {"tokens": t}, jcfg, policy, cache_len=64, pad_len=pl,
        wire=True))
    decode = jax.jit(lambda t, c, pos, pl: JT.decode_step(
        jp, t, c, pos, jcfg, policy, pad_len=pl, wire=True))
    logits, caches = prefill(jnp.asarray(toks), pad)
    logits = logits[:, -1]
    outs, gaps = [], {}
    for step in range(new):
        lf = np.asarray(logits, np.float32)
        for r in range(len(prompts)):
            top2 = np.sort(lf[r])[-2:]
            gaps[(r, step)] = float(top2[1] - top2[0])
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        outs.append(np.asarray(tok))
        if step < new - 1:
            logits, caches = decode(tok, caches, jnp.int32(plen + step), pad)
    gen = np.stack(outs, axis=1)
    return {r: gen[r] for r in range(len(prompts))}, gaps


def _prompts(vocab):
    """Prompts either side of the smoke window (16): the longest sets the
    static batch's length, so every row is left-padded past the window
    and the ring wraps in prefill and again in decode."""
    rng = np.random.RandomState(7)
    return [rng.randint(1, vocab, n) for n in (5, 19, 30)]


@pytest.mark.parametrize("policy", ["none", "q4q8"])
def test_gemma2_static_streams_match_reference(gemma2, policy, monkeypatch):
    jcfg, tcfg, jp, tp = gemma2
    prompts = _prompts(jcfg.vocab_size)
    cuts = PinnedRows(monkeypatch, jitted=True)
    want, gaps = _reference_static(jp, jcfg, JPOL[policy](), prompts,
                                   NEW_TOKENS)
    eng = ServeEngine(tp, tcfg, TPOL[policy](), max_batch=3, max_seq=64)
    done = eng.generate([Request(p, NEW_TOKENS) for p in prompts])
    _assert_streams({r: d.out for r, d in enumerate(done)}, want, gaps)
    if policy != "none":
        assert cuts.hits > cuts.misses, (cuts.hits, cuts.misses)


@pytest.mark.parametrize("policy", ["none", "q4q8"])
def test_gemma2_continuous_streams_match_reference(gemma2, policy,
                                                   monkeypatch):
    """The slab engine: 2 slots, buckets (8, 16, 32) of max_seq 64 (a
    bucket longer than the window pushes a left-padded prompt's first
    keys out of the ring, in both packages alike)."""
    jcfg, tcfg, jp, tp = gemma2
    prompts = _prompts(jcfg.vocab_size) + [
        np.random.RandomState(8).randint(1, jcfg.vocab_size, 12)]
    kw = dict(num_slots=2, max_seq=64, tick_chunk=1)
    ref = JE.ContinuousEngine(jp, jcfg, JPOL[policy](), **kw)
    gaps = StreamGaps(monkeypatch, ref)
    cuts = PinnedRows(monkeypatch, jitted=True)
    for p in prompts:
        ref.submit(p.astype(np.int32), max_new_tokens=NEW_TOKENS)
    want = {r.req_id: np.asarray(r.out) for r in ref.drain()}
    eng = ContinuousEngine(tp, tcfg, TPOL[policy](), device="cpu", **kw)
    assert eng._caches["b0"]["k"].shape[2] == 16
    assert eng._caches["b1"]["k"].shape[2] == 64
    for p in prompts:
        eng.submit(p, max_new_tokens=NEW_TOKENS)
    got = {r.req_id: np.asarray(r.out) for r in eng.drain()}
    _assert_streams(got, want, gaps.gaps)
    if policy != "none":
        assert cuts.hits > cuts.misses, (cuts.hits, cuts.misses)


# the refusals: (what, port call, reference call); each raises ValueError
REFUSALS = {
    "page pool": (
        lambda t: TPG.init_page_pool(TT, t["tcfg"], 8, 4),
        lambda j: JPG.init_page_pool(JT, j["jcfg"], 8, 4)),
    "prefix cache": (
        lambda t: ContinuousEngine(t["tp"], t["tcfg"], prefix_cache=True,
                                   device="cpu"),
        lambda j: JE.ContinuousEngine(j["jp"], j["jcfg"],
                                      prefix_cache=True)),
    "chunked prefill": (
        lambda t: ContinuousEngine(t["tp"], t["tcfg"], prefill_chunk=8,
                                   device="cpu"),
        lambda j: JE.ContinuousEngine(j["jp"], j["jcfg"], prefill_chunk=8)),
    "speculation": (
        lambda t: ContinuousEngine(t["tp"], t["tcfg"], draft_params=t["tp"],
                                   draft_cfg=t["tcfg"], device="cpu"),
        lambda j: JE.ContinuousEngine(j["jp"], j["jcfg"],
                                      draft_params=j["jp"],
                                      draft_cfg=j["jcfg"])),
    "attn_decode_span with a window": (
        lambda t: TA.attn_decode_span(
            None, torch.zeros((1, 2, D)), None, torch.tensor([0]), window=W,
            **KW),
        lambda j: JA.attn_decode_span(
            None, jnp.zeros((1, 2, D)), None, jnp.asarray([0]), window=W,
            **KW)),
    "vision under continuous batching": (
        lambda t: ContinuousEngine(t["pp"], t["pcfg"], device="cpu"),
        lambda j: JE.ContinuousEngine(j["pp"], j["pcfg"])),
    "vision, mixed-length static batch": (
        lambda t: ServeEngine(t["pp"], t["pcfg"]).generate(
            [Request(np.arange(1, 12), 2), Request(np.arange(1, 9), 2)]),
        lambda j: JE.ServeEngine(j["pp"], j["pcfg"]).generate(
            [JE.Request(np.arange(1, 12, dtype=np.int32), 2),
             JE.Request(np.arange(1, 9, dtype=np.int32), 2)])),
}


@pytest.mark.parametrize("what", list(REFUSALS))
def test_refusals_match_reference(gemma2, pixtral, what):
    jcfg, tcfg, jp, tp = gemma2
    pjcfg, ptcfg, pjp, ptp = pixtral
    port, reference = REFUSALS[what]
    with pytest.raises(ValueError) as want:
        reference(dict(jcfg=jcfg, jp=jp, pcfg=pjcfg, pp=pjp))
    with pytest.raises(ValueError) as got:
        port(dict(tcfg=tcfg, tp=tp, pcfg=ptcfg, pp=ptp))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seq", [32, 5])
def test_pixtral_patch_splice_matches_reference(pixtral, seq):
    """The first P rows are the patch embeddings; with S < P the result
    has P rows, as the reference's concatenate gives."""
    jcfg, tcfg, jp, tp = pixtral
    p = jcfg.num_patches
    rng = np.random.RandomState(9)
    toks = rng.randint(0, jcfg.vocab_size, (2, seq))
    pe = rng.randn(2, p, jcfg.d_model).astype(np.float32)
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "patch_embeds": jnp.asarray(pe)}
    tb = {"tokens": torch.from_numpy(toks),
          "patch_embeds": torch.from_numpy(pe)}
    want = JT._embed_input(jp, jb, jcfg)
    got = TT._embed_input(tp, tb, tcfg)
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == want.shape == (2, max(seq, p), jcfg.d_model)
    np.testing.assert_array_equal(_np(got), _np(want))
    plain = TT._embed_input(tp, {"tokens": tb["tokens"]}, tcfg)
    np.testing.assert_array_equal(_np(plain), _np(JT._embed_input(
        jp, {"tokens": jb["tokens"]}, jcfg)))
    other = dataclasses.replace(tcfg, frontend="none")
    np.testing.assert_array_equal(_np(TT._embed_input(tp, tb, other)),
                                  _np(plain))


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def _json_lines(out):
    import json
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


@pytest.mark.parametrize("arch,engine", [("gemma2-27b", "continuous"),
                                         ("pixtral-12b", "static")])
def test_launch_serve_smoke(arch, engine, capsys):
    """``launch/serve --arch``: gemma2 takes the continuous engine (prompts
    up to 20 tokens past the window of 16), pixtral the static one (its
    patch prefix cannot take left-padding), as the reference chooses."""
    from repro_torch.launch import serve as tserve
    assert tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--policy", "q4q8", "--requests", "3", "--slots",
                        "2", "--batch", "2", "--prompt-len", "20",
                        "--new-tokens", "4", "--max-seq", "64"]) == 0
    (rec,) = _json_lines(capsys.readouterr().out)
    assert rec["arch"] == f"{arch}-smoke" and rec["engine"] == engine


@pytest.mark.parametrize("arch", ["gemma2-27b", "pixtral-12b"])
def test_launch_train_smoke(arch, capsys):
    """``launch/train --arch``: q4q8 steps from ``make_batch`` (pixtral's
    with its zero patch embeddings), finite losses."""
    from repro_torch.launch import train as ttrain
    assert ttrain.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--steps", "2", "--batch", "2", "--seq", "32",
                        "--policy", "q4q8", "--log-every", "1"]) == 0
    recs = _json_lines(capsys.readouterr().out)
    assert len(recs) == 2
    assert all(np.isfinite(r["loss"]) for r in recs)
