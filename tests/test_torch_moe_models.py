"""mixtral-8x7b and llama4-maverick-400b-a17b through the port's blocks,
engines and launchers, against the JAX package where it runs them.

Smoke configs (d 256, 4 experts): mixtral 2 MoE layers, top-2, window 16;
llama4 2 (dense, MoE) groups, top-1 and a shared expert, no window.
Reference params carried over through numpy.

  * Greedy streams of the static ``ServeEngine`` (mixtral, prompts either
    side of the window, so its ring wraps in prefill and in decode) and of
    the ``ContinuousEngine`` (mixtral's slab; llama4's paged pool with
    prefix sharing and chunked prefill, where its MoE meets
    ``decode_span`` over pages) against the reference's, its cuts pinned
    row by row (``PinnedRows``) and its routing pinned token by token
    (``test_torch_moe.pin_reference_routing``: a parting only at a
    near-tie): equal, except a parting at a near-tie of the logits, as
    tests/test_torch_serve_continuous.py rules.  Serving routes densely
    (dropless in prefill and span decode, ``s == 1`` in decode).
  * The port's own invariants, bitwise: mixtral's slab stream equal to
    each request served alone (the reference's
    ``test_swa_ring_cache_and_moe``), llama4's paged streams equal with and
    without prefix hits.
  * Refusals with the reference's message: mixtral's window keeps it off
    the page pool, the prefix cache and chunked prefill; both archs off
    the tensor axis (``tp_stage_stack_fn``, and the port's TP step).
  * Training: mixtral's ``grad_accum=2`` step on the simulated cuts
    against the reference's (aux the pieces' mean, in the total with
    weight 0.01), routing pinned; the pipeline step's aux 0.0 where the
    simulated step counts it.
  * The launchers, ``--smoke --device cpu``: both archs serve and train
    (mixtral also through the pipeline).
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import repro.models.transformer as JT
import repro.serve.engine as JE
import repro.serve.pages as JPG
from repro.configs.registry import get as jget
from repro.launch.train import POLICIES as JPOL

import repro_torch.models.transformer as TT
import repro_torch.train.steps as TS
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.registry import get as tget
from repro_torch.core.boundary import init_boundary_state
from repro_torch.core.parallel import ParallelSpec
from repro_torch.core.policy import NO_POLICY, POLICIES as TPOL
from repro_torch.optim.optimizers import OptimizerConfig, init_opt_state
from repro_torch.train.loop import _pipeline_bstates
from repro_torch.serve import pages as TPG
from repro_torch.serve.engine import ContinuousEngine, Request, ServeEngine

from test_torch_attention_variants import _reference_static
from test_torch_moe import pin_reference_routing
from test_torch_serve_continuous import (PinnedRows, StreamGaps,
                                         _assert_streams)

# One intra-op thread: the suite runs in several worker processes at
# once, and a torch thread pool per worker that outnumbers the cores
# slows its CPU ops by an order of magnitude.
torch.set_num_threads(1)

NEW_TOKENS = 16
MIXTRAL, LLAMA4 = "mixtral-8x7b", "llama4-maverick-400b-a17b"


def _pair(arch):
    jcfg, tcfg = jget(arch, smoke=True), tget(arch, smoke=True)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                             "cpu")


@pytest.fixture(scope="module")
def mixtral():
    return _pair(MIXTRAL)


@pytest.fixture(scope="module")
def llama4():
    return _pair(LLAMA4)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", [MIXTRAL, LLAMA4])
def test_smoke_configs_and_param_layout(arch, mixtral, llama4):
    """``check_supported`` passes; ``init_params`` builds the reference's
    tree leaf for leaf (names, shapes, dtypes)."""
    jcfg, tcfg, jp, _ = mixtral if arch == MIXTRAL else llama4
    TT.check_supported(tcfg)
    assert tcfg.layer_kinds() == jcfg.layer_kinds() == (
        ("moe",) if arch == MIXTRAL else ("dense", "moe"))
    own = dict(_leaves(TT.init_params(torch.Generator().manual_seed(0),
                                      tcfg)))
    ref = dict(_leaves(jp))
    assert sorted(own) == sorted(ref)
    for n in ref:
        assert tuple(own[n].shape) == ref[n].shape, n
        assert str(own[n].dtype).split(".")[-1] == str(ref[n].dtype), n
    moe = "/layers/b0/moe" if arch == MIXTRAL else "/layers/b1/moe"
    assert own[f"{moe}/experts/wi"].shape == (2, 4, 256, tcfg.d_ff)
    assert (f"{moe}/shared/wi" in own) == (arch == LLAMA4)


def _prompts(vocab, lens=(5, 19, 30)):
    rng = np.random.RandomState(7)
    return [rng.randint(1, vocab, n) for n in lens]


@pytest.mark.parametrize("policy", ["none", "q4q8"])
def test_mixtral_static_streams_match_reference(mixtral, policy,
                                                monkeypatch):
    """Prompts either side of the window, left-padded to 30: the ring
    wraps in prefill and again in decode; the MoE routes densely."""
    jcfg, tcfg, jp, tp = mixtral
    prompts = _prompts(jcfg.vocab_size)
    routing = pin_reference_routing(monkeypatch)
    cuts = PinnedRows(monkeypatch, jitted=True)
    want, gaps = _reference_static(jp, jcfg, JPOL[policy](), prompts,
                                   NEW_TOKENS)
    eng = ServeEngine(tp, tcfg, TPOL[policy](), max_batch=3, max_seq=64)
    done = eng.generate([Request(p, NEW_TOKENS) for p in prompts])
    _assert_streams({r: d.out for r, d in enumerate(done)}, want, gaps)
    # misses: the rows of a stream after it parted
    assert routing.hits > routing.misses, (routing.hits, routing.misses)
    if policy != "none":
        assert cuts.hits > cuts.misses, (cuts.hits, cuts.misses)
    print(f"# mixtral static {policy}: routed rows {routing.hits} (and "
          f"{routing.misses} after a parting), partings {routing.partings}")


# case -> (arch, policy, engine keywords of both packages)
STREAMS = {
    "mixtral_slab_q4q8": (MIXTRAL, "q4q8", dict(num_slots=2, max_seq=64)),
    "llama4_paged_q4q8": (LLAMA4, "q4q8", dict(
        num_slots=2, max_seq=64, prefix_cache=True, prefill_chunk=8,
        page_size=8)),
    "llama4_slab_none": (LLAMA4, "none", dict(num_slots=2, max_seq=64)),
}


@pytest.mark.parametrize("case", list(STREAMS))
def test_continuous_streams_match_reference(case, mixtral, llama4,
                                            monkeypatch):
    arch, policy, kw = STREAMS[case]
    jcfg, tcfg, jp, tp = mixtral if arch == MIXTRAL else llama4
    kw = dict(kw, tick_chunk=1)
    prompts = _prompts(jcfg.vocab_size) + [
        np.random.RandomState(8).randint(1, jcfg.vocab_size, 12)]
    if kw.get("prefix_cache"):                   # a shared 16-token prefix
        shared = np.random.RandomState(9).randint(1, jcfg.vocab_size, 16)
        prompts = [np.concatenate([shared, p]) for p in prompts]
    ref = JE.ContinuousEngine(jp, jcfg, JPOL[policy](), **kw)
    gaps = StreamGaps(monkeypatch, ref)
    routing = pin_reference_routing(monkeypatch)
    cuts = PinnedRows(monkeypatch, jitted=True)
    for p in prompts:
        ref.submit(p.astype(np.int32), max_new_tokens=NEW_TOKENS)
    want = {r.req_id: np.asarray(r.out) for r in ref.drain()}
    eng = ContinuousEngine(tp, tcfg, TPOL[policy](), device="cpu", **kw)
    for p in prompts:
        eng.submit(p, max_new_tokens=NEW_TOKENS)
    got = {r.req_id: np.asarray(r.out) for r in eng.drain()}
    _assert_streams(got, want, gaps.gaps)
    # misses: the rows of a stream after it parted
    assert routing.hits > routing.misses, (routing.hits, routing.misses)
    if policy != "none":
        assert cuts.hits > cuts.misses, (cuts.hits, cuts.misses)
    if kw.get("prefix_cache"):
        assert eng.stats()["prefix_hits"] >= 1
    print(f"# {case}: routed rows {routing.hits} (and {routing.misses} "
          f"after a parting), partings {routing.partings}")


def _drain(eng, prompts, news):
    for p, n in zip(prompts, news):
        eng.submit(p, max_new_tokens=n)
    return {r.req_id: np.asarray(r.out) for r in eng.drain()}


def test_mixtral_slab_stream_equals_each_request_alone(mixtral):
    """The reference's ``test_swa_ring_cache_and_moe``: ring caches with
    per-slot positions and MoE blocks; each request's tokens bitwise
    those it gets alone."""
    _, tcfg, _, tp = mixtral
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, tcfg.vocab_size, n) for n in (5, 30, 12, 21)]
    news = [9, 4, 14, 6]
    make = lambda: ContinuousEngine(tp, tcfg, TPOL["top10"](),  # noqa: E731
                                    num_slots=2, max_seq=96, device="cpu")
    batched = _drain(make(), prompts, news)
    solo = make()
    for i, (p, n) in enumerate(zip(prompts, news)):
        (alone,) = _drain(solo, [p], [n]).values()
        np.testing.assert_array_equal(alone, batched[i], err_msg=str(i))


def test_llama4_paged_prefix_hits_keep_output(llama4):
    """llama4 through the paged engine: prompts sharing a 24-token prefix,
    each served alone cold, then together twice (prefix hits): the same
    tokens bitwise, and every page back in the pool."""
    _, tcfg, _, tp = llama4
    rng = np.random.RandomState(2)
    shared = rng.randint(1, tcfg.vocab_size, 24)
    prompts = [np.concatenate([shared, rng.randint(1, tcfg.vocab_size, n)])
               for n in (5, 9, 3)]
    kw = dict(num_slots=2, max_seq=96, prefix_cache=True, prefill_chunk=8,
              page_size=8, device="cpu")
    cold = {}
    for i, p in enumerate(prompts):
        eng = ContinuousEngine(tp, tcfg, TPOL["q4q8"](), **kw)
        (cold[i],) = _drain(eng, [p], [6]).values()
    eng = ContinuousEngine(tp, tcfg, TPOL["q4q8"](), **kw)
    warm = _drain(eng, prompts, [6] * 3)
    warm2 = _drain(eng, prompts, [6] * 3)
    for i in cold:
        np.testing.assert_array_equal(cold[i], warm[i])
        np.testing.assert_array_equal(cold[i], warm2[i + 3])
    s = eng.stats()
    assert s["prefix_hits"] >= 3 and s["prefix_hit_tokens"] >= 3 * 16
    eng.pages.check_invariants()
    assert eng.pages.active_pages() == 0


# mixtral's refusals (its window): (port call, reference call), ValueError
REFUSALS = {
    "page pool": (
        lambda t: TPG.init_page_pool(TT, t[1], 8, 4, device="cpu"),
        lambda j: JPG.init_page_pool(JT, j[0], 8, 4)),
    "prefix cache": (
        lambda t: ContinuousEngine(t[3], t[1], prefix_cache=True,
                                   device="cpu"),
        lambda j: JE.ContinuousEngine(j[2], j[0], prefix_cache=True)),
    "chunked prefill": (
        lambda t: ContinuousEngine(t[3], t[1], prefill_chunk=8,
                                   device="cpu"),
        lambda j: JE.ContinuousEngine(j[2], j[0], prefill_chunk=8)),
}


@pytest.mark.parametrize("what", list(REFUSALS))
def test_mixtral_refusals_match_reference(mixtral, what):
    port, reference = REFUSALS[what]
    with pytest.raises(ValueError) as want:
        reference(mixtral)
    with pytest.raises(ValueError) as got:
        port(mixtral)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("arch", [MIXTRAL, LLAMA4])
def test_tensor_parallel_refused_with_reference_message(arch, mixtral,
                                                        llama4):
    """The MoE shards over experts, not over the tensor ring:
    ``tp_stage_stack_fn`` raises the reference's ValueError, and so do the
    port's TP step and its pipeline x TP step when they are built."""
    jcfg, tcfg, jp, tp = mixtral if arch == MIXTRAL else llama4
    with pytest.raises(ValueError) as want:
        JT.tp_stage_stack_fn(jcfg, None)
    with pytest.raises(ValueError) as got:
        TT.tp_stage_stack_fn(tcfg, None)
    assert str(got.value) == str(want.value)
    assert "'moe'" in str(got.value)
    opt = OptimizerConfig(kind="sgd", lr=0.1)
    for axes in ({"tensor": 2}, {"stage": 2, "tensor": 2}):
        with pytest.raises(ValueError) as got:
            TS.make_lm_train_step(tcfg, NO_POLICY, opt,
                                  pipeline_microbatches=2,
                                  parallel=ParallelSpec(axes))
        assert str(got.value) == str(want.value), axes


def _json_lines(out):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


@pytest.mark.parametrize("arch,argv", [
    (MIXTRAL, ["--requests", "3", "--prompt-len", "20"]),
    (LLAMA4, ["--requests", "3", "--prompt-len", "12", "--prefix-cache",
              "--prefill-chunk", "8", "--shared-prefix", "16"])])
def test_launch_serve_smoke(arch, argv, capsys):
    """``launch/serve --arch``: both MoE archs take continuous batching;
    llama4 also the paged pool with a shared prefix."""
    from repro_torch.launch import serve as tserve
    assert tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--policy", "q4q8", "--slots", "2", "--new-tokens",
                        "4", "--max-seq", "64", *argv]) == 0
    (rec,) = _json_lines(capsys.readouterr().out)
    assert rec["arch"] == f"{arch}-smoke" and rec["engine"] == "continuous"
    if arch == LLAMA4:
        assert rec["prefix_hits"] >= 1


@pytest.mark.parametrize("arch,argv", [
    (MIXTRAL, []), (LLAMA4, []),
    (MIXTRAL, ["--transport", "pipeline", "--stages", "2"])])
def test_launch_train_smoke(arch, argv, capsys):
    """``launch/train --arch``: q4q8 steps on the simulated cuts, and
    mixtral's through the pipeline; finite losses."""
    from repro_torch.launch import train as ttrain
    assert ttrain.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--steps", "2", "--batch", "2", "--seq", "32",
                        "--policy", "q4q8", "--log-every", "1", *argv]) == 0
    recs = _json_lines(capsys.readouterr().out)
    assert len(recs) == 2
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert ("fw_bytes" in recs[0]) == ("pipeline" in argv)


@pytest.mark.parametrize("pname", ["none", "q4q8"])
def test_mixtral_grad_accumulation_matches_reference(pname, mixtral,
                                                     monkeypatch):
    """``grad_accum=2`` on the simulated cuts (each piece of 2 x 32 tokens
    routes as its own group): loss, aux and total the pieces' means, aux
    counted into total with weight 0.01, one boundary state a cut that
    exists, against the reference's
    (tests/test_torch_train.py's bounds: loss 2e-3 / 0.05, the gradient
    tree within 2**-5 / 0.3 of its norm), routing pinned."""
    import repro.core.compressors as JC
    import repro.train.steps as JS
    from repro.core.boundary import init_boundary_state as jinit
    from repro.optim import optimizers as JO
    jcfg, tcfg, jp, tp = mixtral
    routing = pin_reference_routing(monkeypatch, row_tol=2.0 ** -3)
    grads_out = lambda opt, p, g, s, **kw: (g, s)  # noqa: E731
    monkeypatch.setattr(JS, "apply_updates", grads_out)
    monkeypatch.setattr(TS, "apply_updates", grads_out)
    monkeypatch.setattr(JC, "KERNEL_BACKEND", "pallas")
    jpol, tpol = JPOL[pname](), TPOL[pname]()
    # the 4-stage preset stops at the smoke model's 2 groups: one cut,
    # though the caller hands in the preset's 3 states (the reference
    # returns the one cut's; the port used to raise IndexError)
    cuts = tpol.num_boundaries
    real = len(TT.segment_bounds(tcfg.num_groups, tpol.num_stages)) - 1
    assert real == min(cuts, 1)
    toks = np.random.RandomState(4).randint(0, tcfg.vocab_size, (4, 32))
    kw = dict(kind="adamw", lr=1e-3, weight_decay=0.01, schedule="cosine",
              t_max=5, grad_clip=1.0)
    jopt, topt = JO.OptimizerConfig(**kw), OptimizerConfig(**kw)
    jg, _, jst, jm = JS.make_lm_train_step(
        jcfg, jpol, jopt, donate=False, grad_accum=2)(
        jp, JO.init_opt_state(jopt, jp),
        [jinit(jpol.at(i), (32, jcfg.d_model), batch=4,
               dtype=jax.numpy.bfloat16) for i in range(cuts)],
        {"tokens": jax.numpy.asarray(toks, jax.numpy.int32)},
        jax.numpy.arange(4))
    tg, _, tst, tm = TS.make_lm_train_step(tcfg, tpol, topt, grad_accum=2)(
        tp, init_opt_state(topt, tp),
        [init_boundary_state(tpol.at(i), (32, tcfg.d_model), batch=4,
                             dtype=torch.bfloat16) for i in range(cuts)],
        {"tokens": torch.from_numpy(toks)}, torch.arange(4))
    assert len(tst) == len(jst) == real
    exact = pname == "none"
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
        (2e-3 if exact else 0.05)
    assert abs(float(tm["aux"]) - float(jm["aux"])) <= 1e-3
    assert float(tm["aux"]) > 0
    assert abs(float(tm["total"]) - float(tm["loss"])
               - 0.01 * float(tm["aux"])) <= 1e-6
    jl, tl = dict(_leaves(jg)), dict(_leaves(tg))
    assert sorted(jl) == sorted(tl)
    got = np.concatenate([tl[n].float().numpy().ravel() for n in sorted(tl)])
    want = np.concatenate([np.asarray(jl[n], np.float32).ravel()
                           for n in sorted(tl)])
    assert np.linalg.norm(got - want) <= \
        (2.0 ** -5 if exact else 0.3) * np.linalg.norm(want)
    assert routing.hits and not routing.misses
    print(f"# mixtral grad_accum {pname}: routing partings "
          f"{routing.partings}")


def test_pipeline_step_drops_the_aux(mixtral):
    """The real pipeline (2 stages, 2 microbatches) drops the MoE aux, as
    the reference does (tests/test_torch_pipeline.py holds the step to the
    reference's); the simulated step on the same batch counts it."""
    _, tcfg, _, tp = mixtral
    opt = OptimizerConfig(kind="sgd", lr=0.1)
    pol = dataclasses.replace(TPOL["q4q8"](), num_stages=2)
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, tcfg.vocab_size, (4, 32)))
    st = _pipeline_bstates(pol, (32, tcfg.d_model), batch=4,
                           microbatches=2, dtype=torch.bfloat16)
    step = TS.make_lm_train_step(tcfg, pol, opt, transport="pipeline",
                                 pipeline_microbatches=2)
    _, _, _, m = step(tp, init_opt_state(opt, tp), st, {"tokens": toks},
                      torch.arange(4))
    assert float(m["aux"]) == 0.0 and float(m["total"]) == float(m["loss"])
    bst = [init_boundary_state(pol.at(0), (32, tcfg.d_model), batch=4,
                               dtype=torch.bfloat16)]
    _, _, _, m = TS.make_lm_train_step(tcfg, pol, opt)(
        tp, init_opt_state(opt, tp), bst, {"tokens": toks}, torch.arange(4))
    assert float(m["aux"]) > 0
