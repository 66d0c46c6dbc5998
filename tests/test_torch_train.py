"""The port's training step without compression, its optimizer and its
data against the JAX package.

Model: gpt2-small smoke with ``num_layers=4`` (d=256), batch 4, seq 32,
reference params carried over through numpy.  Tolerances:
  * loss: ``LOSS_ATOL`` = 2e-3 absolute on a loss of about 6.3 (bf16
    activations in both; measured gap at most 4e-4 over three batches);
  * every gradient leaf and every updated parameter: ``REL_TOL`` = 2**-5
    of the leaf's largest magnitude, the bf16 bound of
    tests/test_torch_serve.py (the two frameworks round bf16 matmuls and
    transcendentals differently, so nothing model-level is bitwise;
    measured at most 2**-5.9 over three batches);
  * optimizer, float32 toy params: within ``OPT_ULPS`` = 4 float32 ulps
    of the reference (XLA fuses multiply-adds into FMAs and computes
    ``pow`` / ``cos`` its own way; measured: bitwise on this CPU);
  * ``LMData`` and ``synthetic_stream``: bitwise.
"""
import contextlib
import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.models.transformer as JT
import repro.train.steps as JS
from repro.configs.registry import get as jget
from repro.core.policy import NO_POLICY as JNONE
from repro.data.synthetic import LMData as JLMData
from repro.launch.train import synthetic_stream as jstream
from repro.optim import optimizers as JO

import repro_torch.models.transformer as TT
import repro_torch.train.steps as TS
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.registry import get as tget
from repro_torch.core.policy import NO_POLICY as TNONE
from repro_torch.data.synthetic import LMData as TLMData
from repro_torch.launch.train import synthetic_stream as tstream
from repro_torch.optim import optimizers as TO

# One intra-op thread: the suite runs in several worker processes at
# once, and a torch thread pool per worker that outnumbers the cores
# slows its CPU ops by an order of magnitude.
torch.set_num_threads(1)

LOSS_ATOL = 2e-3
REL_TOL = 2.0 ** -5
OPT_ULPS = 4
B, S = 4, 32


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jget("gpt2-small", smoke=True), num_layers=4)
    tcfg = dataclasses.replace(tget("gpt2-small", smoke=True), num_layers=4)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _assert_rel(got, want, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    gap = float(np.abs(got - want).max())
    assert gap <= REL_TOL * max(float(np.abs(want).max()), 1e-6), \
        f"{what}: max gap {gap} vs largest {np.abs(want).max()}"


def _tokens(cfg, seed=1):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, S))


def _opt():
    return JO.OptimizerConfig(kind="adamw", lr=1e-3, weight_decay=0.01,
                              schedule="cosine", t_max=5, grad_clip=1.0)


def _topt():
    return TO.OptimizerConfig(kind="adamw", lr=1e-3, weight_decay=0.01,
                              schedule="cosine", t_max=5, grad_clip=1.0)


def test_train_step_loss_and_gradients(models, monkeypatch):
    """One ``make_lm_train_step`` in each package with the optimizer
    swapped for one that hands back the gradients as the new params."""
    jcfg, tcfg, jp, tp = models
    grads_out = lambda opt, params, grads, state, **kw: (grads, state)
    monkeypatch.setattr(JS, "apply_updates", grads_out)
    monkeypatch.setattr(TS, "apply_updates", grads_out)
    toks = _tokens(jcfg)
    jg, _, _, jm = JS.make_lm_train_step(jcfg, JNONE, _opt(), donate=False)(
        jp, JO.init_opt_state(_opt(), jp), [],
        {"tokens": jnp.asarray(toks, jnp.int32)}, jnp.arange(B))
    tg, _, bst, tm = TS.make_lm_train_step(tcfg, TNONE, _topt())(
        tp, TO.init_opt_state(_topt(), tp), [],
        {"tokens": torch.from_numpy(toks)}, torch.arange(B))
    assert bst == []
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_ATOL
    jl, tl = dict(_leaves(jg)), dict(_leaves(tg))
    assert sorted(jl) == sorted(tl)
    for name, g in tl.items():
        assert g.dtype == params_from_numpy(np.asarray(jl[name]), "cpu").dtype
        _assert_rel(g, jl[name], f"grad {name}")


def test_train_step_updates_params(models):
    """SGD with clipping: its update is proportional to the gradient, so
    the gradients' tolerance carries over (AdamW's first step is about
    lr * sign(g), which flips on gradients near zero; the AdamW update
    itself is held to the reference in ``test_optimizer_matches``)."""
    jcfg, tcfg, jp, tp = models
    kw = dict(kind="sgd", lr=0.1, weight_decay=5e-4, grad_clip=0.5,
              schedule="cosine", t_max=5)
    jopt, topt = JO.OptimizerConfig(**kw), TO.OptimizerConfig(**kw)
    toks = _tokens(jcfg, seed=2)
    jn, jo, _, jm = JS.make_lm_train_step(jcfg, JNONE, jopt, donate=False)(
        jp, JO.init_opt_state(jopt, jp), [],
        {"tokens": jnp.asarray(toks, jnp.int32)}, jnp.arange(B))
    tn, to, _, tm = TS.make_lm_train_step(tcfg, TNONE, topt, remat=False)(
        tp, TO.init_opt_state(topt, tp), [],
        {"tokens": torch.from_numpy(toks)}, torch.arange(B))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_ATOL
    assert int(to["step"]) == int(jo["step"]) == 1
    jl = dict(_leaves(jn))
    for name, p in _leaves(tn):
        assert not p.requires_grad
        _assert_rel(p, jl[name], f"param {name}")
    for name, p in _leaves(tp):          # the caller's params stay as given
        assert not p.requires_grad and p.grad is None


@pytest.mark.parametrize("dp", [1, 2])
def test_donated_step_is_the_undonated_step(models, dp):
    """``make_lm_train_step(donate=True)`` (q4q8, AdamW with clipping, on
    one lane or two data-parallel lanes): the undonated step's losses and
    params bit for bit, the params and moments updated in place."""
    from repro_torch.core.parallel import ParallelSpec
    from repro_torch.core.policy import POLICIES
    from repro_torch.train.loop import init_lm_dp_state
    _, tcfg, _, tp = models
    pol = POLICIES["q4q8"]()
    kw = {} if dp == 1 else {"parallel": ParallelSpec({"data": dp})}
    runs = []
    for donate in (False, True):
        p = TO.tree_map(torch.clone, tp)
        o = TO.init_opt_state(_topt(), p)
        step = TS.make_lm_train_step(tcfg, pol, _topt(), donate=donate, **kw)
        extra = ([init_lm_dp_state(tcfg, p, pol, dp, "none")] if dp > 1
                 else [])
        losses = []
        for seed in (1, 2):
            given = TO.tree_leaves([p, o["mu"], o["nu"]])
            res = step(p, o, [], {"tokens": torch.from_numpy(
                _tokens(tcfg, seed))}, torch.arange(B), *extra)
            p, o, extra, m = res[0], res[1], list(res[3:-1]), res[-1]
            same = [a is b for a, b in
                    zip(given, TO.tree_leaves([p, o["mu"], o["nu"]]))]
            assert all(same) if donate else not any(same)
            losses.append(float(m["loss"]))
        runs.append((losses, TO.tree_leaves([p, o])))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


def test_eval_step_matches(models):
    jcfg, tcfg, jp, tp = models
    toks = _tokens(jcfg, seed=3)
    want = JS.make_lm_eval_step(jcfg, JNONE, True)(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    got = TS.make_lm_eval_step(tcfg, TNONE, True)(
        tp, {"tokens": torch.from_numpy(toks)})
    assert abs(float(got) - float(want)) <= LOSS_ATOL
    logits = TT.forward_eval(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert logits.dtype == torch.bfloat16
    assert logits.shape == (B, S, tcfg.vocab_size)
    with torch.no_grad():
        train_logits, aux, new_fw, slots = TT.forward_train(
            tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert torch.equal(train_logits, logits) and float(aux) == 0.0
    assert new_fw == slots == []


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

OPT_CASES = {
    "sgd": dict(kind="sgd", lr=0.05, weight_decay=5e-4, schedule="constant"),
    "adamw": dict(kind="adamw", lr=1e-2, weight_decay=0.01,
                  schedule="constant"),
    "clip": dict(kind="adamw", lr=1e-2, weight_decay=0.01, grad_clip=0.5,
                 schedule="constant"),
    "cosine": dict(kind="sgd", lr=0.1, schedule="cosine", t_max=3,
                   lr_min=0.01, warmup_steps=2),
}


def _assert_ulps(got, want, what):
    got, want = _f32(got), _f32(want)
    tol = OPT_ULPS * np.spacing(np.maximum(np.abs(want), 1e-30))
    assert (np.abs(got - want) <= tol).all(), \
        f"{what}: {np.abs(got - want).max()} > {OPT_ULPS} ulps"


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_matches(case):
    rng = np.random.RandomState(0)
    params = {"a": rng.randn(3, 4).astype(np.float32),
              "b": {"c": rng.randn(5).astype(np.float32)}}
    jcfg, tcfg = JO.OptimizerConfig(**OPT_CASES[case]), \
        TO.OptimizerConfig(**OPT_CASES[case])
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_numpy(params, "cpu")
    js, ts = JO.init_opt_state(jcfg, jp), TO.init_opt_state(tcfg, tp)
    for i in range(4):
        g = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32)
                         * 3.0, params)
        jp, js = JO.apply_updates(jcfg, jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts = TO.apply_updates(tcfg, tp, params_from_numpy(g, "cpu"), ts)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        _assert_ulps(TO.schedule_lr(tcfg, ts["step"]),
                     JO.schedule_lr(jcfg, js["step"]), "lr")
        for key in ("mu", "nu"):
            if key in js:
                for (n, a), (_, b) in zip(_leaves(ts[key]), _leaves(js[key])):
                    _assert_ulps(a, b, f"{key}{n} step {i}")
        for (n, a), (_, b) in zip(_leaves(tp), _leaves(jp)):
            _assert_ulps(a, b, f"param{n} step {i}")


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_donated_update_is_the_same_bits(case):
    """``donate=True`` overwrites the params and moments in place (the
    reference step's ``donate_argnums``) with the bits of the update
    that returns new tensors, which leaves its inputs as they were."""
    gen = torch.Generator().manual_seed(0)

    def tree():
        return {"a": torch.randn(3, 4, generator=gen).to(torch.bfloat16),
                "b": {"c": torch.randn(5, generator=gen)}}

    cfg = TO.OptimizerConfig(**OPT_CASES[case])
    kept = tree()
    p, s = kept, TO.init_opt_state(cfg, kept)
    dp = {"a": kept["a"].clone(), "b": {"c": kept["b"]["c"].clone()}}
    ds = TO.init_opt_state(cfg, dp)
    before = [t.clone() for t in TO.tree_leaves(kept)]
    for i in range(3):
        g = tree()
        p, s = TO.apply_updates(cfg, p, g, s)
        leaves = TO.tree_leaves([dp, ds])
        dp, ds = TO.apply_updates(cfg, dp, g, ds, donate=True)
        new = TO.tree_leaves([dp, ds])
        assert all(a is b for a, b in zip(leaves, new) if a.dim())
        for a, b in zip(TO.tree_leaves([p, s]), new):
            assert a.dtype == b.dtype and torch.equal(a, b), (case, i)
    assert all(torch.equal(a, b)
               for a, b in zip(TO.tree_leaves(kept), before))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_lm_data_is_bitwise_the_reference():
    kw = dict(num_train=64, num_test=16, seq_len=32, vocab=64, seed=3)
    j, t = JLMData(**kw), TLMData(**kw)
    np.testing.assert_array_equal(t.train, j.train)
    np.testing.assert_array_equal(t.test, j.test)
    for (a, ia), (b, ib) in zip(t.epoch(8, 1), j.epoch(8, 1)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ia, ib)
    for (a, ia), (b, ib) in zip(t.test_batches(8), j.test_batches(8)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ia, ib)


def test_synthetic_stream_is_bitwise_the_reference(models):
    jcfg, tcfg, _, _ = models
    js = jstream(jcfg, 4, 16, seed=5, num_samples=10, start_step=2)
    ts = tstream(tcfg, 4, 16, seed=5, num_samples=10, start_step=2)
    for _ in range(4):
        (a, ia), (b, ib) = next(ts), next(js)
        assert a.dtype == b.dtype and ia.dtype == ib.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ia, ib)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [["--policy", "q4q8"],
                                  ["--policy", "top10reuse", "--no-remat"],
                                  ["--feedback", "aqsgd", "--num-samples",
                                   "4"]])
def test_launch_train_main_cpu(argv, capsys):
    from repro_torch.launch import train as ttrain
    assert ttrain.main(["--smoke", "--device", "cpu", "--steps", "2",
                        "--batch", "2", "--seq", "16", "--log-every", "1",
                        *argv]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    recs = [json.loads(ln) for ln in lines]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["tok_per_s"] > 0 for r in recs)


@pytest.mark.parametrize("argv", [
    ["--schedule", "gpipe"],
    ["--schedule", "1f1b"],
    ["--schedule", "interleaved", "--virtual-stages", "1"]])
def test_launch_train_pipeline_cpu(argv, capsys):
    """The pipeline transport through the launcher: two stages (the smoke
    model has two layer groups), two microbatches, q4q8 cuts."""
    from repro_torch.launch import train as ttrain
    assert ttrain.main(["--smoke", "--device", "cpu", "--steps", "2",
                        "--batch", "4", "--seq", "16", "--log-every", "1",
                        "--transport", "pipeline", "--stages", "2",
                        "--pipeline-microbatches", "2", "--policy", "q4q8",
                        *argv]) == 0
    out = capsys.readouterr().out
    assert f"schedule={argv[1]}" in out
    recs = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in recs)
    # one cut, two microbatches: q4 forward, q8 (per-tensor: 2 rows) back
    n = 16 * 256
    assert all(r["fw_bytes"] == 2 * (2 * n // 2 + 8) for r in recs)
    assert all(r["bw_bytes"] == 2 * (2 * n + 8) for r in recs)


def test_launch_train_runs_a_tensor_mesh(capsys):
    """``--mesh tensor=2`` (refused before the tensor axis was ported):
    the uncompressed tensor ring, its ``tp_bytes`` the raw shards'."""
    from repro_torch.launch import train as ttrain
    assert ttrain.main(["--smoke", "--device", "cpu", "--steps", "2",
                        "--batch", "4", "--seq", "32", "--log-every", "1",
                        "--mesh", "tensor=2"]) == 0
    out = capsys.readouterr().out
    recs = [json.loads(l) for l in out.splitlines() if l.startswith("{")]
    assert "# tp=2 tensor collectives: codec=none feedback=none" in out
    assert [r["step"] for r in recs] == [1, 2]
    # 4 sites x 2 collectives x 2 directions x 2 ranks, one raw bf16
    # (4, 16, 256) shard a hop
    assert all(r["tp_bytes"] == 4 * 2 * 2 * 2 * (4 * 16 * 256 * 2)
               for r in recs)


TRACE_ARGV = ["--smoke", "--device", "cpu", "--steps", "2", "--batch", "4",
              "--seq", "16", "--log-every", "1", "--policy", "q4q8"]


def test_launch_train_trace_writes_a_valid_jsonl(tmp_path, capsys):
    """``--trace PATH``: one ``train.step`` span a step, holding its loss,
    in a file that passes the schema check; tracing is off afterwards."""
    from repro_torch.launch import train as ttrain
    from repro_torch.obs import trace
    from repro_torch.obs.export import validate_jsonl
    path = tmp_path / "t.jsonl"
    assert ttrain.main(TRACE_ARGV + ["--trace", str(path)]) == 0
    out = capsys.readouterr().out
    assert f"# trace: 2 events -> {path} (dropped 0)" in out
    assert validate_jsonl(str(path)) == 2
    ev = [json.loads(l) for l in path.read_text().splitlines()]
    losses = [json.loads(l)["loss"] for l in out.splitlines()
              if l.startswith("{")]
    assert [(e["name"], e["args"]["step"]) for e in ev] == [
        ("train.step", 1), ("train.step", 2)]
    # the span keeps 6 digits of the loss, the line 4
    assert [e["args"]["loss"] for e in ev] == pytest.approx(losses,
                                                            abs=1e-4)
    assert trace.get_tracer() is None


def test_launch_train_perfetto_writes_a_chrome_trace(tmp_path, capsys):
    """``--perfetto PATH`` alone turns tracing on and writes a Chrome
    trace whose spans carry microsecond durations."""
    from repro_torch.launch import train as ttrain
    path = tmp_path / "t.json"
    assert ttrain.main(TRACE_ARGV + ["--perfetto", str(path)]) == 0
    assert f"# perfetto: 2 events -> {path}" in capsys.readouterr().out
    doc = json.loads(path.read_text())
    assert [e["name"] for e in doc["traceEvents"]] == ["train.step"] * 2
    assert all(e["ph"] == "X" and e["dur"] > 0 for e in doc["traceEvents"])


def test_launch_train_metrics_emits_the_quality_tap(tmp_path, capsys):
    """``--metrics 2``: the tap's counters and codec instants for each of
    the policy's 3 boundaries at step 2 (q4 forward, q8 backward); no
    feedback buffer, so no norms."""
    from repro_torch.launch import train as ttrain
    path = tmp_path / "t.jsonl"
    assert ttrain.main(TRACE_ARGV + ["--metrics", "2", "--trace",
                                     str(path)]) == 0
    capsys.readouterr()
    ev = [json.loads(l) for l in path.read_text().splitlines()]
    assert [e["name"] for e in ev] == ["train.step"] * 2 + [
        n for b in range(3) for n in (f"quality.boundary{b}",
                                      f"quality.codec.boundary{b}")]
    codecs = [e["args"] for e in ev if e["name"].startswith("quality.codec")]
    assert codecs == [{"step": 2, "fw_codec": "q4", "bw_codec": "q8"}] * 3
    errs = [e["args"] for e in ev if e["ph"] == "C"]
    assert all(0 < a["bw_rel_err"] < a["fw_rel_err"] < 1 for a in errs)


# ---------------------------------------------------------------------------
# gradient accumulation
# ---------------------------------------------------------------------------

# launch/train --policy presets run with grad_accum=2.  Bounds: the loss
# within LOSS_ATOL without compression, the curves' 0.05 with it
# (measured 1.9e-4 and 3.2e-3); without compression every gradient leaf
# within REL_TOL of its largest magnitude (measured 2**-6.1), under q4q8
# the gradient tree within ACCUM_GRAD_RTOL = 0.3 of its norm, the bound
# of tests/test_torch_pipeline.py for a compressed cut (measured 0.116;
# 0.128 without accumulation).  Under ef21top10 the three TopK cuts part
# the gradient from the reference's by 0.64 of its norm with or without
# accumulation (measured): its accumulation is held against its own
# pieces, bit for bit, in test_grad_accumulation_equals_the_pieces_by_hand,
# and here by its loss and its forward buffers, within 0.5 of their norm
# (the pipeline tests' buffer bound; measured at most 0.30).  Some of the
# model's params are float32 (the norms): their gradients come back
# bfloat16, as the reference's do.
ACCUM = ("none", "q4q8", "ef21top10")
ACCUM_GRAD_RTOL = 0.3


def _accum_step(pkg, cfg, params, pname, monkeypatch):
    """One step of ``pkg``'s train step with ``grad_accum=2``, the
    optimizer swapped for one that hands back the gradients."""
    from repro.core.boundary import init_boundary_state as jinit
    from repro.launch.train import POLICIES as JPOL
    import repro.core.compressors as JC
    from repro_torch.core.boundary import init_boundary_state as tinit
    from repro_torch.core.policy import POLICIES as TPOL
    grads_out = lambda opt, p, g, s, **kw: (g, s)  # noqa: E731
    toks = _tokens(cfg, seed=4)
    ids = np.arange(B, dtype=np.int32)
    if pkg == "jax":
        monkeypatch.setattr(JS, "apply_updates", grads_out)
        monkeypatch.setattr(JC, "KERNEL_BACKEND", "pallas")
        pol = JPOL[pname]()
        bst = [jinit(pol.at(i), (S, cfg.d_model), batch=B,
                     dtype=jnp.bfloat16) for i in range(pol.num_boundaries)]
        g, _, bst, m = JS.make_lm_train_step(
            cfg, pol, _opt(), donate=False, grad_accum=2)(
            params, JO.init_opt_state(_opt(), params), bst,
            {"tokens": jnp.asarray(toks, jnp.int32)}, jnp.asarray(ids))
        return g, bst, m
    monkeypatch.setattr(TS, "apply_updates", grads_out)
    pol = TPOL[pname]()
    bst = [tinit(pol.at(i), (S, cfg.d_model), batch=B, dtype=torch.bfloat16)
           for i in range(pol.num_boundaries)]
    g, _, bst, m = TS.make_lm_train_step(cfg, pol, _topt(), grad_accum=2)(
        params, TO.init_opt_state(_topt(), params), bst,
        {"tokens": torch.from_numpy(toks)}, torch.from_numpy(ids))
    return g, bst, m


@pytest.mark.parametrize("pname", ACCUM)
def test_grad_accumulation_matches_reference(pname, models, monkeypatch):
    """``grad_accum=2``: two pieces of 2, the gradients summed in f32,
    halved and cast to bfloat16 (the float32 params' too), loss and aux
    the pieces' means, the cuts' buffers split between the pieces."""
    jcfg, tcfg, jp, tp = models
    jg, jb, jm = _accum_step("jax", jcfg, jp, pname, monkeypatch)
    tg, tb, tm = _accum_step("torch", tcfg, tp, pname, monkeypatch)
    assert any(a.dtype == torch.float32 for _, a in _leaves(tp))
    exact = pname == "none"
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
        (LOSS_ATOL if exact else 0.05)
    assert abs(float(tm["total"]) - float(jm["total"])) <= \
        (LOSS_ATOL if exact else 0.05)
    jl, tl = dict(_leaves(jg)), dict(_leaves(tg))
    assert sorted(jl) == sorted(tl)
    assert all(g.dtype == torch.bfloat16 for g in tl.values())
    assert all(g.dtype == jnp.bfloat16 for g in jl.values())
    if exact:
        for n, g in tl.items():
            _assert_rel(g, jl[n], f"grad {n}")
    elif pname == "q4q8":
        got = np.concatenate([_f32(tl[n]).ravel() for n in sorted(tl)])
        want = np.concatenate([_f32(jl[n]).ravel() for n in sorted(tl)])
        assert np.linalg.norm(got - want) <= \
            ACCUM_GRAD_RTOL * np.linalg.norm(want)
    assert len(tb) == len(jb)
    for t_st, j_st in zip(tb, jb):
        for d in ("fw", "bw"):
            got, want = _f32(t_st[d].resid), _f32(j_st[d].resid)
            assert got.shape == want.shape
            if got.size and d == "fw":       # bw: the parted gradient's
                assert np.linalg.norm(got - want) <= \
                    0.5 * np.linalg.norm(want), d


@pytest.mark.parametrize("pname", ["none", "ef21top10"])
def test_grad_accumulation_equals_the_pieces_by_hand(pname, models,
                                                     monkeypatch):
    """The accumulated step is the f32 sum of its pieces' own steps (each
    on its half of the batch, ids and cut buffers), halved and cast to
    bf16, its buffers the pieces' new halves; ``microbatches=`` is its
    deprecated alias and gives the same bits."""
    from repro_torch.core.boundary import init_boundary_state as tinit
    from repro_torch.core.policy import POLICIES as TPOL
    _, tcfg, _, tp = models
    monkeypatch.setattr(TS, "apply_updates", lambda o, p, g, s, **kw: (g, s))
    pol = TPOL[pname]()
    rng = np.random.RandomState(6)

    def states(rows):
        st = [tinit(pol.at(i), (S, tcfg.d_model), batch=B,
                    dtype=torch.bfloat16) for i in range(pol.num_boundaries)]
        for s_ in st:                    # nonzero buffers, the same each time
            for d in ("fw", "bw"):
                r = s_[d].resid
                r.copy_(torch.from_numpy(rng.randn(*r.shape).astype(
                    np.float32) * 0.1).to(r.dtype))
        return [{d: s_[d].replace(resid=s_[d].resid[rows]) for d in s_}
                for s_ in st]

    toks = torch.from_numpy(_tokens(tcfg, seed=5))
    ids = torch.arange(B)
    step1 = TS.make_lm_train_step(tcfg, pol, _topt())
    pieces = []
    for i in range(2):
        rng.seed(7)
        rows = slice(i * 2, (i + 1) * 2)
        pieces.append(step1(tp, TO.init_opt_state(_topt(), tp),
                            states(rows), {"tokens": toks[rows]}, ids[rows]))
    runs = []
    for kw in ({"grad_accum": 2}, {"microbatches": 2}):
        ctx = (pytest.warns(DeprecationWarning, match="microbatches= is "
                            "deprecated") if "microbatches" in kw
               else contextlib.nullcontext())
        with ctx:
            step = TS.make_lm_train_step(tcfg, pol, _topt(), **kw)
        rng.seed(7)
        runs.append(step(tp, TO.init_opt_state(_topt(), tp),
                         states(slice(None)), {"tokens": toks}, ids))
    (g2, _, b2, m2), (ga, _, ba, ma) = runs
    for (n, a), (_, b), (_, p0), (_, p1) in zip(
            _leaves(g2), _leaves(ga), _leaves(pieces[0][0]),
            _leaves(pieces[1][0])):
        want = ((p0.float() + p1.float()) / 2).to(torch.bfloat16)
        assert torch.equal(a, want) and torch.equal(b, a), n
    assert float(m2["loss"]) == float(ma["loss"]) == \
        float((pieces[0][3]["loss"] + pieces[1][3]["loss"]) / 2)
    for j, st in enumerate(b2):
        for d in ("fw", "bw"):
            if st[d].resid.numel():
                want = torch.cat([pieces[0][2][j][d].resid,
                                  pieces[1][2][j][d].resid])
                assert torch.equal(st[d].resid, want)
                assert torch.equal(ba[j][d].resid, want)


def test_grad_accumulation_refusals_are_the_references(models):
    """Both accumulation knobs at once, AQ-SGD with accumulation and the
    pipeline with accumulation are refused as the reference refuses
    them."""
    from repro.core.policy import CompressionPolicy as JCP
    from repro.core.policy import aqsgd_policy as jaq
    from repro_torch.core.policy import CompressionPolicy as TCP
    from repro_torch.core.policy import aqsgd_policy as taq
    jcfg, tcfg, _, _ = models
    with pytest.raises(ValueError) as want:
        JS.make_lm_train_step(jcfg, JNONE, _opt(), grad_accum=2,
                              microbatches=2)
    with pytest.raises(ValueError) as got:
        TS.make_lm_train_step(tcfg, TNONE, _topt(), grad_accum=2,
                              microbatches=2)
    assert str(got.value) == str(want.value)
    for jpol, tpol, kw in (
            (JCP(4, jaq(0.1)), TCP(4, taq(0.1)), {}),
            (JCP(2), TCP(2), {"transport": "pipeline"})):
        with pytest.raises(NotImplementedError) as want:
            JS.make_lm_train_step(jcfg, jpol, _opt(), grad_accum=2, **kw)
        with pytest.raises(NotImplementedError) as got:
            TS.make_lm_train_step(tcfg, tpol, _topt(), grad_accum=2, **kw)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("argv", [["--grad-accum", "2", "--policy", "q4q8"],
                                  ["--microbatches", "2"]])
def test_launch_train_grad_accum_cpu(argv, capsys):
    from repro_torch.launch import train as ttrain
    with pytest.warns(DeprecationWarning) if "--microbatches" in argv \
            else contextlib.nullcontext():
        assert ttrain.main(["--smoke", "--device", "cpu", "--steps", "2",
                            "--batch", "4", "--seq", "16", "--log-every",
                            "1", *argv]) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in recs)
