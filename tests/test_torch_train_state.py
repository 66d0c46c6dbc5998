"""Train-state checkpoints and resume: the port's files against the JAX
package's, both ways, and bitwise resumes of the port's runs.

The npz train-state file is the bridge between the packages: one written
by either restores in the other, with the same key set and every array
the same bits (bf16 as uint16 views), for the four state layouts:
simulated cuts (a list of ``{"fw", "bw"}`` FeedbackStates), the pipeline
(``init_feedback_state``'s stage-stacked ``{"fw", "bw"}``, also
interleaved, with ``(S, [v,] ...)`` buffers and ``(S, 0)`` placeholders),
DP (``init_dp_state``: a tree-valued ``resid`` and EF21's ``agg``) and
pipeline x DP (the replica dim first).  The states are filled with
random values, so that a swapped or zeroed leaf shows.  Files of the
older ``bstates/...`` + ``dp/...`` layout restore bitwise in both.

Resumes: a port run of 4 smoke steps equals 2 steps + ``save_train_state``
+ ``restore_train_state`` into freshly initialised state + 2 steps, bit
for bit in losses, params, AdamW moments and step, and every feedback
buffer, for simulated AQ-SGD, the pipeline's 1f1b EF21 TopK, DP q4 + EF21
and pipeline x DP; the launcher's ``--resume`` likewise.  A
reference-written step-2 file of an uncompressed run, resumed for 2 steps
by both packages: losses within ``RESUME_ATOL`` = 4e-4, the uncompressed
bound of tests/test_torch_train_curves.py.
"""
import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.models.transformer as JT
import repro.train.steps as JS
from repro.checkpoint import io as JIO
from repro.configs.registry import get as jget
from repro.core import policy as JP
from repro.core.boundary import init_boundary_state as jinit
from repro.launch.train import synthetic_stream as jstream
from repro.optim import optimizers as JO
from repro.transport.collectives import init_dp_state as jinit_dp
from repro.transport.pipeline import init_feedback_state as jinit_pipe

import repro_torch.models.transformer as TT
import repro_torch.train.steps as TS
from repro_torch.checkpoint import io as TIO
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.registry import get as tget
from repro_torch.core import policy as TP
from repro_torch.core.boundary import init_boundary_state as tinit
from repro_torch.core.parallel import AxisSpec, ParallelSpec
from repro_torch.launch.train import synthetic_stream as tstream
from repro_torch.optim import optimizers as TO
from repro_torch.train import loop as TL
from repro_torch.transport.collectives import init_dp_state as tinit_dp
from repro_torch.transport.pipeline import init_feedback_state as tinit_pipe

# One intra-op thread: the suite runs in several worker processes at
# once, and a torch thread pool per worker that outnumbers the cores
# slows its CPU ops by an order of magnitude.
torch.set_num_threads(1)

B, S, NS = 4, 16, 8
RESUME_ATOL = 4e-4
LAYOUTS = ("simulated", "pipeline", "pipeline_interleaved", "dp",
           "pipeline_dp")
EXTRA = {"arch": "gpt2-small", "policy": "q4q8", "feedback": "none",
         "dp": 2, "dp_codec": "q4", "tp": 1}
OPT = dict(kind="adamw", lr=1e-3, weight_decay=0.01, schedule="cosine",
           t_max=4, grad_clip=1.0)


@pytest.fixture(scope="module")
def cfgs():
    jcfg = dataclasses.replace(jget("gpt2-small", smoke=True), num_layers=4)
    tcfg = dataclasses.replace(tget("gpt2-small", smoke=True), num_layers=4)
    return jcfg, tcfg


def _layout(pkg, name, params, cfg):
    """``(bstates, dp_state or None)`` of a layout, zeros, from ``pkg``'s
    own initialisers."""
    P, binit, pinit, dinit = ((JP, jinit, jinit_pipe, jinit_dp)
                              if pkg == "jax" else
                              (TP, tinit, tinit_pipe, tinit_dp))
    bf16 = jnp.bfloat16 if pkg == "jax" else torch.bfloat16
    feat = (S, cfg.d_model)
    if name in ("simulated", "dp"):
        pol = P.CompressionPolicy(4, P.aqsgd_policy(0.1))
        bst = [binit(pol.at(i), feat, batch=B, num_samples=NS, dtype=bf16)
               for i in range(3)]
        if name == "simulated":
            return bst, None
        return bst, dinit(params, 2, "ef21")
    if name == "pipeline":
        return pinit(P.ef_policy(0.1, "ef21"), feat, num_stages=2, batch=B,
                     microbatches=2, dtype=bf16), None
    if name == "pipeline_interleaved":
        return pinit(P.aqsgd_policy(0.1), feat, num_stages=2, batch=B,
                     microbatches=2, num_samples=NS, dtype=bf16,
                     virtual_stages=2), None
    stack = (JT if pkg == "jax" else TT).stack_layer_stages(params, 2)
    return (pinit(P.ef_policy(0.1, "ef21"), feat, num_stages=2, batch=B,
                  microbatches=2, dtype=bf16, dp=2),
            dinit(stack, 2, "ef21"))


def _randomize(tree, seed):
    rng = np.random.default_rng(seed)

    def fill(a):
        if a.dtype == jnp.int32:
            return jnp.asarray(2, jnp.int32)
        return jnp.asarray(rng.standard_normal(a.shape).astype(np.float32),
                           a.dtype)
    return jax.tree.map(fill, tree)


def _ref_state(name, cfg, seed=0):
    """The reference's train state of a layout, random values:
    ``{"params", "opt", "bst", "dp"}``."""
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    opt = JO.init_opt_state(JO.OptimizerConfig(**OPT), params)
    bst, dp = _layout("jax", name, params, cfg)
    return _randomize({"params": params, "opt": opt, "bst": bst, "dp": dp},
                      seed)


def _port_like(name, cfg):
    params = TT.init_params(torch.Generator().manual_seed(0), cfg)
    opt = TO.init_opt_state(TO.OptimizerConfig(**OPT), params)
    bst, dp = _layout("torch", name, params, cfg)
    return {"params": params, "opt": opt, "bst": bst, "dp": dp}


def _ref_like(name, cfg):
    return jax.tree.map(jnp.zeros_like, _ref_state(name, cfg))


def _to_port(st):
    return {k: None if v is None else
            params_from_numpy(jax.tree.map(np.asarray, v), "cpu")
            for k, v in st.items()}


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            return "bfloat16", a.view(torch.int16).numpy().view(np.uint16)
        return str(a.dtype).split(".")[-1], a.numpy().copy()
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return "bfloat16", a.view(np.uint16)
    return a.dtype.name, a


def _ref_flat(tree):
    return {JIO._tree_key(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_bitwise(got, want, what=""):
    """Two flat ``{key: array or tensor}`` dicts: equal key sets, and
    every array the same dtype, shape and bits."""
    assert sorted(got) == sorted(want), what
    for k in want:
        (gd, g), (wd, w) = _bits(got[k]), _bits(want[k])
        assert gd == wd and g.shape == w.shape, (what, k, gd, wd)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


def _state_tree(st):
    fb = {"boundary": st["bst"]}
    if st["dp"] is not None:
        fb["dp"] = st["dp"]
    return {"params": st["params"], "opt": st["opt"], "feedback": fb}


def _file_keys(path):
    with np.load(path) as f:
        return sorted(k[:-5] if k.endswith("@bf16") else k
                      for k in f.files if k != "__meta__")


@pytest.mark.parametrize("name", LAYOUTS)
def test_reference_file_restores_in_the_port(name, cfgs, tmp_path):
    jcfg, tcfg = cfgs
    ref = _ref_state(name, jcfg)
    path = str(tmp_path / "ref.npz")
    JIO.save_train_state(path, ref["params"], ref["opt"], ref["bst"],
                         step=2, extra=EXTRA, dp_state=ref["dp"])
    like = _port_like(name, tcfg)
    args = (path, like["params"], like["opt"], like["bst"])
    if like["dp"] is None:
        params, opt, bst, step = TIO.restore_train_state(*args)
        dp = None
    else:
        params, opt, bst, dp, step = TIO.restore_train_state(
            *args, dp_like=like["dp"])
    assert step == 2
    got = TIO._flatten(_state_tree({"params": params, "opt": opt,
                                    "bst": bst, "dp": dp}))
    want = _ref_flat(_state_tree(ref))
    assert _file_keys(path) == sorted(want)
    _assert_bitwise(got, want, name)
    # the restored leaves are the file's dtypes: bf16 params, f32 moments,
    # an int32 step
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 2
    assert any(t.dtype == torch.bfloat16 for t in got.values())


@pytest.mark.parametrize("name", LAYOUTS)
def test_port_file_restores_in_the_reference(name, cfgs, tmp_path):
    jcfg, _ = cfgs
    ref = _ref_state(name, jcfg, seed=1)
    port = _to_port(ref)
    ppath, rpath = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    TIO.save_train_state(ppath, port["params"], port["opt"], port["bst"],
                         step=2, extra=EXTRA, dp_state=port["dp"])
    JIO.save_train_state(rpath, ref["params"], ref["opt"], ref["bst"],
                         step=2, extra=EXTRA, dp_state=ref["dp"])
    with np.load(ppath) as a, np.load(rpath) as b:
        assert sorted(a.files) == sorted(b.files)
        assert json.loads(str(a["__meta__"])) == \
            json.loads(str(b["__meta__"]))
        assert json.loads(str(a["__meta__"]))["extra"]["format"] == \
            "train-state"
        for k in a.files:
            if k != "__meta__":
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    like = _ref_like(name, jcfg)
    out = JIO.restore_train_state(ppath, like["params"], like["opt"],
                                  like["bst"], dp_like=like["dp"])
    got = {"params": out[0], "opt": out[1], "bst": out[2],
           "dp": out[3] if like["dp"] is not None else None}
    assert out[-1] == 2
    _assert_bitwise(_ref_flat(_state_tree(got)),
                    _ref_flat(_state_tree(ref)), name)


def _legacy_tree(name, st):
    """The older layout of a state: boundary buffers under ``bstates``
    (raw per-direction arrays, or the pipeline's ``{"send", "recv"}``),
    the DP state under ``dp`` without its size-0 ``mirror``."""
    if isinstance(st["bst"], list):
        bst = [{d: c[d].resid for d in ("fw", "bw")} for c in st["bst"]]
    else:
        bst = {d: {"send": st["bst"][d].resid, "recv": st["bst"][d].mirror}
               for d in ("fw", "bw")}
    tree = {"params": st["params"], "opt": st["opt"], "bstates": bst}
    if st["dp"] is not None:
        tree["dp"] = {"resid": st["dp"].resid, "agg": st["dp"].agg}
    return tree


@pytest.mark.parametrize("name", ["dp", "pipeline"])
def test_legacy_file_restores_bitwise_in_both(name, cfgs, tmp_path):
    jcfg, tcfg = cfgs
    ref = _ref_state(name, jcfg, seed=2)
    path = str(tmp_path / "legacy.npz")
    JIO.save(path, _legacy_tree(name, ref), step=2)
    assert not any(k.startswith("feedback/") for k in _file_keys(path))
    want = _ref_flat(_state_tree(ref))
    jl = _ref_like(name, jcfg)
    out = JIO.restore_train_state(path, jl["params"], jl["opt"], jl["bst"],
                                  dp_like=jl["dp"])
    _assert_bitwise(_ref_flat(_state_tree(
        {"params": out[0], "opt": out[1], "bst": out[2],
         "dp": out[3] if jl["dp"] is not None else None})), want, "ref")
    tl = _port_like(name, tcfg)
    out = TIO.restore_train_state(path, tl["params"], tl["opt"], tl["bst"],
                                  dp_like=tl["dp"])
    assert out[-1] == 2
    _assert_bitwise(TIO._flatten(_state_tree(
        {"params": out[0], "opt": out[1], "bst": out[2],
         "dp": out[3] if tl["dp"] is not None else None})), want, "port")


def test_mismatch_lists_every_key_as_the_reference(cfgs, tmp_path):
    """Missing, shape-mismatched and extra keys in one
    :class:`CheckpointMismatch`, its message the reference's."""
    jcfg, _ = cfgs
    ref = _ref_state("simulated", jcfg)
    port = _to_port(ref)
    path = str(tmp_path / "s.npz")
    TIO.save_train_state(path, port["params"], port["opt"], port["bst"],
                         step=2)
    first = sorted(port["params"])[0]
    msgs = []
    for pkg, st, zeros in (("torch", port, torch.zeros),
                           ("jax", ref, jnp.zeros)):
        params = dict(st["params"])
        params[first] = zeros((params[first].shape[0] + 1,
                               *params[first].shape[1:]),
                              dtype=params[first].dtype)
        opt = dict(st["opt"], extra=zeros((3,)))
        io = TIO if pkg == "torch" else JIO
        with pytest.raises(io.CheckpointMismatch) as e:
            io.restore_train_state(path, params, opt, st["bst"][:2])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "missing keys (1): opt/extra" in msgs[0]
    assert f"shape mismatches (1): params/{first}" in msgs[0]
    assert "extra keys in file (6): feedback/boundary/2/bw/agg" in msgs[0]


def test_strict_restore_refuses_leftover_state(cfgs, tmp_path):
    """A DP file resumed without its data axis: the DP state is left over
    and the strict restore refuses it; the non-strict restore takes a
    subset, as ``restore_params`` does from a train-state file."""
    _, tcfg = cfgs
    like = _port_like("dp", tcfg)
    path = str(tmp_path / "dp")
    TIO.save_train_state(path, like["params"], like["opt"], like["bst"],
                         step=3, dp_state=like["dp"])
    path += ".npz"
    with pytest.raises(TIO.CheckpointMismatch, match="feedback/dp/agg"):
        TIO.restore_train_state(path, like["params"], like["opt"],
                                like["bst"])
    sub, step = TIO.restore(path, {"params": like["params"]})
    assert step == 3
    params, step = TIO.restore_params(path, like["params"])
    _assert_bitwise(TIO._flatten(params), TIO._flatten(like["params"]))
    _assert_bitwise(TIO._flatten(sub["params"]),
                    TIO._flatten(like["params"]))
    with pytest.raises(TIO.CheckpointMismatch, match="extra keys in file"):
        TIO.restore(path, {"params": like["params"]}, strict=True)


# ---------------------------------------------------------------------------
# bitwise resumes of the port's runs
# ---------------------------------------------------------------------------

def _ef21(stages):
    return TP.CompressionPolicy(stages, TP.ef_policy(0.1, "ef21"))


RUNS = {
    "simulated_aqsgd": dict(policy=TP.CompressionPolicy(
        4, TP.aqsgd_policy(0.1))),
    "pipeline_1f1b_ef21": dict(policy=_ef21(2), transport="pipeline",
                               schedule="1f1b"),
    "dp_q4_ef21": dict(policy=TP.POLICIES["q4q8"](),
                       parallel={"data": AxisSpec(2, "q4", "ef21")}),
    "pipeline_dp": dict(policy=_ef21(2), transport="pipeline",
                        parallel={"data": AxisSpec(2, "q4", "ef21"),
                                  "stage": 2}),
}


def _fresh(tcfg, run, opt):
    pol = run["policy"]
    pipe = run.get("transport") == "pipeline"
    dp = 2 if "parallel" in run else 1
    params = TT.init_params(torch.Generator().manual_seed(0), tcfg)
    if pipe:
        bst = TL._pipeline_bstates(pol, (S, tcfg.d_model), batch=B,
                                   microbatches=2, num_samples=NS,
                                   dtype=torch.bfloat16, dp=dp)
    else:
        bst = [tinit(pol.at(i), (S, tcfg.d_model), batch=B, num_samples=NS,
                     dtype=torch.bfloat16) for i in range(3)]
    dps = (TL.init_lm_dp_state(tcfg, params, pol, 2, "ef21",
                               transport="pipeline" if pipe else "simulated")
           if dp > 1 else None)
    return {"params": params, "opt": TO.init_opt_state(opt, params),
            "bst": bst, "dp": dps}


def _steps(tcfg, step, st, start, n, dp):
    stream = tstream(tcfg, B, S, 0, num_samples=NS, start_step=start, dp=dp)
    losses = []
    for _ in range(n):
        toks, ids = next(stream)
        args = [st["params"], st["opt"], st["bst"],
                {"tokens": torch.from_numpy(toks).long()},
                torch.from_numpy(ids)]
        if st["dp"] is not None:
            args.append(st["dp"])
        out = step(*args)
        st = {"params": out[0], "opt": out[1], "bst": out[2],
              "dp": out[3] if st["dp"] is not None else None}
        losses.append(float(out[-1]["loss"]))
    return losses, st


@pytest.mark.parametrize("name", list(RUNS))
def test_port_resume_is_bitwise(name, cfgs, tmp_path):
    _, tcfg = cfgs
    run = RUNS[name]
    opt = TO.OptimizerConfig(**OPT)
    kw = {}
    if run.get("transport") == "pipeline":
        kw = dict(transport="pipeline", pipeline_microbatches=2,
                  schedule=run.get("schedule", "gpipe"))
    if "parallel" in run:
        kw["parallel"] = ParallelSpec(run["parallel"])
    step = TS.make_lm_train_step(tcfg, run["policy"], opt, remat=False, **kw)
    dp = 2 if "parallel" in run else 1
    want_losses, want = _steps(tcfg, step, _fresh(tcfg, run, opt), 0, 4, dp)
    first, mid = _steps(tcfg, step, _fresh(tcfg, run, opt), 0, 2, dp)
    path = str(tmp_path / "mid.npz")
    TIO.save_train_state(path, mid["params"], mid["opt"], mid["bst"],
                         step=2, dp_state=mid["dp"])
    del mid
    like = _fresh(tcfg, run, opt)
    out = TIO.restore_train_state(path, like["params"], like["opt"],
                                  like["bst"], dp_like=like["dp"])
    assert out[-1] == 2
    back = {"params": out[0], "opt": out[1], "bst": out[2],
            "dp": out[3] if like["dp"] is not None else None}
    rest, got = _steps(tcfg, step, back, 2, 2, dp)
    assert first + rest == want_losses
    _assert_bitwise(TIO._flatten(_state_tree(got)),
                    TIO._flatten(_state_tree(want)), name)
    assert int(got["opt"]["step"]) == 4
    # the buffers moved: the comparison holds live state, not zeros
    bufs = TIO._flatten(_state_tree(got)["feedback"])
    assert any(t.numel() and t.abs().max() > 0 for t in bufs.values())


def test_reference_file_resumes_in_the_port(cfgs, tmp_path):
    """An uncompressed reference run saved at step 2, resumed by both
    packages for 2 steps."""
    jcfg, tcfg = cfgs
    jopt, topt = JO.OptimizerConfig(**OPT), TO.OptimizerConfig(**OPT)
    jstep = JS.make_lm_train_step(jcfg, JP.NO_POLICY, jopt, donate=False)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    jo = JO.init_opt_state(jopt, jp)
    stream = jstream(jcfg, B, S, 0, num_samples=NS)
    for _ in range(2):
        toks, ids = next(stream)
        jp, jo, _, _ = jstep(jp, jo, [], {"tokens": jnp.asarray(toks)},
                             jnp.asarray(ids))
    path = str(tmp_path / "ref.npz")
    JIO.save_train_state(path, jp, jo, [], step=2)
    jp, jo, _, step = JIO.restore_train_state(
        path, jax.tree.map(jnp.zeros_like, jp),
        jax.tree.map(jnp.zeros_like, jo), [])
    like = _port_like("simulated", tcfg)
    tp, to, bst, tstep_n = TIO.restore_train_state(
        path, like["params"], like["opt"], [])
    assert step == tstep_n == 2 and bst == []
    tstep = TS.make_lm_train_step(tcfg, TP.NO_POLICY, topt)
    js, ts = (jstream(jcfg, B, S, 0, num_samples=NS, start_step=2),
              tstream(tcfg, B, S, 0, num_samples=NS, start_step=2))
    for _ in range(2):
        (toks, ids), _ = next(js), next(ts)
        jp, jo, _, jm = jstep(jp, jo, [], {"tokens": jnp.asarray(toks)},
                              jnp.asarray(ids))
        tp, to, _, tm = tstep(tp, to, [],
                              {"tokens": torch.from_numpy(toks).long()},
                              torch.from_numpy(ids))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= RESUME_ATOL
    assert int(to["step"]) == int(jo["step"]) == 4


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _launch(argv, capsys):
    from repro_torch.launch import train as ttrain
    assert ttrain.main(["--smoke", "--device", "cpu", "--batch", str(B),
                        "--seq", str(S), "--log-every", "1", *argv]) == 0
    out = capsys.readouterr().out
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def _lines(recs):
    """The JSON lines less their clock readings."""
    return [{k: v for k, v in r.items() if k not in ("tok_per_s", "wall_s")}
            for r in recs]


@pytest.mark.parametrize("argv", [
    ["--feedback", "aqsgd", "--num-samples", str(NS)],
    ["--mesh", "data=2", "--wire", "data=q4+ef21", "--policy", "q4q8"],
    ["--transport", "pipeline", "--stages", "2", "--schedule", "1f1b",
     "--pipeline-microbatches", "2", "--feedback", "ef21"]])
def test_launcher_resume_gives_the_same_lines(argv, capsys, tmp_path):
    """``--steps 4`` against a 4-step run that saves every 2 steps (one
    file a save through ``{step}``) and ``--resume`` from its step-2
    file.  The interruption is a run saved at step 2 of 4: the cosine
    schedule spans ``--steps``, so a run launched with ``--steps 2`` is
    another run, in both packages."""
    want = _lines(_launch(["--steps", "4", *argv], capsys))
    ckpt = str(tmp_path / "run_{step}.npz")
    saved = _lines(_launch(["--steps", "4", "--ckpt", ckpt, "--save-every",
                            "2", *argv], capsys))
    assert saved == want
    files = sorted(os.listdir(tmp_path))
    assert files == ["run_2.npz", "run_4.npz"]
    with np.load(tmp_path / "run_2.npz") as f:
        meta = json.loads(str(f["__meta__"]))
    assert meta["step"] == 2 and meta["extra"]["format"] == "train-state"
    got = _lines(_launch(["--steps", "4", "--resume",
                          str(tmp_path / "run_2.npz"), *argv], capsys))
    assert [r["step"] for r in got] == [3, 4]
    assert got == want[2:]


def test_launcher_checkpoint_flags(capsys, tmp_path):
    ckpt = str(tmp_path / "one.npz")
    with pytest.warns(DeprecationWarning, match="--ckpt-every"):
        _launch(["--steps", "2", "--ckpt", ckpt, "--ckpt-every", "1"],
                capsys)
    # without {step}, each save overwrites the one file
    assert os.listdir(tmp_path) == ["one.npz"]
    with np.load(ckpt) as f:
        assert json.loads(str(f["__meta__"]))["step"] == 2
    from repro_torch.launch import train as ttrain
    with pytest.raises(SystemExit):
        ttrain.main(["--smoke", "--device", "cpu", "--ckpt", ckpt,
                     "--ckpt-every", "2", "--save-every", "2"])
    assert "conflicts with --save-every" in capsys.readouterr().err
    # a DP file resumed without --mesh: its DP state is left over
    dp = str(tmp_path / "dp.npz")
    _launch(["--steps", "1", "--ckpt", dp, "--mesh", "data=2", "--wire",
             "data=q4+ef21"], capsys)
    with pytest.raises(TIO.CheckpointMismatch, match="feedback/dp"):
        ttrain.main(["--smoke", "--device", "cpu", "--batch", str(B),
                     "--seq", str(S), "--steps", "2", "--resume", dp])
    # a resume at --steps already reached trains nothing
    assert _launch(["--steps", "2", "--resume", ckpt], capsys) == []


def test_launcher_rule_specs(capsys):
    """A rule-spec ``--policy`` and a rule-coded ``--wire`` codec run and
    give the lines of the static policy they resolve to; a bad spec is an
    argparse error naming it."""
    rules = _lines(_launch(["--steps", "2", "--policy",
                            "q4@dir=fw;q8"], capsys))
    static = _lines(_launch(["--steps", "2", "--policy", "q4q8"], capsys))
    assert rules == static
    base = ["--steps", "2", "--mesh", "data=2", "--policy", "q4q8"]
    coded = _lines(_launch([*base, "--wire", "data=q4@size>=1000000;q8"],
                           capsys))
    assert coded == _lines(_launch([*base, "--wire", "data=q4"], capsys))
    from repro_torch.launch import train as ttrain
    with pytest.raises(SystemExit):
        ttrain.main(["--smoke", "--device", "cpu", "--policy", "q4@size>1"])
    err = capsys.readouterr().err
    assert "'q4@size>1' is neither a named policy" in err
    with pytest.raises(SystemExit):
        ttrain.main(["--smoke", "--device", "cpu", "--mesh", "data=2",
                     "--wire", "data=q4@size>=1e8;q8"])
    assert "integers" in capsys.readouterr().err
