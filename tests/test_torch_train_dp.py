"""The port's data-parallel LM train step on the simulated transport
against the JAX package's, plus the DP launcher, the per-replica id
stream and the parallel spec.

The reference runs in ONE module-scoped subprocess with 4 forced host
devices: ``make_lm_train_step(gpt2-small smoke, policy, opt, dp=2,
dp_codec=..., dp_feedback=..., donate=False)`` under ``jax.jit`` with
``KERNEL_BACKEND = "pallas"`` where a cut compresses (the port's cut
compressor is the accelerator's per-tile / block-TopK function, see
``ROADMAP.md`` §3) and
``apply_updates`` swapped for one that hands back the reduced gradient as
the new params.  Both packages start from the reference's params (carried
over through numpy) and run two steps from them, the second reading the
DP state and boundary buffers the first wrote; batch 4 (2 per lane), seq
32, ids from ``synthetic_stream(dp=2)`` with 4 samples, so that step 2
revisits step 1's AQ-SGD rows.  Cases: DP codec ``none``; q8 with EF; q4
with EF21; q8 under an EF21 TopK cut (its global buffers split by batch
shard across the lanes); q8 under an AQ-SGD TopK cut (its buffer split by
example id, the ids localized by ``shard_ids``); and, with
``grad_accum=2`` on each lane (pieces of 1: accumulate locally, reduce
once), q8 under the EF21 TopK cut, held to the same bounds; and
mixtral-8x7b's smoke model (2 MoE layers, capacity routing on each lane)
with DP codec q8.  Every case's ``aux`` (the lanes' mean MoE load-balance
loss, 0 for gpt2) within ``AUX_ATOL`` = 1e-3 of the reference's.

Bounds (measured on the CPU, then given headroom):
  * loss: ``LOSS_ATOL`` = 2e-3 without compression (the bound of
    tests/test_torch_train.py), ``LM_LOSS_ATOL`` = 0.02 with a compressed
    cut (tests/test_torch_pipeline.py);
  * the reduced gradient with DP codec ``none`` and no cut compression:
    every leaf within ``REL_TOL`` = 2**-5 of its largest magnitude
    (tests/test_torch_train.py);
  * DP codec q8 without cut compression: the gradient tree within
    ``Q8_GRAD_RTOL`` = 0.1 of its norm (measured at most 0.046);
  * DP codec q4, or a compressed cut (EF21 / AQ-SGD + TopK): within
    ``LM_GRAD_RTOL`` = 0.4 (measured at most 0.31, the EF21 cut's step
    2); the DP EF21 ``resid`` / ``agg`` and the cut's feedback buffers
    within ``STATE_RTOL`` = 0.5 of their norms, the pipeline tests' buffer
    bound (measured at most 0.39, the EF21 cut's backward buffer, whose
    backward re-selects the gradient's TopK; the DP EF21 trees 0.145);
  * EF: its residual is the quantization error itself, which a code that
    flips at a rounding boundary changes by a whole code step, so it is
    held through what EF conserves: the reduced gradient plus the
    replicas' residuals, sum_r x_r, within ``Q8_GRAD_RTOL`` (measured at
    most 0.021).
  Two bf16 models round apart (the first bound), and a q4 code step is
  2/15 of a leaf's span: a code that flips moves an element by far more
  than bf16 noise.
"""
import dataclasses
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.models.transformer as JT
from repro.configs.registry import get as jget
from repro.core import parallel as JPAR
from repro.launch.train import synthetic_stream as jstream

import repro_torch.train.steps as TS
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.registry import get as tget
from repro_torch.core import parallel as TPAR
from repro_torch.launch.train import build_policy
from repro_torch.launch.train import synthetic_stream as tstream
from repro_torch.optim import optimizers as TO
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.train.loop import init_lm_dp_state, run_lm_experiment
from repro_torch.transport.collectives import dp_wire_report
from repro_torch.core.boundary import init_boundary_state

# One intra-op thread: the suite runs in several worker processes at
# once, and a torch thread pool per worker that outnumbers the cores
# slows its CPU ops by an order of magnitude.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LOSS_ATOL = 2e-3
LM_LOSS_ATOL = 0.02
REL_TOL = 2.0 ** -5
Q8_GRAD_RTOL = 0.1
LM_GRAD_RTOL = 0.4
STATE_RTOL = 0.5
B, SEQ, DP, NS = 4, 32, 2, 4
# name -> (launch/train --policy, --feedback, dp codec, dp feedback)
CASES = {
    "none": ("none", "none", "none", "none"),
    "q8_ef": ("none", "none", "q8", "ef"),
    "q4_ef21": ("none", "none", "q4", "ef21"),
    "q8_ef21top10": ("ef21top10", "none", "q8", "none"),
    "q8_aqsgd": ("none", "aqsgd", "q8", "none"),
}
# the same, with grad_accum=2 on each lane (pieces of 1): accumulate
# locally, reduce once
ACCUM = {"q8_ef21top10_accum2": ("ef21top10", "none", "q8", "none")}
# the cases on another arch's smoke model than gpt2-small's: mixtral's
# (2 MoE layers), its capacity routing per lane, its aux the lanes' mean
CASES["mixtral_q8"] = ("none", "none", "q8", "none")
DP_ARCHS = {"mixtral_q8": "mixtral-8x7b"}
AUX_ATOL = 1e-3


def inputs(cfg):
    rng = np.random.RandomState(3)
    toks = [rng.randint(0, cfg.vocab_size, (B, SEQ)) for _ in range(2)]
    stream = tstream(cfg, B, SEQ, num_samples=NS, dp=DP)
    ids = [next(stream)[1] for _ in range(2)]
    return toks, ids


REFERENCE = r'''
import sys
import numpy as np
import jax, jax.numpy as jnp
import repro.core.compressors as JC
import repro.train.steps as JS
import repro.models.transformer as JT
from repro.configs.registry import get
from repro.core.boundary import init_boundary_state
from repro.core.policy import CompressionPolicy, aqsgd_policy
from repro.launch.train import POLICIES
from repro.optim import optimizers as JO
from repro.train.loop import init_lm_dp_state
sys.path.insert(0, sys.argv[2])
import test_torch_train_dp as T

out = {}
def save(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "name", p)))
                       for p in path)
        out[f"{prefix}/{key}"] = np.asarray(jnp.asarray(leaf, jnp.float32))

JS.apply_updates = lambda opt, p, g, s: (g, s)
opt = JO.OptimizerConfig(kind="sgd", lr=0.1)
for name, (pname, fb, codec, dfb) in [*T.CASES.items(), *T.ACCUM.items()]:
    cfg = get(T.DP_ARCHS.get(name, "gpt2-small"), smoke=True)
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    toks, ids = T.inputs(cfg)
    pol = (CompressionPolicy(num_stages=2, boundary=aqsgd_policy(0.1))
           if fb == "aqsgd" else POLICIES[pname]())
    pol = CompressionPolicy(num_stages=2, boundary=pol.boundary)
    # the accelerator's cut compressor where a cut compresses; the jnp
    # codecs (the CPU default, same bytes) elsewhere
    JC.KERNEL_BACKEND = "pallas" if (pname, fb) != ("none", "none") else "jnp"
    bst = [init_boundary_state(pol.at(0), (T.SEQ, cfg.d_model), batch=T.B,
                               num_samples=T.NS, dtype=jnp.bfloat16)]
    step = JS.make_lm_train_step(cfg, pol, opt, dp=T.DP, dp_codec=codec,
                                 dp_feedback=dfb, donate=False,
                                 grad_accum=2 if name in T.ACCUM else 1)
    dst = init_lm_dp_state(cfg, params, pol, T.DP, dfb)
    for i in range(2):
        g, _, bst, dst, m = step(params, JO.init_opt_state(opt, params), bst,
                                 {"tokens": jnp.asarray(toks[i], jnp.int32)},
                                 jnp.asarray(ids[i]), dst)
        # back through numpy: the step's outputs carry the data axis'
        # sharding, which the next call's vmap refuses beside unsharded
        # inputs
        bst, dst = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)),
                                (bst, dst))
        p = f"{name}/{i}"
        out[f"{p}/loss"] = np.float32(m["loss"])
        out[f"{p}/aux"] = np.float32(m["aux"])
        save(f"{p}/grad", g)
        if dfb != "none":
            save(f"{p}/resid", dst.resid)
        if dfb == "ef21":
            save(f"{p}/agg", dst.agg)
        for d in ("fw", "bw"):
            out[f"{p}/{d}_resid"] = np.asarray(
                bst[0][d].resid.astype(jnp.float32))
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("train_dp_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(path), str(ROOT / "tests")],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and "REFERENCE_OK" in proc.stdout, \
        proc.stderr[-3000:]
    return dict(np.load(path))


def _tree(ref, prefix, like):
    """The reference's saved tree under ``prefix`` in ``like``'s layout."""
    def go(t, p):
        if isinstance(t, dict):
            return {k: go(v, f"{p}/{k}") for k, v in t.items()}
        return ref[p]
    return go(like, prefix)


def _f32(t):
    return t.detach().float().numpy()


def _rel(got, want):
    got = np.concatenate([np.ravel(a) for a in got]).astype(np.float64)
    want = np.concatenate([np.ravel(a) for a in want]).astype(np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-12))


def _arch_model(arch):
    cfg = tget(arch, smoke=True)
    like = params_from_numpy(jax.tree.map(
        np.asarray, JT.init_params(jax.random.PRNGKey(0),
                                   jget(arch, smoke=True))), "cpu")
    return cfg, like


@pytest.fixture(scope="module")
def model():
    return _arch_model("gpt2-small")


def _policy(pname, fb):
    return dataclasses.replace(build_policy(pname, fb, 0.1), num_stages=2)


@pytest.mark.parametrize("name", list(CASES))
def test_dp_step_matches_reference(name, ref, model, monkeypatch):
    if name in DP_ARCHS:
        model = _arch_model(DP_ARCHS[name])
    _check_dp_case(name, CASES[name], 1, ref, model, monkeypatch)


@pytest.mark.parametrize("name", list(ACCUM))
def test_dp_step_with_grad_accum_matches_reference(name, ref, model,
                                                   monkeypatch):
    """Gradient accumulation composes per lane: each lane sums its two
    pieces' gradients in f32 and casts them to bf16, then one reduce."""
    _check_dp_case(name, ACCUM[name], 2, ref, model, monkeypatch)


def _check_dp_case(name, case, accum, ref, model, monkeypatch):
    cfg, params = model
    pname, fb, codec, dfb = case
    monkeypatch.setattr(TS, "apply_updates", lambda opt, p, g, s, **kw: (g, s))
    pol = _policy(pname, fb)
    opt = TO.OptimizerConfig(kind="sgd", lr=0.1)
    bst = [init_boundary_state(pol.at(0), (SEQ, cfg.d_model), batch=B,
                               num_samples=NS, dtype=torch.bfloat16)]
    with pytest.warns(TPAR.ParallelDeprecationWarning, match="deprecated"):
        step = TS.make_lm_train_step(cfg, pol, opt, dp=DP, dp_codec=codec,
                                     dp_feedback=dfb, grad_accum=accum)
    dst = init_lm_dp_state(cfg, params, pol, DP, dfb)
    toks, ids = inputs(cfg)
    exact = codec == "none" and pname == "none" and fb == "none"
    for i in range(2):
        g, _, bst, dst, m = step(params, TO.init_opt_state(opt, params), bst,
                                 {"tokens": torch.from_numpy(toks[i])},
                                 torch.from_numpy(ids[i]), dst)
        p = f"{name}/{i}"
        tol = LOSS_ATOL if pname == "none" and fb == "none" else LM_LOSS_ATOL
        assert abs(float(m["loss"]) - float(ref[f"{p}/loss"])) <= tol
        assert abs(float(m["aux"]) - float(ref[f"{p}/aux"])) <= AUX_ATOL
        assert (float(m["aux"]) > 0) == (name in DP_ARCHS)
        assert m["wire"]["dp_hops"] == DP * (DP - 1)
        want = _tree(ref, f"{p}/grad", g)
        if exact:
            for got_l, want_l in zip(tree_leaves(g), tree_leaves(want)):
                gap = float(np.abs(_f32(got_l) - want_l).max())
                assert gap <= REL_TOL * max(float(np.abs(want_l).max()),
                                            1e-6)
        else:
            lossy = codec == "q4" or (pname, fb) != ("none", "none")
            assert _rel([_f32(a) for a in tree_leaves(g)],
                        tree_leaves(want)) <= (LM_GRAD_RTOL if lossy
                                               else Q8_GRAD_RTOL)
        if dfb == "ef":          # reduced + sum_r e_r' == sum_r x_r
            w_r = tree_leaves(_tree(ref, f"{p}/resid", dst.resid))
            total = [_f32(a) + _f32(e).sum(0) for a, e in
                     zip(tree_leaves(g), tree_leaves(dst.resid))]
            assert _rel(total, [a + e.sum(0) for a, e in
                                zip(tree_leaves(want), w_r)]) <= Q8_GRAD_RTOL
        for slot in ("resid", "agg") if dfb == "ef21" else ():
            got = getattr(dst, slot)
            assert _rel([_f32(a) for a in tree_leaves(got)],
                        tree_leaves(_tree(ref, f"{p}/{slot}", got))) \
                <= STATE_RTOL, slot
        for d in ("fw", "bw"):               # the cut's feedback buffers
            got = _f32(bst[0][d].resid)
            assert got.shape == ref[f"{p}/{d}_resid"].shape
            if got.size:
                assert _rel([got], [ref[f"{p}/{d}_resid"]]) <= STATE_RTOL, d


def test_dp_step_keeps_the_callers_params_and_refuses_bad_calls(model):
    cfg, params = model
    opt = TO.OptimizerConfig(kind="sgd", lr=0.1)
    spec = TPAR.ParallelSpec({"data": TPAR.AxisSpec(size=2, codec="q8")})
    step = TS.make_lm_train_step(cfg, _policy("none", "none"), opt,
                                 parallel=spec)
    dst = init_lm_dp_state(cfg, params, _policy("none", "none"), 2)
    toks, ids = inputs(cfg)
    new, _, _, dst2, m = step(params, TO.init_opt_state(opt, params), [],
                              {"tokens": torch.from_numpy(toks[0])},
                              torch.from_numpy(ids[0]), dst)
    assert all(not p.requires_grad and p.grad is None
               for p in tree_leaves(params))
    assert dst2.mode == "none" and np.isfinite(float(m["loss"]))
    with pytest.raises(ValueError, match="not divisible"):
        step(params, TO.init_opt_state(opt, params), [],
             {"tokens": torch.from_numpy(toks[0][:3])},
             torch.from_numpy(ids[0][:3]), dst)
    with pytest.raises(ValueError, match="both parallel="):
        TS.make_lm_train_step(cfg, _policy("none", "none"), opt,
                              parallel=spec, dp=2)
    with pytest.raises(NotImplementedError, match="grad_accum > 1"):
        TS.make_lm_train_step(cfg, _policy("q4q8", "none"), opt,
                              grad_accum=2, parallel=TPAR.ParallelSpec(
                                  {"data": 2, "stage": 2}))
    with pytest.raises(ValueError, match="divisible by dp"):
        TS._make_dp_simulated_step(
            _policy("none", "aqsgd"), opt, None, 3, "none", "none", 0.1)(
            params, None, [init_boundary_state(
                _policy("none", "aqsgd").at(0), (SEQ, cfg.d_model), batch=3,
                num_samples=4)], {"tokens": torch.zeros((3, SEQ))},
            torch.arange(3), None)


def test_run_lm_experiment_dp(model):
    """``run_lm_experiment`` with the DP spec and with the legacy kwargs
    (which warn) gives the same run."""
    from repro_torch.data.synthetic import LMData
    cfg, _ = model
    data = LMData(num_train=8, num_test=4, seq_len=16, vocab=64)
    spec = TPAR.spec_from_cli("data=2", "data=q8+ef")
    a = run_lm_experiment(cfg, _policy("none", "none"), epochs=1, batch=4,
                          data=data, parallel=spec, device="cpu")
    with pytest.warns(TPAR.ParallelDeprecationWarning):
        b = run_lm_experiment(cfg, _policy("none", "none"), epochs=1,
                              batch=4, data=data, dp=2, dp_codec="q8",
                              dp_feedback="ef", device="cpu")
    assert a.train_curve == b.train_curve and len(a.train_curve) == 2
    assert np.isfinite(a.loss_on) and np.isfinite(a.loss_off)


# ---------------------------------------------------------------------------
# launcher, id stream, parallel spec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv,codec,k_frac", [
    (["--dp", "2", "--dp-codec", "q8"], "q8", 0.1),
    (["--mesh", "data=2", "--wire", "data=q4+ef"], "q4", 0.1),
    (["--mesh", "data=2", "--wire", "data=topk:0.3", "--policy", "q4q8"],
     "topk", 0.3)])
def test_launch_train_dp_cpu(argv, codec, k_frac, model, capsys):
    """The DP flags run the launcher and its JSON lines carry the ring's
    bytes: 2 replicas x 1 hop of ``dp_wire_report``'s buffer."""
    from repro_torch.launch import train as ttrain
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", TPAR.ParallelDeprecationWarning)
        assert ttrain.main(["--smoke", "--device", "cpu", "--steps", "2",
                            "--batch", "4", "--seq", "16", "--log-every",
                            "1", *argv]) == 0
    out = capsys.readouterr().out
    assert "# dp=2 gradient all-reduce" in out
    recs = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in recs)
    rep = dp_wire_report(model[1], codec, k_frac=k_frac, dp=2)
    assert all(r["dp_bytes"] == 2 * rep["payload_bytes_per_hop"]
               for r in recs)


def test_synthetic_stream_dp_ids_are_the_reference():
    jcfg, tcfg = jget("gpt2-small", smoke=True), tget("gpt2-small",
                                                      smoke=True)
    for dp, ns in ((2, 8), (4, 16)):
        js = jstream(jcfg, 8, 16, seed=5, num_samples=ns, start_step=1,
                     dp=dp)
        ts = tstream(tcfg, 8, 16, seed=5, num_samples=ns, start_step=1,
                     dp=dp)
        for _ in range(3):
            (a, ia), (b, ib) = next(ts), next(js)
            assert ia.dtype == ib.dtype
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(ia, ib)


@pytest.mark.parametrize("mesh,wire", [
    ("data=2", None), ("dp=4", "data=q8+ef:0.2"), (None, "data=topk"),
    ("data=2,stage=2", "data=q4+ef21"), ("data=3", "dp=q8")])
def test_spec_from_cli_matches_reference(mesh, wire):
    j, t = JPAR.spec_from_cli(mesh, wire), TPAR.spec_from_cli(mesh, wire)
    assert t.name == j.name and (t.dp, t.stages, t.tp) == (j.dp, j.stages,
                                                           j.tp)
    for n in TPAR.AXIS_NAMES:
        assert dataclasses.astuple(t.axis(n)) == dataclasses.astuple(
            j.axis(n))
    jp, tp = j.stage_policy(), t.stage_policy()
    assert (jp is None) == (tp is None)


@pytest.mark.parametrize("kw", [dict(dp=2, dp_codec="q8"),
                                dict(dp=3, dp_codec="q4", dp_feedback="ef21",
                                     dp_k_frac=0.2, num_stages=2)])
def test_from_legacy_matches_reference(kw):
    j, t = JPAR.from_legacy(**kw), TPAR.from_legacy(**kw)
    assert t.name == j.name
    for n in TPAR.AXIS_NAMES:
        assert dataclasses.astuple(t.axis(n)) == dataclasses.astuple(
            j.axis(n))


@pytest.mark.parametrize("mesh,wire", [
    ("tensor=2", None), ("tensor=2", "tensor=q8+ef"),
    ("data=2,stage=2,tensor=2", "data=q8,stage=q8,tensor=q4+ef21:0.2")])
def test_spec_from_cli_tensor_axis_matches_reference(mesh, wire):
    """A tensor axis (refused before it was ported) parses to the
    reference's spec."""
    j, t = JPAR.spec_from_cli(mesh, wire), TPAR.spec_from_cli(mesh, wire)
    assert t.name == j.name and (t.tp, t.num_devices) == (j.tp,
                                                          j.num_devices)
    for n in TPAR.AXIS_NAMES:
        assert dataclasses.astuple(t.axis(n)) == dataclasses.astuple(
            j.axis(n))


@pytest.mark.parametrize("mesh,wire,err", [
    (None, "data=q4@size>=1e8", ValueError),
    ("data=x", None, ValueError), ("data=0", None, ValueError),
    ("bogus=2", None, ValueError), (None, "data=q9", ValueError),
    (None, "stage=q8+ef21,data=q8+aqsgd", ValueError)])
def test_spec_from_cli_refuses(mesh, wire, err):
    with pytest.raises(err):
        TPAR.spec_from_cli(mesh, wire)
    with pytest.raises(ValueError) as want:
        JPAR.spec_from_cli(mesh, wire)
    with pytest.raises(ValueError) as got:
        TPAR.spec_from_cli(mesh, wire)
    assert str(got.value) == str(want.value)
