"""The port's telemetry (``src/repro_torch/obs/``) against the JAX
package's ``repro/obs/`` on the CPU.

Mirrors the reference's ``tests/test_obs.py`` and holds the port to the
reference wherever both can run: the event schema and both exporters,
the validator's rejections, the quality tap's rows and feedback norms,
the probes' ring pairs and accessors, the probe-driven policy flip of
``run_lm_experiment``, the train launcher's event stream, the continuous
engine's counters and the wire events' counts and arguments.

Params go JAX -> numpy -> ``params_from_numpy``; the model is gpt2-small
smoke (``num_layers=4`` where a step runs, so the 4-stage presets have 3
cuts).  The reference runs its cut compressors on its kernel path
(``KERNEL_BACKEND = "pallas"``, interpret mode), the function the port's
``Compressor`` computes on every device.  Bounds:

  * ``REL_ERR_ATOL`` = 1e-5 on a tap row's relative error (both sides
    round it to 6 digits; the same function on the same bf16 sample);
  * ``NORM_RTOL`` = 1e-6 on the norm of a state carried across (the port
    sums the squares in float64, the reference's XLA sum is accurate in
    float32), and
    ``TRAINED_NORM_RTOL`` = 0.05 on the AQ-SGD buffer after two trained
    steps, whose cut inputs part by a bf16 rounding (the reason the loss
    curves part, ``tests/test_torch_train_curves.py``);
  * losses within that file's ``CURVE_ATOL`` = 0.05.

The reference's wire events run in ONE subprocess with 4 forced host
devices and Auto-axis meshes passed as ``mesh=`` (the pattern of
``tests/test_torch_pipeline.py``), every step under ``jax.jit``.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.core.compressors as JC
import repro.models.transformer as JT
import repro.obs.export as JX
import repro.obs.probes as JPR
import repro.obs.quality as JQ
import repro.obs.trace as JTR
import repro.serve.engine as JE
from repro.configs.registry import get as jget
from repro.core import policy as JP
from repro.core.boundary import init_boundary_state as jinit
from repro.data.synthetic import LMData as JLMData
from repro.launch import train as jtrain
from repro.train.loop import run_lm_experiment as j_run_lm
from repro.transport.collectives import init_dp_state as j_init_dp

import repro_torch.kernels.ops as TKO
import repro_torch.models.transformer as TT
import repro_torch.obs.export as TX
import repro_torch.obs.keyed as TK
import repro_torch.obs.probes as TPR
import repro_torch.obs.quality as TQ
import repro_torch.obs.trace as TTR
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.registry import get as tget
from repro_torch.core import policy as TP
from repro_torch.core.boundary import init_boundary_state as tinit
from repro_torch.core.feedback import FeedbackState
from repro_torch.core.parallel import AxisSpec, ParallelSpec
from repro_torch.data.synthetic import LMData as TLMData
from repro_torch.launch import train as ttrain
from repro_torch.optim import optimizers as TO
from repro_torch.serve.engine import ContinuousEngine
from repro_torch.train import steps as TS
from repro_torch.train.loop import init_lm_dp_state
from repro_torch.train.loop import run_lm_experiment as t_run_lm
from repro_torch.transport.collectives import init_dp_state as t_init_dp
from repro_torch.transport.tp_collectives import init_tp_state

from test_torch_train_curves import CURVE_ATOL

# One intra-op thread: the suite runs in several worker processes at
# once, and a torch thread pool per worker that outnumbers the cores
# slows its CPU ops by an order of magnitude.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
REL_ERR_ATOL = 1e-5
NORM_RTOL = 1e-6
TRAINED_NORM_RTOL = 0.05
# run_lm_experiment's data and the flip's rules: q8 while the probe reads
# at least 1e9 bytes/s, q4 below
EXP_DATA = dict(num_train=16, num_test=8, seq_len=16, vocab=64, seed=0)
FLIP_RULES = "q8@bandwidth>=1e9;q4"


@pytest.fixture(autouse=True)
def no_tracer_left_on():
    """Every test starts and ends with both packages' tracers off."""
    TTR.disable()
    JTR.disable()
    yield
    TTR.disable()
    JTR.disable()


@pytest.fixture
def pallas_reference():
    prev = JC.KERNEL_BACKEND
    JC.KERNEL_BACKEND = "pallas"
    yield
    JC.KERNEL_BACKEND = prev


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jget("gpt2-small", smoke=True), num_layers=4)
    tcfg = dataclasses.replace(tget("gpt2-small", smoke=True), num_layers=4)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                             "cpu")


def _events(tr):
    return [e.to_dict() for e in tr.drain()]


def _fixed_events():
    """One span, counter and instant with fixed times and mixed args."""
    return [{"name": "train.step", "cat": "train", "ph": "X",
             "ts_us": 10.5, "dur_us": 4.0, "args": {"step": 1,
                                                    "loss": 6.25}},
            {"name": "serve.sched", "cat": "serve", "ph": "C", "ts_us": 20,
             "dur_us": 0, "args": {"queued": 3, "codec": "q8",
                                   "on": True}},
            {"name": "policy.flip", "cat": "policy", "ph": "i",
             "ts_us": 30.0, "dur_us": 0.0, "args": {"old": "q8",
                                                    "new": "q4"}}]


# ---------------------------------------------------------------------------
# trace + export
# ---------------------------------------------------------------------------

def test_event_schema_and_phases_equal_reference():
    assert TX.EVENT_SCHEMA == JX.EVENT_SCHEMA
    assert TTR.PHASES == JTR.PHASES


def test_tracer_records_spans_counters_instants():
    tr = TTR.enable()
    with TTR.span("train.step", cat="train", step=3) as sa:
        sa["loss"] = 1.5
    TTR.counter("queue", cat="serve", depth=4)
    TTR.instant("policy.resolved", cat="policy", codec="q8")
    ev = tr.snapshot()
    assert [(e.name, e.cat, e.ph) for e in ev] == [
        ("train.step", "train", "X"), ("queue", "serve", "C"),
        ("policy.resolved", "policy", "i")]
    assert ev[0].args == {"step": 3, "loss": 1.5} and ev[0].dur >= 0
    assert ev[1].args == {"depth": 4} and ev[2].args == {"codec": "q8"}
    assert len(tr.drain()) == 3 and tr.drain() == []


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_ring_buffer_drops_oldest(pkg):
    """Both packages' rings drop the oldest events and count them alike."""
    T = TTR if pkg == "port" else JTR
    tr = T.Tracer(capacity=3)
    for i in range(5):
        tr.instant("e", i=i)
    assert [e.args["i"] for e in tr.snapshot()] == [2, 3, 4]
    assert tr.stats() == {"buffered": 3, "dropped": 2, "capacity": 3}
    with pytest.raises(ValueError):
        T.Tracer(capacity=0)


def test_disabled_helpers_read_no_clock_and_make_no_event(monkeypatch):
    """Tracing off: one global check, the shared no-op context, no clock
    read, no event, and the keyed step and quality tap do nothing else."""
    def no_clock():
        raise AssertionError("a disabled helper read the clock")
    monkeypatch.setattr(TTR.time, "perf_counter", no_clock)
    assert TTR.get_tracer() is None
    ctx = TTR.span("train.step", cat="train", step=1)
    assert ctx is TTR._NULL and TTR.span("x") is ctx
    with ctx:
        TTR.instant("i", cat="c", a=1)
        TTR.counter("c", cat="c", v=2)
        TK.trace_time_instant("pipeline.wire", cat="wire", dp=1)
    calls = []
    step = TK.keyed_step(lambda *a: calls.append(a) or a)
    x = torch.zeros(2)
    assert step(x) == (x,) and calls == [(x,)]
    assert not TK._PLACED
    tap = TQ.QualityTap((2, 4), every=1, device="cpu")
    monkeypatch.setattr(TQ, "boundary_quality", lambda *a: no_clock())
    assert tap.maybe_sample(1, TP.POLICIES["q4q8"]()) is None


def test_jsonl_round_trip_validates_both_ways(tmp_path):
    tr = TTR.enable()
    with TTR.span("train.step", cat="train", step=1) as sa:
        sa["loss"] = 2.0
    TTR.counter("serve.sched", cat="serve", queued=1)
    TTR.instant("policy.flip", cat="policy", old="q8", new="q4")
    ev = tr.drain()
    path = tmp_path / "t.jsonl"
    assert TX.to_jsonl(ev, str(path)) == 3
    assert TX.validate_jsonl(str(path)) == 3
    assert JX.validate_jsonl(str(path)) == 3     # the reference reads it
    rows = [json.loads(l) for l in path.read_text().splitlines()]
    assert rows == [e.to_dict() for e in ev]
    assert rows[0]["args"] == {"step": 1, "loss": 2.0}


def test_chrome_trace_equals_reference(tmp_path):
    ev = _fixed_events()
    got, want = tmp_path / "port.json", tmp_path / "ref.json"
    assert TX.to_chrome_trace(ev, str(got)) == 3
    assert JX.to_chrome_trace(ev, str(want)) == 3
    g, w = json.loads(got.read_text()), json.loads(want.read_text())
    assert g == w
    span, ctr, inst = g["traceEvents"]
    assert span["dur"] == 4.0 and "s" not in span
    assert inst["s"] == "t"
    # counter args: numbers stay numbers, the rest (bools too) strings
    assert ctr["args"] == {"queued": 3, "codec": "q8", "on": "True"}
    assert g["displayTimeUnit"] == "ms"


def _bad_events():
    ok = _fixed_events()[0]
    drop = dict(ok)
    del drop["cat"]
    return {"missing field": [drop],
            "wrong type": [dict(ok, ts_us="10")],
            "bool number": [dict(ok, dur_us=True)],
            "unknown phase": [dict(ok, ph="B")],
            "negative time": [dict(ok, ts_us=-1.0)],
            "extra field": [dict(ok, pid=0)],
            "args not a dict": [dict(ok, args=[1])]}


@pytest.mark.parametrize("case", sorted(_bad_events()))
def test_validator_rejects_what_the_reference_rejects(case, tmp_path):
    ev = _bad_events()[case]
    with pytest.raises(ValueError) as got:
        TX.validate_events(ev)
    with pytest.raises(ValueError) as want:
        JX.validate_events(ev)
    assert str(got.value) == str(want.value)
    path = tmp_path / "bad.jsonl"
    path.write_text(json.dumps(ev[0]) + "\n")
    with pytest.raises(ValueError):
        TX.validate_jsonl(str(path))


# ---------------------------------------------------------------------------
# quality tap
# ---------------------------------------------------------------------------

def _sample(shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("name", ["q4q8", "top10", "ef21top10"])
def test_boundary_quality_matches_reference(name, pallas_reference):
    """The tap's rows on its own sample: the same codecs, and relative
    errors within ``REL_ERR_ATOL`` of the reference's on the same array."""
    tap = TQ.QualityTap((2, 16, 256), every=1, seed=3, device="cpu")
    x = _sample((2, 16, 256), seed=3)
    assert torch.equal(tap._x, torch.from_numpy(x).to(torch.bfloat16))
    got = TQ.boundary_quality(TP.POLICIES[name](), tap._x)
    want = JQ.boundary_quality(jtrain.POLICIES[name](),
                               jnp.asarray(x).astype(jnp.bfloat16))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert {k: g[k] for k in ("boundary", "fw_codec", "bw_codec")} == \
            {k: w[k] for k in ("boundary", "fw_codec", "bw_codec")}
        for k in ("fw_rel_err", "bw_rel_err"):
            assert abs(g[k] - w[k]) <= REL_ERR_ATOL, (name, k, g[k], w[k])


def _states(model, mode):
    """(port, reference) states of one kind, the same random values."""
    jcfg, _, jp, tp = model
    rng = np.random.RandomState(5)
    if mode == "dp_ef21":
        jst, tst = j_init_dp(jp, 2, "ef21"), t_init_dp(tp, 2, "ef21")
        jl, tdef = jax.tree_util.tree_flatten(jst)
        vals = [rng.standard_normal(a.shape).astype(np.float32)
                for a in jl]
        jst = jax.tree_util.tree_unflatten(tdef, [jnp.asarray(v)
                                                  for v in vals])
        it = iter(vals)

        def fill(tree):
            if isinstance(tree, dict):
                return {k: fill(tree[k]) for k in sorted(tree)}
            return torch.from_numpy(next(it))
        tst = FeedbackState(fill(tst.resid), fill(tst.mirror),
                            fill(tst.agg), scope="dp",
                            direction=tst.direction, mode=tst.mode)
        return tst, jst
    bp = {"ef": JP.ef_policy(0.1, "ef"), "ef21": JP.ef_policy(0.1, "ef21"),
          "aqsgd": JP.aqsgd_policy(0.1)}[mode]
    tbp = {"ef": TP.ef_policy(0.1, "ef"), "ef21": TP.ef_policy(0.1, "ef21"),
           "aqsgd": TP.aqsgd_policy(0.1)}[mode]
    jst, tst = [], []
    for _ in range(3):
        j = jinit(bp, (8, 16), batch=4, num_samples=6)
        t = tinit(tbp, (8, 16), batch=4, num_samples=6)
        jd, td = {}, {}
        for d in ("fw", "bw"):
            vals = {s: rng.standard_normal(getattr(j[d], s).shape).astype(
                np.float32) for s in ("resid", "mirror", "agg")}
            jd[d] = j[d].replace(**{s: jnp.asarray(v)
                                    for s, v in vals.items()})
            td[d] = t[d].replace(**{s: torch.from_numpy(v)
                                    for s, v in vals.items()})
        jst.append(jd)
        tst.append(td)
    return tst, jst


@pytest.mark.parametrize("mode", ["ef", "ef21", "aqsgd", "dp_ef21"])
def test_feedback_norms_keys_and_values_match_reference(model, mode):
    got_state, want_state = _states(model, mode)
    got, want = TQ.feedback_norms(got_state), JQ.feedback_norms(want_state)
    assert list(got) == list(want) and got, (list(got), list(want))
    for k in want:
        assert abs(got[k] - want[k]) <= NORM_RTOL * want[k], (k, got[k],
                                                             want[k])
    if mode == "aqsgd":
        assert list(got) == ["[0]['fw'].resid", "[1]['fw'].resid",
                             "[2]['fw'].resid"]


def test_feedback_norms_skip_empty_and_integer_leaves():
    st = {"a": torch.zeros(0), "b": torch.arange(3), "c": torch.ones(4),
          "d": [None, torch.ones(2, dtype=torch.float64)]}
    assert TQ.feedback_norms(st) == {"['c']": 2.0,
                                     "['d'][1]": pytest.approx(2 ** 0.5)}
    assert TQ.feedback_norms(torch.ones(4)) == {"leaf": 2.0}


def test_quality_tap_samples_on_its_grid():
    tap = TQ.QualityTap((2, 8, 16), every=2, device="cpu")
    pol = TP.POLICIES["q4q8"]()
    assert tap.maybe_sample(2, pol) is None             # tracing off
    tr = TTR.enable()
    assert tap.maybe_sample(1, pol) is None
    rows = tap.maybe_sample(2, pol, [{"x": torch.ones(4)}])
    assert len(rows) == 3
    names = [(e.name, e.ph) for e in tr.drain()]
    assert names == [n for b in range(3) for n in
                     ((f"quality.boundary{b}", "C"),
                      (f"quality.codec.boundary{b}", "i"))] + [
        ("quality.feedback_norms", "C")]
    with pytest.raises(ValueError):
        TQ.QualityTap((2, 4), every=0, device="cpu")


# ---------------------------------------------------------------------------
# probes
# ---------------------------------------------------------------------------

class _Dev:
    def __init__(self, i):
        self.id = i


class _Mesh:
    """A stand-in for ``jax.sharding.Mesh``: devices 0..N-1 in a grid."""

    def __init__(self, shape, names):
        self.devices = np.array([_Dev(i) for i in range(int(np.prod(shape)))]
                                ).reshape(shape)
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))


@pytest.mark.parametrize("shape,names", [((4,), ("stage",)),
                                         ((2, 4), ("data", "stage")),
                                         ((2, 2, 2),
                                          ("data", "stage", "tensor"))])
def test_ring_pairs_match_reference(shape, names):
    mesh = _Mesh(shape, names)
    for axis in names:
        got = TPR.ring_pairs(shape, names, axis)
        assert got == JPR.ring_pairs(mesh, axis), axis
        assert TPR.pairs_key(got) == JPR.pairs_key(got)


def test_boundary_bandwidth_accessors_match_reference():
    def meas(pkg, axis, s):
        return pkg.LinkMeasurement(axis=axis, pairs="{{0,1},{1,0}}",
                                   payload_bytes=1000, seconds=s)
    for pkg in (TPR, JPR):
        assert pkg.boundary_bandwidth(None) is None
        assert pkg.boundary_bandwidth(3) == 3.0
        assert pkg.boundary_bandwidth(meas(pkg, "data", 0.5)) == 2000.0
        both = {"data": meas(pkg, "data", 1.0),
                "stage": meas(pkg, "stage", 0.25)}
        assert pkg.boundary_bandwidth(both) == 4000.0
        assert pkg.boundary_bandwidth({"data": both["data"],
                                       "tensor": meas(pkg, "tensor",
                                                      2.0)}) == 500.0
        assert pkg.boundary_bandwidth({}) is None
        assert meas(pkg, "d", 0.0).bytes_per_s == float("inf")
    assert meas(TPR, "stage", 0.25).to_dict() == \
        meas(JPR, "stage", 0.25).to_dict()


def test_probe_mesh_times_every_axis_and_emits():
    tr = TTR.enable()
    m = TPR.probe_mesh({"data": 2, "stage": 4}, payload_bytes=4096,
                       repeats=2, device="cpu")
    assert list(m) == ["data", "stage"]
    for axis, meas in m.items():
        assert meas.payload_bytes == 4096 and meas.seconds > 0
        assert meas.pairs == TPR.pairs_key(TPR.ring_pairs(
            (2, 4), ("data", "stage"), axis))
    ev = tr.drain()
    assert [(e.name, e.cat, e.ph) for e in ev] == [("probe.ring", "probe",
                                                    "i")] * 2
    assert [e.args for e in ev] == [x.to_dict() for x in m.values()]
    with pytest.raises(ValueError):
        TPR.probe_ring(3, "data", device="cpu", grid={"data": 2})


# ---------------------------------------------------------------------------
# the probe-driven policy flip
# ---------------------------------------------------------------------------

def _scripted(values):
    it = iter(values)
    return lambda: next(it)


def test_run_lm_experiment_flip_matches_reference(model, pallas_reference):
    """A scripted probe (2e9, then 1e6 bytes/s) flips q8 -> q4 between the
    epochs in both packages: the same ``policy_curve``, the same
    ``policy.flip`` instant, losses within the curve bound."""
    jcfg, tcfg, jp, tp = model
    JTR.enable()
    want = j_run_lm(jcfg, JP.parse_policy_rules(FLIP_RULES),
                    pretrained_params=jp, epochs=2, batch=8,
                    data=JLMData(**EXP_DATA),
                    bandwidth_probe=_scripted([2e9, 1e6]))
    jev = [e.to_dict() for e in JTR.get_tracer().drain()]
    tr = TTR.enable()
    got = t_run_lm(tcfg, TP.parse_policy_rules(FLIP_RULES),
                   pretrained_params=tp, epochs=2, batch=8,
                   data=TLMData(**EXP_DATA),
                   bandwidth_probe=_scripted([2e9, 1e6]), device="cpu")
    tev = _events(tr)
    assert got.policy_curve == want.policy_curve
    assert got.policy_curve[0] != got.policy_curve[1]
    flips = [e["args"] for e in tev if e["name"] == "policy.flip"]
    assert flips == [e["args"] for e in jev if e["name"] == "policy.flip"]
    assert flips[0] == {"epoch": 1, "bandwidth": 1e6,
                                "old": got.policy_curve[0],
                                "new": got.policy_curve[1]}
    assert [(e["name"], e["ph"]) for e in tev] == [(e["name"], e["ph"])
                                                   for e in jev]
    steps = [e["args"] for e in tev if e["name"] == "train.step"]
    assert [s["epoch"] for s in steps] == [0, 0, 1, 1]
    assert [s["loss"] for s in steps] == [round(l, 6)
                                          for l in got.train_curve]
    assert np.abs(np.array(got.train_curve)
                  - np.array(want.train_curve)).max() <= CURVE_ATOL


def test_run_lm_experiment_without_probe_is_the_static_run(model):
    """No probe: bitwise the run of the statically resolved policy (a
    bandwidth rule never fires, so the default q4 holds); a probe whose
    reading never flips keeps the step and gives the same bits."""
    _, tcfg, _, tp = model
    data = TLMData(**EXP_DATA)
    rules = TP.parse_policy_rules(FLIP_RULES)
    static = TP.resolve_policy(rules, EXP_DATA["seq_len"] * tcfg.d_model)
    runs = [t_run_lm(tcfg, pol, pretrained_params=tp, epochs=2, batch=8,
                     data=data, device="cpu", **kw)
            for pol, kw in ((rules, {}), (static, {}),
                            (rules, {"bandwidth_probe": lambda: 5e5}))]
    assert runs[0].policy_curve == runs[1].policy_curve == \
        runs[2].policy_curve == [static.name] * 2
    assert runs[0].train_curve == runs[1].train_curve == \
        runs[2].train_curve
    assert runs[0].loss_on == runs[1].loss_on == runs[2].loss_on


def test_run_cnn_experiment_steps_are_spans():
    """Each CNN step runs in a ``train.step`` span holding its synced
    accuracy: an epoch's spans average to its train-curve point."""
    from repro_torch.data.synthetic import ImageClassData
    from repro_torch.train.loop import run_cnn_experiment
    tr = TTR.enable()
    res = run_cnn_experiment(TP.POLICIES["q4q8"](), epochs=2, batch=16,
                             width=8, data=ImageClassData(num_train=32,
                                                          num_test=16),
                             device="cpu")
    ev = _events(tr)
    assert [(e["name"], e["cat"], e["ph"]) for e in ev] == [
        ("train.step", "train", "X")] * 4
    for ep in range(2):
        accs = [e["args"]["acc"] for e in ev if e["args"]["epoch"] == ep]
        assert len(accs) == 2
        assert np.mean(accs) == pytest.approx(res.train_curve[ep], abs=1e-6)


# ---------------------------------------------------------------------------
# the train launcher's event stream
# ---------------------------------------------------------------------------

SMOKE_ARGV = ["--arch", "gpt2-small", "--smoke", "--feedback", "aqsgd",
              "--k-frac", "0.1", "--steps", "4", "--batch", "4", "--seq",
              "32", "--log-every", "1", "--num-samples", "8"]


def _loss_lines(out):
    return [json.loads(l)["loss"] for l in out.splitlines()
            if l.startswith("{")]


def test_launch_train_trace_matches_reference(tmp_path, monkeypatch,
                                              capsys, pallas_reference):
    """The same simulated AQ-SGD command with ``--trace --metrics 2``
    through both launchers, from the same params and tap sample: the same
    (name, cat, ph) sequence and arg keys, equal codec names and steps,
    losses within the curve bound, tap errors within ``REL_ERR_ATOL``,
    the AQ-SGD buffer's norm within ``TRAINED_NORM_RTOL``."""
    jcfg = jget("gpt2-small", smoke=True)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    monkeypatch.setattr(TT, "init_params", lambda gen, cfg: params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu"))
    init = JQ.QualityTap.__init__

    def numpy_sample(self, shape, *, every=50, dtype=jnp.bfloat16, seed=0):
        init(self, shape, every=every, dtype=dtype, seed=seed)
        self._x = jnp.asarray(_sample(shape, seed)).astype(dtype)
    monkeypatch.setattr(JQ.QualityTap, "__init__", numpy_sample)
    flags = ["--trace", str(tmp_path / "ref.jsonl"), "--metrics", "2"]
    assert jtrain.main(SMOKE_ARGV + flags) == 0
    want_loss = _loss_lines(capsys.readouterr().out)
    flags[1] = str(tmp_path / "port.jsonl")
    assert ttrain.main(SMOKE_ARGV + flags + ["--device", "cpu"]) == 0
    got_loss = _loss_lines(capsys.readouterr().out)
    assert np.abs(np.array(got_loss) - np.array(want_loss)).max() \
        <= CURVE_ATOL
    got = [json.loads(l) for l in open(tmp_path / "port.jsonl")]
    want = [json.loads(l) for l in open(tmp_path / "ref.jsonl")]
    assert [(e["name"], e["cat"], e["ph"]) for e in got] == \
        [(e["name"], e["cat"], e["ph"]) for e in want]
    assert len(got) == 4 + 2 * (2 * 3 + 1)
    for g, w in zip(got, want):
        assert list(g["args"]) == list(w["args"]), g["name"]
        for k, v in w["args"].items():
            if k == "loss":
                assert abs(g["args"][k] - v) <= CURVE_ATOL
            elif k.endswith("rel_err"):
                assert abs(g["args"][k] - v) <= REL_ERR_ATOL, (k, g, w)
            elif g["name"] == "quality.feedback_norms":
                assert abs(g["args"][k] - v) <= TRAINED_NORM_RTOL * v
            else:
                assert g["args"][k] == v, (g["name"], k)
    assert list(got[-1]["args"]) == ["[0]['fw'].resid"]


def test_launch_train_tracing_changes_nothing_but_the_tap(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    """With the three flags the loss lines are bitwise the untraced
    run's, and the cut compressors run the tap's calls on top: 2 samples
    x 3 boundaries x the fw and the bw TopK."""
    calls = []

    def counted(op):
        def call(*args):
            calls.append(op.__name__)
            return op(*args)
        return call
    for name in ("quant_dequant_op", "topk_block_op"):
        monkeypatch.setattr(TKO, name, counted(getattr(TKO, name)))
    argv = SMOKE_ARGV + ["--device", "cpu"]
    assert ttrain.main(argv) == 0
    plain, n_plain = _loss_lines(capsys.readouterr().out), len(calls)
    calls.clear()
    assert ttrain.main(argv + ["--trace", str(tmp_path / "t.jsonl"),
                               "--perfetto", str(tmp_path / "t.json"),
                               "--metrics", "2"]) == 0
    assert _loss_lines(capsys.readouterr().out) == plain
    pol = ttrain.build_policy("none", "aqsgd", 0.1)
    per_sample = sum((pol.at(i).fw.kind != "none")
                     + (pol.at(i).bw.kind != "none")
                     for i in range(pol.num_boundaries))
    assert len(calls) - n_plain == 2 * per_sample == 12
    assert TTR.get_tracer() is None


# ---------------------------------------------------------------------------
# the continuous engine
# ---------------------------------------------------------------------------

SERVE_MODES = {
    "paged": dict(tick_chunk=1, prefix_cache=True, prefill_chunk=8,
                  page_size=8),
    "slab": dict(tick_chunk=4, max_prompt=64),
}


@pytest.mark.parametrize("mode", sorted(SERVE_MODES))
def test_continuous_engine_counters_match_reference(model, mode):
    """A paged run with prefix sharing and 8-token chunks, and a slab run
    with 4-tick decode chunks, through both engines: equal
    ``serve.sched`` (and ``serve.pages``) counters, the same spans with
    the same args, and equal ``request_done`` token counts."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.RandomState(2)
    shared = rng.randint(0, 500, 24)
    prompts = [np.concatenate([shared, rng.randint(0, 500, n)])
               for n in (3, 9, 5, 12, 2)]
    news = [4, 1, 6, 9, 5]
    kw = dict(num_slots=2, max_seq=96, metrics_every=2, **SERVE_MODES[mode])
    streams = []
    for pkg in ("reference", "port"):
        T = JTR if pkg == "reference" else TTR
        tr = T.enable()
        eng = (JE.ContinuousEngine(jp, jcfg, **kw) if pkg == "reference"
               else ContinuousEngine(tp, tcfg, device="cpu", **kw))
        for i, (p, n) in enumerate(zip(prompts, news)):
            eng.submit(p.astype(np.int32), max_new_tokens=n, seed=i)
        on_grid = 0
        while not eng.sched.idle:
            eng.step()
            on_grid += eng.ticks % 2 == 0
        streams.append((eng.ticks, on_grid,
                        [e.to_dict() for e in tr.drain()]))
    (jticks, jgrid, want), (tticks, tgrid, got) = streams
    assert (tticks, tgrid) == (jticks, jgrid)
    assert [(e["name"], e["ph"]) for e in got] == \
        [(e["name"], e["ph"]) for e in want]
    for g, w in zip(got, want):
        if g["ph"] == "C" or g["name"] == "serve.request_done":
            assert g["args"].get("tokens") == w["args"].get("tokens")
            if g["ph"] == "C":
                assert g["args"] == w["args"], g["name"]
        else:
            assert g["args"] == w["args"], g["name"]
    assert sum(e["name"] == "serve.request_done" for e in got) == 5
    assert sum(e["name"] == "serve.sched" for e in got) == tgrid
    if mode == "paged":
        # a tick that only prefills leaves the decode tick count as it was
        assert tgrid > tticks // 2
        assert any(e["args"].get("prefix_hits") for e in got
                   if e["name"] == "serve.pages")
    else:
        assert not any(e["name"] == "serve.pages" for e in got)
        assert any(e["args"].get("ticks") == 4 for e in got
                   if e["name"] == "serve.decode")


def test_continuous_engine_metrics_every_sets_the_grid(model):
    _, tcfg, _, tp = model
    counts = {}
    for every in (1, 3):
        tr = TTR.enable()
        eng = ContinuousEngine(tp, tcfg, num_slots=2, max_seq=64,
                               tick_chunk=1, metrics_every=every,
                               device="cpu")
        for i, n in enumerate((5, 2, 7)):
            eng.submit(np.arange(4 + i), max_new_tokens=n)
        on_grid = 0
        while not eng.sched.idle:
            eng.step()
            on_grid += eng.ticks % every == 0
        ev = _events(tr)
        counts[every] = sum(e["name"] == "serve.sched" for e in ev)
        assert counts[every] == on_grid
        assert not any(e["name"] == "serve.pages" for e in ev)
        assert {e["name"] for e in ev if e["ph"] == "X"} == {
            "serve.prefill", "serve.decode"}
    assert counts[1] > counts[3] > 0


# ---------------------------------------------------------------------------
# when the wire events fire
# ---------------------------------------------------------------------------

def test_keyed_step_fires_once_per_key():
    """A new key opens a scope that emits each event once; the step's own
    outputs as inputs are a new key (placed); a seen key emits nothing; a
    rebuilt step starts over; outside a keyed step every call emits."""
    tr = TTR.enable()

    def body(x):
        TK.trace_time_instant("w", cat="wire", n=x.numel())
        TK.trace_time_instant("w", cat="wire", n=x.numel())    # dedup
        return x + 1

    step = TK.keyed_step(body)
    x = torch.zeros(3)
    y = step(x)
    assert len(tr.drain()) == 1
    y = step(step(y))                 # placed: a new key once, then seen
    assert len(tr.drain()) == 1
    step(x)                           # the first key again
    step(torch.zeros(4))              # a new shape
    assert [e.args for e in tr.drain()] == [{"n": 4}]
    TK.keyed_step(body)(y)            # rebuilt
    assert len(tr.drain()) == 1
    body(x)
    body(x)
    assert len(tr.drain()) == 4


B, SEQ = 8, 32
# name -> (launch/train --policy, ParallelSpec axes, schedule)
WIRE_RUNS = {
    "pipeline_dp": ("q4q8", {"data": ("q8", 2), "stage": (None, 2)},
                    "gpipe"),
    "tensor": ("none", {"tensor": ("q8", 2)}, "gpipe"),
}

WIRE_REFERENCE = r'''
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
import repro.core.compressors as JC
JC.KERNEL_BACKEND = "pallas"
import repro.train.steps as JS
import repro.models.transformer as JT
from repro.configs.registry import get
from repro.core.parallel import AxisSpec, ParallelSpec
from repro.core.policy import CompressionPolicy
from repro.launch.train import POLICIES
from repro.obs import trace
from repro.optim import optimizers as JO
from repro.train.loop import _pipeline_bstates, init_lm_dp_state
from repro.transport.tp_collectives import init_tp_state
sys.path.insert(0, sys.argv[2])
import test_torch_obs as T

cfg = dataclasses.replace(get("gpt2-small", smoke=True), num_layers=4)
params = JT.init_params(jax.random.PRNGKey(0), cfg)
opt = JO.OptimizerConfig(kind="adamw", lr=1e-3)
devs = np.array(jax.devices())
toks, ids = T.wire_inputs()
out = {}
for name, (pname, axes, sched) in T.WIRE_RUNS.items():
    spec = ParallelSpec({a: (AxisSpec(n, c) if c else n)
                         for a, (c, n) in axes.items()})
    dp, s = spec.dp, spec.stages
    pol = (dataclasses.replace(POLICIES[pname](), num_stages=s) if s > 1
           else CompressionPolicy(num_stages=1))
    if s > 1:
        mesh = Mesh(devs[:dp * s].reshape(dp, s), ("data", "stage"))
        st = _pipeline_bstates(pol, (T.SEQ, cfg.d_model), batch=T.B,
                               microbatches=2, num_samples=T.B,
                               dtype=jnp.bfloat16, dp=dp)
        extra = [init_lm_dp_state(cfg, params, pol, dp, "none",
                                  transport="pipeline")]
    else:
        mesh = Mesh(devs[:spec.tp], ("tensor",))
        st = []
        extra = [init_tp_state((T.B, T.SEQ, cfg.d_model), JT.tp_sites(cfg),
                               "none")]
    tr = trace.enable()
    step = JS.make_lm_train_step(
        cfg, pol, opt, transport="pipeline" if s > 1 else "simulated",
        mesh=mesh, pipeline_microbatches=2 if s > 1 else None,
        schedule=sched, parallel=spec, donate=False)
    p, o = params, JO.init_opt_state(opt, params)
    for i in range(3):
        r = step(p, o, st, {"tokens": jnp.asarray(toks[i], jnp.int32)},
                 jnp.asarray(ids), *extra)
        p, o, st, extra = r[0], r[1], r[2], list(r[3:-1])
    out[name] = [e.to_dict() for e in tr.drain() if e.cat == "wire"]
print("WIRE " + json.dumps(out))
'''


def wire_inputs():
    rng = np.random.RandomState(4)
    return ([rng.randint(0, 500, (B, SEQ)) for _ in range(3)],
            np.arange(B, dtype=np.int32))


@pytest.fixture(scope="module")
def wire_reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", WIRE_REFERENCE, "", str(ROOT / "tests")],
        env=env, capture_output=True, text=True, timeout=600)
    line = [l for l in proc.stdout.splitlines() if l.startswith("WIRE ")]
    assert proc.returncode == 0 and line, proc.stderr[-3000:]
    return json.loads(line[0][len("WIRE "):])


def _port_wire_run(model, name, traced=True):
    """3 steps of run ``name``; returns (wire events, losses, the steps'
    wire counts)."""
    _, tcfg, _, tp = model
    pname, axes, sched = WIRE_RUNS[name]
    spec = ParallelSpec({a: (AxisSpec(n, c) if c else n)
                         for a, (c, n) in axes.items()})
    dp, s = spec.dp, spec.stages
    opt = TO.OptimizerConfig(kind="adamw", lr=1e-3)
    if s > 1:
        pol = dataclasses.replace(TP.POLICIES[pname](), num_stages=s)
        st = []
        extra = [init_lm_dp_state(tcfg, tp, pol, dp, "none",
                                  transport="pipeline")]
    else:
        pol = TP.CompressionPolicy(num_stages=1)
        st = []
        extra = [init_tp_state((B, SEQ, tcfg.d_model),
                               TT.tp_sites(tcfg), "none")]
    tr = TTR.enable() if traced else None
    step = TS.make_lm_train_step(
        tcfg, pol, opt, transport="pipeline" if s > 1 else "simulated",
        pipeline_microbatches=2 if s > 1 else None, schedule=sched,
        parallel=spec)
    toks, ids = wire_inputs()
    p, o = tp, TO.init_opt_state(opt, tp)
    losses, wires = [], []
    for i in range(3):
        r = step(p, o, st, {"tokens": torch.from_numpy(toks[i]).long()},
                 torch.from_numpy(ids), *extra)
        p, o, st, extra = r[0], r[1], r[2], list(r[3:-1])
        losses.append(r[-1]["loss"])
        wires.append(r[-1]["wire"])
    ev = [e.to_dict() for e in tr.drain() if e.cat == "wire"] if tr else []
    TTR.disable()
    return ev, losses, wires


@pytest.mark.parametrize("name", sorted(WIRE_RUNS))
def test_wire_events_match_reference(model, wire_reference, name):
    """3 steps: the reference compiles twice (the caller's arrays, then its
    own mesh-placed outputs) and emits each wire event twice with these
    args; the port emits them as often, with the same args."""
    got, losses, wires = _port_wire_run(model, name)
    want = wire_reference[name]
    assert [(e["name"], e["cat"], e["ph"]) for e in got] == \
        [(e["name"], e["cat"], e["ph"]) for e in want]
    assert len(got) == (4 if name == "pipeline_dp" else 2)
    assert [e["args"] for e in got] == [e["args"] for e in want]
    # tracing changes nothing the steps compute
    _, plain_losses, plain_wires = _port_wire_run(model, name,
                                                  traced=False)
    assert all(torch.equal(a, b) for a, b in zip(losses, plain_losses))
    assert wires == plain_wires
