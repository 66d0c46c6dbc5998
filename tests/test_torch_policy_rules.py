"""The port's PolicyRules engine and rule-coded axis codecs against the
JAX package's, and rule policies in a training step.

Parsing and resolution are pure Python in both packages, so they are
compared exactly: every rule's fields and ``name``, the rule set's
``name``, ``resolve`` at several sizes, per-cut size lists, with and
without a bandwidth (the resolved policy field by field: each cut's
compressor kind, bits and k_frac, its name and the overrides), the
error class and message of every malformed spec and of every cut no rule
covers.  A spec list covers every condition, direction, k_frac and
scientific bandwidths; hypothesis adds generated specs.

Training under a per-cut rule policy: ``topk:0.1@depth<1,dir=fw;q4@dir=bw;
q8`` resolves to TopK forward / q4 backward at cut 0 and q8 / q4 at cuts
1-2 of the smoke LM (``num_layers=4``, 3 cuts).  One simulated step in
each package (the reference on its kernel path, ``KERNEL_BACKEND =
"pallas"``), held to tests/test_torch_train.py's compressed bounds: the
loss within 0.05 and the gradient tree within 0.3 of its norm.  The CNN
at width 8 under ``topk:0.1@size>=8192;q4@size>=4096;q8`` (its cuts hold
8,192, 4,096 and 2,048 elements an example, so each gets another codec)
through ``run_cnn_experiment`` for one epoch, held to
tests/test_torch_cnn_train.py's bounds for a TopK run: accuracy with
compression on and off equal, eval losses within 0.05, the train curve
within two examples in 64, ``policy_curve`` equal.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.core.compressors as JCC
import repro.models.cnn as JC
import repro.models.transformer as JT
import repro.train.steps as JS
from repro.configs.registry import get as jget
from repro.core import parallel as JPAR
from repro.core import policy as JP
from repro.core.boundary import init_boundary_state as jinit
from repro.data.synthetic import ImageClassData as JData
from repro.optim import optimizers as JO
from repro.train import loop as JL

import repro_torch.train.steps as TS
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.registry import get as tget
from repro_torch.core import parallel as TPAR
from repro_torch.core import policy as TP
from repro_torch.core.boundary import init_boundary_state as tinit
from repro_torch.data.synthetic import ImageClassData as TData
from repro_torch.optim import optimizers as TO
from repro_torch.train import loop as TL

from conftest import hypothesis_or_stubs

given, settings, st = hypothesis_or_stubs()

# One intra-op thread: the suite runs in several worker processes at
# once, and a torch thread pool per worker that outnumbers the cores
# slows its CPU ops by an order of magnitude.
torch.set_num_threads(1)

GOOD = [
    "q8", "none", "q4", "topk", "topk:0.05", "topk:1.0@size<10",
    "q4@size>=65536", "topk:0.1@size>=65536,dir=fw", "q8@depth<1",
    "q4@depth>=1,depth<3", "none@bandwidth>=50e9", "q4@bandwidth<1.5E9",
    "q8@bandwidth>=1e+9,size<4096", "topk:0.2@dir=bw,size>=16384",
    "q4@size>=65536;q8@size>=16384;none",
    "topk:0.1@depth<1,dir=fw;q4@dir=bw;q8", "q4@bandwidth<1e9;q8",
    " q8 ; none ", "q4@size>=100000000;q8", "topk:0.3@dir=fw;;none",
    "q8@bandwidth>=2.5e10,bandwidth<1e11;q4",
]
BAD = ["q9", "topk:abc", "q8@size>1", "q8@size>=1e8", "q8@dir=up",
       "topk:0", "topk:1.5", "", ";", " ; ", "q8@depth>=1.5",
       "q8@@size>=1", "q8@size>=-1", "q8@colour=red", "topk:0.1:0.2"]
SIZES = [1, 2048, 4096, 8192, 16384, 65536, 98304, 123570432]
CUT_SIZES = [(65536, 32768, 16384), (8192, 4096, 2048), (98304,) * 3]
BANDWIDTHS = [None, 1e8, 1e9, 5e10, 1e12]


def _comp(c):
    return (c.kind, c.bits, c.k_frac, c.name)


def _plan(pol):
    """A resolved CompressionPolicy as plain values, field by field."""
    cuts = [(_comp(pol.at(i).fw), _comp(pol.at(i).bw), pol.at(i).feedback,
             pol.at(i).bw_feedback, pol.at(i).reuse_indices, pol.at(i).name)
            for i in range(pol.num_boundaries)]
    return (pol.num_stages, pol.name, len(pol.overrides),
            [i for i, _ in pol.overrides], cuts)


def _outcome(fn):
    """``("ok", value)`` or ``(error class name, message)``."""
    try:
        return "ok", fn()
    except (ValueError, TypeError) as e:
        return type(e).__name__, str(e)


def _check_spec(spec, num_stages=4):
    j = _outcome(lambda: JP.parse_policy_rules(spec, num_stages))
    t = _outcome(lambda: TP.parse_policy_rules(spec, num_stages))
    assert j[0] == t[0], (spec, j, t)
    if j[0] != "ok":
        assert j[1] == t[1]
        return False
    jr, tr = j[1], t[1]
    assert tr.name == jr.name and tr.num_stages == jr.num_stages
    assert len(tr.rules) == len(jr.rules)
    for a, b in zip(tr.rules, jr.rules):
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
        assert a.name == b.name and a.needs_bandwidth == b.needs_bandwidth
    for bw in BANDWIDTHS:
        for n in SIZES:
            for depth in range(3):
                for d in ("fw", "bw"):
                    assert (_outcome(lambda: tr.pick(n, depth, d, bw).name)
                            == _outcome(lambda: jr.pick(n, depth, d,
                                                        bw).name))
        for sizes in [*SIZES, *CUT_SIZES, (1, 2)]:
            got = _outcome(lambda: _plan(tr.resolve(sizes, bw)))
            want = _outcome(lambda: _plan(jr.resolve(sizes, bw)))
            assert got == want, (spec, sizes, bw)
            got = _outcome(lambda: _plan(TP.resolve_policy(tr, sizes, bw)))
            assert got == want
    return True


@pytest.mark.parametrize("spec", GOOD)
def test_good_specs_match_reference(spec):
    assert _check_spec(spec)


@pytest.mark.parametrize("spec", BAD)
def test_bad_specs_raise_as_the_reference(spec):
    assert not _check_spec(spec)


def test_spec_list_covers_every_condition():
    names = ";".join(TP.parse_policy_rules(s).name for s in GOOD)
    for cond in ("size>=", "size<", "depth>=", "depth<", "bandwidth>=",
                 "bandwidth<", "dir=fw", "dir=bw", "topk:0.05"):
        assert cond in names, cond
    # scientific bandwidths are named with {:g}, as the reference names them
    assert TP.parse_rule("none@bandwidth>=50e9").name == \
        JP.parse_rule("none@bandwidth>=50e9").name == "none@bandwidth>=5e+10"


_COND = st.one_of(
    st.builds(lambda k, op, v: f"{k}{op}{v}",
              st.sampled_from(["size", "depth"]), st.sampled_from([">=", "<"]),
              st.integers(0, 200000)),
    st.builds(lambda op, m, e: f"bandwidth{op}{m}e{e}",
              st.sampled_from([">=", "<"]), st.integers(1, 99),
              st.integers(6, 12)),
    st.sampled_from(["dir=fw", "dir=bw", "dir=up", "size>1", "depth>=1.5"]))
_RULE = st.builds(
    lambda codec, kf, conds: (codec + (f":{kf}" if kf is not None else "")
                              + ("@" + ",".join(conds) if conds else "")),
    st.sampled_from(["none", "q8", "q4", "topk", "q2"]),
    st.one_of(st.none(), st.sampled_from([0.01, 0.1, 0.25, 0.5, 1.0, 0.0,
                                          2.0])),
    st.lists(_COND, max_size=3))


@given(rules=st.lists(_RULE, min_size=1, max_size=4),
       num_stages=st.integers(1, 5))
@settings(max_examples=60, deadline=None)
def test_generated_specs_match_reference(rules, num_stages):
    _check_spec(";".join(rules), num_stages)


def test_one_rule_set_equals_its_static_policy():
    for P in (TP, JP):
        static = P.CompressionPolicy(4, P.quant_policy(8, 8))
        assert P.parse_policy_rules("q8").resolve(98304) == static
        assert P.resolve_policy(P.parse_policy_rules("q8"), [5, 6, 7]) \
            == static
        assert P.resolve_policy(static, 3) is static
        assert P.parse_policy_rules("topk:0.1").resolve(10) == \
            P.CompressionPolicy(4, P.topk_policy(0.1))


# ---------------------------------------------------------------------------
# rule-coded axis codecs
# ---------------------------------------------------------------------------

AXIS_CODECS = ["q4@size>=100000000;q8", "topk:0.2@size<1000;q8",
               "q4@bandwidth<1e9;q8", "none@size<1;topk:0.05", "q8"]


def _axes(spec):
    return (spec.name, [(n, dataclasses.astuple(a)) for n, a in spec.axes])


@pytest.mark.parametrize("codec", AXIS_CODECS)
def test_axis_codecs_resolve_as_the_reference(codec):
    for P in (TPAR, JPAR):
        assert P.AxisSpec(size=2, codec=codec).is_rules == (codec != "q8")
    for n in (0, 10, 999, 123570432):
        for bw in (None, 1e8, 1e10):
            t = TPAR.AxisSpec(size=2, codec=codec, feedback="ef").resolve(
                n, bw)
            j = JPAR.AxisSpec(size=2, codec=codec, feedback="ef").resolve(
                n, bw)
            assert dataclasses.astuple(t) == dataclasses.astuple(j)
            sizes = {"data": n, "stage": 98304}
            tw, jw = (P.ParallelSpec({"data": P.AxisSpec(2, codec),
                                      "stage": P.AxisSpec(2, codec)})
                      for P in (TPAR, JPAR))
            assert _axes(tw) == _axes(jw)
            assert _axes(tw.resolved(sizes, bw)) == \
                _axes(jw.resolved(sizes, bw))
            assert _axes(tw.resolved(bandwidth=bw)) == \
                _axes(jw.resolved(bandwidth=bw))


@pytest.mark.parametrize("codec", AXIS_CODECS)
def test_wire_cli_takes_rule_codecs_as_the_reference(codec):
    """``--wire`` splits an item at its first ``:``, so a rule codec with
    a k_frac is refused there by both packages alike."""
    wire = f"data={codec},stage=q8"
    got = _outcome(lambda: _axes(TPAR.spec_from_cli("data=2,stage=2", wire)))
    want = _outcome(lambda: _axes(JPAR.spec_from_cli("data=2,stage=2",
                                                     wire)))
    assert got == want


def test_rule_axis_plans_and_refusals_match_reference():
    t = TPAR.ParallelSpec({"stage": TPAR.AxisSpec(3, "q4@depth<1;q8")})
    j = JPAR.ParallelSpec({"stage": JPAR.AxisSpec(3, "q4@depth<1;q8")})
    tp, jp = t.stage_policy(), j.stage_policy()
    assert isinstance(tp, TP.PolicyRules)
    assert (tp.name, tp.num_stages) == (jp.name, jp.num_stages)
    assert _plan(tp.resolve(98304)) == _plan(jp.resolve(98304))
    for P, S, spec in ((TP, TS, t), (JP, JS, j)):
        with pytest.raises(ValueError, match="unresolved rule spec"):
            S._resolve_parallel("api", spec, P.NO_POLICY, "simulated", {})
    # a rule-coded tensor axis of size 2 resolves as the reference's, on
    # either side of its threshold
    for size in (2047, 2048):
        got, want = (M.ParallelSpec({"tensor": M.AxisSpec(
            2, "q4@size>=2048;q8")}).resolved({"tensor": size})
            for M in (TPAR, JPAR))
        assert got.name == want.name == \
            f"tensor=2({'q4' if size >= 2048 else 'q8'})"
    for bad in ("q4@size>=1e8;q8", "q4@size>1"):
        with pytest.raises(ValueError) as want:
            JPAR.AxisSpec(2, bad)
        with pytest.raises(ValueError) as got:
            TPAR.AxisSpec(2, bad)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# a per-cut rule policy in the training steps
# ---------------------------------------------------------------------------

LM_RULES = "topk:0.1@depth<1,dir=fw;q4@dir=bw;q8"
B, S = 4, 32
LOSS_ATOL, GRAD_RTOL = 0.05, 0.3


@pytest.fixture
def pallas_reference():
    prev = JCC.KERNEL_BACKEND
    JCC.KERNEL_BACKEND = "pallas"
    yield
    JCC.KERNEL_BACKEND = prev


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


def test_lm_rule_policy_resolves_per_cut():
    for P in (TP, JP):
        pol = P.parse_policy_rules(LM_RULES).resolve(S * 256)
        assert [(pol.at(i).fw.kind, pol.at(i).fw.k_frac, pol.at(i).fw.bits)
                for i in range(3)] == \
            [("topk", 0.1, 8), ("quant", 1.0, 8), ("quant", 1.0, 8)]
        assert [(pol.at(i).bw.kind, pol.at(i).bw.bits)
                for i in range(3)] == [("quant", 4)] * 3
        assert len(pol.overrides) == 3


def test_lm_step_under_a_per_cut_rule_policy(monkeypatch, pallas_reference):
    jcfg = dataclasses.replace(jget("gpt2-small", smoke=True), num_layers=4)
    tcfg = dataclasses.replace(tget("gpt2-small", smoke=True), num_layers=4)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    grads_out = lambda opt, p, g, s, **kw: (g, s)  # noqa: E731
    monkeypatch.setattr(JS, "apply_updates", grads_out)
    monkeypatch.setattr(TS, "apply_updates", grads_out)
    kw = dict(kind="adamw", lr=1e-3, weight_decay=0.01, schedule="cosine",
              t_max=5, grad_clip=1.0)
    jopt, topt = JO.OptimizerConfig(**kw), TO.OptimizerConfig(**kw)
    toks = np.random.RandomState(1).randint(0, jcfg.vocab_size, (B, S))
    feat = S * jcfg.d_model
    jrules = JP.parse_policy_rules(LM_RULES)
    trules = TP.parse_policy_rules(LM_RULES)
    jpol, tpol = jrules.resolve(feat), trules.resolve(feat)
    assert _plan(tpol) == _plan(jpol)
    jst = [jinit(jpol.at(i), (S, jcfg.d_model), batch=B, dtype=jnp.bfloat16)
           for i in range(3)]
    tst = [tinit(tpol.at(i), (S, tcfg.d_model), batch=B,
                 dtype=torch.bfloat16) for i in range(3)]
    jg, _, _, jm = JS.make_lm_train_step(
        jcfg, jrules, jopt, donate=False, boundary_feat=feat)(
        jp, JO.init_opt_state(jopt, jp), jst,
        {"tokens": jnp.asarray(toks, jnp.int32)}, jnp.arange(B))
    tg, _, _, tm = TS.make_lm_train_step(
        tcfg, trules, topt, boundary_feat=feat)(
        tp, TO.init_opt_state(topt, tp), tst,
        {"tokens": torch.from_numpy(toks)}, torch.arange(B))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_ATOL
    jl, tl = dict(_leaves(jg)), dict(_leaves(tg))
    assert sorted(jl) == sorted(tl)
    got = np.concatenate([_f32(tl[n]).ravel() for n in sorted(tl)])
    want = np.concatenate([_f32(jl[n]).ravel() for n in sorted(tl)])
    assert np.linalg.norm(got - want) <= GRAD_RTOL * np.linalg.norm(want)
    with pytest.raises(ValueError, match="boundary_feat"):
        TS.make_lm_train_step(tcfg, trules, topt)


def test_pipeline_takes_a_uniform_rule_policy_only():
    """A rule set that resolves to other codecs per cut is refused on the
    pipeline (one program for every cut), as by the reference; one that
    resolves uniformly runs there."""
    tcfg = dataclasses.replace(tget("gpt2-small", smoke=True), num_layers=4)
    topt = TO.OptimizerConfig(kind="adamw", lr=1e-3)
    jcfg = dataclasses.replace(jget("gpt2-small", smoke=True), num_layers=4)
    jopt = JO.OptimizerConfig(kind="adamw", lr=1e-3)
    mixed = "topk:0.1@depth<1;q8"
    with pytest.raises(ValueError, match="same boundary policy"):
        TS.make_lm_train_step(tcfg, TP.parse_policy_rules(mixed), topt,
                              transport="pipeline", boundary_feat=S * 256)
    with pytest.raises(ValueError, match="same boundary policy"):
        JS.make_lm_train_step(jcfg, JP.parse_policy_rules(mixed), jopt,
                              transport="pipeline", boundary_feat=S * 256)
    import repro_torch.models.transformer as TT
    tp = TT.init_params(torch.Generator().manual_seed(0), tcfg)
    step = TS.make_lm_train_step(
        tcfg, TP.parse_policy_rules("q4@size>=4096;q8", 2), topt,
        transport="pipeline", pipeline_microbatches=2, boundary_feat=S * 256)
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, tcfg.vocab_size, (B, S)))
    _, _, _, m = step(tp, TO.init_opt_state(topt, tp), [], {"tokens": toks},
                      torch.arange(B))
    assert np.isfinite(float(m["loss"]))
    # q4 forward at the one cut: 2 hops of (2, S*256) q4 payloads
    assert m["wire"]["fw_bytes"] == 2 * (2 * S * 256 // 2 + 8)


CNN_RULES = "topk:0.1@size>=8192;q4@size>=4096;q8"


def test_run_cnn_experiment_under_a_per_cut_rule_policy(pallas_reference):
    data = dict(num_train=64, num_test=32)
    jp = JC.init_params(jax.random.PRNGKey(0), width=8)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    kw = dict(epochs=1, batch=16, width=8)
    want = JL.run_cnn_experiment(JP.parse_policy_rules(CNN_RULES),
                                 data=JData(**data), warmup_params=jp, **kw)
    got = TL.run_cnn_experiment(TP.parse_policy_rules(CNN_RULES),
                                data=TData(**data), warmup_params=tp,
                                device="cpu", **kw)
    pol = TP.resolve_policy(TP.parse_policy_rules(CNN_RULES),
                            [8192, 4096, 2048])
    assert [(pol.at(i).fw.kind, pol.at(i).fw.bits) for i in range(3)] == \
        [("topk", 8), ("quant", 4), ("quant", 8)]
    assert got.name == want.name and got.policy_curve == want.policy_curve
    assert got.acc_on == want.acc_on and got.acc_off == want.acc_off
    assert abs(got.loss_on - want.loss_on) <= LOSS_ATOL
    assert abs(got.loss_off - want.loss_off) <= LOSS_ATOL
    assert np.abs(np.subtract(got.train_curve, want.train_curve)).max() \
        <= 2 / data["num_train"], (got.train_curve, want.train_curve)
