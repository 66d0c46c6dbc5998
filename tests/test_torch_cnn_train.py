"""The port's CNN train and eval steps, its experiment loop and
``pretrain_lm`` against the JAX package, on the same numpy inputs.

Model: the GroupNorm ResNet at width 8, reference params carried over
through numpy; data from ``ImageClassData`` (64 train, 32 test), batch
16; the loop's default SGD (lr 0.02, momentum 0.9, wd 5e-4, cosine).  The
reference runs with ``KERNEL_BACKEND = "pallas"`` (interpret mode), its
steps under ``jax.jit`` as it builds them.

Each of 3 simulated steps (4 under AQ-SGD, the last on a batch of
epoch 1 that revisits examples, so its buffer is read where it is not
zero) starts from the reference's params, optimizer state and feedback
buffers of the step before, so every step's
arithmetic is held on its own: a compressed trajectory drifts by design
(a one-ulp difference at a cut moves a code or swaps a TopK entry, and
the jitted reference scales its codes by ``span * f32(1/levels)``).
Bounds (measured on the CPU, then given headroom):
  * ``none``: step-1 loss within ``LOSS_ATOL`` = 1e-5 and every gradient
    leaf within ``GRAD_RTOL`` = 1e-4 of its largest magnitude (measured
    2.4e-7 and 2.6e-6); over 3 steps, losses within ``LOSS_ATOL``, every
    updated parameter within ``PARAM_ATOL`` = 1e-5 absolute (measured
    8.2e-7);
  * q4q8, top10, AQ-SGD, EF21: losses within ``C_LOSS_ATOL`` = 1e-3
    (measured at most 6.5e-5, q4q8), updated params within
    ``C_PARAM_ATOL`` = 1e-3 absolute (measured 7.2e-5), feedback buffers
    within ``BUF_RTOL`` = 1e-3 of their norm (measured 1.6e-4, EF21);
    AQ-SGD's revisit step (13 of its 16 examples seen before): loss
    2.4e-7, params bitwise, buffers 1.5e-7 of their norm;
  * ``make_cnn_eval_step``, compression on and off: accuracy equal, loss
    within ``LOSS_ATOL`` (top10) or ``C_LOSS_ATOL`` (q4q8);
  * ``run_cnn_experiment`` (1 epoch, 4 steps, from the reference's
    params as ``warmup_params``): accuracy with compression on and off
    equal.  The 4 steps are not re-synced, so a trajectory may drift as
    described above: under EF21 it does not (measured 1.2e-7), and its
    eval losses are held to ``C_LOSS_ATOL`` and its train curve
    (accuracies) exactly; under top10 the eval losses are held to
    ``RUN_LOSS_ATOL`` = 0.05, the compressed-curve bound of
    tests/test_torch_train_curves.py (measured 0.031 on, 3e-4 off), and
    the train curve to two examples in 64 (measured one);
  * the pipeline CNN step (2 stages, 2 microbatches of 4, in a subprocess
    as tests/test_torch_pipeline.py runs its reference): see
    ``test_pipeline_cnn_step_matches_reference``; ``run_cnn_experiment``
    through the pipeline (q4q8, 1f1b, 1 epoch from the reference's
    params): accuracy on and off and the train curve equal, eval losses
    within ``C_LOSS_ATOL`` (measured 2.3e-5);
  * the first 4 uncompressed steps at width 32, batch 100, not
    re-synced: see ``test_wide_steps_match_reference``;
  * ``pretrain_lm`` (3 AdamW steps of the smoke LM, bf16): the last loss
    within 2e-3, the bound of tests/test_torch_train.py.
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

import repro.core.compressors as JCC
import repro.models.cnn as JC
import repro.models.transformer as JT
import repro.train.steps as JS
from repro.configs.registry import get as jget
from repro.core import policy as JP
from repro.data.synthetic import ImageClassData as JData
from repro.data.synthetic import LMData as JLMData
from repro.optim import optimizers as JO
from repro.train import loop as JL

import repro_torch.models.cnn as TC
import repro_torch.models.transformer as TT
import repro_torch.train.steps as TS
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.registry import get as tget
from repro_torch.core import policy as TP
from repro_torch.data.synthetic import ImageClassData as TData
from repro_torch.data.synthetic import LMData as TLMData
from repro_torch.optim import optimizers as TO
from repro_torch.train import loop as TL

from test_torch_pipeline import _real_slots

# One intra-op thread: the suite runs in several worker processes at
# once, and a torch thread pool per worker that outnumbers the cores
# slows its CPU ops by an order of magnitude.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_ATOL = 1e-5
C_LOSS_ATOL = 1e-3
C_PARAM_ATOL = 1e-3
BUF_RTOL = 1e-3
RUN_LOSS_ATOL = 0.05
PIPE_GRAD_RTOL = 2e-4
WIDTH, B = 8, 16
DATA = dict(num_train=64, num_test=32)
WIDE, WIDE_STEPS, WIDE_LOSS_RTOL = 32, 4, 1e-3


def _policy(P, name, num_stages=4):
    bp = {"none": P.NO_COMPRESSION, "q4q8": P.quant_policy(4, 8),
          "top10": P.topk_policy(0.1), "aqsgd": P.aqsgd_policy(0.1),
          "ef21": P.ef_policy(0.1, "ef21")}[name]
    return P.CompressionPolicy(num_stages=num_stages, boundary=bp)


def _opt(O, t_max=4):
    return O.OptimizerConfig(kind="sgd", lr=0.02, momentum=0.9,
                             weight_decay=5e-4, schedule="cosine",
                             t_max=t_max)


def _revisit(data, batch, steps):
    """The first ``steps`` batches of epoch 0, then the first batch of a
    later epoch that holds an id of theirs, and those ids: AQ-SGD reads
    the buffer it stored for an example only when the example comes
    again."""
    first = [b for _, b in zip(range(steps), data.epoch(batch, 0))]
    seen = np.concatenate([ids for _, _, ids in first])
    for ep in range(1, 100):
        for b in data.epoch(batch, ep):
            again = b[2][np.isin(b[2], seen)]
            if again.size:
                return first + [b], again
    raise AssertionError("no batch revisits an example")


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-12))


@pytest.fixture(scope="module")
def model():
    jp = JC.init_params(jax.random.PRNGKey(0), width=WIDTH)
    return jp, _to_port(jp)


@pytest.fixture(scope="module")
def data():
    return JData(**DATA), TData(**DATA)


@pytest.fixture
def pallas_reference():
    prev = JCC.KERNEL_BACKEND
    JCC.KERNEL_BACKEND = "pallas"
    yield
    JCC.KERNEL_BACKEND = prev


def test_train_step_gradients_match_reference(model, data, monkeypatch):
    """One uncompressed step with the optimizer swapped for one that hands
    back the gradients as the new params."""
    jp, tp = model
    grads_out = lambda opt, params, grads, state, **kw: (grads, state)  # noqa
    monkeypatch.setattr(JS, "apply_updates", grads_out)
    monkeypatch.setattr(TS, "apply_updates", grads_out)
    x, y, ids = next(data[0].epoch(B, 0))
    jg, _, _, jm = JS.make_cnn_train_step(_policy(JP, "none"), _opt(JO))(
        jp, JO.init_opt_state(_opt(JO), jp), [], jnp.asarray(x),
        jnp.asarray(y), jnp.asarray(ids))
    tg, _, st, tm = TS.make_cnn_train_step(_policy(TP, "none"), _opt(TO))(
        tp, TO.init_opt_state(_opt(TO), tp), [], torch.from_numpy(x),
        torch.from_numpy(y), torch.from_numpy(ids))
    assert st == []
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_ATOL
    assert float(tm["acc"]) == float(jm["acc"])
    jl, tl = jax.tree.leaves(jg), TO.tree_leaves(tg)
    assert len(jl) == len(tl) == 56
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert np.abs(_np(b) - a).max() <= GRAD_RTOL * np.abs(a).max()


@pytest.mark.parametrize("name", ["none", "q4q8", "top10", "aqsgd", "ef21"])
def test_train_steps_match_reference(model, data, name, pallas_reference):
    jp, _ = model
    jd, td = data
    loss_tol, param_tol = ((LOSS_ATOL, PARAM_ATOL) if name == "none"
                           else (C_LOSS_ATOL, C_PARAM_ATOL))
    jstep = JS.make_cnn_train_step(_policy(JP, name), _opt(JO))
    tstep = TS.make_cnn_train_step(_policy(TP, name), _opt(TO))
    jst = JL._cnn_bstates(_policy(JP, name), jd, B, WIDTH)
    tst0 = TL._cnn_bstates(_policy(TP, name), td, B, WIDTH, "cpu")
    assert len(jst) == len(tst0) == 3
    params, opt_state = jp, JO.init_opt_state(_opt(JO), jp)
    # AQ-SGD takes a fourth step whose batch revisits examples, so that
    # its delta against a stored (non-zero) buffer is held too
    batches, again = _revisit(jd, B, 3)
    for i, (x, y, ids) in enumerate(batches if name == "aqsgd"
                                    else batches[:3]):
        if i == 3:
            assert all(np.abs(np.asarray(s["fw"].resid)[again]).max(
                axis=(1, 2, 3)).all() for s in jst)
        tp, to, tst = _to_port(params), _to_port(opt_state), _to_port(jst)
        for a, b in zip(tst, tst0, strict=True):
            for d in ("fw", "bw"):
                for slot in ("resid", "mirror"):
                    u, v = getattr(a[d], slot), getattr(b[d], slot)
                    assert u.shape == v.shape and u.dtype == v.dtype
        params, opt_state, jst, jm = jstep(
            params, opt_state, jst, jnp.asarray(x), jnp.asarray(y),
            jnp.asarray(ids))
        tp, to, tst, tm = tstep(tp, to, tst, torch.from_numpy(x),
                                torch.from_numpy(y), torch.from_numpy(ids))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= loss_tol, i
        for a, b in zip(jax.tree.leaves(params), TO.tree_leaves(tp)):
            assert np.abs(_np(b) - np.asarray(a)).max() <= param_tol, i
        assert int(to["step"]) == int(opt_state["step"]) == i + 1
        for js, ts in zip(jst, tst, strict=True):
            for d in ("fw", "bw"):
                for slot in ("resid", "mirror"):
                    want = np.asarray(getattr(js[d], slot))
                    got = _np(getattr(ts[d], slot))
                    assert got.shape == want.shape, (d, slot)
                    if want.size:
                        assert _rel(got, want) <= BUF_RTOL, (i, d, slot)


def test_wide_steps_match_reference(capsys):
    """The first 4 uncompressed steps at width 32, batch 100, on
    ``ImageClassData()`` under ``run_cnn_experiment``'s default SGD over 8
    epochs: ``chip_smoke.py``'s CNN phase at half its width.  Not re-synced
    (an uncompressed trajectory does not drift by design): each loss
    within ``WIDE_LOSS_RTOL`` = 1e-3 of the reference's (measured 9.4e-5,
    step 3: summation order compounds over steps whose loss rises).
    Prints both curves; this SGD raises the loss over these steps in
    both."""
    jp = JC.init_params(jax.random.PRNGKey(0), width=WIDE)
    tp = _to_port(jp)
    opt = TL.cnn_sgd(8, 2000, 100)
    assert opt == _opt(TO, t_max=160)
    jopt = _opt(JO, t_max=160)
    jstep = JS.make_cnn_train_step(_policy(JP, "none"), jopt)
    tstep = TS.make_cnn_train_step(_policy(TP, "none"), opt)
    jo, to = JO.init_opt_state(jopt, jp), TO.init_opt_state(opt, tp)
    jd, td = JData(), TData()
    want, got = [], []
    for (x, y, ids), _ in zip(jd.epoch(100, 0), range(WIDE_STEPS)):
        jp, jo, _, jm = jstep(jp, jo, [], jnp.asarray(x), jnp.asarray(y),
                              jnp.asarray(ids))
        tp, to, _, tm = tstep(tp, to, [], torch.from_numpy(x),
                              torch.from_numpy(y), torch.from_numpy(ids))
        want.append(float(jm["loss"]))
        got.append(float(tm["loss"]))
    with capsys.disabled():
        print(f"\nwidth {WIDE}, batch 100, {WIDE_STEPS} steps, losses: "
              f"reference {want}, port {got}")
    for a, b in zip(got, want):
        assert abs(a - b) <= WIDE_LOSS_RTOL * abs(b), (got, want)


@pytest.mark.parametrize("name", ["q4q8", "top10"])
def test_eval_step_matches_reference(model, data, name, pallas_reference):
    jp, tp = model
    x, y, _ = next(data[0].test_batches(B))
    tol = LOSS_ATOL if name == "top10" else C_LOSS_ATOL
    for compress in (True, False):
        ja, jl = JS.make_cnn_eval_step(_policy(JP, name), compress)(
            jp, jnp.asarray(x), jnp.asarray(y))
        ta, tl = TS.make_cnn_eval_step(_policy(TP, name), compress)(
            tp, torch.from_numpy(x), torch.from_numpy(y))
        assert float(ta) == float(ja)
        assert abs(float(tl) - float(jl)) <= tol, (compress, tl, jl)


@pytest.mark.parametrize("name", ["ef21", "top10"])
def test_run_cnn_experiment_matches_reference(model, name, pallas_reference):
    jp, tp = model
    kw = dict(epochs=1, batch=B, width=WIDTH, name=name)
    want = JL.run_cnn_experiment(_policy(JP, name), data=JData(**DATA),
                                 warmup_params=jp, **kw)
    got = TL.run_cnn_experiment(_policy(TP, name), data=TData(**DATA),
                                warmup_params=tp, device="cpu", **kw)
    assert got.acc_on == want.acc_on and got.acc_off == want.acc_off
    assert got.row() == want.row()
    loss_tol = C_LOSS_ATOL if name == "ef21" else RUN_LOSS_ATOL
    assert abs(got.loss_on - want.loss_on) <= loss_tol
    assert abs(got.loss_off - want.loss_off) <= loss_tol
    curve_tol = 0.0 if name == "ef21" else 2 / DATA["num_train"]
    assert np.abs(np.subtract(got.train_curve, want.train_curve)).max() \
        <= curve_tol, (got.train_curve, want.train_curve)
    assert len(TO.tree_leaves(got.params)) == 56


def test_run_cnn_experiment_refuses_what_is_not_ported():
    with pytest.raises(ValueError, match="warmup_params"):
        TL.run_cnn_experiment(_policy(TP, "q4q8"), transport="pipeline",
                              warmup_params={}, device="cpu")
    with pytest.raises(ValueError, match="boundary_feat"):
        TS.make_cnn_train_step(TP.parse_policy_rules("q8"), _opt(TO))
    with pytest.raises(ValueError, match="transport"):
        TL.run_cnn_experiment(_policy(TP, "q4q8"), transport="ring",
                              device="cpu")


# ---------------------------------------------------------------------------
# the pipeline CNN step, against the reference in a subprocess
# ---------------------------------------------------------------------------

# name -> (policy, schedule)
PIPE = {"q4q8_gpipe": ("q4q8", "gpipe"), "q4q8_1f1b": ("q4q8", "1f1b"),
        "top10_gpipe": ("top10", "gpipe"), "top10_1f1b": ("top10", "1f1b"),
        "aqsgd_gpipe": ("aqsgd", "gpipe")}
PIPE_B, PIPE_MB, PIPE_S = 8, 2, 2

REFERENCE = r'''
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
import repro.core.compressors as JC
JC.KERNEL_BACKEND = "pallas"
import repro.models.cnn as CNN
import repro.train.steps as JS
from repro.core import policy as JP
from repro.data.synthetic import ImageClassData
from repro.optim import optimizers as JO
from repro.train.loop import _pipeline_bstates, run_cnn_experiment
sys.path.insert(0, sys.argv[2])
import test_torch_cnn_train as T

out = {}
mesh = Mesh(np.array(jax.devices()[:T.PIPE_S]), ("stage",))
params = CNN.init_pipeline_params(jax.random.PRNGKey(2), T.PIPE_S,
                                  width=T.WIDTH)
for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
    out["params/" + "/".join(p.key for p in path)] = np.asarray(leaf)
data = ImageClassData(**T.DATA)
batches, _ = T._revisit(data, T.PIPE_B, 2)
opt = T._opt(JO)
apply_updates = JS.apply_updates
JS.apply_updates = lambda o, p, g, s: (g, s)
for name, (pname, sched) in T.PIPE.items():
    pol = T._policy(JP, pname, T.PIPE_S)
    st = _pipeline_bstates(pol, (32, 32, T.WIDTH), batch=T.PIPE_B,
                           microbatches=T.PIPE_MB,
                           num_samples=data.num_train)
    step = JS.make_cnn_train_step(pol, opt, transport="pipeline", mesh=mesh,
                                  pipeline_microbatches=T.PIPE_MB,
                                  schedule=sched)
    for i, (x, y, ids) in enumerate(batches[:3 if st else 1]):
        g, _, st, m = step(params, JO.init_opt_state(opt, params), st,
                           jnp.asarray(x), jnp.asarray(y), jnp.asarray(ids))
        p = f"{name}/{i}"
        out[f"{p}/loss"] = np.float32(m["loss"])
        out[f"{p}/acc"] = np.float32(m["acc"])
        for path, leaf in jax.tree_util.tree_flatten_with_path(g)[0]:
            key = "/".join(p_.key for p_ in path)
            out[f"{p}/grad/{key}"] = np.asarray(leaf)
        if st:
            for d in ("fw", "bw"):
                out[f"{p}/{d}_resid"] = np.asarray(st[d].resid)
                out[f"{p}/{d}_mirror"] = np.asarray(st[d].mirror)
JS.apply_updates = apply_updates
res = run_cnn_experiment(T._policy(JP, "q4q8", T.PIPE_S), epochs=1,
                         batch=T.PIPE_B, width=T.WIDTH,
                         data=ImageClassData(**T.DATA), transport="pipeline",
                         mesh=mesh, pipeline_microbatches=T.PIPE_MB,
                         schedule="1f1b", seed=2)
out["run"] = np.array(json.dumps({
    "acc_on": res.acc_on, "acc_off": res.acc_off, "loss_on": res.loss_on,
    "loss_off": res.loss_off, "curve": res.train_curve}))
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
'''


@pytest.fixture(scope="module")
def pipe_ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("cnn_pipeline_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(path), str(ROOT / "tests")],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and "REFERENCE_OK" in proc.stdout, \
        proc.stderr[-3000:]
    return dict(np.load(path))


def _pipe_params(ref):
    flat = {k[len("params/"):]: v for k, v in ref.items()
            if k.startswith("params/")}
    like = TC.init_pipeline_params(torch.Generator().manual_seed(0),
                                   PIPE_S, width=WIDTH)

    def fill(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: fill(v, f"{prefix}{k}/") for k, v in tree.items()}
        return torch.from_numpy(flat[prefix[:-1]].copy())
    return fill(like)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


@pytest.mark.parametrize("name", list(PIPE))
def test_pipeline_cnn_step_matches_reference(name, pipe_ref, monkeypatch):
    """The gradient of one pipeline step (three under AQ-SGD, the third on
    a batch of epoch 1 that revisits examples of the first two, so it
    reads the buffers they wrote), the optimizer swapped for one that hands
    back the gradients.  Loss within ``C_LOSS_ATOL`` and accuracy equal;
    the gradient tree within ``PIPE_GRAD_RTOL`` = 2e-4 of its norm and the
    buffers within ``BUF_RTOL`` of theirs (measured: loss 4.8e-7, the
    gradient 2.0e-5 (q4q8, where the jitted reference's q8/q4 codes may
    sit one step off the port's), the buffers bitwise).  The two fw buffer slots
    that no real cut uses (the reference's masked wrap-around hop writes
    them) are skipped, and the port must leave them zero.  1f1b's framed hops equal
    gpipe's in the port bitwise."""
    pname, sched = PIPE[name]
    params = _pipe_params(pipe_ref)
    monkeypatch.setattr(TS, "apply_updates", lambda o, p, g, s, **kw: (g, s))
    pol = _policy(TP, pname, PIPE_S)
    data = TData(**DATA)
    st = TL._pipeline_bstates(pol, (32, 32, WIDTH), batch=PIPE_B,
                              microbatches=PIPE_MB,
                              num_samples=data.num_train)
    step = TS.make_cnn_train_step(pol, _opt(TO), transport="pipeline",
                                  pipeline_microbatches=PIPE_MB,
                                  schedule=sched)
    batches, again = _revisit(data, PIPE_B, 2)
    for i, (x, y, ids) in enumerate(batches[:3 if st else 1]):
        if i == 2:
            assert (st["fw"].resid[:, torch.from_numpy(again)].abs()
                    .amax(dim=(0, 2, 3, 4)) > 0).all()
        g, _, st, m = step(params, TO.init_opt_state(_opt(TO), params), st,
                           torch.from_numpy(x), torch.from_numpy(y),
                           torch.from_numpy(ids))
        p = f"{name}/{i}"
        assert abs(float(m["loss"]) - float(pipe_ref[f"{p}/loss"])) \
            <= C_LOSS_ATOL
        assert float(m["acc"]) == float(pipe_ref[f"{p}/acc"])
        got = np.concatenate([_np(v).ravel() for _, v in _leaves(g)])
        want = np.concatenate([pipe_ref[f"{p}/grad/{k}"].ravel()
                               for k, _ in _leaves(g)])
        assert _rel(got, want) <= PIPE_GRAD_RTOL, (p, _rel(got, want))
        hops = PIPE_MB * (PIPE_S - 1)
        assert m["wire"]["fw_hops"] == m["wire"]["bw_hops"] == hops
        if st:
            for d in ("fw", "bw"):
                for slot in ("resid", "mirror"):
                    got_b = _np(getattr(st[d], slot))
                    want_b = pipe_ref[f"{p}/{d}_{slot}"]
                    assert got_b.shape == want_b.shape
                    if not want_b.size:
                        continue
                    if d == "fw":
                        got_b, unused = _real_slots(got_b, PIPE_S, 1,
                                                    slot == "mirror")
                        want_b, _ = _real_slots(want_b, PIPE_S, 1,
                                                slot == "mirror")
                        assert not unused.any(), (p, d, slot)
                    if np.abs(want_b).max():
                        assert _rel(got_b, want_b) <= BUF_RTOL, (p, d, slot)


def test_pipeline_run_cnn_experiment_matches_reference(pipe_ref,
                                                       monkeypatch):
    want = json.loads(str(pipe_ref["run"]))
    params = _pipe_params(pipe_ref)
    monkeypatch.setattr(TC, "init_pipeline_params", lambda *a, **k: params)
    got = TL.run_cnn_experiment(_policy(TP, "q4q8", PIPE_S), epochs=1,
                                batch=PIPE_B, width=WIDTH,
                                data=TData(**DATA), transport="pipeline",
                                pipeline_microbatches=PIPE_MB,
                                schedule="1f1b", seed=2, device="cpu")
    assert got.acc_on == want["acc_on"] and got.acc_off == want["acc_off"]
    assert abs(got.loss_on - want["loss_on"]) <= C_LOSS_ATOL
    assert abs(got.loss_off - want["loss_off"]) <= C_LOSS_ATOL
    assert got.train_curve == want["curve"]


# ---------------------------------------------------------------------------
# pretrain_lm
# ---------------------------------------------------------------------------

def test_pretrain_lm_matches_reference(monkeypatch):
    jcfg = dataclasses.replace(jget("gpt2-small", smoke=True), num_layers=4)
    tcfg = dataclasses.replace(tget("gpt2-small", smoke=True), num_layers=4)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    monkeypatch.setattr(TT, "init_params",
                        lambda gen, cfg: _to_port(jp))
    kw = dict(num_train=16, num_test=8, seq_len=32, vocab=256, seed=1)
    _, want = JL.pretrain_lm(jcfg, steps=3, batch=4, data=JLMData(**kw))
    params, got = TL.pretrain_lm(tcfg, steps=3, batch=4, data=TLMData(**kw),
                                 device="cpu")
    assert np.isfinite(got) and abs(got - want) <= 2e-3, (got, want)
    assert sorted(k for k, _ in _leaves(params)) == \
        sorted(k for k, _ in _leaves(jax.tree.map(np.asarray, jp)))
