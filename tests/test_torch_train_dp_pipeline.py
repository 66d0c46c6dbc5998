"""The port's pipeline x DP training step (the ``(data, stage)`` grid)
and its stage-column-sharded gradient reduce against the JAX package's.

The reference runs in ONE module-scoped subprocess with 4 forced host
devices and an Auto-axis 2 x 2 ``Mesh(devices.reshape(2, 2), ("data",
"stage"))`` passed as ``mesh=``, everything under ``jax.jit`` with
``KERNEL_BACKEND = "pallas"`` (the port's cut compressor is the
accelerator's per-tile / block-TopK function):

  * the shard-axis reduce alone, ``make_grad_all_reduce(mesh, "data",
    codec, feedback=..., shard_axis="stage")``, on per-replica stack
    gradients ``(2, 4, 3, 17)`` and ``(2, 2, 33)`` (split into the two
    stage columns), ``(2, 3, 5)`` (3 does not divide 2: stage-replicated)
    and a bf16 ``(2, 4, 9)``, with a nonzero DP state;
  * 3 steps of ``make_lm_train_step(transport="pipeline", parallel=<data
    2 x stage 2>, mesh=mesh)`` on gpt2-small smoke (``num_layers=4`` for
    the interleaved case), batch 8 x 32 (4 a replica, as 2 microbatches
    of 2), the launcher's AdamW (lr 1e-3, weight decay 0.01, cosine over
    the 3 steps, clip 1.0), ids from ``synthetic_stream(dp=2)`` over 16
    samples, so that step 3 revisits step 1's AQ-SGD rows.

Both packages start from the reference's params (carried through numpy).
Bounds:
  * reduce: the port's fused payload of each column is bitwise the
    reference's packing of the same column slices (eager, on its jnp
    codecs, which the reference's jitted packing matches bit for bit,
    tests/test_torch_collectives.py); the ring's bytes are the sum over
    columns of the reference's ``dp_wire_report`` of the column; the
    reduced gradient and the DP state are held by the one-code-step rule
    of tests/test_torch_collectives.py, with each column's own code step
    (its slice's span), TopK bitwise;
  * train, loss: the bounds of tests/test_torch_train_curves.py, each
    step within ``LOSS_ATOL`` = 2e-3 without compression and
    ``CURVE_ATOL`` = 0.05 with it (measured at most 2.7e-4 and 3.0e-3);
  * train, the gradient the optimizer is given (the optimizer is wrapped
    to hand it back; the stack's is the reduced one): without compression
    every leaf within ``REL_TOL`` = 2**-5 of its largest magnitude at
    every step, tests/test_torch_train.py's bound (measured at most
    0.018); with it, the tree within ``GRAD_RTOL`` = 0.3 of its norm,
    tests/test_torch_pipeline.py's bound (measured at most 0.24, EF21
    TopK), at the first step, and at every step where no feedback buffer
    carries the parting forward (measured at most 0.032).  Under TopK
    with EF21 or AQ-SGD the buffers each framework wrote feed its next
    step, and the trees part further (up to 0.51 and 0.34): those steps
    are held by their losses and params;
  * train, params after 3 steps: the tree within ``REL_TOL`` of its norm
    (measured at most 9.2e-3).  Each leaf alone is not held: a
    zero-initialized bias moves by about lr * sign(g) a step, and an
    element whose gradient sits near zero moves the other way;
  * the feedback buffers after every step have the reference's shapes;
    AQ-SGD has written exactly the local rows of the ids each replica
    has seen, and after the first step the buffers are within
    ``BUF_RTOL`` = 0.5 of the reference's norm, the bound of
    tests/test_torch_pipeline.py (measured at most 0.25, EF21's backward
    buffer).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as JT
from repro.configs.registry import get as jget
from repro.launch.train import synthetic_stream as jstream
from repro.transport import codecs as JCODEC
from repro.transport import collectives as JCOL

import repro_torch.train.steps as TS
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.registry import get as tget
from repro_torch.core import parallel as TPAR
from repro_torch.core import policy as TPOL
from repro_torch.launch.train import build_policy
from repro_torch.optim import optimizers as TO
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.train.loop import (_pipeline_bstates, init_lm_dp_state,
                                    run_lm_experiment)
from repro_torch.transport import codecs as TCODEC
from repro_torch.transport import collectives as TCOL
from repro_torch.transport import pipeline as TPIPE

# One intra-op thread: the suite runs in several worker processes at
# once, and a torch thread pool per worker that outnumbers the cores
# slows its CPU ops by an order of magnitude.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LOSS_ATOL = 2e-3
CURVE_ATOL = 0.05
REL_TOL = 2.0 ** -5
GRAD_RTOL = 0.3
BUF_RTOL = 0.5

# -- the reduce alone --------------------------------------------------------
DP, S = 2, 2
SHAPES = {"a": (4, 3, 17), "b": (2, 33), "c": (3, 5), "d": (4, 9)}
BF16 = {"d"}
# name -> (codec, feedback, k_frac)
REDUCE = {
    "none": ("none", "none", 0.1),
    "q8": ("q8", "none", 0.1),
    "q4": ("q4", "none", 0.1),
    "topk": ("topk", "none", 0.1),
    "q8_ef": ("q8", "ef", 0.1),
    "q4_ef21": ("q4", "ef21", 0.1),
}

# -- the train step ----------------------------------------------------------
B, SEQ, MB, NS, STEPS = 8, 32, 2, 16, 3
OPT = dict(kind="adamw", lr=1e-3, weight_decay=0.01, schedule="cosine",
           t_max=STEPS, grad_clip=1.0)
# name -> (launch/train --policy, --feedback, schedule, virtual stages,
#          num_layers, dp codec, dp feedback, dp k_frac)
TRAIN = {
    "none_gpipe": ("none", "none", "gpipe", 1, 2, "none", "none", 0.1),
    "q8_gpipe": ("q8", "none", "gpipe", 1, 2, "q8", "none", 0.1),
    "ef21top10_gpipe": ("none", "ef21", "gpipe", 1, 2, "q4", "ef21", 0.1),
    "aqsgd_1f1b": ("none", "aqsgd", "1f1b", 1, 2, "q8", "ef", 0.1),
    "q8_interleaved": ("q8", "none", "interleaved", 2, 4, "q8", "none",
                       0.1),
}


def reduce_inputs(seed):
    """Per-replica stack gradients (dp, *leaf) and a nonzero DP state,
    float32 numpy, the bf16 leaf already rounded to bf16."""
    rng = np.random.RandomState(seed)
    g, resid, agg = {}, {}, {}
    for k in sorted(SHAPES):
        a = (rng.randn(DP, *SHAPES[k]) * 1.5).astype(np.float32)
        if k in BF16:
            a = np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
        g[k] = a
        resid[k] = (rng.randn(DP, *SHAPES[k]) * 0.2).astype(np.float32)
        agg[k] = (rng.randn(*SHAPES[k]) * 0.5).astype(np.float32)
    return g, resid, agg


def train_inputs(vocab):
    rng = np.random.RandomState(7)
    toks = [rng.randint(0, vocab, (B, SEQ)) for _ in range(STEPS)]
    stream = jstream(jget("gpt2-small", smoke=True), B, SEQ,
                     num_samples=NS, dp=DP)
    ids = [next(stream)[1] for _ in range(STEPS)]
    return toks, ids


REFERENCE = r'''
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
import repro.core.compressors as JC
JC.KERNEL_BACKEND = "pallas"
import repro.train.steps as JS
import repro.models.transformer as JT
from repro.configs.registry import get
from repro.core.parallel import AxisSpec, ParallelSpec
from repro.core.policy import CompressionPolicy, aqsgd_policy, ef_policy
from repro.launch.train import POLICIES
from repro.optim import optimizers as JO
from repro.train.loop import _pipeline_bstates, init_lm_dp_state
from repro.transport.collectives import init_dp_state, make_grad_all_reduce
from repro.transport.pipeline import SCHEME_POLICIES
sys.path.insert(0, sys.argv[2])
import test_torch_train_dp_pipeline as T

out = {}
def save(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "name", p)))
                       for p in path)
        out[f"{prefix}/{key}"] = np.asarray(jnp.asarray(leaf, jnp.float32))

mesh = Mesh(np.array(jax.devices()[:4]).reshape(T.DP, T.S),
            ("data", "stage"))
for seed, (name, (codec, fb, k)) in enumerate(T.REDUCE.items()):
    red = jax.jit(make_grad_all_reduce(mesh, "data", codec, k_frac=k,
                                       feedback=fb, shard_axis="stage"))
    like = {n: jax.ShapeDtypeStruct(s, jnp.float32)
            for n, s in T.SHAPES.items()}
    st = init_dp_state(like, T.DP, fb)
    g, resid, agg = T.reduce_inputs(seed)
    if fb != "none":
        st = st.replace(resid={n: jnp.asarray(v) for n, v in resid.items()})
    if fb == "ef21":
        st = st.replace(agg={n: jnp.asarray(v) for n, v in agg.items()})
    r, nst = red({n: jnp.asarray(v, jnp.bfloat16 if n in T.BF16
                                 else jnp.float32)
                  for n, v in g.items()}, st)
    save(f"reduce/{name}/red", r)
    if fb != "none":
        save(f"reduce/{name}/resid", nst.resid)
    if fb == "ef21":
        save(f"reduce/{name}/agg", nst.agg)

# the optimizer also hands back the gradient it was given (in the opt
# state, which the caller strips before the next step)
def updates_and_grads(opt, p, g, s):
    p, s = JO.apply_updates(opt, p, g, s)
    return p, {"state": s, "grad": g}
JS.apply_updates = updates_and_grads
opt = JO.OptimizerConfig(**T.OPT)
for name, (pname, feedback, sched, v, layers, codec, dfb, k) in \
        T.TRAIN.items():
    cfg = dataclasses.replace(get("gpt2-small", smoke=True),
                              num_layers=layers)
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    if feedback == "aqsgd":
        bp = aqsgd_policy(0.1)
    elif feedback != "none":
        bp = ef_policy(0.1, feedback)
    elif pname in SCHEME_POLICIES:
        bp = SCHEME_POLICIES[pname](0.1)
    else:
        bp = POLICIES[pname]().boundary
    pol = CompressionPolicy(num_stages=T.S, boundary=bp)
    spec = ParallelSpec({"data": AxisSpec(size=T.DP, codec=codec,
                                          feedback=dfb, k_frac=k),
                         "stage": T.S})
    st = _pipeline_bstates(pol, (T.SEQ, cfg.d_model), batch=T.B,
                           microbatches=T.MB, num_samples=T.NS,
                           dtype=jnp.bfloat16, virtual_stages=v, dp=T.DP)
    dst = init_lm_dp_state(cfg, params, pol, T.DP, dfb,
                           transport="pipeline", virtual_stages=v)
    step = JS.make_lm_train_step(cfg, pol, opt, transport="pipeline",
                                 mesh=mesh, pipeline_microbatches=T.MB,
                                 schedule=sched, virtual_stages=v,
                                 parallel=spec, donate=False)
    toks, ids = T.train_inputs(cfg.vocab_size)
    o = JO.init_opt_state(opt, params)
    p = params
    for i in range(T.STEPS):
        p, o, st, dst, m = step(p, o, st,
                                {"tokens": jnp.asarray(toks[i], jnp.int32)},
                                jnp.asarray(ids[i]), dst)
        save(f"train/{name}/{i}/grad", o["grad"])
        # back through numpy: the outputs carry the mesh's shardings
        p, o, st, dst = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)),
                                     (p, o["state"], st, dst))
        out[f"train/{name}/{i}/loss"] = np.float32(m["loss"])
        for d in ("fw", "bw") if st else ():
            out[f"train/{name}/{i}/{d}_resid"] = np.asarray(
                st[d].resid.astype(jnp.float32))
    save(f"train/{name}/params", p)
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("dp_pipeline_ref") / "ref.npz"
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


def _f32(t):
    return t.detach().float().numpy()


def _rel(got, want):
    got = np.concatenate([np.ravel(a) for a in got]).astype(np.float64)
    want = np.concatenate([np.ravel(a) for a in want]).astype(np.float64)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-12))


def _ulp(a):
    return float(np.spacing(np.float32(max(float(np.abs(a).max()), 1e-30))))


def _columns(a, lead):
    """``a``'s stage-column slices along dim ``lead`` (the whole of ``a``
    for each column where the dim does not divide ``S``)."""
    n = a.shape[lead]
    if n % S:
        return [a] * S
    w = n // S
    idx = [slice(None)] * a.ndim
    out = []
    for c in range(S):
        idx[lead] = slice(c * w, (c + 1) * w)
        out.append(a[tuple(idx)])
    return out


# ---------------------------------------------------------------------------
# the stage-column-sharded reduce
# ---------------------------------------------------------------------------

def _port_reduce(name, monkeypatch):
    codec, fb, k = REDUCE[name]
    seed = list(REDUCE).index(name)
    g, resid, agg = reduce_inputs(seed)
    st = TCOL.init_dp_state({n: torch.zeros(s) for n, s in SHAPES.items()},
                            DP, fb)
    if fb != "none":
        st = st.replace(resid=params_from_numpy(resid, "cpu"))
    if fb == "ef21":
        st = st.replace(agg=params_from_numpy(agg, "cpu"))
    fused = []
    real = TCOL.fuse_payload
    monkeypatch.setattr(TCOL, "fuse_payload",
                        lambda p: fused.append(real(p)) or fused[-1])
    red = TCOL.make_grad_all_reduce(DP, codec, k_frac=k, feedback=fb,
                                    shard_axis=S)
    tg = {n: torch.from_numpy(v.copy()).to(
        torch.bfloat16 if n in BF16 else torch.float32)
        for n, v in g.items()}
    out, nst, wire = red(tg, st)
    return g, resid, agg, out, nst, wire, fused


def _ref_payload(codec, fb, k, g, resid, c, r):
    """The reference's packing of replica ``r``'s slices of column ``c``,
    compensated as its reduce compensates them, fused."""
    jc = JCODEC.get_codec(codec)
    pls = []
    for n in sorted(SHAPES):
        a = _columns(g[n], 1)[c][r]
        if codec != "none":
            a = a.astype(np.float32)
            if fb == "ef":
                a = a + _columns(resid[n], 1)[c][r]
            elif fb == "ef21":
                a = a - _columns(resid[n], 1)[c][r]
        x = jnp.asarray(a, jnp.bfloat16 if (n in BF16 and codec == "none")
                        else jnp.float32)
        pls.append(JCOL.pack_grad_leaf(jc, x, k))
    return pls


def _torch_struct(tree):
    """The port's :class:`LeafStruct` tree of a reference payload tree."""
    def one(a):
        dt = (torch.bfloat16 if a.dtype == jnp.bfloat16 else
              torch.from_numpy(np.zeros(0, np.dtype(a.dtype))).dtype)
        return TCODEC.LeafStruct(tuple(a.shape), dt)
    return jax.tree.map(one, tree)


def _bits(a):
    a = a.float() if a.dtype == torch.bfloat16 else a
    return a.numpy().astype(np.float64)


@pytest.mark.parametrize("name", list(REDUCE))
def test_shard_axis_payloads_are_the_references(name, monkeypatch):
    """Each stage column packs only its own slices: its fused payload is
    bitwise the reference's packing of those slices (TopK: the same
    index/value pairs, the selection's order aside), and the ring counts
    S columns x dp(dp-1) hops of it."""
    import repro.core.compressors as JC
    monkeypatch.setattr(JC, "KERNEL_BACKEND", "jnp")
    codec, fb, k = REDUCE[name]
    g, resid, _, _, _, wire, fused = _port_reduce(name, monkeypatch)
    assert len(fused) == S * DP          # column by column, replica by replica
    for c in range(S):
        for r in range(DP):
            pls = _ref_payload(codec, fb, k, g, resid, c, r)
            got = fused[c * DP + r]
            if codec != "topk":
                np.testing.assert_array_equal(
                    got.numpy(), np.asarray(JCODEC.fuse_payload(pls)))
                continue
            # TopK: the same (index, value) pairs, in either order
            assert got.numel() == np.asarray(JCODEC.fuse_payload(pls)).size
            back = TCODEC.unfuse_payload(got, _torch_struct(pls))
            for tp, jp in zip(back, pls):
                jidx, jval = np.asarray(jp["idx"]), np.asarray(
                    jp["vals"].astype(jnp.float32))
                tidx, tval = _bits(tp["idx"]), _bits(tp["vals"])
                jo, to = np.argsort(jidx.ravel()), np.argsort(tidx.ravel())
                np.testing.assert_array_equal(tidx.ravel()[to],
                                              jidx.ravel()[jo])
                np.testing.assert_array_equal(tval.ravel()[to],
                                              jval.ravel()[jo])
    col_like = {n: jax.ShapeDtypeStruct(
        _columns(np.zeros(s, np.int8), 0)[0].shape,
        jnp.bfloat16 if n in BF16 else jnp.float32)
        for n, s in SHAPES.items()}
    rep = JCOL.dp_wire_report(col_like, codec, k_frac=k, dp=DP)
    tlike = {n: TCODEC.LeafStruct(s, torch.bfloat16 if n in BF16
                                  else torch.float32)
             for n, s in SHAPES.items()}
    port_rep = TCOL.dp_wire_report(tlike, codec, k_frac=k, dp=DP,
                                   shard_axis=S)
    assert port_rep == dict(rep, columns=S)
    assert wire == {"dp_hops": S * DP * (DP - 1),
                    "dp_bytes": S * DP * rep["wire_bytes_per_reduce"]}


def _step(x, codec):
    levels = 255.0 if codec == "q8" else 15.0
    return (float(x.max()) - float(x.min())) / levels


@pytest.mark.parametrize("name", list(REDUCE))
def test_shard_axis_reduce_matches_reference(name, ref, monkeypatch):
    codec, fb, k = REDUCE[name]
    g, resid, agg, out, nst, _, _ = _port_reduce(name, monkeypatch)
    for n in SHAPES:
        got, want = _f32(out[n]), ref[f"reduce/{name}/red/{n}"]
        assert got.shape == want.shape
        assert out[n].dtype == (torch.bfloat16 if n in BF16
                                else torch.float32)
        if codec in ("none", "topk"):
            np.testing.assert_array_equal(got, want)
            continue
        # one code step of each source, column by column
        for c, (gc, wc) in enumerate(zip(_columns(got, 0),
                                         _columns(want, 0))):
            xs = [_columns(g[n], 1)[c][r] for r in range(DP)]
            if fb == "ef":
                xs = [x + _columns(resid[n], 1)[c][r]
                      for r, x in enumerate(xs)]
            elif fb == "ef21":
                xs = [x - _columns(resid[n], 1)[c][r]
                      for r, x in enumerate(xs)]
            steps = [_step(x, codec) for x in xs]
            tol = sum(steps) * (1 + 1e-5) + 4 * _ulp(wc)
            if n in BF16:
                tol += _ulp(wc) * 2.0 ** 16          # one bf16 ulp
            assert float(np.abs(gc - wc).max()) <= tol, (n, c)
            if fb != "none":
                got_r = _columns(_f32(nst.resid[n]), 1)[c]
                want_r = _columns(ref[f"reduce/{name}/resid/{n}"], 1)[c]
                for r in range(DP):
                    assert float(np.abs(got_r[r] - want_r[r]).max()) <= \
                        steps[r] * (1 + 1e-5) + 4 * _ulp(want_r[r]), (n, c)
            if fb == "ef21":
                got_a = _columns(_f32(nst.agg[n]), 0)[c]
                want_a = _columns(ref[f"reduce/{name}/agg/{n}"], 0)[c]
                assert float(np.abs(got_a - want_a).max()) <= \
                    sum(steps) * (1 + 1e-5) + 4 * _ulp(want_a), (n, c)


def test_shard_axis_refusals():
    with pytest.raises(ValueError, match="positive int"):
        TCOL.make_grad_all_reduce(2, "q8", shard_axis="stage")
    with pytest.raises(ValueError, match="positive int"):
        TCOL.make_grad_all_reduce(2, "q8", shard_axis=0)
    red = TCOL.make_grad_all_reduce(2, "q8", shard_axis=2)
    with pytest.raises(ValueError, match="replica dim"):
        red({"a": torch.zeros((3, 4))}, TCOL.init_dp_state(
            {"a": torch.zeros(4)}, 2))


# ---------------------------------------------------------------------------
# the 2 x 2 train step
# ---------------------------------------------------------------------------

def _policy(pname, feedback):
    """The reference script's policy: the launcher's preset or a wire
    scheme at every cut, replaced by TopK 10% under ``feedback``."""
    if feedback != "none" or pname not in TPIPE.SCHEME_POLICIES:
        pol = build_policy(pname, feedback, 0.1)
        return dataclasses.replace(pol, num_stages=S)
    return TPOL.CompressionPolicy(
        num_stages=S, boundary=TPIPE.SCHEME_POLICIES[pname](0.1))


@pytest.fixture(scope="module")
def models():
    out = {}
    for layers in (2, 4):
        jcfg = dataclasses.replace(jget("gpt2-small", smoke=True),
                                   num_layers=layers)
        tcfg = dataclasses.replace(tget("gpt2-small", smoke=True),
                                   num_layers=layers)
        out[layers] = (tcfg, params_from_numpy(jax.tree.map(
            np.asarray, JT.init_params(jax.random.PRNGKey(0), jcfg)), "cpu"))
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _run_port(name, models, states=None):
    pname, feedback, sched, v, layers, codec, dfb, k = TRAIN[name]
    cfg, params = models[layers]
    pol = _policy(pname, feedback)
    spec = TPAR.ParallelSpec({"data": TPAR.AxisSpec(
        size=DP, codec=codec, feedback=dfb, k_frac=k), "stage": S})
    opt = TO.OptimizerConfig(**OPT)
    st = _pipeline_bstates(pol, (SEQ, cfg.d_model), batch=B,
                           microbatches=MB, num_samples=NS,
                           dtype=torch.bfloat16, virtual_stages=v, dp=DP)
    dst = init_lm_dp_state(cfg, params, pol, DP, dfb, transport="pipeline",
                           virtual_stages=v)
    step = TS.make_lm_train_step(cfg, pol, opt, transport="pipeline",
                                 pipeline_microbatches=MB, schedule=sched,
                                 virtual_stages=v, parallel=spec)
    toks, ids = train_inputs(cfg.vocab_size)
    p, o, losses, wires = params, TO.init_opt_state(opt, params), [], []
    for i in range(STEPS):
        p, o, st, dst, m = step(p, o, st, {"tokens": torch.from_numpy(
            toks[i])}, torch.from_numpy(ids[i]), dst)
        losses.append(float(m["loss"]))
        wires.append(m["wire"])
        if states is not None and st:
            states.append({d: _f32(st[d].resid) for d in ("fw", "bw")})
    return params, p, st, losses, wires, ids


@pytest.mark.parametrize("name", list(TRAIN))
def test_dp_pipeline_steps_match_reference(name, ref, models, monkeypatch):
    pname, feedback, sched, v, layers, codec, dfb, k = TRAIN[name]
    grads = []
    real = TS.apply_updates
    monkeypatch.setattr(TS, "apply_updates", lambda o, p, g, s, **kw: (
        grads.append(g), real(o, p, g, s, **kw))[1])
    states = []
    _, p, st, losses, wires, ids = _run_port(name, models, states)
    exact = (pname, feedback, codec) == ("none", "none", "none")
    for i, loss in enumerate(losses):
        gap = abs(loss - float(ref[f"train/{name}/{i}/loss"]))
        assert gap <= (LOSS_ATOL if exact else CURVE_ATOL), (i, gap)
    # the gradient the optimizer was given: of the global batch, the
    # stack's reduced over the replicas without a 1/dp
    for i, g in enumerate(grads):
        got = dict(_leaves(g))
        want = {n: ref[f"train/{name}/{i}/grad/{n}"] for n in got}
        if exact:
            for n in got:
                assert np.abs(_f32(got[n]) - want[n]).max() <= \
                    REL_TOL * max(np.abs(want[n]).max(), 1e-6), (i, n)
        elif i == 0 or feedback == "none":
            assert _rel([_f32(got[n]) for n in sorted(got)],
                        [want[n] for n in sorted(got)]) <= GRAD_RTOL, i
    got = dict(_leaves(p))
    assert _rel([_f32(got[n]) for n in sorted(got)],
                [ref[f"train/{name}/params/{n}"] for n in sorted(got)]) \
        <= REL_TOL
    # every row's hops, and the ring over the S stage columns
    hops = DP * MB * (S * v - 1)
    assert all(w["fw_hops"] == w["bw_hops"] == hops for w in wires)
    assert all(w["dp_hops"] == S * DP * (DP - 1) for w in wires)
    if not st:
        assert f"train/{name}/0/fw_resid" not in ref
        return
    for i, bufs in enumerate(states):
        for d in ("fw", "bw"):
            got_b, want_b = bufs[d], ref[f"train/{name}/{i}/{d}_resid"]
            assert got_b.shape == want_b.shape, (d, got_b.shape,
                                                 want_b.shape)
            if got_b.size == 0:
                continue
            if d == "fw":
                # the last stage sends nothing: its slot stays zero here,
                # and the reference's masked wrap-around hop writes it
                assert not got_b[:, S - 1].any()
                got_b, want_b = got_b[:, :S - 1], want_b[:, :S - 1]
            if feedback == "aqsgd" and d == "fw":
                # replica r's rows: the local rows of the ids it has seen
                per = NS // DP
                for r in range(DP):
                    seen = sorted({int(j) - r * per for a in ids[:i + 1]
                                   for j in a[r * B // DP:(r + 1) * B // DP]})
                    rows = got_b[r, 0].any(
                        axis=tuple(range(1, got_b.ndim - 2)))
                    assert sorted(np.flatnonzero(rows)) == seen, (i, r)
            if i == 0:
                assert _rel([got_b], [want_b]) <= BUF_RTOL, d


def test_dp_pipeline_keeps_the_callers_params(models):
    cfg, params = models[2]
    pol = _policy("q8", "none")
    spec = TPAR.spec_from_cli("data=2,stage=2", "data=q8")
    opt = TO.OptimizerConfig(**OPT)
    step = TS.make_lm_train_step(cfg, pol, opt, transport="pipeline",
                                 pipeline_microbatches=MB, parallel=spec)
    dst = init_lm_dp_state(cfg, params, pol, DP, transport="pipeline")
    assert [tuple(a.shape) for a in tree_leaves(dst.resid)] == [(DP, 0)]
    toks, ids = train_inputs(cfg.vocab_size)
    new, _, bst, dst2, m = step(params, TO.init_opt_state(opt, params), [],
                                {"tokens": torch.from_numpy(toks[0])},
                                torch.from_numpy(ids[0]), dst)
    assert bst == [] and dst2.mode == "none"
    assert all(not a.requires_grad and a.grad is None
               for a in tree_leaves(params))
    assert [tuple(a.shape) for a in tree_leaves(new)] == \
        [tuple(a.shape) for a in tree_leaves(params)]
    with pytest.raises(ValueError, match="not divisible"):
        step(params, TO.init_opt_state(opt, params), [],
             {"tokens": torch.from_numpy(toks[0][:3])},
             torch.from_numpy(ids[0][:3]), dst)


def test_dp_pipeline_reduce_state_is_the_stack(models):
    """The DP state of the pipeline transport mirrors the stage-stacked
    layer stack, as the reference's ``init_lm_dp_state`` does."""
    from repro.train.loop import init_lm_dp_state as jinit
    from repro.core.policy import CompressionPolicy as JCP
    for v in (1, 2):
        cfg, params = models[4]
        jcfg = dataclasses.replace(jget("gpt2-small", smoke=True),
                                   num_layers=4)
        jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
        want = jinit(jcfg, jp, JCP(num_stages=S), DP, "ef21",
                     transport="pipeline", virtual_stages=v)
        got = init_lm_dp_state(cfg, params, _policy("none", "none"), DP,
                               "ef21", transport="pipeline",
                               virtual_stages=v)
        for slot in ("resid", "agg"):
            assert [tuple(a.shape) for a in tree_leaves(getattr(got, slot))] \
                == [a.shape for a in jax.tree.leaves(getattr(want, slot))]


def test_run_lm_experiment_dp_pipeline():
    from repro_torch.data.synthetic import LMData
    cfg = tget("gpt2-small", smoke=True)
    data = LMData(num_train=8, num_test=8, seq_len=16, vocab=64, seed=0)
    spec = TPAR.spec_from_cli("data=2,stage=2", "data=q4+ef21")
    res = run_lm_experiment(cfg, _policy("none", "ef21"), epochs=1,
                            batch=8, data=data, parallel=spec,
                            pipeline_microbatches=2, schedule="1f1b",
                            device="cpu")
    assert len(res.train_curve) == 1 and np.isfinite(res.train_curve).all()
    assert np.isfinite(res.loss_on) and np.isfinite(res.loss_off)


@pytest.mark.parametrize("argv", [
    ["--mesh", "data=2,stage=2", "--wire", "data=q8,stage=q8"],
    ["--dp", "2", "--dp-codec", "q4", "--transport", "pipeline",
     "--stages", "2", "--schedule", "1f1b"]])
def test_launch_train_dp_pipeline_cpu(argv, models, capsys):
    """The 2D flags run the launcher; its JSON lines carry every row's
    hop bytes and the ring's bytes over the stage columns."""
    import warnings
    from repro_torch.launch import train as ttrain
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", TPAR.ParallelDeprecationWarning)
        assert ttrain.main(["--smoke", "--device", "cpu", "--steps", "1",
                            "--batch", "8", "--seq", "16", *argv]) == 0
    out = capsys.readouterr().out
    assert "# dp=2 gradient all-reduce" in out
    import json
    recs = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert [r["step"] for r in recs] == [1]
    codec = "q8" if "data=q8,stage=q8" in argv else "q4"
    cfg, params = models[2]
    rep = TCOL.dp_wire_report(
        TS.transformer.stack_layer_stages(params, S), codec, dp=DP,
        shard_axis=S)
    assert all(r["dp_bytes"] == S * DP * rep["wire_bytes_per_reduce"]
               and r["fw_bytes"] > 0 and r["bw_bytes"] > 0 for r in recs)
