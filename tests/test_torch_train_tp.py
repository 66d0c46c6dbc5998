"""The port's tensor axis (TP alone, DP x TP, pipeline x TP and the 3D
step) against the JAX package's.

The reference runs in ONE module-scoped subprocess with 8 forced host
devices, every step under ``jax.jit`` on its jnp codecs (the tensor wire
packs per tensor and the stage hops here pack too few rows for the tiled
wire format: the Pallas backend gives the same bits, one run checked),
with Auto-axis meshes passed as ``mesh=`` (``jax.make_mesh``'s Explicit
axes fail under jax 0.9, see ``ROADMAP.md`` §3): ``Mesh(devices[:2],
("tensor",))`` for TP alone and ``Mesh(devices[:n].reshape(dp, stages,
tp), ("data", "stage", "tensor"))`` for the rest.  Each case trains
gpt2-small smoke (2 layers, d 256, 4 heads, 2 KV heads: only tp = 2
divides), or gemma2-27b smoke (``TRAIN_ARCHS``: 2 local/global groups,
window 16, softcaps, post-norm, 4 heads, 2 KV heads) under tp 2 and no
compression, for 3 steps at batch 8 x 32 from the reference's params
(carried through numpy), with the launcher's AdamW (lr 1e-3, weight
decay 0.01, cosine over the 3 steps, clip 1.0); the optimizer is
wrapped in both packages to hand back the gradient it was given.
Bounds:
  * losses: every step within ``LOSS_ATOL`` = 2e-3 with every wire
    uncompressed (tests/test_torch_train_curves.py's 4e-4 over five
    steps is for one device; the TP sum order is the port's own: autograd
    adds the ranks' gradients of a replicated LayerNorm leaf where the
    reference's ``shard_map`` transpose psums them, in f32 either way),
    ``CURVE_ATOL`` = 0.05 with compression (measured at most 2.8e-4 and
    0.011);
  * the step-1 gradient the optimizer is given (both packages start from
    the same params and batch): without compression every leaf within
    ``REL_TOL`` = 2**-5 of its largest magnitude (measured at most
    0.0143); with it the tree and the layer stack alone within
    ``GRAD_RTOL`` = 0.3 of their norms (tests/test_torch_pipeline.py's
    bound; measured at most 0.093).  Under the q4 tensor wire
    (``WITNESSED``) one flipped 4-bit code moves its element by a 15th
    of the tensor's span, and the flips compound over the sites: the
    WITNESS, the reference's own step 1 from its embedding moved one bf16
    ulp away from zero, lies 0.43-0.49 from the reference (0.42-0.47 is
    how far q4 moves the gradient from the uncompressed one), so the port
    is held within the witness's distance, case by case (measured
    0.38-0.45).  At this level a port whose backward collectives skipped
    the codec would pass too (a mutation check read 0.33-0.39):
    tests/test_torch_tp_collectives.py's VJP tests hold the backward
    collectives to the reference's and catch it;
  * ``tp_state`` after step 1: site 0, whose input is the same bits in
    both packages, within ``REL_TOL`` (measured 2e-4 and 0); EF21's
    mirror (the gathered activations) within ``BUF_RTOL`` = 0.5 of the
    reference's norm (tests/test_torch_pipeline.py's bound; measured
    0.17); EF's resid is compression error, which any upstream code flip
    changes elementwise, so each site's norm is held within
    ``NORM_RTOL`` = 0.05 of the reference's (measured at most 0.0053);
    ``dp_state`` (EF21's resid and agg) within ``GRAD_RTOL`` (measured
    0.093);
  * params after 3 steps within ``REL_TOL`` of the reference's norm
    (measured at most 0.0103);
  * wire counts: the ring's ``tp_hops`` / ``tp_bytes`` equal
    ``tp_wire_report``'s (the reference's function) exact bytes x ranks
    x 2 directions (forward, backward) x lanes or rows x microbatches;
    the DP ring's equal the reference's ``dp_wire_report`` of one
    (stage column, tensor coordinate) block x blocks x dp; the stage hops
    the codec's payload of one rank's shard x ranks.
"""
import json
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
import repro.train.steps as JS
from repro.configs.registry import get as jget
from repro.core import parallel as JPAR
from repro.core.policy import CompressionPolicy as JCP
from repro.optim.optimizers import OptimizerConfig as JOC
from repro.launch.train import POLICIES as JPOLICIES
from repro.transport import collectives as JCOL
from repro.transport import tp_collectives as JTP

import repro_torch.train.steps as TS
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.registry import get as tget
from repro_torch.core import parallel as TPAR
from repro_torch.core import policy as TPOL
from repro_torch.data.synthetic import LMData
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as TT
from repro_torch.optim import optimizers as TO
from repro_torch.train.loop import (_pipeline_bstates, init_lm_dp_state,
                                    run_lm_experiment)
from repro_torch.transport import codecs as TCODEC
from repro_torch.transport import collectives as TCOL
from repro_torch.transport import pipeline as TPIPE
from repro_torch.transport import tp_collectives as TTP

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LOSS_ATOL = 2e-3
CURVE_ATOL = 0.05
REL_TOL = 2.0 ** -5
GRAD_RTOL = 0.3
BUF_RTOL = 0.5

B, SEQ, MB, STEPS = 8, 32, 2, 3
OPT = dict(kind="adamw", lr=1e-3, weight_decay=0.01, schedule="cosine",
           t_max=STEPS, grad_clip=1.0)
# name -> ((dp, codec, feedback), (stages, codec), (tp, codec, feedback),
#          schedule)
TRAIN = {
    "t2_none": ((1, "none", "none"), (1, "none"), (2, "none", "none"),
                "gpipe"),
    "t2_q8ef": ((1, "none", "none"), (1, "none"), (2, "q8", "ef"), "gpipe"),
    "t2_q4ef21": ((1, "none", "none"), (1, "none"), (2, "q4", "ef21"),
                  "gpipe"),
    "d2t2_q8": ((2, "q8", "none"), (1, "none"), (2, "q8", "none"), "gpipe"),
    "d2t2_q4ef21": ((2, "q4", "ef21"), (1, "none"), (2, "none", "none"),
                    "gpipe"),
    "s2t2_gpipe": ((1, "none", "none"), (2, "q8"), (2, "q4", "none"),
                   "gpipe"),
    "s2t2_1f1b": ((1, "none", "none"), (2, "q8"), (2, "q4", "none"),
                  "1f1b"),
    "d2s2t2": ((2, "q8", "none"), (2, "q8"), (2, "q4", "none"), "gpipe"),
    "gemma2_t2_none": ((1, "none", "none"), (1, "none"), (2, "none", "none"),
                       "gpipe"),
}
# the cases on another arch's smoke model than gpt2-small's
TRAIN_ARCHS = {"gemma2_t2_none": "gemma2-27b"}
# the tensor codecs whose step-1 gradient is held by the witness
WITNESSED = ("q4",)
# run_lm_experiment's data; a rule-coded tensor wire resolves against the
# cut's 1/tp shard, 16 * 256 / 2 = 2048 elements: q8 here (q4 on the cut)
EXP_DATA = dict(num_train=16, num_test=8, seq_len=16, vocab=64, seed=0)
EXP_RULES = "q4@size>=3000;q8"
NORM_RTOL = 0.05


def spec_of(case, axes=TPAR):
    (dp, dc, dfb), (s, sc), (tp, tc, tfb), _ = TRAIN[case]
    return axes.ParallelSpec({
        "data": axes.AxisSpec(size=dp, codec=dc, feedback=dfb),
        "stage": axes.AxisSpec(size=s, codec=sc),
        "tensor": axes.AxisSpec(size=tp, codec=tc, feedback=tfb)})


def tokens(vocab):
    rng = np.random.RandomState(11)
    return [rng.randint(0, vocab, (B, SEQ)) for _ in range(STEPS)]


REFERENCE = r'''
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
import repro.core.compressors as JC
JC.KERNEL_BACKEND = "jnp"
import repro.train.steps as JS
import repro.models.transformer as JT
from repro.configs.registry import get
from repro.core.parallel import AxisSpec, ParallelSpec
from repro.core.policy import CompressionPolicy
from repro.data.synthetic import LMData
from repro.optim import optimizers as JO
from repro.train.loop import (_pipeline_bstates, init_lm_dp_state,
                              run_lm_experiment)
from repro.transport.tp_collectives import init_tp_state
sys.path.insert(0, sys.argv[2])
import test_torch_train_tp as T

out = {}
def save(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "name", p)))
                       for p in path)
        out[f"{prefix}/{key}"] = np.asarray(jnp.asarray(leaf, jnp.float32))

def updates_and_grads(opt, p, g, s):
    p, s = JO.apply_updates(opt, p, g, s)
    return p, {"state": s, "grad": g}
JS.apply_updates = updates_and_grads
devs = np.array(jax.devices())
opt = JO.OptimizerConfig(**T.OPT)
ids = jnp.arange(T.B, dtype=jnp.int32)
for name, ((dp, _, dfb), (s, _), (tp, tc, tfb), sched) in T.TRAIN.items():
    cfg = get(T.TRAIN_ARCHS.get(name, "gpt2-small"), smoke=True)
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    toks = T.tokens(cfg.vocab_size)
    spec = T.spec_of(name, sys.modules["repro.core.parallel"])
    mesh = (Mesh(devs[:tp], ("tensor",)) if dp == s == 1 else
            Mesh(devs[:dp * s * tp].reshape(dp, s, tp),
                 ("data", "stage", "tensor")))
    step = JS.make_lm_train_step(cfg, CompressionPolicy(num_stages=1), opt,
                                 parallel=spec, mesh=mesh,
                                 pipeline_microbatches=T.MB, schedule=sched,
                                 donate=False)
    def init_extra():
        extra = []
        if dp > 1:
            extra.append(init_lm_dp_state(
                cfg, params, CompressionPolicy(num_stages=s), dp, dfb,
                transport="pipeline" if s > 1 else "simulated", tp=tp))
        if s == 1:
            extra.append(init_tp_state((T.B, T.SEQ, cfg.d_model),
                                       JT.tp_sites(cfg), tfb))
        return extra
    if tc in T.WITNESSED:
        # the witness: step 1 again from the embedding moved one bf16 ulp
        # away from zero
        bits = jax.lax.bitcast_convert_type(params["embed"], jnp.uint16)
        pw = dict(params, embed=jax.lax.bitcast_convert_type(
            bits + jnp.uint16(1), jnp.bfloat16))
        res = step(pw, JO.init_opt_state(opt, pw), [],
                   {"tokens": jnp.asarray(toks[0], jnp.int32)}, ids,
                   *init_extra())
        save(f"train/{name}/witness/grad", res[1]["grad"])
    extra = init_extra()
    p, o = params, JO.init_opt_state(opt, params)
    for i in range(T.STEPS):
        res = step(p, o, [], {"tokens": jnp.asarray(toks[i], jnp.int32)},
                   ids, *extra)
        p, o, extra, m = res[0], res[1], list(res[3:-1]), res[-1]
        save(f"train/{name}/{i}/grad", o["grad"])
        # back through numpy: the outputs carry the mesh's shardings
        p, o, extra = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)),
                                   (p, o["state"], extra))
        out[f"train/{name}/{i}/loss"] = np.float32(m["loss"])
        if i == 0:
            if dp > 1:
                save(f"train/{name}/dp_resid", extra[0].resid)
                save(f"train/{name}/dp_agg", extra[0].agg)
            if s == 1:
                out[f"train/{name}/tp_resid"] = np.asarray(extra[-1].resid)
                out[f"train/{name}/tp_mirror"] = np.asarray(extra[-1].mirror)
    save(f"train/{name}/params", p)

cfg = get("gpt2-small", smoke=True)
params = JT.init_params(jax.random.PRNGKey(0), cfg)
toks = T.tokens(cfg.vocab_size)
# a buffered stage policy with a tensor axis is refused at trace time
try:
    spec = ParallelSpec({"stage": AxisSpec(2, "q8", "ef"), "tensor": 2})
    step = JS.make_lm_train_step(
        cfg, CompressionPolicy(num_stages=1), opt, parallel=spec,
        mesh=Mesh(devs[:4].reshape(1, 2, 2), ("data", "stage", "tensor")),
        pipeline_microbatches=T.MB, donate=False)
    bst = _pipeline_bstates(spec.stage_policy(), (T.SEQ, cfg.d_model),
                            batch=T.B, microbatches=T.MB,
                            dtype=jnp.bfloat16)
    step(params, JO.init_opt_state(opt, params), bst,
         {"tokens": jnp.asarray(toks[0], jnp.int32)}, ids)
    out["refusal/buffered"] = np.array("none")
except Exception as e:
    out["refusal/buffered"] = np.array(type(e).__name__)

JS.apply_updates = JO.apply_updates
res = run_lm_experiment(
    cfg, CompressionPolicy(num_stages=1), pretrained_params=params,
    epochs=1, batch=8, data=LMData(**T.EXP_DATA),
    parallel=ParallelSpec({"tensor": 2}), mesh=Mesh(devs[:2], ("tensor",)))
out["exp/curve"] = np.asarray(res.train_curve, np.float32)
out["exp/policy_curve"] = np.array(res.policy_curve)
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("train_tp_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(path), str(ROOT / "tests")],
        env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0 and "REFERENCE_OK" in proc.stdout, \
        proc.stderr[-3000:]
    return dict(np.load(path))


def _model(arch):
    jcfg = jget(arch, smoke=True)
    return tget(arch, smoke=True), params_from_numpy(jax.tree.map(
        np.asarray, JT.init_params(jax.random.PRNGKey(0), jcfg)), "cpu")


@pytest.fixture(scope="module")
def model():
    return _model("gpt2-small")


@pytest.fixture(scope="module")
def gemma2_model():
    return _model("gemma2-27b")


def _f32(t):
    return t.detach().float().numpy()


def _rel(got, want):
    got = np.concatenate([np.ravel(a) for a in got]).astype(np.float64)
    want = np.concatenate([np.ravel(a) for a in want]).astype(np.float64)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-12))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _run_port(name, model, monkeypatch):
    """3 steps of the case: losses, the gradients the optimizer was given,
    the states after step 1, the final params and each step's wire."""
    (dp, _, dfb), (s, _), (tp, _, tfb), sched = TRAIN[name]
    cfg, params = model
    grads = []
    real = TS.apply_updates
    monkeypatch.setattr(TS, "apply_updates", lambda o, p, g, st, **kw: (
        grads.append(g), real(o, p, g, st, **kw))[1])
    opt = TO.OptimizerConfig(**OPT)
    step = TS.make_lm_train_step(cfg, TPOL.NO_POLICY, opt,
                                 parallel=spec_of(name),
                                 pipeline_microbatches=MB, schedule=sched)
    extra = []
    if dp > 1:
        extra.append(init_lm_dp_state(
            cfg, params, TPOL.CompressionPolicy(num_stages=s), dp, dfb,
            transport="pipeline" if s > 1 else "simulated", tp=tp))
    if s == 1:
        extra.append(TTP.init_tp_state((B, SEQ, cfg.d_model),
                                       TT.tp_sites(cfg), tfb))
    p, o = params, TO.init_opt_state(opt, params)
    losses, wires, first = [], [], None
    for i, tk in enumerate(tokens(cfg.vocab_size)):
        res = step(p, o, [], {"tokens": torch.from_numpy(tk)},
                   torch.arange(B, dtype=torch.int32), *extra)
        p, o, extra, m = res[0], res[1], list(res[3:-1]), res[-1]
        losses.append(float(m["loss"]))
        wires.append(m["wire"])
        if i == 0:
            first = list(extra)
    return losses, grads, first, p, wires


@pytest.mark.parametrize("name", list(TRAIN))
def test_tp_steps_match_reference(name, ref, request, monkeypatch):
    (dp, dc, dfb), (s, sc), (tp, tc, tfb), sched = TRAIN[name]
    model = request.getfixturevalue(
        "gemma2_model" if TRAIN_ARCHS.get(name) == "gemma2-27b" else "model")
    losses, grads, first, p, wires = _run_port(name, model, monkeypatch)
    exact = (dc, sc, tc) == ("none", "none", "none")
    for i, loss in enumerate(losses):
        gap = abs(loss - float(ref[f"train/{name}/{i}/loss"]))
        assert gap <= (LOSS_ATOL if exact else CURVE_ATOL), (i, gap)
    got = dict(_leaves(grads[0]))
    want = {n: ref[f"train/{name}/0/grad/{n}"] for n in got}
    assert sorted(got) == sorted(k[len(f"train/{name}/0/grad/"):]
                                 for k in ref
                                 if k.startswith(f"train/{name}/0/grad/"))
    if exact:
        for n in got:
            assert np.abs(_f32(got[n]) - want[n]).max() <= \
                REL_TOL * max(np.abs(want[n]).max(), 1e-6), n
    else:
        # GRAD_RTOL, or for a witnessed codec no farther than the reference
        # lies from itself when its embedding moves one bf16 ulp
        for names in (sorted(got), sorted(n for n in got
                                          if n.startswith("layers/"))):
            bound = GRAD_RTOL
            if tc in WITNESSED:
                bound = _rel([ref[f"train/{name}/witness/grad/{n}"]
                              for n in names], [want[n] for n in names])
            assert _rel([_f32(got[n]) for n in names],
                        [want[n] for n in names]) <= bound, \
                (names[0], bound)
    got_p = dict(_leaves(p))
    assert _rel([_f32(got_p[n]) for n in sorted(got_p)],
                [ref[f"train/{name}/params/{n}"] for n in sorted(got_p)]) \
        <= REL_TOL
    if dp > 1:
        dst = first[0]
        for slot in ("resid", "agg"):
            got_s = dict(_leaves(getattr(dst, slot)))
            keys = sorted(k for k in ref
                          if k.startswith(f"train/{name}/dp_{slot}/"))
            if dfb == "none" or (slot == "agg" and dfb != "ef21"):
                assert all(_f32(a).size == 0 for a in got_s.values())
                continue
            assert sorted(f"train/{name}/dp_{slot}/{n}"
                          for n in got_s) == keys
            assert _rel([_f32(got_s[n]) for n in sorted(got_s)],
                        [ref[k] for k in keys]) <= GRAD_RTOL
    if s == 1:
        tst = first[-1]
        assert (tst.scope, tst.mode) == ("tp", tfb)
        for slot in ("resid", "mirror"):
            got_b, want_b = _f32(getattr(tst, slot)), \
                ref[f"train/{name}/tp_{slot}"]
            assert got_b.shape == want_b.shape
            if not got_b.size:
                continue
            # site 0 packs the same bits in both packages
            assert _rel([got_b[0]], [want_b[0]]) <= REL_TOL, slot
            if slot == "mirror":
                assert _rel([got_b], [want_b]) <= BUF_RTOL
                continue
            # EF's resid is compression error: any code that moved upstream
            # changes it elementwise; its size per site is held
            for i in range(got_b.shape[0]):
                ratio = np.linalg.norm(got_b[i]) / np.linalg.norm(want_b[i])
                assert abs(ratio - 1) <= NORM_RTOL, (i, ratio)
    _check_wire(name, model[0], wires)


def _check_wire(name, cfg, wires):
    (dp, dc, _), (s, sc), (tp, tc, _), _ = TRAIN[name]
    d = cfg.d_model
    # the tensor rings: every lane (or every row's microbatch) runs the
    # whole stack's sites, forward and backward, on its batch
    rows_b = B // dp if s == 1 else B // (dp * MB)
    jcfg = jget(TRAIN_ARCHS.get(name, "gpt2-small"), smoke=True)
    rep = JTP.tp_wire_report((rows_b, SEQ, d), tp, tc,
                             sites=JT.tp_sites(jcfg))
    runs = dp * (1 if s == 1 else MB)
    tp_w = {"tp_hops": runs * 2 * tp * 2 * rep["sites_per_forward"]
            * rep["hops_per_collective"],
            "tp_bytes": runs * 2 * tp * rep["wire_bytes_per_forward"]}
    for w in wires:
        assert {k: w[k] for k in tp_w} == tp_w
    if s > 1:
        shard = (B // (dp * MB), SEQ // tp, d)
        bp = TPAR.ParallelSpec({"stage": TPAR.AxisSpec(s, sc)}
                               ).stage_policy().boundary
        tr = TPIPE.PipelineTransport(bp, s)
        hops = dp * tp * MB * (s - 1)
        for w in wires:
            assert w["fw_hops"] == w["bw_hops"] == hops
            assert w["fw_bytes"] == hops * TCODEC.wire_bytes(
                tr.fw_payload_struct(shard))
            assert w["bw_bytes"] == hops * TCODEC.wire_bytes(
                tr.bw_payload_struct(shard))
    if dp > 1:
        # one (stage column, tensor coordinate) block's leaves
        layers = TT.init_params(torch.Generator().manual_seed(0),
                                cfg)["layers"]
        like = (TT.stack_layer_stages({"layers": layers}, s) if s > 1
                else layers)
        dims = TT.tp_param_dims(like)
        port = TCOL.dp_wire_report(like, dc, dp=dp, tp_axis=tp,
                                   tp_dims=dims,
                                   shard_axis=s if s > 1 else None)
        blocks = TCOL._column_struct(like, s, tp, TO.tree_leaves(dims))
        jlike = [jax.ShapeDtypeStruct(b.shape, jnp.float32 if b.dtype ==
                                      torch.float32 else jnp.bfloat16)
                 for b in blocks]
        jrep = JCOL.dp_wire_report(jlike, dc, dp=dp)
        extra = {"tensor_columns": tp, **({"columns": s} if s > 1 else {})}
        assert port == dict(jrep, **extra)
        for w in wires:
            assert w["dp_hops"] == s * tp * dp * (dp - 1)
            assert w["dp_bytes"] == s * tp * dp * \
                jrep["wire_bytes_per_reduce"]


def test_run_lm_experiment_tensor_axis(ref, model):
    """``run_lm_experiment`` with a tensor axis: the reference's train
    curve and ``policy_curve`` (``policy/spec`` when tp > 1); a rule-coded
    tensor wire resolves against the cut's 1/tp sequence shard."""
    cfg, params = model
    res = run_lm_experiment(
        cfg, TPOL.NO_POLICY, pretrained_params=params, epochs=1, batch=8,
        data=LMData(**EXP_DATA), parallel=TPAR.ParallelSpec({"tensor": 2}),
        device="cpu")
    assert res.policy_curve == list(ref["exp/policy_curve"]) == \
        ["1x(fw=none,bw=none)/tensor=2"]
    np.testing.assert_allclose(res.train_curve, ref["exp/curve"],
                               atol=LOSS_ATOL)
    res = run_lm_experiment(
        cfg, TPOL.NO_POLICY, pretrained_params=params, epochs=1, batch=8,
        data=LMData(**EXP_DATA),
        parallel=TPAR.ParallelSpec({"tensor": TPAR.AxisSpec(2, EXP_RULES)}),
        device="cpu")
    bsize = EXP_DATA["seq_len"] * cfg.d_model
    want = JPAR.ParallelSpec({"tensor": JPAR.AxisSpec(2, EXP_RULES)}
                             ).resolved({"tensor": bsize // 2})
    assert res.policy_curve == [f"{JCP(num_stages=1).name}/{want.name}"] \
        == ["1x(fw=none,bw=none)/tensor=2(q8)"]


def test_refusals_match_reference(ref, model):
    cfg, params = model
    jcfg = jget("gpt2-small", smoke=True)
    opt, jopt = TO.OptimizerConfig(**OPT), JOC(**OPT)
    q4q8 = (TPOL.POLICIES["q4q8"](), JPOLICIES["q4q8"]())
    none = (TPOL.NO_POLICY, JCP(num_stages=1))
    # (policy, axes, grad_accum): simulated cuts with TP, tensor feedback
    # on the pipeline, gradient accumulation with TP
    for pols, axes, ga in ((q4q8, {"tensor": 2}, 1),
                           (none, {"stage": 2, "tensor": ("q8", "ef")}, 1),
                           (none, {"tensor": 2}, 2)):
        for mod, S, c, pol, o in ((TPAR, TS, cfg, pols[0], opt),
                                  (JPAR, JS, jcfg, pols[1], jopt)):
            spec = mod.ParallelSpec({
                k: mod.AxisSpec(2, *v) if isinstance(v, tuple) else v
                for k, v in axes.items()})
            with pytest.raises(NotImplementedError):
                S.make_lm_train_step(c, pol, o, grad_accum=ga,
                                     parallel=spec)
    # an encoder-decoder arch: the reference's "decoder-only" refusal
    msg = "tensor parallelism: decoder-only archs"
    with pytest.raises(NotImplementedError, match=msg):
        JS.make_lm_train_step(jget("whisper-small", smoke=True),
                              JCP(num_stages=1), jopt,
                              parallel=JPAR.ParallelSpec({"tensor": 2}))
    with pytest.raises(NotImplementedError, match=msg):
        TS.make_lm_train_step(tget("whisper-small", smoke=True),
                              TPOL.NO_POLICY, opt,
                              parallel=TPAR.ParallelSpec({"tensor": 2}))
    # a buffered stage policy with a tensor axis: refused where the
    # pipeline is traced (the reference) or run (the port)
    spec = TPAR.ParallelSpec({"stage": TPAR.AxisSpec(2, "q8", "ef"),
                              "tensor": 2})
    step = TS.make_lm_train_step(cfg, TPOL.NO_POLICY, opt,
                                 pipeline_microbatches=MB, parallel=spec)
    bst = _pipeline_bstates(spec.stage_policy(), (SEQ, cfg.d_model),
                            batch=B, microbatches=MB, dtype=torch.bfloat16)
    with pytest.raises(ValueError) as got:
        step(params, TO.init_opt_state(opt, params), bst,
             {"tokens": torch.from_numpy(tokens(cfg.vocab_size)[0])},
             torch.arange(B, dtype=torch.int32))
    assert type(got.value).__name__ == str(ref["refusal/buffered"])
    assert "buffer-free boundary policies only" in str(got.value)
    # heads that do not divide: the message names both counts
    with pytest.raises(ValueError, match="num_heads 4 and num_kv_heads 2 "
                                         "must both be divisible by tp=4"):
        TS.make_lm_train_step(cfg, TPOL.NO_POLICY, opt,
                              parallel=TPAR.ParallelSpec({"tensor": 4}))(
            params, TO.init_opt_state(opt, params), [],
            {"tokens": torch.from_numpy(tokens(cfg.vocab_size)[0])},
            torch.arange(B, dtype=torch.int32),
            TTP.init_tp_state((B, SEQ, cfg.d_model), TT.tp_sites(cfg)))


def test_dp_tp_reduce_state_is_the_layer_stack(model):
    """Under DP x TP the DP state mirrors the raw layer stack, as the
    reference's ``init_lm_dp_state(tp=)``."""
    from repro.train.loop import init_lm_dp_state as jinit
    cfg, params = model
    jcfg = jget("gpt2-small", smoke=True)
    want = jinit(jcfg, JT.init_params(jax.random.PRNGKey(0), jcfg),
                 JCP(num_stages=1), 2, "ef21", tp=2)
    got = init_lm_dp_state(cfg, params, TPOL.NO_POLICY, 2, "ef21", tp=2)
    for slot in ("resid", "agg"):
        assert [tuple(a.shape) for a in TO.tree_leaves(getattr(got, slot))] \
            == [a.shape for a in jax.tree.leaves(getattr(want, slot))]


def _launch(argv, capsys):
    assert ttrain.main(["--smoke", "--device", "cpu", "--batch", "4",
                        "--seq", "32", "--log-every", "1", *argv]) == 0
    out = capsys.readouterr().out
    return ([json.loads(l) for l in out.splitlines() if l.startswith("{")],
            out)


def test_launch_train_tensor_mesh(capsys):
    """``--mesh tensor=2 --wire tensor=q8+ef``: JSON lines with the ring's
    ``tp_bytes``, the tensor wire's codec and feedback line."""
    recs, out = _launch(["--steps", "2", "--mesh", "tensor=2", "--wire",
                         "tensor=q8+ef"], capsys)
    assert "# tp=2 tensor collectives: codec=q8 feedback=ef" in out
    cfg = tget("gpt2-small", smoke=True)
    rep = TTP.tp_wire_report((4, 32, cfg.d_model), 2, "q8",
                             sites=TT.tp_sites(cfg))
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert all(r["tp_bytes"] == 2 * 2 * rep["wire_bytes_per_forward"]
               for r in recs)


def test_launch_train_rule_coded_tensor_wire(capsys):
    """A rule-coded tensor wire resolves against the 1/tp sequence shard
    (32 * 256 / 2 = 4096 elements), as the reference's launcher: q8 here,
    where the whole cut (8192) would pick q4."""
    _, out = _launch(["--steps", "1", "--mesh", "tensor=2", "--wire",
                      "tensor=q4@size>=6000;q8"], capsys)
    assert "# tp=2 tensor collectives: codec=q8 feedback=none" in out


def test_launch_train_3d_mesh_and_resume_note(tmp_path, capsys):
    recs, _ = _launch(["--steps", "1", "--batch", "8", "--mesh",
                       "data=2,stage=2,tensor=2", "--wire",
                       "data=q8,stage=q8,tensor=q4",
                       "--pipeline-microbatches", "2"], capsys)
    assert set(recs[0]) >= {"fw_bytes", "bw_bytes", "dp_bytes", "tp_bytes"}
    ck = str(tmp_path / "s.npz")
    _launch(["--steps", "2", "--save-every", "1", "--ckpt", ck, "--mesh",
             "tensor=2", "--wire", "tensor=q4+ef21"], capsys)
    recs, out = _launch(["--steps", "2", "--resume", ck, "--mesh",
                         "tensor=2", "--wire", "tensor=q4+ef21"], capsys)
    assert "resuming with zeroed tp_state" in out
    assert [r["step"] for r in recs] == []
