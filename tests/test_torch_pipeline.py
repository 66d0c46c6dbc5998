"""The port's compressed pipeline against the JAX package's
``pipeline_apply`` and LM pipeline step, on the same numpy inputs.

The reference runs in ONE module-scoped subprocess (4 forced host
devices; its pipeline is a ``shard_map`` over a mesh): an Auto-axis
``jax.sharding.Mesh`` passed as ``mesh=``, every step under ``jax.jit``,
``KERNEL_BACKEND = "pallas"``.  It writes the losses, gradients and
feedback buffers to an npz that the tests compare with the port's.  It
takes about 85 s alone on an 8-core CPU; its 600 s limit leaves room for
the other test workers beside it.

Cases: a toy MLP stage stack (f32, d=256) and the gpt2-small smoke model
with 4 layer groups (bf16, batch 16, seq 32), under none / q8 / q4 / topk
/ topk_reuse, gpipe / 1f1b / interleaved, and EF / EF21 / EF-mixed /
AQ-SGD over two steps (the second reads the buffers the first wrote);
gemma2-27b's smoke model (2 local/global groups, window 16 < seq,
softcaps, post-norm) and mixtral-8x7b's (2 MoE layers, 4 experts top-2,
capacity routing in each microbatch) under q4q8 / gpipe; their aux is 0.0
on the pipeline in both packages.

Tolerances (measured on the CPU, then given headroom):
  * toy (f32, every case): loss within ``TOY_LOSS_RTOL`` = 1e-5 relative
    (measured at most 1.1e-6), gradients and buffers within
    ``TOY_GRAD_RTOL`` = 2e-3 of their norm (measured at most 5.7e-4: the
    raw wire rounds f32 activations to bf16, and the frameworks' f32
    products round a bf16 tie differently now and then);
  * LM without compression, the bounds of tests/test_torch_train.py:
    loss within 2e-3 absolute, every gradient leaf within 2**-5 of its
    largest magnitude (measured 2.7e-5 and 2**-6.2);
  * LM compressed: the two frameworks round the bf16 model differently,
    and a one-ulp difference at a cut's input moves a code or swaps a
    TopK entry (the jitted reference also scales its q8/q4 codes by
    ``span * f32(1/levels)``, one ulp off the port's division).  Loss
    within ``LM_LOSS_ATOL`` = 0.02 (the 5-step curves allow 0.05;
    measured at most 1.3e-3); the gradient tree within ``LM_GRAD_RTOL`` =
    0.3 of its norm and each leaf within ``LM_LEAF_RTOL`` = 0.5 of its own
    (measured at most 0.24 and 0.35, both under TopK with EF21, whose
    backward re-selects the gradient's TopK: ``top10reuse`` measures
    0.085); buffers within ``LM_BUF_RTOL`` = 0.5 of their norm (measured at
    most 0.33, EF21's backward buffers).  That is the model's own
    sensitivity: in the port alone, a one-ulp change of each bf16 embedding
    weight moves the gradient by 0.015 (none), 0.053 (q4q8), 0.195 (top10)
    and 0.103 (top10reuse) of its norm, against measured gaps to the
    reference of 0.011, 0.049, 0.173 and 0.085.  The toy cases hold the
    pipeline's mechanics under the same schemes, schedules and modes to
    the toy bounds above (loss 1e-5 relative, gradients and buffers 2e-3
    of their norm).
The reference's masked wrap-around hop writes two buffer slots that no
real cut uses (``transport/pipeline.py`` module doc): those are skipped,
and the port must leave them zero.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.models.transformer as JT
from repro.configs.registry import get as jget

import repro_torch.train.steps as TS
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.registry import get as tget
from repro_torch.core import policy as TPOL
from repro_torch.launch.train import build_policy
from repro_torch.optim import optimizers as TO
from repro_torch.train.loop import _pipeline_bstates, run_lm_experiment
from repro_torch.transport import pipeline as TP
from repro_torch.transport.schedules import get_schedule

# One intra-op thread: the suite runs in several worker processes at
# once, and a torch thread pool per worker that outnumbers the cores
# slows its CPU ops by an order of magnitude.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOY_LOSS_RTOL = 1e-5
TOY_GRAD_RTOL = 2e-3
LM_EXACT_ATOL = 2e-3
LM_EXACT_LEAF = 2.0 ** -5
LM_LOSS_ATOL = 0.02
LM_GRAD_RTOL = 0.3
LM_LEAF_RTOL = 0.5
LM_BUF_RTOL = 0.5

D, B, NS = 256, 32, 48
# name -> (scheme or feedback mode, schedule, stages, virtual, microbatches)
TOY = {
    "none_gpipe": ("none", "gpipe", 3, 1, 2),
    "q8_gpipe": ("q8", "gpipe", 3, 1, 2),
    "q4_gpipe": ("q4", "gpipe", 3, 1, 2),
    "topk_gpipe": ("topk", "gpipe", 3, 1, 2),
    "topk_reuse_gpipe": ("topk_reuse", "gpipe", 3, 1, 2),
    "q8_1f1b": ("q8", "1f1b", 3, 1, 4),
    "topk_reuse_1f1b": ("topk_reuse", "1f1b", 2, 1, 2),
    "none_interleaved": ("none", "interleaved", 2, 2, 4),
    "q4_interleaved": ("q4", "interleaved", 2, 2, 2),
    "ef_gpipe": ("ef", "gpipe", 3, 1, 2),
    "ef21_gpipe": ("ef21", "gpipe", 3, 1, 2),
    "efmixed_1f1b": ("efmixed", "1f1b", 2, 1, 2),
    "aqsgd_1f1b": ("aqsgd", "1f1b", 3, 1, 2),
    "ef21_interleaved": ("ef21", "interleaved", 2, 2, 2),
    "aqsgd_interleaved": ("aqsgd", "interleaved", 2, 2, 2),
}
FEEDBACK = ("ef", "ef21", "efmixed", "aqsgd")
# name -> (launch/train --policy, --feedback, schedule, virtual stages)
LM = {
    "none_gpipe": ("none", "none", "gpipe", 1),
    "q4q8_gpipe": ("q4q8", "none", "gpipe", 1),
    "q4q8_1f1b": ("q4q8", "none", "1f1b", 1),
    "q4q8_interleaved": ("q4q8", "none", "interleaved", 2),
    "top10_gpipe": ("top10", "none", "gpipe", 1),
    "top10reuse_1f1b": ("top10reuse", "none", "1f1b", 1),
    "aqsgd_gpipe": ("none", "aqsgd", "gpipe", 1),
    "ef21_1f1b": ("none", "ef21", "1f1b", 1),
    "gemma2_q4q8_gpipe": ("q4q8", "none", "gpipe", 1),
    "mixtral_q4q8_gpipe": ("q4q8", "none", "gpipe", 1),
}
# the LM cases on another arch's smoke model than gpt2-small's
LM_ARCHS = {"gemma2_q4q8_gpipe": "gemma2-27b",
            "mixtral_q4q8_gpipe": "mixtral-8x7b"}
LM_B, LM_SEQ, LM_MB = 16, 32, 2


def lm_config(get, name=None):
    """An LM case's smoke config from the registry ``get``: gpt2-small's
    with 4 layer groups, or the arch of ``LM_ARCHS`` as it is."""
    arch = LM_ARCHS.get(name, "gpt2-small")
    cfg = get(arch, smoke=True)
    if arch == "gpt2-small":
        cfg = dataclasses.replace(cfg, num_layers=4)
    return cfg


def toy_inputs():
    rng = np.random.RandomState(0)
    w = (rng.randn(4, D, D) * 0.06).astype(np.float32)
    x = [rng.randn(B, D).astype(np.float32) for _ in range(2)]
    target = rng.randn(B, D).astype(np.float32)
    ids = [np.arange(B, dtype=np.int32),
           rng.permutation(np.arange(16, 16 + B)).astype(np.int32)]
    return w, x, target, ids


def lm_inputs(vocab):
    rng = np.random.RandomState(1)
    toks = [rng.randint(0, vocab, (LM_B, LM_SEQ)) for _ in range(2)]
    ids = [np.arange(LM_B, dtype=np.int32),
           rng.permutation(LM_B).astype(np.int32)]
    return toks, ids


REFERENCE = r'''
import dataclasses, json, os, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
import repro.core.compressors as JC
JC.KERNEL_BACKEND = "pallas"
import repro.train.steps as JS
import repro.models.transformer as JT
from repro.configs.registry import get
from repro.core.policy import CompressionPolicy, aqsgd_policy, ef_policy
from repro.launch.train import POLICIES
from repro.optim import optimizers as JO
from repro.train.loop import _pipeline_bstates
from repro.transport.pipeline import (SCHEME_POLICIES, init_feedback_state,
                                      pipeline_apply)
sys.path.insert(0, sys.argv[2])
import test_torch_pipeline as T

out = {}
def save(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "name", p)))
                       for p in path)
        out[f"{prefix}/{key}"] = np.asarray(jnp.asarray(leaf, jnp.float32))

def toy_policy(scheme):
    if scheme == "aqsgd":
        return aqsgd_policy(0.1)
    if scheme in T.FEEDBACK:
        return ef_policy(0.1, scheme)
    return SCHEME_POLICIES[scheme](0.1)

w, xs, target, ids = T.toy_inputs()
stage_fn = lambda p, x: x + jnp.tanh(x @ p)
for name, (scheme, sched, s, v, mb) in T.TOY.items():
    mesh = Mesh(np.array(jax.devices()[:s]), ("stage",))
    pol = toy_policy(scheme)
    fb = scheme in T.FEEDBACK
    st = init_feedback_state(pol, (T.D,), num_stages=s, batch=T.B,
                             microbatches=mb, num_samples=T.NS,
                             virtual_stages=v)
    def loss_fn(wt, x, fw, bw, i):
        kw = dict(fw_state=fw, bw_state=bw, ids=i) if fb else {}
        r = pipeline_apply(stage_fn, wt, x, mesh, "stage", policy=pol,
                           microbatches=mb, schedule=sched,
                           virtual_stages=v, **kw)
        y, nfw = r if fb else (r, fw)
        return jnp.mean((y - target) ** 2), nfw
    f = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1, 3),
                                   has_aux=True))
    fw, bw = st["fw"], st["bw"]
    for step in range(2 if fb else 1):
        (loss, fw), (gw, gx, bw) = f(jnp.asarray(w[:s * v]),
                                     jnp.asarray(xs[step]), fw, bw,
                                     jnp.asarray(ids[step]))
        p = f"toy/{name}/{step}"
        out[f"{p}/loss"] = np.float32(loss)
        out[f"{p}/gw"], out[f"{p}/gx"] = np.asarray(gw), np.asarray(gx)
        for d, state in (("fw", fw), ("bw", bw)):
            out[f"{p}/{d}_resid"] = np.asarray(state.resid)
            out[f"{p}/{d}_mirror"] = np.asarray(state.mirror)

JS.apply_updates = lambda opt, p, g, s: (g, s)
opt = JO.OptimizerConfig(kind="sgd", lr=0.1)
mesh = Mesh(np.array(jax.devices()[:2]), ("stage",))
for name, (pname, feedback, sched, v) in T.LM.items():
    cfg = T.lm_config(get, name)
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    toks, lids = T.lm_inputs(cfg.vocab_size)
    pol = POLICIES[pname]()
    if feedback == "aqsgd":
        pol = CompressionPolicy(num_stages=2, boundary=aqsgd_policy(0.1))
    elif feedback != "none":
        pol = CompressionPolicy(num_stages=2,
                                boundary=ef_policy(0.1, feedback))
    pol = dataclasses.replace(pol, num_stages=2)
    st = _pipeline_bstates(pol, (T.LM_SEQ, cfg.d_model), batch=T.LM_B,
                           microbatches=T.LM_MB, num_samples=T.LM_B,
                           dtype=jnp.bfloat16, virtual_stages=v)
    step = JS.make_lm_train_step(cfg, pol, opt, transport="pipeline",
                                 mesh=mesh, pipeline_microbatches=T.LM_MB,
                                 schedule=sched, virtual_stages=v,
                                 donate=False)
    for i in range(2 if st else 1):
        g, _, st, m = step(params, JO.init_opt_state(opt, params), st,
                           {"tokens": jnp.asarray(toks[i], jnp.int32)},
                           jnp.asarray(lids[i]))
        p = f"lm/{name}/{i}"
        out[f"{p}/loss"] = np.float32(m["loss"])
        out[f"{p}/aux"] = np.float32(m["aux"])
        save(f"{p}/grad", g)
        if st:
            for d in ("fw", "bw"):
                out[f"{p}/{d}_resid"] = np.asarray(
                    st[d].resid.astype(jnp.float32))
                out[f"{p}/{d}_mirror"] = np.asarray(
                    st[d].mirror.astype(jnp.float32))
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("pipeline_ref") / "ref.npz"
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


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-12))


def _f32(t):
    return t.detach().float().numpy()


def _real_slots(buf: np.ndarray, s: int, v: int, mirror: bool):
    """The buffer with the slot no real cut uses cut out: the last logical
    stage's fw resid, logical stage 0's fw mirror.  Returns (kept, the
    unused slot)."""
    d, k = (0, 0) if mirror else (s - 1, v - 1)
    mask = np.ones(buf.shape[:2] if v > 1 else buf.shape[:1], bool)
    mask[(d, k) if v > 1 else d] = False
    return buf[mask], buf[~mask]


def _assert_buffers(tst, want, prefix, s, v, rtol):
    for d in ("fw", "bw"):
        for slot in ("resid", "mirror"):
            got = _f32(getattr(tst[d], slot))
            ref = want[f"{prefix}/{d}_{slot}"]
            assert got.shape == ref.shape, (d, slot, got.shape, ref.shape)
            if got.size == 0:
                continue
            if d == "fw":
                got, unused = _real_slots(got, s, v, slot == "mirror")
                ref, _ = _real_slots(ref, s, v, slot == "mirror")
                assert not unused.any(), f"{prefix} {d} {slot}: unused slot"
            assert _rel(got, ref) <= rtol, (prefix, d, slot, _rel(got, ref))


# ---------------------------------------------------------------------------
# the toy stage stack through pipeline_apply
# ---------------------------------------------------------------------------

def _toy_policy(scheme):
    if scheme == "aqsgd":
        return TPOL.aqsgd_policy(0.1)
    if scheme in FEEDBACK:
        return TPOL.ef_policy(0.1, scheme)
    return TP.SCHEME_POLICIES[scheme](0.1)


def _toy_stage(p, x):
    return x + torch.tanh(x @ p)


@pytest.mark.parametrize("name", list(TOY))
def test_toy_pipeline_matches_reference(name, ref):
    scheme, sched, s, v, mb = TOY[name]
    pol = _toy_policy(scheme)
    fb = scheme in FEEDBACK
    w, xs, target, ids = toy_inputs()
    st = TP.init_feedback_state(pol, (D,), num_stages=s, batch=B,
                                microbatches=mb, num_samples=NS,
                                virtual_stages=v)
    for step in range(2 if fb else 1):
        wt = torch.from_numpy(w[:s * v]).requires_grad_(True)
        x = torch.from_numpy(xs[step]).requires_grad_(True)
        y, fw, slot = TP.pipeline_apply(
            _toy_stage, wt, x, num_stages=s, policy=pol, microbatches=mb,
            schedule=sched, virtual_stages=v,
            fw_state=st["fw"] if fb else None,
            bw_state=st["bw"] if fb else None,
            ids=torch.from_numpy(ids[step]))
        loss = ((y - torch.from_numpy(target)) ** 2).mean()
        loss.backward()
        p = f"toy/{name}/{step}"
        want = float(ref[f"{p}/loss"])
        assert abs(loss.item() - want) <= TOY_LOSS_RTOL * abs(want), \
            (loss.item(), want)
        assert _rel(_f32(wt.grad), ref[f"{p}/gw"]) <= TOY_GRAD_RTOL
        assert _rel(_f32(x.grad), ref[f"{p}/gx"]) <= TOY_GRAD_RTOL
        hops = mb * (v * s - 1)
        assert slot.wire["fw_hops"] == slot.wire["bw_hops"] == hops
        if fb:
            st = {"fw": fw, "bw": slot.state}
            _assert_buffers(st, ref, p, s, v, TOY_GRAD_RTOL)


def test_toy_wire_bytes_are_the_telemetry():
    """Bytes counted at the hops == ``wire_telemetry`` x hops, for every
    scheme and schedule of the toy runs."""
    w, xs, _, ids = toy_inputs()
    for name, (scheme, sched, s, v, mb) in TOY.items():
        pol = _toy_policy(scheme)
        st = TP.init_feedback_state(pol, (D,), num_stages=s, batch=B,
                                    microbatches=mb, num_samples=NS,
                                    virtual_stages=v)
        x = torch.from_numpy(xs[0]).to(torch.bfloat16).requires_grad_(True)
        y, _, slot = TP.pipeline_apply(
            _toy_stage, torch.from_numpy(w[:s * v]).to(torch.bfloat16), x,
            num_stages=s, policy=pol, microbatches=mb, schedule=sched,
            virtual_stages=v, fw_state=st["fw"], bw_state=st["bw"],
            ids=torch.from_numpy(ids[0]))
        y.float().sum().backward()
        sch = get_schedule(sched, v)
        tel = TP.wire_telemetry(
            TP.PipelineTransport(pol, s, virtual_stages=v,
                                 fused=sch.fused_wire), sch, (B // mb, D),
            microbatches=mb)
        hops = mb * tel["wire_cuts"]
        assert slot.wire == {
            "fw_hops": hops, "bw_hops": hops,
            "fw_bytes": hops * tel["fw_payload_bytes_per_hop"],
            "bw_bytes": hops * tel["bw_payload_bytes_per_hop"]}, name


def test_pipeline_apply_refuses_bad_calls():
    w = torch.zeros((3, 4, 4))
    x = torch.zeros((4, 4))
    none = TP.SCHEME_POLICIES["none"](0.1)
    with pytest.raises(ValueError, match="leading dim"):
        TP.pipeline_apply(_toy_stage, w, x, num_stages=2, policy=none)
    with pytest.raises(ValueError, match="fw_state/bw_state"):
        TP.pipeline_apply(_toy_stage, w[:2], x, num_stages=2,
                          policy=TPOL.ef_policy(0.1, "ef21"))
    with pytest.raises(ValueError, match="not divisible"):
        TP.pipeline_apply(_toy_stage, w[:2], x[:3], num_stages=2,
                          policy=none)
    with pytest.raises(NotImplementedError, match="reuse_indices"):
        TP.PipelineTransport(dataclasses.replace(
            TPOL.topk_policy(0.1, reuse_indices=True), feedback="ef"), 2)


# ---------------------------------------------------------------------------
# the LM pipeline step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    """``load(name=None) -> (tcfg, params)``: an LM case's smoke model
    with the reference's seed-0 params, carried through numpy."""
    models = {}

    def load(name=None):
        arch = LM_ARCHS.get(name, "gpt2-small")
        if arch not in models:
            jp = JT.init_params(jax.random.PRNGKey(0), lm_config(jget, name))
            models[arch] = (lm_config(tget, name), params_from_numpy(
                jax.tree.map(np.asarray, jp), "cpu"))
        return models[arch]
    return load


def _lm_policy(pname, feedback):
    return dataclasses.replace(build_policy(pname, feedback, 0.1),
                               num_stages=2)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


@pytest.mark.parametrize("name", list(LM))
def test_lm_pipeline_step_matches_reference(name, ref, lm, monkeypatch):
    tcfg, params = lm(name)
    pname, feedback, sched, v = LM[name]
    pol = _lm_policy(pname, feedback)
    monkeypatch.setattr(TS, "apply_updates",
                        lambda opt, p, g, s, **kw: (g, s))
    opt = TO.OptimizerConfig(kind="sgd", lr=0.1)
    st = _pipeline_bstates(pol, (LM_SEQ, tcfg.d_model), batch=LM_B,
                           microbatches=LM_MB, num_samples=LM_B,
                           dtype=torch.bfloat16, virtual_stages=v)
    step = TS.make_lm_train_step(tcfg, pol, opt, transport="pipeline",
                                 pipeline_microbatches=LM_MB, schedule=sched,
                                 virtual_stages=v)
    toks, ids = lm_inputs(tcfg.vocab_size)
    exact = pname == "none" and feedback == "none"
    for i in range(2 if st else 1):
        g, _, st, m = step(params, TO.init_opt_state(opt, params), st,
                           {"tokens": torch.from_numpy(toks[i])},
                           torch.from_numpy(ids[i]))
        p = f"lm/{name}/{i}"
        gap = abs(float(m["loss"]) - float(ref[f"{p}/loss"]))
        assert gap <= (LM_EXACT_ATOL if exact else LM_LOSS_ATOL), gap
        # the pipeline drops the MoE load-balance loss, as the reference
        assert float(m["aux"]) == float(ref[f"{p}/aux"]) == 0.0
        hops = LM_MB * (2 * v - 1)
        assert m["wire"]["fw_hops"] == m["wire"]["bw_hops"] == hops
        got = {path: _f32(leaf) for path, leaf in _leaves(g)}
        want = {path: ref[f"{p}/grad/{path}"] for path in got}
        for path in got:
            if exact:
                assert np.abs(got[path] - want[path]).max() <= \
                    LM_EXACT_LEAF * max(np.abs(want[path]).max(), 1e-6), path
            else:
                assert _rel(got[path], want[path]) <= LM_LEAF_RTOL, path
        if not exact:
            assert _rel(np.concatenate([a.ravel() for a in got.values()]),
                        np.concatenate([a.ravel() for a in want.values()])
                        ) <= LM_GRAD_RTOL
        if st:
            _assert_buffers(st, ref, p, 2, v, LM_BUF_RTOL)


def test_lm_1f1b_equals_gpipe_bitwise(lm):
    """Same cuts, same order: rematerialization and framed hops change no
    bit of the loss or the updated params."""
    tcfg, params = lm()
    pol = _lm_policy("q4q8", "none")
    opt = TO.OptimizerConfig(kind="adamw", lr=1e-3, weight_decay=0.01,
                             schedule="cosine", t_max=2, grad_clip=1.0)
    toks, ids = lm_inputs(tcfg.vocab_size)
    runs = {}
    for sched in ("gpipe", "1f1b"):
        step = TS.make_lm_train_step(tcfg, pol, opt, transport="pipeline",
                                     pipeline_microbatches=LM_MB,
                                     schedule=sched)
        p, o = params, TO.init_opt_state(opt, params)
        losses = []
        for t in toks:
            p, o, _, m = step(p, o, [], {"tokens": torch.from_numpy(t)},
                              torch.from_numpy(ids[0]))
            losses.append(float(m["loss"]))
        runs[sched] = (losses, p)
    assert runs["gpipe"][0] == runs["1f1b"][0]
    for (n, a), (_, b) in zip(_leaves(runs["gpipe"][1]),
                              _leaves(runs["1f1b"][1])):
        assert torch.equal(a, b), n


def test_run_lm_experiment_pipeline_cpu():
    from repro_torch.data.synthetic import LMData
    cfg = tget("gpt2-small", smoke=True)
    data = LMData(num_train=16, num_test=8, seq_len=16, vocab=64, seed=0)
    res = run_lm_experiment(cfg, _lm_policy("top10", "none"), epochs=1,
                            batch=8, data=data, transport="pipeline",
                            schedule="1f1b", pipeline_microbatches=2,
                            device="cpu")
    assert len(res.train_curve) == 2
    assert all(np.isfinite(res.train_curve))
    assert np.isfinite(res.loss_on) and np.isfinite(res.loss_off)
    json.dumps(res.train_curve)
