"""The pipeline's stages as processes: ``pipeline_apply_rank`` and the
rank step of ``make_lm_train_step(..., group=)`` against the one-process
``pipeline_apply`` and pipeline step, with ``torch.distributed`` gloo on
CPU processes.

One module-scoped fixture spawns the ranks once per world size (4 and 2,
``torch.multiprocessing.spawn``, a ``file://`` store, every join under a
deadline), runs every case inside the workers and saves what each rank
holds; the parent computes the one-process runs meanwhile, and the JAX
package's reference runs in one subprocess beside them (4 forced host
devices, an Auto-axis mesh, ``jax.jit``, ``KERNEL_BACKEND = "pallas"``).
Workers and parent run one intra-op thread each.  About 45 s alone on an
8-core CPU.

Cases: the toy MLP stage stack (f32, d 256, batch 32) and the gpt2-small
smoke model cut to 4 layer groups (bf16, batch 8, seq 32) under none / q8
/ q4 (q4q8) / TopK (top10) / TopK with reuse_indices, gpipe / 1f1b /
interleaved, and EF / EF21 / EF-mixed / AQ-SGD, each over two steps (the
second reads the buffers the first wrote).

What must hold:
  * bitwise, with ``grad_clip=0``: the loss, every rank's gradients (and
    rank 0's input gradient), the updated params (AdamW), every feedback
    buffer row and the wire counters summed over ranks;
  * under the launcher's ``grad_clip=1.0`` the clip's global norm gathers
    each rank's per-leaf squared sums and sums them in rank order, where
    one process sums each whole layer leaf in one reduction.  Step 1's
    gradients stay bitwise; its norm is within ``CLIP_NORM_RTOL`` = 4e-7
    relative (measured 1.3e-7, one float32 ulp), so the clip scale and
    the updated params part only by a rounding: each param leaf within
    ``CLIP_PARAM_RTOL`` = 1e-3 of its largest magnitude after either step
    (measured at most 8.6e-5: a bf16 param one rounding apart).  Step 2
    runs from those params: its norm within ``CLIP_NORM2_RTOL`` = 1e-4
    (measured 1.8e-5), its loss within ``CLIP_LOSS_RTOL`` = 1e-5
    relative, as step 1's (measured 0 at both steps);
  * one toy case (EF21, 1f1b, 4 stages) within the JAX reference's
    ``TOY_LOSS_RTOL`` / ``TOY_GRAD_RTOL`` of tests/test_torch_pipeline.py,
    and ``pipeline_forward`` bitwise ``pipeline_apply`` and within those
    bounds of the reference's ``pipeline_forward``;
  * the launcher under ``torch.distributed.run`` prints the one-process
    launcher's JSON: every step's rounded loss and bytes and step 1's
    ``ppl`` bitwise, step 2's ``ppl`` (the exp of the unrounded loss, run
    from params the clip moved) within ``LAUNCH_PPL_RTOL`` = 2e-5 relative
    (measured 0 here, 5.8e-6 on an H100 in ``chip_smoke.py``); it refuses
    what the ranks do not carry; nccl with two ranks on one card and a world size other than
    the stage count raise.
"""
import contextlib
import dataclasses
import io
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.core import policy as TPOL
from repro_torch.transport import pipeline as TP
from repro_torch.transport.schedules import get_schedule

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
JOIN_S = 240                  # every spawn's deadline
CLIP_NORM_RTOL = 4e-7
CLIP_NORM2_RTOL = 1e-4
CLIP_LOSS_RTOL = 1e-5
CLIP_PARAM_RTOL = 1e-3
LAUNCH_PPL_RTOL = 2e-5

D, B, NS = 256, 32, 48
FEEDBACK = ("ef", "ef21", "efmixed", "aqsgd")
# name -> (scheme or feedback mode, schedule, stages, virtual, microbatches)
TOY = {
    "none_gpipe": ("none", "gpipe", 4, 1, 4),
    "q8_gpipe": ("q8", "gpipe", 4, 1, 4),
    "q4_1f1b": ("q4", "1f1b", 4, 1, 8),
    "topk_gpipe": ("topk", "gpipe", 4, 1, 4),
    "topk_reuse_1f1b": ("topk_reuse", "1f1b", 4, 1, 4),
    "q8_interleaved": ("q8", "interleaved", 4, 2, 4),
    "ef_gpipe": ("ef", "gpipe", 4, 1, 4),
    "ef21_1f1b": ("ef21", "1f1b", 4, 1, 4),
    "efmixed_gpipe": ("efmixed", "gpipe", 4, 1, 4),
    "aqsgd_1f1b": ("aqsgd", "1f1b", 4, 1, 4),
    "aqsgd_interleaved": ("aqsgd", "interleaved", 4, 2, 4),
    "none_interleaved_s2": ("none", "interleaved", 2, 2, 4),
    "topk_reuse_interleaved_s2": ("topk_reuse", "interleaved", 2, 2, 2),
    "ef21_interleaved_s2": ("ef21", "interleaved", 2, 2, 2),
    "q4_gpipe_s2": ("q4", "gpipe", 2, 1, 2),
    "efmixed_1f1b_s2": ("efmixed", "1f1b", 2, 1, 2),
}
JAX_TOY = "ef21_1f1b"
# name -> (launch/train --policy, --feedback, schedule, stages, virtual,
#          grad_clip)
LM = {
    "none_gpipe": ("none", "none", "gpipe", 4, 1, 0.0),
    "q4q8_gpipe": ("q4q8", "none", "gpipe", 4, 1, 0.0),
    "q4q8_1f1b": ("q4q8", "none", "1f1b", 4, 1, 0.0),
    "top10_gpipe": ("top10", "none", "gpipe", 4, 1, 0.0),
    "top10reuse_1f1b": ("top10reuse", "none", "1f1b", 4, 1, 0.0),
    "ef_gpipe": ("none", "ef", "gpipe", 4, 1, 0.0),
    "ef21_1f1b": ("none", "ef21", "1f1b", 4, 1, 0.0),
    "efmixed_gpipe": ("none", "efmixed", "gpipe", 4, 1, 0.0),
    "aqsgd_1f1b": ("none", "aqsgd", "1f1b", 4, 1, 0.0),
    "q4q8_interleaved_s2": ("q4q8", "none", "interleaved", 2, 2, 0.0),
    "aqsgd_interleaved_s2": ("none", "aqsgd", "interleaved", 2, 2, 0.0),
}
LM_CLIP = "q4q8_gpipe_clip"
LM[LM_CLIP] = ("q4q8", "none", "gpipe", 4, 1, 1.0)
LM_B, LM_SEQ, LM_MB, LM_SAMPLES = 8, 32, 4, 16


def toy_inputs():
    rng = np.random.RandomState(0)
    w = (rng.randn(8, D, D) * 0.06).astype(np.float32)
    x = [rng.randn(B, D).astype(np.float32) for _ in range(2)]
    target = rng.randn(B, D).astype(np.float32)
    ids = [np.arange(B, dtype=np.int32),
           rng.permutation(np.arange(16, 16 + B)).astype(np.int32)]
    return w, x, target, ids


def toy_policy(scheme):
    if scheme == "aqsgd":
        return TPOL.aqsgd_policy(0.1)
    if scheme in FEEDBACK:
        return TPOL.ef_policy(0.1, scheme)
    return TP.SCHEME_POLICIES[scheme](0.1)


def toy_stage(p, x):
    return x + torch.tanh(x @ p)


def _state_dict(st):
    return {f"{d}_{slot}": getattr(st[d], slot).clone()
            for d in ("fw", "bw") for slot in ("resid", "mirror")}


def run_toy(name, group=None):
    """Two steps of toy case ``name``: one process, or this rank of
    ``group``.  Returns one record a step."""
    scheme, sched, s, v, mb = TOY[name]
    pol, fb = toy_policy(scheme), scheme in FEEDBACK
    w, xs, target, ids = toy_inputs()
    rank = None if group is None else group.rank
    st = TP.init_feedback_state(pol, (D,), num_stages=s, batch=B,
                                microbatches=mb, num_samples=NS,
                                virtual_stages=v, stage=rank)
    kw = dict(num_stages=s, policy=pol, microbatches=mb, schedule=sched,
              virtual_stages=v)
    out = []
    for step in range(2):
        wt = w[:s * v] if rank is None else w[rank:s * v:s]
        wt = torch.from_numpy(wt.copy()).requires_grad_(True)
        x = torch.from_numpy(xs[step]).requires_grad_(True)
        fkw = dict(fw_state=st["fw"] if fb else None,
                   bw_state=st["bw"] if fb else None,
                   ids=torch.from_numpy(ids[step]), **kw)
        loss = None
        if rank is None:
            y, fw, slot = TP.pipeline_apply(toy_stage, wt, x, **fkw)
            loss = ((y - torch.from_numpy(target)) ** 2).mean()
            loss.backward()
        else:
            y, fw, slot = TP.pipeline_apply_rank(
                toy_stage, wt, x if rank == 0 else None, group=group,
                shape=(B, D), dtype=torch.float32, **fkw)
            g = None
            if y is not None:
                y.requires_grad_(True)
                loss = ((y - torch.from_numpy(target)) ** 2).mean()
                loss.backward()
                g = y.grad
            slot.backward(g)
        if fb:
            st = {"fw": fw, "bw": slot.state}
        out.append({"loss": None if loss is None else loss.detach(),
                    "gw": wt.grad, "gx": x.grad, "wire": dict(slot.wire),
                    "state": _state_dict(st) if fb else {}})
    return out


def lm_setup(name):
    from repro_torch.configs.registry import get
    from repro_torch.launch.train import build_policy
    from repro_torch.models import transformer
    from repro_torch.optim.optimizers import OptimizerConfig
    pname, feedback, sched, s, v, clip = LM[name]
    cfg = dataclasses.replace(get("gpt2-small", smoke=True), num_layers=4)
    pol = dataclasses.replace(build_policy(pname, feedback, 0.1),
                              num_stages=s)
    opt = OptimizerConfig(kind="adamw", lr=1e-3, weight_decay=0.01,
                          schedule="cosine", t_max=2, grad_clip=clip)
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    return cfg, pol, opt, params, sched, s, v


def run_lm(name, group=None):
    """Two AdamW steps of LM case ``name`` from the seed-0 smoke model:
    one process, or this rank of ``group``.  Each step's record holds the
    loss, the gradient the optimizer was given (and the clip's norm), the
    new params, the buffers and the wire counters."""
    from repro_torch.launch.train import synthetic_stream
    from repro_torch.optim import optimizers as TO
    from repro_torch.train import steps as TS
    from repro_torch.train.loop import _pipeline_bstates
    cfg, pol, opt, params, sched, s, v = lm_setup(name)
    rank = None if group is None else group.rank
    seen = []
    real = TS.apply_updates

    def recording(o, p, g, state, **kw):
        norm = kw.get("grad_norm")
        if norm is None and o.grad_clip:
            norm = TO._global_norm(g)
        seen.append((g, norm))
        return real(o, p, g, state, **kw)

    TS.apply_updates = recording
    try:
        step = TS.make_lm_train_step(cfg, pol, opt, transport="pipeline",
                                     pipeline_microbatches=LM_MB,
                                     schedule=sched, virtual_stages=v,
                                     group=group)
        if rank is not None:
            params = TS.stage_params(params, rank, s, v)
        bst = _pipeline_bstates(pol, (LM_SEQ, cfg.d_model), batch=LM_B,
                                microbatches=LM_MB, num_samples=LM_SAMPLES,
                                dtype=torch.bfloat16, virtual_stages=v,
                                stage=rank)
        opt_state = TO.init_opt_state(opt, params)
        stream = synthetic_stream(cfg, LM_B, LM_SEQ, 0,
                                  num_samples=LM_SAMPLES)
        out = []
        for _ in range(2):
            toks, ids = next(stream)
            params, opt_state, bst, m = step(
                params, opt_state, bst,
                {"tokens": torch.from_numpy(toks).to(torch.int64)},
                torch.from_numpy(ids))
            g, norm = seen[-1]
            out.append({"loss": m["loss"], "grads": g, "norm": norm,
                        "params": params, "wire": m["wire"],
                        "state": _state_dict(bst) if bst else {}})
    finally:
        TS.apply_updates = real
    return out


def worker(rank, world, store, outdir):
    """One rank: every case of its world size, saved to ``outdir``."""
    torch.set_num_threads(1)
    from repro_torch.transport.p2p import StageGroup
    with StageGroup(rank, world, "gloo", device="cpu",
                    init_method=f"file://{store}") as group:
        res = {"toy": {n: run_toy(n, group) for n, c in TOY.items()
                       if c[2] == world},
               "lm": {n: run_lm(n, group) for n, c in LM.items()
                      if c[3] == world}}
    torch.save(res, os.path.join(outdir, f"rank{rank}.pt"))


REFERENCE = r'''
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
import repro.core.compressors as JC
JC.KERNEL_BACKEND = "pallas"
from repro.core.policy import ef_policy
from repro.transport.pipeline import (init_feedback_state, pipeline_apply,
                                      pipeline_forward)
sys.path.insert(0, sys.argv[2])
import test_torch_pipeline_ranks as T

out = {}
w, xs, target, ids = T.toy_inputs()
stage_fn = lambda p, x: x + jnp.tanh(x @ p)
scheme, sched, s, v, mb = T.TOY[T.JAX_TOY]
mesh = Mesh(np.array(jax.devices()[:s]), ("stage",))
pol = ef_policy(0.1, scheme)
st = init_feedback_state(pol, (T.D,), num_stages=s, batch=T.B,
                         microbatches=mb, num_samples=T.NS, virtual_stages=v)
def loss_fn(wt, x, fw, bw, i):
    y, nfw = pipeline_apply(stage_fn, wt, x, mesh, "stage", policy=pol,
                            microbatches=mb, schedule=sched,
                            virtual_stages=v, fw_state=fw, bw_state=bw,
                            ids=i)
    return jnp.mean((y - target) ** 2), nfw
f = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1, 3), has_aux=True))
fw, bw = st["fw"], st["bw"]
for step in range(2):
    (loss, fw), (gw, gx, bw) = f(jnp.asarray(w[:s * v]),
                                 jnp.asarray(xs[step]), fw, bw,
                                 jnp.asarray(ids[step]))
    p = f"toy/{step}"
    out[f"{p}/loss"] = np.float32(loss)
    out[f"{p}/gw"], out[f"{p}/gx"] = np.asarray(gw), np.asarray(gx)
    for d, state in (("fw", fw), ("bw", bw)):
        out[f"{p}/{d}_resid"] = np.asarray(state.resid)
        out[f"{p}/{d}_mirror"] = np.asarray(state.mirror)
def fwd_loss(wt, x):
    y = pipeline_forward(stage_fn, wt, x, mesh, "stage", scheme="q4",
                         microbatches=4)
    return jnp.mean((y - target) ** 2), y
(loss, y), (gw, gx) = jax.jit(jax.value_and_grad(
    fwd_loss, argnums=(0, 1), has_aux=True))(jnp.asarray(w[:4]),
                                             jnp.asarray(xs[0]))
out["fwd/loss"], out["fwd/y"] = np.float32(loss), np.asarray(y)
out["fwd/gw"], out["fwd/gx"] = np.asarray(gw), np.asarray(gx)
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
'''


def _join(ctx, deadline):
    """Join a spawn context by ``deadline``, or kill its processes."""
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError("rank processes did not finish in "
                                 f"{JOIN_S} s")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on ranks (worlds 4 and 2), in one process, and the JAX
    reference's toy case."""
    tmp = tmp_path_factory.mktemp("pipeline_ranks")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    ref_path = tmp / "ref.npz"
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(ref_path), str(ROOT / "tests")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    deadline = time.monotonic() + JOIN_S
    spawned = {}
    for world in (4, 2):
        out = tmp / f"world{world}"
        out.mkdir()
        spawned[world] = (out, mp.spawn(
            worker, args=(world, str(tmp / f"store{world}"), str(out)),
            nprocs=world, join=False))
    one = {"toy": {n: run_toy(n) for n in TOY},
           "lm": {n: run_lm(n) for n in LM}}
    ranks = {}
    for world, (out, ctx) in spawned.items():
        _join(ctx, deadline)
        ranks[world] = [torch.load(out / f"rank{r}.pt", weights_only=False)
                        for r in range(world)]
    stdout, stderr = ref.communicate(timeout=max(deadline - time.monotonic(),
                                                 1))
    assert ref.returncode == 0 and "REFERENCE_OK" in stdout, stderr[-3000:]
    return {"ranks": ranks, "one": one, "jax": dict(np.load(ref_path))}


def _rank_records(runs, kind, name, world):
    return [r[kind][name] for r in runs["ranks"][world]]


def _equal_trees(got, want, what):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _equal_trees(got[k], want[k], f"{what}/{k}")
        return
    assert got.dtype == want.dtype and torch.equal(got, want), what


def _wire_sum(records, step):
    keys = ("fw_hops", "fw_bytes", "bw_hops", "bw_bytes")
    return {k: sum(rec[step]["wire"][k] for rec in records) for k in keys}


# ---------------------------------------------------------------------------
# the toy stack through pipeline_apply_rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(TOY))
def test_toy_ranks_equal_one_process_bitwise(name, runs):
    scheme, sched, s, v, mb = TOY[name]
    ranks = _rank_records(runs, "toy", name, s)
    for step, want in enumerate(runs["one"]["toy"][name]):
        got = [r[step] for r in ranks]
        assert torch.equal(got[s - 1]["loss"], want["loss"]), step
        assert all(g["loss"] is None for g in got[:-1])
        for r in range(s):
            assert torch.equal(got[r]["gw"], want["gw"][r::s]), (step, r)
        assert torch.equal(got[0]["gx"], want["gx"]), step
        assert _wire_sum(ranks, step) == want["wire"], step
        for key, buf in want["state"].items():
            for r in range(s):
                assert torch.equal(got[r]["state"][key], buf[r]), \
                    (step, key, r)


def test_toy_ranks_match_the_reference(runs):
    """One toy case on 4 ranks within the one-process pipeline's bounds
    of the JAX package (tests/test_torch_pipeline.py)."""
    from test_torch_pipeline import TOY_GRAD_RTOL, TOY_LOSS_RTOL, _rel
    scheme, sched, s, v, mb = TOY[JAX_TOY]
    ranks = _rank_records(runs, "toy", JAX_TOY, s)
    ref = runs["jax"]
    for step in range(2):
        p = f"toy/{step}"
        want = float(ref[f"{p}/loss"])
        got = float(ranks[s - 1][step]["loss"])
        assert abs(got - want) <= TOY_LOSS_RTOL * abs(want), (got, want)
        gw = torch.cat([ranks[r][step]["gw"] for r in range(s)])
        assert _rel(gw.numpy(), ref[f"{p}/gw"]) <= TOY_GRAD_RTOL
        assert _rel(ranks[0][step]["gx"].numpy(),
                    ref[f"{p}/gx"]) <= TOY_GRAD_RTOL
        for d in ("fw", "bw"):
            for slot in ("resid", "mirror"):
                got_buf = np.stack([ranks[r][step]["state"][f"{d}_{slot}"]
                                    .numpy() for r in range(s)])
                want_buf = ref[f"{p}/{d}_{slot}"]
                if d == "fw":       # the slot no real cut uses
                    keep = np.ones(s, bool)
                    keep[0 if slot == "mirror" else s - 1] = False
                    assert not got_buf[~keep].any()
                    got_buf, want_buf = got_buf[keep], want_buf[keep]
                assert _rel(got_buf, want_buf) <= TOY_GRAD_RTOL, (d, slot)


def test_pipeline_forward_is_pipeline_apply_and_the_reference(runs):
    """``pipeline_forward`` is ``pipeline_apply`` under its scheme's
    symmetric policy, bit for bit, and within the toy bounds of the
    reference's ``pipeline_forward``."""
    from test_torch_pipeline import TOY_GRAD_RTOL, TOY_LOSS_RTOL, _rel
    w, xs, target, _ = toy_inputs()
    grads = []
    for fn in ("forward", "apply"):
        wt = torch.from_numpy(w[:4]).requires_grad_(True)
        x = torch.from_numpy(xs[0]).requires_grad_(True)
        if fn == "forward":
            y = TP.pipeline_forward(toy_stage, wt, x, num_stages=4,
                                    scheme="q4", microbatches=4)
        else:
            y = TP.pipeline_apply(toy_stage, wt, x, num_stages=4,
                                  policy=TP.SCHEME_POLICIES["q4"](0.1),
                                  microbatches=4)[0]
        loss = ((y - torch.from_numpy(target)) ** 2).mean()
        loss.backward()
        grads.append((y.detach(), loss.detach(), wt.grad, x.grad))
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    y, loss, gw, gx = grads[0]
    ref = runs["jax"]
    want = float(ref["fwd/loss"])
    assert abs(float(loss) - want) <= TOY_LOSS_RTOL * abs(want)
    assert _rel(y.numpy(), ref["fwd/y"]) <= TOY_GRAD_RTOL
    assert _rel(gw.numpy(), ref["fwd/gw"]) <= TOY_GRAD_RTOL
    assert _rel(gx.numpy(), ref["fwd/gx"]) <= TOY_GRAD_RTOL
    with pytest.raises(ValueError, match="unknown scheme"):
        TP.pipeline_forward(toy_stage, w[:2], xs[0], num_stages=2,
                            scheme="q3")


# ---------------------------------------------------------------------------
# the LM step, one rank a stage
# ---------------------------------------------------------------------------

def _stage_tree(tree, r, s, v):
    from repro_torch.train.steps import stage_params
    return stage_params(tree, r, s, v)


@pytest.mark.parametrize("name", [n for n in LM if n != LM_CLIP])
def test_lm_rank_step_equals_one_process_bitwise(name, runs):
    s, v = LM[name][3], LM[name][4]
    ranks = _rank_records(runs, "lm", name, s)
    for step, want in enumerate(runs["one"]["lm"][name]):
        got = [r[step] for r in ranks]
        assert torch.equal(got[s - 1]["loss"], want["loss"]), step
        assert all(g["loss"] is None for g in got[:-1])
        # every rank holds the counters summed over the ranks
        assert all(g["wire"] == want["wire"] for g in got), step
        for r in range(s):
            _equal_trees(got[r]["grads"],
                         _stage_tree(want["grads"], r, s, v),
                         f"{name} step {step} rank {r} grads")
            _equal_trees(got[r]["params"],
                         _stage_tree(want["params"], r, s, v),
                         f"{name} step {step} rank {r} params")
            for key, buf in want["state"].items():
                assert torch.equal(got[r]["state"][key], buf[r]), \
                    (step, key, r)


def test_lm_rank_step_under_the_clip_stays_in_its_bound(runs):
    """The launcher's ``grad_clip=1.0``: step 1's gradients are bitwise
    the one-process ones, and only the gathered norm parts from the
    one-process norm, in its last bits; the params it updates part by a
    rounding, and step 2 runs from them.  The bounds are the module
    doc's."""
    s, v = LM[LM_CLIP][3], LM[LM_CLIP][4]
    ranks = _rank_records(runs, "lm", LM_CLIP, s)
    want = runs["one"]["lm"][LM_CLIP]
    for r in range(s):
        _equal_trees(ranks[r][0]["grads"],
                     _stage_tree(want[0]["grads"], r, s, v), f"rank {r}")
    for step, norm_rtol in enumerate((CLIP_NORM_RTOL, CLIP_NORM2_RTOL)):
        norms = [r[step]["norm"] for r in ranks]
        assert all(torch.equal(n, norms[0]) for n in norms)
        ref = float(want[step]["norm"])
        assert ref > 1.0                            # the clip acts
        gap = abs(float(norms[0]) - ref) / ref
        assert gap <= norm_rtol, (step, gap)
        loss = float(ranks[s - 1][step]["loss"])
        ref = float(want[step]["loss"])
        assert abs(loss - ref) <= CLIP_LOSS_RTOL * abs(ref), (step, loss)
        for r in range(s):
            new = _flat(_stage_tree(want[step]["params"], r, s, v))
            for k, got in _flat(ranks[r][step]["params"]).items():
                gap = ((got.float() - new[k].float()).abs().max()
                       / new[k].float().abs().max())
                assert gap <= CLIP_PARAM_RTOL, (step, r, k, float(gap))


def _flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


def test_stage_params_and_rows_are_the_one_process_slices():
    """A rank's params are its logical stages' slices (chunk k = stage
    k*S + d), the embedding on rank 0 (and the last rank, tied), the
    final norm on the last; its feedback rows are row d of each buffer."""
    from repro_torch.train.steps import stage_params
    from repro_torch.models import transformer
    cfg, pol, opt, params, sched, s, v = lm_setup("q4q8_interleaved_s2")
    stack = transformer.stack_layer_stages(params, s * v)
    for r in range(s):
        mine = stage_params(params, r, s, v)
        assert set(mine) == ({"layers", "embed"} | (
            {"final_norm"} if r == s - 1 else set()))
        for k, a in _flat(mine["layers"]).items():
            full = _flat(stack)[k]
            for c in range(v):
                assert torch.equal(a[c], full[c * s + r])
            assert a.is_contiguous()
    pol = TPOL.aqsgd_policy(0.1)
    full = TP.init_feedback_state(pol, (4,), num_stages=3, batch=6,
                                  num_samples=9, virtual_stages=2)
    row = TP.init_feedback_state(pol, (4,), num_stages=3, batch=6,
                                 num_samples=9, virtual_stages=2, stage=1)
    for d in ("fw", "bw"):
        assert row[d].resid.shape == full[d].resid.shape[1:]
        assert row[d].mirror.shape == full[d].mirror.shape[1:]


@pytest.mark.parametrize("name,v", [("gpipe", None), ("1f1b", None),
                                    ("interleaved", 2), ("interleaved", 3)])
def test_rank_columns_pair_every_send_with_a_receive(name, v):
    """``Schedule.column`` is the plan's valid ticks of one device; the
    output of device d at tick t is the input device d+1 (mod S) takes at
    tick t+1, for the same (logical stage + 1, microbatch): what lets each
    rank post its sends and receives of a tick together."""
    sched = get_schedule(name, v)
    for s in (2, 3, 4):
        for mb in [m for m in range(1, 9) if sched.virtual_stages == 1
                   or m % s == 0]:
            cols = [dict(sched.column(d, mb, s)) for d in range(s)]
            for d in range(s):
                assert list(cols[d]) == sorted(cols[d])
                for t, p in cols[d].items():
                    assert p == sched.plan(t, d, mb, s) and p.valid
                    lg = p.k * s + d
                    if p.last:
                        continue
                    q = cols[(d + 1) % s][t + 1]
                    assert (q.k * s + (d + 1) % s, q.j) == (lg + 1, p.j)
                    assert not q.inject
            pairs = sum(len(c) for c in cols) - mb
            assert pairs == mb * sched.wire_cuts(s)


# ---------------------------------------------------------------------------
# the launcher and the refusals
# ---------------------------------------------------------------------------

LAUNCH = ["--arch", "gpt2-small", "--smoke", "--device", "cpu", "--steps",
          "2", "--batch", "4", "--seq", "32", "--log-every", "1",
          "--transport", "pipeline", "--stages", "2", "--schedule", "1f1b",
          "--pipeline-microbatches", "2", "--policy", "q4q8"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def test_launcher_under_torchrun_prints_the_one_process_run(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-addr", "127.0.0.1", "--master-port",
         str(_free_port()), "-m", "repro_torch.launch.train", *LAUNCH,
         "--dist-backend", "gloo", "--json", str(tmp_path / "m.json")],
        env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    from repro_torch.launch import train as ttrain
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert ttrain.main(LAUNCH) == 0
    want = _json_lines(buf.getvalue())
    got = _json_lines(proc.stdout)
    keys = ("step", "loss", "ppl", "fw_bytes", "bw_bytes")
    got, want = ([{k: r[k] for k in keys} for r in rs] for rs in (got, want))
    # step 1 bitwise (its ppl is the exp of the unrounded loss); step 2
    # runs from params the clip's gathered norm may have moved by a
    # rounding: its rounded loss bitwise, its ppl within LAUNCH_PPL_RTOL
    assert len(got) == len(want) == 2 and got[0] == want[0]
    assert [(r["step"], r["loss"], r["fw_bytes"], r["bw_bytes"])
            for r in got] == \
        [(r["step"], r["loss"], r["fw_bytes"], r["bw_bytes"]) for r in want]
    assert abs(got[1]["ppl"] - want[1]["ppl"]) <= \
        LAUNCH_PPL_RTOL * want[1]["ppl"]
    assert json.loads((tmp_path / "m.json").read_text())[0]["loss"] == \
        want[0]["loss"]
    assert "stages as ranks: 2 ranks, backend gloo" in proc.stdout


@pytest.mark.parametrize("extra,match", [
    (["--dp", "2"], "DP ring across ranks"),
    (["--ckpt", "x.npz"], "--ckpt"),
    (["--trace", "t.jsonl"], "telemetry"),
    (["--metrics", "1"], "telemetry"),
])
def test_launcher_refuses_what_ranks_do_not_carry(extra, match, monkeypatch,
                                                  capsys):
    from repro_torch.launch import train as ttrain
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit):
        ttrain.main([*LAUNCH, "--dist-backend", "gloo", *extra])
    assert match in capsys.readouterr().err


@pytest.mark.parametrize("argv,match", [
    (["--transport", "simulated"], "--transport pipeline"),
    (["--mesh", "data=2,stage=2"], "DP ring across ranks"),
    (["--mesh", "stage=2,tensor=2"], "tensor ring across ranks"),
    (["--mesh", "stage=2", "--wire", "stage=q4@size>=4096;q8"],
     "rule specs"),
])
def test_launcher_refuses_other_axes(argv, match, monkeypatch, capsys):
    from repro_torch.launch import train as ttrain
    base = ["--arch", "gpt2-small", "--smoke", "--device", "cpu",
            "--steps", "1", "--batch", "8", "--seq", "32"]
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit):
        ttrain.main([*base, *argv, "--dist-backend", "gloo"])
    assert match in capsys.readouterr().err


def test_world_size_other_than_the_stages_raises(monkeypatch, capsys):
    from repro_torch.launch import train as ttrain
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(SystemExit):
        ttrain.main([*LAUNCH, "--dist-backend", "gloo"])
    assert "world size 4 must equal the stage count 2" in \
        capsys.readouterr().err
    monkeypatch.delenv("RANK")
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(SystemExit):
        ttrain.main([*LAUNCH, "--dist-backend", "gloo"])
    assert "torch.distributed.run" in capsys.readouterr().err


def test_nccl_with_two_ranks_on_one_card_raises(monkeypatch):
    """Refused before any process group is made, with the reason."""
    import torch.distributed as dist
    from repro_torch.transport.p2p import StageGroup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for rank in (0, 1):
        with pytest.raises(ValueError, match="two ranks on one card"):
            StageGroup(rank, 2, "nccl")
    with pytest.raises(ValueError, match="two ranks on one card"):
        StageGroup(1, 2, "nccl", device="cuda:0")
    with pytest.raises(ValueError, match="sends from cards"):
        StageGroup(0, 2, "nccl", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        StageGroup(0, 2, "mpi", device="cpu")
    assert not dist.is_initialized()


class _GroupMade(Exception):
    pass


def test_nccl_ranks_take_their_card_from_the_local_rank(monkeypatch):
    """Two nodes of 4 cards, 8 ranks: each rank's card is its local rank's,
    and no rank is refused; two local ranks on a 1-card node still are."""
    import torch.distributed as dist
    from repro_torch.transport import p2p
    made, cards = [], []

    def init_process_group(*a, **kw):
        made.append(kw["rank"])
        raise _GroupMade

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", cards.append)
    monkeypatch.setattr(p2p.dist, "init_process_group", init_process_group)
    for rank in range(8):
        with pytest.raises(_GroupMade):
            p2p.StageGroup(rank, 8, "nccl", local_rank=rank % 4,
                           local_world=4)
    assert made == list(range(8))
    assert cards == [torch.device("cuda", r % 4) for r in range(8)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="two ranks on one card"):
        p2p.StageGroup(5, 8, "nccl", local_rank=1, local_world=2)
    with pytest.raises(ValueError, match="two ranks on one card"):
        p2p.StageGroup(4, 8, "nccl", device="cuda:0", local_rank=1,
                       local_world=2)
    assert made == list(range(8)) and not dist.is_initialized()


def test_mismatched_groups_are_refused(tmp_path):
    """A step whose group is not one rank a stage, or a rank handed the
    whole stage-stacked buffers, raises."""
    from repro_torch.train import steps as TS
    from repro_torch.transport.p2p import StageGroup
    with StageGroup(0, 1, "gloo", device="cpu",
                    init_method=f"file://{tmp_path / 'store'}") as group:
        cfg, pol, opt, params, sched, s, v = lm_setup("q4q8_gpipe")
        with pytest.raises(ValueError, match="one rank a stage"):
            TS.make_lm_train_step(cfg, pol, opt, transport="pipeline",
                                  group=group)
        with pytest.raises(ValueError, match="transport='pipeline'"):
            TS.make_lm_train_step(cfg, pol, opt, group=group)
        with pytest.raises(ValueError, match="2 stages or more"):
            TP.pipeline_apply_rank(toy_stage, torch.zeros(1, 4, 4),
                                   torch.zeros(4, 4), group=group,
                                   num_stages=1,
                                   policy=toy_policy("none"))
        st = TP.init_feedback_state(toy_policy("ef"), (4,), num_stages=1,
                                    batch=4)
        with pytest.raises(ValueError, match="stage=rank"):
            TP._check_rank_rows(st["fw"], "fw_state", 1, 1)
