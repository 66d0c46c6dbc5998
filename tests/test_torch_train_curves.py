"""Compressed training runs of the port against the JAX package: 5-step
loss curves from the same params and the same synthetic stream.

Model: gpt2-small smoke with ``num_layers=4`` (d=256, so every 4-stage
preset has 3 cuts), batch 4, seq 32, the launch/train AdamW (lr 1e-3,
weight decay 0.01, cosine over the 5 steps, clip 1.0).  The reference
runs its jitted train step on its kernel path (``KERNEL_BACKEND =
"pallas"``, interpret mode): the per-tile quantizer and the block TopK
that the port runs.

Bound: each step's loss within ``CURVE_ATOL`` = 0.05 of the reference's
(about 0.8% of a loss near 6.3).  The curves part for a known reason:
the cut kernels agree bitwise on the same input
(tests/test_torch_kernels.py, tests/test_torch_boundary.py), but a
bf16-rounding difference at a cut's input (0.6% of its largest
magnitude at the first cut) swaps a few TopK entries or moves a code by
one step, and each swap moves the next stage's input by a kept value.
Measured largest gap over the 5 steps: q4q8 0.0070, top10 0.034,
top10reuse 0.018, ef21top10 0.026, aqsgd 0.015.  Without compression
the gap is below 4e-4 (tests/test_torch_train.py).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.core.compressors as JC
import repro.models.transformer as JT
import repro.train.steps as JS
from repro.configs.registry import get as jget
from repro.core import policy as JP
from repro.core.boundary import init_boundary_state as jinit
from repro.launch.train import POLICIES as JPOL
from repro.launch.train import synthetic_stream
from repro.optim import optimizers as JO

import repro_torch.kernels.ops as TKO
import repro_torch.train.steps as TS
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.registry import get as tget
from repro_torch.core import policy as TP
from repro_torch.core.boundary import init_boundary_state as tinit
from repro_torch.optim import optimizers as TO

# One intra-op thread: the suite runs in several worker processes at
# once, and a torch thread pool per worker that outnumbers the cores
# slows its CPU ops by an order of magnitude.
torch.set_num_threads(1)

CURVE_ATOL = 0.05
B, S, STEPS, NUM_SAMPLES = 4, 32, 5, 8
OPT = dict(kind="adamw", lr=1e-3, weight_decay=0.01, schedule="cosine",
           t_max=STEPS, grad_clip=1.0)


def policies(name):
    """(reference, port) CompressionPolicy for a launch/train preset, or
    ``aqsgd`` (AQ-SGD + TopK 10% at every cut)."""
    if name == "aqsgd":
        return (JP.CompressionPolicy(4, JP.aqsgd_policy(0.1)),
                TP.CompressionPolicy(4, TP.aqsgd_policy(0.1)))
    return JPOL[name](), TP.POLICIES[name]()


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jget("gpt2-small", smoke=True), num_layers=4)
    tcfg = dataclasses.replace(tget("gpt2-small", smoke=True), num_layers=4)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture
def pallas_reference():
    prev = JC.KERNEL_BACKEND
    JC.KERNEL_BACKEND = "pallas"
    yield
    JC.KERNEL_BACKEND = prev


# C(x) calls per train step: fw and bw at each of the 3 cuts, or the fw
# only where the gradient reuses the forward mask (the CPU counterpart of
# chip_smoke.py's launch counts)
CALLS_PER_STEP = {"q4q8": 6, "top10": 6, "top10reuse": 3, "ef21top10": 6,
                  "aqsgd": 6}


def loss_curves(models, name, monkeypatch):
    """``STEPS`` steps of each package from the same params and stream
    (ids cycle over ``NUM_SAMPLES``, so AQ-SGD rows are revisited)."""
    calls = []

    def counted(op):
        def call(*args):
            calls.append(op.__name__)
            return op(*args)
        return call
    for name_ in ("quant_dequant_op", "topk_block_op"):
        monkeypatch.setattr(TKO, name_, counted(getattr(TKO, name_)))
    jcfg, tcfg, jp, tp = models
    jpol, tpol = policies(name)
    cuts = jpol.num_boundaries
    jb = [jinit(jpol.at(i), (S, jcfg.d_model), batch=B,
                num_samples=NUM_SAMPLES, dtype=jnp.bfloat16)
          for i in range(cuts)]
    tb = [tinit(tpol.at(i), (S, tcfg.d_model), batch=B,
                num_samples=NUM_SAMPLES, dtype=torch.bfloat16)
          for i in range(cuts)]
    jopt, topt = JO.OptimizerConfig(**OPT), TO.OptimizerConfig(**OPT)
    jstep = JS.make_lm_train_step(jcfg, jpol, jopt, donate=False)
    tstep = TS.make_lm_train_step(tcfg, tpol, topt)
    jo, to = JO.init_opt_state(jopt, jp), TO.init_opt_state(topt, tp)
    stream = synthetic_stream(jcfg, B, S, 0, num_samples=NUM_SAMPLES)
    jl, tl = [], []
    for _ in range(STEPS):
        toks, ids = next(stream)
        jp, jo, jb, jm = jstep(jp, jo, jb, {"tokens": jnp.asarray(toks)},
                               jnp.asarray(ids))
        tp, to, tb, tm = tstep(tp, to, tb,
                               {"tokens": torch.from_numpy(toks).long()},
                               torch.from_numpy(ids))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        assert len(calls) == CALLS_PER_STEP[name], (name, len(calls))
        calls.clear()
    assert len(tb) == len(jb) == cuts
    for t_st, j_st in zip(tb, jb):
        for d in ("fw", "bw"):
            assert tuple(t_st[d].resid.shape) == tuple(j_st[d].resid.shape)
    return np.array(tl), np.array(jl)


@pytest.mark.parametrize("name", ["q4q8", "top10", "top10reuse"])
def test_loss_curve_tracks_reference(models, name, pallas_reference,
                                     monkeypatch):
    got, want = loss_curves(models, name, monkeypatch)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= CURVE_ATOL, (got, want)

