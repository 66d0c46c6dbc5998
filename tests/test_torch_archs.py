"""The registry archs that no other test names, against the JAX package:
granite-8b, glm4-9b and starcoder2-7b at their smoke configs (2 layer
groups, d=256; granite and glm4 SwiGLU + RMSNorm, starcoder2 GELU +
LayerNorm), gemma2-27b (2 local/global groups, window 16, softcaps 50
and 30, post-norm, tied head), pixtral-12b (2 layers, untied head, 8
patch embeddings in the batch, drawn from a seed), mixtral-8x7b (2 MoE
layers, 4 experts top-2, window 16) and llama4-maverick-400b-a17b (2
dense/MoE groups, 4 experts top-1 and a shared expert), reference params
carried over through numpy, batch 4, seq 32.

The MoE archs run with the reference's routing pinned into the port
(``test_torch_moe.pin_reference_routing``): a token routes apart only
at a near-tie, whose margin is printed (``-s``) and held under the
call's cross-package noise.  Measured: eval, llama4 one parting (margin 0.0043
under 0.031), mixtral none; the q4q8 step, past the q4 cut, mixtral 9 and
llama4 3 (margins at most 0.136 under 0.79 and 0.053 under 0.85), each
seen again in the remat's recompute.

Bounds (bf16 activations in both; nothing model-level is bitwise):
  * eval loss within ``LOSS_ATOL`` = 2e-3, the bound of
    tests/test_torch_train.py (measured 1.5e-4, 8.2e-5, 2.4e-4, 3.2e-4
    and 4.5e-5 in the order above);
  * logits within ``LOGIT_RTOL`` = 2**-5 of their largest magnitude, the
    bf16 bound of tests/test_torch_serve.py (measured 0.95%, 0.85%,
    0.66%, 1.54% and 0.93%; gemma2's final softcap rounds its bf16
    logits three times in each package);
  * one simulated q4q8 train step (the launcher's preset: 4 stages,
    capped at the smoke model's 2 groups, so one cut), the optimizer
    swapped for one that hands back the gradient: the loss within
    ``STEP_LOSS_ATOL`` = 0.05 and the gradient tree within
    ``GRAD_RTOL`` = 0.3 of its norm, tests/test_torch_train.py's bounds
    for a compressed step (gemma2 and pixtral measured 3.8e-3 and
    1.7e-3 on the loss, 0.063 and 0.070 on the gradient).  The reference
    runs its kernel path (``KERNEL_BACKEND = "pallas"``).  The step's
    ``aux`` (the MoE load-balance loss, 0 for the dense archs) within
    ``AUX_ATOL`` = 1e-3 of the reference's (mixtral and llama4 measured
    7.6e-4 and 7.8e-4: past the q4 cut the routers see hidden states a
    code step apart), and ``total`` = loss + 0.01 aux.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.core.compressors as JCC
import repro.models.transformer as JT
import repro.train.steps as JS
from repro.configs.registry import get as jget
from repro.core.boundary import init_boundary_state as jinit
from repro.core.policy import NO_POLICY as JNONE
from repro.launch.train import POLICIES as JPOL
from repro.optim import optimizers as JO

import repro_torch.models.transformer as TT
import repro_torch.train.steps as TS
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.registry import get as tget
from repro_torch.core.boundary import init_boundary_state as tinit
from repro_torch.core.policy import NO_POLICY as TNONE
from repro_torch.core.policy import POLICIES as TPOL
from repro_torch.optim import optimizers as TO

from test_torch_moe import pin_reference_routing

# One intra-op thread: the suite runs in several worker processes at
# once, and a torch thread pool per worker that outnumbers the cores
# slows its CPU ops by an order of magnitude.
torch.set_num_threads(1)

ARCHS = ("granite-8b", "glm4-9b", "starcoder2-7b", "gemma2-27b",
         "pixtral-12b", "mixtral-8x7b", "llama4-maverick-400b-a17b")
B, S = 4, 32
LOSS_ATOL = 2e-3
LOGIT_RTOL = 2.0 ** -5
STEP_LOSS_ATOL = 0.05
AUX_ATOL = 1e-3
GRAD_RTOL = 0.3
OPT = dict(kind="adamw", lr=1e-3, weight_decay=0.01, schedule="cosine",
           t_max=5, grad_clip=1.0)


def _pin(cfg, monkeypatch):
    """The reference's routing pinned into the port (MoE archs).  Rows
    are matched within 2**-3: past the q4 cut of the q4q8 step, a code
    that flips moves a token's router probabilities by up to ~0.1 (no
    stream parts here, so every row is its reference row)."""
    if not cfg.num_experts:
        return None
    return pin_reference_routing(monkeypatch, row_tol=2.0 ** -3)


def _report(arch, pin):
    if pin is not None:
        assert pin.hits and not pin.misses, (pin.hits, pin.misses)
        print(f"# {arch}: {pin.hits} routed rows, partings (margin, "
              f"near-tie bound): {pin.partings}")


def _model(arch):
    jcfg, tcfg = jget(arch, smoke=True), tget(arch, smoke=True)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.RandomState(1).randint(0, jcfg.vocab_size, (B, S))
    return jcfg, tcfg, jp, tp, toks


def _batches(cfg, toks):
    """The same batch for the reference and the port: the tokens, and for
    the vision frontend (B, P, d) bf16 patch embeddings from a seed."""
    jb = {"tokens": jnp.asarray(toks, jnp.int32)}
    tb = {"tokens": torch.from_numpy(toks)}
    if cfg.frontend == "vision":
        pe = np.random.RandomState(2).standard_normal(
            (toks.shape[0], cfg.num_patches, cfg.d_model)).astype(np.float32)
        jb["patch_embeds"] = jnp.asarray(pe).astype(jnp.bfloat16)
        tb["patch_embeds"] = torch.from_numpy(pe).to(torch.bfloat16)
    return jb, tb


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


@pytest.mark.parametrize("arch", ARCHS)
def test_eval_loss_and_logits_match_reference(arch, monkeypatch):
    jcfg, tcfg, jp, tp, toks = _model(arch)
    pin = _pin(jcfg, monkeypatch)
    assert tcfg.arch_id == jcfg.arch_id
    TT.check_supported(tcfg)
    jb, tb = _batches(jcfg, toks)
    want = JS.make_lm_eval_step(jcfg, JNONE, True)(jp, jb)
    got = TS.make_lm_eval_step(tcfg, TNONE, True)(tp, tb)
    assert abs(float(got) - float(want)) <= LOSS_ATOL, (got, want)
    jl = _f32(JT.forward_eval(jp, jb, jcfg))
    with torch.no_grad():
        tl = _f32(TT.forward_eval(tp, tb, tcfg))
    assert tl.shape == jl.shape == (B, S, jcfg.vocab_size)
    gap = float(np.abs(tl - jl).max())
    assert gap <= LOGIT_RTOL * float(np.abs(jl).max()), (gap,
                                                         np.abs(jl).max())
    _report(arch, pin)


@pytest.mark.parametrize("arch", ARCHS)
def test_q4q8_train_step_matches_reference(arch, monkeypatch):
    jcfg, tcfg, jp, tp, toks = _model(arch)
    pin = _pin(jcfg, monkeypatch)
    grads_out = lambda opt, p, g, s, **kw: (g, s)  # noqa: E731
    monkeypatch.setattr(JS, "apply_updates", grads_out)
    monkeypatch.setattr(TS, "apply_updates", grads_out)
    monkeypatch.setattr(JCC, "KERNEL_BACKEND", "pallas")
    jpol, tpol = JPOL["q4q8"](), TPOL["q4q8"]()
    jb, tb = _batches(jcfg, toks)
    cuts = len(TT.segment_bounds(tcfg.num_groups, tpol.num_stages)) - 1
    assert cuts == 1
    jst = [jinit(jpol.at(i), (S, jcfg.d_model), batch=B,
                 dtype=jnp.bfloat16) for i in range(cuts)]
    tst = [tinit(tpol.at(i), (S, tcfg.d_model), batch=B,
                 dtype=torch.bfloat16) for i in range(cuts)]
    jopt, topt = JO.OptimizerConfig(**OPT), TO.OptimizerConfig(**OPT)
    jg, _, _, jm = JS.make_lm_train_step(jcfg, jpol, jopt, donate=False)(
        jp, JO.init_opt_state(jopt, jp), jst, jb, jnp.arange(B))
    tg, _, _, tm = TS.make_lm_train_step(tcfg, tpol, topt)(
        tp, TO.init_opt_state(topt, tp), tst, tb, torch.arange(B))
    assert np.isfinite(float(tm["loss"]))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= STEP_LOSS_ATOL
    # the MoE load-balance loss, counted into the total with weight 0.01
    # on the simulated cuts; 0 for the dense archs
    assert abs(float(tm["aux"]) - float(jm["aux"])) <= AUX_ATOL
    assert (float(tm["aux"]) > 0) == bool(jcfg.num_experts)
    assert abs(float(tm["total"]) - float(tm["loss"])
               - 0.01 * float(tm["aux"])) <= 1e-6
    jl, tl = dict(_leaves(jg)), dict(_leaves(tg))
    assert sorted(jl) == sorted(tl)
    got = np.concatenate([_f32(tl[n]).ravel() for n in sorted(tl)])
    want = np.concatenate([_f32(jl[n]).ravel() for n in sorted(tl)])
    assert np.linalg.norm(got - want) <= GRAD_RTOL * np.linalg.norm(want)
    _report(arch, pin)
