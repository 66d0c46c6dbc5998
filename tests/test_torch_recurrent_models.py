"""rwkv6-3b and hymba-1.5b through the port's blocks, model, train steps,
static engine and launchers, against the JAX package.

Smoke configs: rwkv6 2 layers, d 256, 16 heads of 16 (``ssm_state``
holds the head size), LayerNorm, tied head; hymba 2 layers, d 256, 4
attention heads of 64 over 2 KV heads with a 16-token window beside 2
SSD heads of state 16, RMSNorm, SwiGLU.  Reference params carried over
through numpy.

Bounds (bf16 activations in both; nothing model-level is bitwise), those
of tests/test_torch_archs.py, each measured value beside it:
  * a block's output within ``BLOCK_RTOL`` = 2**-5 of its largest
    magnitude (measured at most 0.50%), its f32 state within
    ``STATE_RTOL`` = 1e-3 (rwkv6's S 9.4e-5, hymba's SSD state 2.9e-7),
    its bf16 token-shift rows and K/V rows within 2**-5 (at most 0.52%),
    after a prefill of 45 tokens (a padded chunk) and after one decode
    step from it; the block's backward (the reference's ``jax.vjp``
    jitted), the input's gradient and each param leaf's within 2**-5 of
    its norm (at most 1.5%);
  * eval loss within ``LOSS_ATOL`` = 2e-3 (at most 3.7e-4), logits within
    ``LOGIT_RTOL`` = 2**-5 of their largest magnitude (at most 2.62%);
  * one simulated q4q8 step (the launcher's preset, capped at the smoke
    model's 2 groups: one cut; the reference on ``KERNEL_BACKEND =
    "pallas"``): loss within ``STEP_LOSS_ATOL`` = 0.05 (4.1e-4), the
    gradient tree within ``GRAD_RTOL`` = 0.3 of its norm (0.261, hymba);
  * ``grad_accum=2`` without compression: loss within 2e-3 (3.7e-4), the
    gradient tree within 0.3 (0.146, hymba);
  * a gpipe pipeline step (2 stages, 2 microbatches) and a DP q8 step (2
    lanes) against the reference run in one subprocess under ``jax.jit``
    (as tests/test_torch_pipeline.py and test_torch_train_dp.py run it):
    loss within 2e-3 and 0.02 (at most 3.6e-4), the gradient tree within
    0.3 and 0.1 of its norm (at most 0.085).
These models are chaotic at random init, their gradients most: in the
reference alone, one bf16 ulp added to every embedding weight moves the
smoke models' step gradient by 0.11 (rwkv6) and 0.44 (hymba) of its norm
uncompressed, and by 0.40 and 1.13 under q4q8, where a code of the cut
flips.  So the compressed cases with accumulation or the pipeline part
from the reference beyond 0.3 (measured 0.59 and 0.48 with accumulation,
0.60 and 0.30 on the pipeline, under q4q8) and are held uncompressed
here; the codecs' bits are held elsewhere, and the blocks' backward
above.  Where the reference's graph rounds each op in bf16
(``jax.nn.sigmoid`` / ``silu`` as 1 / (1 + exp(-x))), the port does the
same (``blocks._sigmoid``).

Serving: prefill of S tokens then n decode steps equals a forward pass
over S + n tokens, in each package (logits within 2**-5: the decode step
reads the carried state, a dropped write moves the logits by ~60%); the
static engine's greedy streams on equal-length prompts of 45 tokens (a
padded chunk; hymba's ring wraps) equal the reference's, cuts pinned
row by row, except a parting at a near-tie (tests/test_torch_serve_
continuous.py's rule).  Every refusal raises the reference's exception
type with its message; the npz format carries both trees both ways,
bit for bit; both launchers run on the CPU.
"""
import dataclasses
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

import repro.core.compressors as JCC
import repro.models.blocks as JB
import repro.models.transformer as JT
import repro.serve.engine as JE
import repro.serve.speculative as JSP
import repro.train.steps as JS
from repro.checkpoint import io as JIO
from repro.configs.registry import get as jget
from repro.core.boundary import init_boundary_state as jinit
from repro.launch.train import POLICIES as JPOL
from repro.optim import optimizers as JO

import repro_torch.models.blocks as TB
import repro_torch.models.transformer as TT
import repro_torch.serve.speculative as TSP
import repro_torch.train.steps as TS
from repro_torch.checkpoint import io as TIO
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.registry import get as tget
from repro_torch.core.boundary import init_boundary_state as tinit
from repro_torch.core.parallel import AxisSpec, ParallelSpec
from repro_torch.core.policy import NO_POLICY, POLICIES as TPOL
from repro_torch.optim import optimizers as TO
from repro_torch.serve.engine import ContinuousEngine, Request, ServeEngine
from repro_torch.train.loop import _pipeline_bstates

from test_torch_attention_variants import _reference_static
from test_torch_checkpoint import _assert_same
from test_torch_serve_continuous import PinnedRows, _assert_streams

# One intra-op thread: the suite runs in several worker processes at
# once, and a torch thread pool per worker that outnumbers the cores
# slows its CPU ops by an order of magnitude.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RWKV, HYMBA = "rwkv6-3b", "hymba-1.5b"
ARCHS = (RWKV, HYMBA)
B, S = 4, 32
BLOCK_RTOL = 2.0 ** -5
STATE_RTOL = 1e-3
LOSS_ATOL = 2e-3
LOGIT_RTOL = 2.0 ** -5
STEP_LOSS_ATOL = 0.05
GRAD_RTOL = 0.3
DP_LOSS_ATOL = 0.02
DP_GRAD_RTOL = 0.1
OPT = dict(kind="adamw", lr=1e-3, weight_decay=0.01, schedule="cosine",
           t_max=5, grad_clip=1.0)
PROMPT, NEW = 45, 16


def _pair(arch):
    jcfg, tcfg = jget(arch, smoke=True), tget(arch, smoke=True)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                             "cpu")


@pytest.fixture(scope="module")
def models():
    return {arch: _pair(arch) for arch in ARCHS}


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _gap(got, want):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rel(got, want):
    got = np.concatenate([np.ravel(a) for a in got]).astype(np.float64)
    want = np.concatenate([np.ravel(a) for a in want]).astype(np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _tree_rel(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w)
    return _rel([_f32(g[n]) for n in sorted(g)],
                [_f32(w[n]) for n in sorted(g)])


# ---------------------------------------------------------------------------
# config, params, blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_config_and_param_layout(arch, models):
    """``check_supported`` passes; ``init_params`` builds the reference's
    tree leaf for leaf (names, shapes, dtypes); the leaves that are not
    random (rwkv's decay base ``w0``, hymba's ``a_log``) within one f32
    ulp of the reference's, the constant leaves equal."""
    jcfg, tcfg, jp, _ = models[arch]
    TT.check_supported(tcfg)
    kind = "rwkv" if arch == RWKV else "hymba"
    assert tcfg.layer_kinds() == jcfg.layer_kinds() == (kind,)
    own = dict(_leaves(TT.init_params(torch.Generator().manual_seed(0),
                                      tcfg)))
    ref = dict(_leaves(jp))
    assert sorted(own) == sorted(ref)
    for n in ref:
        assert tuple(own[n].shape) == ref[n].shape, n
        assert str(own[n].dtype).split(".")[-1] == str(ref[n].dtype), n
    fixed = (("tm/w0",) if arch == RWKV else ("ssm/a_log",))
    const = (("tm/mu_x", "tm/mu", "tm/gn_scale", "tm/gn_bias", "cm/mu_k",
              "cm/mu_r") if arch == RWKV else ("ssm/dt_bias", "ssm/d_skip"))
    for leaf in fixed + const:
        name = f"/layers/b0/{leaf}"
        a = np.asarray(ref[name], np.float32).view(np.int32).astype(np.int64)
        b = own[name].numpy().view(np.int32).astype(np.int64)
        assert np.abs(a - b).max() <= (1 if leaf in fixed else 0), name


def _one_group(jp, tp, g=0):
    return (jax.tree.map(lambda a: a[g], jp["layers"]["b0"]),
            TT._group(tp["layers"], g)["b0"])


def _block_input(cfg, seed, s=PROMPT):
    x = np.random.RandomState(seed).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    return (jnp.asarray(x).astype(jnp.bfloat16),
            torch.from_numpy(x).to(torch.bfloat16))


@pytest.mark.parametrize("arch", ARCHS)
def test_blocks_match_reference(arch, models):
    """One block on the same bf16 input (the reference's calls jitted):
    the training forward, the prefill's output and cache (45 tokens: a
    padded chunk; hymba's ring of 16 rows wraps), then one decode step
    from that cache: output and the new cache, written in place into the
    port's cache."""
    jcfg, tcfg, jp, tp = models[arch]
    kind = jcfg.layer_kinds()[0]
    jg, tg = _one_group(jp, tp)
    jx, tx = _block_input(jcfg, 2)
    with torch.no_grad():
        ty, taux = TB.block_train(tg, tx, tcfg, kind)
        tyc, tc = TB.block_prefill(tg, tx, tcfg, kind, cache_len=64)
    jy, jaux = jax.jit(lambda p, x: JB.block_train(p, x, jcfg, kind))(jg, jx)
    jyc, jc, _ = jax.jit(lambda p, x: JB.block_prefill(
        p, x, jcfg, kind, cache_len=64))(jg, jx)
    assert float(taux) == float(jaux) == 0.0
    assert _gap(ty, jy) <= BLOCK_RTOL and torch.equal(ty, tyc)
    assert sorted(tc) == sorted(jc)

    def check_cache(got, want):
        for k in want:
            assert got[k].dtype == params_from_numpy(
                np.asarray(want[k])[:0], "cpu").dtype, k
            rtol = STATE_RTOL if k in ("S", "ssm") else BLOCK_RTOL
            assert _gap(got[k], want[k]) <= rtol, k

    check_cache(tc, jc)
    jx1, tx1 = _block_input(jcfg, 3, 1)
    held = dict(tc)
    with torch.no_grad():
        ty1, tc1 = TB.block_decode(tg, tx1, tc, PROMPT, tcfg, kind)
    jy1, jc1 = jax.jit(lambda p, x, c: JB.block_decode(
        p, x, c, PROMPT, jcfg, kind))(jg, jx1, jc)
    assert _gap(ty1, jy1) <= BLOCK_RTOL
    assert all(tc1[k] is held[k] for k in held)          # in place
    check_cache(tc1, jc1)


def _requires_grad(tree):
    if isinstance(tree, dict):
        return {k: _requires_grad(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_()


@pytest.mark.parametrize("arch", ARCHS)
def test_block_gradients_match_reference(arch, models):
    """The block's backward on the same input and cotangent: the input's
    gradient within ``BLOCK_RTOL`` of its norm and every param leaf's
    within ``BLOCK_RTOL`` of its own (measured at most 1.5%): the
    model-level gradients part further only through the models' own
    sensitivity (module doc)."""
    jcfg, tcfg, jp, tp = models[arch]
    kind = jcfg.layer_kinds()[0]
    jg, tg = _one_group(jp, tp)
    jx, tx = _block_input(jcfg, 2)
    jct, tct = _block_input(jcfg, 4)
    jgp, jgx = jax.jit(lambda p, x, ct: jax.vjp(
        lambda p, x: JB.block_train(p, x, jcfg, kind)[0], p, x)[1](ct))(
        jg, jx, jct)
    tp_ = _requires_grad(tg)
    tx = tx.requires_grad_()
    TB.block_train(tp_, tx, tcfg, kind)[0].backward(tct)
    assert _rel([_f32(tx.grad)], [_f32(jgx)]) <= BLOCK_RTOL
    want = dict(_leaves(jgp))
    got = dict(_leaves(tp_))
    assert sorted(got) == sorted(want)
    for n in want:
        assert _rel([_f32(got[n].grad)], [_f32(want[n])]) <= BLOCK_RTOL, n


@pytest.mark.parametrize("arch", ARCHS)
def test_eval_loss_and_logits_match_reference(arch, models):
    from repro.core.policy import NO_POLICY as JNONE
    jcfg, tcfg, jp, tp = models[arch]
    toks = np.random.RandomState(1).randint(0, jcfg.vocab_size, (B, S))
    want = JS.make_lm_eval_step(jcfg, JNONE, True)(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    got = TS.make_lm_eval_step(tcfg, NO_POLICY, True)(
        tp, {"tokens": torch.from_numpy(toks)})
    assert abs(float(got) - float(want)) <= LOSS_ATOL, (got, want)
    jl = JT.forward_eval(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    with torch.no_grad():
        tl = TT.forward_eval(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert tuple(tl.shape) == (B, S, jcfg.vocab_size)
    assert _gap(tl, jl) <= LOGIT_RTOL


# ---------------------------------------------------------------------------
# training: simulated cuts (and grad_accum), the pipeline, DP
# ---------------------------------------------------------------------------

def _sim_steps(arch, pname, accum, models, monkeypatch):
    """One simulated-cut step of each package on the same batch, the
    optimizer swapped for one that hands back the gradient."""
    jcfg, tcfg, jp, tp = models[arch]
    grads_out = lambda opt, p, g, s, **kw: (g, s)  # noqa: E731
    monkeypatch.setattr(JS, "apply_updates", grads_out)
    monkeypatch.setattr(TS, "apply_updates", grads_out)
    monkeypatch.setattr(JCC, "KERNEL_BACKEND", "pallas")
    jpol, tpol = JPOL[pname](), TPOL[pname]()
    cuts = len(TT.segment_bounds(tcfg.num_groups, tpol.num_stages)) - 1
    assert cuts == (pname != "none")      # "none" is one stage
    toks = np.random.RandomState(1).randint(0, jcfg.vocab_size, (B, S))
    jopt, topt = JO.OptimizerConfig(**OPT), TO.OptimizerConfig(**OPT)
    jg, _, _, jm = JS.make_lm_train_step(
        jcfg, jpol, jopt, donate=False, grad_accum=accum)(
        jp, JO.init_opt_state(jopt, jp),
        [jinit(jpol.at(i), (S, jcfg.d_model), batch=B, dtype=jnp.bfloat16)
         for i in range(cuts)],
        {"tokens": jnp.asarray(toks, jnp.int32)}, jnp.arange(B))
    tg, _, _, tm = TS.make_lm_train_step(tcfg, tpol, topt,
                                         grad_accum=accum)(
        tp, TO.init_opt_state(topt, tp),
        [tinit(tpol.at(i), (S, tcfg.d_model), batch=B,
               dtype=torch.bfloat16) for i in range(cuts)],
        {"tokens": torch.from_numpy(toks)}, torch.arange(B))
    assert np.isfinite(float(tm["loss"]))
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    return float(tm["loss"]) - float(jm["loss"]), _tree_rel(tg, jg)


@pytest.mark.parametrize("arch", ARCHS)
def test_q4q8_train_step_matches_reference(arch, models, monkeypatch):
    loss_gap, grad_gap = _sim_steps(arch, "q4q8", 1, models, monkeypatch)
    assert abs(loss_gap) <= STEP_LOSS_ATOL and grad_gap <= GRAD_RTOL


@pytest.mark.parametrize("arch", ARCHS)
def test_grad_accumulation_matches_reference(arch, models, monkeypatch):
    """``grad_accum=2`` (two pieces of 2) without compression: the loss
    within ``LOSS_ATOL``, the gradient tree within ``GRAD_RTOL``."""
    loss_gap, grad_gap = _sim_steps(arch, "none", 2, models, monkeypatch)
    assert abs(loss_gap) <= LOSS_ATOL and grad_gap <= GRAD_RTOL


# case -> (arch, transport)
REF_CASES = {"rwkv_gpipe": (RWKV, "pipeline"),
             "hymba_gpipe": (HYMBA, "pipeline"),
             "rwkv_dp_q8": (RWKV, "dp"), "hymba_dp_q8": (HYMBA, "dp")}
MB, DP = 2, 2


def ref_inputs(vocab):
    rng = np.random.RandomState(4)
    return rng.randint(0, vocab, (B, S)), np.arange(B, dtype=np.int32)


REFERENCE = r'''
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
import repro.train.steps as JS
import repro.models.transformer as JT
from repro.configs.registry import get
from repro.core.boundary import init_boundary_state
from repro.core.policy import CompressionPolicy
from repro.launch.train import POLICIES
from repro.optim import optimizers as JO
from repro.train.loop import _pipeline_bstates, init_lm_dp_state
sys.path.insert(0, sys.argv[2])
import test_torch_recurrent_models as T

out = {}
JS.apply_updates = lambda opt, p, g, s: (g, s)
opt = JO.OptimizerConfig(kind="sgd", lr=0.1)
mesh = Mesh(np.array(jax.devices()[:2]), ("stage",))
for name, (arch, transport) in T.REF_CASES.items():
    cfg = get(arch, smoke=True)
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    toks, ids = T.ref_inputs(cfg.vocab_size)
    batch = {"tokens": jnp.asarray(toks, jnp.int32)}
    if transport == "pipeline":
        pol = CompressionPolicy(num_stages=2,
                                boundary=POLICIES["none"]().boundary)
        st = _pipeline_bstates(pol, (T.S, cfg.d_model), batch=T.B,
                               microbatches=T.MB, num_samples=T.B,
                               dtype=jnp.bfloat16)
        step = JS.make_lm_train_step(cfg, pol, opt, transport="pipeline",
                                     mesh=mesh, pipeline_microbatches=T.MB,
                                     donate=False)
        g, _, _, m = step(params, JO.init_opt_state(opt, params), st, batch,
                          jnp.asarray(ids))
    else:
        pol = CompressionPolicy(num_stages=2,
                                boundary=POLICIES["none"]().boundary)
        bst = [init_boundary_state(pol.at(0), (T.S, cfg.d_model),
                                   batch=T.B, dtype=jnp.bfloat16)]
        step = JS.make_lm_train_step(cfg, pol, opt, dp=T.DP, dp_codec="q8",
                                     donate=False)
        dst = init_lm_dp_state(cfg, params, pol, T.DP, "none")
        g, _, _, _, m = step(params, JO.init_opt_state(opt, params), bst,
                             batch, jnp.asarray(ids), dst)
    out[f"{name}/loss"] = np.float32(m["loss"])
    for path, leaf in jax.tree_util.tree_flatten_with_path(g)[0]:
        key = "/".join(str(p.key) for p in path)
        out[f"{name}/grad/{key}"] = np.asarray(
            jnp.asarray(leaf, jnp.float32))
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("recurrent_ref") / "ref.npz"
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


@pytest.mark.parametrize("name", list(REF_CASES))
def test_pipeline_and_dp_steps_match_reference(name, ref, models,
                                               monkeypatch):
    arch, transport = REF_CASES[name]
    _, tcfg, _, tp = models[arch]
    monkeypatch.setattr(TS, "apply_updates",
                        lambda opt, p, g, s, **kw: (g, s))
    opt = TO.OptimizerConfig(kind="sgd", lr=0.1)
    toks, ids = ref_inputs(tcfg.vocab_size)
    batch = {"tokens": torch.from_numpy(toks)}
    if transport == "pipeline":
        pol = dataclasses.replace(TPOL["none"](), num_stages=2)
        st = _pipeline_bstates(pol, (S, tcfg.d_model), batch=B,
                               microbatches=MB, num_samples=B,
                               dtype=torch.bfloat16)
        step = TS.make_lm_train_step(tcfg, pol, opt, transport="pipeline",
                                     pipeline_microbatches=MB)
        g, _, _, m = step(tp, TO.init_opt_state(opt, tp), st, batch,
                          torch.from_numpy(ids))
        assert m["wire"]["fw_hops"] == m["wire"]["bw_hops"] == MB
        rtol, atol = GRAD_RTOL, LOSS_ATOL
    else:
        from repro_torch.train.loop import init_lm_dp_state
        pol = dataclasses.replace(TPOL["none"](), num_stages=2)
        spec = ParallelSpec({"data": AxisSpec(size=DP, codec="q8")})
        step = TS.make_lm_train_step(tcfg, pol, opt, parallel=spec)
        bst = [tinit(pol.at(0), (S, tcfg.d_model), batch=B,
                     dtype=torch.bfloat16)]
        g, _, _, _, m = step(tp, TO.init_opt_state(opt, tp), bst, batch,
                             torch.from_numpy(ids),
                             init_lm_dp_state(tcfg, tp, pol, DP))
        assert m["wire"]["dp_hops"] == DP * (DP - 1)
        rtol, atol = DP_GRAD_RTOL, DP_LOSS_ATOL
    assert abs(float(m["loss"]) - float(ref[f"{name}/loss"])) <= atol
    got = dict(_leaves(g))
    assert _rel([_f32(got[n]) for n in sorted(got)],
                [ref[f"{name}/grad{n}"] for n in sorted(got)]) <= rtol


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _prefill_decode(mod, params, cfg, toks, s, asarray):
    """Logits of a prefill of ``toks[:, :s]`` and of decode steps over
    the rest, (B, T - s + 1, V) f32."""
    logits, caches = mod.prefill(params, {"tokens": asarray(toks[:, :s])},
                                 cfg, cache_len=toks.shape[1])
    outs = [_f32(logits[:, 0])]
    for i in range(s, toks.shape[1]):
        logits, caches = mod.decode_step(params, asarray(toks[:, i]), caches,
                                         i, cfg)
        outs.append(_f32(logits))
    return np.stack(outs, axis=1)


def _reference_prefill_decode(jp, cfg, toks, s):
    """:func:`_prefill_decode` of the reference, its prefill and decode
    step jitted (the static engine's way)."""
    logits, caches = jax.jit(lambda t: JT.prefill(
        jp, {"tokens": t}, cfg, cache_len=toks.shape[1]))(
        jnp.asarray(toks[:, :s], jnp.int32))
    decode = jax.jit(lambda t, c, pos: JT.decode_step(jp, t, c, pos, cfg))
    outs = [_f32(logits[:, 0])]
    for i in range(s, toks.shape[1]):
        logits, caches = decode(jnp.asarray(toks[:, i], jnp.int32), caches,
                                jnp.int32(i))
        outs.append(_f32(logits))
    return np.stack(outs, axis=1)


@pytest.mark.parametrize("package", ["port", "reference"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_forward(arch, package, models):
    """Prefill of 37 tokens (a chunk and a padded one), 8 decode steps
    (hymba's ring of 16 wraps): the logits of a forward pass over 45."""
    jcfg, tcfg, jp, tp = models[arch]
    toks = np.random.RandomState(5).randint(0, jcfg.vocab_size,
                                            (2, PROMPT))
    s = PROMPT - 8
    if package == "port":
        with torch.no_grad():
            got = _prefill_decode(TT, tp, tcfg, toks, s, torch.from_numpy)
            want = _f32(TT.forward_eval(tp, {"tokens": torch.from_numpy(
                toks)}, tcfg))
    else:
        got = _reference_prefill_decode(jp, jcfg, toks, s)
        want = _f32(jax.jit(lambda t: JT.forward_eval(
            jp, {"tokens": t}, jcfg))(jnp.asarray(toks)))
    assert _gap(got, want[:, s - 1:]) <= LOGIT_RTOL


@pytest.mark.parametrize("policy", ["none", "q4q8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_static_streams_match_reference(arch, policy, models, monkeypatch):
    """Two equal-length prompts of 45 tokens, 16 new tokens each, through
    the static engine of both packages (the reference's jitted)."""
    jcfg, tcfg, jp, tp = models[arch]
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, jcfg.vocab_size, PROMPT) for _ in range(2)]
    cuts = PinnedRows(monkeypatch, jitted=True)
    want, gaps = _reference_static(jp, jcfg, JPOL[policy](), prompts, NEW)
    eng = ServeEngine(tp, tcfg, TPOL[policy](), max_batch=2, max_seq=64)
    done = eng.generate([Request(p, NEW) for p in prompts])
    _assert_streams({r: d.out for r, d in enumerate(done)}, want, gaps)
    if policy != "none":
        assert cuts.hits > cuts.misses, (cuts.hits, cuts.misses)


# refusal -> (port call, reference call) on (jcfg, tcfg, jp, tp)
REFUSALS = {
    "continuous": (
        lambda m: ContinuousEngine(m[3], m[1], device="cpu"),
        lambda m: JE.ContinuousEngine(m[2], m[0])),
    "speculative draft": (
        lambda m: TSP.DraftWorker(m[3], m[1], device="cpu"),
        lambda m: JSP.DraftWorker(m[2], m[0])),
    "mixed-length static": (
        lambda m: ServeEngine(m[3], m[1], max_seq=64).generate(
            [Request(np.arange(1, 6), 2), Request(np.arange(1, 9), 2)]),
        lambda m: JE.ServeEngine(m[2], m[0], max_seq=64).generate(
            [JE.Request(np.arange(1, 6, dtype=np.int32), 2),
             JE.Request(np.arange(1, 9, dtype=np.int32), 2)])),
    "decode_span": (
        lambda m: TT.decode_span(
            m[3], torch.zeros((1, 2), dtype=torch.long),
            TT.init_caches(m[1], 1, 16, device="cpu"),
            torch.zeros(1, dtype=torch.long), m[1]),
        lambda m: JT.decode_span(
            m[2], jnp.zeros((1, 2), jnp.int32), JT.init_caches(m[0], 1, 16),
            jnp.zeros(1, jnp.int32), m[0])),
    "tensor axis": (
        lambda m: TT.tp_stage_stack_fn(m[1], None),
        lambda m: JT.tp_stage_stack_fn(m[0], None)),
}


@pytest.mark.parametrize("what", list(REFUSALS))
@pytest.mark.parametrize("arch", ARCHS)
def test_refusals_match_reference(arch, what, models):
    port, reference = REFUSALS[what]
    with pytest.raises(ValueError) as want:
        reference(models[arch])
    with pytest.raises(ValueError) as got:
        port(models[arch])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_axis_train_steps_refused(arch, models):
    """The port's TP step and pipeline x TP step raise the reference's
    ``tp_stage_stack_fn`` message when they are built."""
    jcfg, tcfg, _, _ = models[arch]
    with pytest.raises(ValueError) as want:
        JT.tp_stage_stack_fn(jcfg, None)
    opt = TO.OptimizerConfig(kind="sgd", lr=0.1)
    for axes in ({"tensor": 2}, {"stage": 2, "tensor": 2}):
        with pytest.raises(ValueError) as got:
            TS.make_lm_train_step(tcfg, NO_POLICY, opt,
                                  pipeline_microbatches=2,
                                  parallel=ParallelSpec(axes))
        assert str(got.value) == str(want.value), axes


@pytest.mark.parametrize("arch", ARCHS)
def test_npz_carries_both_trees_both_ways(arch, models, tmp_path):
    """f32 leaves stay f32, bf16 ones cross as uint16 views, bit for
    bit, in either direction."""
    _, _, jp, tp = models[arch]
    path = str(tmp_path / "ref.npz")
    JIO.save(path, jp, step=3)
    like = jax.tree.map(lambda a: torch.zeros(
        a.shape, dtype=params_from_numpy(np.asarray(a)[:0], "cpu").dtype),
        jp)
    got, step = TIO.restore_params(path, like)
    assert step == 3
    _assert_same(got, jp)
    path = str(tmp_path / "port.npz")
    TIO.save(path, tp, step=4)
    back, step = JIO.restore_params(path, jp)
    assert step == 4
    _assert_same(tp, back)
    dtypes = {str(np.asarray(a).dtype) for a in jax.tree.leaves(back)}
    assert dtypes == {"float32", "bfloat16"}


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

def _json_lines(out):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_falls_back_to_static(arch, capsys):
    """No ``--engine``: the reference's line, then the static engine."""
    from repro_torch.launch import serve as tserve
    assert tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--policy", "q4q8", "--batch", "2", "--prompt-len",
                        "12", "--new-tokens", "4"]) == 0
    out = capsys.readouterr().out
    kind = "rwkv" if arch == RWKV else "hymba"
    assert (f"# {arch}-smoke: ['{kind}'] cannot mask left-padding -> "
            "static engine") in out
    (rec,) = _json_lines(out)
    assert rec["engine"] == "static" and rec["arch"] == f"{arch}-smoke"


@pytest.mark.parametrize("arch,argv", [
    (RWKV, ["--grad-accum", "2"]),
    (HYMBA, ["--transport", "pipeline", "--stages", "2",
             "--pipeline-microbatches", "2"]),
    (RWKV, ["--mesh", "data=2", "--wire", "data=q8"])])
def test_launch_train_smoke(arch, argv, capsys):
    """``launch/train --arch``: q4q8 steps on the simulated cuts (with
    gradient accumulation), through the pipeline and data-parallel;
    finite losses."""
    from repro_torch.launch import train as ttrain
    assert ttrain.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--steps", "2", "--batch", "4", "--seq", "32",
                        "--policy", "q4q8", "--log-every", "1", *argv]) == 0
    recs = _json_lines(capsys.readouterr().out)
    assert len(recs) == 2
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert ("fw_bytes" in recs[0]) == ("pipeline" in argv)
    assert ("dp_bytes" in recs[0]) == ("--mesh" in argv)
