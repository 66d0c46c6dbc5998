"""The port's Mixture-of-Experts FFN (``repro_torch/models/moe.py``)
against the JAX package's ``repro/models/moe.py`` on the same numpy
inputs.

Routing on given f32 logits (``_route``): the dispatch one-hot bitwise,
which fixes every expert choice, capacity drop and slot; the combine
weights within ``COMBINE_ATOL`` = 4 f32 ulps of 1 (the two softmaxes sum
in their own orders; measured 1 ulp of 0.5) and the load-balance aux
within ``AUX_ATOL`` = 1e-6 (measured 1.2e-7).  Cases: top-2 over 4 and 8
experts, top-1 over 128; each asserts its premise, that its smallest
top-k margin is above ``MARGIN`` = 2**-16, so that the ulps cannot swap a
choice.  Planted exact ties go to the lower index, and planted overflow
(every token's first choice one expert) drops past the capacity in token
order, after every top-1 choice the top-2 ones.

``moe_apply`` (bf16 activations, f32 router), the capacity path (t = 48
tokens in groups of at most 32: the ``g //= 2`` loop runs, G = 3; and
G = 2 over 8 experts; llama4's top-1 with a shared expert), the dropless
dense path and single-token decode: y within ``REL_TOL`` = 2**-5 of its
largest magnitude (the bf16 bound of tests/test_torch_serve.py; measured
at most 0.0087), aux within ``AUX_ATOL``; the gradients of a scalar loss
in x, the router, the experts and the shared expert against
``jax.grad``, each within ``GRAD_RTOL`` = 2**-5 of its norm (measured at
most 0.012, the router's at s == 1).  The routing margins of the router
logits of these inputs are asserted above ``MARGIN`` as well.

``dispatch_quant`` (int8 codes per (e, G, c) row over d): forward and
backward of ``_QuantDispatch`` within one code step of the reference's,
eager and jitted (the jitted one multiplies by ``f32(1/levels)``,
``ROADMAP.md`` §3); ``moe_apply`` with it on both paths (the dense one
codes straight-through) against the reference's within ``REL_TOL``,
its gradients within ``GRAD_RTOL``; and the reference's own bounds of
tests/test_beyond_paper.py on the port: y within 0.05 of the
unquantized y, the gradient within 0.2, on both paths.

``pin_reference_routing`` (model-level parity with the routing pinned,
each parting a near-tie) serves tests/test_torch_archs.py and
tests/test_torch_moe_models.py; ``moe_init``'s layout is the
reference's leaf for leaf, and the dense archs' seed-0 draws are those
they were before the expert stacks got their slice-by-slice draw.
"""
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as JM

import repro_torch.models.moe as TM
from repro_torch.checkpoint.convert import params_from_numpy

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import RoutingReplay  # noqa: E402  (the repo root's script)

# One intra-op thread: the suite runs in several worker processes at
# once, and a torch thread pool per worker that outnumbers the cores
# slows its CPU ops by an order of magnitude.
torch.set_num_threads(1)

COMBINE_ATOL = 4 * 2.0 ** -23
AUX_ATOL = 1e-6
MARGIN = 2.0 ** -16
REL_TOL = 2.0 ** -5
GRAD_RTOL = 2.0 ** -5
D, FF = 64, 128


def pin_reference_routing(monkeypatch, row_tol=REL_TOL):
    """Model-level MoE parity: the reference's routing pinned into the
    port row by row, each parting a near-tie (``chip_smoke.RoutingReplay``,
    which ``chip_smoke.py`` also uses to pin the port's CPU routing into
    its card run).  The reference's router probabilities and top-k
    choices are recorded call by call (``jax.debug.callback``: under
    ``jax.jit`` and in a remat's recompute too) on both of its routing
    paths (``_route`` and ``_moe_apply_dense``); rows are near within
    ``row_tol`` in probability."""
    pins = RoutingReplay(torch, TM._top_k, row_tol,
                         barrier=jax.effects_barrier)
    orig_route, orig_dense = JM._route, JM._moe_apply_dense

    def record(logits, top_k):
        probs = jax.nn.softmax(logits, axis=-1)
        jax.debug.callback(pins.keep, probs, jax.lax.top_k(probs, top_k)[1])

    def route(logits, top_k, cap, num_experts):
        record(logits, top_k)
        return orig_route(logits, top_k, cap, num_experts)

    def dense(params, x, **kw):
        xt = x.reshape(-1, x.shape[-1])
        record(xt.astype(jnp.float32) @ params["router"], kw["top_k"])
        return orig_dense(params, x, **kw)

    monkeypatch.setattr(JM, "_route", route)
    monkeypatch.setattr(JM, "_moe_apply_dense", dense)
    monkeypatch.setattr(TM, "_top_k", pins.top_k)
    return pins


def _cap(g, top_k, e, cf=1.25):
    return max(top_k, int(math.ceil(cf * g * top_k / e)))


def _margin(logits: np.ndarray, top_k: int) -> float:
    """The smallest gap between a row's k-th and (k+1)-th softmax
    probability."""
    z = logits - logits.max(-1, keepdims=True)
    p = np.exp(z.astype(np.float64))
    p /= p.sum(-1, keepdims=True)
    s = -np.sort(-p, axis=-1)
    return float((s[..., top_k - 1] - s[..., top_k]).min())


def _route_both(logits: np.ndarray, top_k: int, cap: int):
    e = logits.shape[-1]
    jd, jc, ja = JM._route(jnp.asarray(logits), top_k, cap, e)
    td, tc, ta = TM._route(torch.from_numpy(logits), top_k, cap, e)
    return ((np.asarray(jd), np.asarray(jc), float(ja)),
            (td.numpy(), tc.numpy(), float(ta)))


# name -> (G, g, E, top_k)
ROUTE = {"top2_e4": (2, 32, 4, 2), "top2_e8": (2, 32, 8, 2),
         "top1_e128": (3, 64, 128, 1)}


@pytest.mark.parametrize("name", list(ROUTE))
def test_route_matches_reference(name):
    gg, g, e, k = ROUTE[name]
    logits = (np.random.RandomState(len(name)).standard_normal((gg, g, e))
              * 2).astype(np.float32)
    assert _margin(logits, k) > MARGIN
    cap = _cap(g, k, e)
    (jd, jc, ja), (td, tc, ta) = _route_both(logits, k, cap)
    assert td.shape == jd.shape == (gg, g, e, cap)
    np.testing.assert_array_equal(td, jd)
    assert np.abs(tc - jc).max() <= COMBINE_ATOL
    assert abs(ta - ja) <= AUX_ATOL
    # the combine weights sit exactly where the dispatch ones are
    np.testing.assert_array_equal(tc != 0, td != 0)


def test_route_exact_ties_go_to_the_lower_index():
    rows = np.array([[0.0, 0.0, 0.0, 0.0],       # all tie: experts 0, 1
                     [1.0, 3.0, 3.0, 0.0],       # 1 and 2 tie on top
                     [2.0, 1.0, 1.0, 1.0],       # 1, 2, 3 tie for second
                     [0.0, 0.0, 5.0, 5.0]], np.float32)
    logits = np.stack([rows, rows[::-1]])        # (2, 4, 4)
    want = {0: (0, 1), 1: (1, 2), 2: (0, 1), 3: (2, 3)}
    (jd, jc, ja), (td, tc, ta) = _route_both(logits, 2, 8)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tc, jc)
    assert abs(ta - ja) <= AUX_ATOL
    for gi, order in ((0, range(4)), (1, range(3, -1, -1))):
        for t, r in enumerate(order):
            experts = tuple(np.nonzero(td[gi, t].sum(-1))[0])
            assert experts == want[r], (gi, t, experts)
    # an exact tie splits the gate evenly
    assert np.allclose(tc[0, 0].sum(-1)[:2], 0.5)


def test_route_capacity_overflow_drops_in_priority_order():
    """Every token's first choice is expert 2 and its second alternates
    between 0 and 1; capacity 3: tokens 0-2 take expert 2's slots 0-2 and
    the rest of their first choices drop; the second choices fill their
    experts' slots after all the first ones, in token order."""
    g, e, cap = 12, 4, 3
    logits = np.zeros((1, g, e), np.float32)
    logits[0, :, 2] = 8.0
    logits[0, np.arange(g), np.arange(g) % 2] = 4.0
    (jd, jc, ja), (td, tc, ta) = _route_both(logits, 2, cap)
    np.testing.assert_array_equal(td, jd)
    assert np.abs(tc - jc).max() <= COMBINE_ATOL
    assert abs(ta - ja) <= AUX_ATOL
    for t in range(g):
        assert td[0, t, 2].sum() == (1 if t < cap else 0), t
        if t < cap:
            assert td[0, t, 2, t] == 1
        # second choice: expert t % 2, slot t // 2 while under capacity
        second = td[0, t, t % 2]
        if t // 2 < cap:
            assert second[t // 2] == 1 and second.sum() == 1, t
        else:
            assert second.sum() == 0, t
    # a dropped choice keeps no gate
    assert tc[0, cap:, 2].sum() == 0


# name -> (batch, seq, E, top_k, group_size, dropless, shared experts)
APPLY = {
    "capacity_loop_G3": (2, 24, 4, 2, 32, False, 0),
    "capacity_G2_e8": (2, 32, 8, 2, 32, False, 0),
    "capacity_top1_shared": (2, 32, 8, 1, 64, False, 1),
    "dropless": (2, 24, 4, 2, 32, True, 0),
    "decode_s1": (3, 1, 4, 2, 32, False, 0),
}


def _apply_inputs(name):
    b, s, e, k, gs, dropless, shared = APPLY[name]
    seed = sorted(APPLY).index(name)
    jp = JM.moe_init(jax.random.PRNGKey(seed), D, FF, e, "swiglu", shared)
    x = np.random.RandomState(seed).standard_normal((b, s, D)) \
        .astype(np.float32)
    kw = dict(num_experts=e, top_k=k, mlp_kind="swiglu", group_size=gs,
              dropless=dropless)
    return jp, x, kw


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-12))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _both(name, dispatch_quant=False):
    """y, aux and the gradients of mean(y**2) + 0.01 aux in (params, x),
    from the reference and from the port."""
    jp, x, kw = _apply_inputs(name)
    kw = dict(kw, dispatch_quant=dispatch_quant)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    # the premise: the router's f32 logits of these bf16 inputs do not
    # sit on a near-tie
    xt = np.asarray(jx.astype(jnp.float32)).reshape(-1, D)
    assert _margin(xt @ np.asarray(jp["router"]), kw["top_k"]) > MARGIN

    def jloss(p, x):
        y, aux = JM.moe_apply(p, x, **kw)
        return (y.astype(jnp.float32) ** 2).mean() + 0.01 * aux, (y, aux)

    (_, (jy, ja)), jg = jax.value_and_grad(jloss, argnums=(0, 1),
                                           has_aux=True)(jp, jx)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    for _, leaf in _leaves(tp):
        leaf.requires_grad_()
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    ty, ta = TM.moe_apply(tp, tx, **kw)
    ((ty.float() ** 2).mean() + 0.01 * ta).backward()
    tg = ({n: leaf.grad for n, leaf in _leaves(tp)}, tx.grad)
    return (jy, float(ja), (dict(_leaves(jg[0])), jg[1])), \
        (ty, float(ta.detach()), tg)


@pytest.mark.parametrize("name", list(APPLY))
def test_moe_apply_matches_reference(name):
    (jy, ja, (jgp, jgx)), (ty, ta, (tgp, tgx)) = _both(name)
    jy, ty = _f32(jy), _f32(ty)
    assert ty.shape == jy.shape
    assert np.abs(ty - jy).max() <= REL_TOL * np.abs(jy).max()
    assert abs(ta - ja) <= AUX_ATOL
    assert sorted(tgp) == sorted(jgp)
    assert _rel(_f32(tgx), _f32(jgx)) <= GRAD_RTOL
    for n in tgp:
        assert tgp[n] is not None, n
        assert _rel(_f32(tgp[n]), _f32(jgp[n])) <= GRAD_RTOL, n


def test_capacity_groups_and_slots(monkeypatch):
    """``g = min(group_size, t)``, halved while it does not divide t: 48
    tokens in groups of 32 route as 3 groups of 16, each with capacity
    ceil(1.25 * 16 * 2 / 4) = 10 slots an expert."""
    seen = []
    real = TM._route

    def spy(logits, top_k, cap, e):
        seen.append((tuple(logits.shape), cap))
        return real(logits, top_k, cap, e)

    jp, x, kw = _apply_inputs("capacity_loop_G3")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    monkeypatch.setattr(TM, "_route", spy)
    TM.moe_apply(tp, torch.from_numpy(x).to(torch.bfloat16), **kw)
    assert seen == [((3, 16, 4), 10)]


# ---------------------------------------------------------------------------
# dispatch_quant (beyond the paper: int8 expert-dispatch payloads)
# ---------------------------------------------------------------------------

def _code_steps(got, want, x):
    """max |got - want| in units of the code step of x's rows (the last
    dim), after one bf16 rounding of the row's largest magnitude (the
    dequantized payload is rounded to bf16)."""
    span = x.max(-1, keepdims=True) - x.min(-1, keepdims=True)
    step = np.where(span > 0, span / 255.0, 1.0)
    slack = 2.0 ** -8 * np.abs(x).max(-1, keepdims=True)
    return float((np.maximum(np.abs(got - want) - slack, 0) / step).max())


def test_quant_dispatch_within_one_code_step():
    """``_QuantDispatch`` forward and backward against the reference's
    ``_quant_dispatch`` and its ``custom_vjp``, eager and jitted (the
    jitted one scales by ``f32(1/levels)``: measured 1.06 steps before
    the bf16 slack, 0 after; eager measured bitwise)."""
    rng = np.random.RandomState(7)
    t = rng.standard_normal((4, 2, 5, D)).astype(np.float32)
    t[1, 0, 2] = 0.0                      # an empty slot: a constant row
    g = rng.standard_normal(t.shape).astype(np.float32)
    jt, jgt = (jnp.asarray(a).astype(jnp.bfloat16) for a in (t, g))
    ref = lambda a: JM._quant_dispatch(a, (None,) * 4)  # noqa: E731
    jy, vjp = jax.vjp(ref, jt)
    (jb,) = vjp(jgt)
    jy_jit = jax.jit(ref)(jt)
    (jb_jit,) = jax.jit(lambda a, c: jax.vjp(ref, a)[1](c))(jt, jgt)
    tt = torch.from_numpy(t).to(torch.bfloat16).requires_grad_()
    ty = TM._QuantDispatch.apply(tt)
    ty.backward(torch.from_numpy(g).to(torch.bfloat16))
    assert ty.dtype == tt.grad.dtype == torch.bfloat16
    tq, gq = _f32(jt), _f32(jgt)
    ty, tb = _f32(ty), _f32(tt.grad)
    for want, back in ((jy, jb), (jy_jit, jb_jit)):
        assert _code_steps(ty, _f32(want), tq) <= 1.0
        assert _code_steps(tb, _f32(back), gq) <= 1.0
    assert np.all(ty[1, 0, 2] == 0)
    # and within half a step of the uncoded payload
    assert _code_steps(ty, tq, tq) <= 0.5


@pytest.mark.parametrize("name", ["capacity_loop_G3", "dropless"])
def test_dispatch_quant_matches_reference(name):
    (jy, ja, (jgp, jgx)), (ty, ta, (tgp, tgx)) = _both(name, True)
    jy, ty = _f32(jy), _f32(ty)
    assert np.abs(ty - jy).max() <= REL_TOL * np.abs(jy).max()
    assert abs(ta - ja) <= AUX_ATOL
    assert _rel(_f32(tgx), _f32(jgx)) <= GRAD_RTOL
    for n in tgp:
        assert _rel(_f32(tgp[n]), _f32(jgp[n])) <= GRAD_RTOL, n


@pytest.mark.parametrize("name", ["capacity_loop_G3", "dropless"])
def test_dispatch_quant_close_to_unquantized(name):
    """tests/test_beyond_paper.py's bounds, on the port: y within 0.05 of
    the unquantized y (relative to its largest magnitude), the gradient in
    x within 0.2 of its norm, finite."""
    jp, x, kw = _apply_inputs(name)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ys, gs = [], []
    for dq in (False, True):
        tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
        y, aux = TM.moe_apply(tp, tx, dispatch_quant=dq, **kw)
        ((y.float() ** 2).mean() + 0.01 * aux).backward()
        ys.append(_f32(y))
        gs.append(_f32(tx.grad))
    assert np.isfinite(gs[1]).all()
    err = np.abs(ys[0] - ys[1]).max() / (np.abs(ys[0]).max() + 1e-9)
    assert err < 0.05, err
    assert _rel(gs[1], gs[0]) < 0.2


def test_moe_init_layout_matches_reference():
    """The tree the reference's ``moe_init`` builds, leaf for leaf (names,
    shapes, dtypes), with and without the shared expert; the expert stacks
    drawn slice by slice with dense_init's spread."""
    for shared in (0, 1):
        jp = JM.moe_init(jax.random.PRNGKey(0), D, FF, 4, "swiglu", shared)
        tp = TM.moe_init(torch.Generator().manual_seed(0), D, FF, 4,
                         "swiglu", shared)
        jl, tl = dict(_leaves(jp)), dict(_leaves(tp))
        assert sorted(jl) == sorted(tl)
        for n in jl:
            assert tuple(tl[n].shape) == jl[n].shape, n
            assert str(tl[n].dtype).split(".")[-1] == str(jl[n].dtype), n
    w = TM.dense_init_slices(torch.Generator().manual_seed(0), 256, 64,
                             lead=(2, 3)).float()
    assert w.shape == (2, 3, 256, 64)
    assert float(w.abs().max()) <= 2.0 / 16 + 1e-6
    std = [float(w[i, j].std()) for i in range(2) for j in range(3)]
    assert all(0.8 / 16 < s < 0.95 / 16 for s in std), std
    assert len({float(w[i, j].sum()) for i in range(2)
                for j in range(3)}) == 6        # each slice its own draw


# seed-0 draws of the dense archs' smoke params, sha256 over the leaves
# (name and bytes, in sorted order), as they were before the MoE expert
# stacks got their slice-by-slice draw
DENSE_DRAWS = {"gpt2-small": "cf4d7f7f9ac1078c",
               "granite-8b": "0eb36d49554d8bea",
               "glm4-9b": "5caa3c08166ca248",
               "starcoder2-7b": "cf4d7f7f9ac1078c",
               "gemma2-27b": "d24270d5452bcfcd",
               "pixtral-12b": "5caa3c08166ca248"}


@pytest.mark.parametrize("arch", list(DENSE_DRAWS))
def test_dense_arch_seed0_draws_unchanged(arch):
    import hashlib
    from repro_torch.configs.registry import get
    from repro_torch.models import transformer as TT
    params = TT.init_params(torch.Generator().manual_seed(0),
                            get(arch, smoke=True))
    h = hashlib.sha256()
    for n, v in _leaves(params):
        h.update(n.encode())
        h.update(v.contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest()[:16] == DENSE_DRAWS[arch]


def test_routing_replay_of_the_port_into_itself():
    """``RoutingReplay`` records a smoke model's routing and replays it
    into the same model: every row near, no parting; then again for the
    next seeds, each replay built on the port's real ``_top_k`` while
    the earlier one is still in place (as ``chip_smoke.py`` loops over
    its seeds).  A replay that wrapped the earlier one would pin seed
    n's rows to seed n - 1's choices."""
    from repro_torch.configs.registry import get
    from repro_torch.models import transformer as TT
    cfg = get("mixtral-8x7b", smoke=True)
    real = TM._top_k
    try:
        for seed in (1, 2, 3, 4):
            params = TT.init_params(torch.Generator().manual_seed(seed), cfg)
            batch = {"tokens": torch.randint(
                0, cfg.vocab_size, (4, 32),
                generator=torch.Generator().manual_seed(seed + 1))}
            pins = RoutingReplay(torch, real, REL_TOL)
            TM._top_k = pins.top_k
            for first in (True, False):
                pins.recording = first
                with torch.no_grad():
                    TT.forward_eval(params, batch, cfg)
            rows = sum(len(r) for calls in pins.bank.values()
                       for r, _ in calls)
            assert (pins.hits, pins.misses, pins.partings) == (rows, 0, [])
    finally:
        TM._top_k = real
