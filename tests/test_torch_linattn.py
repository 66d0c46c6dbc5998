"""The port's linear attention (``repro_torch/models/linattn.py``) against
the JAX package's (``repro/models/linattn.py``) on the same numpy inputs,
in f32 on the CPU.

Cases: bonus mode (RWKV: y_t reads S_{t-1} plus the u-weighted current
token) and include-current mode (SSD: y_t reads S_t); K = V = 16 and
K = 16 / V = 64 (hymba's state N and head dim); T a multiple of the
chunk and not (45 and 7 tokens against a chunk of 32 or 8: the padded
steps must leave the final state exact); with and without a given
``initial_state``; log decays drawn from [-11, 1], so that both ends of
the clip to [MIN_LOG_DECAY, 0] are taken.

Bounds: every output and gradient within ``RTOL`` = 2e-5 of its largest
magnitude (the chunked forms sum the chunk's cumulative decays by a
lower-triangular product, the reference by ``jnp.cumsum``: the same sums
in another order).  Measured, over every case: the port's chunked form
against the reference's 1.17e-5 on y and 9.2e-7 on the state, against
the two sequential oracles 3.6e-6 and 1.7e-6; the decode step 1.4e-7,
the padded state 3.2e-7, the gradients 2.7e-7.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.linattn as J
import repro_torch.models.linattn as T

torch.set_num_threads(1)

RTOL = 2e-5
# name -> (B, H, T, K, V, chunk)
SHAPES = {
    "k16v16_t45": (2, 3, 45, 16, 16, 32),
    "k16v64_t45": (2, 2, 45, 16, 64, 32),
    "k8v8_t32": (1, 2, 32, 8, 8, 32),
    "k4v4_t7_chunk8": (2, 2, 7, 4, 4, 8),
    "k16v64_t20_chunk8": (1, 2, 20, 16, 64, 8),
}


def _inputs(shape, bonus, state, seed=0):
    b, h, t, k, v, _ = shape
    rng = np.random.RandomState(seed)
    arrs = {"q": rng.randn(b, h, t, k), "k": rng.randn(b, h, t, k),
            "v": rng.randn(b, h, t, v),
            "log_w": rng.uniform(-11.0, 1.0, (b, h, t, k))}
    if bonus:
        arrs["bonus"] = rng.randn(h, k) * 0.1
    if state:
        arrs["initial_state"] = rng.randn(b, h, k, v)
    return {n: a.astype(np.float32) for n, a in arrs.items()}


def _gap(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _split(a):
    pos = [a[n] for n in ("q", "k", "v", "log_w")]
    kw = {n: a[n] for n in ("bonus", "initial_state") if n in a}
    return pos, kw


def _jax(fn, a, **extra):
    pos, kw = _split(a)
    return fn(*map(jnp.asarray, pos),
              **{n: jnp.asarray(x) for n, x in kw.items()}, **extra)


def _torch(fn, a, **extra):
    pos, kw = _split(a)
    return fn(*map(torch.from_numpy, pos),
              **{n: torch.from_numpy(x) for n, x in kw.items()}, **extra)


def test_constants_are_the_reference_s():
    assert T.MIN_LOG_DECAY == J.MIN_LOG_DECAY == -8.0
    assert T.NEG_INF == J.NEG_INF


@pytest.mark.parametrize("state", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("bonus", [True, False], ids=["bonus", "current"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_chunked_matches_reference_and_oracles(name, bonus, state):
    shape = SHAPES[name]
    a = _inputs(shape, bonus, state)
    chunk = shape[-1]
    jy, js = _jax(J.chunked_linear_attention, a, chunk=chunk)
    ty, ts = _torch(T.chunked_linear_attention, a, chunk=chunk)
    assert ty.dtype == ts.dtype == torch.float32
    assert _gap(ty, jy) <= RTOL and _gap(ts, js) <= RTOL
    ry, rs = _torch(T.reference_linear_attention, a)
    jry, jrs = _jax(J.reference_linear_attention, a)
    for got_y, got_s in ((ry, rs), (jry, jrs)):
        assert _gap(ty, got_y) <= RTOL and _gap(ts, got_s) <= RTOL


@pytest.mark.parametrize("bonus", [True, False], ids=["bonus", "current"])
def test_output_keeps_the_value_dtype(bonus):
    """y comes back in v's dtype (bf16 in the RWKV block), the state in
    f32, as in the reference."""
    a = _inputs(SHAPES["k16v16_t45"], bonus, False)
    q, k, v, w = (torch.from_numpy(a[n]) for n in ("q", "k", "v", "log_w"))
    kw = {"bonus": torch.from_numpy(a["bonus"])} if bonus else {}
    y, s = T.chunked_linear_attention(q, k, v.to(torch.bfloat16), w, **kw)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    want, _ = T.chunked_linear_attention(q, k, v.to(torch.bfloat16).float(),
                                         w, **kw)
    assert torch.equal(y, want.to(torch.bfloat16))


@pytest.mark.parametrize("bonus", [True, False], ids=["bonus", "current"])
def test_decode_step_matches_reference(bonus):
    b, h, k, v = 2, 3, 16, 64
    rng = np.random.RandomState(3)
    a = {"q": rng.randn(b, h, k), "k": rng.randn(b, h, k),
         "v": rng.randn(b, h, v), "log_w": rng.uniform(-11.0, 1.0, (b, h, k)),
         "state": rng.randn(b, h, k, v)}
    if bonus:
        a["bonus"] = rng.randn(h, k) * 0.1
    a = {n: x.astype(np.float32) for n, x in a.items()}
    pos = ("q", "k", "v", "log_w", "state")
    kw = {"bonus": a["bonus"]} if bonus else {}
    jy, js = J.linear_attention_decode(
        *(jnp.asarray(a[n]) for n in pos),
        **{n: jnp.asarray(x) for n, x in kw.items()})
    ty, ts = T.linear_attention_decode(
        *(torch.from_numpy(a[n]) for n in pos),
        **{n: torch.from_numpy(x) for n, x in kw.items()})
    assert _gap(ty, jy) <= RTOL and _gap(ts, js) <= RTOL


def test_padded_steps_leave_the_state_exact():
    """T = 45 against a chunk of 32 pads 19 zero steps: the final state
    equals the one after the 45 real steps alone (the sequential oracle)
    and the reference's chunked form."""
    a = _inputs(SHAPES["k16v64_t45"], True, True)
    _, s_pad = _torch(T.chunked_linear_attention, a)
    _, s_seq = _torch(T.reference_linear_attention, a)
    assert _gap(s_pad, s_seq) <= RTOL
    _, s_ref = _jax(J.chunked_linear_attention, a)
    assert _gap(s_pad, s_ref) <= RTOL


@pytest.mark.parametrize("state", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("bonus", [True, False], ids=["bonus", "current"])
def test_gradients_match_jax_grad(bonus, state):
    """d/d(q, k, v, log_w, bonus, initial_state) of <y, R> + <S, R'>,
    torch autograd against ``jax.grad``, with T not a multiple of the
    chunk and log decays on both sides of the clip."""
    shape = SHAPES["k16v64_t20_chunk8"]
    a = _inputs(shape, bonus, state, seed=5)
    # both sides of the clip: its gradient is 0 outside [-8, 0] in both
    assert (a["log_w"] < -8).any() and (a["log_w"] > 0).any()
    rng = np.random.RandomState(6)
    b, h, t, k, v, chunk = shape
    ry = rng.randn(b, h, t, v).astype(np.float32)
    rs = rng.randn(b, h, k, v).astype(np.float32)
    names = list(a)

    def jloss(*xs):
        d = dict(zip(names, xs))
        y, s = J.chunked_linear_attention(
            d["q"], d["k"], d["v"], d["log_w"], chunk=chunk,
            bonus=d.get("bonus"), initial_state=d.get("initial_state"))
        return jnp.sum(y * ry) + jnp.sum(s * rs)

    want = jax.grad(jloss, argnums=tuple(range(len(names))))(
        *(jnp.asarray(a[n]) for n in names))
    xs = {n: torch.from_numpy(a[n]).requires_grad_() for n in names}
    y, s = T.chunked_linear_attention(
        xs["q"], xs["k"], xs["v"], xs["log_w"], chunk=chunk,
        bonus=xs.get("bonus"), initial_state=xs.get("initial_state"))
    ((y * torch.from_numpy(ry)).sum() + (s * torch.from_numpy(rs)).sum()) \
        .backward()
    for n, w in zip(names, want):
        assert _gap(xs[n].grad, w) <= RTOL, n
