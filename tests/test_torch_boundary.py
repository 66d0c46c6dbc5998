"""The port's training boundary against the reference ``custom_vjp``.

For every feedback mode, the same bf16 ``(B, S, d)`` activation, fw and
bw buffers (random, not zero), example ids and cotangent go through
``repro_torch.core.boundary.boundary_apply`` (forward, then ``backward``)
and through ``repro.core.boundary.boundary_apply`` under ``jax.vjp``, with
the reference on its kernel path (``KERNEL_BACKEND = "pallas"``,
interpret mode).  Compared: ``y``, the new fw state, ``gx`` and the new bw
state (the reference's cotangent of ``bw_buf``; the port's ``BwSlot``).

TopK and uncompressed modes are bitwise.  ``q4q8`` follows the scale
rule of tests/test_torch_kernels.py: per tile, at most one code step
where the jitted reference's reciprocal scale differs, plus the rounding
slack of its FMA dequant.  AQ-SGD is tested with unique ids only.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.core.compressors as JC
from repro.core import boundary as JB
from repro.core import policy as JP

from repro_torch.core import boundary as TB
from repro_torch.core import policy as TP

from test_torch_kernels import assert_bits, assert_within_one_code_step

B, S, D = 4, 16, 256
NUM_SAMPLES = 8
IDS = np.array([3, 0, 7, 5], np.int32)
MODES = {
    "none": lambda P: P.BoundaryPolicy(),
    "q4q8": lambda P: P.quant_policy(4, 8),
    "top10": lambda P: P.topk_policy(0.1),
    "top10reuse": lambda P: P.topk_policy(0.1, reuse_indices=True),
    "ef": lambda P: P.ef_policy(0.1, "ef"),
    "ef21": lambda P: P.ef_policy(0.1, "ef21"),
    "efmixed": lambda P: P.ef_policy(0.1, "efmixed"),
    "aqsgd": lambda P: P.aqsgd_policy(0.1),
}


@pytest.fixture
def pallas_reference():
    prev = JC.KERNEL_BACKEND
    JC.KERNEL_BACKEND = "pallas"
    yield
    JC.KERNEL_BACKEND = prev


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _states(jpol, tpol, rng):
    """The two packages' initial states, with the same random buffers."""
    js = JB.init_boundary_state(jpol, (S, D), batch=B,
                                num_samples=NUM_SAMPLES, dtype=jnp.bfloat16)
    ts = TB.init_boundary_state(tpol, (S, D), batch=B,
                                num_samples=NUM_SAMPLES, dtype=torch.bfloat16)
    for d in ("fw", "bw"):
        shape = ts[d].resid.shape
        assert tuple(js[d].resid.shape) == tuple(shape)
        buf = rng.randn(*shape).astype(np.float32)
        js[d] = js[d].replace(resid=jnp.asarray(buf).astype(jnp.bfloat16))
        ts[d] = ts[d].replace(resid=_bf16(buf))
    return js, ts


@pytest.mark.parametrize("mode", list(MODES))
def test_boundary_apply_matches_custom_vjp(mode, pallas_reference):
    jpol, tpol = MODES[mode](JP), MODES[mode](TP)
    rng = np.random.RandomState(0)
    x = rng.randn(B, S, D).astype(np.float32)
    gy = rng.randn(B, S, D).astype(np.float32)
    js, ts = _states(jpol, tpol, rng)

    def f(x, bw):
        return JB.boundary_apply(jpol, x, js["fw"], bw, jnp.asarray(IDS))
    (jy, jfw), vjp = jax.vjp(f, jnp.asarray(x).astype(jnp.bfloat16),
                             js["bw"])
    jgx, jbw = vjp((jnp.asarray(gy).astype(jnp.bfloat16),
                    jax.tree.map(jnp.zeros_like, jfw)))

    tx = _bf16(x).requires_grad_(True)
    ty, tfw, slot = TB.boundary_apply(tpol, tx, ts["fw"], ts["bw"],
                                      torch.from_numpy(IDS))
    ty.backward(_bf16(gy))
    tbw = slot.state

    if mode == "q4q8":
        flat = (B, S * D)
        assert_within_one_code_step(ty.detach().reshape(flat),
                                    jy.reshape(flat),
                                    tx.detach().reshape(flat), 4, (4, 2048))
        assert_within_one_code_step(tx.grad.reshape(flat), jgx.reshape(flat),
                                    _bf16(gy).reshape(flat), 8, (4, 2048))
    else:
        assert_bits(ty.detach(), jy)
        assert_bits(tx.grad, jgx)
    assert ty.dtype == tx.grad.dtype == torch.bfloat16
    assert_bits(tfw.resid, jfw.resid)
    assert_bits(tbw.resid, jbw.resid)
    assert (tfw.mode, tbw.mode) == (jpol.feedback, jpol.bw_feedback)


def test_reuse_mask_is_the_exact_forward_topk():
    """``reuse_indices`` masks the gradient with the EXACT per-example
    TopK of x, as the reference does on every backend, not with the set
    the block kernel kept."""
    pol = TP.topk_policy(0.1, reuse_indices=True)
    st = TB.init_boundary_state(pol, (S, D), batch=B)
    x = _bf16(np.random.RandomState(1).randn(B, S, D)).requires_grad_(True)
    y, _, _ = TB.boundary_apply(pol, x, st["fw"], st["bw"], None)
    y.backward(torch.ones_like(y))
    from repro_torch.core.compressors import topk_mask
    assert torch.equal(x.grad != 0, topk_mask(x.detach(), 0.1))


def test_aqsgd_updates_its_buffer_in_place():
    pol = TP.aqsgd_policy(0.1)
    st = TB.init_boundary_state(pol, (S, D), batch=B,
                                num_samples=NUM_SAMPLES)
    buf = st["fw"].resid
    x = torch.from_numpy(np.random.RandomState(2).randn(B, S, D)
                         .astype(np.float32))
    y, new_fw, _ = TB.boundary_apply(pol, x, st["fw"], st["bw"],
                                     torch.from_numpy(IDS))
    assert new_fw.resid.data_ptr() == buf.data_ptr()
    assert torch.equal(buf[torch.from_numpy(IDS).long()], y)
    with pytest.raises(ValueError, match="ids"):
        TB.boundary_apply(pol, x, st["fw"], st["bw"], None)


@pytest.mark.parametrize("mode", ["none", "q4q8", "top10", "top10reuse",
                                  "ef21"])
def test_wire_bytes_per_example_match(mode):
    from repro.transport.simulated import simulated_transport as jsim
    from repro_torch.transport.simulated import simulated_transport as tsim
    for n in (S * D, 128 * 768):
        assert (tsim(MODES[mode](TP)).wire_bytes_per_example(n)
                == jsim(MODES[mode](JP)).wire_bytes_per_example(n))
