"""The training-cut kernels' plain versions and ``kernels/ops.py`` against
the JAX package, on the same numpy inputs.

Bitwise, everywhere below except one place:
  * ``quant_dequant_plain`` == the eager ``ref.quant_dequant_ref``;
  * ``topk_block_plain`` == the eager ``ref.topk_block_ref`` == the Pallas
    ``topk_block`` in interpret mode == the jitted ``topk_block_op``.
The one exception is the jitted ``quant_dequant_op`` (and the Pallas
``quant_dequant``, which matches it).  XLA rewrites its scale ``span /
levels`` as ``span * f32(1/levels)``, and fuses the dequant ``code *
scale + min`` into an FMA (measured on this CPU).  On bf16 inputs (the
training type) each output element is held, per tile, to
``|port - jit| <= step + 1 bf16 ulp of the element + 1 f32 ulp of the
tile's largest magnitude``, where ``step`` is the tile's scale (one code
step) when its two scales differ and 0 when they agree: the FMA skips
one rounding of ``code * scale``, which shows near zero, and may flip the
bf16 rounding of the sum.  Tiles whose scales agree must still be
bitwise equal in at least 98% of their elements (lowest measured:
98.8%, 8 bits).  In float32 the FMA shows everywhere, so float32 is
held to the eager oracle only.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as JO
from repro.kernels import quantize as JQ
from repro.kernels import ref as JREF
from repro.kernels import topk_mask as JK

from repro_torch.kernels import ops as TO
from repro_torch.kernels import quantize as TQ
from repro_torch.kernels import tiling as TT
from repro_torch.kernels import topk_mask as TK

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# (shape, kind): m of 1, 6 and 8; n = 767 takes the whole-tensor tile
CASES = [((1, 4096), "randn"), ((6, 4096), "randn"), ((8, 4096), "randn"),
         ((4, 767), "randn"), ((8, 4096), "constant"),
         ((8, 4096), "zero_rows"), ((6, 4096), "ties")]


def make_input(shape, kind, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "constant":
        return np.full(shape, 3.25, np.float32)
    if kind == "ties":
        return rng.randint(-3, 4, size=shape).astype(np.float32)
    x = rng.randn(*shape).astype(np.float32)
    if kind == "zero_rows":
        x[::2] = 0.0
    return x


def to_np(a):
    """Tensor or JAX array -> float32 numpy (bf16 widens exactly)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def assert_bits(got, want):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def both(x, dtype):
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)


def tile(shape):
    """The ops layer's (bm, bn) for a flat (m, n)."""
    m, n = shape
    bn = TT.lane_block(n)
    return (m, n) if bn is None else (TT.pow2_row_block(m), bn)


def ulp(v, mantissa_bits):
    """The spacing of floats with ``mantissa_bits`` at |v| (0 -> 0)."""
    v = np.abs(np.asarray(v, np.float64))
    safe = np.where(v > 0, v, 1.0)
    return np.where(v > 0, 2.0 ** (np.floor(np.log2(safe)) - mantissa_bits),
                    0.0)


def assert_within_one_code_step(port, jit, x, bits, block):
    """The jitted-reference rule of the module docstring, per tile.
    Returns the number of tiles whose two scales disagree."""
    port, jit, xf = to_np(port), to_np(jit), to_np(x)
    levels = np.float32((1 << bits) - 1)
    m, n = xf.shape
    bm, bn = block
    differ = 0
    for i in range(0, m, bm):
        for j in range(0, n, bn):
            sl = np.s_[i:i + bm, j:j + bn]
            t = xf[sl]
            span = np.float32(t.max() - t.min())
            s_div = np.float32(span / levels)
            s_mul = np.float32(span * np.float32(np.float32(1) / levels))
            agree = s_div == s_mul or span == 0
            differ += not agree
            tol = ((0.0 if agree else s_div)
                   + ulp(np.maximum(np.abs(port[sl]), np.abs(jit[sl])), 7)
                   + ulp(np.abs(t).max(), 23))
            assert (np.abs(port[sl] - jit[sl]) <= tol).all()
            if agree:
                assert (port[sl] == jit[sl]).mean() >= 0.98
    return differ


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,kind", CASES)
def test_quant_dequant_plain_is_the_eager_oracle(shape, kind, dtype):
    t, j = both(make_input(shape, kind), dtype)
    for bits in (4, 8):
        got = TQ.quant_dequant_plain(t, bits, tile(shape))
        assert got.dtype == t.dtype
        assert_bits(got, JREF.quant_dequant_ref(j, bits, block=tile(shape)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,kind", CASES)
def test_topk_block_plain_is_the_kernel(shape, kind, dtype):
    t, j = both(make_input(shape, kind), dtype)
    for k_frac in (0.1, 0.3):
        got = TK.topk_block_plain(t, k_frac, tile(shape))
        assert got.dtype == t.dtype
        assert_bits(got, JREF.topk_block_ref(j, k_frac, block=tile(shape)))
        if TT.lane_block(shape[1]) is not None:
            assert_bits(got, JK.topk_block(j, k_frac, block=tile(shape),
                                           interpret=True))
        if kind == "zero_rows":
            assert (to_np(got)[::2] == 0).all()
            kept = (to_np(got)[1::2] != 0).sum(axis=1)
            assert (kept >= np.ceil(k_frac * tile(shape)[1])).all()
        if kind == "constant":        # every tie kept
            assert_bits(got, t)


def int_bits(a):
    """Tensor or JAX array -> numpy integer view of its bits (int32 for
    float32, int16 for bfloat16): ``torch.equal`` fails on NaN."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int32 if a.dtype == torch.float32
                      else torch.int16).numpy()
    return np.asarray(a).view(np.int32 if a.dtype == jnp.float32
                              else np.int16)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_plain_versions_carry_nan_and_inf_as_the_reference(bad, dtype):
    """One NaN or +-inf in one (8, 256) tile: the quantizer makes that
    whole tile NaN (the min, max or scale is NaN or inf) and leaves the
    others finite; the TopK mask drops a NaN and keeps the rest of its
    row's tile (the bisection's hi is NaN, so lo stays 0), and keeps an
    inf.  Bits compared as integers.  One exception, in bfloat16 only:
    where the reference's quantizer output is NaN the port's must be NaN
    too, but the NaN's bits differ (ATen's float32 -> bfloat16
    conversion on the CPU writes 0xFFFF, XLA's 0x7FC0 with the sign)."""
    x = make_input((8, 512), "randn")
    x[3, 100] = bad
    t, j = both(x, dtype)
    block = (8, 256)
    for bits in (4, 8):
        got = TQ.quant_dequant_plain(t, bits, block)
        want = JREF.quant_dequant_ref(j, bits, block=block)
        nan = np.isnan(to_np(want))
        assert nan[:, :256].all() and not nan[:, 256:].any()
        np.testing.assert_array_equal(np.isnan(to_np(got)), nan)
        if dtype == "float32":
            np.testing.assert_array_equal(int_bits(got), int_bits(want))
        else:
            np.testing.assert_array_equal(int_bits(got)[~nan],
                                          int_bits(want)[~nan])
    for k_frac in (0.1, 0.3):
        got = TK.topk_block_plain(t, k_frac, block)
        np.testing.assert_array_equal(
            int_bits(got),
            int_bits(JREF.topk_block_ref(j, k_frac, block=block)))
        kept = to_np(got)[3, :256] != 0
        if np.isnan(bad):
            assert kept.sum() == 255 and not kept[100]
        else:
            assert kept[100] and to_np(got)[3, 100] == bad


@pytest.mark.parametrize("seed", range(4))
def test_quant_dequant_against_the_jitted_reference(seed):
    x = np.random.RandomState(seed).randn(8, 4096).astype(np.float32)
    x *= (0.01, 1.0, 3.0, 100.0)[seed]
    t, j = both(x, "bfloat16")
    differ = 0
    for bits in (4, 8):
        port = TO.quant_dequant_op(t, bits)
        differ += assert_within_one_code_step(
            port, JO.quant_dequant_op(j, bits), t, bits, (8, 2048))
        differ += assert_within_one_code_step(
            port, JQ.quant_dequant(j, bits, block=(8, 2048), interpret=True),
            t, bits, (8, 2048))
    assert differ < 16             # most tiles' scales agree


@pytest.mark.parametrize("shape", [(4, 16, 256), (3, 5, 64), (2, 3, 4, 128)])
def test_ops_any_rank(shape):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    t, j = both(x, "bfloat16")
    flat = t.reshape(shape[0], -1)
    q = TO.quant_dequant_op(t, 4)
    assert q.shape == t.shape
    assert_bits(q, TQ.quant_dequant_plain(flat, 4, tile(flat.shape))
                .reshape(shape))
    k = TO.topk_block_op(t, 0.1)
    assert k.shape == t.shape
    assert_bits(k, JO.topk_block_op(j, 0.1))
    assert_bits(k, TK.topk_block_plain(flat, 0.1, tile(flat.shape))
                .reshape(shape))


def test_tiles_are_the_reference_tiles():
    from repro.kernels import tiling as JT
    for m in (1, 2, 6, 8, 12, 96, 1024):
        assert TT.pow2_row_block(m) == JT.pow2_row_block(m)
    for n in (96, 128, 384, 767, 768, 4096, 98304, 70001):
        assert TT.lane_block(n) == JT.lane_block(n)


@pytest.mark.parametrize("st,arg", [(TO.quant_dequant_st, 4),
                                    (TO.topk_block_st, 0.1)])
def test_straight_through_gradient_is_identity(st, arg):
    x = torch.randn(4, 8, 128, dtype=torch.bfloat16, requires_grad=True)
    g = torch.randn(4, 8, 128, dtype=torch.bfloat16)
    y = st(x, arg)
    assert not torch.equal(y, x)
    y.backward(g)
    assert torch.equal(x.grad, g)


def test_wrappers_check_inputs():
    with pytest.raises(ValueError, match="float32/bfloat16"):
        TQ.quant_dequant(torch.zeros(2, 8, dtype=torch.float16), 4)
    with pytest.raises(ValueError, match="bits"):
        TQ.quant_dequant(torch.zeros(2, 8), 9)
    with pytest.raises(ValueError, match="tile"):
        TQ.quant_dequant(torch.zeros(6, 8), 4, block=(4, 8))
    with pytest.raises(ValueError, match="float32/bfloat16"):
        TK.topk_block(torch.zeros(2, 8, dtype=torch.float64), 0.1)
    with pytest.raises(ValueError, match="tile"):
        TK.topk_block(torch.zeros(2, 768), 0.1, block=(2, 512))
