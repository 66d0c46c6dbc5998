"""The q4 wire pair (``kernels/pack4.py``, ``csrc/pack4.cu``) on the CPU.

- :func:`pack4.stat_stride`, through which the kernels read the
  statistics in place (stride 0: the codec's expanded per-tensor pair;
  stride 1: per-row), and :func:`pack4.geometry`, which sizes the launch.
- numpy models of ``csrc/qcode.cuh``'s code rule and of the two kernels'
  row layout (head, units, short end; aligned words realigned; edge units
  read element by element; the unpack's shuffled float4 stores), at every
  alignment of their input and output, held bitwise to the plain
  versions: every output written exactly once, every vector load inside
  the tensor, every vector access aligned.  The card tests
  (``tests/test_torch_kernels_cuda.py``) hold the kernels themselves to
  the plain versions.
- The q4 codec on NaN and +-inf inputs against the JAX package (its jnp
  path and its Pallas kernels in interpret mode): min and scale bit for
  bit, the codes wherever ``(x - min) / scale`` is defined (the port's
  code of a NaN quotient is 0, as the reference's is here), the unpack
  NaN for NaN.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core.compressors as JC
from repro.kernels import pack4 as JP4
from repro.transport import codecs as JX

from repro_torch.kernels import pack4 as TP4
from repro_torch.transport import codecs as TX

F32 = np.float32
BASE = 1 << 12           # a 16-byte aligned address: the models' storage


# ---------------------------------------------------------------------------
# the stride helper and the launch geometry
# ---------------------------------------------------------------------------

def test_stat_stride_reads_an_expanded_pair_in_place():
    v = torch.tensor(2.5).expand(8)
    got, stride = TP4.stat_stride(v)
    assert stride == 0 and got.data_ptr() == v.data_ptr()


def test_stat_stride_reads_a_per_row_pair_in_place():
    v = torch.arange(8, dtype=torch.float32)
    got, stride = TP4.stat_stride(v)
    assert stride == 1 and got is v
    view = torch.arange(12, dtype=torch.float32)[3:11]   # offset, stride 1
    got, stride = TP4.stat_stride(view)
    assert stride == 1 and got.data_ptr() == view.data_ptr()


@pytest.mark.parametrize("step", [2, 3])
def test_stat_stride_copies_any_other_stride(step):
    v = torch.arange(8 * step, dtype=torch.float32)[::step]
    got, stride = TP4.stat_stride(v)
    assert stride == 1 and got.data_ptr() != v.data_ptr()
    assert got.is_contiguous() and torch.equal(got, v)


def test_stat_stride_reads_one_row_in_place():
    v = torch.arange(6, dtype=torch.float32)[2::5]        # (1,), stride 5
    got, stride = TP4.stat_stride(v)
    assert stride == 0 and got is v


@pytest.mark.parametrize("m,n", [(1, 38597376), (8, 98304), (4, 49152),
                                 (4, 768), (1, 768), (1, 1), (4096, 33),
                                 (5, 1001), (1, 28311552), (3, 7)])
def test_geometry_covers_every_row_in_whole_warps(m, n):
    per, threads, chunks = TP4.geometry(m, n, 132)
    units = n // TP4.UNIT
    assert per in (1, 2, 4) and threads % 32 == 0
    assert 32 <= threads <= TP4.MAX_THREADS
    assert per * threads * chunks >= units            # every unit covered
    assert per * threads * (chunks - 1) < max(units, 1)  # no idle block
    if m * chunks < 2 * 132:                          # a small tensor
        assert per == 1 and (threads <= 64 or chunks == 1)


def test_geometry_at_the_main_path_shapes():
    # the 38.6 M leaf: 4 units a thread, 256 threads; the hop fills the
    # card with 1 unit a thread; decode takes two blocks a row
    assert TP4.geometry(1, 38597376, 132) == (4, 256, 4712)
    assert TP4.geometry(8, 98304, 132) == (1, 256, 48)
    assert TP4.geometry(4, 49152, 132) == (1, 64, 96)
    assert TP4.geometry(4, 768, 132) == (1, 64, 2)


# ---------------------------------------------------------------------------
# numpy models of csrc/qcode.cuh and csrc/pack4.cu
# ---------------------------------------------------------------------------

def qcodes_model(x, mn, sc):
    """csrc/qcode.cuh in float32, element by element: the reciprocal
    product where provably the division's integer, the division elsewhere
    (the kernel sends a whole unit to the division where one of its
    elements is flagged: the same integers)."""
    x, mn, sc = F32(x), F32(mn), F32(sc)
    with np.errstate(all="ignore"):
        rcp = F32(1) / sc
        ok = (rcp >= np.finfo(F32).tiny) & (rcp <= np.finfo(F32).max)
        rs = np.where(ok, rcp, F32(np.nan)).astype(F32)
        d = (x - mn).astype(F32)
        t = (d * rs).astype(F32)
        magic = F32(12582912.0)
        r = ((t + magic).astype(F32) - magic).astype(F32)
        fast = (t <= F32(16)) & (np.abs((t - r).astype(F32))
                                 < F32(0.5 - 2.0 ** -13))
        q = np.where(fast, r, np.rint((d / sc).astype(F32))).astype(F32)
        q = np.fmin(np.fmax(q, F32(0)), F32(15))
    return ((q + F32(2 ** 23)).astype(F32).view(np.uint32)
            & 0xFF).astype(np.uint8)


def _plain_codes(x, mn, sc):
    """The plain version's codes, one per element, from its packed
    bytes."""
    m, n = x.shape
    packed = TP4.pack4_wire_plain(torch.from_numpy(x),
                                  torch.from_numpy(mn), torch.from_numpy(sc))
    p = packed.numpy()
    return np.stack([p & 0xF, p >> 4], -1).reshape(m, -1)[:, :n]


def _near_ties(rng, scale):
    """x = min + (k + 1/2) * scale, then 0-4 float32 steps either way:
    quotients on and beside every half-integer 0.5-15.5."""
    mn = F32(rng.randn())
    half = np.arange(16, dtype=F32) + F32(0.5)
    base = (mn + half * F32(scale)).astype(F32)
    out = [base]
    for step in range(1, 5):
        up, down = base.copy(), base.copy()
        for _ in range(step):
            up = np.nextafter(up, F32(np.inf)).astype(F32)
            down = np.nextafter(down, F32(-np.inf)).astype(F32)
        out += [up, down]
    return np.concatenate(out)[None, :].astype(F32), mn


QCODE_CASES = ["randn", "exact ties", "near ties", "near ties, odd scale",
               "NaN and +-inf", "beyond the range", "subnormal scale",
               "huge scale", "zero scale", "negative scale", "NaN scale",
               "inf scale", "subnormal differences"]


@pytest.mark.parametrize("kind", QCODE_CASES)
def test_qcode_rule_equals_the_division(kind):
    rng = np.random.RandomState(QCODE_CASES.index(kind))
    x = rng.randn(4, 4096).astype(F32)
    mn, sc = TP4.minmax_scale(torch.from_numpy(x))
    mn, sc = mn.numpy(), sc.numpy()
    if kind == "exact ties":
        x = (np.arange(4 * 31) % 31 * 0.25).astype(F32).reshape(4, 31)
        mn, sc = np.zeros(4, F32), np.full(4, 0.5, F32)
    elif kind.startswith("near ties"):
        scale = F32(0.37) if kind.endswith("odd scale") else F32(0.125)
        x, m0 = _near_ties(rng, scale)
        mn, sc = np.array([m0], F32), np.array([scale], F32)
    elif kind == "NaN and +-inf":
        x[:, ::7] = np.nan
        x[:, 1::7] = np.inf
        x[:, 2::7] = -np.inf
    elif kind == "beyond the range":
        x = x * F32(40)                 # quotients far outside [0, 15]
    elif kind == "subnormal scale":
        sc = np.full(4, 1e-39, F32)     # 1 / scale overflows
    elif kind == "huge scale":
        sc = np.full(4, 3e38, F32)      # 1 / scale is subnormal
    elif kind == "zero scale":
        sc = np.zeros(4, F32)
    elif kind == "negative scale":
        sc = -sc
    elif kind == "NaN scale":
        sc = np.full(4, np.nan, F32)
    elif kind == "inf scale":
        sc = np.full(4, np.inf, F32)
    elif kind == "subnormal differences":
        x = (x * F32(1e-40)).astype(F32)
        mn = np.zeros(4, F32)
        sc = np.full(4, 1e-3, F32)
    got = qcodes_model(x, mn[:, None], sc[:, None])
    np.testing.assert_array_equal(got, _plain_codes(x, mn, sc))


def _dequant(codes, mn, sc):
    return (codes.astype(F32) * F32(sc)).astype(F32) + F32(mn)


def pack_model(x, mn, sc, x_off, out_off, geometry):
    """csrc/pack4.cu::pack4_kernel on x (m, n) stored ``x_off`` elements
    past a 16-byte boundary, its output ``out_off`` bytes past a 4-byte
    one.  Returns the packed bytes and how often each was written."""
    m, n = x.shape
    h = (n + 1) // 2
    flat = x.reshape(-1)
    out = np.zeros(m * h, np.uint8)
    writes = np.zeros(m * h, np.int64)
    per, threads, chunks = geometry
    for row in range(m):
        xr = row * n
        orow = out_off + row * h
        head = min((4 - orow % 4) % 4, h)
        pairs = n >> 1
        units = (pairs - head) >> 2 if pairs > head else 0
        d = ((BASE + 4 * (x_off + xr)) // 4 + 2 * head) % 4
        width = 4 * (3 if d else 2)
        for chunk in range(chunks):
            first = chunk * per * threads + np.arange(threads)
            for j in range(per):
                u = first + j * threads
                u = u[u < units]
                p = xr + 2 * (head + 4 * u) - d
                assert ((BASE + 4 * (x_off + p)) % 16 == 0).all()
                idx = p[:, None] + np.arange(width)
                inside = (idx >= 0) & (idx < m * n)
                edge = (u == 0) | (u == units - 1)
                assert inside[~edge].all(), "a vector load leaves x"
                vals = np.where(inside, flat[np.clip(idx, 0, m * n - 1)],
                                F32(0))
                want = xr + 2 * (head + 4 * u)[:, None] + np.arange(8)
                np.testing.assert_array_equal(idx[:, d:d + 8], want)
                codes = qcodes_model(vals[:, d:d + 8], mn[row], sc[row])
                b = row * h + head + 4 * u
                assert ((out_off + b) % 4 == 0).all()
                at = b[:, None] + np.arange(4)
                out[at] = codes[:, 0::2] | (codes[:, 1::2] << 4)
                writes[at] += 1
            if chunk == 0:
                for t in range(h - 4 * units):
                    jb = t if t < head else t + 4 * units
                    lo = qcodes_model(flat[xr + 2 * jb], mn[row], sc[row])
                    hi = (qcodes_model(flat[xr + 2 * jb + 1], mn[row],
                                       sc[row]) if 2 * jb + 1 < n else 0)
                    out[row * h + jb] = lo | (hi << 4)
                    writes[row * h + jb] += 1
    return out.reshape(m, h), writes


def unpack_model(packed, mn, sc, n, p_off, y_off, geometry):
    """csrc/pack4.cu::unpack4_kernel on packed (m, h) stored ``p_off``
    bytes past a 16-byte boundary, its f32 output ``y_off`` elements past
    one.  Returns the output and how often each element was written."""
    m, h = packed.shape
    flat = packed.reshape(-1)
    out = np.full(m * n, np.nan, F32)
    writes = np.zeros(m * n, np.int64)
    per, threads, chunks = geometry
    lanes = np.arange(32)
    for row in range(m):
        pr, yr = row * h, row * n
        head = min((4 - (BASE // 4 + y_off + yr) % 4) % 4, n)
        units = (n - head) >> 3
        g = 2 * (BASE + p_off + pr) + head
        shift = 4 * (g & 7)
        wbase = (g >> 1) & ~3                 # an address
        for chunk in range(chunks):
            first = chunk * per * threads + np.arange(threads)
            for j in range(per):
                u = first + j * threads
                valid = u < units
                edge = (u == 0) | (u == units - 1)
                nbytes = 8 if shift else 4
                at = wbase + 4 * u[:, None] + np.arange(nbytes) - BASE - p_off
                inside = (at >= 0) & (at < m * h)
                assert inside[valid & ~edge].all(), "a vector load leaves p"
                byts = np.where(inside & valid[:, None],
                                flat[np.clip(at, 0, m * h - 1)], 0)
                word = (byts.astype(np.uint64)
                        << (8 * np.arange(nbytes, dtype=np.uint64))).sum(1)
                codes = (word >> np.uint64(shift)) & np.uint64(0xFFFFFFFF)
                for w in range(threads // 32):
                    u0 = u[32 * w]
                    for k in range(2):
                        slot = 32 * k + lanes
                        src = slot >> 1
                        cw = codes[32 * w + src]       # the shuffle
                        uu = u0 + src
                        ok = uu < units
                        half = (cw >> (16 * (slot & 1)).astype(np.uint64))
                        nib = ((half[:, None] >> (4 * np.arange(
                            4, dtype=np.uint64))) & np.uint64(15))
                        e = yr + head + 8 * uu + 4 * (slot & 1)
                        assert ((y_off + e[ok]) % 4 == 0).all()
                        at_e = e[ok][:, None] + np.arange(4)
                        out[at_e] = _dequant(nib[ok], mn[row], sc[row])
                        writes[at_e] += 1
            if chunk == 0:
                for t in range(n - 8 * units):
                    e = t if t < head else t + 8 * units
                    c = (flat[pr + (e >> 1)] >> (4 * (e & 1))) & 15
                    out[yr + e] = _dequant(np.array(c), mn[row], sc[row])
                    writes[yr + e] += 1
    return out.reshape(m, n), writes


MODEL_SHAPES = [(1, 1), (2, 3), (3, 7), (2, 8), (3, 15), (2, 16), (2, 17),
                (5, 1001), (5, 1002), (3, 4098), (64, 33), (4, 768)]


def _model_inputs(shape, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(F32)
    x[:, ::13] = (np.arange(x[:, ::13].size) % 31 * 0.25).reshape(
        x[:, ::13].shape)                    # a few exact ties
    mn, sc = TP4.minmax_scale(torch.from_numpy(x))
    return x, mn.numpy(), sc.numpy()


def _geometries(m, n):
    """The launch's own geometry, and one of 32-thread blocks that cuts a
    row into several chunks."""
    return [TP4.geometry(m, n, 132), (1, 32, max(1, -(-n // (8 * 32))))]


@pytest.mark.parametrize("offsets", [(0, 0), (1, 3), (2, 2), (3, 1)])
@pytest.mark.parametrize("shape", MODEL_SHAPES)
def test_pack_model_equals_plain_at_every_alignment(shape, offsets):
    x, mn, sc = _model_inputs(shape, sum(shape))
    want = TP4.pack4_wire_plain(torch.from_numpy(x), torch.from_numpy(mn),
                                torch.from_numpy(sc)).numpy()
    for geo in _geometries(*shape):
        got, writes = pack_model(x, mn, sc, *offsets, geo)
        assert (writes == 1).all(), geo
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("offsets", [(0, 0), (1, 3), (6, 2), (15, 1)])
@pytest.mark.parametrize("shape", MODEL_SHAPES)
def test_unpack_model_equals_plain_at_every_alignment(shape, offsets):
    x, mn, sc = _model_inputs(shape, sum(shape) + 1)
    n = shape[1]
    packed = TP4.pack4_wire_plain(torch.from_numpy(x), torch.from_numpy(mn),
                                  torch.from_numpy(sc))
    want = TP4.unpack4_wire_plain(packed, torch.from_numpy(mn),
                                  torch.from_numpy(sc), n).numpy()
    for geo in _geometries(*shape):
        got, writes = unpack_model(packed.numpy(), mn, sc, n, *offsets, geo)
        assert (writes == 1).all(), geo
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


# ---------------------------------------------------------------------------
# the q4 codec on NaN and +-inf inputs against the JAX package
# ---------------------------------------------------------------------------

def _nonfinite(kind):
    x = np.random.RandomState(5).randn(4, 301).astype(F32)
    if "NaN" in kind:
        x[1, 7] = np.nan
    if "+inf" in kind:
        x[2, 300] = np.inf
    if "-inf" in kind:
        x[0, 0] = -np.inf
    return x


def _codes(packed, n):
    p = np.asarray(packed)
    return np.stack([p & 0xF, p >> 4], -1).reshape(p.shape[0], -1)[:, :n]


NONFINITE = ["NaN", "+inf", "-inf", "+inf and -inf", "NaN and +inf"]


@pytest.mark.parametrize("path", ["jnp", "pallas"])
@pytest.mark.parametrize("kind", NONFINITE)
def test_q4_codec_carries_nan_and_inf_as_the_reference(kind, path):
    """A NaN makes the per-tensor pair (NaN, 1): min and max NaN, the span
    NaN and not > 0.  +inf or -inf make the span and the scale inf.  The
    port's min and scale equal the reference's bit for bit, its codes
    wherever (x - min) / scale is defined, and the port's code of a NaN
    quotient is 0."""
    x = _nonfinite(kind)
    n = x.shape[1]
    port = TX.get_codec("q4").pack(torch.from_numpy(x))
    prev = JC.KERNEL_BACKEND
    JC.KERNEL_BACKEND = "jnp"
    try:
        if path == "jnp":
            ref = JX.get_codec("q4").pack(jnp.asarray(x))
        else:
            p, mn, sc = JP4.pack4_wire(jnp.asarray(x), interpret=True)
            ref = {"codes4": p, "min": mn, "scale": sc}
        back = np.asarray(JX.get_codec("q4").unpack(ref, x.shape,
                                                    jnp.float32))
    finally:
        JC.KERNEL_BACKEND = prev
    for key in ("min", "scale"):
        np.testing.assert_array_equal(
            port[key].numpy().reshape(-1).view(np.uint32),
            np.asarray(ref[key], F32).reshape(-1).view(np.uint32))
    mn, sc = port["min"].numpy(), port["scale"].numpy()
    if "NaN" in kind:
        assert np.isnan(mn) and sc == 1.0
    else:
        assert np.isinf(sc)
    with np.errstate(invalid="ignore"):
        defined = ~np.isnan((x - mn) / sc)
    got, want = _codes(port["codes4"], n), _codes(ref["codes4"], n)
    np.testing.assert_array_equal(got[defined], want[defined])
    assert (got[~defined] == 0).all()
    mine = TX.get_codec("q4").unpack(port, x.shape, torch.float32).numpy()
    np.testing.assert_array_equal(np.isnan(mine), np.isnan(back))
    np.testing.assert_array_equal(mine[~np.isnan(mine)],
                                  back[~np.isnan(back)])
