"""The per-tile quantizers (``kernels/quantize.py``, ``csrc/quantize.cu``)
on the CPU.

- :func:`quantize.geometry`, which sizes both kernels' launch (elements a
  unit, blocks a tile's cluster, units a thread, units held in
  registers), at the main paths' shapes and over a grid.
- ``csrc/qcode.cuh``'s code rule at the q8 levels (255) and the other
  levels the cut quantizer takes, against the division.
- A numpy model of the cluster walk both kernels share, at the main
  paths' shapes and the edge shapes, held bitwise to the plain versions:
  every element of every tile read by exactly one block and coded exactly
  once, every vector access inside the tensor and aligned, the wire meta
  written once a tile, and the order-free NaN combine giving the plain
  version's meta bits.  The card tests
  (``tests/test_torch_kernels_cuda.py``) hold the kernels themselves to
  the plain versions.
- The plain wire quantizer against the JAX package's eager oracle on a NaN
  with its own payload bits.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as JREF

from repro_torch.kernels import quantize as TQ
from repro_torch.kernels import tiling as TT

F32 = np.float32


# ---------------------------------------------------------------------------
# the launch geometry
# ---------------------------------------------------------------------------

def test_geometry_at_the_main_path_shapes():
    # the pipeline hop and the training cut, (8, 98304) in (8, 2048)
    # tiles: 4 blocks a tile in bf16, 8 in f32, 2 units a thread held
    assert TQ.geometry(98304, 8, 2048, 2, True) == (8, 4, 2, 2)
    assert TQ.geometry(98304, 8, 2048, 4, True) == (4, 8, 2, 2)
    # a 256-row microbatch: a (256, 2048) tile, 32 units a thread, read
    # again from L2
    assert TQ.geometry(98304, 256, 2048, 2, True) == (8, 8, 32, 0)
    assert TQ.geometry(98304, 256, 2048, 4, True) == (4, 8, 64, 0)
    # the cut's whole-tensor fallback tiles, one element a unit
    assert TQ.geometry(767, 4, 767, 2, True) == (1, 6, 2, 2)
    assert TQ.geometry(5001, 2, 5001, 4, True) == (1, 8, 5, 8)
    # a view off 16-byte alignment takes single elements
    assert TQ.geometry(4096, 8, 2048, 4, False) == (1, 8, 8, 8)


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("aligned", [True, False])
def test_geometry_covers_every_tile_with_no_idle_block(elem, aligned):
    for bm in (1, 2, 8, 16, 64, 256):
        for bn in (1, 7, 128, 500, 767, 2048, 5001):
            n = 3 * bn
            v, cluster, per, held = TQ.geometry(n, bm, bn, elem, aligned)
            if aligned and bn % (16 // elem) == 0:
                assert v == 16 // elem
            else:
                assert v == 1
            units = bm * (bn // v)
            assert 1 <= cluster <= TQ.MAX_CLUSTER
            assert cluster * TQ.THREADS * per >= units       # all covered
            assert cluster * TQ.THREADS * (per - 1) < units  # per is tight
            if cluster < TQ.MAX_CLUSTER:                     # no idle block
                assert (cluster - 1) * TQ.PER_THREAD * TQ.THREADS < units
            assert held == next((r for r in TQ.HELD if per <= r), 0)


# ---------------------------------------------------------------------------
# csrc/qcode.cuh at the q8 levels
# ---------------------------------------------------------------------------

def qcodes_model(x, mn, sc, levels, group=1):
    """csrc/qcode.cuh in float32 over rows of ``group`` elements: the
    reciprocal product where provably the division's integer; where one
    element of a group is flagged, the whole group takes the division.
    Returns the codes as float32 (clamped, a NaN quotient gives 0)."""
    x, mn, sc = F32(x), F32(mn), F32(sc)
    lv = F32(levels)
    with np.errstate(all="ignore"):
        rcp = F32(1) / sc
        ok = (rcp >= np.finfo(F32).tiny) & (rcp <= np.finfo(F32).max)
        rs = np.where(ok, rcp, F32(np.nan)).astype(F32)
        d = (x - mn).astype(F32)
        t = (d * rs).astype(F32)
        magic = F32(12582912.0)
        r = ((t + magic).astype(F32) - magic).astype(F32)
        # NaN-carrying maxima: a NaN t or offset flags its group
        off = np.abs((t - r).astype(F32))
        flag = ~((off < F32(0.5 - 2.0 ** -13)) & (t <= lv + F32(1)))
        shape = flag.shape
        flag = flag.reshape(-1, group).any(axis=1, keepdims=True)
        flag = np.broadcast_to(flag, (flag.shape[0], group)).reshape(shape)
        q = np.where(flag, np.rint((d / sc).astype(F32)), r).astype(F32)
        return np.fmin(np.fmax(q, F32(0)), lv).astype(F32)


def _division(x, mn, sc, levels):
    """The plain versions' rule, ``clamp(round((x - mn) / sc), 0,
    levels)`` in torch, with the code of a NaN quotient 0."""
    x, mn, sc = (torch.from_numpy(np.asarray(a, F32)) for a in (x, mn, sc))
    q = torch.clamp(torch.round((x - mn) / sc), 0, levels)
    return torch.nan_to_num(q, nan=0.0).numpy()


def _near_ties(rng, scale, levels):
    """x = min + (k + 1/2) * scale, k < levels, then 0-4 float32 steps
    either way."""
    mn = F32(rng.randn())
    half = np.arange(levels + 1, dtype=F32) + F32(0.5)
    base = (mn + half * F32(scale)).astype(F32)
    out = [base]
    for step in range(1, 5):
        up, down = base.copy(), base.copy()
        for _ in range(step):
            up = np.nextafter(up, F32(np.inf)).astype(F32)
            down = np.nextafter(down, F32(-np.inf)).astype(F32)
        out += [up, down]
    x = np.concatenate(out)
    return x[: len(x) // 8 * 8][None, :].astype(F32), mn


QCODE_CASES = ["randn", "exact ties", "near ties", "near ties, odd scale",
               "NaN and +-inf", "beyond the range", "subnormal scale",
               "huge scale", "zero scale", "NaN scale", "inf scale",
               "subnormal differences"]


@pytest.mark.parametrize("levels", [255, 15, 3, 1])
@pytest.mark.parametrize("kind", QCODE_CASES)
def test_qcode_rule_equals_the_division_at_every_level(kind, levels):
    rng = np.random.RandomState(QCODE_CASES.index(kind) + levels)
    x = rng.randn(4, 4096).astype(F32)
    mn = x.min(axis=1)
    span = (x.max(axis=1) - mn).astype(F32)
    sc = (span / F32(levels)).astype(F32)
    if kind == "exact ties":
        # min 0, max levels / 2, so scale 0.5: x = j / 4 halves every
        # other quotient
        x = (np.arange(4 * (2 * levels + 2)) % (2 * levels + 1)
             * 0.25).astype(F32).reshape(4, -1)
        mn, sc = np.zeros(4, F32), np.full(4, 0.5, F32)
    elif kind.startswith("near ties"):
        scale = F32(0.37) if kind.endswith("odd scale") else F32(0.125)
        x, m0 = _near_ties(rng, scale, levels)
        mn, sc = np.array([m0], F32), np.array([scale], F32)
    elif kind == "NaN and +-inf":
        x[:, ::7] = np.nan
        x[:, 1::7] = np.inf
        x[:, 2::7] = -np.inf
    elif kind == "beyond the range":
        x = x * F32(40)
    elif kind == "subnormal scale":
        sc = np.full(4, 1e-39, F32)
    elif kind == "huge scale":
        sc = np.full(4, 3e38, F32)
    elif kind == "zero scale":
        sc = np.zeros(4, F32)
    elif kind == "NaN scale":
        sc = np.full(4, np.nan, F32)
    elif kind == "inf scale":
        sc = np.full(4, np.inf, F32)
    elif kind == "subnormal differences":
        x = (x * F32(1e-40)).astype(F32)
        mn = np.zeros(4, F32)
        sc = np.full(4, 1e-3, F32)
    want = _division(x, mn[:, None], sc[:, None], levels)
    for group in (1, 4, 8):
        got = qcodes_model(x, mn[:, None], sc[:, None], levels, group)
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# a numpy model of the cluster walk (csrc/quantize.cu::cluster_tile)
# ---------------------------------------------------------------------------

def _f32(x):
    """The kernels' f32 view of a float32 or bfloat16 tensor (bf16
    widened exactly)."""
    return x.to(torch.float32).numpy()


def _min_keep_nan(a, b):
    """csrc/quantize.cu::min_keep_nan: the NaN of the larger bit pattern
    as a signed integer, else the min."""
    na, nb = np.isnan(a), np.isnan(b)
    if na and nb:
        return a if F32(a).view(np.int32) >= F32(b).view(np.int32) else b
    if na or nb:
        return a if na else b
    return F32(min(a, b))


def cluster_model(x, bits, block, wire, x_off=0):
    """The cluster walk on ``x`` (m, n) float32 / bfloat16, stored
    ``x_off`` elements past a 16-byte boundary (the output: at one),
    tiled ``block``.  ``wire``: the quantize_wire epilogue (uint8 codes and
    the meta), else quant_dequant's (dequantized in x's type).  Returns
    (output, meta or None, reads, writes, rank) with ``rank`` the cluster
    block that read each element."""
    m, n = x.shape
    bm, bn = TQ._tiles(x, bits, block)
    elem = x.element_size()
    g = TQ.geometry(n, bm, bn, elem, x_off * elem % 16 == 0)
    v, csize, held = g.v, g.cluster, g.held
    levels = (1 << bits) - 1
    flat = _f32(x).reshape(-1)
    bits32 = flat.view(np.int32)
    codes = np.full(m * n, np.nan, F32)
    reads = np.zeros(m * n, np.int64)
    writes = np.zeros(m * n, np.int64)
    rank_of = np.full(m * n, -1, np.int64)
    gm, gn = m // bm, n // bn
    meta = np.full((gm, 2 * gn), np.nan, F32)
    meta_writes = np.zeros((gm, gn), np.int64)
    row_units = bn // v
    units = bm * row_units
    stride = csize * TQ.THREADS
    reps = held if held else -(-units // stride)
    for ti in range(gm):
        for tj in range(gn):
            origin = ti * bm * n + tj * bn
            offs, parts = [], []
            for rank in range(csize):
                first = rank * TQ.THREADS + np.arange(TQ.THREADS)
                u = (first[:, None] + stride * np.arange(reps)).reshape(-1)
                u = u[u < units]
                r = u // row_units
                off = origin + r * n + (u - r * row_units) * v
                idx = off[:, None] + np.arange(v)
                assert ((idx >= 0) & (idx < m * n)).all(), "a load leaves x"
                if v > 1:
                    assert ((x_off + off) * elem % 16 == 0).all()
                reads[idx] += 1
                rank_of[idx] = rank
                vals = flat[idx]
                nan = np.isnan(vals)
                if nan.any():   # the block's NaN, bits and all (wire)
                    lo = bits32[idx][nan].max().view(F32) if wire \
                        else F32(np.nan)
                    hi = F32(np.nan)
                elif vals.size:
                    lo, hi = vals.min(), vals.max()
                else:
                    lo, hi = F32(np.inf), F32(-np.inf)
                parts.append((lo, hi))
                offs.append(idx)
            lo, hi = parts[0]
            for plo, phi in parts[1:]:   # rank order, as every block does
                lo = _min_keep_nan(lo, plo) if wire else (
                    F32(np.nan) if np.isnan(lo) or np.isnan(plo)
                    else F32(min(lo, plo)))
                hi = F32(np.nan) if np.isnan(hi) or np.isnan(phi) \
                    else F32(max(hi, phi))
            with np.errstate(invalid="ignore"):
                span = F32(hi - lo)
                scale = F32(span / F32(levels)) if span > 0 else F32(1)
            for idx in offs:
                q = qcodes_model(flat[idx], lo, scale, levels, v)
                codes[idx] = q.reshape(idx.shape)
                if wire:
                    assert (idx[:, 0] % v == 0).all()   # the word store
                writes[idx] += 1
            if wire:   # the cluster's first block, one 8-byte store
                meta[ti, 2 * tj:2 * tj + 2] = (lo, scale)
                meta_writes[ti, tj] += 1
                continue
            for idx in offs:
                with np.errstate(invalid="ignore"):
                    codes[idx] = (codes[idx] * scale).astype(F32) + lo
    out = codes.reshape(m, n)
    if wire:
        assert (meta_writes == 1).all()
        out = out.astype(np.uint8)
    else:
        out, meta = torch.from_numpy(out).to(x.dtype), None
    return (out, meta, reads.reshape(m, n), writes.reshape(m, n),
            rank_of.reshape(m, n))


def _store(x, x_off):
    """``x`` as a view ``x_off`` elements into a fresh storage."""
    if not x_off:
        return x
    store = torch.zeros(x.numel() + x_off, dtype=x.dtype)
    view = store[x_off:].view(x.shape)
    view.copy_(x)
    return view


def _defined(x, meta, block):
    """Where ``(x - min) / scale`` is not NaN: there the codes are
    defined (a NaN's uint8 code is not, on either side)."""
    m, n = x.shape
    bm, bn = block
    mins = np.repeat(np.repeat(meta[:, 0::2], bm, 0), bn, 1)
    scales = np.repeat(np.repeat(meta[:, 1::2], bm, 0), bn, 1)
    with np.errstate(invalid="ignore"):
        return ~np.isnan((_f32(x) - mins) / scales)


def _check_wire(x, block, x_off=0):
    """The model's wire output against the plain version's: meta bit for
    bit, codes wherever defined; each element read and coded once."""
    bm, bn = TQ._tiles(x, 8, block)
    codes, meta, reads, writes, _ = cluster_model(x, 8, block, True, x_off)
    assert (reads == 1).all() and (writes == 1).all()
    pcodes, pmeta = TQ.quantize_wire_plain(x, 8, block)
    pmeta = pmeta.numpy()
    np.testing.assert_array_equal(meta.view(np.int32), pmeta.view(np.int32))
    ok = _defined(x, pmeta, (bm, bn))
    np.testing.assert_array_equal(codes[ok], pcodes.numpy()[ok])
    assert (codes[~ok] == 0).all()
    return meta


def _check_qdq(x, bits, block, x_off=0):
    out, _, reads, writes, _ = cluster_model(x, bits, block, False, x_off)
    assert (reads == 1).all() and (writes == 1).all()
    want = TQ.quant_dequant_plain(x, bits, block)
    np.testing.assert_array_equal(_bits(out), _bits(want))


def _bits(t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16) \
        .numpy()


def _wire_input(shape, kind, dtype, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(F32)
    if kind == "constant":
        x[:] = 3.25
    elif kind == "exact ties":
        # min 0, max 127.5 in every (., 2048) tile: scale 0.5, and x = j / 4
        # (exact in bf16 too) halves every other quotient (the IEEE path)
        x = (np.arange(x.size) % 256 * 0.25).astype(F32).reshape(shape)
        x[:, ::1024] = 127.5
    elif kind == "+-inf":
        x[0, 5] = np.inf
        x[-1, -3] = -np.inf
    return torch.from_numpy(x).to(dtype)


BF, FP = torch.bfloat16, torch.float32
# (shape, block, input, dtype, offset): the hop in both types, two row
# tiles, a 256-row microbatch's (256, 2048) tile (read again from L2),
# one element a unit (a view at offset 1; n and bn not multiples of 8),
# a constant tile, exact ties, +-inf
WIRE_MODEL_CASES = {
    "hop bf16": ((8, 98304), None, "randn", BF, 0),
    "hop f32": ((8, 98304), None, "randn", FP, 0),
    "two row tiles bf16": ((16, 4096), (8, 2048), "randn", BF, 0),
    "256 rows bf16": ((256, 4096), None, "randn", BF, 0),
    "256 rows f32": ((256, 2048), None, "randn", FP, 0),
    "view at offset 1 f32": ((8, 4096), None, "randn", FP, 1),
    "view at offset 1 bf16": ((8, 4096), None, "randn", BF, 1),
    "n 1004 block 502 bf16": ((8, 1004), (8, 502), "randn", BF, 0),
    "n 1004 block 502 f32": ((8, 1004), (8, 502), "randn", FP, 0),
    "constant bf16": ((8, 4096), None, "constant", BF, 0),
    "exact ties f32": ((8, 4096), None, "exact ties", FP, 0),
    "exact ties bf16": ((8, 4096), None, "exact ties", BF, 0),
    "+-inf f32": ((16, 4096), None, "+-inf", FP, 0),
}


@pytest.mark.parametrize("case", list(WIRE_MODEL_CASES))
def test_wire_cluster_model_equals_plain(case):
    shape, block, kind, dtype, x_off = WIRE_MODEL_CASES[case]
    x = _store(_wire_input(shape, kind, dtype), x_off)
    _check_wire(x, block or TT.wire_tiling(shape), x_off)


def test_wire_cluster_model_meta_of_a_constant_tile_and_ties():
    meta = _check_wire(_wire_input((8, 4096), "constant", BF), (8, 2048))
    np.testing.assert_array_equal(meta, [[3.25, 1.0, 3.25, 1.0]])
    meta = _check_wire(_wire_input((8, 4096), "exact ties", FP), (8, 2048))
    assert (meta[:, 0::2] == 0).all() and (meta[:, 1::2] == 0.5).all()


# the training cut's shapes through the same walk: the cut, m = 6 (row
# tile 2), batch 256, the whole-tensor fallback tiles, a view
QDQ_MODEL_CASES = {
    "cut bf16": ((8, 98304), (8, 2048), BF, 0),
    "cut f32": ((8, 98304), (8, 2048), FP, 0),
    "m=6 bf16": ((6, 4096), (2, 2048), BF, 0),
    "batch 256 bf16": ((256, 4096), (256, 2048), BF, 0),
    "fallback (4, 767) bf16": ((4, 767), (4, 767), BF, 0),
    "fallback (2, 5001) f32": ((2, 5001), (2, 5001), FP, 0),
    "view at offset 1 bf16": ((8, 4096), (8, 2048), BF, 1),
}


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("case", list(QDQ_MODEL_CASES))
def test_quant_dequant_cluster_model_equals_plain(case, bits):
    shape, block, dtype, x_off = QDQ_MODEL_CASES[case]
    x = _store(_wire_input(shape, "randn", dtype, seed=bits), x_off)
    _check_qdq(x, bits, block, x_off)


def _rank_element(x, block, rank):
    """(row, col) of an element in the first tile that cluster block
    ``rank`` reads (its last such element)."""
    ranks = cluster_model(x, 8, block, True)[4]
    bm, bn = block
    rows, cols = np.nonzero(ranks[:bm, :bn] == rank)
    return rows[-1], cols[-1]


NAN_PAYLOADS = {FP: [0x7FC00123, 0xFFC00123], BF: [0x7FC1, 0xFFC1]}


def _with_nan(x, at, payload):
    """x with the NaN of bit pattern ``payload`` (x's width) at ``at``."""
    x = x.clone()
    if x.element_size() == 4:
        x.view(torch.int32)[at] = int(np.uint32(payload).view(np.int32))
    else:
        x.view(torch.int16)[at] = int(np.uint16(payload).view(np.int16))
    return x


def _widened(dtype, payload):
    """The float32 bits of a NaN payload of ``dtype``, as a signed int."""
    return np.uint32(payload if dtype == FP else payload << 16).view(
        np.int32)


@pytest.mark.parametrize("dtype", [FP, BF])
@pytest.mark.parametrize("where", ["first block", "last block", "both"])
def test_wire_cluster_model_carries_a_nan_payload(dtype, where):
    """A NaN of its own payload in the first or the last block of a hop
    tile's cluster (or one in each): the tile's meta min is that NaN, bit
    for bit, as in the plain version; of two payloads the larger bit
    pattern as a signed integer, in any order."""
    shape = (8, 98304)
    block = TT.wire_tiling(shape)
    x = _wire_input(shape, "randn", dtype, seed=7)
    csize = TQ.geometry(shape[1], *block, x.element_size(), True).cluster
    first, last = NAN_PAYLOADS[dtype]
    want = []
    if where in ("first block", "both"):
        x = _with_nan(x, _rank_element(x, block, 0), first)
        want.append(_widened(dtype, first))
    if where in ("last block", "both"):
        x = _with_nan(x, _rank_element(x, block, csize - 1), last)
        want.append(_widened(dtype, last))
    meta = _check_wire(x, block)
    assert meta.view(np.int32)[0, 0] == max(want) and meta[0, 1] == 1.0
    assert np.isfinite(meta[0, 2:]).all()


# ---------------------------------------------------------------------------
# the plain wire quantizer against the JAX package's eager oracle
# ---------------------------------------------------------------------------

def _to_jax(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("dtype", [FP, BF])
@pytest.mark.parametrize("sign", ["+", "-"])
def test_quantize_wire_plain_keeps_a_nan_payload_as_the_reference(dtype,
                                                                  sign):
    """A tile holding one NaN with its own payload: the plain version's
    meta equals the eager oracle's bit for bit (min the input's NaN,
    scale 1), and so do its codes wherever they are defined."""
    shape = (16, 10240)
    block = TT.wire_tiling(shape)
    x = _wire_input(shape, "randn", dtype, seed=11)
    payload = NAN_PAYLOADS[dtype][0 if sign == "+" else 1]
    x = _with_nan(x, (9, 2048 + 77), payload)
    codes, meta = TQ.quantize_wire_plain(x, 8, block)
    jcodes, jmeta = JREF.quantize_wire_ref(_to_jax(x), 8, block)
    meta, jmeta = meta.numpy(), np.asarray(jmeta)
    np.testing.assert_array_equal(meta.view(np.uint32),
                                  jmeta.view(np.uint32))
    assert meta.view(np.int32)[0, 2] == _widened(dtype, payload)
    assert meta[0, 3] == 1.0
    ok = _defined(x, meta, block)
    assert not ok[:, 2048:4096].any() and ok[:, :2048].all()
    np.testing.assert_array_equal(codes.numpy()[ok], np.asarray(jcodes)[ok])
