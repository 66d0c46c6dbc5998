"""The port's DP decode + sum (``kernels/dp_reduce.py``) against the JAX
package's ``repro/kernels/dp_reduce.py``, on the same bytes.

In-process and jit-free.  Every replica's gradient leaves come from a
seeded numpy ``RandomState``; both packages pack them (the port's plain
codecs, the reference's eager jnp path) and the payload bytes must agree
bitwise before the same fused slots go to both decoders.  The tree is
ragged: an odd leaf (7,) (q4 pad nibble, odd q8 ``n``: misaligned meta
offsets), (5, 33), a rank-3 stack (2, 3, 17), a bf16 leaf (4, 9) and a
constant leaf (6,).

Bounds:
  * ``build_decode_plans``, ``extract_meta``, ``decode_fits``: equal
    field for field / bitwise;
  * ``decode_sum_fused_plain`` against the reference's eager loop
    (``unfuse_payload`` -> ``unpack_grad_leaf`` -> add, jnp backend, where
    every dequant is a multiply then an add): bitwise;
  * against the reference's Pallas kernel in interpret mode, which
    contracts ``codes * scale + min`` into an FMA: within
    ``dp * 1.2e-7 * max(|a|, 1)``, the bound of
    tests/test_codec_kernels.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.compressors as JC
from repro.kernels import dp_reduce as JK
from repro.transport import codecs as JCODEC
from repro.transport import collectives as JCOL

from repro_torch.kernels import dp_reduce as TK
from repro_torch.transport import codecs as TCODEC
from repro_torch.transport import collectives as TCOL

SHAPES = {"a": (7,), "b": (5, 33), "c": (2, 3, 17), "d": (4, 9),
          "e": (6,)}
BF16 = {"d"}
CONST = {"e"}
DPS = (1, 2, 3, 4)


@pytest.fixture(autouse=True)
def jnp_backend(monkeypatch):
    """The reference's eager jnp codecs (its CPU default, pinned)."""
    monkeypatch.setattr(JC, "KERNEL_BACKEND", "jnp")


def replica_leaves(dp, seed=0):
    """``dp`` lists of float32 leaves in ``jax.tree.leaves`` order (the
    bf16 leaf rounded to bf16 first, as a bf16 gradient cast to f32)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(dp):
        leaves = []
        for k in sorted(SHAPES):
            a = (rng.randn(*SHAPES[k]) * 2.5).astype(np.float32)
            if k in CONST:
                a[:] = 0.75
            if k in BF16:
                a = np.asarray(jnp.asarray(a, jnp.bfloat16)
                               .astype(jnp.float32))
            leaves.append(a)
        out.append(leaves)
    return out


def _shapes():
    return [SHAPES[k] for k in sorted(SHAPES)]


def _like():
    return {k: jax.ShapeDtypeStruct(SHAPES[k], jnp.bfloat16 if k in BF16
                                    else jnp.float32) for k in SHAPES}


def _tlike():
    return {k: TCODEC.LeafStruct(SHAPES[k], torch.bfloat16 if k in BF16
                                 else torch.float32) for k in SHAPES}


def slots_both(codec, dp, seed=0):
    """(reference slots, port slots, reference payload struct): both
    packages pack every replica's leaves; the fused bytes must agree."""
    jc, tc = JCODEC.get_codec(codec), TCODEC.get_codec(codec)
    jrows, trows = [], []
    for leaves in replica_leaves(dp, seed):
        jp = [JCOL.pack_grad_leaf(jc, jnp.asarray(a)) for a in leaves]
        tp = [TCOL.pack_grad_leaf(tc, torch.from_numpy(a.copy()))
              for a in leaves]
        jrows.append(np.asarray(JCODEC.fuse_payload(jp)))
        trows.append(TCODEC.fuse_payload(tp))
    jslots, tslots = np.stack(jrows), torch.stack(trows)
    np.testing.assert_array_equal(tslots.numpy(), jslots)
    struct = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                          jp)
    return jslots, tslots, struct


@pytest.mark.parametrize("codec", ["q8", "q4"])
def test_build_decode_plans_match_reference(codec):
    want = JK.build_decode_plans(JCOL.grad_payload_structs(_like(), codec),
                                 _shapes())
    got = TK.build_decode_plans(TCOL.grad_payload_structs(_tlike(), codec),
                                _shapes())
    assert want is not None and got is not None
    assert [dataclasses_tuple(p) for p in got] == \
        [dataclasses_tuple(p) for p in want]
    # the odd leaf leaves the next leaf's meta misaligned
    assert any(p.meta_off % 4 for p in got)


def dataclasses_tuple(p):
    return (p.kind, p.off, p.nbytes, p.meta_off, p.n)


@pytest.mark.parametrize("case", ["none", "topk", "q8_per_tile",
                                  "empty_leaf", "bf16_stats"])
def test_plans_reject_what_the_kernel_does_not_take(case):
    shapes = _shapes()
    if case in ("none", "topk"):
        jst = JCOL.grad_payload_structs(_like(), case)
        tst = TCOL.grad_payload_structs(_tlike(), case)
    elif case == "q8_per_tile":       # the (rows >= 8) pipeline wire format
        shapes = [(8, 1024)]
        tst = [TCODEC.get_codec("q8").payload_struct((8, 1024))]
        assert set(tst[0]) == {"codes", "tile_meta"}
        jst = [{"codes": jax.ShapeDtypeStruct((8, 1024), jnp.uint8),
                "tile_meta": jax.ShapeDtypeStruct((1, 2), jnp.float32)}]
    elif case == "empty_leaf":        # a (1, 0) q8 payload
        shapes = [(0,)]
        f32 = TCODEC.LeafStruct((), torch.float32)
        tst = [{"codes": TCODEC.LeafStruct((1, 0), torch.uint8),
                "min": f32, "scale": f32}]
        jf32 = jax.ShapeDtypeStruct((), jnp.float32)
        jst = [{"codes": jax.ShapeDtypeStruct((1, 0), jnp.uint8),
                "min": jf32, "scale": jf32}]
    else:
        shapes = [(7,)]
        tst = [dict(TCOL.grad_payload_structs(
            [TCODEC.LeafStruct((7,), torch.float32)], "q8")[0],
            min=TCODEC.LeafStruct((), torch.bfloat16))]
        jst = [dict(JCOL.grad_payload_structs(
            [jax.ShapeDtypeStruct((7,), jnp.float32)], "q8")[0],
            min=jax.ShapeDtypeStruct((), jnp.bfloat16))]
    assert JK.build_decode_plans(jst, shapes) is None
    assert TK.build_decode_plans(tst, shapes) is None


@pytest.mark.parametrize("dp", DPS)
@pytest.mark.parametrize("codec", ["q8", "q4"])
def test_extract_meta_bitwise(codec, dp):
    jslots, tslots, struct = slots_both(codec, dp)
    plans = TK.build_decode_plans(TCOL.grad_payload_structs(_tlike(), codec),
                                  _shapes())
    want = np.asarray(JK.extract_meta(jnp.asarray(jslots),
                                      JK.build_decode_plans(struct,
                                                            _shapes())))
    got = TK.extract_meta(tslots, plans)
    assert got.dtype == torch.float32 and got.shape == (dp, 2 * len(plans))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


def _reference_loop(codec, jslots, struct, dp):
    jc = JCODEC.get_codec(codec)
    acc = [None] * len(struct)
    for s in range(dp):
        pls = JCODEC.unfuse_payload(jnp.asarray(jslots[s]), struct)
        for i, shape in enumerate(_shapes()):
            m = JCOL.unpack_grad_leaf(jc, pls[i], shape)
            acc[i] = m if acc[i] is None else acc[i] + m
    return [np.asarray(a) for a in acc]


@pytest.mark.parametrize("dp", DPS)
@pytest.mark.parametrize("codec", ["q8", "q4"])
def test_decode_sum_plain_matches_reference(codec, dp):
    """Bitwise the reference's eager loop; within the FMA bound of its
    interpret-mode Pallas kernel.  The CPU wrapper takes the plain path."""
    jslots, tslots, struct = slots_both(codec, dp, seed=dp)
    jplans = JK.build_decode_plans(struct, _shapes())
    tplans = TK.build_decode_plans(TCOL.grad_payload_structs(_tlike(), codec),
                                   _shapes())
    got = TK.decode_sum_fused_plain(tslots, tplans, dp)
    loop = _reference_loop(codec, jslots, struct, dp)
    kern = [np.asarray(a) for a in
            JK.decode_sum_fused(jnp.asarray(jslots), jplans, dp,
                                interpret=True)]
    wrapped = TK.decode_sum_fused(tslots, tplans, dp)
    for i, shape in enumerate(_shapes()):
        g = got[i]
        assert g.dtype == torch.float32 and g.shape == (1, tplans[i].n)
        g = g.reshape(shape).numpy()
        np.testing.assert_array_equal(g.view(np.uint32),
                                      loop[i].view(np.uint32))
        k = kern[i].reshape(shape)
        tol = dp * 1.2e-7 * max(float(np.abs(k).max()), 1.0)
        assert float(np.abs(g - k).max()) <= tol
        assert torch.equal(wrapped[i], got[i])


@pytest.mark.parametrize("dp", [1, 4, 64])
def test_decode_fits_is_the_reference(dp):
    for codec in ("q8", "q4"):
        for shapes in (_shapes(), [(1024, 1024)], [(300, 7), (9,)]):
            tl = [TCODEC.LeafStruct(s, torch.float32) for s in shapes]
            jl = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
            tp = TK.build_decode_plans(TCOL.grad_payload_structs(tl, codec),
                                       shapes)
            jp = JK.build_decode_plans(JCOL.grad_payload_structs(jl, codec),
                                       shapes)
            assert TK.decode_fits(tp, dp) == JK.decode_fits(jp, dp)
    assert TK.DECODE_MAX_BYTES == JK.DECODE_MAX_BYTES
    assert TK.decode_fits([], dp) == JK.decode_fits([], dp)


def test_kernel_plan_table():
    """The kernel's plan table: one row per leaf, outputs packed back to
    back, tiles of 4096 elements that never cross a leaf."""
    shapes = [(7,), (3, 8192), (5,)]
    plans = TK.build_decode_plans(TCOL.grad_payload_structs(
        [TCODEC.LeafStruct(s, torch.float32) for s in shapes], "q4"), shapes)
    table, tiles = TK._table(plans, "cpu")
    assert tiles == 1 + 6 + 1
    assert table.tolist() == [
        [1, 0, 4, 7, 0, 0],
        [1, 12, 12 + 12288, 24576, 7, 1],
        [1, 12 + 12288 + 8, 12 + 12288 + 8 + 3, 5, 7 + 24576, 7]]
    assert TK._table(plans, "cpu")[0] is table      # uploaded once


def test_decode_sum_refuses_bad_slots():
    plans = TK.build_decode_plans(TCOL.grad_payload_structs(
        [TCODEC.LeafStruct((7,), torch.float32)], "q8"), [(7,)])
    with pytest.raises(ValueError, match="dp=3"):
        TK.decode_sum_fused(torch.zeros((2, 15), dtype=torch.uint8), plans, 3)
    with pytest.raises(ValueError, match="uint8"):
        TK.decode_sum_fused(torch.zeros((2, 15)), plans, 2)
    with pytest.raises(ValueError, match="does not fit"):
        TK.decode_sum_fused(torch.zeros((2, 14), dtype=torch.uint8), plans, 2)


# ---------------------------------------------------------------------------
# the decode kernel's algorithm (csrc/dp_reduce.cu), modelled in numpy
# ---------------------------------------------------------------------------

THREADS = 256


def decode_kernel_model(slots, table, tiles, dp, grid, base):
    """``decode_sum_kernel`` run line for line over ``slots`` placed at
    byte address ``base`` of a model of device memory (rows ``row_bytes``
    apart), output at an address 0 mod 16: a persistent grid of ``grid``
    blocks, each walking its tiles and the leaf table forward; each thread
    a run of 16 elements, its 16 (q8) or 8 (q4) code bytes a source read
    as the realigned aligned words that hold them (a leaf's short last run
    byte by byte), codes as floats by 2^23 + code less 2^23, float32
    multiply then add in source order; each warp's 32 runs stored through
    its staging rows, as float4s at 16-byte aligned addresses where the
    leaf's out_off allows and the runs are whole, else one by one.
    Returns the output and how often each element was written."""
    from test_torch_framing import Memory, funnel_r
    rows, row_bytes = slots.shape
    mem = Memory(base + rows * row_bytes + 16)
    mem.b[base:base + rows * row_bytes] = slots.reshape(-1)
    tab = table.tolist()
    total = sum(r[3] for r in tab)
    out = np.zeros(total, np.float32)
    writes = np.zeros(total, np.int64)
    f32 = np.float32

    def meta(l, s):
        p = base + s * row_bytes + tab[l][2]
        return mem.b[p:p + 8].copy().view(np.float32)   # (min, scale)

    def load8(p, run):
        """The 8 bytes at p by aligned 8-byte loads and ``realign8``."""
        delta = p & 7
        for a in range(p - delta, p + 8, 8):
            assert a < run[1] and a + 8 > run[0], (a, run)
        w = mem.b[p - delta:p - delta + 16].view("<u4").tolist()
        lo, hi = w[:2], (w[2:] if delta else [0, 0])
        one, sh = delta & 4, (delta & 3) * 8
        w0, w1, w2 = (lo[1], hi[0], hi[1]) if one else (lo[0], lo[1], hi[0])
        return [funnel_r(w0, w1, sh), funnel_r(w1, w2, sh)]

    def run(l, r):
        kind, off, _, n, _, _ = tab[l]
        nb = 8 if kind else 16                    # code bytes a run
        nbytes = (n + 1) // 2 if kind else n
        kb = min(nb, nbytes - nb * r)
        acc = None
        for s in range(dp):
            p = base + off + nb * r + s * row_bytes
            if kb == nb:
                w = load8(p, (p, p + 8)) if kind else mem.load16(p, (p,
                                                                   p + 16))
                b = np.array(w, "<u4").view(np.uint8)
            else:
                b = np.zeros(nb, np.uint8)
                b[:kb] = mem.b[p:p + kb]
            codes = (np.stack([b & 15, b >> 4], -1).reshape(-1) if kind
                     else b).astype(np.uint32)
            c = (codes | np.uint32(0x4B000000)).view(np.float32) \
                - f32(8388608.0)
            mn, sc = meta(l, s)
            d = c * sc + mn
            acc = d if s == 0 else acc + d
        return acc

    for blk in range(grid):
        l = 0
        for t in range(blk, tiles, grid):
            while l + 1 < len(tab) and tab[l + 1][5] <= t:
                l += 1
            n, out_off = tab[l][3], tab[l][4]
            for warp in range(THREADS // 32):
                r0 = (t - tab[l][5]) * THREADS + 32 * warp
                stage = np.zeros((32, 16), np.float32)
                for lane in range(32):
                    if (r0 + lane) * 16 < n:
                        stage[lane] = run(l, r0 + lane)
                flat, e0 = stage.reshape(-1), r0 * 16
                if out_off % 4 == 0 and e0 + 512 <= n:
                    assert (4 * (out_off + e0)) % 16 == 0
                    out[out_off + e0:out_off + e0 + 512] = flat
                    writes[out_off + e0:out_off + e0 + 512] += 1
                else:
                    k = max(0, min(512, n - e0))
                    out[out_off + e0:out_off + e0 + k] = flat[:k]
                    writes[out_off + e0:out_off + e0 + k] += 1
    return out, writes


def port_slots(codec, dp, shapes, pad, seed=0):
    """(dp, row_bytes + pad) uint8 slots of the port's packed payloads of
    seeded leaves of ``shapes`` (one constant), and their plans."""
    rng = np.random.RandomState(seed)
    c = TCODEC.get_codec(codec)
    rows = []
    for _ in range(dp):
        leaves = [torch.from_numpy((rng.randn(*s) * 2.5).astype(np.float32))
                  for s in shapes]
        leaves[-1][:] = 0.75
        buf = TCODEC.fuse_payload([TCOL.pack_grad_leaf(c, a)
                                   for a in leaves])
        rows.append(torch.cat([buf, torch.from_numpy(
            rng.randint(0, 256, pad).astype(np.uint8))]))
    plans = TK.build_decode_plans(TCOL.grad_payload_structs(
        [TCODEC.LeafStruct(s, torch.float32) for s in shapes], codec),
        shapes)
    return torch.stack(rows), plans


# odd q4 n, a leaf shorter than a thread's run, a leaf of several tiles
# and a short last run, a leaf whose out_off is not a multiple of 4 and
# whose meta sits at an odd offset, a constant leaf
MODEL_SHAPES = [(7,), (3, 11), (2, 4100), (5, 1030), (9,), (6,)]


@pytest.mark.parametrize("grid", [3, 1000])
@pytest.mark.parametrize("pad,base", [(0, 64), (8, 64), (1, 67), (3, 72)])
@pytest.mark.parametrize("dp", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("codec", ["q8", "q4"])
def test_decode_kernel_model_is_the_plain_version(codec, dp, pad, base,
                                                  grid):
    """The kernel's algorithm, bitwise the plain version, every element
    written once: rows padded so that row_bytes is = 8 (mod 16) or odd,
    the bank at several alignments, dp 1-5 (dp 5 takes two batches of
    loads), a grid smaller and larger than the tile count."""
    slots, plans = port_slots(codec, dp, MODEL_SHAPES, pad, seed=dp)
    assert any(p.meta_off % 2 for p in plans)
    table, tiles = TK._table(plans, "cpu")
    assert any(r[4] % 4 for r in table.tolist())
    got, writes = decode_kernel_model(slots.numpy(), table, tiles, dp,
                                      grid, base)
    assert (writes == 1).all()
    want = torch.cat([a.reshape(-1) for a in
                      TK.decode_sum_fused_plain(slots, plans, dp)])
    np.testing.assert_array_equal(got.view(np.int32),
                                  want.numpy().view(np.int32))


def test_decode_row_bytes_of_gpt2_small_are_8_mod_16():
    """At gpt2-small, odd and even sources sit 8 bytes apart in 16-byte
    alignment (q8: 123,570,536 B a row, q4: 61,785,320 B), which is why
    the kernel realigns each source's loads."""
    from repro.configs.registry import get
    from repro.models import transformer
    shapes = jax.eval_shape(lambda k: transformer.init_params(
        k, get("gpt2-small")), jax.random.PRNGKey(0))
    like = [TCODEC.LeafStruct(tuple(a.shape), torch.float32)
            for a in jax.tree.leaves(shapes)]
    assert len(like) == 13
    for codec, row in (("q8", 123570536), ("q4", 61785320)):
        plans = TK.build_decode_plans(TCOL.grad_payload_structs(like, codec),
                                      [s.shape for s in like])
        assert plans[-1].meta_off + 8 == row and row % 16 == 8
