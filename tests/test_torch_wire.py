"""The pipeline's wire formats against the JAX package, on the same numpy
inputs: ``wire_tiling``, the per-tile q8 wire quantizer, payload framing
and fusion, payload structs, and the four message functions of the
pipeline transport for every feedback mode.

The reference runs eagerly with ``repro.core.compressors.KERNEL_BACKEND =
"pallas"`` (its Pallas kernels in interpret mode), as on its accelerator.
Bitwise everywhere, except one stated bound:
  * ``quantize_wire_plain`` == the eager ``ref.quantize_wire_ref``;
  * against the interpret-mode Pallas ``quantize_wire`` (which computes
    its scale as ``span * f32(1/255)``, XLA's rewrite of the division):
    tile mins bitwise, scales within one float32 ulp, codes within one
    code step, and bitwise in every tile whose two scales agree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.compressors as JC
from repro.core import policy as JPOL
from repro.kernels import framing as JF
from repro.kernels import quantize as JQ
from repro.kernels import ref as JREF
from repro.kernels import tiling as JT
from repro.transport import codecs as JX
from repro.transport import pipeline as JPIPE

from repro_torch.core import policy as TPOL
from repro_torch.kernels import framing as TF
from repro_torch.kernels import quantize as TQ
from repro_torch.kernels import tiling as TT
from repro_torch.transport import codecs as TX
from repro_torch.transport import pipeline as TPIPE


@pytest.fixture
def pallas(monkeypatch):
    """The JAX package on its Pallas kernels (interpret mode)."""
    monkeypatch.setattr(JC, "KERNEL_BACKEND", "pallas")


def _inputs(shape, kind="randn", seed=0):
    rng = np.random.RandomState(seed)
    if kind == "constant":
        return np.full(shape, 3.25, np.float32)
    if kind == "ties":
        return rng.randint(-3, 4, size=shape).astype(np.float32)
    x = rng.randn(*shape).astype(np.float32)
    if kind == "zero_rows":
        x[::2] = 0.0
    return x


def _both(x, dtype):
    t = torch.from_numpy(x).to(dtype)
    j = jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16
                              else jnp.float32)
    return t, j


def _to_jax(t: torch.Tensor):
    """Tensor -> JAX array with the same dtype and bits."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
    if t.dtype == torch.uint16:
        return jnp.asarray(t.to(torch.int32).numpy().astype(np.uint16))
    return jnp.asarray(t.numpy())


def _bytes(a) -> np.ndarray:
    """The raw bytes of a tensor or JAX array."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.asarray(a).reshape(-1).view(np.uint8)


def _assert_bits(got, want):
    assert tuple(got.shape) == tuple(want.shape), (got.shape, want.shape)
    np.testing.assert_array_equal(_bytes(got), _bytes(want))


def _tree_to_jax(tree):
    if isinstance(tree, dict):
        return {k: _tree_to_jax(v) for k, v in tree.items()}
    return _to_jax(tree)


def _assert_tree_bits(got, want):
    assert isinstance(got, dict) == isinstance(want, dict)
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
        for k in got:
            _assert_tree_bits(got[k], want[k])
    else:
        assert str(got.dtype).split(".")[-1] == \
            str(want.dtype).split(".")[-1], (got.dtype, want.dtype)
        _assert_bits(got, want)


# ---------------------------------------------------------------------------
# tiling and the q8 wire quantizer
# ---------------------------------------------------------------------------

def test_wire_tiling_matches_over_a_grid():
    assert TT.MIN_SUBLANES == JT.MIN_SUBLANES
    for m in (1, 2, 3, 4, 6, 7, 8, 12, 16, 24, 32, 256, 512, 1024):
        for n in (64, 100, 127, 128, 256, 384, 512, 767, 1024, 2048, 4096,
                  6144, 8192, 98304):
            assert TT.wire_tiling((m, n)) == JT.wire_tiling((m, n)), (m, n)


WIRE_CASES = [((8, 4096), "randn"), ((16, 4096), "randn"),
              ((24, 2048), "randn"), ((8, 98304), "randn"),
              ((8, 4096), "constant"), ((8, 4096), "zero_rows"),
              ((16, 1024), "ties")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kind", WIRE_CASES)
def test_quantize_wire_plain_is_the_eager_oracle(shape, kind, dtype):
    t, j = _both(_inputs(shape, kind), dtype)
    block = TT.wire_tiling(shape)
    codes, meta = TQ.quantize_wire(t, 8, block)      # CPU: the plain version
    jcodes, jmeta = JREF.quantize_wire_ref(j, 8, block)
    _assert_bits(codes, jcodes)
    _assert_bits(meta, jmeta)
    assert codes.dtype == torch.uint8 and meta.dtype == torch.float32


def nonfinite_wire_input():
    """(16, 10240) f32, five (16, 2048) wire tiles: a NaN in tile 0, +inf
    in tile 1, -inf in tile 2, +inf and -inf in tile 3, tile 4 finite."""
    x = _inputs((16, 10240), seed=3)
    x[3, 100] = np.nan
    x[5, 2048 + 7] = np.inf
    x[9, 4096 + 2000] = -np.inf
    x[0, 6144] = np.inf
    x[15, 8191] = -np.inf
    return x


def finite_codes(x, meta, block):
    """Where ``(x - min) / scale`` of each element's tile is not NaN: the
    codes there are defined (a NaN's uint8 code is not, on either side)."""
    m, n = x.shape
    bm, bn = block
    mins = np.repeat(np.repeat(meta[:, 0::2], bm, 0), bn, 1)
    scales = np.repeat(np.repeat(meta[:, 1::2], bm, 0), bn, 1)
    with np.errstate(invalid="ignore"):
        return ~np.isnan((x.astype(np.float32) - mins) / scales)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_wire_plain_meta_carries_nan_and_inf_as_the_reference(
        dtype):
    """A tile holding a NaN has meta (NaN, 1): its min and max are NaN,
    its span is NaN and not > 0, so its scale falls back to 1.  +inf or
    -inf make the span inf and the scale inf.  The plain version's meta
    equals the eager oracle's bit for bit, and so do its codes wherever
    they are defined.  Both take the same bits: torch and JAX round a
    float32 NaN to different bf16 NaNs, and the meta keeps the input's."""
    x = nonfinite_wire_input()
    t = torch.from_numpy(x).to(dtype)
    j = _to_jax(t)
    block = TT.wire_tiling(x.shape)
    codes, meta = TQ.quantize_wire(t, 8, block)
    jcodes, jmeta = JREF.quantize_wire_ref(j, 8, block)
    _assert_bits(meta, jmeta)
    m = meta.numpy()
    assert np.isnan(m[0, 0]) and m[0, 1] == 1.0
    assert np.isinf(m[0, 3]) and np.isinf(m[0, 5]) and np.isinf(m[0, 7])
    assert np.isfinite(m[0, 8:]).all()
    ok = finite_codes(t.float().numpy(), m, block)
    assert not ok[:, :2048].any() and ok[:, 8192:].all()
    np.testing.assert_array_equal(codes.numpy()[ok], np.asarray(jcodes)[ok])


@pytest.mark.parametrize("shape,kind", WIRE_CASES)
def test_quantize_wire_within_one_code_of_the_interpret_kernel(shape, kind):
    """The Pallas kernel in interpret mode scales by ``span * f32(1/255)``:
    mins agree bitwise, scales within one ulp, codes within one step and
    bitwise wherever the tile's scales agree."""
    t, j = _both(_inputs(shape, kind), torch.float32)
    block = TT.wire_tiling(shape)
    codes, meta = TQ.quantize_wire_plain(t, 8, block)
    jcodes, jmeta = JQ.quantize_wire(j, 8, block=block, interpret=True)
    jmeta = np.asarray(jmeta)
    meta = meta.numpy()
    np.testing.assert_array_equal(meta[:, 0::2].view(np.uint32),
                                  jmeta[:, 0::2].view(np.uint32))
    ulps = np.abs(meta[:, 1::2].view(np.int32).astype(np.int64)
                  - jmeta[:, 1::2].view(np.int32))
    assert ulps.max() <= 1
    bm, bn = block
    gm, gn = shape[0] // bm, shape[1] // bn
    diff = np.abs(codes.numpy().astype(np.int32)
                  - np.asarray(jcodes).astype(np.int32))
    diff = diff.reshape(gm, bm, gn, bn)
    assert diff.max() <= 1
    same_scale = (ulps == 0)[:, None, :, None]
    assert not (diff * same_scale).any()


def test_dequantize_wire_is_the_reference_jnp():
    t, _ = _both(_inputs((16, 4096)), torch.bfloat16)
    block = TT.wire_tiling((16, 4096))
    codes, meta = TQ.quantize_wire(t, 8, block)
    got = TQ.dequantize_wire(codes, meta, torch.float32, block=block)
    want = JQ.dequantize_wire(_to_jax(codes), _to_jax(meta), jnp.float32,
                              block=block)
    _assert_bits(got, want)


# ---------------------------------------------------------------------------
# framing and payload fusion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes", [[5, 0, 17, 256, 3], [1, 1],
                                   [4096, 384], [7]])
def test_framing_matches_the_reference(sizes):
    rng = np.random.RandomState(len(sizes))
    parts = [rng.randint(0, 256, nb).astype(np.uint8) for nb in sizes]
    got = TF.frame_parts([torch.from_numpy(p) for p in parts])
    want = JF.frame_parts([jnp.asarray(p) for p in parts], interpret=True)
    _assert_bits(got, want)
    assert torch.equal(got, TF.frame_parts_plain(
        [torch.from_numpy(p) for p in parts]))
    segs = TF.unframe_parts(got, sizes)
    jsegs = JF.unframe_parts(want, sizes, interpret=True)
    for s, js, p in zip(segs, jsegs, parts):
        _assert_bits(s, js)
        np.testing.assert_array_equal(s.numpy(), p)
        assert s.storage_offset() == 0


def _policy_payload(name, shape, k_frac=0.1):
    """A port payload of codec ``name`` (or EF-mixed TopK) for a bf16
    activation of ``shape``."""
    y = torch.from_numpy(_inputs(shape, seed=3)).to(torch.bfloat16)
    if name == "efmixed":
        e = torch.from_numpy(_inputs(shape, seed=4)).to(torch.bfloat16)
        c = TX.get_codec("topk")
        return {"x": c.pack(y, k_frac / 2), "e": c.pack(e, k_frac / 2)}
    return TX.get_codec(name).pack(y, k_frac)


PAYLOADS = [("none", (4, 8, 32)), ("q8", (8, 256)), ("q8", (4, 256)),
            ("q4", (8, 255)), ("topk", (8, 512)), ("topk", (2, 70001)),
            ("efmixed", (8, 512))]


@pytest.mark.parametrize("name,shape", PAYLOADS)
def test_fuse_payload_is_the_reference_bytes(name, shape, pallas):
    payload = _policy_payload(name, shape)
    jpayload = _tree_to_jax(payload)
    buf = TX.fuse_payload(payload)
    jbuf = JX.fuse_payload(jpayload)
    _assert_bits(buf, jbuf)
    assert buf.numel() == TX.wire_bytes(payload) == JX.wire_bytes(jpayload)
    struct = TX.payload_struct(payload)
    _assert_tree_bits(TX.unfuse_payload(buf, struct), payload)
    jstruct = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                           jpayload)
    _assert_tree_bits(TX.unfuse_payload(buf, struct),
                      JX.unfuse_payload(jbuf, jstruct))


@pytest.mark.parametrize("name,shape", PAYLOADS[:-1])
def test_payload_struct_is_the_pack_and_the_reference(name, shape, pallas):
    codec, jcodec = TX.get_codec(name), JX.get_codec(name)
    payload = _policy_payload(name, shape)
    struct = codec.payload_struct(shape, 0.1)
    assert struct == TX.payload_struct(payload)
    jstruct = jax.eval_shape(lambda a: jcodec.pack(a, 0.1),
                             jax.ShapeDtypeStruct(shape, jnp.bfloat16))
    assert sorted(struct) == sorted(jstruct)
    for k, leaf in struct.items():
        assert leaf.shape == jstruct[k].shape
        assert str(leaf.dtype).split(".")[-1] == str(jstruct[k].dtype)


def test_q8_tiled_keys_and_dispatch(pallas):
    """With 8 rows or more the q8 codec sends the per-tile format, as the
    reference's accelerator path does; fewer rows keep per-tensor stats."""
    x = torch.from_numpy(_inputs((8, 2, 128))).to(torch.bfloat16)
    payload = TX.get_codec("q8").pack(x)
    assert set(payload) == set(JX.get_codec("q8").pack(_to_jax(x)))
    assert set(payload) == {"codes", "tile_meta"}
    flat = x.reshape(8, -1)
    codes, meta = TQ.quantize_wire(flat, 8, TT.wire_tiling(flat.shape))
    _assert_bits(payload["codes"], codes)
    _assert_bits(payload["tile_meta"], meta)
    want = TQ.dequantize_wire(codes, meta, torch.float32,
                              block=TT.wire_tiling(flat.shape))
    _assert_bits(TX.unpack_payload(payload, x.shape, torch.float32),
                 want.reshape(x.shape))
    assert set(TX.get_codec("q8").pack(x[:4])) == {"codes", "min", "scale"}
    assert set(TX.get_codec("q8").pack(x, per_request=True)) == \
        {"codes", "min", "scale"}


# ---------------------------------------------------------------------------
# the pipeline transport's message functions
# ---------------------------------------------------------------------------

def _policies(mod, mode):
    if mode == "none":
        return mod.topk_policy(0.1)
    if mode == "aqsgd":
        return mod.aqsgd_policy(0.1)
    return mod.ef_policy(0.1, mode)


MODES = ["none", "ef", "ef21", "efmixed", "aqsgd"]


@pytest.mark.parametrize("mode", MODES)
def test_message_functions_match(mode, pallas):
    """pack/unpack of both directions, bitwise: payload bytes, the
    receiver's message and every new buffer slice."""
    tp = TPIPE.PipelineTransport(_policies(TPOL, mode), 2)
    jp = JPIPE.PipelineTransport(_policies(JPOL, mode), "stage", 2)
    shape = (8, 16, 32)
    y, buf, mirror = (torch.from_numpy(_inputs(shape, seed=s))
                      .to(torch.bfloat16) for s in (5, 6, 7))
    jy, jbuf, jmirror = _to_jax(y), _to_jax(buf), _to_jax(mirror)

    pl, new = tp.pack_fw_message(y, buf)
    jpl, _, jnew = jp.pack_fw_message(jy, jbuf)
    _assert_bits(TX.fuse_payload(pl), JX.fuse_payload(jpl))
    _assert_bits(new, jnew)
    assert TX.payload_struct(pl) == tp.fw_payload_struct(shape)
    assert TX.wire_bytes(tp.fw_payload_struct(shape)) == \
        JX.wire_bytes(jp.fw_payload_struct(
            jax.ShapeDtypeStruct(shape, jnp.bfloat16)))
    out, rec = tp.unpack_fw_message(pl, shape, torch.bfloat16, mirror)
    jout, jrec = jp.unpack_fw_message(jpl, shape, jnp.bfloat16, jmirror)
    _assert_bits(out, jout)
    assert (rec is None) == (jrec is None)
    if rec is not None:
        _assert_bits(rec, jrec)

    if mode == "aqsgd":             # activations only: no bw feedback
        return
    pl, new = tp.pack_bw_message(y, buf)
    jpl, jnew = jp.pack_bw_message(jy, jbuf)
    _assert_bits(TX.fuse_payload(pl), JX.fuse_payload(jpl))
    _assert_bits(new, jnew)
    assert TX.payload_struct(pl) == tp.bw_payload_struct(shape)
    out, rec = tp.unpack_bw_message(pl, shape, torch.bfloat16, mirror)
    jout, jrec = jp.unpack_bw_message(jpl, shape, jnp.bfloat16, jmirror)
    _assert_bits(out, jout)
    assert (rec is None) == (jrec is None)
    if rec is not None:
        _assert_bits(rec, jrec)


@pytest.mark.parametrize("mode", MODES)
def test_feedback_state_shapes_match(mode):
    for v in (1, 2):
        kw = dict(num_stages=2, batch=16, microbatches=4, num_samples=40,
                  virtual_stages=v)
        t = TPIPE.init_feedback_state(_policies(TPOL, mode), (3, 8), **kw)
        j = JPIPE.init_feedback_state(_policies(JPOL, mode), (3, 8), **kw)
        for d in ("fw", "bw"):
            assert t[d].mode == j[d].mode and t[d].direction == d
            assert tuple(t[d].resid.shape) == tuple(j[d].resid.shape)
            assert tuple(t[d].mirror.shape) == tuple(j[d].mirror.shape)


@pytest.mark.parametrize("scheme", sorted(TPIPE.SCHEME_POLICIES))
@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_wire_telemetry_matches(scheme, schedule, pallas):
    from repro.transport.schedules import get_schedule as jget
    from repro_torch.transport.schedules import get_schedule as tget
    shape = (8, 128, 64)
    tpol = TPIPE.SCHEME_POLICIES[scheme](0.1)
    jpol = JPIPE.SCHEME_POLICIES[scheme](0.1)
    tsch, jsch = tget(schedule), jget(schedule)
    got = TPIPE.wire_telemetry(
        TPIPE.PipelineTransport(tpol, 4, fused=tsch.fused_wire), tsch,
        shape, microbatches=4)
    want = JPIPE.wire_telemetry(
        JPIPE.PipelineTransport(jpol, "stage", 4, fused=jsch.fused_wire),
        jsch, shape, jnp.bfloat16, microbatches=4)
    want.pop("axis")
    assert got == want
