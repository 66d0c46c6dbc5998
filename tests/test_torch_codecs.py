"""Parity of the port's wire codecs, kernels' plain versions and serving
boundary with the JAX package, on the same numpy inputs.

Exact outputs are compared bitwise: q4/q8 bytes, min and scale, TopK
thresholds, index sets and the dense unpack, payload sizes.  The one float
allowance: the JAX Pallas q4 unpack may contract ``codes*scale+min`` into
an FMA (``repro/kernels/pack4.py`` documents 1 ulp); the port's kernel and
plain version never do, and match the JAX jnp path bitwise.

The JAX Pallas path runs in interpret mode, by setting
``repro.core.compressors.KERNEL_BACKEND = "pallas"`` as
tests/test_codec_kernels.py does.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.core.compressors as JC
from repro.core import boundary as JB
from repro.kernels import pack4 as JP4
from repro.kernels import ref as JREF
from repro.kernels import topk_select as JTS
from repro.launch.train import POLICIES as JPOL
from repro.transport import codecs as JX

import repro_torch.core.compressors as TC
from repro_torch import device as D
from repro_torch.checkpoint.convert import tensor_from_numpy
from repro_torch.core import boundary as TB
from repro_torch.core.policy import POLICIES as TPOL
from repro_torch.kernels import pack4 as TP4
from repro_torch.kernels import topk_select as TTS
from repro_torch.transport import codecs as TX


@pytest.fixture
def jax_backend():
    """Switch the JAX package between its jnp path and its Pallas kernels
    (interpret mode); restored afterwards."""
    prev = JC.KERNEL_BACKEND

    def use(name):
        JC.KERNEL_BACKEND = name
    yield use
    JC.KERNEL_BACKEND = prev


def _inputs(shape, kind="randn", seed=0):
    rng = np.random.RandomState(seed)
    if kind == "constant":
        return np.full(shape, 3.25, np.float32)
    if kind == "ties":
        return rng.randint(-3, 4, size=shape).astype(np.float32)
    return rng.randn(*shape).astype(np.float32)


def _np(a):
    """JAX array or tensor -> numpy (bf16 via float32, exact)."""
    if isinstance(a, torch.Tensor):
        a = a.float() if a.dtype == torch.bfloat16 else a
        return a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _bits_equal(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.dtype == b.dtype, \
        (a.shape, a.dtype, b.shape, b.dtype)
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                  b.reshape(-1).view(np.uint8))


CASES = [((4, 255), "randn"), ((2, 7), "randn"), ((1, 767), "randn"),
         ((4, 768), "randn"), ((3, 129), "ties"), ((4, 129), "constant")]


# ---------------------------------------------------------------------------
# q4 / q8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,kind", CASES)
def test_q4_pack_bytes_match_jnp_and_pallas(shape, kind, jax_backend):
    x = _inputs(shape, kind)
    port = TX.get_codec("q4").pack(torch.from_numpy(x))
    jax_backend("jnp")
    jnp_p = JX.get_codec("q4").pack(jnp.asarray(x))
    packed, mn, sc = JP4.pack4_wire(jnp.asarray(x), interpret=True)
    for key, pallas in (("codes4", packed), ("min", mn), ("scale", sc)):
        _bits_equal(port[key], jnp_p[key])
        _bits_equal(port[key], pallas)


@pytest.mark.parametrize("shape,kind", CASES)
def test_q4_unpack(shape, kind, jax_backend):
    x = _inputs(shape, kind)
    jax_backend("jnp")
    jp = JX.get_codec("q4").pack(jnp.asarray(x))
    packed = tensor_from_numpy(np.asarray(jp["codes4"]), "cpu")
    m, n = shape
    # the port's kernel reads the per-tensor pair once per row
    mn = tensor_from_numpy(np.asarray(jp["min"]), "cpu").expand(m)
    sc = tensor_from_numpy(np.asarray(jp["scale"]), "cpu").expand(m)
    got = TP4.unpack4_wire(packed, mn, sc, n)
    _bits_equal(got, TP4.unpack4_wire_plain(packed, mn, sc, n))
    _bits_equal(got, JX.get_codec("q4").unpack(jp, shape, jnp.float32))
    # the Pallas kernel may contract to an FMA: within 1 f32 ulp of the
    # largest magnitude (the bound of tests/test_codec_kernels.py)
    pallas = _np(JP4.unpack4_wire(jp["codes4"], jp["min"], jp["scale"], n,
                                  interpret=True))
    tol = 1.2e-7 * max(float(np.abs(pallas).max()), 1.0)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=tol)


@pytest.mark.parametrize("shape,kind", CASES)
def test_q8_pack_unpack_match_jnp(shape, kind, jax_backend):
    x = _inputs(shape, kind)
    jax_backend("jnp")
    port = TX.get_codec("q8").pack(torch.from_numpy(x))
    ref = JX.get_codec("q8").pack(jnp.asarray(x))
    assert set(port) == set(ref)
    for key in ref:
        _bits_equal(port[key], ref[key])
    _bits_equal(TX.get_codec("q8").unpack(port, shape, torch.float32),
                JX.get_codec("q8").unpack(ref, shape, jnp.float32))


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_dequantize_matches(bits):
    x = _inputs((3, 40, 8))
    _bits_equal(TC.quantize_dequantize(torch.from_numpy(x), bits),
                JC.quantize_dequantize(jnp.asarray(x), bits))


# ---------------------------------------------------------------------------
# TopK
# ---------------------------------------------------------------------------

TOPK_CASES = CASES + [((2, 4096), "ties"), ((1, 65536), "randn"),
                      ((1, 65537), "randn")]
# Interpret-mode Pallas costs seconds per call: a few cases cover it.
PALLAS_TOPK_CASES = [((4, 768), "randn", "bfloat16"),
                     ((3, 129), "ties", "float32"),
                     ((4, 129), "constant", "bfloat16"),
                     ((1, 767), "randn", "float32"),
                     ((1, 65537), "randn", "bfloat16")]


def _topk_inputs(shape, kind, dtype):
    xj = jnp.asarray(_inputs(shape, kind), dtype)
    return xj, tensor_from_numpy(np.asarray(xj), "cpu"), \
        max(1, int(round(0.1 * shape[1])))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,kind", TOPK_CASES)
def test_topk_select_matches_lax_top_k(shape, kind, dtype):
    """Threshold = lax.top_k's k-th magnitude, bitwise; the index set is
    lax.top_k's (ties toward the lower index), ascending; values gathered."""
    xj, xt, k = _topk_inputs(shape, kind, dtype)
    top_vals, top_idx = jax.lax.top_k(jnp.abs(xj.astype(jnp.float32)), k)
    _bits_equal(TTS.topk_threshold(xt, k), top_vals[:, -1:])
    vals, idx = TTS.topk_select_wire(xt, k)
    assert vals.dtype == xt.dtype and idx.dtype == torch.int32
    want_idx = np.sort(np.asarray(top_idx), axis=1).astype(np.int32)
    _bits_equal(idx, want_idx)
    _bits_equal(vals, jnp.take_along_axis(xj, jnp.asarray(want_idx), axis=1))


@pytest.mark.parametrize("shape,kind,dtype", PALLAS_TOPK_CASES)
def test_topk_select_matches_pallas(shape, kind, dtype):
    xj, xt, k = _topk_inputs(shape, kind, dtype)
    _bits_equal(TTS.topk_threshold(xt, k),
                JTS.topk_threshold(xj, k, interpret=True))
    vals, idx = TTS.topk_select_wire(xt, k)
    jv, ji = JTS.topk_select_wire(xj, k, interpret=True)
    _bits_equal(idx, ji)
    _bits_equal(vals, jv)


@pytest.mark.parametrize("shape,kind", TOPK_CASES)
def test_topk_codec_pack_unpack(shape, kind, jax_backend):
    x = _inputs(shape, kind)
    port = TX.get_codec("topk").pack(torch.from_numpy(x), 0.1)
    backends = ("jnp", "pallas") if shape in ((4, 768), (1, 65537)) \
        else ("jnp",)
    for backend in backends:
        jax_backend(backend)
        ref = JX.get_codec("topk").pack(jnp.asarray(x), 0.1)
        assert port["idx"].dtype == (torch.uint16 if shape[1] <= 65536
                                     else torch.int32)
        assert _np(port["idx"]).dtype == _np(ref["idx"]).dtype
        _bits_equal(TX.get_codec("topk").unpack(port, shape, torch.float32),
                    JX.get_codec("topk").unpack(ref, shape, jnp.float32))
        assert TX.wire_bytes(port) == JX.wire_bytes(ref)


@pytest.mark.parametrize("shape,kind", CASES)
def test_topk_values_indices_in_lax_order(shape, kind):
    x = _inputs(shape, kind)
    vals, idx = TC.topk_values_indices(torch.from_numpy(x), 0.25)
    jv, ji = JC.topk_values_indices(jnp.asarray(x), 0.25)
    _bits_equal(idx, ji)
    _bits_equal(vals, jv)
    _bits_equal(TC.topk_compress(torch.from_numpy(x), 0.25),
                JC.topk_compress(jnp.asarray(x), 0.25))


# ---------------------------------------------------------------------------
# registry, cost model, serving boundary
# ---------------------------------------------------------------------------

def test_registry_and_dispatch():
    assert TX.registered_codecs() == JX.registered_codecs()
    x = torch.from_numpy(_inputs((2, 10, 6)))
    for name in TX.registered_codecs():
        p = TX.pack_payload(x, name, 0.25)
        y = TX.unpack_payload(p, x.shape, torch.float32)
        assert y.shape == x.shape
    with pytest.raises(ValueError, match="match no registered codec"):
        TX.unpack_payload({"codes4": None, "min": None}, x.shape)
    with pytest.raises(ValueError, match="unknown wire scheme"):
        TX.get_codec("q2")


@pytest.mark.parametrize("name", ["none", "q8", "q4", "topk"])
@pytest.mark.parametrize("shape", [(2, 7, 33), (1, 4, 768), (1, 65537)])
def test_wire_bytes_and_cost_model(name, shape, jax_backend):
    x = _inputs(shape)
    jax_backend("jnp")
    port = TX.get_codec(name).pack(torch.from_numpy(x), 0.1)
    ref = JX.get_codec(name).pack(jnp.asarray(x), 0.1)
    assert TX.wire_bytes(port) == JX.wire_bytes(ref)
    n = int(np.prod(shape[1:]))
    assert TX.get_codec(name).wire_bytes_per_elem(n, 2, 0.1) == \
        JX.get_codec(name).wire_bytes_per_elem(n, 2, 0.1)


@pytest.mark.parametrize("policy", sorted(TPOL))
@pytest.mark.parametrize("d", [64, 768])
def test_policies_and_wire_bytes_per_token(policy, d):
    tp, jp = TPOL[policy](), JPOL[policy]()
    assert tp.name == jp.name and tp.num_boundaries == jp.num_boundaries
    for cuts in (None, 1):
        assert TB.boundary_wire_bytes_per_token(tp, d, cuts) == \
            JB.boundary_wire_bytes_per_token(jp, d, cuts)
    comp_t, comp_j = tp.at(0).fw, jp.at(0).fw
    assert comp_t.name == comp_j.name
    for n in (None, 100, 70000):
        assert comp_t.wire_bytes_per_elem(2, n) == \
            comp_j.wire_bytes_per_elem(2, n)


@pytest.mark.parametrize("policy", ["q4q8", "top10"])
@pytest.mark.parametrize("shape,jax_path", [((3, 5, 64), "jnp"),
                                            ((4, 1, 768), "jnp"),
                                            ((2, 9, 33), "jnp"),
                                            ((3, 5, 64), "pallas")])
def test_boundary_wire_eval_matches_vmap(policy, shape, jax_path,
                                         jax_backend):
    """Row b of the port's batched cut is request b's own payload: bitwise
    the reference's jax.vmap-per-request pack/unpack (bf16 activations).
    Against the Pallas q4 path the f32 unpack may differ by its FMA ulp,
    which the bf16 cast absorbs here."""
    x = jnp.asarray(_inputs(shape, seed=3), jnp.bfloat16)
    rows = np.asarray(x).copy()
    rows[1:] *= 4.0                       # per-request scales must differ
    x = jnp.asarray(rows)
    jax_backend(jax_path)
    ref = JB.boundary_wire_eval(JPOL[policy]().at(0), x, True)
    got = TB.boundary_wire_eval(TPOL[policy]().at(0),
                                tensor_from_numpy(np.asarray(x), "cpu"), True)
    assert got.dtype == torch.bfloat16
    _bits_equal(got, ref)
    # and per request, not per batch: a lone row gives the same bytes
    alone = TB.boundary_wire_eval(TPOL[policy]().at(0),
                                  tensor_from_numpy(np.asarray(x[1:2]), "cpu"),
                                  True)
    _bits_equal(alone, got[1:2])


def test_boundary_eval_and_compressor_call(jax_backend):
    # C(x) is the per-tile / block-TopK function on every device in the
    # port: the reference's kernel path (interpret mode here).  n = 96 is
    # not a multiple of 128, so both take one whole-tensor tile; the
    # quantizer is held to the reference's eager oracle for it, because
    # the jitted wrapper rewrites the scale division and, in f32, fuses
    # the dequant into an FMA (tests/test_torch_kernels.py measures both).
    jax_backend("pallas")
    x = _inputs((2, 6, 16))
    for policy in ("none", "top10"):
        _bits_equal(TB.boundary_eval(TPOL[policy]().at(0),
                                     torch.from_numpy(x), True),
                    JB.boundary_eval(JPOL[policy]().at(0), jnp.asarray(x),
                                     True))
    for bits in (4, 8):
        _bits_equal(TC.quant(bits)(torch.from_numpy(x)),
                    JREF.quant_dequant_ref(jnp.asarray(x.reshape(2, -1)),
                                           bits, block=(2, 96))
                    .reshape(x.shape))


def test_plain_backend_and_bad_backend(monkeypatch):
    x = torch.from_numpy(_inputs((2, 33)))
    monkeypatch.setattr(D, "KERNEL_BACKEND", "plain")
    plain = TX.get_codec("q4").pack(x)
    monkeypatch.setattr(D, "KERNEL_BACKEND", "auto")
    auto = TX.get_codec("q4").pack(x)
    for key in plain:
        _bits_equal(plain[key], auto[key])
    monkeypatch.setattr(D, "KERNEL_BACKEND", "pallas")
    with pytest.raises(ValueError, match="KERNEL_BACKEND"):
        TX.get_codec("q4").pack(x)


def test_kernel_wrappers_check_inputs():
    mn, sc = torch.zeros(4), torch.ones(4)
    with pytest.raises(ValueError, match="float32"):
        TP4.pack4_wire(torch.zeros(4, 8, dtype=torch.float64), mn, sc)
    with pytest.raises(ValueError, match=r"min/scale must be \(4,\)"):
        TP4.pack4_wire(torch.zeros(4, 8), mn[:1], sc[:1])
    with pytest.raises(ValueError, match="ceil"):
        TP4.unpack4_wire(torch.zeros(4, 3, dtype=torch.uint8), mn, sc, 9)
    with pytest.raises(ValueError, match="min/scale"):
        TP4.unpack4_wire(torch.zeros(4, 5, dtype=torch.uint8), mn[:2], sc, 9)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        TTS.topk_select_wire(torch.zeros(2, 8, dtype=torch.float16), 2)
    with pytest.raises(ValueError, match="k <= n"):
        TTS.topk_select_wire(torch.zeros(2, 8), 9)
