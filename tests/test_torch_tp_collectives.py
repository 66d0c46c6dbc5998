"""The port's compressed tensor-parallel collectives
(``transport/tp_collectives.py``) against the JAX package's.

In process (the reference's pure functions need one device): the payload
structs and wire reports for ``none``, ``q8``, ``q4`` and ``topk`` at tp
2 and 4 and several shapes, ``init_tp_state``'s shapes and modes, the
validation's error classes, tp = 1 passing through, and ``tp_local``'s
weight slices.

Against the reference's collectives: ONE module-scoped subprocess with 4
forced host devices runs ``TPCollectives(Mesh(devices[:tp], ("tensor",)),
"tensor", ...)`` (an Auto-axis mesh) inside ``shard_map`` under
``jax.jit``, for each codec and tp in {2, 4}, on the same bf16 inputs as
the port: the all-gather and the reduce-scatter, the VJPs of ``gather``
and ``scatter`` (gather <-> reduce-scatter), and one EF and one EF21
``gather`` (the new ``resid`` / ``mirror``).  Bounds:
  * ``none``: every output bitwise the reference's, and the
    reduce-scatter bitwise the single-device rank-ordered bf16 sum
    ``((p_0 + p_1) + p_2) + p_3`` computed here in torch, the association
    the reference's docstring promises;
  * q8 / q4: every element within one code step of each source it sums
    (``sum_s span_s / levels``, the rule of
    tests/test_torch_collectives.py for the jitted reference's ``span *
    f32(1 / levels)`` scale and FMA-contracted dequant) plus one bf16 ulp
    of the result per addend, since the decode casts each source to bf16;
    EF's ``resid`` within its own code step plus a bf16 ulp of the
    decode it subtracts, EF21's ``mirror`` within its code step plus a
    bf16 ulp (measured: q8 and q4 move at most one code of one element);
  * TopK: the same bits, except EF21's ``mirror``: the jitted reference
    stores the f32 sum ``M + delta`` where its code casts the bf16 one
    (XLA's excess precision on the CPU), so the port's mirror, bitwise
    its gathered activation as the code says, is within one bf16 ulp;
  * the ring's counted hops and bytes equal ``tp_wire_report``'s exact
    numbers times the ``tp`` ranks, for each collective.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.transport.tp_collectives as JTP
from repro.core.parallel import AxisSpec as JAxisSpec
from repro.core.parallel import ParallelSpec as JParallelSpec

from repro_torch.core.parallel import AxisSpec, ParallelSpec
from repro_torch.transport import codecs as TCODEC
from repro_torch.transport import tp_collectives as TTP

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FULL = (2, 16, 24)                       # (B, S, d) full activation
TPS = (2, 4)
CODECS = {"none": 0.1, "q8": 0.1, "q4": 0.1, "topk": 0.1}
LEVELS = {"q8": 255.0, "q4": 15.0}


def bf16(a):
    """float32 numpy rounded to bf16 (and back to float32)."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def inputs(codec: str, tp: int):
    """The bf16 inputs of one (codec, tp) case, as float32 numpy: the full
    activation, every rank's partial output and gather cotangent, the
    scatter cotangent, and a nonzero EF resid / EF21 mirror (f32)."""
    rng = np.random.RandomState(list(CODECS).index(codec) * 10 + tp)
    return {"x": bf16(rng.randn(*FULL) * 2.0),
            "partial": bf16(rng.randn(tp, *FULL)),
            "ct_gather": bf16(rng.randn(tp, *FULL)),
            "ct_scatter": bf16(rng.randn(*FULL)),
            "resid": (rng.randn(*FULL) * 0.1).astype(np.float32),
            "mirror": (rng.randn(*FULL) * 2.0).astype(np.float32)}


REFERENCE = r'''
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.transport.base import shard_map_compat
from repro.transport.tp_collectives import TPCollectives
sys.path.insert(0, sys.argv[2])
import test_torch_tp_collectives as T

out = {}
SEQ = P(None, "tensor", None)
RANKS = P("tensor", None, None, None)
for tp in T.TPS:
    mesh = Mesh(np.array(jax.devices()[:tp]), ("tensor",))
    for codec, k in T.CODECS.items():
        inp = {n: jnp.asarray(v, jnp.bfloat16 if n not in ("resid", "mirror")
                              else jnp.float32)
               for n, v in T.inputs(codec, tp).items()}
        tpc = TPCollectives(mesh, "tensor", codec=codec, k_frac=k)
        sm = lambda f, i, o: jax.jit(shard_map_compat(f, mesh, i, o))
        out[f"{codec}/{tp}/ag"] = sm(lambda x: tpc.all_gather_wire(x)[None],
                                     (SEQ,), RANKS)(inp["x"])
        out[f"{codec}/{tp}/rs"] = sm(
            lambda p: tpc.reduce_scatter_wire(p[0]), (RANKS,), SEQ)(
                inp["partial"])

        def gvjp(x, ct):
            _, f = jax.vjp(lambda a: tpc.gather(a)[0], x)
            return f(ct[0])[0]
        out[f"{codec}/{tp}/gvjp"] = sm(gvjp, (SEQ, RANKS), SEQ)(
            inp["x"], inp["ct_gather"])

        def svjp(p, ct):
            _, f = jax.vjp(tpc.scatter, p[0])
            return f(ct)[0][None]
        out[f"{codec}/{tp}/svjp"] = sm(svjp, (RANKS, SEQ), RANKS)(
            inp["partial"], inp["ct_scatter"])
        if codec == "none":
            continue
        ef = TPCollectives(mesh, "tensor", codec=codec, k_frac=k,
                           feedback="ef")
        full, res = sm(lambda x, r: (lambda o: (o[0][None], o[1]))(
            ef.gather(x, resid=r)), (SEQ, SEQ), (RANKS, SEQ))(
                inp["x"], inp["resid"])
        out[f"{codec}/{tp}/ef_full"], out[f"{codec}/{tp}/ef_resid"] = full, res
        ef21 = TPCollectives(mesh, "tensor", codec=codec, k_frac=k,
                             feedback="ef21")
        full, mir = sm(lambda x, m: (lambda o: (o[0][None], o[2][None]))(
            ef21.gather(x, mirror=m)), (SEQ, P()), (RANKS, RANKS))(
                inp["x"], inp["mirror"])
        out[f"{codec}/{tp}/ef21_full"] = full
        out[f"{codec}/{tp}/ef21_mirror"] = mir
np.savez(sys.argv[1], **{k: np.asarray(jnp.asarray(v, jnp.float32))
                         for k, v in out.items()})
print("REFERENCE_OK")
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("tp_ref") / "ref.npz"
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


def _t(a, dtype=torch.bfloat16):
    return torch.from_numpy(np.array(a)).to(dtype)


def _np(t):
    return t.detach().float().numpy()


def _shards(a, tp):
    return np.split(a, tp, axis=1)


def _step(a, codec):
    """One code step of a source packed per tensor: its span / levels."""
    return (float(a.max()) - float(a.min())) / LEVELS[codec]


def _bf16_ulp(a):
    """One bf16 ulp of every element of ``a`` (at least the smallest
    normal's), elementwise."""
    m = np.maximum(np.abs(a), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(m)) - 7)


# ---------------------------------------------------------------------------
# pure functions, in process
# ---------------------------------------------------------------------------

def _jstruct_to_port(tree):
    def one(a):
        dt = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32,
              jnp.uint8: torch.uint8, jnp.uint16: torch.uint16,
              jnp.int32: torch.int32}[jnp.dtype(a.dtype).type]
        return TCODEC.LeafStruct(tuple(a.shape), dt)
    return jax.tree.map(one, tree)


@pytest.mark.parametrize("codec", list(CODECS))
@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("feat", [(2, 16, 24), (8, 128, 768), (3, 12, 5),
                                  (1, 4096, 64)])
def test_payload_struct_and_wire_report_match_reference(codec, tp, feat):
    k = CODECS[codec]
    shard = (feat[0], feat[1] // tp, *feat[2:])
    got = TTP.tp_payload_struct(shard, codec, k_frac=k)
    want = JTP.tp_payload_struct(shard, codec, k_frac=k)
    assert got == _jstruct_to_port(want)
    for sites in (1, 24):
        assert TTP.tp_wire_report(feat, tp, codec, k_frac=k,
                                  sites=sites) == \
            JTP.tp_wire_report(feat, tp, codec, k_frac=k, sites=sites)


def test_wire_report_refuses_an_indivisible_sequence():
    for mod in (TTP, JTP):
        with pytest.raises(ValueError, match="not divisible by tp=4"):
            mod.tp_wire_report((2, 6, 8), 4, "q8")


@pytest.mark.parametrize("feedback", ["none", "ef", "ef21"])
def test_init_tp_state_matches_reference(feedback):
    j = JTP.init_tp_state((4, 8, 16), 6, feedback)
    t = TTP.init_tp_state((4, 8, 16), 6, feedback)
    assert (t.scope, t.direction, t.mode) == (j.scope, j.direction, j.mode)
    for slot in ("resid", "mirror", "agg"):
        a, b = getattr(j, slot), getattr(t, slot)
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32
        assert not b.any()


def test_feedback_modes_and_validation_match_reference():
    assert TTP.TP_FEEDBACK_MODES == JTP.TP_FEEDBACK_MODES == \
        ("none", "ef", "ef21")
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("tensor",))
    for kw in (dict(codec="q8", feedback="aqsgd"),
               dict(codec="none", feedback="ef"),
               dict(codec="none", feedback="ef21")):
        with pytest.raises(ValueError) as want:
            JTP.TPCollectives(mesh, "tensor", **kw)
        with pytest.raises(ValueError) as got:
            TTP.TPCollectives(2, **kw)
        assert str(got.value) == str(want.value)
    for mod in (JTP, TTP):
        with pytest.raises(ValueError, match="unknown tp feedback"):
            mod.init_tp_state((2, 4, 8), 2, "efmixed")
    with pytest.raises(ValueError, match="positive int"):
        TTP.TPCollectives("tensor")
    # the spec takes the tensor axis and the tp scope's modes, as the
    # reference's does
    spec = ParallelSpec({"data": 2, "stage": 2, "tensor": AxisSpec(
        2, "q4", "ef21")})
    assert (spec.tp, spec.num_devices) == (2, 8)
    assert spec.name == "data=2,stage=2,tensor=2(q4+ef21)"
    for fb in ("efmixed", "aqsgd"):
        with pytest.raises(ValueError, match="not valid on the 'tensor'"):
            ParallelSpec({"tensor": AxisSpec(2, "q8", fb)})
    with pytest.raises(ValueError, match="not valid on the 'tensor'"):
        JParallelSpec({"tensor": JAxisSpec(2, "q8", "aqsgd")})


@pytest.mark.parametrize("feedback", ["none", "ef", "ef21"])
def test_tp_one_passes_through(feedback):
    """tp = 1: no wire, the input itself, the state untouched (as the
    reference's, whose ``tp == 1`` early returns need no ``shard_map``)."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("tensor",))
    codec = "none" if feedback == "none" else "q8"
    x = np.random.RandomState(0).randn(*FULL).astype(np.float32)
    j = JTP.TPCollectives(mesh, "tensor", codec=codec, feedback=feedback)
    np.testing.assert_array_equal(np.asarray(j.all_gather_wire(x)), x)
    np.testing.assert_array_equal(np.asarray(j.scatter(x)), x)
    t = TTP.TPCollectives(1, codec=codec, feedback=feedback)
    xt = torch.from_numpy(x)
    buf = torch.ones(FULL)
    fulls, out_buf = t.gather_site([xt], buf)
    assert fulls[0] is xt and out_buf is buf
    assert t.scatter([xt])[0] is xt
    assert t.all_gather_wire([xt]) is xt
    assert t.wire == {"tp_hops": 0, "tp_bytes": 0}


def test_tp_local_slices_the_leaves():
    """Column-parallel leaves split on their last dim, ``wo`` on its
    second-to-last, replicated leaves whole; the slices are views."""
    from repro_torch.models.transformer import tp_param_dims
    stack = {"attn": {"wq": torch.arange(24.).reshape(2, 3, 4),
                      "wo": torch.arange(24.).reshape(2, 4, 3)},
             "ln1": {"scale": torch.ones(2, 3)}}
    dims = tp_param_dims(stack)
    assert dims == {"attn": {"wq": 2, "wo": 1}, "ln1": {"scale": -1}}
    r1 = TTP.tp_local(stack, dims, 2, 1)
    assert torch.equal(r1["attn"]["wq"], stack["attn"]["wq"][..., 2:])
    assert torch.equal(r1["attn"]["wo"], stack["attn"]["wo"][:, 2:])
    assert r1["ln1"]["scale"] is stack["ln1"]["scale"]
    assert r1["attn"]["wq"].untyped_storage().data_ptr() == \
        stack["attn"]["wq"].untyped_storage().data_ptr()
    with pytest.raises(ValueError, match="not divisible by tp=3"):
        TTP.tp_local(stack, dims, 3, 0)


# ---------------------------------------------------------------------------
# the collectives against the reference's, in shard_map
# ---------------------------------------------------------------------------

def _port(codec, tp, feedback="none"):
    return TTP.TPCollectives(tp, codec=codec, k_frac=CODECS[codec],
                             feedback=feedback)


def _rank_ordered_sum(parts):
    """The single-device association: bf16 adds in source-rank order."""
    acc = None
    for p in parts:
        acc = p if acc is None else acc + p
    return acc


def _check_sum(got, want, sources, codec, where):
    """``got`` / ``want``: rank r's slice of a sum over ``sources`` (each
    the per-source float32 numpy input of the slice).  The bf16 ulps are
    those of the larger of the result and the sources' magnitudes (EF's
    resid is small, the decode it subtracts is not)."""
    mag = np.maximum(np.abs(want), sum(np.abs(s) for s in sources))
    tol = len(sources) * _bf16_ulp(mag)
    if codec in LEVELS:
        tol = tol + sum(_step(s, codec) for s in sources) * (1 + 1e-5)
    assert np.all(np.abs(got - want) <= tol), where


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("codec", list(CODECS))
def test_all_gather_matches_reference(codec, tp, ref):
    inp = inputs(codec, tp)
    tpc = _port(codec, tp)
    got = _np(tpc.all_gather_wire([_t(s) for s in _shards(inp["x"], tp)]))
    want = ref[f"{codec}/{tp}/ag"]
    for r in range(tp):                  # every rank holds the same bits
        np.testing.assert_array_equal(want[r], want[0])
    rep = TTP.tp_wire_report(FULL, tp, codec, k_frac=CODECS[codec])
    assert tpc.wire == {"tp_hops": tp * (tp - 1),
                        "tp_bytes": tp * rep["wire_bytes_per_collective"]}
    if codec in ("none", "topk"):
        np.testing.assert_array_equal(got, want[0])
        return
    for s, (gs, ws, xs) in enumerate(zip(_shards(got, tp),
                                         _shards(want[0], tp),
                                         _shards(inp["x"], tp))):
        _check_sum(gs, ws, [xs], codec, ("shard", s))


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("codec", list(CODECS))
def test_reduce_scatter_matches_reference(codec, tp, ref):
    inp = inputs(codec, tp)
    tpc = _port(codec, tp)
    parts = [_t(p) for p in inp["partial"]]
    got = tpc.reduce_scatter_wire(parts)
    want = _shards(ref[f"{codec}/{tp}/rs"], tp)
    rep = TTP.tp_wire_report(FULL, tp, codec, k_frac=CODECS[codec])
    assert tpc.wire == {"tp_hops": tp * (tp - 1),
                        "tp_bytes": tp * rep["wire_bytes_per_collective"]}
    for r in range(tp):
        srcs = [_shards(p, tp)[r] for p in inp["partial"]]
        if codec == "none":
            # bitwise the single-device rank-ordered association
            want_r = _rank_ordered_sum([_shards_t(p, tp)[r] for p in parts])
            assert torch.equal(got[r], want_r)
        if codec in ("none", "topk"):
            np.testing.assert_array_equal(_np(got[r]), want[r])
            continue
        _check_sum(_np(got[r]), want[r], srcs, codec, ("rank", r))


def _shards_t(t, tp):
    return list(torch.chunk(t, tp, dim=1))


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("codec", list(CODECS))
def test_gather_vjp_is_the_compressed_reduce_scatter(codec, tp, ref):
    """The gradient of every rank's shard: the compressed reduce-scatter
    of the ranks' cotangents, as the reference's VJP."""
    inp = inputs(codec, tp)
    tpc = _port(codec, tp)
    xs = [_t(s).requires_grad_(True) for s in _shards(inp["x"], tp)]
    fulls, _, _ = tpc.gather(xs)
    assert all(f.untyped_storage().data_ptr() ==
               fulls[0].untyped_storage().data_ptr() for f in fulls)
    cts = [_t(c) for c in inp["ct_gather"]]
    torch.autograd.backward(fulls, cts)
    want = _shards(ref[f"{codec}/{tp}/gvjp"], tp)
    rep = TTP.tp_wire_report(FULL, tp, codec, k_frac=CODECS[codec])
    assert tpc.wire == {"tp_hops": 2 * tp * (tp - 1),
                        "tp_bytes": 2 * tp * rep["wire_bytes_per_collective"]}
    for r, x in enumerate(xs):
        np.testing.assert_array_equal(
            _np(x.grad), _np(tpc.reduce_scatter_wire(cts)[r]))
        if codec in ("none", "topk"):
            np.testing.assert_array_equal(_np(x.grad), want[r])
            continue
        _check_sum(_np(x.grad), want[r],
                   [_shards(c, tp)[r] for c in inp["ct_gather"]], codec,
                   ("rank", r))


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("codec", list(CODECS))
def test_scatter_vjp_is_the_compressed_all_gather(codec, tp, ref):
    inp = inputs(codec, tp)
    tpc = _port(codec, tp)
    parts = [_t(p).requires_grad_(True) for p in inp["partial"]]
    shards = tpc.scatter(parts)
    torch.autograd.backward(shards, _shards_t(_t(inp["ct_scatter"]), tp))
    want = ref[f"{codec}/{tp}/svjp"]
    for r, p in enumerate(parts):
        got = _np(p.grad)
        np.testing.assert_array_equal(got, _np(parts[0].grad))
        if codec in ("none", "topk"):
            np.testing.assert_array_equal(got, want[r])
            continue
        for s, (gs, ws, cs) in enumerate(zip(
                _shards(got, tp), _shards(want[r], tp),
                _shards(inp["ct_scatter"], tp))):
            _check_sum(gs, ws, [cs], codec, ("rank", r, "shard", s))


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("codec", ["q8", "q4", "topk"])
def test_ef_gather_matches_reference(codec, tp, ref):
    """EF: the wire carries C(x + e); the new resid x + e - C(x + e) stays
    sequence-sharded, and no gradient reaches it."""
    inp = inputs(codec, tp)
    tpc = _port(codec, tp, "ef")
    xs = [_t(s) for s in _shards(inp["x"], tp)]
    resid = torch.from_numpy(inp["resid"])
    fulls, new_resid, mirror = tpc.gather(xs, resid=resid)
    assert mirror is None and not new_resid.requires_grad
    assert new_resid.dtype == torch.float32 and new_resid.shape == FULL
    assert torch.equal(resid, torch.from_numpy(inp["resid"]))   # not in place
    want_full = ref[f"{codec}/{tp}/ef_full"][0]
    want_resid = ref[f"{codec}/{tp}/ef_resid"]
    if codec == "topk":
        np.testing.assert_array_equal(_np(fulls[0]), want_full)
        np.testing.assert_array_equal(_np(new_resid), want_resid)
        return
    xe = [bf16(x + bf16(e)) for x, e in zip(_shards(inp["x"], tp),
                                            _shards(inp["resid"], tp))]
    for s in range(tp):
        _check_sum(_shards(_np(fulls[0]), tp)[s], _shards(want_full, tp)[s],
                   [xe[s]], codec, ("full", s))
        _check_sum(_shards(_np(new_resid), tp)[s],
                   _shards(want_resid, tp)[s], [xe[s]], codec, ("resid", s))


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("codec", ["q8", "q4", "topk"])
def test_ef21_gather_matches_reference(codec, tp, ref):
    """EF21: the wire carries C(x - M_r); the gathered activation is the
    updated replicated model M, which every rank holds."""
    inp = inputs(codec, tp)
    tpc = _port(codec, tp, "ef21")
    xs = [_t(s) for s in _shards(inp["x"], tp)]
    mirror = torch.from_numpy(inp["mirror"])
    fulls, resid, new_mirror = tpc.gather(xs, mirror=mirror)
    assert resid is None and not new_mirror.requires_grad
    np.testing.assert_array_equal(_np(new_mirror), _np(fulls[0]))
    want_full = ref[f"{codec}/{tp}/ef21_full"][0]
    want_mirror = ref[f"{codec}/{tp}/ef21_mirror"]
    for r in range(tp):
        np.testing.assert_array_equal(want_mirror[r], want_mirror[0])
    if codec == "topk":
        np.testing.assert_array_equal(_np(fulls[0]), want_full)
        # the jitted reference stores the f32 sum M + delta where its code
        # casts the bf16 one (XLA's excess precision): one bf16 ulp
        assert np.all(np.abs(_np(new_mirror) - want_mirror[0])
                      <= _bf16_ulp(want_mirror[0]))
        return
    delta = [bf16(x - bf16(m)) for x, m in zip(_shards(inp["x"], tp),
                                               _shards(inp["mirror"], tp))]
    for s in range(tp):
        for got, want in ((fulls[0], want_full),
                          (new_mirror, want_mirror[0])):
            _check_sum(_shards(_np(got), tp)[s], _shards(want, tp)[s],
                       [delta[s]], codec, ("mirror", s))
