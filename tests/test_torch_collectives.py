"""The port's compressed DP gradient all-reduce
(``transport/collectives.py``) against the JAX package's.

In-process, eager: payloads, payload structs, wire reports, fusion round
trips and the DP state's structure, on a ragged gradient tree (an odd
leaf (7,), (5, 33), a rank-3 stack (2, 3, 17), a bf16 leaf (4, 9)).

Against the reference's reduce: ONE module-scoped subprocess with 4
forced host devices runs ``make_grad_all_reduce(jax.make_mesh((dp,),
("data",)), "data", ...)`` under ``jax.jit`` (its ``shard_map`` does not
run eagerly in jax 0.9) on the same per-replica numpy gradients and DP
state as the port's reduce, and returns the reduced gradient, ``resid``
and ``agg``.  Bounds:
  * codec ``none``: bitwise with ``average=False`` and for a power-of-two
    dp.  With ``average=True`` and dp = 3 the jitted reference multiplies
    by ``f32(1/3)`` where the port divides by 3 (IEEE): the test holds
    each package to its own arithmetic bitwise, in numpy, and the bf16
    leaf, whose division rounds to bf16 either way, to each other;
  * q8 / q4 with feedback none / ef / ef21, dp 2, 3, 4 (``average=True``,
    as the train step calls it): every element of the reduced gradient
    and ``agg`` within one code step of each source, ``sum_s scale_s``,
    and ``resid`` within one code step of its own source, the rule
    ``ROADMAP.md`` states for the jitted reference's ``span * f32(1 /
    levels)`` scale and FMA-contracted dequant (plus 4 f32 ulps of the
    leaf's largest magnitude, and one bf16 ulp on the bf16 leaf's
    output).  Measured: at most 1e-6 (an ulp or two), no code moved;
  * TopK, dp 2 and 4: the same kept index sets and bitwise values.
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

import repro.core.compressors as JC
from repro.transport import codecs as JCODEC
from repro.transport import collectives as JCOL

from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.kernels import dp_reduce as TK
from repro_torch.kernels import framing
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.transport import codecs as TCODEC
from repro_torch.transport import collectives as TCOL

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"a": (7,), "b": (5, 33), "c": (2, 3, 17), "d": (4, 9)}
BF16 = {"d"}
CODECS = ("none", "q8", "q4", "topk")
# name -> (codec, feedback, dp, average)
CASES = {
    "none_avg_dp3": ("none", "none", 3, True),
    "none_sum_dp3": ("none", "none", 3, False),
    "none_avg_dp4": ("none", "none", 4, True),
    **{f"{c}_{fb}_dp{dp}": (c, fb, dp, True)
       for c in ("q8", "q4") for fb in ("none", "ef", "ef21")
       for dp in (2, 3, 4)},
    "topk_avg_dp2": ("topk", "none", 2, True),
    "topk_sum_dp4": ("topk", "none", 4, False),
}


def grads_np(dp, seed):
    """Per-replica gradient leaves (dp, *leaf) as float32 numpy, the bf16
    leaf already rounded to bf16."""
    rng = np.random.RandomState(seed)
    out = {}
    for k in sorted(SHAPES):
        a = (rng.randn(dp, *SHAPES[k]) * 1.5).astype(np.float32)
        if k in BF16:
            a = np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
        out[k] = a
    return out


def state_np(dp, seed):
    """A nonzero DP state (resid (dp, *leaf), agg (*leaf)), float32."""
    rng = np.random.RandomState(seed + 100)
    resid = {k: (rng.randn(dp, *s) * 0.2).astype(np.float32)
             for k, s in sorted(SHAPES.items())}
    agg = {k: (rng.randn(*s) * 0.5).astype(np.float32)
           for k, s in sorted(SHAPES.items())}
    return resid, agg


def to_jax(g):
    return {k: jnp.asarray(v, jnp.bfloat16 if k in BF16 else jnp.float32)
            for k, v in g.items()}


def to_torch(g):
    return {k: torch.from_numpy(v.copy()).to(torch.bfloat16 if k in BF16
                                             else torch.float32)
            for k, v in g.items()}


REFERENCE = r'''
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.transport.collectives import init_dp_state, make_grad_all_reduce
sys.path.insert(0, sys.argv[2])
import test_torch_collectives as T

out = {}
for seed, (name, (codec, fb, dp, avg)) in enumerate(T.CASES.items()):
    mesh = jax.make_mesh((dp,), ("data",))
    red = jax.jit(make_grad_all_reduce(mesh, "data", codec, feedback=fb,
                                       average=avg))
    like = {k: jax.ShapeDtypeStruct(s, jnp.float32)
            for k, s in T.SHAPES.items()}
    st = init_dp_state(like, dp, fb)
    resid, agg = T.state_np(dp, seed)
    if fb != "none":
        st = st.replace(resid={k: jnp.asarray(v) for k, v in resid.items()})
    if fb == "ef21":
        st = st.replace(agg={k: jnp.asarray(v) for k, v in agg.items()})
    r, nst = red(T.to_jax(T.grads_np(dp, seed)), st)
    for k in T.SHAPES:
        out[f"{name}/red/{k}"] = np.asarray(r[k].astype(jnp.float32))
        if fb != "none":
            out[f"{name}/resid/{k}"] = np.asarray(nst.resid[k])
        if fb == "ef21":
            out[f"{name}/agg/{k}"] = np.asarray(nst.agg[k])
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("collectives_ref") / "ref.npz"
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


def _port_reduce(name):
    codec, fb, dp, avg = CASES[name]
    seed = list(CASES).index(name)
    resid, agg = state_np(dp, seed)
    st = TCOL.init_dp_state({k: torch.zeros(s) for k, s in SHAPES.items()},
                            dp, fb)
    if fb != "none":
        st = st.replace(resid=params_from_numpy(resid, "cpu"))
    if fb == "ef21":
        st = st.replace(agg=params_from_numpy(agg, "cpu"))
    red = TCOL.make_grad_all_reduce(dp, codec, feedback=fb, average=avg)
    g = grads_np(dp, seed)
    out, nst, wire = red(to_torch(g), st)
    return g, resid, out, nst, wire


def _f32(t):
    return t.detach().float().numpy()


def _ulp(a):
    return float(np.spacing(np.float32(max(float(np.abs(a).max()), 1e-30))))


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith("none")])
def test_uncompressed_reduce_is_bitwise(name, ref):
    codec, fb, dp, avg = CASES[name]
    g, _, out, _, wire = _port_reduce(name)
    assert wire == {"dp_hops": dp * (dp - 1),
                    "dp_bytes": dp * (dp - 1) * TCOL.dp_wire_report(
                        {k: v[0] for k, v in to_torch(g).items()}, "none",
                        dp=dp)["payload_bytes_per_hop"]}
    for k in SHAPES:
        got, want = _f32(out[k]), ref[f"{name}/red/{k}"]
        assert out[k].dtype == (torch.bfloat16 if k in BF16
                                else torch.float32)
        if not avg or dp & (dp - 1) == 0 or k in BF16:
            np.testing.assert_array_equal(got, want)
            continue
        # dp = 3: each package's own arithmetic, in rank order
        exact, recip = g[k][0] / np.float32(dp), g[k][0] * np.float32(1 / dp)
        for r in range(1, dp):
            exact = exact + g[k][r] / np.float32(dp)
            recip = recip + g[k][r] * np.float32(1 / dp)
        np.testing.assert_array_equal(got, exact)
        np.testing.assert_array_equal(want, recip)


def _scales(x, codec):
    levels = 255.0 if codec == "q8" else 15.0
    return (float(x.max()) - float(x.min())) / levels


@pytest.mark.parametrize("name", [n for n in CASES if n[:2] in ("q8", "q4")])
def test_quantized_reduce_within_a_code_step(name, ref):
    codec, fb, dp, avg = CASES[name]
    g, resid, out, nst, wire = _port_reduce(name)
    assert wire["dp_hops"] == dp * (dp - 1)
    for k in SHAPES:
        xs = [g[k][r] / np.float32(dp) for r in range(dp)]
        if fb == "ef":
            xs = [x + resid[k][r] for r, x in enumerate(xs)]
        elif fb == "ef21":
            xs = [x - resid[k][r] for r, x in enumerate(xs)]
        steps = [_scales(x, codec) for x in xs]
        want = ref[f"{name}/red/{k}"]
        tol = sum(steps) * (1 + 1e-5) + 4 * _ulp(want)
        if k in BF16:
            tol += _ulp(want) * 2.0 ** 16          # one bf16 ulp
        assert float(np.abs(_f32(out[k]) - want).max()) <= tol, k
        if fb != "none":
            got_r, want_r = _f32(nst.resid[k]), ref[f"{name}/resid/{k}"]
            for r in range(dp):
                assert float(np.abs(got_r[r] - want_r[r]).max()) <= \
                    steps[r] * (1 + 1e-5) + 4 * _ulp(want_r[r]), (k, r)
        if fb == "ef21":
            want_a = ref[f"{name}/agg/{k}"]
            assert float(np.abs(_f32(nst.agg[k]) - want_a).max()) <= \
                sum(steps) * (1 + 1e-5) + 4 * _ulp(want_a), k
            np.testing.assert_array_equal(
                _f32(out[k]), _f32(nst.agg[k].to(out[k].dtype)))


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith("topk")])
def test_topk_reduce_keeps_the_same_entries(name, ref):
    _, _, out, _, _ = _port_reduce(name)
    for k in SHAPES:
        got, want = _f32(out[k]), ref[f"{name}/red/{k}"]
        np.testing.assert_array_equal(got != 0, want != 0)
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# in-process: payloads, structs, wire reports, fusion, state
# ---------------------------------------------------------------------------

@pytest.fixture
def jnp_backend(monkeypatch):
    monkeypatch.setattr(JC, "KERNEL_BACKEND", "jnp")


@pytest.mark.parametrize("codec", CODECS)
def test_pack_grad_leaf_matches_reference(codec, jnp_backend):
    g = grads_np(1, 7)
    jc, tc = JCODEC.get_codec(codec), TCODEC.get_codec(codec)
    for k in sorted(SHAPES):
        jp = JCOL.pack_grad_leaf(jc, to_jax(g)[k][0])
        tp = TCOL.pack_grad_leaf(tc, to_torch(g)[k][0])
        jl, tl = jax.tree.leaves(jp), TCODEC.payload_leaves(tp)
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            assert tuple(b.shape) == a.shape, (k, b.shape, a.shape)
            want = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                              else a)
            got = _f32(b) if b.dtype == torch.bfloat16 else b.numpy()
            if codec == "topk":         # same kept set, in either order
                if b.dtype == torch.bfloat16:
                    got, want = np.sort(got), np.sort(want)
                else:
                    got, want = np.sort(got.astype(np.int64)), \
                        np.sort(want.astype(np.int64))
            np.testing.assert_array_equal(got, want)
        back = TCOL.unpack_grad_leaf(tc, tp, SHAPES[k])
        np.testing.assert_array_equal(
            _f32(back), np.asarray(JCOL.unpack_grad_leaf(
                jc, jp, SHAPES[k]).astype(jnp.float32)))


@pytest.mark.parametrize("codec", CODECS)
def test_payload_structs_and_wire_report_match(codec):
    jlike = {k: jax.ShapeDtypeStruct(s, jnp.bfloat16 if k in BF16
                                     else jnp.float32)
             for k, s in SHAPES.items()}
    tlike = {k: TCODEC.LeafStruct(s, torch.bfloat16 if k in BF16
                                  else torch.float32)
             for k, s in SHAPES.items()}
    js = JCOL.grad_payload_structs(jlike, codec, 0.3)
    ts = TCOL.grad_payload_structs(tlike, codec, 0.3)
    jl, tl = jax.tree.leaves(js), TCODEC.payload_leaves(ts)
    assert [(tuple(a.shape), jnp.dtype(a.dtype).itemsize) for a in jl] == \
        [(b.shape, b.dtype.itemsize) for b in tl]
    for dp in (2, 3):
        assert TCOL.dp_wire_report(tlike, codec, k_frac=0.3, dp=dp) == \
            JCOL.dp_wire_report(jlike, codec, k_frac=0.3, dp=dp)


@pytest.mark.parametrize("codec", CODECS)
def test_fused_round_trip_and_both_decode_paths(codec, monkeypatch):
    """fuse -> unfuse gives every payload leaf back bitwise; the fused
    reduce (the decode kernel's path for q8/q4) and the unfused loop give
    the same bits, and only q8/q4 reach ``decode_sum_fused``."""
    g = to_torch(grads_np(3, 11))
    tc = TCODEC.get_codec(codec)
    pl = [TCOL.pack_grad_leaf(tc, g[k][0].float() if codec != "none"
                              else g[k][0]) for k in sorted(SHAPES)]
    back = TCODEC.unfuse_payload(TCODEC.fuse_payload(pl),
                                 TCODEC.payload_struct(pl))
    for a, b in zip(TCODEC.payload_leaves(pl), TCODEC.payload_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    calls = []
    real = TK.decode_sum_fused
    monkeypatch.setattr(TCOL, "decode_sum_fused",
                        lambda *a: calls.append(1) or real(*a))
    st = TCOL.init_dp_state(g, 3)
    fused = TCOL.make_grad_all_reduce(3, codec, average=True)(g, st)
    loop = TCOL.make_grad_all_reduce(3, codec, average=True,
                                     fused=False)(g, st)
    assert len(calls) == (1 if codec in ("q8", "q4") else 0)
    assert fused[2] == loop[2]
    for k in SHAPES:
        assert torch.equal(fused[0][k], loop[0][k])


@pytest.mark.parametrize("n,groups", [(1, 1), (16, 1), (17, 1), (39, 1),
                                      (240, 1), (241, 2)])
def test_framing_launch_groups(n, groups):
    """The framing wrappers launch once a call for up to 240 non-empty
    segments (the kernel's by-value table), and once per group of 240
    beyond: the q8/q4 gradient payload of gpt2-small (39 segments), TopK
    (26) and raw (13) are one launch each.  Empty segments launch
    nothing."""
    sizes = [3 + i for i in range(n)]
    sizes.insert(n // 2, 0)
    plan = framing.launch_groups(sizes)
    assert len(plan) == groups
    assert all(len(g) <= framing.MAX_PARTS for g in plan)
    assert [i for g in plan for i in g] == [i for i, nb in enumerate(sizes)
                                            if nb]
    parts = [torch.full((nb,), i % 256, dtype=torch.uint8)
             for i, nb in enumerate(sizes)]
    buf = framing.frame_parts(parts)
    assert torch.equal(buf, torch.cat(parts))
    back = framing.unframe_parts(buf, sizes)
    assert all(torch.equal(a, b) for a, b in zip(back, parts))


@pytest.mark.parametrize("feedback", ["none", "ef", "ef21"])
def test_init_dp_state_structure(feedback):
    jlike = {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in
             SHAPES.items()}
    j = JCOL.init_dp_state(jlike, 3, feedback)
    t = TCOL.init_dp_state({k: torch.zeros(s) for k, s in SHAPES.items()},
                           3, feedback)
    assert (t.scope, t.direction, t.mode) == (j.scope, j.direction, j.mode)
    for slot in ("resid", "mirror", "agg"):
        jt, tt = getattr(j, slot), getattr(t, slot)
        assert isinstance(tt, dict) == isinstance(jt, dict)
        jl, tl = jax.tree.leaves(jt), tree_leaves(tt)
        assert [tuple(b.shape) for b in tl] == [a.shape for a in jl]
        assert all(b.dtype == torch.float32 and not b.any() for b in tl)
    ones = t.map(lambda a: a + 1)
    assert all(bool((a == 1).all()) for slot in ("resid", "agg")
               for a in tree_leaves(getattr(ones, slot)))
    # the reference's state carried across as numpy
    c = params_from_numpy(jax.tree.map(np.asarray, j), "cpu")
    assert (c.scope, c.direction, c.mode) == (t.scope, t.direction, t.mode)
    for slot in ("resid", "mirror", "agg"):
        assert [tuple(a.shape) for a in tree_leaves(getattr(c, slot))] == \
            [tuple(a.shape) for a in tree_leaves(getattr(t, slot))]


@pytest.mark.parametrize("codec,feedback", [("none", "none"),
                                            ("q8", "ef"), ("q4", "ef21")])
def test_tensor_split_reduce_is_one_reduce_per_coordinate(codec, feedback):
    """``tp_axis=T``: each tensor coordinate reduces its own shard of the
    sharded leaves (and the replicated leaves whole): the result, state and
    ring bytes are those of T independent reduces on the shards."""
    rng = np.random.RandomState(3)
    g = {"w": torch.from_numpy(rng.randn(2, 3, 8).astype(np.float32)),
         "s": torch.from_numpy(rng.randn(2, 5).astype(np.float32))}
    dims = {"w": 2, "s": -1}               # absolute, in the (dp, ...) arrays
    like = {"w": torch.zeros(3, 8), "s": torch.zeros(5)}
    st = TCOL.init_dp_state(like, 2, feedback)
    red = TCOL.make_grad_all_reduce(2, codec, feedback=feedback, tp_axis=2,
                                    tp_dims=dims)
    out, nst, wire = red(g, st)
    one = TCOL.make_grad_all_reduce(2, codec, feedback=feedback)
    parts = []
    for t in range(2):
        gt = {"w": g["w"][..., 4 * t:4 * t + 4], "s": g["s"]}
        st_t = TCOL.init_dp_state({"w": torch.zeros(3, 4),
                                   "s": torch.zeros(5)}, 2, feedback)
        parts.append(one(gt, st_t))
    assert torch.equal(out["w"], torch.cat([p[0]["w"] for p in parts], -1))
    assert all(torch.equal(out["s"], p[0]["s"]) for p in parts)
    if feedback != "none":
        assert torch.equal(nst.resid["w"], torch.cat(
            [p[1].resid["w"] for p in parts], -1))
    if feedback == "ef21":
        assert torch.equal(nst.agg["w"], torch.cat(
            [p[1].agg["w"] for p in parts], -1))
    assert wire == {k: 2 * parts[0][2][k] for k in wire}
    rep = TCOL.dp_wire_report(like, codec, dp=2, tp_axis=2,
                              tp_dims={"w": 1, "s": -1})
    assert rep["tensor_columns"] == 2
    assert wire["dp_bytes"] == 2 * 2 * rep["wire_bytes_per_reduce"]


def test_reduce_refuses_what_is_not_ported_or_wrong():
    with pytest.raises(ValueError, match="stage axis' size"):
        TCOL.make_grad_all_reduce(2, "q8", shard_axis="stage")
    # the tensor split: a size, given with the leaves' tensor dims
    with pytest.raises(ValueError, match="tensor axis' size"):
        TCOL.make_grad_all_reduce(2, "q8", tp_axis="tensor", tp_dims={})
    with pytest.raises(ValueError, match="come together"):
        TCOL.make_grad_all_reduce(2, "q8", tp_axis=2)
    with pytest.raises(ValueError, match="come together"):
        JCOL.make_grad_all_reduce(None, "data", "q8", tp_axis="tensor")
    with pytest.raises(ValueError, match="LOSSY"):
        TCOL.make_grad_all_reduce(2, "none", feedback="ef")
    with pytest.raises(ValueError, match="unknown dp feedback"):
        TCOL.make_grad_all_reduce(2, "q8", feedback="aqsgd")
    with pytest.raises(ValueError, match="unknown dp feedback"):
        TCOL.init_dp_state({"a": torch.zeros(3)}, 2, "efmixed")
    assert TCOL.DP_FEEDBACK_MODES == JCOL.DP_FEEDBACK_MODES
    red = TCOL.make_grad_all_reduce(2, "q8")
    with pytest.raises(ValueError, match="replica dim"):
        red({"a": torch.zeros((3, 4))}, TCOL.init_dp_state(
            {"a": torch.zeros(4)}, 2))
