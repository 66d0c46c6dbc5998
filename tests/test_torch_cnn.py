"""The port's CNN data and model against the JAX package, on the same
numpy inputs.

Model: the GroupNorm ResNet at width 8 (2 blocks a stage, 4 stages, 3
cuts), reference params carried over through numpy, 32x32 images from
``ImageClassData``.  Batch 16 (cut tile (16, 2048)) and batch 12 (tile
(4, 2048), the tile height of batch 100 on the card).  Both packages are
float32, so the model is held well inside the bf16 LM bounds:
  * ``ImageClassData``: every array and the epoch order, bitwise;
  * logits: within ``ATOL`` = 1e-5 absolute (measured at most 1.5e-6 on
    logits of magnitude 3); activations (every stage's output, a block's,
    a cut's input): within ``ATOL`` of the larger of 1 and their largest
    magnitude (measured at most 8e-7 of it: 1.3e-5 on a stage output of
    magnitude 17.5);
  * the stride-2 block (XLA's "SAME" pads a stride-2 3x3 conv (0, 1),
    not (1, 1)) and a stride-2 conv alone: within ``ATOL``;
  * each cut with the reference's cut input pinned (the reference run
    with the eager C(x) at its cuts): the port's cut input must be the
    reference's, NHWC in logical order (a channels-first tensor at the
    cut fails here), within the activation bound; then the port's
    C(x) of the pinned input is bitwise the eager reference oracle
    (``ref.quant_dequant_ref`` / ``ref.topk_block_ref``), and within one
    code step of the Pallas kernel in interpret mode (XLA scales by
    ``span * f32(1/levels)`` and fuses the dequant into an FMA, so each
    element is held to ``step + 1 ulp of it + 1 ulp of its tile's largest
    magnitude``, ``step`` the tile's scale where the two scales differ);
    the TopK kept set exactly;
  * the pipeline variant's stem, stages and head: within the activation
    bound; ``pipeline_forward_eval``'s logits, with compression off and
    with top10 at the cuts: within ``ATOL``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.core.compressors as JCC
import repro.models.cnn as JC
from repro.core import policy as JP
from repro.data.synthetic import ImageClassData as JData
from repro.kernels import quantize as JQ
from repro.kernels import ref as JREF
from repro.kernels import topk_mask as JK

import repro_torch.models.cnn as TC
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.core import policy as TP
from repro_torch.data.synthetic import ImageClassData as TData
from repro_torch.kernels import tiling as TT
from repro_torch.transport import pipeline as TPIPE

# One intra-op thread: the suite runs in several worker processes at
# once, and a torch thread pool per worker that outnumbers the cores
# slows its CPU ops by an order of magnitude.
torch.set_num_threads(1)

ATOL = 1e-5
WIDTH = 8


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, what, scaled=False):
    """Within ``ATOL``: absolute, or ``scaled`` by the larger of 1 and the
    reference's largest magnitude (activations)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    gap = float(np.abs(got - want).max())
    tol = ATOL * (max(1.0, float(np.abs(want).max())) if scaled else 1.0)
    assert gap <= tol, f"{what}: max gap {gap} > {tol}"


@pytest.fixture(scope="module")
def model():
    jp = JC.init_params(jax.random.PRNGKey(0), width=WIDTH)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def images():
    return JData(num_train=16, num_test=16, seed=3).x_train


@pytest.fixture
def pallas_reference():
    prev = JCC.KERNEL_BACKEND
    JCC.KERNEL_BACKEND = "pallas"
    yield
    JCC.KERNEL_BACKEND = prev


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(num_train=64, num_test=32, seed=5,
                                         image=16, noise=0.3)])
def test_image_class_data_is_bitwise_the_reference(kw):
    j, t = JData(**kw), TData(**kw)
    for name in ("templates", "x_train", "y_train", "x_test", "y_test"):
        a, b = getattr(j, name), getattr(t, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    for ep in (0, 1):
        for (xa, ya, ia), (xb, yb, ib) in zip(j.epoch(16, ep),
                                              t.epoch(16, ep), strict=True):
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)
            assert ia.dtype == ib.dtype == np.int32
            np.testing.assert_array_equal(ia, ib)
    for a, b in zip(j.test_batches(10), t.test_batches(10), strict=True):
        for u, v in zip(a, b):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def test_init_params_has_the_reference_tree(model):
    jp, _ = model
    tp = TC.init_params(torch.Generator().manual_seed(0), width=WIDTH)
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: np.zeros(t.shape), tp))[0]
    assert [(p, np.shape(a)) for p, a in want] == \
        [(p, np.shape(a)) for p, a in got]
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(tp))


def test_stride2_conv_pads_as_xla():
    """A 3x3 stride-2 "SAME" conv on an even input: XLA pads (0, 1)."""
    rng = np.random.RandomState(0)
    x = rng.randn(1, 8, 8, 2).astype(np.float32)
    w = rng.randn(3, 3, 2, 3).astype(np.float32)
    for stride in (1, 2):
        _close(TC._conv(torch.from_numpy(x), torch.from_numpy(w), stride),
               JC._conv(jnp.asarray(x), jnp.asarray(w), stride),
               f"conv stride {stride}")
    w1 = rng.randn(1, 1, 2, 3).astype(np.float32)
    _close(TC._conv(torch.from_numpy(x), torch.from_numpy(w1), 2),
           JC._conv(jnp.asarray(x), jnp.asarray(w1), 2), "1x1 stride 2")


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_stride2_block_matches_reference(model, images, stage):
    """The first block of stages 1-3 (stride 2, with its projection)."""
    jp, tp = model
    cin = WIDTH * 2 ** (stage - 1)
    size = 32 >> (stage - 1)
    x = np.random.RandomState(stage).randn(4, size, size, cin) \
        .astype(np.float32)
    got = TC._block_apply(tp["stages"][stage][0], torch.from_numpy(x), 2)
    want = JC._block_apply(jp["stages"][stage][0], jnp.asarray(x), 2)
    _close(got, want, f"stage {stage} stride-2 block", scaled=True)
    assert got.shape == (4, size // 2, size // 2, 2 * cin)


def _stage_outputs(mod, params, x, asarray):
    """Every stage's output of the uncompressed model, in order."""
    x = mod.pipeline_stem(params, asarray(x))
    outs = []
    strides = mod._stage_strides(4, 2)
    for s, stage in enumerate(params["stages"]):
        for p, st in zip(stage, strides[s]):
            x = mod._block_apply(p, x, st)
        outs.append(x)
    return outs


@pytest.mark.parametrize("batch", [16, 12])
def test_forward_matches_reference(model, images, batch):
    jp, tp = model
    x = images[:batch]
    jouts = _stage_outputs(JC, jp, x, jnp.asarray)
    touts = _stage_outputs(TC, tp, x, torch.from_numpy)
    for s, (a, b) in enumerate(zip(touts, jouts)):
        _close(a, b, f"stage {s} output", scaled=True)
    want = JC.forward_eval(jp, jnp.asarray(x))
    _close(TC.forward_eval(tp, torch.from_numpy(x)), want, "eval logits")
    pol = TP.CompressionPolicy(num_stages=4)
    logits, new_fw, slots = TC.forward_train(tp, torch.from_numpy(x), pol)
    _close(logits, want, "train logits")
    assert len(new_fw) == len(slots) == 3


def _oracle(name, flat, block):
    """The eager reference C(x) of a flat cut tensor."""
    if name == "top10":
        return JREF.topk_block_ref(flat, 0.1, block=block)
    return JREF.quant_dequant_ref(flat, {"q8": 8, "q4": 4}[name],
                                  block=block)


def _reference_cuts(jp, x, name):
    """The reference model with the eager C(x) at each cut: each cut's
    input and output, and the logits."""
    h = JC.pipeline_stem(jp, jnp.asarray(x))
    strides = JC._stage_strides(4, 2)
    ins, outs = [], []
    for s, stage in enumerate(jp["stages"]):
        for p, st in zip(stage, strides[s]):
            h = JC._block_apply(p, h, st)
        if s < 3:
            flat = h.reshape(h.shape[0], -1)
            block = (TT.pow2_row_block(flat.shape[0]),
                     TT.lane_block(flat.shape[1]))
            ins.append(h)
            h = _oracle(name, flat, block).reshape(h.shape)
            outs.append(h)
    return ins, outs, JC._head(jp, h)


def _pin_cuts(monkeypatch, cut_inputs):
    """Check the port model's cut input against the reference's, then
    replace it by the reference's; record what the cut returns."""
    seen = []
    real = TC.boundary_eval

    def pinned(policy, x, compress):
        i = len(seen)
        _close(x, cut_inputs[i], f"cut {i} input", scaled=True)
        x = torch.from_numpy(np.array(cut_inputs[i]))
        y = real(policy, x, compress)
        seen.append((x, y))
        return y

    monkeypatch.setattr(TC, "boundary_eval", pinned)
    return seen


def _assert_one_code_step(port, jit, x, bits, block):
    """Per tile: |port - jit| <= step + 1 f32 ulp of the element + 1 f32
    ulp of the tile's largest magnitude; ``step`` the tile's scale where
    the divided and the reciprocal-multiplied scales differ."""
    port, jit, xf = (_np(a).reshape(a.shape[0], -1) for a in (port, jit, x))
    levels = np.float32((1 << bits) - 1)
    bm, bn = block

    def ulp(v):
        v = np.abs(np.asarray(v, np.float64))
        safe = np.where(v > 0, v, 1.0)
        return np.where(v > 0, 2.0 ** (np.floor(np.log2(safe)) - 23), 0.0)

    for i in range(0, xf.shape[0], bm):
        for j in range(0, xf.shape[1], bn):
            sl = np.s_[i:i + bm, j:j + bn]
            t = xf[sl]
            span = np.float32(t.max() - t.min())
            s_div = np.float32(span / levels)
            s_mul = np.float32(span * np.float32(np.float32(1) / levels))
            step = 0.0 if s_div == s_mul or span == 0 else s_div
            tol = (step + ulp(np.maximum(np.abs(port[sl]), np.abs(jit[sl])))
                   + ulp(np.abs(t).max()))
            assert (np.abs(port[sl] - jit[sl]) <= tol).all()


@pytest.mark.parametrize("batch", [16, 12])
@pytest.mark.parametrize("name", ["q8", "q4", "top10"])
def test_each_cut_with_the_reference_input_pinned(model, images, batch, name,
                                                  monkeypatch):
    jp, tp = model
    x = images[:batch]
    cut_in, cut_out, logits = _reference_cuts(jp, x, name)
    bp = {"q8": TP.quant_policy(8, 8), "q4": TP.quant_policy(4, 4),
          "top10": TP.topk_policy(0.1)}[name]
    seen = _pin_cuts(monkeypatch, cut_in)
    got = TC.forward_eval(tp, torch.from_numpy(x),
                          TP.CompressionPolicy(num_stages=4, boundary=bp))
    assert len(seen) == 3
    _close(got, logits, "logits")
    for i, ((tx, ty), jx, jy) in enumerate(zip(seen, cut_in, cut_out)):
        assert tuple(tx.shape) == (batch, *JC.boundary_shapes(WIDTH)[i])
        flat = jx.reshape(batch, -1)
        block = (TT.pow2_row_block(batch), TT.lane_block(flat.shape[1]))
        assert block == ((16 if batch == 16 else 4), 2048)
        ty = ty.reshape(batch, -1)
        np.testing.assert_array_equal(
            _np(ty).view(np.uint32),
            _np(jy.reshape(batch, -1)).view(np.uint32))
        if name == "top10":
            kernel = JK.topk_block(flat, 0.1, block=block, interpret=True)
            np.testing.assert_array_equal(_np(ty) != 0, _np(kernel) != 0)
            np.testing.assert_array_equal(_np(ty), _np(kernel))
        else:
            kernel = JQ.quant_dequant(flat, bp.fw.bits, block=block,
                                      interpret=True)
            _assert_one_code_step(ty, kernel, flat, bp.fw.bits, block)


def test_cut_input_is_nhwc_in_logical_order(model, images):
    """What reaches the cut is the (B, H, W, C) activation: flattened per
    example it is the reference's NHWC flattening (a channels-first
    tensor at the cut would flatten to a different order, and its tiles,
    scales and TopK sets would differ)."""
    jp, tp = model
    x = images[:12]
    want = _stage_outputs(JC, jp, x, jnp.asarray)[0]
    got = _stage_outputs(TC, tp, x, torch.from_numpy)[0]
    _close(got.reshape(12, -1), np.asarray(want).reshape(12, -1),
           "cut 0 flattened", scaled=True)
    nchw = np.asarray(want).transpose(0, 3, 1, 2).reshape(12, -1)
    assert np.abs(_np(got.reshape(12, -1)) - nchw).max() > 1.0


def test_boundary_shapes():
    assert TC.boundary_shapes(64, 32) == JC.boundary_shapes(64, 32)
    assert TC.boundary_shapes(8, 16) == JC.boundary_shapes(8, 16)


# ---------------------------------------------------------------------------
# the pipeline variant
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipe_model():
    jp = JC.init_pipeline_params(jax.random.PRNGKey(1), 3, width=WIDTH)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def test_pipeline_stage_and_stem_match_reference(pipe_model, images):
    jp, tp = pipe_model
    x = images[:8]
    _close(TC.pipeline_stem(tp, torch.from_numpy(x)),
           JC.pipeline_stem(jp, jnp.asarray(x)), "stem", scaled=True)
    h = np.random.RandomState(2).randn(8, 32, 32, WIDTH).astype(np.float32)
    for s in range(3):
        got = TC.pipeline_stage_apply(TPIPE._index_tree(tp["stages"], s),
                                      torch.from_numpy(h))
        want = JC.pipeline_stage_apply(
            jax.tree.map(lambda a: a[s], jp["stages"]), jnp.asarray(h))
        _close(got, want, f"stage {s}", scaled=True)
    _close(TC.pipeline_head(tp, torch.from_numpy(h)),
           JC.pipeline_head(jp, jnp.asarray(h)), "head")
    tp2 = TC.init_pipeline_params(torch.Generator().manual_seed(0), 3,
                                  width=WIDTH)
    assert [np.shape(a) for a in jax.tree.leaves(jp)] == \
        [tuple(a.shape) for a in jax.tree.leaves(tp2)]


@pytest.mark.parametrize("name", ["none", "top10"])
def test_pipeline_forward_eval_matches_reference(pipe_model, images, name,
                                                 pallas_reference):
    jp, tp = pipe_model
    x = images[:8]
    jbp = JP.topk_policy(0.1) if name == "top10" else JP.NO_COMPRESSION
    tbp = TP.topk_policy(0.1) if name == "top10" else TP.NO_COMPRESSION
    for compress in (True, False):
        want = JC.pipeline_forward_eval(
            jp, jnp.asarray(x), JP.CompressionPolicy(num_stages=3,
                                                     boundary=jbp),
            compress=compress)
        got = TC.pipeline_forward_eval(
            tp, torch.from_numpy(x), TP.CompressionPolicy(num_stages=3,
                                                          boundary=tbp),
            compress=compress)
        _close(got, want, f"{name} compress={compress}")
