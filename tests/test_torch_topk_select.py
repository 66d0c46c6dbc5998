"""The TopK select's host-side grid planning, and its plain versions
against the JAX package's Pallas select (interpret mode) on rows that
the card cuts into several chunks, with ties across chunk boundaries.

The CUDA kernels themselves are held to the plain versions bit for bit
on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py phase 2).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import topk_select as JTS
from repro_torch.checkpoint.convert import tensor_from_numpy
from repro_torch.kernels import topk_select as TTS

# (m, n): serving decode and prefill, a pipeline microbatch, gpt2-small's
# DP gradient leaves as (1, n), odd n, and edges of the planning rule
GRID_SHAPES = [(4, 768), (4, 64 * 768), (8, 128 * 768), (1, 38597376),
               (1, 28311552), (1, 9216), (1, 786432), (2, 70001), (1, 767),
               (264, 5000), (300, 100000), (1, 4095), (1, 4096),
               (1, 2048 * 264 - 1), (1, 2048 * 264 + 1), (3, 2 ** 31 - 1)]


@pytest.mark.parametrize("m,n", GRID_SHAPES)
def test_select_grid_covers_each_row_in_order(m, n):
    chunks, length = TTS.select_grid(m, n)
    bounds = [(c * length, min(n, (c + 1) * length)) for c in range(chunks)]
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(lo < hi for lo, hi in bounds), "an empty chunk"
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    want = -(-TTS.TARGET_BLOCKS // m)
    if n >= TTS.MIN_CHUNK * want:          # n allows a full card
        assert chunks * m >= TTS.TARGET_BLOCKS
    if chunks > 1:
        assert length >= TTS.MIN_CHUNK
    else:
        assert length == n and min(want, n // TTS.MIN_CHUNK) <= 1


def test_select_grid_main_path_counts():
    assert TTS.select_grid(4, 768) == (1, 768)             # decode: 1 a row
    assert TTS.select_grid(8, 128 * 768)[0] == 33          # microbatch
    assert TTS.select_grid(1, 38597376)[0] == 264          # wte leaf


def _chunked_rows(kind, n, length, rng):
    """Rows cut by the card into chunks of ``length``: 'ties' holds 7
    values only; 'run' holds three large entries and a run of 16 equal
    entries across the first chunk boundary, which k cuts 10 entries in;
    'zeros' is mostly zeros and -0.0."""
    if kind == "ties":
        return rng.randint(-3, 4, size=(2, n)).astype(np.float32), n // 10
    if kind == "run":
        x = (rng.rand(2, n).astype(np.float32) - 0.5) * 0.5
        x[:, length - 8:length + 8] = 2.0
        x[1, length - 8:length + 8:2] = -2.0
        x[:, [5, n // 2, n - 1]] = 5.0
        return x, 3 + 10
    x = np.zeros((2, n), np.float32)
    x[1, ::2] = -0.0
    x[:, ::997] = rng.randn(2, len(range(0, n, 997)))
    return x, n // 10


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["ties", "run", "zeros"])
def test_plain_select_matches_pallas_across_chunks(kind, dtype):
    n = 3 * TTS.MIN_CHUNK + 5
    chunks, length = TTS.select_grid(2, n)
    assert chunks == 3
    x, k = _chunked_rows(kind, n, length, np.random.RandomState(0))
    xj = jnp.asarray(x, dtype)
    xt = tensor_from_numpy(np.asarray(xj), "cpu")
    thresh = TTS.topk_threshold(xt, k)
    np.testing.assert_array_equal(
        thresh.view(torch.int32).numpy(),
        np.asarray(JTS.topk_threshold(xj, k, interpret=True)).view(np.int32))
    vals, idx = TTS.topk_select_wire(xt, k)
    jv, ji = JTS.topk_select_wire(xj, k, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.float().numpy(),
                                  np.asarray(jv.astype(jnp.float32)))
    if kind == "run":       # the tie quota runs out in the second chunk
        kept = set(idx[0].tolist())
        assert {length - 8 + i for i in range(10)} <= kept
        assert length + 2 not in kept and length + 1 in kept


def _special_rows(m, n, rng):
    """``m`` rows of ``n`` holding few distinct magnitudes (ties across
    the row), 0.0 beside -0.0, NaN and +-inf."""
    x = rng.randint(-2, 3, size=(m, n)).astype(np.float32)
    x[x == 0] = rng.choice([0.0, -0.0], size=int((x == 0).sum()))
    specials = [np.nan, np.inf, -np.inf, -0.0]
    for r in range(m):
        cols = rng.choice(n, size=r + 1, replace=False)
        x[r, cols] = [specials[(r + j) % 4] for j in range(r + 1)]
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5])
def test_plain_compact_matches_reference_epilogue(m, dtype):
    """The plain compaction (which writes the kept entries only) against
    the reference's cumsum / scatter epilogue of ``topk_select_wire`` on
    tied, -0.0, NaN and +-inf rows, given the reference's own thresholds
    and the plain ones: the indices equal, the values bit for bit but for
    a NaN's sign and payload (PyTorch's CPU ``gather`` of a bfloat16 NaN
    returns 0xffff), where both are NaN."""
    n = 41
    x = _special_rows(m, n, np.random.RandomState(m))
    xj = jnp.asarray(x, dtype)
    xt = tensor_from_numpy(np.asarray(xj), "cpu")
    for k in (1, 2, 7, n // 2, n - 1, n):
        jv, ji = JTS.topk_select_wire(xj, k, interpret=True)
        jt = JTS.topk_threshold(xj, k, interpret=True)
        for thresh in (tensor_from_numpy(np.asarray(jt), "cpu"),
                       TTS.topk_threshold(xt, k)):
            vals, idx = TTS.topk_compact_plain(xt, thresh, k)
            np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
            got = vals.float().numpy()
            want = np.asarray(jv.astype(jnp.float32))
            nan = np.isnan(want)
            np.testing.assert_array_equal(np.isnan(got), nan)
            np.testing.assert_array_equal(got.view(np.int32)[~nan],
                                          want.view(np.int32)[~nan])
