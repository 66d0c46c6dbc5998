"""The block TopK kernel's algorithm against ``topk_block_plain``, on the
CPU where no card exists.

``csrc/topk_mask.cu`` does not run the bisection's 24 counting passes.
It uses the identity that a step's ``#(|x| >= mid) > k`` holds exactly
when the (row, tile) has a (k+1)-th largest non-NaN magnitude ``a`` and
``mid <= a``: it finds ``a`` by a radix select over the magnitudes' f32
bits (8-bit digits from bit 31 down; 2 passes for bf16, whose low 16 bits
are zero, 4 for f32), then runs the 24 steps as scalar f32 arithmetic.
``order_statistic_mask`` below is a numpy copy of exactly that, and must
equal ``topk_block_plain`` (the mirror of the JAX package's reference)
bit for bit on adversarial tiles.  The kernel itself is held to the plain
version on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""
import math

import numpy as np
import pytest
import torch

from conftest import hypothesis_or_stubs
from repro_torch.kernels import topk_mask as TK

given, settings, st = hypothesis_or_stubs()

ITERS = 24
INF_BITS = 0x7F800000
PASSES = {torch.float32: 4, torch.bfloat16: 2}


def radix_kth_largest(keys, rank, passes):
    """The ``rank``-th largest of the uint32 ``keys`` (rank 1 = the
    largest), by the kernel's digit passes; None when there are fewer."""
    if len(keys) < rank:
        return None
    prefix, need = 0, rank
    for p in range(passes):
        hi, lo = 31 - 8 * p, max(23 - 8 * p, 0)
        cand = keys[(keys >> hi) == (prefix >> hi)]
        hist = np.bincount((cand >> lo) & ((1 << (hi - lo)) - 1),
                           minlength=256)
        above = 0
        for b in range(255, -1, -1):
            if above + hist[b] >= need:
                prefix |= b << lo
                need -= above
                break
            above += hist[b]
    return prefix


def order_statistic_mask(x, k_frac, bn, passes):
    """numpy copy of the kernel: x float32 (m, n) (bf16 values widened)."""
    k = max(1, math.ceil(k_frac * bn))
    out = np.empty_like(x)
    half = np.float32(0.5)
    for r in range(x.shape[0]):
        for j in range(0, x.shape[1], bn):
            t = x[r, j:j + bn]
            mag = np.abs(t)
            keys = mag.view(np.uint32)
            valid = keys[keys <= INF_BITS]
            a = radix_kth_largest(valid, k + 1, passes)
            if a is not None:     # the digit passes find the sort's entry
                assert a == np.sort(valid)[::-1][k]
            lo, hi = np.float32(0), keys.max().view(np.float32)
            with np.errstate(over="ignore", invalid="ignore"):
                for _ in range(ITERS):
                    mid = np.float32(half * np.float32(lo + hi))
                    if a is not None and mid <= np.uint32(a).view(np.float32):
                        lo = mid
                    else:
                        hi = mid
                out[r, j:j + bn] = np.where(mag >= lo, t, np.float32(0))
    return out


def tile_input(kind, m, n, rng):
    """(m, n) float32 of one adversarial kind."""
    x = rng.randn(m, n).astype(np.float32)
    if kind == "ties":
        x = rng.randint(-3, 4, size=(m, n)).astype(np.float32)
    elif kind == "zeros and -0.0":
        x = np.zeros((m, n), np.float32)
        x[:, ::2] = -0.0
    elif kind == "mostly +-0, a few values":
        x[:, np.arange(n) % 37 != 0] = 0.0
        x[:, 1::3] = -0.0
    elif kind == "+-inf":
        x[:, ::50] = np.inf
        x[:, 25::50] = -np.inf
    elif kind == "NaN":
        x[:, ::7] = np.nan
    elif kind == "mostly NaN":
        x[:, np.arange(n) % 97 != 0] = np.nan
    elif kind == "subnormal":
        x *= np.float32(1e-41)
    elif kind == "bf16-exact":
        x = torch.from_numpy(x).bfloat16().float().numpy()
    elif kind == "near the f32 max":   # lo + hi overflows to inf
        x = rng.uniform(-3.4e38, 3.4e38, size=(m, n)).astype(np.float32)
    return x


def assert_mask_is_plain(x, dtype, k_frac, bn):
    t = torch.from_numpy(x).to(dtype)
    want = TK.topk_block_plain(t, k_frac, (t.shape[0], bn))
    got = order_statistic_mask(t.float().numpy(), k_frac, bn, PASSES[dtype])
    np.testing.assert_array_equal(got.view(np.uint32),
                                  want.float().numpy().view(np.uint32))


KINDS = ["randn", "ties", "zeros and -0.0", "mostly +-0, a few values",
         "+-inf", "NaN", "mostly NaN", "subnormal", "bf16-exact",
         "near the f32 max"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bn", [128, 256, 512, 1024, 2048])
@pytest.mark.parametrize("kind", KINDS)
def test_order_statistic_mask_is_the_bisection(kind, bn, dtype):
    """k = 1, 10%, 30%, bn - 1 and bn (bn a power of two, so k / bn is
    exact and the wrapper's ceil gives k back)."""
    x = tile_input(kind, 2, 2 * bn, np.random.RandomState(bn))
    for k in (1, bn // 10, 3 * bn // 10, bn - 1, bn):
        assert_mask_is_plain(x, dtype, k / bn, bn)


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), log_bn=st.integers(7, 11),
       k_num=st.integers(1, 2048), special=st.integers(0, 6),
       dtype=st.sampled_from([torch.float32, torch.bfloat16]))
def test_order_statistic_mask_on_random_mixtures(seed, log_bn, k_num,
                                                 special, dtype):
    """Random tiles with a random share of zeros, -0.0, ties, +-inf and
    NaN; any k from 1 to bn."""
    bn = 1 << log_bn
    k = 1 + (k_num - 1) % bn
    rng = np.random.RandomState(seed)
    scale = np.float32(10.0 ** rng.randint(-3, 4))
    x = rng.randn(3, bn).astype(np.float32) * scale
    picks = rng.rand(3, bn)
    width = special / 72.0       # each special value's share of the tile
    for band, value in enumerate((0.0, -0.0, 2.5, np.inf, -np.inf, np.nan)):
        x[(picks >= band * width) & (picks < (band + 1) * width)] = value
    assert_mask_is_plain(x, dtype, k / bn, bn)
