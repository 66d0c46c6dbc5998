"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip without a CUDA device.  On a machine with an
H100 and nvcc (torch only, no JAX needed):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from repro_torch import device as D
from repro_torch.kernels import _build, ops, pack4, quantize, topk_mask
from repro_torch.kernels import topk_select

pytestmark = pytest.mark.cuda

SHAPES = [(4, 768), (4, 64 * 768), (1, 767), (2, 70001)]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _kernel_and_plain(fn, monkeypatch):
    got = fn()
    monkeypatch.setattr(D, "KERNEL_BACKEND", "plain")
    want = fn()
    monkeypatch.setattr(D, "KERNEL_BACKEND", "auto")
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_topk_kernels_bit_exact(gen, shape, dtype, monkeypatch):
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    k = max(1, int(round(0.1 * shape[1])))
    got, want = _kernel_and_plain(lambda: topk_select.topk_select_wire(x, k),
                                  monkeypatch)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("shape", SHAPES)
def test_pack4_kernels_bit_exact(gen, shape, monkeypatch):
    x = torch.randn(shape, generator=gen, device="cuda")
    mn, sc = pack4.minmax_scale(x)
    got, want = _kernel_and_plain(lambda: pack4.pack4_wire(x, mn, sc),
                                  monkeypatch)
    assert got.dtype == want.dtype and torch.equal(got, want)
    got, want = _kernel_and_plain(
        lambda: pack4.unpack4_wire(want, mn, sc, shape[1]), monkeypatch)
    assert torch.equal(got, want)


# the training cut's shapes: (8, 128*768), (4, 64*768), m = 6, and the
# whole-tensor fallback tile (4, 767)
CUT_SHAPES = [(8, 128 * 768), (4, 64 * 768), (6, 4096), (4, 767)]


def _cut_inputs(gen, shape, dtype):
    m, n = shape
    yield torch.randn(shape, generator=gen, device="cuda").to(dtype)
    yield torch.full(shape, 3.25, device="cuda").to(dtype)
    z = torch.randn(shape, generator=gen, device="cuda")
    z[::2] = 0.0                                   # all-zero rows
    yield z.to(dtype)
    yield torch.randint(-3, 4, shape, generator=gen,
                        device="cuda").to(dtype)   # heavy ties


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CUT_SHAPES)
def test_cut_kernels_bit_exact(gen, shape, dtype, monkeypatch):
    for x in _cut_inputs(gen, shape, dtype):
        for bits in (4, 8):
            got, want = _kernel_and_plain(
                lambda: ops.quant_dequant_op(x, bits), monkeypatch)
            assert got.dtype == want.dtype and torch.equal(got, want)
        for k_frac in (0.1, 0.3):
            got, want = _kernel_and_plain(
                lambda: ops.topk_block_op(x, k_frac), monkeypatch)
            assert got.dtype == want.dtype and torch.equal(got, want)


def test_each_wrapper_counts_one_launch(gen, monkeypatch):
    x = torch.randn((2, 1000), generator=gen, device="cuda")
    _build.reset_launches()
    mn, sc = pack4.minmax_scale(x)
    pack4.unpack4_wire(pack4.pack4_wire(x, mn, sc), mn, sc, 1000)
    topk_select.topk_select_wire(x, 100)
    quantize.quant_dequant(x, 4, (2, 1000))
    topk_mask.topk_block(x, 0.1, (2, 1000))
    assert _build.LAUNCHES == {"pack4_wire": 1, "unpack4_wire": 1,
                               "topk_threshold": 1, "topk_compact": 1,
                               "quant_dequant": 1, "topk_block": 1}
    monkeypatch.setattr(D, "KERNEL_BACKEND", "plain")
    topk_select.topk_select_wire(x, 100)
    quantize.quant_dequant(x, 4, (2, 1000))
    topk_mask.topk_block(x, 0.1, (2, 1000))
    assert _build.LAUNCHES["topk_threshold"] == 1
    assert _build.LAUNCHES["quant_dequant"] == 1
    assert _build.LAUNCHES["topk_block"] == 1
