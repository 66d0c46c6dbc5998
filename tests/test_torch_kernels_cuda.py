"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip without a CUDA device.  On a machine with an
H100 and nvcc (torch only, no JAX needed):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from repro_torch import device as D
from repro_torch.kernels import _build, dp_reduce, framing, ops, pack4
from repro_torch.kernels import quantize, tiling, topk_mask, topk_select
from repro_torch.transport import codecs, collectives

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


def _select_case(kind, gen):
    """(x f32 on the card, k) of one of the select's edge cases: rows of
    many chunks, ties whose quota runs out inside a chunk and across a
    chunk boundary, constant, zero and -0.0 rows, k = 1 and k = n, int32
    indices, odd rows starting off a 16-byte boundary and ending at their
    storage's end, and a threshold bin whose candidates all lie in one
    chunk."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    mc = topk_select.MIN_CHUNK
    if kind == "3 chunks and 5":
        return randn(3, 3 * mc + 5), None
    if kind == "40 chunks and 5":
        return randn(2, 40 * mc + 5), None
    if kind == "tie run across a chunk boundary":
        n = 3 * mc + 5
        length = topk_select.select_grid(2, n)[1]
        x = randn(2, n) * 0.1
        x[:, length - 8:length + 8] = 2.0
        x[1, length - 8:length + 8:2] = -2.0
        x[:, [5, n // 2, n - 1]] = 5.0
        return x, 3 + 10                   # 10 of the 16 ties
    if kind == "heavy ties":
        return torch.randint(-3, 4, (4, 128 * 768), generator=gen,
                             device="cuda").float(), None
    if kind == "constant":
        return torch.full((2, 10 * mc), 3.25, device="cuda"), None
    if kind == "zeros and -0.0":
        x = torch.zeros((2, 20485), device="cuda")
        x[1, ::2] = -0.0
        x[:, ::997] = randn(2, 21)
        return x, None
    if kind == "k = 1":
        return randn(2, 50000), 1
    if kind == "k = n":
        return randn(2, 50000), 50000
    if kind == "int32 index (2, 70001)":
        return randn(2, 70001), None
    if kind == "one chunk's candidates":
        n = 40 * mc + 5
        length = topk_select.select_grid(2, n)[1]
        x = randn(2, n) * 0.01
        x[:, 3 * length:4 * length] = 1.0 + 0.001 * torch.rand(
            (2, length), generator=gen, device="cuda")
        return x, 1000                     # inside the chunk's one bin
    assert kind == "misaligned start, odd n"
    return randn(3 * 30001 + 1)[1:].view(3, 30001), None


SELECT_CASES = ["3 chunks and 5", "40 chunks and 5",
                "tie run across a chunk boundary", "heavy ties", "constant",
                "zeros and -0.0", "k = 1", "k = n", "int32 index (2, 70001)",
                "misaligned start, odd n", "one chunk's candidates"]


def _select_bit_exact(x, k, monkeypatch):
    """Both select kernels == their plain versions, bitwise, one counted
    launch each; exactly k ascending indices a row."""
    _build.reset_launches()
    t_k, t_p = _kernel_and_plain(lambda: topk_select.topk_threshold(x, k),
                                 monkeypatch)
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
    got, want = _kernel_and_plain(
        lambda: topk_select.topk_compact(x, t_p, k), monkeypatch)
    assert _build.LAUNCHES == {"topk_threshold": 1, "topk_compact": 1}
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got[1].shape == (x.shape[0], k)
    assert bool((got[1][:, 1:] > got[1][:, :-1]).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", SELECT_CASES)
def test_topk_select_edge_cases_bit_exact(gen, kind, dtype, monkeypatch):
    x, k = _select_case(kind, gen)
    if dtype != x.dtype:
        x = x.to(dtype) if x.storage_offset() == 0 else \
            torch.empty(x.numel() + 1, dtype=dtype,
                        device="cuda")[1:].view(x.shape).copy_(x)
    assert x.is_contiguous()
    _select_bit_exact(x, max(1, round(0.1 * x.shape[1])) if k is None
                      else k, monkeypatch)


def test_topk_select_full_wte_leaf_bit_exact(gen, monkeypatch):
    """One gpt2-small wte gradient leaf, (1, 38597376) f32, k = 10%."""
    x = torch.randn((1, 38597376), generator=gen, device="cuda") * 0.01
    assert topk_select.select_grid(1, x.shape[1])[0] == 264
    _select_bit_exact(x, 3859738, monkeypatch)


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


# the q8 wire quantizer at the pipeline's shapes: a full-width gpt2-small
# microbatch (8, 128*768), (16, 4096), and the per-tile fallback shapes
WIRE_SHAPES = [(8, 128 * 768), (16, 4096), (8, 1024)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", WIRE_SHAPES)
def test_quantize_wire_bit_exact(gen, shape, dtype, monkeypatch):
    block = tiling.wire_tiling(shape)
    for x in _cut_inputs(gen, shape, dtype):
        got, want = _kernel_and_plain(
            lambda: quantize.quantize_wire(x, 8, block), monkeypatch)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)


def _segments(gen, sizes):
    return [torch.randint(0, 256, (nb,), generator=gen, device="cuda",
                          dtype=torch.uint8) for nb in sizes]


@pytest.mark.parametrize("sizes", [
    [393216, 4, 4],                      # q4: codes4, min, scale
    [786432, 384],                       # q8 tiled: codes, tile_meta
    [314560, 157280],                    # top10: int32 idx, bf16 vals
    [157280, 78640, 157280, 78640],      # EF-mixed top10: e, x
    [1, 7, 0, 33, 4097, 2, 16, 15],      # odd sizes and an empty leaf
    [4097],                              # one segment
    [0, 4097],                           # one segment and an empty one
    [3, 5, 4, 4] * 4 + [9],              # 17 segments: two launches
    [1001, 4, 4] * 13,                   # a q8 DP payload: 39, three
])
def test_framing_bit_exact(gen, sizes, monkeypatch):
    parts = _segments(gen, sizes)
    # a misaligned view too: the segment starts one byte into its storage
    parts[0] = torch.cat([parts[0][:1], parts[0]])[1:]
    got, want = _kernel_and_plain(lambda: framing.frame_parts(parts),
                                  monkeypatch)
    assert torch.equal(got, want) and torch.equal(got, torch.cat(parts))
    got, want = _kernel_and_plain(lambda: framing.unframe_parts(want, sizes),
                                  monkeypatch)
    for a, b, p in zip(got, want, parts):
        assert a.storage_offset() == 0
        assert torch.equal(a, b) and torch.equal(a, p)
        assert a.data_ptr() != p.data_ptr() or not p.numel()


def test_framing_one_segment_launches_and_copies(gen):
    seg = _segments(gen, [4097])[0]
    _build.reset_launches()
    buf = framing.frame_parts([seg, seg[:0]])
    back = framing.unframe_parts(buf, [0, 4097])
    assert buf.data_ptr() != seg.data_ptr() and torch.equal(buf, seg)
    assert torch.equal(back[1], seg) and back[0].numel() == 0
    assert _build.LAUNCHES == {"frame_parts": 1, "unframe_parts": 1}


@pytest.mark.parametrize("n,launches", [(16, 1), (17, 2), (39, 3)])
def test_framing_launches_once_per_16_segments(gen, n, launches):
    parts = _segments(gen, [5 + i for i in range(n)])
    _build.reset_launches()
    buf = framing.frame_parts(parts + [parts[0][:0]])
    back = framing.unframe_parts(buf, [p.numel() for p in parts] + [0])
    assert torch.equal(buf, torch.cat(parts))
    assert all(torch.equal(a, b) for a, b in zip(back, parts))
    assert _build.LAUNCHES == {"frame_parts": launches,
                               "unframe_parts": launches}


# a ragged gradient tree: an odd leaf (misaligned meta), a rank-3 stack,
# a constant leaf (one code), and a leaf of 3 tiles and a bit
DP_SHAPES = [(7,), (5, 33), (2, 3, 17), (6,), (3 * 8192 + 5,)]


def _dp_slots(gen, codec, dp, shapes):
    rows = []
    c = codecs.get_codec(codec)
    for _ in range(dp):
        leaves = [torch.randn(s, generator=gen, device="cuda") * 3
                  for s in shapes]
        leaves[3] = torch.full(shapes[3], 0.75, device="cuda")
        rows.append(codecs.fuse_payload(
            [collectives.pack_grad_leaf(c, a) for a in leaves]))
    plans = dp_reduce.build_decode_plans(collectives.grad_payload_structs(
        [codecs.LeafStruct(s, torch.float32) for s in shapes], codec),
        shapes)
    return torch.stack(rows), plans


@pytest.mark.parametrize("dp", [1, 3, 4])
@pytest.mark.parametrize("codec", ["q8", "q4"])
def test_decode_sum_fused_bit_exact(gen, codec, dp, monkeypatch):
    """Kernel == plain version == the unfused loop (unfuse -> unpack ->
    rank-ordered add), bitwise, with one launch."""
    slots, plans = _dp_slots(gen, codec, dp, DP_SHAPES)
    assert any(p.meta_off % 4 for p in plans)
    _build.reset_launches()
    got, want = _kernel_and_plain(
        lambda: dp_reduce.decode_sum_fused(slots, plans, dp), monkeypatch)
    assert _build.LAUNCHES.get("decode_sum_fused") == 1
    c = codecs.get_codec(codec)
    struct = collectives.grad_payload_structs(
        [codecs.LeafStruct(s, torch.float32) for s in DP_SHAPES], codec)
    loop = [None] * len(DP_SHAPES)
    for s in range(dp):
        pls = codecs.unfuse_payload(slots[s], struct)
        for i, shape in enumerate(DP_SHAPES):
            m = collectives.unpack_grad_leaf(c, pls[i], shape)
            loop[i] = m if loop[i] is None else loop[i] + m
    for a, b, l, shape in zip(got, want, loop, DP_SHAPES):
        assert a.shape == b.shape and torch.equal(a, b)
        assert torch.equal(a.reshape(shape), l)


def test_uint16_leaf_views_to_and_from_uint8(gen):
    idx = torch.randint(0, 1 << 16, (8, 300), generator=gen, device="cuda",
                        dtype=torch.int32).to(torch.uint16)
    seg = idx.reshape(-1).view(torch.uint8)
    back = framing.unframe_parts(framing.frame_parts([seg, seg[:6]]),
                                 [seg.numel(), 6])[0]
    assert torch.equal(back.view(torch.uint16).reshape(8, 300), idx)


def test_wire_wrappers_count_one_launch(gen):
    x = torch.randn((8, 4096), generator=gen, device="cuda")
    _build.reset_launches()
    codes, meta = quantize.quantize_wire(x, 8, (8, 2048))
    buf = framing.frame_parts([codes.reshape(-1),
                               meta.reshape(-1).view(torch.uint8)])
    framing.unframe_parts(buf, [codes.numel(), meta.numel() * 4])
    assert _build.LAUNCHES == {"quantize_wire": 1, "frame_parts": 1,
                               "unframe_parts": 1}
