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


# the q4 pair's main-path shapes: serving decode and prefill (per-request
# statistics), the pipeline hop (the codec's per-tensor pair expanded over
# the rows) and every distinct gradient leaf size of gpt2-small as the DP
# codec packs it, (1, n) f32: wte, a layer norm, an attention stack, a
# bias stack, an MLP stack
GPT2_LEAF_N = (38597376, 768, 7077888, 9216, 28311552)
Q4_PATH_SHAPES = {"decode (4, 768)": ((4, 768), False),
                  "prefill (4, 49152)": ((4, 64 * 768), False),
                  "hop (8, 98304)": ((8, 128 * 768), True),
                  **{f"leaf (1, {n})": ((1, n), True) for n in GPT2_LEAF_N}}


def _q4_pair_bit_exact(x, mn, sc, monkeypatch, packed=None):
    """Both kernels against their plain versions: the packed bytes, and
    the unpacked floats as integer bits (NaN and -0.0 count).  ``packed``
    (default: the plain version's bytes) is what the unpack reads."""
    n = x.shape[1]
    got, want = _kernel_and_plain(lambda: pack4.pack4_wire(x, mn, sc),
                                  monkeypatch)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert torch.equal(got, want)
    src = want if packed is None else packed
    got, want = _kernel_and_plain(lambda: pack4.unpack4_wire(src, mn, sc, n),
                                  monkeypatch)
    assert got.shape == want.shape and torch.equal(_bits(got), _bits(want))


def _per_tensor(x):
    """The codec's statistics: one pair over the tensor, expanded."""
    mn, sc = (v.reshape(()) for v in pack4.minmax_scale(x.reshape(1, -1)))
    return mn.expand(x.shape[0]), sc.expand(x.shape[0])


@pytest.mark.parametrize("label", list(Q4_PATH_SHAPES))
def test_q4_pair_bit_exact_at_path_shapes(gen, label, monkeypatch):
    shape, per_tensor = Q4_PATH_SHAPES[label]
    x = torch.randn(shape, generator=gen, device="cuda") * 0.01
    mn, sc = _per_tensor(x) if per_tensor else pack4.minmax_scale(x)
    _q4_pair_bit_exact(x, mn, sc, monkeypatch)


def _q4_case(kind, gen):
    """(x, min, scale, packed or None) of one of the q4 pair's edge
    cases."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    if kind.startswith("n = "):                   # short and odd rows
        m, n = (int(v) for v in kind[4:].split(" x "))
        x = randn(m, n)
        return (x, *pack4.minmax_scale(x), None)
    if kind.startswith("x at element offset "):   # f32 rows 4-byte aligned
        off = int(kind[-1])
        x = randn(3 * 1001 + 3)[off:off + 3 * 1001].view(3, 1001)
        return (x, *pack4.minmax_scale(x), None)
    if kind.startswith("packed at byte offset "):  # any byte
        off = int(kind[-1])
        x = randn(5, 2 * 1003)
        mn, sc = pack4.minmax_scale(x)
        p = pack4.pack4_wire_plain(x, mn, sc).reshape(-1)
        buf = torch.zeros(p.numel() + 3, dtype=torch.uint8, device="cuda")
        buf[off:off + p.numel()] = p
        return x, mn, sc, buf[off:off + p.numel()].view(5, 1003)
    if kind == "many short rows (4096, 33)":
        x = randn(4096, 33)
        return (x, *pack4.minmax_scale(x), None)
    if kind == "constant rows":                    # span 0 -> scale 1
        x = torch.full((4, 4099), 3.25, device="cuda")
        x[1] = -0.0
        return (x, *pack4.minmax_scale(x), None)
    if kind == "exact ties":
        # min 0, max 7.5, scale 0.5: (x - min) / scale = j / 2 lies on a
        # half-integer at every odd j, the IEEE division's elements
        j = torch.arange(8 * 4096 + 7, device="cuda") % 31
        x = (j * 0.25).float().reshape(1, -1).repeat(3, 1)
        mn, sc = pack4.minmax_scale(x)
        assert (mn == 0).all() and (sc == 0.5).all()
        return x, mn, sc, None
    if kind.startswith("NaN and +-inf"):
        x = randn(6, 4101)
        x[0, 17] = float("nan")
        x[1, 4100] = float("inf")
        x[2, 0] = -float("inf")
        x[3, 1000:1002] = torch.tensor([float("inf"), -float("inf")])
        x[4, 7] = float("nan")
        x[4, 8] = float("inf")
        if kind.endswith("finite statistics"):
            clean = torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
            return (x, *pack4.minmax_scale(clean), None)
        # rows' own statistics: (NaN, 1), (min, inf), (-inf, inf)
        return (x, *pack4.minmax_scale(x), None)
    if kind == "stride-0 pair (8, 4097)":
        x = randn(8, 4097)
        return (x, *_per_tensor(x), None)
    raise ValueError(kind)


Q4_CASES = (["n = 1 x 1", "n = 2 x 3", "n = 3 x 7", "n = 2 x 8",
             "n = 3 x 15", "n = 2 x 16", "n = 2 x 17", "n = 5 x 1001",
             "n = 5 x 1002", "n = 7 x 4098"]
            + [f"x at element offset {k}" for k in (1, 2, 3)]
            + [f"packed at byte offset {k}" for k in (1, 2, 3)]
            + ["many short rows (4096, 33)", "constant rows", "exact ties",
               "NaN and +-inf, finite statistics",
               "NaN and +-inf, their own statistics",
               "stride-0 pair (8, 4097)"])


@pytest.mark.parametrize("kind", Q4_CASES)
def test_q4_pair_bit_exact_on_edge_cases(gen, kind, monkeypatch):
    x, mn, sc, packed = _q4_case(kind, gen)
    _q4_pair_bit_exact(x, mn, sc, monkeypatch, packed)


@pytest.mark.parametrize("which", ["pack4", "unpack4"])
def test_q4_expanded_pair_runs_one_device_op(gen, which):
    """With the codec's per-tensor pair expanded over the rows (stride 0)
    a call is the kernel alone: no copy of the pair."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn((8, 128 * 768), generator=gen, device="cuda")
    mn, sc = _per_tensor(x)
    assert mn.stride() == (0,)
    packed = pack4.pack4_wire(x, mn, sc)
    call = ((lambda: pack4.pack4_wire(x, mn, sc)) if which == "pack4" else
            (lambda: pack4.unpack4_wire(packed, mn, sc, x.shape[1])))
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            call()
        torch.cuda.synchronize()
    ops = {ev.key: ev.count for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA}
    assert len(ops) == 1 and f"{which}_kernel" in next(iter(ops)), ops
    assert next(iter(ops.values())) == 10, ops


# the training cut's shapes: (8, 128*768), (4, 64*768), m = 6, batch 256
# (a (256, 2048) tile, more than a cluster holds in registers), and the
# whole-tensor fallback tiles (4, 767) and (2, 5001) (wider than 2048)
CUT_SHAPES = [(8, 128 * 768), (4, 64 * 768), (6, 4096), (256, 4096),
              (4, 767), (2, 5001)]


def _cut_inputs(gen, shape, dtype, nonfinite=True):
    """Random, constant, half-zero and heavily tied tensors; with
    ``nonfinite``, also one holding a NaN, a +inf and a -inf (in three
    tiles where the shape has three)."""
    m, n = shape
    yield torch.randn(shape, generator=gen, device="cuda").to(dtype)
    yield torch.full(shape, 3.25, device="cuda").to(dtype)
    z = torch.randn(shape, generator=gen, device="cuda")
    z[::2] = 0.0                                   # all-zero rows
    yield z.to(dtype)
    yield torch.randint(-3, 4, shape, generator=gen,
                        device="cuda").to(dtype)   # heavy ties
    if nonfinite:
        x = torch.randn(shape, generator=gen, device="cuda")
        x[0, 5] = float("nan")
        x[m // 2, n // 2] = float("inf")
        x[m - 1, n - 3] = -float("inf")
        yield x.to(dtype)


def _bits(t):
    """The integer view of a float tensor's bits: ``torch.equal`` fails
    on NaN and takes -0.0 for 0.0."""
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


CUT_OPS = {"quant_dequant": lambda x: [ops.quant_dequant_op(x, bits)
                                        for bits in (4, 8)],
           "topk_block": lambda x: [ops.topk_block_op(x, k_frac)
                                    for k_frac in (0.1, 0.3)]}


@pytest.mark.parametrize("kernel", list(CUT_OPS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CUT_SHAPES)
def test_cut_kernels_bit_exact(gen, shape, dtype, kernel, monkeypatch):
    for i, x in enumerate(_cut_inputs(gen, shape, dtype)):
        got, want = _kernel_and_plain(lambda: CUT_OPS[kernel](x),
                                      monkeypatch)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            assert torch.equal(_bits(a), _bits(b)), f"input {i}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cut_kernels_bit_exact_off_16_byte_alignment(gen, dtype,
                                                     monkeypatch):
    """A cut tensor one element into its storage: the kernels take
    single elements instead of 16-byte vectors, with the same bits."""
    store = torch.randn(8 * 4096 + 1, generator=gen, device="cuda")
    x = store.to(dtype)[1:].view(8, 4096)
    assert x.data_ptr() % 16
    for fn in CUT_OPS.values():
        got, want = _kernel_and_plain(lambda: fn(x), monkeypatch)
        for a, b in zip(got, want):
            assert torch.equal(_bits(a), _bits(b))


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
    # no NaN here: the plain version's uint8 code of a NaN is undefined
    # (test_quantize_wire_carries_nan_and_inf compares where it is not)
    for x in _cut_inputs(gen, shape, dtype, nonfinite=False):
        got, want = _kernel_and_plain(
            lambda: quantize.quantize_wire(x, 8, block), monkeypatch)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_wire_carries_nan_and_inf(gen, dtype, monkeypatch):
    """A NaN in a tile makes its meta (NaN, 1) and +inf / -inf make its
    scale inf, as in the plain version: meta compared as integer bits,
    and the codes wherever they are defined ((x - min) / scale not NaN;
    a NaN's uint8 code is undefined on both sides)."""
    x = torch.randn((16, 10240), generator=gen, device="cuda")
    x[3, 100] = float("nan")
    x[5, 2048 + 7] = float("inf")
    x[9, 4096 + 2000] = -float("inf")
    x[0, 6144] = float("inf")
    x[15, 8191] = -float("inf")
    x = x.to(dtype)
    block = tiling.wire_tiling(tuple(x.shape))
    (codes, meta), (pcodes, pmeta) = _kernel_and_plain(
        lambda: quantize.quantize_wire(x, 8, block), monkeypatch)
    assert torch.equal(_bits(meta), _bits(pmeta))
    assert torch.isnan(meta[0, 0]) and meta[0, 1] == 1.0
    bm, bn = block
    mins = meta[:, 0::2].repeat_interleave(bm, 0).repeat_interleave(bn, 1)
    scales = meta[:, 1::2].repeat_interleave(bm, 0).repeat_interleave(bn, 1)
    ok = ~torch.isnan((x.float() - mins) / scales)
    assert not ok[:, :2048].any() and ok[:, 8192:].all()
    assert torch.equal(codes[ok], pcodes[ok])


def _cluster_element(shape, block, elem, rank):
    """(row, col) of the last element of the first tile that block
    ``rank`` of the tile's cluster reads: unit u (``v`` elements) belongs
    to block (u // THREADS) % cluster (``csrc/quantize.cu``)."""
    g = quantize.geometry(shape[1], *block, elem, True)
    row_units = block[1] // g.v
    u = max(u for u in range(block[0] * row_units)
            if u // quantize.THREADS % g.cluster == rank)
    return u // row_units, u % row_units * g.v + g.v - 1


def _with_nan(x, at, payload):
    """x with the NaN of bit pattern ``payload`` (x's width) at ``at``."""
    x = x.clone()
    ints = x.view(torch.int32 if x.element_size() == 4 else torch.int16)
    ints[at] = payload - (1 << 8 * x.element_size() if payload >> (
        8 * x.element_size() - 1) else 0)
    return x


def _wire_case(kind, dtype, gen):
    """(x, block) of a quantize_wire edge case."""
    if kind == "256-row microbatch":   # a (256, 2048) tile, read twice
        x = torch.randn((256, 128 * 768), generator=gen, device="cuda")
        return x.to(dtype), None
    if kind == "view at offset 1":     # one element a unit
        store = torch.randn(8 * 4096 + 1, generator=gen, device="cuda")
        x = store.to(dtype)[1:].view(8, 4096)
        assert x.data_ptr() % 16
        return x, None
    if kind == "n 1004, block (8, 502)":
        x = torch.randn((8, 1004), generator=gen, device="cuda")
        return x.to(dtype), (8, 502)
    if kind == "constant":
        return torch.full((8, 4096), 3.25, device="cuda", dtype=dtype), None
    if kind == "exact ties":   # min 0, max 127.5: scale 0.5, x = j / 4
        x = torch.arange(8 * 4096, device="cuda") % 256 * 0.25
        x = x.view(8, 4096)
        x[:, ::1024] = 127.5
        return x.to(dtype), None
    x = torch.randn((8, 128 * 768), generator=gen, device="cuda").to(dtype)
    if kind == "+-inf":
        x[0, 5] = float("inf")
        x[7, 98301] = -float("inf")
        return x, None
    # a NaN with its own payload bits in the first or last block of a hop
    # tile's cluster, or one in each
    block = tiling.wire_tiling(tuple(x.shape))
    first, last = ((0x7FC00123, 0xFFC00123) if dtype == torch.float32
                   else (0x7FC1, 0xFFC1))
    clusters = quantize.geometry(x.shape[1], *block, x.element_size(),
                                 True).cluster
    if kind in ("NaN payload, first block", "NaN payloads, both"):
        x = _with_nan(x, _cluster_element(x.shape, block, x.element_size(),
                                          0), first)
    if kind in ("NaN payload, last block", "NaN payloads, both"):
        x = _with_nan(x, _cluster_element(x.shape, block, x.element_size(),
                                          clusters - 1), last)
    return x, None


WIRE_CASES = ["256-row microbatch", "view at offset 1",
              "n 1004, block (8, 502)", "constant", "exact ties", "+-inf",
              "NaN payload, first block", "NaN payload, last block",
              "NaN payloads, both"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", WIRE_CASES)
def test_quantize_wire_bit_exact_on_edge_cases(gen, kind, dtype,
                                               monkeypatch):
    """The cluster kernel against the plain version: meta as integer bits
    (a NaN's own payload included), codes wherever defined and 0 where
    (x - min) / scale is NaN."""
    x, block = _wire_case(kind, dtype, gen)
    block = block or tiling.wire_tiling(tuple(x.shape))
    (codes, meta), (pcodes, pmeta) = _kernel_and_plain(
        lambda: quantize.quantize_wire(x, 8, block), monkeypatch)
    assert codes.dtype == torch.uint8 and codes.shape == x.shape
    assert meta.dtype == torch.float32 and meta.shape == pmeta.shape
    assert torch.equal(_bits(meta), _bits(pmeta))
    bm, bn = block
    mins = meta[:, 0::2].repeat_interleave(bm, 0).repeat_interleave(bn, 1)
    scales = meta[:, 1::2].repeat_interleave(bm, 0).repeat_interleave(bn, 1)
    ok = ~torch.isnan((x.float() - mins) / scales)
    assert torch.equal(codes[ok], pcodes[ok])
    assert not codes[~ok].any()
    if "NaN" in kind:
        assert torch.isnan(meta[0, 0]) and meta[0, 1] == 1.0
        assert torch.isfinite(meta[:, 2:]).all()
    if kind == "NaN payload, first block" and dtype == torch.float32:
        assert _bits(meta)[0, 0].item() == 0x7FC00123
    if kind == "constant":
        assert (meta[:, 1] == 1.0).all() and not codes.any()


def test_quantize_wire_runs_one_device_op_at_the_hop(gen):
    """At the pipeline hop (8, 128*768) bf16 a call is the kernel alone:
    the wrapper counts one launch a call, and a profile of 20 calls
    records that kernel and no other device op, at most once a call.
    Late in a long process CUPTI drops a profile's first records (8 of
    10 seen), so the profile need not record every call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn((8, 128 * 768), generator=gen, device="cuda").to(
        torch.bfloat16)
    block = tiling.wire_tiling(tuple(x.shape))
    quantize.quantize_wire(x, 8, block)
    torch.cuda.synchronize()
    _build.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            quantize.quantize_wire(x, 8, block)
        torch.cuda.synchronize()
    assert _build.LAUNCHES == {"quantize_wire": 20}
    ops = {ev.key: ev.count for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA}
    assert len(ops) == 1 and "quantize_wire_kernel" in next(iter(ops)), ops
    assert 10 <= next(iter(ops.values())) <= 20, ops


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
    [3, 5, 4, 4] * 4 + [9],              # 17 segments
    [1001, 4, 4] * 13,                   # a q8 DP payload: 39
    [1001, 4] * 13,                      # a TopK DP payload: 26
    [1001 + 16 * i for i in range(13)],  # a raw DP payload: 13
    [3 + i % 7 for i in range(241)],     # 241: two launches
])
def test_framing_bit_exact(gen, sizes, monkeypatch):
    parts = _segments(gen, sizes)
    # a misaligned view too: the segment starts one byte into its storage
    parts[0] = torch.cat([parts[0][:1], parts[0]])[1:]
    launches = len(framing.launch_groups(sizes))
    assert launches == (2 if len(sizes) > framing.MAX_PARTS else 1)
    _build.reset_launches()
    got, want = _kernel_and_plain(lambda: framing.frame_parts(parts),
                                  monkeypatch)
    assert torch.equal(got, want) and torch.equal(got, torch.cat(parts))
    got, want = _kernel_and_plain(lambda: framing.unframe_parts(want, sizes),
                                  monkeypatch)
    assert _build.LAUNCHES == {"frame_parts": launches,
                               "unframe_parts": launches}
    for a, b, p in zip(got, want, parts):
        assert a.storage_offset() == 0
        assert torch.equal(a, b) and torch.equal(a, p)
        assert a.data_ptr() != p.data_ptr() or not p.numel()


@pytest.mark.parametrize("src", range(16))
def test_framing_bit_exact_at_every_alignment(gen, src, monkeypatch):
    """Every pair of source and destination offsets modulo 16, both ways:
    a leaf viewed ``src`` bytes into its storage lands at buffer offset
    ``dst`` (after a leaf of ``dst`` bytes), beside a leaf 8 bytes off
    (a DP payload's (min, scale) pair); the buffer is unframed from a
    view ``dst`` bytes into its storage."""
    for dst in range(16):
        store = _segments(gen, [src + 40000])[0]
        parts = [_segments(gen, [dst])[0], store[src:], store[:8],
                 _segments(gen, [4100])[0][8:]]
        sizes = [p.numel() for p in parts]
        got, want = _kernel_and_plain(lambda: framing.frame_parts(parts),
                                      monkeypatch)
        assert torch.equal(got, want) and torch.equal(got, torch.cat(parts))
        view = torch.cat([got[:dst], got])[dst:]
        assert view.data_ptr() % 16 == dst
        back, plain = _kernel_and_plain(
            lambda: framing.unframe_parts(view, sizes), monkeypatch)
        for a, b, p in zip(back, plain, parts):
            assert a.storage_offset() == 0 and a.data_ptr() % 16 == 0
            assert torch.equal(a, b) and torch.equal(a, p)


def test_framing_one_segment_launches_and_copies(gen):
    seg = _segments(gen, [4097])[0]
    _build.reset_launches()
    buf = framing.frame_parts([seg, seg[:0]])
    back = framing.unframe_parts(buf, [0, 4097])
    assert buf.data_ptr() != seg.data_ptr() and torch.equal(buf, seg)
    assert torch.equal(back[1], seg) and back[0].numel() == 0
    assert _build.LAUNCHES == {"frame_parts": 1, "unframe_parts": 1}


@pytest.mark.parametrize("n,launches", [(16, 1), (17, 1), (39, 1),
                                        (241, 2)])
def test_framing_launches_once_per_16_segments(gen, n, launches):
    """One launch a call up to ``framing.MAX_PARTS`` (240) non-empty
    segments, one per group of 240 beyond."""
    parts = _segments(gen, [5 + i % 300 for i in range(n)])
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


def _dp_slots(gen, codec, dp, shapes, row_mod=None):
    """(dp, row_bytes) slots of seeded packed payloads; ``row_mod``
    "8 mod 16" or "odd" pads each row with random bytes so that row_bytes
    is so (the bank's rows then start at every alignment)."""
    rows = []
    c = codecs.get_codec(codec)
    for _ in range(dp):
        leaves = [torch.randn(s, generator=gen, device="cuda") * 3
                  for s in shapes]
        leaves[3] = torch.full(shapes[3], 0.75, device="cuda")
        rows.append(codecs.fuse_payload(
            [collectives.pack_grad_leaf(c, a) for a in leaves]))
    width = rows[0].numel()
    pad = {None: 0, "8 mod 16": (8 - width) % 16,
           "odd": 1 - width % 2}[row_mod]
    slots = torch.stack(rows)
    if pad:
        slots = torch.cat([slots, torch.randint(
            0, 256, (dp, pad), generator=gen, device="cuda",
            dtype=torch.uint8)], dim=1)
    plans = dp_reduce.build_decode_plans(collectives.grad_payload_structs(
        [codecs.LeafStruct(s, torch.float32) for s in shapes], codec),
        shapes)
    return slots, plans


@pytest.mark.parametrize("row_mod", [None, "8 mod 16", "odd"])
@pytest.mark.parametrize("dp", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("codec", ["q8", "q4"])
def test_decode_sum_fused_bit_exact(gen, codec, dp, row_mod, monkeypatch):
    """Kernel == plain version == the unfused loop (unfuse -> unpack ->
    rank-ordered add), bitwise, with one launch: dp 1-5 (dp 5 takes two
    batches of loads), rows of every alignment, a q4 leaf of odd n and
    leaves shorter than a thread's run, meta at odd offsets."""
    slots, plans = _dp_slots(gen, codec, dp, DP_SHAPES, row_mod)
    assert any(p.meta_off % 2 for p in plans)
    if row_mod == "8 mod 16":
        assert slots.shape[1] % 16 == 8
    elif row_mod == "odd":
        assert slots.shape[1] % 2 == 1
    _build.reset_launches()
    got, want = _kernel_and_plain(
        lambda: dp_reduce.decode_sum_fused(slots, plans, dp), monkeypatch)
    assert _build.LAUNCHES.get("decode_sum_fused") == 1
    c = codecs.get_codec(codec)
    struct = collectives.grad_payload_structs(
        [codecs.LeafStruct(s, torch.float32) for s in DP_SHAPES], codec)
    loop = [None] * len(DP_SHAPES)
    width = plans[-1].meta_off + 8
    for s in range(dp):
        pls = codecs.unfuse_payload(slots[s, :width].contiguous(), struct)
        for i, shape in enumerate(DP_SHAPES):
            m = collectives.unpack_grad_leaf(c, pls[i], shape)
            loop[i] = m if loop[i] is None else loop[i] + m
    for a, b, l, shape in zip(got, want, loop, DP_SHAPES):
        assert a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))
        assert torch.equal(_bits(a.reshape(shape)), _bits(l))


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


# the CNN slice's shapes: ResNet18's three cuts at batch 100 (tile (4,
# 2048), 800 / 400 / 200 tiles), the pipeline CNN's compressed eval of a
# whole test batch of 128 (tile (128, 2048)) and its hop, a microbatch of
# 32 at 32 x 32 x 64, all f32
CNN_CUTS = {(100, 65536): (4, 2048), (100, 32768): (4, 2048),
            (100, 16384): (4, 2048), (128, 65536): (128, 2048)}
CNN_HOP = (32, 65536)


@pytest.mark.parametrize("shape", list(CNN_CUTS))
def test_cut_kernels_bit_exact_at_the_cnn_cuts(gen, shape, monkeypatch):
    cases = {"quant_dequant": lambda x: [ops.quant_dequant_op(x, bits)
                                         for bits in (2, 4, 8)],
             "topk_block": lambda x: [ops.topk_block_op(x, k_frac)
                                      for k_frac in (0.1, 0.05)]}
    for i, x in enumerate(_cut_inputs(gen, shape, torch.float32)):
        assert ops._tile(x) == CNN_CUTS[shape]
        for fn in cases.values():
            got, want = _kernel_and_plain(lambda: fn(x), monkeypatch)
            for a, b in zip(got, want):
                assert torch.equal(_bits(a), _bits(b)), f"input {i}"


def test_hop_kernels_bit_exact_at_the_cnn_hop(gen, monkeypatch):
    """The q8 wire quantizer (wire tile (32, 2048)), the q4 pair with the
    codec's expanded per-tensor pair, the TopK select (k 10%) and framing
    of the q8 and the q4 payload, at the pipeline CNN's hop."""
    block = tiling.wire_tiling(CNN_HOP)
    assert block == (32, 2048)
    k = max(1, int(round(0.1 * CNN_HOP[1])))
    for x in _cut_inputs(gen, CNN_HOP, torch.float32, nonfinite=False):
        got, want = _kernel_and_plain(
            lambda: quantize.quantize_wire(x, 8, block), monkeypatch)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        mn, sc = (v.reshape(()).expand(CNN_HOP[0])
                  for v in pack4.minmax_scale(x.reshape(1, -1)))
        packed, want_p = _kernel_and_plain(
            lambda: pack4.pack4_wire(x, mn, sc), monkeypatch)
        assert torch.equal(packed, want_p)
        got, want = _kernel_and_plain(
            lambda: pack4.unpack4_wire(want_p, mn, sc, CNN_HOP[1]),
            monkeypatch)
        assert torch.equal(_bits(got), _bits(want))
        got, want = _kernel_and_plain(
            lambda: topk_select.topk_select_wire(x, k), monkeypatch)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        for codec in ("q8", "q4"):
            parts = [a.reshape(-1).view(torch.uint8) for a in
                     codecs.payload_leaves(codecs.get_codec(codec).pack(x))]
            buf, want_b = _kernel_and_plain(
                lambda: framing.frame_parts(parts), monkeypatch)
            assert torch.equal(buf, want_b)
            assert torch.equal(buf, torch.cat(parts))
            segs = framing.unframe_parts(buf, [p.numel() for p in parts])
            assert all(torch.equal(a, b) for a, b in zip(segs, parts))
