"""The framing kernel's algorithm (``csrc/framing.cu``), on the CPU.

No CUDA here, so a line-for-line numpy model of ``framing_kernel`` runs
on a byte array that stands for device memory: the flat work list of
buffer chunks (16 KB, down to 4 KB for a small payload), the binary
search for a chunk's first segment, each
piece's head bytes, 16-byte vectors realigned from aligned 16-byte words
(``realign.cuh``'s selects and funnel shifts), and tail bytes.  It is fed
the tables of ``kernels/framing.py::launch_tables`` and must give
``torch.cat`` / the split copy byte for byte, at every pair of source and
destination offsets modulo 16, with every loaded word holding a byte of
its piece and every store to an aligned vector.  The card tests
(``tests/test_torch_kernels_cuda.py``) hold the kernel itself to the
plain version.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import framing

THREADS, UNROLL = 256, 4
CHUNK, MIN_CHUNK = 16 * THREADS * UNROLL, 16 * THREADS
SMS = 132                              # an H100's SMs


def chunk_for(total, sms=SMS):
    """The launch's chunk: 16 KB, halved down to 4 KB while the grid
    would leave an SM without two blocks."""
    chunk = CHUNK
    while chunk > MIN_CHUNK and -(-total // chunk) < 2 * sms:
        chunk //= 2
    return chunk


def funnel_r(lo, hi, sh):
    return ((int(hi) << 32 | int(lo)) >> (sh & 31)) & 0xFFFFFFFF


def realign16(lo, hi, delta):
    """``realign16`` of realign.cuh: bytes [delta, delta + 16) of lo:hi,
    each a tuple of four little-endian 32-bit words."""
    two, one = delta & 8, delta & 4
    w = [lo[2], lo[3], hi[0], hi[1], hi[2], hi[3]] if two else \
        [lo[0], lo[1], lo[2], lo[3], hi[0], hi[1]]
    if one:
        w = w[1:] + [0]
    sh = (delta & 3) * 8
    return [funnel_r(w[j], w[j + 1], sh) for j in range(4)]


class Memory:
    """A flat byte array standing for device memory; loads of aligned
    16-byte words are checked to hold a byte of the run being read."""

    def __init__(self, size):
        self.b = np.zeros(size, np.uint8)

    def word(self, addr, run):
        assert addr % 16 == 0
        assert addr < run[1] and addr + 16 > run[0], (addr, run)
        return tuple(int(v) for v in self.b[addr:addr + 16].view("<u4"))

    def load16(self, p, run):
        """``load16``: the 16 bytes at p by aligned loads."""
        delta = p & 15
        lo = self.word(p - delta, run)
        if not delta:
            return list(lo)
        return realign16(lo, self.word(p - delta + 16, run), delta)

    def store16(self, p, words):
        assert p % 16 == 0
        self.b[p:p + 16] = np.array(words, "<u4").view(np.uint8)


def copy_piece(mem, dst, src, nb):
    head = min((16 - dst % 16) % 16, nb)
    nvec = (nb - head) >> 4
    tail = head + (nvec << 4)
    assert nvec <= THREADS * UNROLL and nb - tail <= THREADS - 32
    run = (src, src + nb)
    vecs = [mem.load16(src + head + 16 * i, run) for i in range(nvec)]
    mem.b[dst:dst + head] = mem.b[src:src + head]
    mem.b[dst + tail:dst + nb] = mem.b[src + tail:src + nb]
    for i, v in enumerate(vecs):
        mem.store16(dst + head + 16 * i, v)


def framing_kernel(mem, segs, offs, buf, to_buf):
    """One launch: ``segs`` leaf addresses, ``offs`` their n + 1 buffer
    offsets."""
    n, begin, end = len(segs), offs[0], offs[-1]
    chunk = chunk_for(end - begin)
    for b in range(-(-(end - begin) // chunk)):
        lo = begin + b * chunk
        hi = min(lo + chunk, end)
        a, z = 0, n - 1
        while a < z:
            mid = (a + z + 1) >> 1
            if offs[mid] <= lo:
                a = mid
            else:
                z = mid - 1
        p = a
        while p < n and offs[p] < hi:
            frm, to = max(offs[p], lo), min(offs[p + 1], hi)
            leaf = segs[p] + frm - offs[p]
            if to_buf:
                copy_piece(mem, buf + frm, leaf, to - frm)
            else:
                copy_piece(mem, leaf, buf + frm, to - frm)
            p += 1


def run_model(sizes, seg_mod, buf_mod, seed=0):
    """Frames segments of ``sizes`` (leaf p at an address = seg_mod[p]
    mod 16) into a buffer at an address = buf_mod mod 16, then unframes
    it into fresh segments at address 0 mod 16; returns both results and
    what torch.cat / the split copy give."""
    rng = np.random.RandomState(seed)
    mem = Memory(sum(sizes) * 3 + 64 * len(sizes) + 4096)
    addr, segs, out = 64, [], []
    for nb, mod in zip(sizes, seg_mod):
        addr += (mod - addr) % 16
        segs.append(addr)
        mem.b[addr:addr + nb] = rng.randint(0, 256, nb)
        addr += nb + 16
    addr += (buf_mod - addr) % 16
    buf = addr
    addr += sum(sizes) + 32
    for nb in sizes:
        addr += (-addr) % 16
        out.append(addr)
        addr += nb + 16
    want = np.concatenate([mem.b[s:s + nb] for s, nb in zip(segs, sizes)])
    launches = 0
    for ptrs, offs in framing.launch_tables(segs, sizes):
        framing_kernel(mem, ptrs, offs, buf, True)
        launches += 1
    got = mem.b[buf:buf + sum(sizes)].copy()
    for ptrs, offs in framing.launch_tables(out, sizes):
        framing_kernel(mem, ptrs, offs, buf, False)
    back = [mem.b[o:o + nb].copy() for o, nb in zip(out, sizes)]
    return got, want, back, launches


@pytest.mark.parametrize("src_mod", range(16))
@pytest.mark.parametrize("dst_mod", range(16))
def test_framing_model_every_alignment_pair(src_mod, dst_mod):
    """Every (source, destination) offset pair modulo 16: a DP-like
    payload (codes of 40,000 and 3 bytes, an 8-byte (min, scale) pair
    after each, so the chunk walk crosses segments) byte-identical to
    torch.cat both ways, in one launch."""
    sizes = [40000, 8, 3, 8, 1001, 8]
    mods = [src_mod, (src_mod + 8) % 16, src_mod, 3, (src_mod + 5) % 16, 0]
    got, want, back, launches = run_model(sizes, mods, dst_mod)
    np.testing.assert_array_equal(got, want)
    offs = np.cumsum([0] + sizes)
    for a, o, nb in zip(back, offs, sizes):
        np.testing.assert_array_equal(a, want[o:o + nb])
    assert launches == 1


@pytest.mark.parametrize("sizes", [
    [786432, 384],                       # q8-tiled hop: 193 chunks
    [1, 7, 0, 33, 4097, 2, 16, 15],      # odd sizes and an empty leaf
    [4097],                              # one segment
    [3, 5, 4, 4] * 4 + [9],              # 17 segments, one launch
    [1001, 4, 4] * 13,                   # a q8 DP payload, 39 segments
    [1001, 4] * 13,                      # a TopK DP payload, 26
    [5 + i for i in range(13)],          # a raw DP payload, 13
    [3 + i % 7 for i in range(241)],     # 241 segments: two launches
])
def test_framing_model_layouts(sizes):
    live = [nb for nb in sizes if nb]
    mods = [(7 * i + 1) % 16 for i in range(len(sizes))]
    got, want, back, launches = run_model(sizes, mods, 8, seed=len(sizes))
    np.testing.assert_array_equal(got, want)
    offs = np.cumsum([0] + list(sizes))
    for a, o, nb in zip(back, offs, sizes):
        np.testing.assert_array_equal(a, want[o:o + nb])
    assert launches == -(-len(live) // framing.MAX_PARTS)


def test_chunk_sizes():
    """A DP payload takes 16 KB chunks, the hop 4 KB: every SM gets two
    blocks where the payload allows."""
    assert chunk_for(123570536) == CHUNK
    assert chunk_for(786816) == MIN_CHUNK
    assert -(-786816 // MIN_CHUNK) == 193
    assert chunk_for(264 * 8192) == 8192
    assert chunk_for(10) == MIN_CHUNK


def test_launch_tables_cover_the_buffer():
    """Each launch's offsets ascend from its first segment's to its end,
    and the launches tile the buffer without a gap; empty segments are
    left out."""
    sizes = [3, 0, 5] * 130 + [7]
    tables = framing.launch_tables(list(range(len(sizes))), sizes)
    assert len(tables) == 2
    pos = 0
    for ptrs, offs in tables:
        assert len(offs) == len(ptrs) + 1 and offs[0] == pos
        assert all(b > a for a, b in zip(offs, offs[1:]))
        assert all(sizes[p] == b - a for p, a, b in zip(ptrs, offs, offs[1:]))
        pos = offs[-1]
    assert pos == sum(sizes)
    assert framing.launch_tables([0, 1], [0, 0]) == []
    assert torch.equal(framing.frame_parts(
        [torch.arange(n, dtype=torch.uint8) for n in sizes[:9]]),
        torch.cat([torch.arange(n, dtype=torch.uint8) for n in sizes[:9]]))
