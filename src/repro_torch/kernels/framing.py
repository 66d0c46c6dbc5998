"""Payload framing for fused wire hops: CUDA kernel (``csrc/framing.cu``) +
plain versions.

Port of ``repro/kernels/framing.py``.  ``fuse_payload``
(``transport/codecs.py``) turns a packed payload into ONE contiguous uint8
buffer so a hop of the fused schedules (1f1b, interleaved) moves one
buffer per direction, and the data-parallel gradient reduce
(``transport/collectives.py``) moves one buffer per replica.
:func:`frame_parts` writes each flat uint8 leaf segment at its byte offset
of the hop buffer, byte-identical to ``torch.cat(parts)``;
:func:`unframe_parts` copies each segment back out, into a fresh tensor
per leaf, so that a dtype view of a segment starts at storage offset 0
(``Tensor.view(dtype)`` needs an offset that is a multiple of the item
size).  The plain versions are ``torch.cat`` and slices copied out.

Launches.  The kernel takes its segment table by value, up to
``MAX_PARTS`` = 240 non-empty segments (the C side's capacity classes of
4, 16, 64 and 240 keep a small payload's parameter block small), so a
wrapper call is ONE launch for every payload the port frames: a hop's 2-4
segments, a DP gradient payload of gpt2-small (39 segments under q8/q4,
26 under TopK, 13 raw).  Beyond 240 it launches once per group of 240,
all writing into (or reading from) the one buffer (:func:`launch_groups`
gives the grouping).  ``LAUNCHES["frame_parts"]`` / ``["unframe_parts"]``
count KERNEL LAUNCHES, not wrapper calls.

The reference frames only buffers of up to ``FRAME_MAX_BYTES`` (4 MB, a
TPU VMEM limit that decides when its kernel runs, not what the bytes
are); the CUDA kernel streams through device memory and takes any size
and any number of segments, so every payload of two or more leaves is
framed here.

Bound on the H100: memory bytes (see the note in ``csrc/framing.cu``).
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from repro_torch import device as D
from repro_torch.kernels import _build

MAX_PARTS = 240            # as kMaxParts in the kernel
_TABLE = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    "frame_parts_launch": (_build.P, _TABLE, _TABLE, _build.I32, _build.P),
    "unframe_parts_launch": (_build.P, _TABLE, _TABLE, _build.I32, _build.P),
}


def _table(values) -> ctypes.Array:
    return (ctypes.c_longlong * len(values))(*values)


def _offsets(sizes: Sequence[int]) -> List[int]:
    offs, off = [], 0
    for nb in sizes:
        offs.append(off)
        off += nb
    return offs


def launch_groups(sizes: Sequence[int]) -> List[List[int]]:
    """The segment indices each kernel launch copies: the non-empty
    segments in order, in groups of at most ``MAX_PARTS`` (one group for
    any payload of up to 240 non-empty segments)."""
    live = [i for i, nb in enumerate(sizes) if nb]
    return [live[g:g + MAX_PARTS] for g in range(0, len(live), MAX_PARTS)]


def launch_tables(ptrs: Sequence[int], sizes: Sequence[int]):
    """What each kernel launch is given, one entry per group of
    :func:`launch_groups`: the group's leaf pointers and its n + 1
    ascending byte offsets in the buffer (the last is the group's end)."""
    offs = _offsets(sizes)
    return [([ptrs[i] for i in g], [offs[i] for i in g]
             + [offs[g[-1]] + sizes[g[-1]]]) for g in launch_groups(sizes)]


def _launch(fn: str, buf: torch.Tensor, segs, sizes, counter: str):
    tables = launch_tables([s.data_ptr() for s in segs], sizes)
    if not tables:
        return
    lib = _build.library("framing", _SIGNATURES)
    with torch.cuda.device(buf.device):
        for ptrs, offs in tables:
            _build.call(lib, fn, buf.data_ptr(), _table(ptrs), _table(offs),
                        len(ptrs), torch.cuda.current_stream().cuda_stream)
            _build.count(counter)


def _check_parts(parts):
    for p in parts:
        if p.dtype != torch.uint8 or p.ndim != 1:
            raise ValueError(f"frame_parts takes flat uint8 segments, got "
                             f"{tuple(p.shape)} {p.dtype}")


def frame_parts_plain(parts: List[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of :func:`frame_parts`."""
    _check_parts(parts)
    if not parts:
        return torch.zeros((0,), dtype=torch.uint8)
    return torch.cat(parts)


def frame_parts(parts: List[torch.Tensor]) -> torch.Tensor:
    """Concatenate flat uint8 leaf segments into one hop buffer in one
    launch (one per group of ``MAX_PARTS`` non-empty segments beyond 240):
    byte-identical to ``torch.cat(parts)``, and like it always a fresh
    tensor.  With no non-empty segment the buffer is empty and nothing is
    launched."""
    if not parts or not D.use_kernel(parts[0]):
        return frame_parts_plain(parts)
    _check_parts(parts)
    parts = [p.contiguous() for p in parts]
    sizes = [p.numel() for p in parts]
    buf = torch.empty((sum(sizes),), dtype=torch.uint8,
                      device=parts[0].device)
    _launch("frame_parts_launch", buf, parts, sizes, "frame_parts")
    return buf


def _check_buf(buf, sizes):
    if buf.dtype != torch.uint8 or buf.ndim != 1:
        raise ValueError(f"unframe_parts takes a flat uint8 buffer, got "
                         f"{tuple(buf.shape)} {buf.dtype}")
    if sum(sizes) != buf.numel() or min(sizes, default=0) < 0:
        raise ValueError(f"segment sizes {list(sizes)} do not tile a buffer "
                         f"of {buf.numel()} bytes")


def unframe_parts_plain(buf: torch.Tensor,
                        sizes: Sequence[int]) -> List[torch.Tensor]:
    """Plain PyTorch version of :func:`unframe_parts`."""
    _check_buf(buf, sizes)
    return [buf[off:off + nb].clone()
            for off, nb in zip(_offsets(sizes), sizes)]


def unframe_parts(buf: torch.Tensor,
                  sizes: Sequence[int]) -> List[torch.Tensor]:
    """Inverse of :func:`frame_parts`: the hop buffer's segments of the
    given byte ``sizes``, each in a fresh flat uint8 tensor at storage
    offset 0 (one launch, as :func:`frame_parts`; none when every segment
    is empty)."""
    if not D.use_kernel(buf):
        return unframe_parts_plain(buf, sizes)
    _check_buf(buf, sizes)
    buf = buf.contiguous()
    out = [torch.empty((nb,), dtype=torch.uint8, device=buf.device)
           for nb in sizes]
    _launch("unframe_parts_launch", buf, out, sizes, "unframe_parts")
    return out
