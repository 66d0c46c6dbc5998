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

Launches.  The kernel takes a by-value table of at most ``MAX_PARTS`` =
16 segments, so a wrapper launches it once per group of 16 non-empty
segments, all writing into (or reading from) the one buffer: a payload of
1-16 live segments is one launch, a DP gradient payload of gpt2-small (39
segments under q8/q4, 26 under TopK) is three or two.
``LAUNCHES["frame_parts"]`` / ``["unframe_parts"]`` count KERNEL LAUNCHES,
not wrapper calls (:func:`launch_groups` gives the grouping).

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

MAX_PARTS = 16
_TABLE = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    "frame_parts_launch": (_build.P, _TABLE, _TABLE, _TABLE, _build.I32,
                           _build.P),
    "unframe_parts_launch": (_build.P, _TABLE, _TABLE, _TABLE, _build.I32,
                             _build.P),
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
    segments in order, in groups of at most ``MAX_PARTS``."""
    live = [i for i, nb in enumerate(sizes) if nb]
    return [live[g:g + MAX_PARTS] for g in range(0, len(live), MAX_PARTS)]


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
    """Concatenate flat uint8 leaf segments into one hop buffer, one
    launch per group of ``MAX_PARTS`` non-empty segments: byte-identical
    to ``torch.cat(parts)``, and like it always a fresh tensor.  With no
    non-empty segment the buffer is empty and nothing is launched."""
    if not parts or not D.use_kernel(parts[0]):
        return frame_parts_plain(parts)
    _check_parts(parts)
    parts = [p.contiguous() for p in parts]
    sizes = [p.numel() for p in parts]
    offs = _offsets(sizes)
    buf = torch.empty((sum(sizes),), dtype=torch.uint8,
                      device=parts[0].device)
    groups = launch_groups(sizes)
    if not groups:
        return buf
    lib = _build.library("framing", _SIGNATURES)
    with torch.cuda.device(buf.device):
        for g in groups:
            _build.call(lib, "frame_parts_launch", buf.data_ptr(),
                        _table([parts[i].data_ptr() for i in g]),
                        _table([offs[i] for i in g]),
                        _table([sizes[i] for i in g]), len(g),
                        torch.cuda.current_stream().cuda_stream)
            _build.count("frame_parts")
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
    given byte ``sizes``, each in a fresh flat uint8 tensor (one launch
    per group of ``MAX_PARTS`` non-empty segments; none when every
    segment is empty)."""
    if not D.use_kernel(buf):
        return unframe_parts_plain(buf, sizes)
    _check_buf(buf, sizes)
    buf = buf.contiguous()
    offs = _offsets(sizes)
    out = [torch.empty((nb,), dtype=torch.uint8, device=buf.device)
           for nb in sizes]
    groups = launch_groups(sizes)
    if not groups:
        return out
    lib = _build.library("framing", _SIGNATURES)
    with torch.cuda.device(buf.device):
        for g in groups:
            _build.call(lib, "unframe_parts_launch", buf.data_ptr(),
                        _table([out[i].data_ptr() for i in g]),
                        _table([offs[i] for i in g]),
                        _table([sizes[i] for i in g]), len(g),
                        torch.cuda.current_stream().cuda_stream)
            _build.count("unframe_parts")
    return out
