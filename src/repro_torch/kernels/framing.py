"""Payload framing for fused wire hops: CUDA kernel (``csrc/framing.cu``) +
plain versions.

Port of ``repro/kernels/framing.py``.  ``fuse_payload``
(``transport/codecs.py``) turns a packed payload into ONE contiguous uint8
buffer so a hop of the fused schedules (1f1b, interleaved) moves one
buffer per direction.  :func:`frame_parts` writes each flat uint8 leaf
segment at its byte offset of the hop buffer in one launch, byte-identical
to ``torch.cat(parts)``; :func:`unframe_parts` copies each segment back
out, into a fresh tensor per leaf, so that a dtype view of a segment
starts at storage offset 0 (``Tensor.view(dtype)`` needs an offset that is
a multiple of the item size).  The plain versions are ``torch.cat`` and
slices copied out.

The reference frames only hop buffers of up to ``FRAME_MAX_BYTES`` (4 MB,
a TPU VMEM limit that decides when its kernel runs, not what the bytes
are); the CUDA kernel streams through device memory and takes any size,
so every payload of two or more leaves is framed here.

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
    """Concatenate flat uint8 leaf segments into one hop buffer with one
    launch: byte-identical to ``torch.cat(parts)``, and like it always a
    fresh tensor.  Empty segments are dropped; with none left the buffer
    is empty and nothing is launched."""
    if not parts or not D.use_kernel(parts[0]):
        return frame_parts_plain(parts)
    _check_parts(parts)
    live = [p.contiguous() for p in parts if p.numel()]
    if not live:
        return parts[0].new_zeros((0,))
    if len(live) > MAX_PARTS:
        raise ValueError(f"frame_parts takes at most {MAX_PARTS} segments, "
                         f"got {len(live)}")
    sizes = [p.numel() for p in live]
    buf = torch.empty((sum(sizes),), dtype=torch.uint8, device=live[0].device)
    lib = _build.library("framing", _SIGNATURES)
    with torch.cuda.device(buf.device):
        _build.call(lib, "frame_parts_launch", buf.data_ptr(),
                    _table([p.data_ptr() for p in live]),
                    _table(_offsets(sizes)), _table(sizes), len(live),
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
    given byte ``sizes``, each in a fresh flat uint8 tensor (one launch;
    none when every segment is empty)."""
    if not D.use_kernel(buf):
        return unframe_parts_plain(buf, sizes)
    _check_buf(buf, sizes)
    live = [i for i, nb in enumerate(sizes) if nb]
    if len(live) > MAX_PARTS:
        raise ValueError(f"unframe_parts takes at most {MAX_PARTS} "
                         f"segments, got {len(live)}")
    buf = buf.contiguous()
    offs = _offsets(sizes)
    out = [torch.empty((nb,), dtype=torch.uint8, device=buf.device)
           for nb in sizes]
    if not live:
        return out
    lib = _build.library("framing", _SIGNATURES)
    with torch.cuda.device(buf.device):
        _build.call(lib, "unframe_parts_launch", buf.data_ptr(),
                    _table([out[i].data_ptr() for i in live]),
                    _table([offs[i] for i in live]),
                    _table([sizes[i] for i in live]), len(live),
                    torch.cuda.current_stream().cuda_stream)
    _build.count("unframe_parts")
    return out
