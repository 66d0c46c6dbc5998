"""q4 wire pack / unpack: CUDA kernels (``csrc/pack4.cu``) + plain versions.

Port of ``repro/kernels/pack4.py``.  Byte ``j`` of a row is
``code[2j] | code[2j+1] << 4`` with one zero pad code when the feature dim
is odd.  The JAX kernel takes one per-tensor (min, scale) pair; the port's
kernel takes one pair PER ROW, ``(M,)`` each, because the serving boundary
packs each request's row as its own payload (the written-out ``jax.vmap``
of core/boundary.py).  With one row — or the per-tensor pair expanded over
the rows, as ``transport/codecs.py`` does — it is exactly the TPU kernel's
per-tensor format.

The (min, scale) reduction (:func:`minmax_scale`) stays a torch reduction
before the kernel, as the JAX package computes it outside its Pallas body.
Bytes are bit-identical to the plain version and to the JAX q4 wire format;
the dequant is ``codes*scale+min`` without FMA contraction, bit-identical
to the plain version.

Bound on the H100: memory bytes (see the note in ``csrc/pack4.cu``).
The statistics are read in place with a row stride of 0 or 1
(:func:`stat_stride`), so the codec's expanded per-tensor pair costs no
copy: each wrapper call is one device op.  :func:`geometry` sizes both
kernels' launch.
"""
from __future__ import annotations

import functools

import torch

from repro_torch import device as D
from repro_torch.kernels import _build

LEVELS = 15.0
_ARGS = ((_build.P,) * 4 + (_build.I64,) * 4 + (_build.I32,) * 3
         + (_build.P,))
_SIGNATURES = {"pack4_wire_launch": _ARGS, "unpack4_wire_launch": _ARGS}
UNIT = 8             # elements (4 packed bytes) a kernel unit
MAX_THREADS = 256    # a block's threads at most (csrc/pack4.cu kMaxThreads)
MAX_UNITS = 4        # units a thread at most
_SMS = {}            # device index -> streaming multiprocessors


def minmax_scale(flat: torch.Tensor):
    """Per-row ``(min, scale)`` of ``(M, N)``, ``(M,)`` each, as in
    ``quantize_kbit``."""
    mn, mx = flat.amin(dim=1), flat.amax(dim=1)
    span = mx - mn
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not IEEE division
    sc = torch.where(span > 0, span / torch.full_like(span, LEVELS),
                     torch.ones_like(span))
    return mn, sc


def _check_stats(m, mn, sc):
    for v in (mn, sc):
        if v.shape != (m,) or v.dtype != torch.float32:
            raise ValueError(f"min/scale must be ({m},) float32, got "
                             f"{tuple(v.shape)} {v.dtype}")


def stat_stride(v: torch.Tensor):
    """``(tensor, stride)`` through which the kernels read a per-row
    statistic ``v`` of shape ``(m,)``: row r's value is
    ``tensor[r * stride]``.  The codec's expanded per-tensor pair (stride
    0) and a contiguous ``(m,)`` tensor (stride 1) are read in place, as is
    any one-row tensor (stride 0); any other stride is copied."""
    if v.stride(0) in (0, 1):
        return v, v.stride(0)
    if v.shape[0] <= 1:
        return v, 0
    return v.contiguous(), 1


@functools.lru_cache(maxsize=256)
def geometry(m: int, n: int, sms: int):
    """``(units a thread, threads a block, blocks a row)`` of both kernels
    on an ``(m, n)`` tensor.  A block works ``units * threads`` consecutive
    units (8 elements each) of one row; a row's body holds at most
    ``n // 8``.  Units a thread halve from 4, then threads from 256 down to
    64, while the grid would not fill ``sms`` SMs twice over; a row shorter
    than a block takes a block of as many warps as its units need."""
    units = n // UNIT
    per, threads = MAX_UNITS, MAX_THREADS

    def blocks():
        return m * max(1, -(-units // (per * threads)))
    while per > 1 and blocks() < 2 * sms:
        per //= 2
    while threads > 64 and blocks() < 2 * sms:
        threads //= 2
    threads = min(threads, max(32, 32 * -(-units // (32 * per))))
    chunks = max(1, -(-units // (per * threads)))
    if n >= 1 << 31 or m * chunks >= 1 << 31:
        raise ValueError(f"({m}, {n}) is beyond the q4 kernels' 32-bit "
                         f"row and grid indices")
    return per, threads, chunks


def _sm_count(device) -> int:
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device.index]


def _check_pack(flat, mn, sc):
    if flat.ndim != 2 or flat.dtype != torch.float32:
        raise ValueError(f"pack4_wire takes a 2-D float32 tensor, got "
                         f"{tuple(flat.shape)} {flat.dtype}")
    _check_stats(flat.shape[0], mn, sc)


def pack4_wire_plain(flat: torch.Tensor, mn: torch.Tensor,
                     sc: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`pack4_wire`."""
    _check_pack(flat, mn, sc)
    n = flat.shape[1]
    codes = torch.clamp(torch.round((flat - mn[:, None]) / sc[:, None]),
                        0.0, LEVELS).to(torch.uint8)
    if n % 2:
        codes = torch.nn.functional.pad(codes, (0, 1))
    return codes[:, 0::2] | (codes[:, 1::2] << 4)


def pack4_wire(flat: torch.Tensor, mn: torch.Tensor,
               sc: torch.Tensor) -> torch.Tensor:
    """flat: (M, N) float32, per-row min/scale (M,) float32 -> packed uint8
    (M, ceil(N/2))."""
    if not D.use_kernel(flat):
        return pack4_wire_plain(flat, mn, sc)
    _check_pack(flat, mn, sc)
    flat = flat.contiguous()
    (mn, ms), (sc, ss) = stat_stride(mn), stat_stride(sc)
    m, n = flat.shape
    packed = torch.empty((m, (n + 1) // 2), dtype=torch.uint8,
                         device=flat.device)
    lib = _build.library("pack4", _SIGNATURES)
    with torch.cuda.device(flat.device):
        _build.call(lib, "pack4_wire_launch", flat.data_ptr(), mn.data_ptr(),
                    sc.data_ptr(), packed.data_ptr(), m, n, ms, ss,
                    *geometry(m, n, _sm_count(flat.device)),
                    torch.cuda.current_stream().cuda_stream)
    _build.count("pack4_wire")
    return packed


def _check_unpack(packed, mn, sc, n):
    if packed.ndim != 2 or packed.dtype != torch.uint8:
        raise ValueError(f"unpack4_wire takes a 2-D uint8 tensor, got "
                         f"{tuple(packed.shape)} {packed.dtype}")
    if packed.shape[1] != (n + 1) // 2:
        raise ValueError(f"packed width {packed.shape[1]} != ceil({n}/2)")
    _check_stats(packed.shape[0], mn, sc)


def unpack4_wire_plain(packed: torch.Tensor, mn: torch.Tensor,
                       sc: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`unpack4_wire`."""
    _check_unpack(packed, mn, sc, n)
    m = packed.shape[0]
    codes = torch.stack([packed & 0xF, packed >> 4], dim=-1)
    codes = codes.reshape(m, -1)[:, :n].to(torch.float32)
    return codes * sc[:, None] + mn[:, None]


def unpack4_wire(packed: torch.Tensor, mn: torch.Tensor, sc: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Inverse of :func:`pack4_wire`: (M, ceil(n/2)) uint8 and per-row
    min/scale (M,) -> (M, n) float32."""
    if not D.use_kernel(packed):
        return unpack4_wire_plain(packed, mn, sc, n)
    _check_unpack(packed, mn, sc, n)
    packed = packed.contiguous()
    (mn, ms), (sc, ss) = stat_stride(mn), stat_stride(sc)
    m = packed.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=packed.device)
    lib = _build.library("pack4", _SIGNATURES)
    with torch.cuda.device(packed.device):
        _build.call(lib, "unpack4_wire_launch", packed.data_ptr(),
                    mn.data_ptr(), sc.data_ptr(), out.data_ptr(), m, n, ms,
                    ss, *geometry(m, n, _sm_count(packed.device)),
                    torch.cuda.current_stream().cuda_stream)
    _build.count("unpack4_wire")
    return out
