"""Exact per-row TopK select: CUDA kernels (``csrc/topk_select.cu``) + plain
versions.

Port of ``repro/kernels/topk_select.py``.  ``topk_threshold`` finds the
exact k-th largest |x| per row, the largest bit pattern t of |x| with
count(bits >= t) >= k; ``topk_compact`` — the epilogue the TPU left to
XLA — keeps exactly k entries per row (all above the threshold, then ties
by LOWEST index, ``lax.top_k``'s rule) and writes their indices ascending
with the gathered values.  The selected set equals ``lax.top_k``'s, so
the scattered dense tensor is bit-identical.

Bound on the H100: memory bytes.  The kernels cut each row into
:func:`select_grid` chunks so that rows from (4, 768) to a (1, 38.6 M)
gradient leaf fill the card: the threshold is a radix select of 2-3 digit
passes, one launch each after a zeroed scratch, and the compaction a count
launch and a write launch; a row of one chunk takes one launch for each
(see the note in ``csrc/topk_select.cu``).  The plain versions bisect the
31 magnitude bits and cumsum / scatter, as the reference does (the
scatter of the kept entries only).
"""
from __future__ import annotations

import torch

from repro_torch import device as D
from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "topk_select_state_ints": (),
    "topk_threshold_launch": (_build.P,) * 4 + (_build.I32,)
    + (_build.I64,) * 5 + (_build.P,),
    "topk_compact_launch": (_build.P,) * 5 + (_build.I32,)
    + (_build.I64,) * 5 + (_build.P,),
}
# grid planning: at least two blocks for each of the H100's 132 SMs where
# the rows are long enough, no chunk (but a row's last) under MIN_CHUNK
TARGET_BLOCKS = 2 * 132
MIN_CHUNK = 2048


def select_grid(m: int, n: int):
    """(chunks per row C, chunk length L) of the (C * m)-block grid.  Chunk
    c of a row is [c L, min(n, (c + 1) L)): in index order, disjoint,
    never empty, covering [0, n).  C = min(ceil(TARGET_BLOCKS / m), n //
    MIN_CHUNK), or 1 where that is not above 1: C * m >= TARGET_BLOCKS
    wherever n allows, and L >= MIN_CHUNK (L = ceil(n / C) gives exactly
    C chunks, since n >= C * C; the last may be shorter)."""
    want = min(-(-TARGET_BLOCKS // m), n // MIN_CHUNK)
    if want <= 1:
        return 1, n
    length = -(-n // want)
    return -(-n // length), length


def _check(flat: torch.Tensor, k: int):
    if flat.ndim != 2 or flat.dtype not in _DTYPE_CODE:
        raise ValueError(f"TopK select takes a 2-D float32/bfloat16 "
                         f"tensor, got {tuple(flat.shape)} {flat.dtype}")
    m, n = flat.shape
    if not (1 <= k <= n < 2 ** 31) or m < 1:
        raise ValueError(f"need 1 <= k <= n < 2**31 and m >= 1, got "
                         f"m={m} n={n} k={k}")


def _magnitude_bits(flat: torch.Tensor) -> torch.Tensor:
    return flat.to(torch.float32).abs().view(torch.int32)


def topk_threshold_plain(flat: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`topk_threshold`."""
    _check(flat, k)
    bits = _magnitude_bits(flat)
    t = torch.zeros((flat.shape[0], 1), dtype=torch.int32, device=flat.device)
    for b in range(30, -1, -1):
        cand = t | (1 << b)
        cnt = (bits >= cand).sum(dim=1, keepdim=True)
        t = torch.where(cnt >= k, cand, t)
    return t.view(torch.float32)


def topk_threshold(flat: torch.Tensor, k: int) -> torch.Tensor:
    """flat: (M, N).  The EXACT k-th largest |x| per row, (M, 1) float32:
    count(|x| >= t) >= k and count(|x| > t) < k."""
    if not D.use_kernel(flat):
        return topk_threshold_plain(flat, k)
    _check(flat, k)
    flat = flat.contiguous()
    m, n = flat.shape
    chunks, length = select_grid(m, n)
    thresh = torch.empty((m, 1), dtype=torch.float32, device=flat.device)
    lib = _build.library("topk_select", _SIGNATURES)
    scratch = []
    if chunks > 1:          # the passes' row histograms, tickets, prefixes
        scratch.append(torch.zeros((m, lib.topk_select_state_ints()),
                                   dtype=torch.int32, device=flat.device))
        if flat.dtype == torch.float32:   # pass 1's candidates, <= n / 8
            scratch.append(torch.empty((m, n // 8), dtype=torch.int32,
                                       device=flat.device))
    ptrs = [t.data_ptr() for t in scratch] + [None] * (2 - len(scratch))
    with torch.cuda.device(flat.device):
        _build.call(lib, "topk_threshold_launch", flat.data_ptr(),
                    thresh.data_ptr(), *ptrs, _DTYPE_CODE[flat.dtype], m, n,
                    k, length, chunks, torch.cuda.current_stream().cuda_stream)
    _build.count("topk_threshold")
    return thresh


def topk_compact_plain(flat: torch.Tensor, thresh: torch.Tensor, k: int):
    """Plain PyTorch version of :func:`topk_compact` — the cumsum/scatter
    epilogue of the JAX ``topk_select_wire``."""
    _check(flat, k)
    m, n = flat.shape
    mag = flat.to(torch.float32).abs()
    gt = mag > thresh
    eq = mag == thresh
    c_gt = gt.sum(dim=1, keepdim=True)
    tie_rank = eq.to(torch.int32).cumsum(dim=1)
    keep = gt | (eq & (tie_rank <= k - c_gt))           # exactly k per row
    slot = keep.to(torch.int32).cumsum(dim=1) - 1
    # only the kept entries are written, each to its own slot: scattering
    # every entry (the rest into a dropped column) makes deterministic
    # CUDA serialise the colliding writes, seconds on a gradient leaf
    rows, cols = keep.nonzero(as_tuple=True)
    at = slot[rows, cols]
    live = at < k
    idx = torch.zeros((m, k), dtype=torch.int32, device=flat.device)
    idx[rows[live], at[live]] = cols[live].to(torch.int32)
    return flat.gather(1, idx.long()), idx


def topk_compact(flat: torch.Tensor, thresh: torch.Tensor, k: int):
    """(M, N) + exact thresholds (M, 1) -> (values (M, k) flat.dtype,
    indices (M, k) int32 ascending)."""
    if not D.use_kernel(flat):
        return topk_compact_plain(flat, thresh, k)
    _check(flat, k)
    flat = flat.contiguous()
    m, n = flat.shape
    if thresh.shape != (m, 1) or thresh.dtype != torch.float32:
        raise ValueError(f"thresh must be ({m}, 1) float32, got "
                         f"{tuple(thresh.shape)} {thresh.dtype}")
    thresh = thresh.contiguous()
    chunks, length = select_grid(m, n)
    vals = torch.empty((m, k), dtype=flat.dtype, device=flat.device)
    idx = torch.empty((m, k), dtype=torch.int32, device=flat.device)
    counts = None           # each chunk's (above, equal) counts
    if chunks > 1:
        counts = torch.empty((m, chunks, 2), dtype=torch.int32,
                             device=flat.device)
    lib = _build.library("topk_select", _SIGNATURES)
    with torch.cuda.device(flat.device):
        _build.call(lib, "topk_compact_launch", flat.data_ptr(),
                    thresh.data_ptr(), None if counts is None
                    else counts.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                    _DTYPE_CODE[flat.dtype], m, n, k, length, chunks,
                    torch.cuda.current_stream().cuda_stream)
    _build.count("topk_compact")
    return vals, idx


def topk_select_wire_plain(flat: torch.Tensor, k: int):
    """Plain PyTorch version of :func:`topk_select_wire`."""
    return topk_compact_plain(flat, topk_threshold_plain(flat, k), k)


def topk_select_wire(flat: torch.Tensor, k: int):
    """(M, N) -> (values (M, k) flat.dtype, indices (M, k) int32): the
    ``lax.top_k`` set per row, indices ascending."""
    return topk_compact(flat, topk_threshold(flat, k), k)
