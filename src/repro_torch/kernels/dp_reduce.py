"""Fused receive-side decode + sum of the DP gradient ring: CUDA kernel
(``csrc/dp_reduce.cu``) + plain version.

Port of ``repro/kernels/dp_reduce.py``.  After the ring gather
(``transport/collectives.py``) the bank holds ``slots``, the fused uint8
payload buffers of all ``dp`` source ranks stacked in source-rank order.
:func:`decode_sum_fused` decodes every leaf's q8 bytes or q4 nibble pairs
with that source's per-tensor ``(min, scale)`` and sums them in the static
source-rank order, one ``(1, n)`` float32 tensor per leaf (views of one
flat allocation): ``acc = d_0``, then ``acc = acc + d_s`` for s = 1..dp-1,
where ``d_s = codes * scale + min`` is a multiply then an add, never an
FMA.  That is bitwise the unfused loop (``unfuse_payload`` ->
``unpack_grad_leaf`` -> add), so the collective may take either path.

``build_decode_plans`` validates the payload layout and returns ``None``
where the kernel does not apply (raw / TopK / per-tile q8 payloads, empty
leaves, non-f32 stats).  ``decode_fits`` is the reference's TPU VMEM
budget, copied as it is; the port's kernel streams from device memory and
the collective does not route on it.

Bound on the H100: memory bytes (see the note in ``csrc/dp_reduce.cu``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import device as D
from repro_torch.kernels import _build

# slots + meta + f32 accumulators all resident at once (TPU VMEM).
DECODE_MAX_BYTES = 4 * 1024 * 1024

_Q8_KEYS = frozenset(("codes", "min", "scale"))
_Q4_KEYS = frozenset(("codes4", "min", "scale"))
_TILE = 256 * 16           # elements per tile: kThreads runs of kRun
_SMEM_MAX = 232448          # shared memory a block can use (kMaxSmem)
_STAGE = 256 * 20 * 4       # the kernel's staging rows (kThreads x kRow)
MAX_DP = 4096
_SIGNATURES = {
    "decode_sum_launch": (_build.P, _build.I64, _build.I32, _build.P,
                          _build.I32, _build.I64, _build.P, _build.P),
}
_TABLES: Dict[Tuple, Tuple[torch.Tensor, int]] = {}


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """Static byte layout of one leaf's payload inside the fused buffer:
    ``kind`` q8/q4, codes at ``[off, off + nbytes)``, the f32 (min, scale)
    pair at ``[meta_off, meta_off + 8)``, dense feature count ``n``."""
    kind: str
    off: int
    nbytes: int
    meta_off: int
    n: int


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def build_decode_plans(structs, leaf_shapes) -> Optional[List[LeafPlan]]:
    """Byte-layout plans for a list of per-leaf payload structs (dicts of
    ``LeafStruct``, as ``fuse_payload`` flattens them), or ``None`` when
    the fused kernel does not apply.  Offsets follow ``payload_leaves``
    order: keys sorted, so codes always precede min/scale."""
    if len(structs) != len(leaf_shapes):
        return None
    plans, off = [], 0
    for s, shape in zip(structs, leaf_shapes):
        if not isinstance(s, dict):
            return None                      # raw passthrough (codec none)
        keys = frozenset(s)
        if keys == _Q8_KEYS:
            kind, codes = "q8", s["codes"]
        elif keys == _Q4_KEYS:
            kind, codes = "q4", s["codes4"]
        else:
            return None                      # topk / per-tile q8
        n, nbytes = _numel(shape), _numel(codes.shape)
        if (n == 0 or codes.dtype != torch.uint8
                or tuple(s["min"].shape) != () or tuple(s["scale"].shape) != ()
                or s["min"].dtype.itemsize != 4
                or s["scale"].dtype.itemsize != 4):
            return None
        if nbytes != ((n + 1) // 2 if kind == "q4" else n):
            return None
        plans.append(LeafPlan(kind, off, nbytes, off + nbytes, n))
        off += nbytes + 8
    return plans


def decode_fits(plans: Sequence[LeafPlan], dp: int,
                budget: int = DECODE_MAX_BYTES) -> bool:
    nbytes = plans[-1].meta_off + 8 if plans else 0
    dense = sum(p.n for p in plans) * 4
    return dp * nbytes + dense + dp * len(plans) * 8 <= budget


def extract_meta(slots: torch.Tensor, plans: Sequence[LeafPlan]):
    """(dp, nbytes) uint8 slots -> (dp, 2 * leaves) f32 of per-source
    (min, scale) pairs, read from the payload bytes.  Each 4-byte field
    is copied to a fresh tensor before its f32 view: ``meta_off`` has any
    alignment, and a view needs an aligned storage offset."""
    cols = [slots[:, o:o + 4].clone(memory_format=torch.contiguous_format)
            .view(torch.float32)
            for p in plans for o in (p.meta_off, p.meta_off + 4)]
    if not cols:
        return torch.zeros((slots.shape[0], 0), dtype=torch.float32,
                           device=slots.device)
    return torch.cat(cols, dim=1)


def _check(slots, plans, dp):
    if slots.ndim != 2 or slots.dtype != torch.uint8:
        raise ValueError(f"decode_sum_fused takes (dp, nbytes) uint8 slots, "
                         f"got {tuple(slots.shape)} {slots.dtype}")
    if slots.shape[0] != dp or not 1 <= dp <= MAX_DP:
        raise ValueError(f"slots {tuple(slots.shape)} for dp={dp} "
                         f"(1 <= dp <= {MAX_DP})")
    for p in plans:
        if p.meta_off + 8 > slots.shape[1] or p.meta_off != p.off + p.nbytes:
            raise ValueError(f"plan {p} does not fit rows of "
                             f"{slots.shape[1]} bytes")


def _codes(seg: torch.Tensor, p: LeafPlan) -> torch.Tensor:
    """(1, nbytes) uint8 -> (1, n) f32 codes; q4: low nibble for an even
    element, high nibble for an odd one."""
    if p.kind == "q8":
        return seg.to(torch.float32)
    pairs = torch.stack([seg & 0xF, seg >> 4], dim=-1).reshape(1, -1)
    return pairs[:, :p.n].to(torch.float32)


def decode_sum_fused_plain(slots: torch.Tensor, plans: Sequence[LeafPlan],
                           dp: int) -> List[torch.Tensor]:
    """Plain PyTorch version of :func:`decode_sum_fused`: the reference's
    static fold, each dequant a multiply then an add."""
    _check(slots, plans, dp)
    meta = extract_meta(slots, plans)
    out = []
    for li, p in enumerate(plans):
        acc = None
        for s in range(dp):
            codes = _codes(slots[s:s + 1, p.off:p.off + p.nbytes], p)
            d = codes * meta[s, 2 * li + 1] + meta[s, 2 * li]
            acc = d if acc is None else acc + d
        out.append(acc)
    return out


def _table(plans: Sequence[LeafPlan], device) -> Tuple[torch.Tensor, int]:
    """The kernel's (leaves, 6) int64 plan table on ``device`` (uploaded
    once per plan tuple and device) and the tile count."""
    key = (tuple(plans), str(device))
    if key not in _TABLES:
        rows, out_off, tile = [], 0, 0
        for p in plans:
            rows.append([int(p.kind == "q4"), p.off, p.meta_off, p.n,
                         out_off, tile])
            out_off += p.n
            tile += -(-p.n // _TILE)
        _TABLES[key] = (torch.tensor(rows, dtype=torch.int64).to(device),
                        tile)
    return _TABLES[key]


def decode_sum_fused(slots: torch.Tensor, plans: Sequence[LeafPlan],
                     dp: int) -> List[torch.Tensor]:
    """slots: (dp, nbytes) uint8 source-rank-ordered payload buffers.
    Returns one (1, n) float32 rank-summed dense gradient per plan, in one
    launch on the card (views of one flat allocation), bitwise the plain
    version and the unfused loop."""
    if not D.use_kernel(slots):
        return decode_sum_fused_plain(slots, plans, dp)
    _check(slots, plans, dp)
    if _STAGE + len(plans) * (48 + 8 * dp) > _SMEM_MAX:
        raise ValueError(f"{len(plans)} leaves at dp={dp}: the leaf table "
                         f"and (min, scale) pairs exceed the kernel's "
                         f"{_SMEM_MAX} bytes of shared memory")
    slots = slots.contiguous()
    total = sum(p.n for p in plans)
    flat = torch.empty((total,), dtype=torch.float32, device=slots.device)
    if plans:
        table, tiles = _table(plans, slots.device)
        lib = _build.library("dp_reduce", _SIGNATURES)
        with torch.cuda.device(slots.device):
            _build.call(lib, "decode_sum_launch", slots.data_ptr(),
                        slots.shape[1], dp, table.data_ptr(), len(plans),
                        tiles, flat.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
        _build.count("decode_sum_fused")
    out, off = [], 0
    for p in plans:
        out.append(flat[off:off + p.n].view(1, p.n))
        off += p.n
    return out
