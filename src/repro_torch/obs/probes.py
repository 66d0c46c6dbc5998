"""Bandwidth probes: measured bytes/s per ring, closing the loop.

Port of ``repro/obs/probes.py``.  Agarwal et al. (2103.00543): whether
compression pays off is a function of the MEASURED link bandwidth, not
the nominal one.  The reference times a real ``ppermute`` ring hop per
mesh axis and reports achieved bytes/s per link-pair set, keyed
``"{{src,dst},...}"`` as its HLO launch audit keys collectives, so that
a probe measurement and a ``bandwidth>=X``
:class:`~repro_torch.core.policy.PolicyRule` predicate speak about the
same ring.

This port has no mesh: every lane, stage and rank is a lane of the one
card (``transport/collectives.py``).  Lanes are numbered 0..N-1 in
row-major order of the grid, which gives the reference's pairs on a mesh
of devices 0..N-1 in that shape.  A hop is every lane's uint8 buffer
copied into the next lane's slot of a preallocated buffer on the device.
On one card that measures the card's own copy rate as one lane sees it,
NOT a link's bandwidth: nothing crosses a wire.  Sending the hop between
cards is the multi-card slice's work.

The loop closes in ``train/loop.py``: a ``bandwidth_probe`` callable is
invoked between epochs, its measurement re-resolves the ``PolicyRules``,
and the chosen codec follows the wire.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs import trace


def ring_pairs(shape: Sequence[int], axis_names: Sequence[str],
               axis: str) -> Set[Tuple[int, int]]:
    """Source->target lane pairs of the ``axis`` ring on a grid of
    ``shape`` (lanes numbered row-major): within every slice along the
    other axes, position r sends to r+1 (mod n)."""
    lanes = np.arange(int(np.prod(shape))).reshape(tuple(shape))
    ax = list(axis_names).index(axis)
    n = lanes.shape[ax]
    cols = np.moveaxis(lanes, ax, 0).reshape(n, -1)
    pairs = set()
    for c in range(cols.shape[1]):
        for r in range(n):
            pairs.add((int(cols[r, c]), int(cols[(r + 1) % n, c])))
    return pairs


def pairs_key(pairs: Set[Tuple[int, int]]) -> str:
    """``{{src,dst},...}`` formatting (sorted)."""
    return ("{" + ",".join("{%d,%d}" % p for p in sorted(pairs)) + "}")


@dataclasses.dataclass(frozen=True)
class LinkMeasurement:
    """Achieved bandwidth of one ring's hop (the slowest link bounds a
    synchronous ring hop, so one number per ring is the honest grain)."""
    axis: str
    pairs: str                   # pairs_key(...) of the measured ring
    payload_bytes: int           # bytes each lane put on the hop
    seconds: float               # best-of-repeats wall time of one hop
    hops: int = 1

    @property
    def bytes_per_s(self) -> float:
        return (self.payload_bytes * self.hops / self.seconds
                if self.seconds > 0 else float("inf"))

    def to_dict(self) -> dict:
        return {"axis": self.axis, "pairs": self.pairs,
                "payload_bytes": self.payload_bytes,
                "seconds": round(self.seconds, 6),
                "bytes_per_s": round(self.bytes_per_s, 1)}


def probe_ring(n: int, axis: str, *, payload_bytes: int = 1 << 22,
               repeats: int = 3, device=None,
               grid: Optional[Dict[str, int]] = None) -> LinkMeasurement:
    """Time one uint8 ring hop over the ``n`` lanes of ``axis`` and report
    achieved bytes/s: every lane's buffer of ``payload_bytes`` copied into
    the next lane's slot of a preallocated buffer on ``device`` (``cuda``
    unless given).  ``grid``: the whole lane grid, axis name -> size in
    order (default ``{axis: n}``); the hop then runs in every slice along
    the other axes at once.  Wall time from dispatch to
    ``torch.cuda.synchronize()`` (the reference's ``block_until_ready``),
    best of ``repeats`` after a warm-up dispatch; emits a ``probe.ring``
    instant."""
    dev = resolve_device(device)
    grid = dict(grid) if grid is not None else {axis: n}
    if grid.get(axis) != n:
        raise ValueError(f"grid {grid} has no axis {axis!r} of size {n}")
    per = max(1, payload_bytes)
    shape = tuple(grid.values())
    ax = list(grid).index(axis)
    src = torch.zeros((*shape, per), dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)

    def hop():
        # lane r's buffer into lane r+1's slot, the last into lane 0's
        dst.narrow(ax, 1, n - 1).copy_(src.narrow(ax, 0, n - 1))
        dst.narrow(ax, 0, 1).copy_(src.narrow(ax, n - 1, 1))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    hop()                                              # warm-up dispatch
    best = float("inf")
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        hop()
        best = min(best, time.perf_counter() - t0)
    m = LinkMeasurement(axis=axis,
                        pairs=pairs_key(ring_pairs(shape, list(grid), axis)),
                        payload_bytes=per, seconds=best)
    trace.instant("probe.ring", cat="probe", **m.to_dict())
    return m


def probe_mesh(axes: Dict[str, int], *, payload_bytes: int = 1 << 22,
               repeats: int = 3, device=None) -> Dict[str, LinkMeasurement]:
    """One ring measurement per axis of the lane grid ``axes`` (axis name
    -> size, e.g. ``{"data": 2, "stage": 4}``), keyed by axis name."""
    return {a: probe_ring(n, a, payload_bytes=payload_bytes,
                          repeats=repeats, device=device, grid=axes)
            for a, n in axes.items()}


def boundary_bandwidth(measurements,
                       stage_axis: str = "stage") -> Optional[float]:
    """The single bytes/s number a ``bandwidth>=X`` policy predicate
    consumes: the stage-hop ring's achieved bandwidth (boundary payloads
    ride that ring), falling back to the slowest measured ring when no
    axis matches.  Accepts a measurement dict from :func:`probe_mesh`,
    one :class:`LinkMeasurement`, a plain float, or None."""
    if measurements is None:
        return None
    if isinstance(measurements, (int, float)):
        return float(measurements)
    if isinstance(measurements, LinkMeasurement):
        return measurements.bytes_per_s
    if stage_axis in measurements:
        return measurements[stage_axis].bytes_per_s
    if not measurements:
        return None
    return min(m.bytes_per_s for m in measurements.values())
