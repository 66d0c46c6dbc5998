"""Lane grids: the port's meshes.

Port of ``repro/launch/mesh.py``.  The reference builds ``jax.sharding``
meshes of devices; this port runs every lane, stage and rank on the one
card (``transport/collectives.py``), so a mesh is a :class:`LaneGrid`:
axis names, a shape, and lane ids numbered 0..N-1 in row-major order, the
form ``obs/probes.py::ring_pairs`` takes.  The size checks raise the
reference's ``ValueError``s.  The reference's ``RuntimeError`` for too few
devices has no counterpart: a grid of any size is lanes of one card.

The production grids are the reference's: (16, 16) ``(data, tensor)`` for
one pod, (2, 16, 16) ``(pod, data, tensor)`` for two.  The dry run
(``launch/dryrun.py``) and the sharding rules (``sharding/specs.py``)
read them; nothing places a tensor on them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class LaneGrid:
    """``axis_names`` and ``shape`` of a grid of lanes, numbered in
    row-major order (:attr:`lanes`)."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"grid shape {self.shape} and axis names "
                             f"{self.axis_names} differ in length")

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    @property
    def sizes(self) -> Dict[str, int]:
        """Axis name -> its size (the reference's ``mesh.shape``)."""
        return dict(zip(self.axis_names, self.shape))

    @property
    def lanes(self) -> np.ndarray:
        """Lane ids in the grid's shape, row-major."""
        return np.arange(self.size).reshape(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> LaneGrid:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "tensor") if multi_pod else ("data", "tensor")
    return LaneGrid(shape, axes)


def make_local_mesh() -> LaneGrid:
    """One lane with the canonical ``(data, tensor)`` names;
    sharding/specs.py accepts the historical "model" name as an alias."""
    return LaneGrid((1, 1), ("data", "tensor"))


def make_data_mesh(dp: int, *, data_axis: str = "data") -> LaneGrid:
    """``dp`` data-parallel lanes for the compressed gradient all-reduce
    around the simulated cuts."""
    if dp < 1:
        raise ValueError(f"dp must be >= 1, got {dp}")
    return LaneGrid((dp,), (data_axis,))


def make_dp_pipeline_mesh(dp: int, stages: int, *, data_axis: str = "data",
                          stage_axis: str = "stage") -> LaneGrid:
    """``(data, stages)``: row r is one replica's pipeline; activations hop
    along a row, the DP gradient ring runs down each column."""
    if dp < 1 or stages < 1:
        raise ValueError(f"dp and stages must be >= 1, got ({dp}, {stages})")
    return LaneGrid((dp, stages), (data_axis, stage_axis))


def make_tensor_mesh(tp: int, *, tensor_axis: str = "tensor") -> LaneGrid:
    """``tp`` ranks of the compressed tensor ring."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    return LaneGrid((tp,), (tensor_axis,))


def make_3d_mesh(dp: int, stages: int, tp: int, *, data_axis: str = "data",
                 stage_axis: str = "stage",
                 tensor_axis: str = "tensor") -> LaneGrid:
    """``(data, stage, tensor)``: all three communication axes.  Axes of
    size 1 are kept, as in the reference."""
    for k, v in (("dp", dp), ("stages", stages), ("tp", tp)):
        if v < 1:
            raise ValueError(f"{k} must be >= 1, got {v}")
    return LaneGrid((dp, stages, tp), (data_axis, stage_axis, tensor_axis))


# Hardware constants of the port's card, an H100 SXM (NVIDIA's data sheet;
# the card this port is measured on reports "H100 80GB HBM3, 700.00 W")
PEAK_FLOPS_BF16 = 989e12        # dense tensor-core flop/s
HBM_BW = 3.35e12                # device-memory bytes/s
NVLINK_BW = 450e9               # bytes/s each way to the other cards
