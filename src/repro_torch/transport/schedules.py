"""Pipeline schedules: who computes which microbatch at which tick.

Port of ``repro/transport/schedules.py``, on Python ints.  A
:class:`Schedule` owns the bookkeeping of the compressed pipeline
(``transport/pipeline.py``): the per-tick plan (which virtual chunk /
microbatch each device computes, injection/emission points, validity of
the fill/drain ticks) plus the analytic cost model (bubble fraction,
in-flight stash, wire cuts per microbatch).

Three schedules ship:

  * ``gpipe``       — the minimum-tick GPipe skew.
  * ``1f1b``        — the same cut structure and microbatch order as GPipe
                      (losses match step for step), with the two mechanics
                      that make ``microbatches >> stages`` practical: the
                      stage body is rematerialized (``torch.utils.
                      checkpoint``) and each hop's payload leaves are
                      FUSED into one contiguous byte buffer.
  * ``interleaved`` — Megatron-style virtual stages: each device holds
                      ``v`` round-robin stage slices (device d owns logical
                      stages d, d+S, ..., d+(v-1)S), every cut is a wire
                      cut, and the fill/drain bubble shrinks from
                      (S-1)/(mb+S-1) to (S-1)/(v*mb+S-1).

The per-tick plan is one closed-form map.  With ``u = t - d`` (the skew
coordinate of device ``d`` at tick ``t``), ``S`` devices and ``v`` virtual
chunks, microbatches advance in groups of ``S``:

    g = u // (S*v)        # microbatch group
    k = (u % (S*v)) // S  # virtual chunk computed this tick
    r = u % S             # position within the group
    j = g*S + r           # microbatch index
    logical stage computed = k*S + d

For ``v == 1`` this degenerates to the GPipe skew ``j = t - d``.  The
sender (device d-1, tick t-1) and the receiver (device d, tick t) share
the same ``u``, hence the same ``(k, j)``: the payload that arrives is the
input of the receiver's current tick.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union


@dataclasses.dataclass(frozen=True)
class TickPlan:
    """Device-local bookkeeping for one tick.

    ``k``/``j`` are the virtual chunk / microbatch this device computes;
    ``valid`` marks the ticks that compute a
    real (microbatch, stage) pair; ``inject`` marks logical stage 0 (input
    comes from the batch, not the wire); ``last`` marks the final logical
    stage (its output is emitted and its gradient comes from the loss).
    """
    k: int
    j: int
    valid: bool
    inject: bool
    last: bool


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A pipeline schedule: per-tick plan + analytic cost model.

    ``virtual_stages`` — stage slices per device (v); params carry
    ``S * v`` logical slices.  ``fused_wire`` — frame each hop's payload
    into one contiguous uint8 buffer.  ``remat_ticks`` — rematerialize the
    stage body so autograd keeps only the boundary tensors.
    """
    name: str = "gpipe"
    virtual_stages: int = 1
    fused_wire: bool = False
    remat_ticks: bool = False

    # -- validation ---------------------------------------------------------

    def validate(self, microbatches: int, num_stages: int) -> None:
        v = self.virtual_stages
        if v < 1:
            raise ValueError(f"virtual_stages must be >= 1, got {v}")
        if v > 1 and microbatches % num_stages:
            raise ValueError(
                "the interleaved schedule advances microbatches in groups "
                f"of the stage count: microbatches={microbatches} must be "
                f"divisible by num_stages={num_stages}")

    # -- per-tick plan ------------------------------------------------------

    def num_ticks(self, microbatches: int, num_stages: int) -> int:
        """Every (microbatch, logical stage) pair computes exactly once,
        plus the S-1 fill skew."""
        return self.virtual_stages * microbatches + num_stages - 1

    def plan(self, t: int, d: int, microbatches: int,
             num_stages: int) -> TickPlan:
        """The plan for device ``d`` at tick ``t``."""
        s, v = num_stages, self.virtual_stages
        u = t - d
        if v == 1:
            k, j = 0, u
        else:
            sv = s * v
            g = u // sv
            w = u - g * sv
            k = w // s
            j = g * s + (w - k * s)
        valid = u >= 0 and 0 <= j < microbatches
        return TickPlan(k=k, j=j, valid=valid, inject=d == 0 and k == 0,
                        last=d == s - 1 and k == v - 1)

    # -- analytic cost model ------------------------------------------------

    def bubble_fraction(self, microbatches: int, num_stages: int) -> float:
        """Idle fraction of the fill/drain skew: (S-1)/(v*mb + S-1)."""
        return (num_stages - 1) / self.num_ticks(microbatches, num_stages)

    def wire_cuts(self, num_stages: int) -> int:
        """Compressed cuts one microbatch crosses, per direction."""
        return self.virtual_stages * num_stages - 1

    def stash_microbatches(self, microbatches: int, num_stages: int) -> int:
        """In-flight activation stash per device of the IDEALIZED schedule
        (microbatches resident between their fw and bw).  GPipe stashes
        the full batch; 1F1B bounds it at S; interleaved at S*v."""
        return microbatches

    def describe(self, microbatches: int, num_stages: int) -> dict:
        return {
            "schedule": self.name,
            "virtual_stages": self.virtual_stages,
            "fused_wire": self.fused_wire,
            "remat_ticks": self.remat_ticks,
            "ticks": self.num_ticks(microbatches, num_stages),
            "bubble_fraction": round(
                self.bubble_fraction(microbatches, num_stages), 4),
            "wire_cuts_per_microbatch": self.wire_cuts(num_stages),
            "idealized_stash_microbatches": self.stash_microbatches(
                microbatches, num_stages),
        }


@dataclasses.dataclass(frozen=True)
class GPipeSchedule(Schedule):
    name: str = "gpipe"

    def validate(self, microbatches: int, num_stages: int) -> None:
        if self.virtual_stages != 1:
            raise ValueError("gpipe runs one stage slice per device; use "
                             "schedule='interleaved' for virtual stages")


@dataclasses.dataclass(frozen=True)
class OneFOneBSchedule(Schedule):
    name: str = "1f1b"
    fused_wire: bool = True
    remat_ticks: bool = True

    def validate(self, microbatches: int, num_stages: int) -> None:
        if self.virtual_stages != 1:
            raise ValueError("1f1b runs one stage slice per device; use "
                             "schedule='interleaved' for virtual stages")

    def stash_microbatches(self, microbatches: int, num_stages: int) -> int:
        return min(microbatches, num_stages)


@dataclasses.dataclass(frozen=True)
class InterleavedSchedule(Schedule):
    name: str = "interleaved"
    virtual_stages: int = 2
    fused_wire: bool = True
    remat_ticks: bool = True

    def stash_microbatches(self, microbatches: int, num_stages: int) -> int:
        return min(microbatches, num_stages) * self.virtual_stages


SCHEDULES = {
    "gpipe": GPipeSchedule,
    "1f1b": OneFOneBSchedule,
    "interleaved": InterleavedSchedule,
}


def get_schedule(name: str, virtual_stages: Optional[int] = None) -> Schedule:
    """Look up a schedule by name, optionally overriding ``virtual_stages``
    (only meaningful for ``interleaved``; the others reject v > 1)."""
    try:
        cls = SCHEDULES[name]
    except KeyError:
        raise ValueError(f"unknown schedule {name!r}; "
                         f"known: {sorted(SCHEDULES)}") from None
    if virtual_stages is None:
        return cls()
    return cls(virtual_stages=virtual_stages)


def as_schedule(schedule: Union[str, Schedule],
                virtual_stages: Optional[int] = None) -> Schedule:
    """Normalize a ``schedule=`` argument (name or instance)."""
    if isinstance(schedule, Schedule):
        if virtual_stages is not None and \
                virtual_stages != schedule.virtual_stages:
            raise ValueError(
                f"virtual_stages={virtual_stages} conflicts with the "
                f"schedule instance's {schedule.virtual_stages}")
        return schedule
    return get_schedule(schedule, virtual_stages)
