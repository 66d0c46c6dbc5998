"""Grid context for in-model sharding constraints.

Port of ``repro/sharding/ctx.py``.  With a grid installed (the dry run),
:func:`constrain` resolves a logical spec as the reference does before its
``with_sharding_constraint``; on one card there is nothing to place, so it
returns ``x`` itself.  The port's model code calls no ``constrain``: the
reference's calls only steer XLA's partitioner, and cross-card placement
is the multi-card slice's work.

Logical axis names:
  "batch"   -> ("pod", "data") (or ("data",) on one pod)
  "model"   -> the tensor-parallel axis
  "expert"  -> expert-parallel axis (mapped onto "data")
  "seq"     -> sequence/cache sharding for batch=1 decode (onto "data")
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

from repro_torch.launch.mesh import LaneGrid

_state = threading.local()


def set_mesh(grid: Optional[LaneGrid], rules: Optional[dict] = None) -> None:
    _state.mesh = grid
    _state.rules = rules or default_rules(grid)


def get_mesh() -> Optional[LaneGrid]:
    return getattr(_state, "mesh", None)


def get_rules() -> dict:
    return getattr(_state, "rules", {})


def default_rules(grid: Optional[LaneGrid]) -> dict:
    """Map logical axes -> grid axes for the production grids."""
    if grid is None:
        return {}
    names = grid.axis_names
    rules = {"batch": ("pod", "data") if "pod" in names else ("data",)}
    # the canonical tensor axis is "tensor"; the legacy "model" axis name
    # keeps resolving as an alias
    for tp_axis in ("tensor", "model"):
        if tp_axis in names:
            rules["model"] = (tp_axis,)
            break
    if "data" in names:
        rules["expert"] = ("data",)
        rules["seq"] = ("data",)
    return rules


class use_mesh:
    """``with use_mesh(grid):`` installs a grid and its rules."""

    def __init__(self, grid: Optional[LaneGrid],
                 rules: Optional[dict] = None):
        self.mesh, self.rules = grid, rules

    def __enter__(self):
        self.prev = (get_mesh(), get_rules())
        set_mesh(self.mesh, self.rules)
        return self.mesh

    def __exit__(self, *exc):
        _state.mesh, _state.rules = self.prev
        return False


def _resolve(axis) -> Optional[Tuple[str, ...]]:
    if axis is None:
        return None
    rules = get_rules()
    if isinstance(axis, str):
        return rules.get(axis)
    out = []
    for a in axis:
        got = rules.get(a)
        if got:
            out.extend(got)
    return tuple(out) or None


def constrain_spec(shape, *logical_axes) -> tuple:
    """The spec :func:`constrain` resolves for a ``shape`` under the
    installed grid: one entry per dim, ``None`` or a tuple of grid axes.
    Earlier dims win: a grid axis shards at most one dim, and a logical
    axis whose axes do not divide its dim drops out (batch=1 decode
    cannot shard over "batch", so "seq" takes "data")."""
    grid = get_mesh()
    sizes = grid.sizes
    spec, used = [], set()
    for dim, logical in zip(shape, logical_axes):
        resolved = _resolve(logical)
        if resolved is None:
            spec.append(None)
            continue
        resolved = tuple(a for a in resolved if a not in used)
        size = 1
        for a in resolved:
            size *= sizes[a]
        if resolved and dim % size == 0 and dim >= size:
            spec.append(resolved)
            used.update(resolved)
        else:
            spec.append(None)
    return tuple(spec)


def constrain(x, *logical_axes):
    """A sharding constraint by logical axis names (None = replicated).
    Without a grid, ``x``; with one, the spec is resolved (and its length
    checked against ``x.ndim``) and ``x`` returned unchanged: every lane
    is on the one card."""
    if get_mesh() is None:
        return x
    assert len(logical_axes) == x.ndim, (logical_axes, x.shape)
    constrain_spec(x.shape, *logical_axes)
    return x
