"""Parameter / batch / cache sharding rules for the production grids.

Port of ``repro/sharding/specs.py``, on the lane grids of
``launch/mesh.py``.  A spec is a tuple with one entry per dim, each
``None`` (replicated) or a tuple of axis names: a ``PartitionSpec``
without JAX.  Strategy as in the reference: DP over ("pod", "data") for
the batch, TP over the tensor axis for heads / d_ff / vocab, FSDP weight
sharding over "data", expert-parallel over "data" for MoE experts.  Rules
go by name and shape and degrade per dim to replication when a dim is not
divisible by its axes.  The tensor axis is "tensor", with the historical
"model" name accepted as an alias; a rule naming either resolves to
whichever the grid has, and to replication when it has neither.

The rules feed the dry run (``launch/dryrun.py``): :func:`device_bytes`
is the bytes one lane holds of a tree under its specs.  On one card
nothing is placed by them.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch

from repro_torch.core.parallel import AXIS_ALIASES
from repro_torch.launch.mesh import LaneGrid

Spec = Tuple[Optional[Tuple[str, ...]], ...]


def tree_paths(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """``(path, leaf)`` of every tensor of a tree of dicts, lists and
    tuples; a path joins the keys and indices with "/" (the reference's
    ``_path_str``)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from tree_paths(v, f"{prefix}/{k}" if prefix else str(k))


def _tree_map_paths(fn, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _tree_map_paths(fn, v, f"{prefix}/{k}" if prefix
                                   else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map_paths(fn, v, f"{prefix}/{i}" if prefix
                                          else str(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def tensor_axis(grid: LaneGrid) -> Optional[str]:
    """The grid's tensor-parallel axis name ("tensor", or the legacy
    "model" alias), or None when the grid has no tensor axis."""
    for name in ("tensor", "model"):
        if name in grid.axis_names:
            return name
    return None


def _resolve_names(grid: LaneGrid, names) -> tuple:
    """Map logical axis names (+ aliases) onto the grid's axes; names the
    grid does not carry drop out (that dim replicates over them)."""
    out = []
    for n in (names if isinstance(names, tuple) else (names,)):
        if AXIS_ALIASES.get(n, n) == "tensor":
            n = tensor_axis(grid)
        if n is not None and n in grid.axis_names and n not in out:
            out.append(n)
    return tuple(out)


def _axis_size(grid: LaneGrid, names) -> int:
    s, sizes = 1, grid.sizes
    for n in (names if isinstance(names, tuple) else (names,)):
        s *= sizes[n]
    return s


def batch_axes(grid: LaneGrid):
    return ("pod", "data") if "pod" in grid.axis_names else ("data",)


def _fit(dim: int, grid: LaneGrid, names) -> Optional[tuple]:
    if names is None:
        return None
    names = _resolve_names(grid, names)
    if not names:
        return None
    return names if dim % _axis_size(grid, names) == 0 else None


def _is_out(path: str) -> bool:
    """Matrices whose first trailing dim is the tensor-sharded contraction
    (outputs of TP regions)."""
    if path.endswith("cm/wv"):
        return True
    name = path.rsplit("/", 1)[-1]
    return name in ("wo", "out_proj", "lora_B", "w_lora_B")


def param_spec(path: str, shape, grid: LaneGrid) -> Spec:
    nd = len(shape)
    if nd <= 1:
        return (None,) * nd
    # embeddings / heads: (V, d) -> vocab over model, d FSDP over data
    leaf = path.rsplit("/", 1)[-1]
    if leaf in ("embed", "lm_head", "dec_pos"):
        return (_fit(shape[0], grid, "model"), None)
    if leaf == "router":
        return (*([None] * (nd - 2)), _fit(shape[-2], grid, "model"), None)
    if "/experts/" in path and nd >= 3:
        # (..., E, in, out): experts over data (EP) + TP on in/out
        lead = [None] * (nd - 3)
        e = _fit(shape[-3], grid, "data")
        if _is_out(path):
            return (*lead, e, _fit(shape[-2], grid, "model"), None)
        return (*lead, e, None, _fit(shape[-1], grid, "model"))
    # generic 2D-trailing matrices (+ leading group dims)
    lead = [None] * (nd - 2)
    if _is_out(path):
        return (*lead, _fit(shape[-2], grid, "model"),
                _fit(shape[-1], grid, "data"))
    return (*lead, _fit(shape[-2], grid, "data"),
            _fit(shape[-1], grid, "model"))


def param_shardings(grid: LaneGrid, params_tree):
    """The spec tree of a params (or meta) tree."""
    return _tree_map_paths(lambda p, l: param_spec(p, l.shape, grid),
                           params_tree)


def opt_state_shardings(grid: LaneGrid, opt_tree):
    """Moments mirror params; the scalar step is replicated."""
    def spec(path, leaf):
        if path == "step" or leaf.ndim == 0:
            return (None,) * leaf.ndim
        # strip the leading "mu/" / "nu/" container name
        sub = path.split("/", 1)[1] if "/" in path else path
        return param_spec(sub, leaf.shape, grid)
    return _tree_map_paths(spec, opt_tree)


def batch_spec(shape, grid: LaneGrid) -> Spec:
    """(B, ...) data inputs: batch over ("pod", "data") when divisible."""
    b = _fit(shape[0], grid, batch_axes(grid))
    return (b, *([None] * (len(shape) - 1)))


def batch_shardings(grid: LaneGrid, tree):
    return _tree_map_paths(lambda p, l: batch_spec(l.shape, grid), tree)


def cache_spec(path: str, shape, grid: LaneGrid, batch_dim: int = 1) -> Spec:
    """Decode-cache leaves.  Attention k/v: (G, B, C, KV, hd); recurrent
    state (G, B, H, K, V); shift states (G, B, d).

    Preference order: batch over DP axes; KV-heads over model; if KV does
    not divide, the cache SEQ dim takes the model axis (flash-decode
    style); with batch=1 (long_500k) the seq dim also takes the data
    axis."""
    nd = len(shape)
    leaf = path.rsplit("/", 1)[-1]
    bspec = _fit(shape[batch_dim], grid, batch_axes(grid))
    lead = [None] * batch_dim
    if leaf in ("k", "v") and nd == batch_dim + 4:
        _, c, kv, _ = shape[batch_dim:]
        kvspec = _fit(kv, grid, "model")
        seq_axes = []
        if bspec is None:
            seq_axes.append("data")
            if "pod" in grid.axis_names:
                seq_axes.insert(0, "pod")
        if kvspec is None:
            seq_axes.append("model")
        seqspec = _fit(c, grid, tuple(seq_axes)) if seq_axes else None
        return (*lead, bspec, seqspec, kvspec, None)
    if leaf in ("S", "ssm") and nd == batch_dim + 4:     # rwkv / mamba state
        return (*lead, bspec, _fit(shape[batch_dim + 1], grid, "model"),
                None, None)
    return (*lead, bspec, *([None] * (nd - batch_dim - 1)))


def cache_shardings(grid: LaneGrid, cache_tree, batch_dim: int = 1):
    return _tree_map_paths(
        lambda p, l: cache_spec(p, l.shape, grid, batch_dim), cache_tree)


def replicated(grid: LaneGrid, tree):
    return _tree_map_paths(lambda p, l: (None,) * l.ndim, tree)


def shard_shape(shape, spec: Spec, grid: LaneGrid) -> Tuple[int, ...]:
    """The shape one lane holds of a ``shape`` leaf under ``spec``."""
    return tuple(d if names is None else d // _axis_size(grid, names)
                 for d, names in zip(shape, spec))


def device_bytes(grid: LaneGrid, tree, specs) -> int:
    """Bytes one lane holds of ``tree`` under ``specs``, the spec tree of
    the same structure: the sum of its leaves' shard sizes.  Every rule
    above shards a dim only by axes that divide it, so every lane holds
    the same bytes."""
    if isinstance(tree, dict):
        return sum(device_bytes(grid, v, specs[k]) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(device_bytes(grid, v, specs[i])
                   for i, v in enumerate(tree))
    n = 1
    for d in shard_shape(tree.shape, specs, grid):
        n *= d
    return n * tree.element_size()
