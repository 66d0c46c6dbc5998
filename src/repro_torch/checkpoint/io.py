"""The reference's npz checkpoints: read them into torch params, and
write params-only files.

Schema (``repro/checkpoint/io.py``): one npz, keys are "/"-joined tree
paths (dict keys, list indices: ``stages/0/1/conv1``), ``__meta__`` a JSON
string with ``step`` and ``extra``; bf16 leaves are stored as uint16 views
under ``<key>@bf16``.  Params-only files hold ``embed/...``; train-state
files hold them under ``params/``.  Writing train state is not ported yet.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.convert import tensor_from_numpy


class CheckpointMismatch(ValueError):
    """The checkpoint's keys/shapes do not cover the requested tree."""


def load_flat(path: str, device) -> Tuple[Dict[str, torch.Tensor], dict]:
    """All arrays of an npz checkpoint as tensors, by key, and its meta."""
    with np.load(path if path.endswith(".npz") else path + ".npz",
                 allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        flat = {}
        for k in data.files:
            if k == "__meta__":
                continue
            if k.endswith("@bf16"):
                flat[k[:-5]] = tensor_from_numpy(data[k], device, bf16=True)
            else:
                flat[k] = tensor_from_numpy(data[k], device)
    return flat, meta


def _flatten(tree, prefix=""):
    """Leaves by key, in ``jax.tree.leaves``' order (dict keys sorted,
    list items by index)."""
    if isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}/"))
    return out


def _unflatten_like(like, flat, prefix=""):
    if isinstance(like, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}{k}/")
                for k, v in like.items()}
    if isinstance(like, list):
        return [_unflatten_like(v, flat, f"{prefix}{i}/")
                for i, v in enumerate(like)]
    return flat[prefix[:-1]]


def save(path: str, tree, step: int = 0, extra: dict = None) -> None:
    """A params-only checkpoint of ``tree`` (nested dicts and lists of
    tensors) in the reference's schema; ``np.savez`` adds ``.npz`` to a
    path without it."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {}
    for key, t in _flatten(tree).items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            flat[key + "@bf16"] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            flat[key] = t.numpy()
    meta = {"step": step, "extra": extra or {}}
    np.savez(path, __meta__=json.dumps(meta), **flat)


def restore_params(path: str, params_like) -> Tuple[dict, int]:
    """Params from either format, in the structure and shapes of
    ``params_like`` and on its devices.  As the reference's ``restore``,
    only shapes are checked: each leaf comes back in the dtype the file
    holds, whatever ``params_like``'s dtype.  Returns ``(params, step)``;
    raises :class:`CheckpointMismatch` listing every missing or
    mismatched key."""
    leaves = _flatten(params_like)
    dev = next(iter(leaves.values())).device
    flat, meta = load_flat(path, dev)
    if any(k.startswith("params/") for k in flat):
        flat = {k[len("params/"):]: v for k, v in flat.items()
                if k.startswith("params/")}
    missing = sorted(k for k in leaves if k not in flat)
    bad = sorted(f"{k}: saved {tuple(flat[k].shape)} != {tuple(v.shape)}"
                 for k, v in leaves.items()
                 if k in flat and flat[k].shape != v.shape)
    if missing or bad:
        raise CheckpointMismatch(
            f"checkpoint {path!r} does not match the params: missing "
            f"{missing or 'none'}; mismatched {bad or 'none'}")
    out = {k: flat[k].to(v.device) for k, v in leaves.items()}
    return _unflatten_like(params_like, out), meta["step"]
