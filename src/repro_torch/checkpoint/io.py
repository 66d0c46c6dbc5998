"""Checkpoints: trees of tensors <-> the reference's flat npz, both ways.

Schema (``repro/checkpoint/io.py``): one npz, keys are "/"-joined tree
paths (dict keys, list indices, a :class:`FeedbackState`'s slot names:
``stages/0/1/conv1``, ``feedback/boundary/0/fw/resid``), ``__meta__`` a
JSON string with ``step`` and ``extra``; bf16 leaves are stored as uint16
views under ``<key>@bf16``.  A file written by either package restores in
the other, bit for bit.

Two formats share the machinery:

  * params-only: ``save(path, params)``, flat keys ``embed/...``;
  * train-state: ``save_train_state(path, ...)``, one tree ``{"params",
    "opt", "feedback": {"boundary", ["dp"]}}`` holding the model, the
    optimizer moments and every feedback thread (the cuts' fw/bw
    :class:`FeedbackState` s, as a list on the simulated transport or the
    pipeline's stage-stacked dict, and the DP reduce's state), so that a
    resume reproduces the run's trajectory bit for bit.  Files of the
    older ``bstates/...`` + ``dp/...`` layout are migrated on restore, by
    key only.

``restore`` fills the structure of ``like`` from a file: extra keys in
the file are ignored unless ``strict``; missing, shape-mismatched and (if
strict) extra keys raise ONE :class:`CheckpointMismatch` listing them
all.  Each leaf comes back in the file's dtype, whatever ``like``'s, on
the device of ``like``'s leaf.  Arrays are read from the file one at a
time, and written one at a time, so the host never holds a whole state.
"""
from __future__ import annotations

import json
import os
import re
import zipfile
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.convert import tensor_from_numpy
from repro_torch.core.feedback import FeedbackState

_SLOTS = ("resid", "mirror", "agg")


class CheckpointMismatch(ValueError):
    """The checkpoint's keys/shapes do not cover the requested tree."""


def _flatten(tree, prefix=""):
    """Leaves by key, as ``jax.tree_util.tree_flatten_with_path`` names
    them: dict keys sorted, list items by index, a FeedbackState's array
    slots by name."""
    if isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    elif isinstance(tree, list):
        items = enumerate(tree)
    elif isinstance(tree, FeedbackState):
        items = ((s, getattr(tree, s)) for s in _SLOTS)
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
    if isinstance(like, FeedbackState):
        return like.replace(**{s: _unflatten_like(getattr(like, s), flat,
                                                  f"{prefix}{s}/")
                               for s in _SLOTS})
    return flat[prefix[:-1]]


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save(path: str, tree, step: int = 0, extra: dict = None) -> None:
    """``tree`` (nested dicts, lists and FeedbackStates of tensors) in the
    reference's schema; ``.npz`` is added to a path without it, as
    ``np.savez`` does.  Each leaf is copied to the host and written in
    turn."""
    path = _npz_path(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    meta = {"step": step, "extra": extra or {}}
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        def put(key, arr):
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(arr),
                                          allow_pickle=False)
        put("__meta__", json.dumps(meta))
        for key, t in _flatten(tree).items():
            t = t.detach().cpu()
            if t.dtype == torch.bfloat16:
                put(key + "@bf16", t.view(torch.int16).numpy()
                    .view(np.uint16))
            else:
                put(key, t.numpy())


def _open(path: str):
    """``(npz file, {key: reader}, meta)``; a reader loads one array from
    the file as ``(array, is_bf16)``."""
    data = np.load(_npz_path(path), allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))
    flat: Dict[str, Callable] = {}
    for k in data.files:
        if k == "__meta__":
            continue
        bf16 = k.endswith("@bf16")
        flat[k[:-5] if bf16 else k] = (
            lambda k=k, bf16=bf16: (data[k], bf16))
    return data, flat, meta


def _restore_from_flat(path: str, flat, meta, like,
                       strict: bool) -> Tuple[Any, int]:
    leaves_like = _flatten(like)
    missing, mismatched, out = [], [], {}
    for key, leaf in leaves_like.items():
        read = flat.get(key)
        if read is None:
            missing.append(key)
            continue
        arr, bf16 = read()
        if tuple(arr.shape) != tuple(leaf.shape):
            mismatched.append(f"{key}: saved {tuple(arr.shape)} != "
                              f"expected {tuple(leaf.shape)}")
            continue
        out[key] = tensor_from_numpy(arr, leaf.device, bf16=bf16)
        del arr
    extra = sorted(set(flat) - set(leaves_like))
    if missing or mismatched or (strict and extra):
        def fmt(label, items, limit=8):
            if not items:
                return f"  {label}: none"
            shown = ", ".join(items[:limit])
            more = (f" (+{len(items) - limit} more)" if len(items) > limit
                    else "")
            return f"  {label} ({len(items)}): {shown}{more}"

        raise CheckpointMismatch(
            f"checkpoint {path!r} does not match the requested pytree:\n"
            + fmt("missing keys", sorted(missing)) + "\n"
            + fmt("shape mismatches", mismatched) + "\n"
            + fmt("extra keys in file", extra)
            + "\n(params-only vs train-state format? see "
            "checkpoint/io.py docstring)")
    return _unflatten_like(like, out), meta["step"]


def restore(path: str, like, strict: bool = False) -> Tuple[Any, int]:
    """Restore into the structure of ``like``; returns ``(tree, step)``.

    ``like`` may name a SUBSET of the saved keys (how ``restore_params``
    pulls the params out of a train-state file); ``strict=True`` also
    requires it to consume the WHOLE file (a leftover key means the run
    being resumed was configured differently).  Shapes are checked, not
    dtypes: each leaf comes back in the file's dtype."""
    data, flat, meta = _open(path)
    with data:
        return _restore_from_flat(path, flat, meta, like, strict)


# ---------------------------------------------------------------------------
# Train-state format: params + optimizer moments + feedback buffers
# ---------------------------------------------------------------------------

def save_train_state(path: str, params, opt_state, bstates, step: int = 0,
                     extra: dict = None, dp_state=None) -> None:
    """One file covering everything a resume needs: ``feedback/boundary``
    holds the cuts' states (``bstates``), ``feedback/dp`` (dp runs only)
    the data-parallel reduce's state (``transport/collectives.py::
    init_dp_state``); ``extra["format"]`` is ``"train-state"``."""
    extra = dict(extra or {})
    extra["format"] = "train-state"
    feedback = {"boundary": bstates}
    if dp_state is not None:
        feedback["dp"] = dp_state
    save(path, {"params": params, "opt": opt_state, "feedback": feedback},
         step=step, extra=extra)


_LEGACY_BSTATE_RE = re.compile(r"^bstates/(.+?)(?:/(send|recv))?$")


def _migrate_legacy_feedback(flat):
    """The older key layout -> the ``feedback`` schema, key by key:
    boundary buffers under ``bstates/...`` (simulated: one array per
    direction; pipeline: ``{"send", "recv"}``) and the DP reduce state
    under ``dp/...``.  Arrays pass through untouched."""
    out = {}
    for k, v in flat.items():
        if k == "dp" or k.startswith("dp/"):
            out["feedback/" + k] = v
        elif k.startswith("bstates/"):
            m = _LEGACY_BSTATE_RE.match(k)
            leaf = {"send": "resid", "recv": "mirror", None: "resid"}
            out[f"feedback/boundary/{m.group(1)}/{leaf[m.group(2)]}"] = v
        else:
            out[k] = v
    return out


def restore_train_state(path: str, params_like, opt_like, bstates_like,
                        dp_like=None) -> Tuple[Any, ...]:
    """Strict: the file must match the expected state EXACTLY (leftover
    keys mean the checkpointed run was configured differently: more cuts,
    another optimizer, a dp run resumed without its data axis).  A file of
    the older layout is migrated by key, its size-0 leaves, which it
    never stored, made as empty arrays of ``like``'s shape and dtype.

    Returns ``(params, opt, bstates, step)``, or ``(params, opt, bstates,
    dp_state, step)`` when ``dp_like`` is given."""
    like = {"params": params_like, "opt": opt_like,
            "feedback": {"boundary": bstates_like}}
    if dp_like is not None:
        like["feedback"]["dp"] = dp_like
    data, flat, meta = _open(path)
    with data:
        legacy = (not any(k.startswith("feedback/") for k in flat)
                  and any(k == "dp" or k.startswith(("bstates/", "dp/"))
                          for k in flat))
        if legacy:
            flat = _migrate_legacy_feedback(flat)
            for key, leaf in _flatten(like).items():
                if key not in flat and leaf.numel() == 0:
                    z = np.zeros(tuple(leaf.shape),
                                 np.uint16 if leaf.dtype == torch.bfloat16
                                 else str(leaf.dtype).split(".")[-1])
                    flat[key] = (lambda z=z, bf16=leaf.dtype ==
                                 torch.bfloat16: (z, bf16))
        state, step = _restore_from_flat(path, flat, meta, like,
                                         strict=True)
    bstates = state["feedback"]["boundary"]
    if dp_like is not None:
        return (state["params"], state["opt"], bstates,
                state["feedback"]["dp"], step)
    return state["params"], state["opt"], bstates, step


def restore_params(path: str, params_like) -> Tuple[Any, int]:
    """The model params from EITHER format (serving), in the structure of
    ``params_like`` and on its devices, each leaf in the file's dtype.
    Returns ``(params, step)``."""
    data, flat, meta = _open(path)
    with data:
        if any(k == "params" or k.startswith("params/") for k in flat):
            state, step = _restore_from_flat(
                path, flat, meta, {"params": params_like}, strict=False)
            return state["params"], step
        return _restore_from_flat(path, flat, meta, params_like,
                                  strict=False)
