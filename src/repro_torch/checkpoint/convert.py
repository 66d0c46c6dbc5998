"""numpy <-> torch for parameter trees.

The reference params cannot be re-drawn in torch (``jax.random`` is not
``torch.Generator``), so they cross as numpy: ``np.asarray`` of each JAX
leaf, or the arrays of an npz checkpoint.  bfloat16 arrives as numpy's
``bfloat16`` extension dtype or as a uint16 view; both are reinterpreted
bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.feedback import FeedbackState


def tensor_from_numpy(arr, device, bf16: bool = False) -> torch.Tensor:
    """One array -> tensor on ``device``.  ``bf16``: the array holds bf16
    bit patterns (a uint16 view, as the npz schema stores them)."""
    arr = np.array(arr, order="C")        # a writable copy torch may own
    if bf16 or arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(arr).to(device)


def params_from_numpy(tree, device):
    """A tree of numpy arrays -> the same tree of tensors on ``device``.
    Nested dicts (the reference's params via ``np.asarray``) and lists
    map node for node; a feedback state -- any object with ``resid`` /
    ``mirror`` / ``agg`` slots and ``scope`` / ``direction`` / ``mode``,
    such as the reference's ``FeedbackState`` after ``jax.tree.map(
    np.asarray, ...)``, including the DP reduce's ``resid`` / ``agg``
    trees -- becomes the port's :class:`FeedbackState`."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_from_numpy(v, device) for v in tree]
    if all(hasattr(tree, a) for a in ("resid", "mirror", "agg", "mode")):
        return FeedbackState(
            resid=params_from_numpy(tree.resid, device),
            mirror=params_from_numpy(tree.mirror, device),
            agg=params_from_numpy(tree.agg, device), scope=tree.scope,
            direction=tree.direction, mode=tree.mode)
    return tensor_from_numpy(tree, device)
