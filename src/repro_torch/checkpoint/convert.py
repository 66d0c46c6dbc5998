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


def tensor_from_numpy(arr, device, bf16: bool = False) -> torch.Tensor:
    """One array -> tensor on ``device``.  ``bf16``: the array holds bf16
    bit patterns (a uint16 view, as the npz schema stores them)."""
    arr = np.array(arr, order="C")        # a writable copy torch may own
    if bf16 or arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(arr).to(device)


def params_from_numpy(tree, device):
    """A nested dict of numpy arrays (the reference's params via
    ``np.asarray``) -> the same tree of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)
