"""Shared model building blocks: norms, MLP, RoPE, sinusoidal positions,
softcap, initializers.

Port of ``repro/models/common.py``.  Params are nested dicts of tensors;
bf16 weights and activations, fp32 norm statistics and RoPE angles.
Initializers draw from an explicit ``torch.Generator`` on the generator's
device; ``lead`` prepends stacked dims (the layer-group dim).  Given
:data:`SHAPE_ONLY` in the generator's place they run the same code on the
``meta`` device: every leaf has its shape and dtype and no storage, and
nothing is drawn (the dry run's parameter tree).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

DTYPE = torch.bfloat16


class ShapeOnly:
    """Stands in for an init's ``torch.Generator``: the init builds its
    tree on the ``meta`` device and draws nothing, so one code path lays
    out both the real tree and the shape-only one."""
    device = torch.device("meta")


SHAPE_ONLY = ShapeOnly()


def draws(gen):
    """The generator a draw takes: none for :data:`SHAPE_ONLY` (a meta
    tensor has no values to draw)."""
    return None if isinstance(gen, ShapeOnly) else gen


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype=DTYPE, lead=()) -> torch.Tensor:
    """Truncated-normal fan-in init, ``(*lead, in, out)``.  The f32 draw is
    scaled in place: one f32 temporary of the leaf, not two."""
    t = torch.empty((*lead, in_dim, out_dim), dtype=torch.float32,
                    device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                generator=draws(gen))
    return t.div_(math.sqrt(in_dim)).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype=DTYPE) -> torch.Tensor:
    t = torch.randn((vocab, dim), generator=draws(gen), dtype=torch.float32,
                    device=gen.device)
    return t.mul_(0.02).to(dtype)


def norm_init(d: int, kind: str = "rmsnorm", device=None, lead=()):
    p = {"scale": torch.ones((*lead, d), dtype=torch.float32, device=device)}
    if kind != "rmsnorm":
        p["bias"] = torch.zeros((*lead, d), dtype=torch.float32, device=device)
    return p


def norm_apply(params, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * params["scale"]
    else:
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) * params["scale"] \
            + params["bias"]
    return y.to(x.dtype)


def mlp_init(gen: torch.Generator, d: int, ff: int, kind: str = "swiglu",
             dtype=DTYPE, lead=()):
    p = {"wi": dense_init(gen, d, ff, dtype, lead)}
    if kind == "swiglu":
        p["wg"] = dense_init(gen, d, ff, dtype, lead)
    p["wo"] = dense_init(gen, ff, d, dtype, lead)
    return p


def mlp_apply(params, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    if kind == "swiglu":
        h = F.silu(x @ params["wg"]) * (x @ params["wi"])
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ params["wi"], approximate="tanh")
    return h @ params["wo"]


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs      # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                        # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(seq: int, d: int, device=None) -> torch.Tensor:
    """(seq, d) float32 sinusoidal positions (the whisper encoder's): sin
    on the even columns, cos on the odd ones."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros((seq, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """``tanh(x / cap) * cap`` (gemma2's logit softcap); ``None``: x.
    A division, as the reference writes it, not a product by 1/cap."""
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap
