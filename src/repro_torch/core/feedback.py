"""Error-compensation state and message functions (paper Sec. 2.4, 2.5).

Port of ``repro/core/feedback.py`` for the stage boundary: the simulated
cut (``core/boundary.py``) and the real pipeline
(``transport/pipeline.py``).  Each message maps ``(compressor, x,
buffer) -> (message, new_buffer)``; ``message`` is what crosses the
wire:

  EF       (Seide et al.):     m = C(x + e);           e' = x + e - m
  EF21     (Richtarik et al.): m = g + C(x - g);       g' = m
  EF-mixed (this paper):       m = C_{K/2}(x) + C_{K/2}(e);  e' = x + e - m
  AQ-SGD   (Wang et al.):      per-example EF21 on activations only:
                               m_i = b_i + C(x_i - b_i); b_i' = m_i

EF-mixed uses the exact per-example TopK (``topk_compress``), as the
reference does on every backend, so it never reaches the block TopK
kernel.  AQ-SGD's buffer is ``(num_samples, *feat)``, gathered and
written back by example id.

:class:`FeedbackState` holds the sender-side ``resid`` buffer, the
receiver-side ``mirror`` that the real pipeline keeps for the
delta-coded modes (EF21, AQ-SGD: the receiver rebuilds the message from
its own copy of the sender's buffer) and the ``agg`` slot of the
data-parallel gradient reduce (EF21's replicated aggregate).  The
simulated boundary collapses both ends into ``resid`` and keeps
``mirror`` and ``agg`` size 0.  At scope ``"dp"`` (``transport/
collectives.py``) ``resid`` and ``agg`` are trees (nested dicts) of
tensors mirroring the parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.core.compressors import Compressor, topk_compress


def ef_message(comp: Compressor, x: torch.Tensor, e: torch.Tensor):
    xe = x + e
    m = comp(xe)
    return m, xe - m


def ef21_message(comp: Compressor, x: torch.Tensor, g: torch.Tensor):
    m = g + comp(x - g)
    return m, m


def efmixed_message(comp: Compressor, x: torch.Tensor, e: torch.Tensor):
    if comp.kind != "topk":
        raise ValueError("EF-mixed is defined for TopK compression")
    half = comp.k_frac / 2.0
    m = topk_compress(x, half) + topk_compress(e, half)
    return m, (x + e) - m


def aqsgd_message(comp: Compressor, x: torch.Tensor, buf: torch.Tensor,
                  ids: torch.Tensor):
    """Per-example EF21.  ``buf``: (num_samples, *feat); ``ids``: (B,).

    Writes the new rows into ``buf`` IN PLACE (``index_copy_``; the
    reference returns an updated copy) and returns it as the new buffer.
    With repeated ids the surviving row is unspecified, as for the
    reference's ``buf.at[ids].set``: give each example of a batch its own
    id."""
    ids = ids.long()
    b = buf[ids]
    m = b + comp(x - b)
    return m, buf.index_copy_(0, ids, m.to(buf.dtype))


@dataclasses.dataclass(frozen=True)
class FeedbackMode:
    """One registry entry.  ``delta_coded``: the wire message is a
    compressed DELTA against the buffer (m = buf + C(x - buf)), so a real
    wire's receiver keeps a mirror of the sender's buffer.
    ``per_example``: the buffer is ``(num_samples, *feat)``, indexed by
    example id.  ``scopes``: where the mode is valid."""
    name: str
    message: Callable
    delta_coded: bool = False
    per_example: bool = False
    scopes: Tuple[str, ...] = ("boundary",)


def _none_message(comp, x, buf, ids=None):
    return comp(x), buf


FEEDBACK_REGISTRY = {
    "none": FeedbackMode("none", _none_message,
                         scopes=("boundary", "dp", "tp")),
    "ef": FeedbackMode(
        "ef", lambda comp, x, buf, ids=None: ef_message(comp, x, buf),
        scopes=("boundary", "dp", "tp")),
    "ef21": FeedbackMode(
        "ef21", lambda comp, x, buf, ids=None: ef21_message(comp, x, buf),
        delta_coded=True, scopes=("boundary", "dp", "tp")),
    "efmixed": FeedbackMode(
        "efmixed",
        lambda comp, x, buf, ids=None: efmixed_message(comp, x, buf)),
    "aqsgd": FeedbackMode(
        "aqsgd",
        lambda comp, x, buf, ids=None: aqsgd_message(comp, x, buf, ids),
        delta_coded=True, per_example=True),
}


def get_mode(mode: str) -> FeedbackMode:
    try:
        return FEEDBACK_REGISTRY[mode]
    except KeyError:
        raise ValueError(f"unknown feedback mode {mode!r}; known: "
                         f"{sorted(FEEDBACK_REGISTRY)}") from None


def needs_recv_mirror(mode: str) -> bool:
    """True when a real (packed-wire) transport of this mode must keep a
    receiver-side replica of the compensation buffer."""
    return get_mode(mode).delta_coded


def feedback_message(mode: str, comp: Compressor, x: torch.Tensor, buf,
                     ids=None):
    """Dispatch.  ``mode='none'`` ignores the buffer and returns it."""
    return get_mode(mode).message(comp, x, buf, ids)


def _tree_map(f, tree):
    """``f`` over the tensors of a nested dict (or over one tensor)."""
    if isinstance(tree, dict):
        return {k: _tree_map(f, v) for k, v in tree.items()}
    return f(tree)


@dataclasses.dataclass(frozen=True)
class FeedbackState:
    """One compensation thread's state: the sender-side buffer ``resid``
    (EF's error e, EF21's model g, AQ-SGD's per-example rows, the DP
    reduce's per-replica residuals; size 0 when the direction has no
    feedback), the receiver-side ``mirror`` of the real pipeline's
    delta-coded modes (size 0 otherwise, and always on the simulated
    boundary), ``agg``, the DP EF21 reduce's replicated aggregate
    G = sum_r w_r (size 0 otherwise), and its ``(scope, direction,
    mode)``.  At scope ``"dp"`` the slots are trees of tensors."""
    resid: Any
    mirror: Any
    agg: Any
    scope: str = "boundary"
    direction: str = "fw"
    mode: str = "none"

    def __post_init__(self):
        spec = get_mode(self.mode)
        if self.scope not in spec.scopes:
            raise ValueError(
                f"feedback mode {self.mode!r} is not valid at scope "
                f"{self.scope!r} (valid scopes: {spec.scopes})")

    def replace(self, **kw) -> "FeedbackState":
        return dataclasses.replace(self, **kw)

    def map(self, f) -> "FeedbackState":
        """Apply ``f`` to every tensor of every slot (metadata kept)."""
        return self.replace(resid=_tree_map(f, self.resid),
                            mirror=_tree_map(f, self.mirror),
                            agg=_tree_map(f, self.agg))


def init_buffer(mode: str, feat_shape, dtype=torch.float32,
                num_samples: int = 0, batch: int = 0, device=None):
    """Initial buffer for one boundary direction: ``(batch, *feat)`` for
    ef/ef21/efmixed, ``(num_samples, *feat)`` for aqsgd, size 0 for none."""
    spec = get_mode(mode)
    if mode == "none":
        return torch.zeros((0,), dtype=dtype, device=device)
    rows = num_samples if spec.per_example else batch
    if rows <= 0:
        raise ValueError(f"{mode} feedback needs "
                         f"{'num_samples' if spec.per_example else 'batch'}"
                         " > 0")
    return torch.zeros((rows, *feat_shape), dtype=dtype, device=device)


def init_feedback(mode: str, feat_shape, *, scope: str = "boundary",
                  direction: str = "fw", dtype=torch.float32,
                  num_samples: int = 0, batch: int = 0,
                  device=None) -> FeedbackState:
    """A fresh :class:`FeedbackState` for one boundary direction (the
    simulated transport's view: ``mirror`` and ``agg`` size 0)."""
    return FeedbackState(
        resid=init_buffer(mode, feat_shape, dtype=dtype,
                          num_samples=num_samples, batch=batch,
                          device=device),
        mirror=torch.zeros((0,), dtype=dtype, device=device),
        agg=torch.zeros((0,), dtype=dtype, device=device),
        scope=scope, direction=direction, mode=mode)


# ---------------------------------------------------------------------------
# Buffer row addressing (the pipeline's per-microbatch slices)
# ---------------------------------------------------------------------------

def gather_rows(buf, k, slot, ids, mode: str, v: int = 1):
    """One microbatch's slice of a device's feedback buffer (size-0 passes
    through).  ``k`` selects the virtual chunk when ``v > 1``; the row is
    ``ids`` for per-example modes, the microbatch ``slot`` otherwise.  An
    int slot gives a view, an id tensor a copy."""
    if mode == "none":
        return buf
    row = ids.long() if get_mode(mode).per_example else slot
    return buf[row] if v == 1 else buf[k, row]


def scatter_rows(buf, k, slot, ids, mode: str, v: int, new_slice):
    """Write one microbatch's slice back (the inverse of
    :func:`gather_rows`), IN PLACE; returns ``buf``.  The reference
    returns an updated copy and takes a validity mask for its fill/drain
    ticks; the port's pipeline computes valid ticks only."""
    if mode == "none":
        return buf
    upd = new_slice.to(buf.dtype)
    row = ids.long() if get_mode(mode).per_example else slot
    if v == 1:
        buf[row] = upd
    else:
        buf[k, row] = upd
    return buf


def shard_ids(ids, replica, num_samples: int, dp: int):
    """Translate global example ids into a replica's id-shard rows.

    AQ-SGD + DP shards the ``(num_samples, *feat)`` buffer by example id
    over the data axis: replica ``r`` owns rows
    ``[r * num_samples/dp, (r+1) * num_samples/dp)`` and gathers/scatters
    with LOCAL row indices, so the per-example compensation never leaves
    the replica.  The data stream must route example ``i`` to replica
    ``i // (num_samples/dp)`` (``launch/train.synthetic_stream(dp=)``'s
    contiguous id blocks do)."""
    if num_samples % dp:
        raise ValueError(
            f"aqsgd + dp shards the per-example buffer by id: num_samples "
            f"{num_samples} must be divisible by dp {dp}")
    return ids - replica * (num_samples // dp)
