"""Compression-quality metrics: the paper's asymmetry as a live signal.

Port of ``repro/obs/quality.py``.  The paper's central findings are
distortion findings — activations tolerate less compression than
gradients (Tables 1-3), AQ-SGD's per-example buffers shrink the
effective error over training (Sec. 2.5).  This tap samples them LIVE
every N steps instead of only at end-of-run loss curves:

  * per-boundary RELATIVE compression error — the codec roundtrip
    ``||x - C(x)|| / ||x||`` of each boundary's fw/bw compressor through
    ``Compressor.__call__``: on a CUDA tensor the hand-written
    ``quant_dequant`` / ``topk_block`` kernels, on a CPU tensor their
    plain versions (the function the reference computes on its
    accelerator);
  * feedback-buffer norms — L2 norms of every EF/EF21/AQ-SGD residual
    leaf in the training state, keyed by its path in the reference's
    ``jax.tree_util.keystr`` spelling (``"[0]['fw'].resid"``).

Everything here costs device work, so it only runs when explicitly
sampled (``QualityTap`` gates on the step counter AND on tracing being
enabled); a disabled tracer short-circuits before any tensor op.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.policy import CompressionPolicy
from repro_torch.device import resolve_device
from repro_torch.obs import trace


def _norm(t: torch.Tensor) -> torch.Tensor:
    """The L2 norm of a float32 tensor, its squares summed in float64:
    PyTorch's float32 norm on the CPU sums in an order that drifts by
    1e-5 on a million elements, where the reference's XLA sum does not."""
    return torch.linalg.vector_norm(t.reshape(-1), dtype=torch.float64)


def relative_error(x: torch.Tensor, compressor) -> float:
    """``||x - C(x)||_2 / ||x||_2`` of the float32 difference, C through
    ``Compressor.__call__``."""
    xf = x.to(torch.float32)
    err = _norm(xf - compressor(x).to(torch.float32))
    return float(err / torch.clamp(_norm(xf), min=1e-12))


def boundary_quality(policy: CompressionPolicy, x: torch.Tensor
                     ) -> List[dict]:
    """Per-boundary fw/bw relative compression error on sample tensor
    ``x`` ((batch, *feat); the transformer's uniform boundary shape —
    heterogeneous stacks call per boundary with each cut's shape)."""
    rows = []
    for i in range(policy.num_boundaries):
        bp = policy.at(i)
        rows.append({
            "boundary": i, "fw_codec": bp.fw.name, "bw_codec": bp.bw.name,
            "fw_rel_err": relative_error(x, bp.fw),
            "bw_rel_err": relative_error(x, bp.bw),
        })
    return rows


def _keyed_leaves(tree, path: str = "") -> Iterator[Tuple[str, object]]:
    """(path, leaf) of a state tree in ``jax.tree_util`` flatten order,
    the path spelled as ``keystr``: ``[i]`` for a list or tuple entry,
    ``['k']`` for a dict key (keys sorted), ``.name`` for a dataclass
    field."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _keyed_leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _keyed_leaves(v, f"{path}[{i}]")
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _keyed_leaves(getattr(tree, f.name),
                                     f"{path}.{f.name}")
    elif tree is not None:
        yield path, tree


def feedback_norms(state) -> dict:
    """L2 norm of every float leaf in a feedback-state tree (lists, dicts,
    ``FeedbackState``), keyed by its path; empty leaves, integer leaves
    and non-tensor fields (a state's mode and scope) are skipped."""
    out = {}
    for path, leaf in _keyed_leaves(state):
        if not isinstance(leaf, torch.Tensor) or leaf.numel() == 0 \
                or not leaf.is_floating_point():
            continue
        out[path.strip(".") or "leaf"] = float(_norm(leaf.to(torch.float32)))
    return out


class QualityTap:
    """Every-N-steps sampler wiring the metrics into the tracer.

    ``sample_shape``: the boundary tensor shape ((batch, *feat)) the
    roundtrip error is measured on; the sample is a fixed seeded normal
    (the codec's distortion on a reference distribution), so the series
    isolates POLICY changes — a codec flip between epochs moves the
    line, batch noise does not.

    One deviation from the reference: its sample is
    ``jax.random.normal(PRNGKey(seed))``, which PyTorch cannot draw.
    Here it is ``numpy.random.RandomState(seed).standard_normal`` as
    float32, cast to ``dtype`` on ``device`` (``cuda`` unless given), so
    that the card, the CPU and the reference (fed the same array in the
    tests) see one sample.
    """

    def __init__(self, sample_shape, *, every: int = 50,
                 dtype=torch.bfloat16, seed: int = 0, device=None):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.every = every
        x = np.random.RandomState(seed).standard_normal(
            tuple(sample_shape)).astype(np.float32)
        self._x = torch.from_numpy(x).to(resolve_device(device)).to(dtype)

    def maybe_sample(self, step: int, policy: CompressionPolicy,
                     bstates=None) -> Optional[List[dict]]:
        """Emit quality counters when tracing is on and ``step`` is on
        the sampling grid; returns the rows it emitted (None when
        skipped — the disabled path does no device work)."""
        tr = trace.get_tracer()
        if tr is None or step % self.every != 0:
            return None
        rows = boundary_quality(policy, self._x)
        for r in rows:
            tr.counter(f"quality.boundary{r['boundary']}", cat="quality",
                       fw_rel_err=round(r["fw_rel_err"], 6),
                       bw_rel_err=round(r["bw_rel_err"], 6))
            tr.instant(f"quality.codec.boundary{r['boundary']}",
                       cat="quality", step=step, fw_codec=r["fw_codec"],
                       bw_codec=r["bw_codec"])
        if bstates is not None:
            norms = feedback_norms(bstates)
            if norms:
                tr.counter("quality.feedback_norms", cat="quality",
                           **{k: round(v, 6) for k, v in norms.items()})
        return rows
