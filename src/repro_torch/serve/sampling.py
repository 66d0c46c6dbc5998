"""Token sampling for the serve engines.

Port of ``repro/serve/sampling.py``.  One frozen :class:`SamplingConfig`
per engine, and PER-REQUEST random streams.

The reference keys every request with a threefry chain
(``jax.random.split`` / ``categorical``).  The port does not reproduce
that stream, as it does not reproduce ``jax.random`` weight inits; it
keeps the same contract with its own generator:

  * :func:`request_key` gives the request its own ``torch.Generator`` on
    the engine's device, seeded with the request's seed;
  * :func:`sample_tokens` casts the logits to float32.  Greedy
    (``temperature == 0``) is ``argmax``, the first index on ties, and
    consumes no randomness;
  * otherwise it applies :func:`_filter_logits` to ``logits / T`` and
    draws each row by Gumbel-max with THAT ROW's generator: one
    ``torch.rand`` of V uniforms, ``argmax(logits - log(-log(u)))``.

A slot's stream is then a pure function of (seed, its logits):
independent of its batch neighbours and of the slot it lands in, which
is what keeps sampled continuous-batching output identical to serving
the request alone.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """``temperature == 0`` => greedy argmax (top_k/top_p ignored).

    ``top_k > 0``  : keep only the k highest-probability tokens (and any
                     tied with the k-th).
    ``top_p < 1``  : nucleus — keep the smallest probability mass >= top_p.
    Filters compose (top-k first, then top-p), as in standard samplers.
    """
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0: {self.temperature}")
        if not 0 < self.top_p <= 1:
            raise ValueError(f"top_p must be in (0, 1]: {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0: {self.top_k}")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0

    @property
    def name(self) -> str:
        if self.greedy:
            return "greedy"
        parts = [f"t={self.temperature:g}"]
        if self.top_k:
            parts.append(f"k={self.top_k}")
        if self.top_p < 1:
            parts.append(f"p={self.top_p:g}")
        return ",".join(parts)


GREEDY = SamplingConfig()


def request_key(seed: int, device) -> torch.Generator:
    """The request's own generator on ``device``, seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(seed)


def _filter_logits(logits: torch.Tensor, cfg: SamplingConfig) -> torch.Tensor:
    """Mask logits outside the top-k / nucleus to -inf.  logits: (B, V)."""
    v = logits.shape[-1]
    neg = torch.tensor(-torch.inf, dtype=logits.dtype, device=logits.device)
    if cfg.top_k and cfg.top_k < v:
        kth = torch.topk(logits, cfg.top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits >= kth, logits, neg)
    if cfg.top_p < 1.0:
        sorted_ = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep every token up to and including the one crossing top_p
        keep_sorted = cum - probs < cfg.top_p
        cutoff = torch.where(keep_sorted, sorted_,
                             torch.full_like(sorted_, torch.inf)
                             ).amin(dim=-1, keepdim=True)
        logits = torch.where(logits >= cutoff, logits, neg)
    return logits


def sample_tokens(logits: torch.Tensor,
                  gens: Sequence[Optional[torch.Generator]],
                  cfg: SamplingConfig) -> torch.Tensor:
    """Next token per row.  logits: (B, V); ``gens``: one generator a row
    (:func:`request_key`).  Returns (B,) int64 on the logits' device.

    Greedy never touches a generator, so a request replayed greedy and
    sampled stays reproducible.  A row whose generator is None (an idle
    slot riding along in a batched tick) takes the argmax of its filtered
    logits and consumes nothing."""
    logits = logits.to(torch.float32)
    if cfg.greedy:
        return torch.argmax(logits, dim=-1)
    logits = _filter_logits(logits / cfg.temperature, cfg)
    rows = []
    for row, gen in zip(logits, gens):
        if gen is not None:
            u = torch.rand(row.shape, generator=gen, device=row.device,
                           dtype=torch.float32)
            row = row - torch.log(-torch.log(u))
        rows.append(torch.argmax(row))
    return torch.stack(rows)
