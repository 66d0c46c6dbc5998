"""Compression policy configuration for stage boundaries.

Port of ``repro/core/policy.py`` (static policies).  A
:class:`BoundaryPolicy` says what happens at ONE stage cut: the forward and
backward compressors and the error compensation around each.  A
:class:`CompressionPolicy` is the model-level plan: the stage count plus
the boundary policy at every cut, with optional per-cut overrides.  The
adaptive rule engine (``PolicyRules``) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.compressors import Compressor, IDENTITY, quant, topk

FEEDBACK_MODES = ("none", "ef", "ef21", "efmixed", "aqsgd")

# The backward direction excludes aqsgd: the paper applies per-example
# feedback to activations only (Sec. 2.5).
BW_FEEDBACK_MODES = ("none", "ef", "ef21", "efmixed")


@dataclasses.dataclass(frozen=True)
class BoundaryPolicy:
    """Per-boundary compression behaviour.

    fw / bw         : compressors for activations / activation-gradients.
    feedback        : error compensation wrapping the FORWARD direction.
    bw_feedback     : error compensation wrapping the BACKWARD direction.
    reuse_indices   : reuse the forward TopK mask on the backward gradient.
    compress_eval   : apply ``fw`` during inference.
    """
    fw: Compressor = IDENTITY
    bw: Compressor = IDENTITY
    feedback: str = "none"
    bw_feedback: str = "none"
    reuse_indices: bool = False
    compress_eval: bool = True

    def __post_init__(self):
        if self.feedback not in FEEDBACK_MODES:
            raise ValueError(f"bad feedback mode {self.feedback!r}; "
                             f"valid modes: {FEEDBACK_MODES}")
        if self.bw_feedback not in BW_FEEDBACK_MODES:
            raise ValueError(
                f"bad bw_feedback mode {self.bw_feedback!r}; valid modes: "
                f"{BW_FEEDBACK_MODES} ('aqsgd' is activations-only — the "
                "paper keeps per-example feedback on the forward direction)")
        if self.reuse_indices and self.fw.kind != "topk":
            raise ValueError("reuse_indices requires a TopK forward compressor")

    @property
    def needs_fw_buffer(self) -> bool:
        return self.feedback in ("ef", "ef21", "efmixed", "aqsgd")

    @property
    def needs_bw_buffer(self) -> bool:
        return self.bw_feedback in ("ef", "ef21", "efmixed")

    @property
    def name(self) -> str:
        parts = [f"fw={self.fw.name}", f"bw={self.bw.name}"]
        if self.feedback != "none":
            parts.append(self.feedback)
        if self.bw_feedback != "none":
            parts.append(f"bw-{self.bw_feedback}")
        if self.reuse_indices:
            parts.append("reuse")
        return ",".join(parts)


NO_COMPRESSION = BoundaryPolicy()


def quant_policy(fw_bits: int, bw_bits: int) -> BoundaryPolicy:
    """Paper's fw[A]-bw[B] quantization mode (Table 1)."""
    return BoundaryPolicy(fw=quant(fw_bits), bw=quant(bw_bits))


def topk_policy(k_frac: float, reuse_indices: bool = False) -> BoundaryPolicy:
    """Paper's TopK mode (Tables 2, 5)."""
    return BoundaryPolicy(fw=topk(k_frac), bw=topk(k_frac),
                          reuse_indices=reuse_indices)


def ef_policy(k_frac: float, mode: str = "ef") -> BoundaryPolicy:
    """Paper's error-feedback modes (Table 3) on both directions, TopK."""
    return BoundaryPolicy(fw=topk(k_frac), bw=topk(k_frac),
                          feedback=mode, bw_feedback=mode)


def aqsgd_policy(k_frac: float) -> BoundaryPolicy:
    """Paper's AQ-SGD + TopK mode (Table 4): per-example feedback on
    activations, plain TopK on gradients."""
    return BoundaryPolicy(fw=topk(k_frac), bw=topk(k_frac), feedback="aqsgd")


@dataclasses.dataclass(frozen=True)
class CompressionPolicy:
    """Model-level plan: ``num_stages`` stages => ``num_stages - 1`` cuts,
    ``boundary`` at every cut unless ``overrides`` names a per-cut policy.
    """
    num_stages: int = 4
    boundary: BoundaryPolicy = NO_COMPRESSION
    overrides: Tuple[Tuple[int, BoundaryPolicy], ...] = ()

    @property
    def num_boundaries(self) -> int:
        return max(0, self.num_stages - 1)

    @property
    def name(self) -> str:
        if not self.overrides:
            return f"{self.num_stages}x({self.boundary.name})"
        cuts = ",".join(f"{i}:({self.at(i).name})"
                        for i in range(self.num_boundaries))
        return f"{self.num_stages}x[{cuts}]"

    def at(self, i: int) -> BoundaryPolicy:
        for j, p in self.overrides:
            if j == i:
                return p
        return self.boundary


NO_POLICY = CompressionPolicy(num_stages=1)

# The named presets of ``repro.launch.train.POLICIES``.
POLICIES = {
    "none": lambda: NO_POLICY,
    "q4q8": lambda: CompressionPolicy(num_stages=4,
                                      boundary=quant_policy(4, 8)),
    "top10": lambda: CompressionPolicy(num_stages=4,
                                       boundary=topk_policy(0.10)),
    "top10reuse": lambda: CompressionPolicy(
        num_stages=4, boundary=topk_policy(0.10, reuse_indices=True)),
    "ef21top10": lambda: CompressionPolicy(num_stages=4,
                                           boundary=ef_policy(0.10, "ef21")),
}
