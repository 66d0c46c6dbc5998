"""Compression policy configuration for stage boundaries.

Port of ``repro/core/policy.py``.  A :class:`BoundaryPolicy` says what
happens at ONE stage cut: the forward and backward compressors and the
error compensation around each.  A :class:`CompressionPolicy` is the
model-level plan: the stage count plus the boundary policy at every cut,
with optional per-cut overrides.

On top sits the adaptive rule engine: a :class:`PolicyRule` maps a
predicate over (tensor size, cut depth, direction, measured bandwidth) to
a ``(codec, k_frac)`` choice, and :class:`PolicyRules` resolves an ordered
rule list into a plain :class:`CompressionPolicy` given the per-cut tensor
sizes, first match winning, in Python before the step is built.  A
one-rule set that resolves uniformly is EQUAL to its hand-written
policy.  Names, grammar and errors are the reference's.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence, Tuple, Union

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

# ---------------------------------------------------------------------------
# Adaptive per-boundary policy rule engine
# ---------------------------------------------------------------------------

RULE_CODECS = ("none", "q8", "q4", "topk")


def _rule_compressor(codec: str, k_frac: float) -> Compressor:
    if codec == "none":
        return IDENTITY
    if codec == "q8":
        return quant(8)
    if codec == "q4":
        return quant(4)
    return topk(k_frac)


@dataclasses.dataclass(frozen=True)
class PolicyRule:
    """One rule: a predicate over the boundary tensor -> a codec choice.

    The predicate sees three static facts about each boundary direction:

      size      : per-example element count of the boundary tensor
                  (``prod(feat_shape)`` — what the wire cost scales with);
      depth     : the boundary index (0 = the cut after the first stage);
      direction : "fw" (activations) or "bw" (activation-gradients);
      bandwidth : (optional) MEASURED link bytes/s from a probe.  A
                  rule with a bandwidth term only fires when a
                  measurement is supplied — without one (the no-probe
                  config, the only one the port has) it is skipped.

    ``matches`` is pure Python over static shapes and a host-side float,
    so rules resolve before the step is built.
    """
    codec: str
    k_frac: float = 0.1
    min_size: int = 0
    max_size: Optional[int] = None
    min_depth: int = 0
    max_depth: Optional[int] = None
    direction: str = "both"
    min_bandwidth: float = 0.0
    max_bandwidth: Optional[float] = None

    def __post_init__(self):
        if self.codec not in RULE_CODECS:
            raise ValueError(f"unknown rule codec {self.codec!r}; "
                             f"known: {RULE_CODECS}")
        if self.direction not in ("fw", "bw", "both"):
            raise ValueError(f"rule direction must be 'fw', 'bw' or "
                             f"'both', got {self.direction!r}")
        if not 0.0 < self.k_frac <= 1.0:
            raise ValueError(f"k_frac must be in (0, 1], got {self.k_frac}")

    @property
    def needs_bandwidth(self) -> bool:
        return self.min_bandwidth > 0 or self.max_bandwidth is not None

    def matches(self, size: int, depth: int, direction: str,
                bandwidth: Optional[float] = None) -> bool:
        if self.direction != "both" and direction != self.direction:
            return False
        if size < self.min_size:
            return False
        if self.max_size is not None and size >= self.max_size:
            return False
        if depth < self.min_depth:
            return False
        if self.max_depth is not None and depth >= self.max_depth:
            return False
        if self.needs_bandwidth:
            # no measurement => a bandwidth-conditioned rule never fires
            # (degenerate no-probe configs resolve exactly as before)
            if bandwidth is None:
                return False
            if bandwidth < self.min_bandwidth:
                return False
            if self.max_bandwidth is not None \
                    and bandwidth >= self.max_bandwidth:
                return False
        return True

    @property
    def name(self) -> str:
        conds = []
        if self.direction != "both":
            conds.append(f"dir={self.direction}")
        if self.min_size:
            conds.append(f"size>={self.min_size}")
        if self.max_size is not None:
            conds.append(f"size<{self.max_size}")
        if self.min_depth:
            conds.append(f"depth>={self.min_depth}")
        if self.max_depth is not None:
            conds.append(f"depth<{self.max_depth}")
        if self.min_bandwidth:
            conds.append(f"bandwidth>={self.min_bandwidth:g}")
        if self.max_bandwidth is not None:
            conds.append(f"bandwidth<{self.max_bandwidth:g}")
        codec = (f"{self.codec}:{self.k_frac}" if self.codec == "topk"
                 else self.codec)
        return codec + (("@" + ",".join(conds)) if conds else "")


@dataclasses.dataclass(frozen=True)
class PolicyRules:
    """An ordered rule list + stage count: the unresolved adaptive policy.

    ``resolve(boundary_sizes)`` evaluates the rules per boundary and per
    direction — FIRST match wins, like a routing table — and returns a
    plain :class:`CompressionPolicy` (per-cut overrides collapse to a
    uniform boundary when every cut resolves identically, so a degenerate
    one-rule policy is EQUAL to its hand-written static counterpart).  A boundary no rule covers is an error: end
    the list with a catch-all rule (e.g. ``none``).
    """
    rules: Tuple[PolicyRule, ...]
    num_stages: int = 4

    def __post_init__(self):
        if not self.rules:
            raise ValueError("PolicyRules needs at least one rule")

    @property
    def num_boundaries(self) -> int:
        return max(0, self.num_stages - 1)

    def pick(self, size: int, depth: int, direction: str,
             bandwidth: Optional[float] = None) -> PolicyRule:
        for r in self.rules:
            if r.matches(size, depth, direction, bandwidth):
                return r
        raise ValueError(
            f"no policy rule matches boundary {depth} "
            f"(size={size}, direction={direction!r}, "
            f"bandwidth={bandwidth!r}) — rule list: "
            f"[{'; '.join(r.name for r in self.rules)}]. Append a "
            "catch-all rule (e.g. 'none') so every boundary resolves.")

    def resolve(self, boundary_sizes: Union[int, Sequence[int]],
                bandwidth: Optional[float] = None) -> CompressionPolicy:
        """Rules x per-boundary tensor sizes -> a static policy.

        ``boundary_sizes``: per-example element count at each cut (an int
        broadcasts to every cut — the transformer's uniform ``seq *
        d_model``; heterogeneous stacks like the CNN pass one per cut).

        ``bandwidth``: measured link bytes/s evaluated by
        ``bandwidth>=X`` / ``bandwidth<X`` rule terms.  Without a
        measurement (None — the degenerate no-probe config), bandwidth-
        conditioned rules never fire and resolution is IDENTICAL to the
        static engine's, bit for bit.
        """
        if isinstance(boundary_sizes, int):
            sizes = (boundary_sizes,) * self.num_boundaries
        else:
            sizes = tuple(int(s) for s in boundary_sizes)
        if len(sizes) != self.num_boundaries:
            raise ValueError(
                f"got {len(sizes)} boundary sizes for "
                f"{self.num_boundaries} boundaries (num_stages="
                f"{self.num_stages})")
        bps = []
        for i, n in enumerate(sizes):
            fw_rule = self.pick(n, i, "fw", bandwidth)
            bw_rule = self.pick(n, i, "bw", bandwidth)
            bps.append(BoundaryPolicy(
                fw=_rule_compressor(fw_rule.codec, fw_rule.k_frac),
                bw=_rule_compressor(bw_rule.codec, bw_rule.k_frac)))
        if not bps:
            return CompressionPolicy(num_stages=self.num_stages)
        if all(bp == bps[0] for bp in bps):
            return CompressionPolicy(num_stages=self.num_stages,
                                     boundary=bps[0])
        return CompressionPolicy(
            num_stages=self.num_stages, boundary=bps[0],
            overrides=tuple((i, bp) for i, bp in enumerate(bps)))

    @property
    def name(self) -> str:
        return ";".join(r.name for r in self.rules)


_COND_RE = re.compile(
    r"^(size|depth|bandwidth)(>=|<)(\d+(?:\.\d+)?(?:[eE]\+?\d+)?)$"
    r"|^dir=(fw|bw)$")


def parse_rule(spec: str) -> PolicyRule:
    """``codec[:k_frac][@cond,...]`` -> :class:`PolicyRule`.

    Conditions: ``size>=N`` / ``size<N`` (per-example element count),
    ``depth>=N`` / ``depth<N`` (boundary index), ``dir=fw`` / ``dir=bw``,
    ``bandwidth>=X`` / ``bandwidth<X`` (measured link bytes/s, scientific
    notation welcome — fires only when a probe measurement is supplied at
    resolve time).  Examples: ``q8``, ``topk:0.1``,
    ``topk:0.05@size>=65536,dir=fw``, ``none@bandwidth>=50e9``.
    """
    spec = spec.strip()
    head, _, conds = spec.partition("@")
    codec, _, kf = head.partition(":")
    codec = codec.strip()
    kw = {}
    if kf:
        try:
            kw["k_frac"] = float(kf)
        except ValueError:
            raise ValueError(f"bad k_frac {kf!r} in rule {spec!r}") from None
    for cond in filter(None, (c.strip() for c in conds.split(","))):
        m = _COND_RE.match(cond)
        if not m:
            raise ValueError(
                f"bad rule condition {cond!r} in {spec!r} — expected "
                "size>=N, size<N, depth>=N, depth<N, bandwidth>=X, "
                "bandwidth<X, dir=fw or dir=bw")
        if m.group(4):
            kw["direction"] = m.group(4)
        else:
            key, op, raw = m.group(1), m.group(2), m.group(3)
            if key == "bandwidth":
                val = float(raw)
            else:
                try:
                    val = int(raw)
                except ValueError:
                    raise ValueError(
                        f"bad rule condition {cond!r} in {spec!r} — "
                        f"{key} thresholds must be integers") from None
            kw[("min_" if op == ">=" else "max_") + key] = val
    return PolicyRule(codec=codec, **kw)


def parse_policy_rules(spec: str, num_stages: int = 4) -> PolicyRules:
    """A ``;``-separated rule list -> :class:`PolicyRules`.

    E.g. ``"topk:0.1@size>=65536;q8"``: TopK-10% at any cut whose tensor
    has >= 64Ki elements per example, 8-bit quantization everywhere else
    (the Hivemind ``SizeAdaptiveCompression`` shape).
    """
    rules = tuple(parse_rule(r) for r in spec.split(";") if r.strip())
    if not rules:
        raise ValueError(f"empty policy rule spec {spec!r}")
    return PolicyRules(rules=rules, num_stages=num_stages)


def resolve_policy(policy, boundary_sizes,
                   bandwidth: Optional[float] = None) -> CompressionPolicy:
    """Accept either a static :class:`CompressionPolicy` (returned as-is)
    or unresolved :class:`PolicyRules` (resolved against the boundary
    sizes, and — when a probe measurement is supplied — the measured link
    ``bandwidth`` in bytes/s) — the single entry point train/steps.py and
    the launchers thread an adaptive policy through."""
    if isinstance(policy, PolicyRules):
        return policy.resolve(boundary_sizes, bandwidth)
    return policy


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
