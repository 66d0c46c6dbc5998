"""Unified parallelism spec: one object for every communication axis.

Port of ``repro/core/parallel.py``.  :class:`ParallelSpec` maps each axis
name (``"data" | "stage" | "tensor"``) to an :class:`AxisSpec`: the axis
size and its WIRE configuration (codec, feedback mode, TopK fraction).
``make_lm_train_step`` / ``run_lm_experiment`` take it as one
``parallel=`` argument; the legacy ``dp``/``dp_codec``/``dp_feedback``/
``dp_k_frac`` kwargs construct the equivalent spec (:func:`from_legacy`)
and warn with :class:`ParallelDeprecationWarning`.  The compact CLI forms
``--mesh data=2,stage=2`` and ``--wire data=q8+ef:0.1`` parse as in the
reference, with its grammar and error messages.

An axis codec may be a plain codec name (``"q8"``) or a policy-rule list
(``"q4@size>=100000000;q8"``, the grammar of ``core.policy.parse_rule``),
resolved against the axis' wire size (and an optional measured
bandwidth) by :meth:`ParallelSpec.resolved`.  The tensor axis takes the
"tp" scope's feedback modes (``none``, ``ef``, ``ef21``); a lossless
codec under feedback is refused where the wire is built
(``transport/tp_collectives.TPCollectives``), as in the reference.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Mapping, Optional, Tuple, Union

from repro_torch.core.feedback import FEEDBACK_REGISTRY
from repro_torch.core.policy import (BoundaryPolicy, CompressionPolicy,
                                     _rule_compressor, parse_policy_rules)

AXIS_NAMES = ("data", "stage", "tensor")

# "model" is the historical name of the tensor axis; "dp"/"pp"/"tp" are
# accepted shorthands in CLI specs.
AXIS_ALIASES = {
    "model": "tensor",
    "dp": "data",
    "pp": "stage",
    "tp": "tensor",
}

# Which FeedbackState scope an axis' feedback buffers live in.
AXIS_SCOPES = {"data": "dp", "stage": "boundary", "tensor": "tp"}


class ParallelDeprecationWarning(DeprecationWarning):
    """Category of the legacy ``dp_*`` kwarg deprecation shim."""


def canonical_axis(name: str) -> str:
    """Resolve an axis name or alias ("model" -> "tensor") to canonical."""
    name = AXIS_ALIASES.get(name, name)
    if name not in AXIS_NAMES:
        raise ValueError(
            f"unknown parallel axis {name!r}; valid: {AXIS_NAMES} "
            f"(aliases: {tuple(AXIS_ALIASES)})"
        )
    return name


def _is_rule_spec(codec: str) -> bool:
    return ("@" in codec) or (";" in codec) or (":" in codec)


def _feedback_modes_for(axis: str) -> Tuple[str, ...]:
    scope = AXIS_SCOPES[axis]
    return tuple(
        n for n, m in FEEDBACK_REGISTRY.items() if scope in m.scopes
    )


@dataclasses.dataclass(frozen=True)
class AxisSpec:
    """One mesh axis: its size and the wire that crosses it.  ``codec`` is
    a wire-codec name (``none/q8/q4/topk``) or an unresolved policy-rule
    list (anything containing ``@``/``;``/``:``), picked per axis by the
    rule engine."""

    size: int = 1
    codec: str = "none"
    feedback: str = "none"
    k_frac: float = 0.1

    def __post_init__(self):
        if not isinstance(self.size, int) or self.size < 1:
            raise ValueError(
                f"axis size must be a positive int, got {self.size!r}")
        if not 0.0 < self.k_frac <= 1.0:
            raise ValueError(f"k_frac must be in (0, 1], got {self.k_frac}")
        if _is_rule_spec(self.codec):
            parse_policy_rules(self.codec)  # raises on a malformed rule list
        else:
            from repro_torch.transport.codecs import registered_codecs

            if self.codec not in registered_codecs():
                raise ValueError(
                    f"unknown wire codec {self.codec!r}; registered: "
                    f"{registered_codecs()} (or a policy-rule spec)"
                )
        if self.feedback not in FEEDBACK_REGISTRY:
            raise ValueError(
                f"unknown feedback mode {self.feedback!r}; "
                f"known: {tuple(FEEDBACK_REGISTRY)}"
            )

    @property
    def is_rules(self) -> bool:
        return _is_rule_spec(self.codec)

    def resolve(self, wire_size: int,
                bandwidth: Optional[float] = None) -> "AxisSpec":
        """Collapse a rule-spec codec to a concrete one for this axis'
        wire size (per-example element count crossing the axis) and an
        optional measured ``bandwidth`` (bytes/s)."""
        if not self.is_rules:
            return self
        rule = parse_policy_rules(self.codec).pick(
            wire_size, 0, "fw", bandwidth=bandwidth)
        return dataclasses.replace(self, codec=rule.codec,
                                   k_frac=rule.k_frac)


_AXES_T = Tuple[Tuple[str, AxisSpec], ...]


@dataclasses.dataclass(frozen=True, init=False)
class ParallelSpec:
    """The full parallelism plan: ``{axis name -> AxisSpec}``.

    Canonical axis order is ``(data, stage, tensor)``; missing axes
    default to size 1 with no wire compression.  Hashable."""

    axes: _AXES_T

    def __init__(
        self,
        axes: Union[None, Mapping[str, Union[AxisSpec, int]], _AXES_T] = None,
    ):
        entries = dict(axes or {})
        normalized = {}
        for name, spec in entries.items():
            name = canonical_axis(name)
            if name in normalized:
                raise ValueError(f"duplicate axis {name!r} in ParallelSpec")
            if isinstance(spec, int):
                spec = AxisSpec(size=spec)
            if not isinstance(spec, AxisSpec):
                raise TypeError(
                    f"axis {name!r} must be an AxisSpec or int size, "
                    f"got {spec!r}"
                )
            normalized[name] = spec
        full = tuple(
            (n, normalized.get(n, AxisSpec())) for n in AXIS_NAMES
        )
        object.__setattr__(self, "axes", full)
        self._validate()

    def _validate(self):
        for name, spec in self.axes:
            modes = _feedback_modes_for(name)
            if spec.feedback not in modes:
                raise ValueError(
                    f"feedback {spec.feedback!r} is not valid on the "
                    f"{name!r} axis (scope {AXIS_SCOPES[name]!r} supports "
                    f"{modes})"
                )

    # -- accessors ---------------------------------------------------------

    def axis(self, name: str) -> AxisSpec:
        name = canonical_axis(name)
        return dict(self.axes)[name]

    @property
    def data(self) -> AxisSpec:
        return self.axis("data")

    @property
    def stage(self) -> AxisSpec:
        return self.axis("stage")

    @property
    def tensor(self) -> AxisSpec:
        return self.axis("tensor")

    @property
    def dp(self) -> int:
        return self.data.size

    @property
    def stages(self) -> int:
        return self.stage.size

    @property
    def tp(self) -> int:
        return self.tensor.size

    @property
    def num_devices(self) -> int:
        return self.dp * self.stages * self.tp

    @property
    def name(self) -> str:
        parts = []
        for n, s in self.axes:
            if s.size == 1 and s.codec == "none":
                continue
            wire = s.codec
            if s.feedback != "none":
                wire += f"+{s.feedback}"
            if s.codec == "topk" or (s.codec != "none" and s.k_frac != 0.1):
                wire += f":{s.k_frac:g}"
            parts.append(f"{n}={s.size}({wire})" if wire != "none"
                         else f"{n}={s.size}")
        return ",".join(parts) or "solo"

    # -- derived plans -----------------------------------------------------

    def resolved(
        self,
        wire_sizes: Optional[Mapping[str, int]] = None,
        bandwidth: Optional[float] = None,
    ) -> "ParallelSpec":
        """Resolve any rule-spec axis codecs (see :meth:`AxisSpec.resolve`).
        ``wire_sizes`` maps axis name -> per-example element count on that
        axis' wire; axes without an entry resolve with size 0."""
        sizes = dict(wire_sizes or {})
        return ParallelSpec(
            {n: s.resolve(sizes.get(n, 0), bandwidth) for n, s in self.axes})

    def stage_policy(self):
        """A uniform boundary :class:`CompressionPolicy` from the stage
        axis' wire spec (the unresolved ``PolicyRules`` of a rule-spec
        stage codec), or None when the stage wire is uncompressed with no
        feedback (callers then keep their explicit ``policy``)."""
        s = self.stage
        if s.codec == "none" and s.feedback == "none":
            return None
        if s.is_rules:
            return parse_policy_rules(s.codec, num_stages=s.size)
        comp = _rule_compressor(s.codec, s.k_frac)
        return CompressionPolicy(
            num_stages=s.size,
            boundary=BoundaryPolicy(
                fw=comp,
                bw=comp,
                feedback=s.feedback,
                bw_feedback=s.feedback if s.feedback != "aqsgd" else "none",
            ),
        )


# ---------------------------------------------------------------------------
# Compact CLI specs:  --mesh data=2,stage=2
#                     --wire data=q8+ef:0.1
# ---------------------------------------------------------------------------


def parse_mesh_spec(spec: str) -> dict:
    """``"data=2,stage=2,tensor=2"`` ->
    ``{"data": 2, "stage": 2, "tensor": 2}``.
    Axis aliases (``model``/``dp``/``pp``/``tp``) are accepted."""
    out = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        name, eq, size_s = item.partition("=")
        if not eq:
            raise ValueError(
                f"bad mesh item {item!r} (want axis=<int>, e.g. data=2)"
            )
        name = canonical_axis(name.strip())
        try:
            size = int(size_s)
        except ValueError:
            raise ValueError(f"bad mesh size {size_s!r} for axis {name!r}")
        if size < 1:
            raise ValueError(
                f"mesh axis {name!r} size must be >= 1, got {size}")
        if name in out:
            raise ValueError(f"duplicate mesh axis {name!r} in {spec!r}")
        out[name] = size
    if not out:
        raise ValueError(f"empty mesh spec {spec!r}")
    return out


def parse_wire_item(item: str) -> Tuple[str, str, Optional[float]]:
    """``"q8+ef:0.1"`` -> ``("q8", "ef", 0.1)`` (k_frac None if omitted)."""
    head, colon, k_s = item.partition(":")
    k_frac = None
    if colon:
        try:
            k_frac = float(k_s)
        except ValueError:
            raise ValueError(f"bad k_frac {k_s!r} in wire item {item!r}")
    codec, plus, feedback = head.partition("+")
    codec = codec.strip() or "none"
    feedback = feedback.strip() if plus else "none"
    return codec, feedback, k_frac


def parse_wire_spec(spec: str) -> dict:
    """``"data=q8+ef:0.1,tensor=q4"`` ->
    ``{"data": ("q8", "ef", 0.1), "tensor": ("q4", "none", None)}``."""
    out = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        name, eq, wire = item.partition("=")
        if not eq:
            raise ValueError(
                f"bad wire item {item!r} (want axis=codec[+feedback][:k_frac])"
            )
        name = canonical_axis(name.strip())
        if name in out:
            raise ValueError(f"duplicate wire axis {name!r} in {spec!r}")
        out[name] = parse_wire_item(wire.strip())
    if not out:
        raise ValueError(f"empty wire spec {spec!r}")
    return out


def spec_from_cli(
    mesh: Optional[str] = None, wire: Optional[str] = None
) -> ParallelSpec:
    """Build a :class:`ParallelSpec` from the compact ``--mesh``/``--wire``
    CLI strings (either may be None)."""
    sizes = parse_mesh_spec(mesh) if mesh else {}
    wires = parse_wire_spec(wire) if wire else {}
    axes = {}
    for name in AXIS_NAMES:
        kw = {"size": sizes.get(name, 1)}
        if name in wires:
            codec, feedback, k_frac = wires[name]
            kw["codec"] = codec
            kw["feedback"] = feedback
            if k_frac is not None:
                kw["k_frac"] = k_frac
        axes[name] = AxisSpec(**kw)
    return ParallelSpec(axes)


# ---------------------------------------------------------------------------
# Legacy-kwarg shim
# ---------------------------------------------------------------------------


def from_legacy(
    *,
    dp: int = 1,
    dp_codec: str = "none",
    dp_feedback: str = "none",
    dp_k_frac: float = 0.1,
    num_stages: int = 1,
    tp: int = 1,
    tp_codec: str = "none",
    tp_feedback: str = "none",
    tp_k_frac: float = 0.1,
) -> ParallelSpec:
    """The spec the legacy kwarg family described."""
    return ParallelSpec(
        {
            "data": AxisSpec(
                size=dp, codec=dp_codec, feedback=dp_feedback, k_frac=dp_k_frac
            ),
            "stage": AxisSpec(size=num_stages),
            "tensor": AxisSpec(
                size=tp, codec=tp_codec, feedback=tp_feedback, k_frac=tp_k_frac
            ),
        }
    )


def warn_legacy(api: str, kwargs: Tuple[str, ...]) -> None:
    """Warn once for a legacy-kwarg call site."""
    warnings.warn(
        f"{api}: the {', '.join(kwargs)} kwarg(s) are deprecated — pass "
        f"parallel=ParallelSpec({{...}}) instead (see core/parallel.py and "
        "the README 'Parallelism & wire configuration' section)",
        ParallelDeprecationWarning,
        stacklevel=3,
    )
