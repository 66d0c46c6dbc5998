"""Lightweight span/counter tracing over a host-side ring buffer.

Port of ``repro/obs/trace.py`` (a copy: the port imports nothing of the
JAX package).  Design constraints:

  * ZERO cost when disabled — the module-level helpers check one global
    and return a shared no-op; no event objects, no clock reads, and
    never any device ops (instrumentation sites only touch host state
    and facts computed from shapes);
  * bounded memory when enabled — a ``deque(maxlen=capacity)`` ring
    buffer drops the OLDEST events and counts the drops, so a long run
    can leave tracing on without growing without bound;
  * exporter-agnostic events — one flat :class:`TraceEvent` record maps
    1:1 onto both the JSONL schema and the Chrome-trace format
    (obs/export.py).

Usage::

    from repro_torch.obs import trace
    tracer = trace.enable()
    with trace.span("train.step", cat="train", step=3):
        ...                       # timed wall-clock span
    trace.counter("queue", cat="serve", depth=4)
    trace.instant("policy.resolved", cat="policy", codec="q8")
    events = tracer.drain()

Timestamps are seconds since the tracer's epoch (``perf_counter`` based,
monotonic); exporters convert to microseconds.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Deque, List, Optional

# Chrome-trace phases we emit: X = complete span (ts + dur),
# C = counter sample, i = instant event.
PHASES = ("X", "C", "i")


@dataclasses.dataclass
class TraceEvent:
    """One telemetry record: a span, counter sample or instant marker."""
    name: str
    cat: str
    ph: str                      # one of PHASES
    ts: float                    # seconds since tracer epoch
    dur: float = 0.0             # seconds (spans only)
    args: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"name": self.name, "cat": self.cat, "ph": self.ph,
                "ts_us": round(self.ts * 1e6, 1),
                "dur_us": round(self.dur * 1e6, 1), "args": self.args}


class Tracer:
    """Host-side ring buffer of :class:`TraceEvent` records."""

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.events: Deque[TraceEvent] = deque(maxlen=capacity)
        self.dropped = 0
        self.t0 = time.perf_counter()

    def _now(self) -> float:
        return time.perf_counter() - self.t0

    def _append(self, ev: TraceEvent) -> None:
        if len(self.events) == self.capacity:
            self.dropped += 1
        self.events.append(ev)

    # -- emit ---------------------------------------------------------------

    def instant(self, name: str, cat: str = "default", **args) -> None:
        self._append(TraceEvent(name, cat, "i", self._now(), 0.0, args))

    def counter(self, name: str, cat: str = "default", **values) -> None:
        """A counter sample: ``values`` are the tracked numeric series."""
        self._append(TraceEvent(name, cat, "C", self._now(), 0.0, values))

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "default", **args):
        """Wall-clock a ``with`` block as one complete ("X") event.

        Yields the event's mutable ``args`` dict so the block can attach
        results it only knows at the end (e.g. a loss value)."""
        t0 = self._now()
        try:
            yield args
        finally:
            self._append(TraceEvent(name, cat, "X", t0,
                                    self._now() - t0, args))

    # -- read ---------------------------------------------------------------

    def drain(self) -> List[TraceEvent]:
        """Pop and return every buffered event (oldest first)."""
        out = list(self.events)
        self.events.clear()
        return out

    def snapshot(self) -> List[TraceEvent]:
        """Buffered events without clearing (oldest first)."""
        return list(self.events)

    def stats(self) -> dict:
        return {"buffered": len(self.events), "dropped": self.dropped,
                "capacity": self.capacity}


# ---------------------------------------------------------------------------
# Global tracer: default-off; the module helpers are the instrumentation
# surface (one global check, a shared nullcontext when disabled)
# ---------------------------------------------------------------------------

_TRACER: Optional[Tracer] = None
_NULL = contextlib.nullcontext({})


def enable(capacity: int = 65536) -> Tracer:
    """Install (and return) the global tracer; idempotent per-process
    enablement replaces any previous tracer."""
    global _TRACER
    _TRACER = Tracer(capacity)
    return _TRACER


def disable() -> None:
    global _TRACER
    _TRACER = None


@contextlib.contextmanager
def recording(capacity: int = 65536):
    """A tracer of its own for the ``with`` block, which it yields; the
    tracer installed before (or none) comes back after."""
    global _TRACER
    prev, _TRACER = _TRACER, Tracer(capacity)
    try:
        yield _TRACER
    finally:
        _TRACER = prev


def get_tracer() -> Optional[Tracer]:
    """The active tracer, or None when tracing is off (the default)."""
    return _TRACER


def span(name: str, cat: str = "default", **args):
    """Module-level span: a real timed span when tracing is enabled, a
    shared no-op context (no clock read, no allocation) otherwise."""
    t = _TRACER
    return t.span(name, cat, **args) if t is not None else _NULL


def instant(name: str, cat: str = "default", **args) -> None:
    t = _TRACER
    if t is not None:
        t.instant(name, cat, **args)


def counter(name: str, cat: str = "default", **values) -> None:
    t = _TRACER
    if t is not None:
        t.counter(name, cat, **values)
