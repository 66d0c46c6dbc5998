"""Trace exporters: JSONL event log + Chrome-trace (Perfetto) JSON.

Port of ``repro/obs/export.py``: the same schema and the same fields.

One event schema, two serializations:

  * JSONL — one event object per line, machine-diffable, validated
    against :data:`EVENT_SCHEMA`;
  * Chrome trace — ``{"traceEvents": [...]}`` loadable by Perfetto
    (https://ui.perfetto.dev) and ``chrome://tracing``; spans ("X")
    carry microsecond ts/dur, counters ("C") render as tracks.

The schema is deliberately flat so downstream tooling needs no codegen:

  name    str   event name, dotted namespace ("train.step", "serve.tick")
  cat     str   category ("train" | "serve" | "wire" | "policy" | ...)
  ph      str   phase: "X" complete span, "C" counter, "i" instant
  ts_us   num   start time, microseconds since tracer epoch
  dur_us  num   duration in microseconds (0 for C / i)
  args    dict  event payload (codec names, byte counts, depths, ...)
"""
from __future__ import annotations

import json
from typing import Iterable, List, Union

from repro_torch.obs.trace import PHASES, TraceEvent

# field name -> (allowed types, required)
EVENT_SCHEMA = {
    "name": (str, True),
    "cat": (str, True),
    "ph": (str, True),
    "ts_us": ((int, float), True),
    "dur_us": ((int, float), True),
    "args": (dict, True),
}


def _dicts(events: Iterable) -> List[dict]:
    return [e.to_dict() if isinstance(e, TraceEvent) else dict(e)
            for e in events]


def to_jsonl(events: Iterable, path: str) -> int:
    """Write one JSON object per line; returns the event count."""
    rows = _dicts(events)
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return len(rows)


def to_chrome_trace(events: Iterable, path: str, *,
                    pid: int = 0, tid: int = 0) -> int:
    """Write the Chrome-trace/Perfetto JSON format.

    Counter args must be numeric in this format; non-numeric arg values
    (codec names etc.) are stringified into the args dict, which both
    viewers render in the detail pane."""
    rows = []
    for e in _dicts(events):
        rec = {"name": e["name"], "cat": e["cat"], "ph": e["ph"],
               "ts": e["ts_us"], "pid": pid, "tid": tid,
               "args": e["args"]}
        if e["ph"] == "X":
            rec["dur"] = e["dur_us"]
        if e["ph"] == "i":
            rec["s"] = "t"                     # instant scope: thread
        if e["ph"] == "C":
            rec["args"] = {k: (v if isinstance(v, (int, float))
                               and not isinstance(v, bool) else str(v))
                           for k, v in e["args"].items()}
        rows.append(rec)
    with open(path, "w") as f:
        json.dump({"traceEvents": rows,
                   "displayTimeUnit": "ms"}, f)
    return len(rows)


def validate_events(events: Iterable[Union[dict, TraceEvent]]) -> int:
    """Validate events against :data:`EVENT_SCHEMA`; returns the count.

    Raises ``ValueError`` naming the first offending event and field."""
    n = 0
    for i, e in enumerate(_dicts(events)):
        for field, (types, required) in EVENT_SCHEMA.items():
            if field not in e:
                if required:
                    raise ValueError(
                        f"event {i} ({e.get('name', '?')!r}): missing "
                        f"required field {field!r}")
                continue
            if not isinstance(e[field], types) or isinstance(e[field], bool):
                raise ValueError(
                    f"event {i} ({e.get('name', '?')!r}): field {field!r} "
                    f"has type {type(e[field]).__name__}, expected {types}")
        if e["ph"] not in PHASES:
            raise ValueError(f"event {i} ({e['name']!r}): phase "
                             f"{e['ph']!r} not in {PHASES}")
        if e["ts_us"] < 0 or e["dur_us"] < 0:
            raise ValueError(f"event {i} ({e['name']!r}): negative "
                             "ts_us/dur_us")
        extra = set(e) - set(EVENT_SCHEMA)
        if extra:
            raise ValueError(f"event {i} ({e['name']!r}): unknown "
                             f"fields {sorted(extra)}")
        n += 1
    return n


def validate_jsonl(path: str) -> int:
    """Parse + schema-validate a JSONL trace file; returns the count."""
    with open(path) as f:
        events = [json.loads(line) for line in f if line.strip()]
    return validate_events(events)
