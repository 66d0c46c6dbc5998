"""Wire-level telemetry: traces, metrics and bandwidth probes.

Port of ``repro/obs/``.  Host-side observability for the train and serve
loops.  Instrumentation sites read facts computed from shapes (payload
structs, codec names) and wall clocks around the steps, so the telemetry
layer adds no device work of its own and is free when disabled (the
default).  Two parts do run on the device when asked to: the quality
tap's codec round trips and the bandwidth probe's copies.

  trace.py    span/counter API over a host-side ring buffer
  export.py   JSONL + Chrome-trace (Perfetto) exporters, event schema
  quality.py  per-boundary compression error / feedback-norm debug tap
  probes.py   achieved-bytes/s probes feeding PolicyRules
  keyed.py    when the trace-time wire events fire in an eager program
"""
from repro_torch.obs.trace import (Tracer, disable, enable,  # noqa: F401
                                   get_tracer, instant, counter, span)
from repro_torch.obs.export import (EVENT_SCHEMA,  # noqa: F401
                                    to_chrome_trace, to_jsonl,
                                    validate_events, validate_jsonl)
