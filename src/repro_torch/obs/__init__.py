"""repro_torch.obs — unified telemetry: spans, metrics, and solver traces;
the port of ``repro.obs``, stdlib only (``torch`` is imported lazily for
the optional ``torch.profiler`` mirror, the H100 roofline reads
``repro_torch.roofline.hw``).

  * **spans** (:mod:`repro_torch.obs.spans`) — nested wall+CPU timed regions
    via a contextvar stack; thread-safe; no-op by default.
  * **metrics** (:mod:`repro_torch.obs.metrics`) — process-global counters /
    gauges / bounded histograms (kernel pairs, tile FLOPs+bytes by dtype,
    CG iterations), with ``snapshot()/diff()`` for benchmarks and
    Prometheus text exposition.
  * **traces** (:mod:`repro_torch.obs.trace`) — one canonical per-iteration
    record emitted by every solver through :class:`TraceRecorder`, with the
    ``history`` shape kept as a view.

Thread a :class:`Telemetry` session through the public entry points::

    tel = Telemetry(jsonl="run.jsonl")
    result = solve(problem, method="askotch", telemetry=tel)
    tel.close()
    validate_jsonl("run.jsonl")   # strict schema check

``telemetry=None`` (the default) resolves to the shared disabled session;
the disabled path is one bool test a loop and adds no device
synchronization.  ``python -m repro_torch.obs.report RUN.jsonl`` validates
and summarizes a file.
"""

from repro_torch.obs.metrics import (
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    counter,
    diff,
    gauge,
    histogram,
    log_buckets,
    prometheus_text,
    record_tile_work,
    snapshot,
)
from repro_torch.obs.sinks import NULL_SINK, JsonlSink, MultiSink, NullSink, RingSink
from repro_torch.obs.spans import current_span_id, set_sink, span
from repro_torch.obs.telemetry import NULL_TELEMETRY, Telemetry, as_telemetry
from repro_torch.obs.trace import SCHEMAS, TraceRecorder, validate_event, validate_jsonl

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "JsonlSink",
    "MultiSink",
    "NULL_SINK",
    "NULL_TELEMETRY",
    "NullSink",
    "REGISTRY",
    "RingSink",
    "SCHEMAS",
    "Telemetry",
    "TraceRecorder",
    "as_telemetry",
    "counter",
    "current_span_id",
    "diff",
    "gauge",
    "histogram",
    "log_buckets",
    "prometheus_text",
    "record_tile_work",
    "set_sink",
    "snapshot",
    "span",
    "validate_event",
    "validate_jsonl",
]
