"""The per-run telemetry session object threaded through the public APIs —
the port of ``repro.obs.telemetry``.

:class:`Telemetry` bundles a sink with span/recorder factories so one object
flows through ``solve(..., telemetry=tel)``, ``tune(..., telemetry=tel)``
and the ``--telemetry PATH`` launch flags:

    >>> from repro_torch.obs import Telemetry
    >>> tel = Telemetry(ring=True)          # or jsonl="/tmp/run.jsonl"
    >>> with tel.span("demo", n=4):
    ...     pass
    >>> tel.close()

``close()`` flushes a final batch of ``type="metric"`` events (the global
registry's snapshot, so the JSONL is self-contained) and closes the sink.

:data:`NULL_TELEMETRY` is the shared disabled instance; :func:`as_telemetry`
maps ``None`` to it so every instrumented call site can do
``tel = as_telemetry(telemetry)`` and then branch on the precomputed
``tel.enabled`` bool — the whole disabled path is one attribute load per
iteration and adds no device synchronization.

A span times the host.  CUDA launches return before the work ends, so the
instrumented solvers close a span after the host read that ends its region
(the residual ``float()`` of an evaluation), or synchronize the device
first, and only when ``tel.enabled``.

Optional ``profiler=True`` additionally wraps spans in
``torch.profiler.record_function`` so they show up as named ranges in a
``torch.profiler`` trace (lazy import; obs stays stdlib-only otherwise).
"""

from __future__ import annotations

from repro_torch.obs import metrics as _metrics
from repro_torch.obs.sinks import NULL_SINK, JsonlSink, MultiSink, RingSink
from repro_torch.obs.spans import NULL_SPAN, Span
from repro_torch.obs.trace import TraceRecorder

__all__ = ["NULL_TELEMETRY", "Telemetry", "as_telemetry"]


class Telemetry:
    """One telemetry session: a sink plus span / trace-recorder factories.

    Construct with ``jsonl=path`` (file), ``ring=True`` / ``ring=RingSink``
    (in-memory), an explicit ``sink=``, or nothing (disabled).  Passing more
    than one of jsonl/ring/sink fans out through a ``MultiSink``.
    """

    def __init__(self, *, jsonl=None, ring=None, sink=None, profiler=False):
        sinks = []
        self.ring = None
        if jsonl is not None:
            sinks.append(JsonlSink(jsonl))
        if ring:
            self.ring = ring if isinstance(ring, RingSink) else RingSink()
            sinks.append(self.ring)
        if sink is not None:
            sinks.append(sink)
        if not sinks:
            self.sink = NULL_SINK
        elif len(sinks) == 1:
            self.sink = sinks[0]
        else:
            self.sink = MultiSink(sinks)
        self.profiler = bool(profiler)
        self._closed = False

    @property
    def enabled(self) -> bool:
        """True when events actually go somewhere — instrumented hot loops
        read this once up front and skip per-iteration work when False."""
        return self.sink is not NULL_SINK

    def span(self, name: str, **attrs):
        """Open a span on this session's sink (no-op when disabled).

        With ``profiler=True`` the span is additionally recorded as a
        ``torch.profiler.record_function`` range.
        """
        if self.sink is NULL_SINK and not self.profiler:
            return NULL_SPAN
        s = Span(name, self.sink, attrs) if self.sink is not NULL_SINK else NULL_SPAN
        if not self.profiler:
            return s
        return _ProfiledSpan(name, s)

    def recorder(self, solver: str, *, precision=None, sweep_counter=None,
                 n=None) -> TraceRecorder:
        """Create a :class:`~repro_torch.obs.trace.TraceRecorder` bound to this
        session (``history`` always recorded; events when enabled)."""
        return TraceRecorder(solver, precision=precision, telemetry=self,
                             sweep_counter=sweep_counter, n=n)

    def emit_metrics(self) -> None:
        """Emit one ``type="metric"`` event per global-registry series so
        the JSONL stream is self-contained (no separate scrape needed)."""
        if self.sink is NULL_SINK:
            return
        with _metrics.REGISTRY._lock:
            items = sorted(_metrics.REGISTRY._metrics.items())
        for (name, lk), m in items:
            if m.kind == "histogram":
                vals = {"_count": float(m.count), "_sum": float(m.sum)}
            else:
                vals = {"": float(m.value)}
            for suffix, v in vals.items():
                event = {"type": "metric", "name": name + suffix,
                         "kind": m.kind, "value": v}
                if lk:
                    event["labels"] = dict(lk)
                self.sink.emit(event)

    def close(self) -> None:
        """Flush the metric snapshot into the stream and close the sink
        (idempotent)."""
        if self._closed:
            return
        self._closed = True
        self.emit_metrics()
        self.sink.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class _ProfiledSpan:
    """Span wrapper that mirrors the region as a ``torch.profiler`` range."""

    __slots__ = ("_span", "_annot")

    def __init__(self, name: str, inner):
        from torch.profiler import record_function

        self._span = inner
        self._annot = record_function(name)

    def __enter__(self):
        self._annot.__enter__()
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        self._span.__exit__(*exc)
        self._annot.__exit__(*exc)
        return False


#: the shared disabled session — what ``telemetry=None`` resolves to
NULL_TELEMETRY = Telemetry()


def as_telemetry(obj) -> Telemetry:
    """Coerce a ``telemetry=`` argument: ``None`` → :data:`NULL_TELEMETRY`,
    a :class:`Telemetry` passes through, anything else raises."""
    if obj is None:
        return NULL_TELEMETRY
    if isinstance(obj, Telemetry):
        return obj
    raise TypeError(
        f"telemetry= expects a repro_torch.obs.Telemetry or None, got {type(obj).__name__}"
    )
