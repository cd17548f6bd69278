"""Contextvar-based span tracer: nested timed regions, thread-safe (the
port's own copy of ``repro.obs.spans``, stdlib only).

``with span("solve/askotch", n=n, t=t): ...`` times a region with both the
wall clock and the process CPU clock and emits one structured event at exit:

    {"type": "span", "name": ..., "t_wall": ..., "dur_s": ..., "cpu_s": ...,
     "span_id": ..., "parent_id": ..., "depth": ..., "thread": ...,
     "attrs": {...}}

Nesting is tracked through a :mod:`contextvars` stack, so each thread (the
serving engine's worker plus any number of client threads) gets its own
independent span tree while sharing one sink — the sink itself serializes
writes.  ``parent_id`` stitches the tree back together offline.

The module-level default sink is :data:`~repro_torch.obs.sinks.NULL_SINK`; with it
active :func:`span` returns a shared no-op context manager without allocating
anything, so un-configured telemetry costs one identity check per call site.
Per-session sinks (the usual path) come from
:class:`repro_torch.obs.telemetry.Telemetry`, which passes its sink explicitly.
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time

from repro_torch.obs.sinks import NULL_SINK

__all__ = ["NULL_SPAN", "Span", "current_span_id", "set_sink", "span"]

_ids = itertools.count(1)
#: per-context stack of active span ids (tuple → copy-on-write, thread-safe)
_stack: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "repro_obs_span_stack", default=()
)


class _NullSpan:
    """Shared no-op context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


#: the singleton returned by :func:`span` when the sink is disabled
NULL_SPAN = _NullSpan()


class Span:
    """One timed region; use as a context manager.

    Records ``time.perf_counter`` (wall) and ``time.process_time`` (CPU) at
    entry, pushes itself on the context stack, and on exit emits a single
    ``type="span"`` event to its sink with durations, ids, nesting depth,
    thread name, and any keyword attributes given at creation.
    """

    __slots__ = ("name", "sink", "attrs", "span_id", "parent_id", "depth",
                 "_t0", "_c0", "_t_wall", "_token")

    def __init__(self, name: str, sink, attrs: dict):
        self.name = name
        self.sink = sink
        self.attrs = attrs
        self.span_id = next(_ids)

    def __enter__(self):
        stack = _stack.get()
        self.parent_id = stack[-1] if stack else 0
        self.depth = len(stack)
        self._token = _stack.set(stack + (self.span_id,))
        self._t_wall = time.time()
        self._c0 = time.process_time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        cpu = time.process_time() - self._c0
        _stack.reset(self._token)
        event = {
            "type": "span",
            "name": self.name,
            "t_wall": self._t_wall,
            "dur_s": dur,
            "cpu_s": cpu,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "depth": self.depth,
            "thread": threading.current_thread().name,
        }
        if self.attrs:
            event["attrs"] = self.attrs
        self.sink.emit(event)
        return False


_default_sink = NULL_SINK


def set_sink(sink) -> None:
    """Install ``sink`` as the module-level default for bare :func:`span`
    calls (pass :data:`~repro_torch.obs.sinks.NULL_SINK` to disable again).
    Telemetry sessions normally pass their sink explicitly instead."""
    global _default_sink
    _default_sink = sink if sink is not None else NULL_SINK


def span(name: str, *, sink=None, **attrs):
    """Open a timed span named ``name`` (use as a context manager).

    ``attrs`` keyword values are attached verbatim to the emitted event.
    With no sink configured this returns the shared :data:`NULL_SPAN`
    no-op — the disabled path allocates nothing.
    """
    s = _default_sink if sink is None else sink
    if s is NULL_SINK:
        return NULL_SPAN
    return Span(name, s, attrs)


def current_span_id() -> int:
    """Id of the innermost active span in this context (0 when outside
    any span) — lets detached work (e.g. serving batches) link events to
    the span that enqueued them."""
    stack = _stack.get()
    return stack[-1] if stack else 0
