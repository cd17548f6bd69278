"""Event sinks — where telemetry events go (the port's own copy of
``repro.obs.sinks``, stdlib only).

Every pillar of ``repro_torch.obs`` (spans, solver traces, the metric snapshot a
:class:`~repro_torch.obs.telemetry.Telemetry` session flushes at close) emits plain
JSON-able dicts through one ``Sink`` interface:

  * :data:`NULL_SINK` — the process-wide no-op default.  ``emit`` is a bound
    no-op method, so a disabled telemetry path costs one attribute check.
  * :class:`RingSink` — a bounded in-memory ring buffer (``collections.deque``)
    for tests and live inspection; ``events()`` copies the current contents.
  * :class:`JsonlSink` — one JSON object per line, appended under a lock so
    serving worker + client threads never interleave partial lines.
  * :class:`MultiSink` — fan-out to several sinks at once.

Sinks are deliberately dependency-free (stdlib only) and never raise out of
``emit`` on shutdown races; schema enforcement lives in ``repro_torch.obs.trace``.
"""

from __future__ import annotations

import collections
import json
import threading
from typing import Any, Iterable

__all__ = ["JsonlSink", "MultiSink", "NULL_SINK", "NullSink", "RingSink"]


class NullSink:
    """The disabled-path sink: swallows every event.

    A single shared instance (:data:`NULL_SINK`) is the default everywhere,
    so ``sink is NULL_SINK`` is the one-branch fast path that keeps disabled
    telemetry at near-zero overhead.
    """

    __slots__ = ()

    def emit(self, event: dict) -> None:
        """Drop the event."""

    def close(self) -> None:
        """Nothing to release."""


#: the shared no-op sink — identity-compared by the span/recorder fast paths
NULL_SINK = NullSink()


class RingSink:
    """Bounded in-memory event buffer (newest ``capacity`` events kept).

    ``collections.deque`` appends are atomic under the GIL, so concurrent
    emitters need no extra locking; ``events()`` returns a list copy.
    """

    def __init__(self, capacity: int = 4096):
        self._buf: collections.deque = collections.deque(maxlen=int(capacity))

    def emit(self, event: dict) -> None:
        """Append ``event`` (a dict) to the ring, evicting the oldest."""
        self._buf.append(event)

    def events(self) -> list[dict]:
        """Snapshot of the buffered events, oldest first."""
        return list(self._buf)

    def close(self) -> None:
        """Keep the buffer readable after close (tests inspect it)."""


class JsonlSink:
    """Append events to ``path`` as JSON Lines, one object per line.

    A lock serializes writes — the serving engine's worker thread and any
    number of client threads can share one sink without interleaving lines.
    Values that are not JSON-native (numpy scalars, 0-d tensors) are coerced
    through ``float``/``str`` by the encoder's ``default`` hook.
    """

    def __init__(self, path: str):
        self.path = str(path)
        self._lock = threading.Lock()
        self._fh = open(self.path, "a")

    @staticmethod
    def _default(obj: Any):
        try:
            return float(obj)
        except (TypeError, ValueError):
            return str(obj)

    def emit(self, event: dict) -> None:
        """Write one JSON line (locked; silently drops after close)."""
        line = json.dumps(event, default=self._default)
        with self._lock:
            if self._fh.closed:
                return
            self._fh.write(line + "\n")

    def close(self) -> None:
        """Flush and close the file (idempotent)."""
        with self._lock:
            if not self._fh.closed:
                self._fh.flush()
                self._fh.close()


class MultiSink:
    """Fan one event stream out to several sinks."""

    def __init__(self, sinks: Iterable):
        self.sinks = tuple(sinks)

    def emit(self, event: dict) -> None:
        """Emit to every child sink in order."""
        for s in self.sinks:
            s.emit(event)

    def close(self) -> None:
        """Close every child sink."""
        for s in self.sinks:
            s.close()
