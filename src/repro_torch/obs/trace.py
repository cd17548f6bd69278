"""Per-solve iterate recorder — the port's own copy of
``repro.obs.trace.TraceRecorder``, restricted to its ``history`` view.

Every evaluated iterate goes through :meth:`TraceRecorder.add`, which
appends the solver's history dict with the reference's keys in the
reference's order (``iter``, ``rel_residual``[, ``rel_residual_per_head``]
[, solver extras such as ``sketch_res``/``step_L``], ``time_s``).  Telemetry
sinks, spans and metrics arrive with the port's telemetry slice.
"""

from __future__ import annotations

__all__ = ["TraceRecorder"]


class TraceRecorder:
    """Per-solve iterate recorder (the ``history`` list)."""

    __slots__ = ("history",)

    def __init__(self):
        self.history: list[dict] = []

    def add(self, it: int, rel_residual: float, *, time_s: float,
            rel_residual_per_head=None, **extras) -> dict:
        """Record iteration ``it``: append the history dict and return it."""
        rec: dict = {"iter": int(it), "rel_residual": float(rel_residual)}
        if rel_residual_per_head is not None:
            rec["rel_residual_per_head"] = rel_residual_per_head
        rec.update(extras)
        rec["time_s"] = float(time_s)
        self.history.append(rec)
        return rec
