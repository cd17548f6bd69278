"""Canonical solver traces and the event schemas every sink line obeys —
the port's own copy of ``repro.obs.trace`` (stdlib only).

Each solver's ``history`` dicts keep the JAX package's shapes (askotch
carries ``sketch_res``/``step_L``, blocked-CG/pcg/falkon/eigenpro a 4-key
subset).  :class:`TraceRecorder` is the single emission point: every iterate goes through :meth:`add`,
which (a) appends the solver's legacy-shaped dict to ``.history`` — a
compatibility view, field for field the JAX package's records — and
(b) emits one canonical ``type="trace"`` event to the telemetry sink:

    {"type": "trace", "solver": ..., "iter": ..., "wall_s": ...,
     "rel_residual": ...[, "rel_residual_per_head", "sweeps", "precision",
     and solver extras like "sketch_res"/"step_L"]}

``sweeps`` is kernel-sweep-equivalents so far (pairs / n²) when the recorder
is linked to a tune-engine ``SweepCounter`` — the paper's budget unit.

:data:`SCHEMAS` + :func:`validate_event` / :func:`validate_jsonl` close the
loop: CI validates emitted JSONL strictly (unknown or missing fields fail),
so the schema (identical to the JAX package's) is enforced, not advisory.
"""

from __future__ import annotations

import json

from repro_torch.obs.sinks import NULL_SINK

__all__ = ["SCHEMAS", "TraceRecorder", "validate_event", "validate_jsonl"]

#: required / optional fields per event type — the wire contract
SCHEMAS: dict[str, dict[str, frozenset]] = {
    "span": {
        "required": frozenset({
            "type", "name", "t_wall", "dur_s", "cpu_s", "span_id",
            "parent_id", "depth", "thread",
        }),
        "optional": frozenset({"attrs"}),
    },
    "trace": {
        "required": frozenset({
            "type", "solver", "iter", "wall_s", "rel_residual",
        }),
        "optional": frozenset({
            "rel_residual_per_head", "sweeps", "precision", "sketch_res",
            "step_L", "head",
        }),
    },
    "metric": {
        "required": frozenset({"type", "name", "kind", "value"}),
        "optional": frozenset({"labels"}),
    },
}


class TraceRecorder:
    """Per-solve iterate recorder: legacy ``history`` view + canonical events.

    Solvers call :meth:`add` once per (evaluated) iteration; the recorder
    appends the legacy-shaped dict to :attr:`history` (what callers and
    existing tests consume, unchanged) and, when a telemetry sink is live,
    emits the canonical trace event.  With no telemetry the event path is a
    single identity check, so plain solves pay nothing.
    """

    __slots__ = ("solver", "precision", "sweep_counter", "n", "_sink",
                 "history")

    def __init__(self, solver: str, *, precision=None, telemetry=None,
                 sweep_counter=None, n=None):
        self.solver = solver
        self.precision = precision
        self.sweep_counter = sweep_counter
        self.n = n
        self._sink = NULL_SINK if telemetry is None else telemetry.sink
        self.history: list[dict] = []

    def add(self, it: int, rel_residual: float, *, time_s: float,
            rel_residual_per_head=None, **extras) -> dict:
        """Record iteration ``it``.

        Builds the legacy history dict (``iter``/``rel_residual``
        [/``rel_residual_per_head``][/solver extras]/``time_s`` — the JAX
        package's keys in its order), appends it to
        :attr:`history`, emits the canonical event when enabled, and returns
        the history dict so callers can reuse it (callbacks).
        """
        rec: dict = {"iter": int(it), "rel_residual": float(rel_residual)}
        if rel_residual_per_head is not None:
            rec["rel_residual_per_head"] = rel_residual_per_head
        rec.update(extras)
        rec["time_s"] = float(time_s)
        self.history.append(rec)

        if self._sink is not NULL_SINK:
            event: dict = {
                "type": "trace",
                "solver": self.solver,
                "iter": int(it),
                "wall_s": float(time_s),
                "rel_residual": float(rel_residual),
            }
            if rel_residual_per_head is not None:
                event["rel_residual_per_head"] = [
                    float(v) for v in rel_residual_per_head
                ]
            if self.sweep_counter is not None and self.n:
                event["sweeps"] = self.sweep_counter.pairs / float(self.n) ** 2
            if self.precision is not None:
                event["precision"] = self.precision
            for k, v in extras.items():
                event[k] = float(v) if isinstance(v, (int, float)) else v
            self._sink.emit(event)
        return rec


def validate_event(event: dict) -> None:
    """Strictly validate one event dict against :data:`SCHEMAS`.

    Raises ``ValueError`` on an unknown ``type``, a missing required field,
    or any field outside required ∪ optional — CI runs every emitted JSONL
    line through this, so schema drift fails loudly.
    """
    etype = event.get("type")
    schema = SCHEMAS.get(etype)
    if schema is None:
        raise ValueError(f"unknown event type: {etype!r} in {event!r}")
    keys = set(event)
    missing = schema["required"] - keys
    if missing:
        raise ValueError(f"{etype} event missing fields {sorted(missing)}: {event!r}")
    unknown = keys - schema["required"] - schema["optional"]
    if unknown:
        raise ValueError(f"{etype} event has unknown fields {sorted(unknown)}: {event!r}")


def validate_jsonl(path: str) -> dict[str, int]:
    """Validate every line of a telemetry JSONL file.

    Returns ``{event_type: count}`` on success; raises ``ValueError`` (with
    the offending line number) on the first malformed or schema-violating
    line.  An empty file validates to ``{}``.
    """
    counts: dict[str, int] = {}
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                event = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: not valid JSON: {e}") from e
            try:
                validate_event(event)
            except ValueError as e:
                raise ValueError(f"{path}:{lineno}: {e}") from e
            counts[event["type"]] = counts.get(event["type"], 0) + 1
    return counts
