"""Summary CLI for telemetry JSONL files — the port of ``repro.obs.report``:

    PYTHONPATH=src python -m repro_torch.obs.report RUN.jsonl [...]

Validates every line against the strict schemas in ``repro_torch.obs.trace`` (so
CI can use this as its schema gate), then prints a human summary per file:
event counts by type, the slowest top-level spans, per-solver trace
convergence (first/last rel_residual, iterations, wall), and the metric
snapshot embedded at close.  ``--no-validate`` skips the schema gate for
quick looks at partial files.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.trace import validate_jsonl

__all__ = ["main", "summarize"]


def _load(path: str) -> list[dict]:
    events = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return events


def summarize(path: str) -> dict:
    """Structured summary of one telemetry JSONL file.

    Returns ``{"path", "counts", "spans", "traces", "metrics"}`` where
    ``spans`` lists the top spans by duration, ``traces`` maps solver name
    to {iters, first/last rel_residual, wall_s}, and ``metrics`` is the
    flushed end-of-run snapshot.
    """
    events = _load(path)
    counts: dict[str, int] = {}
    for e in events:
        counts[e.get("type", "?")] = counts.get(e.get("type", "?"), 0) + 1

    spans = sorted(
        (e for e in events if e.get("type") == "span"),
        key=lambda e: -e.get("dur_s", 0.0),
    )[:10]
    span_rows = [
        {"name": e["name"], "dur_s": e["dur_s"], "cpu_s": e["cpu_s"],
         "depth": e["depth"], "thread": e["thread"]}
        for e in spans
    ]

    traces: dict[str, dict] = {}
    for e in events:
        if e.get("type") != "trace":
            continue
        t = traces.setdefault(e["solver"], {
            "iters": 0, "first_rel_residual": e["rel_residual"],
            "last_rel_residual": e["rel_residual"], "wall_s": 0.0,
        })
        t["iters"] += 1
        t["last_rel_residual"] = e["rel_residual"]
        t["wall_s"] = max(t["wall_s"], e["wall_s"])
        if "sweeps" in e:
            t["sweeps"] = e["sweeps"]

    metrics = {}
    for e in events:
        if e.get("type") == "metric":
            key = e["name"]
            if e.get("labels"):
                inner = ",".join(f'{k}="{v}"' for k, v in sorted(e["labels"].items()))
                key = f"{key}{{{inner}}}"
            metrics[key] = e["value"]

    return {"path": path, "counts": counts, "spans": span_rows,
            "traces": traces, "metrics": metrics}


def _print_summary(s: dict) -> None:
    print(f"== {s['path']}")
    print("  events: " + ", ".join(
        f"{k}={v}" for k, v in sorted(s["counts"].items())) or "  (empty)")
    if s["spans"]:
        print("  slowest spans:")
        for row in s["spans"][:5]:
            print(f"    {row['dur_s']:9.4f}s cpu {row['cpu_s']:8.4f}s  "
                  f"{'  ' * row['depth']}{row['name']}  [{row['thread']}]")
    for solver, t in sorted(s["traces"].items()):
        extra = f", sweeps={t['sweeps']:.2f}" if "sweeps" in t else ""
        print(f"  trace[{solver}]: {t['iters']} iters, rel_residual "
              f"{t['first_rel_residual']:.3e} -> {t['last_rel_residual']:.3e}, "
              f"wall {t['wall_s']:.3f}s{extra}")
    if s["metrics"]:
        print("  metrics:")
        for k, v in sorted(s["metrics"].items()):
            print(f"    {k} = {v:g}")


def main(argv=None) -> int:
    """Entry point: validate (by default) and summarize each given file.

    Returns a nonzero exit code if any file fails schema validation.
    """
    ap = argparse.ArgumentParser(
        prog="obs-report", description="Summarize repro telemetry JSONL files."
    )
    ap.add_argument("paths", nargs="+", help="telemetry .jsonl files")
    ap.add_argument("--no-validate", action="store_true",
                    help="skip strict schema validation")
    args = ap.parse_args(argv)

    rc = 0
    for path in args.paths:
        if not args.no_validate:
            try:
                counts = validate_jsonl(path)
            except (OSError, ValueError) as e:
                print(f"== {path}\n  SCHEMA FAIL: {e}", file=sys.stderr)
                rc = 1
                continue
            print(f"== schema OK: {path} ({sum(counts.values())} events)")
        _print_summary(summarize(path))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
