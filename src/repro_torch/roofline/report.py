"""Turn the dry run's JSON files into the §Dry-run / §Roofline tables — the
port of ``repro.roofline.report``.  Every figure is a prediction for H100s
(``roofline.hw``): memory against a card's 80 GB, terms at its peaks.

    PYTHONPATH=src python -m repro_torch.roofline.report results/dryrun_torch
"""

from __future__ import annotations

import glob
import json
import os
import sys

from repro_torch.roofline import analyze, hw


def load(out_dir: str) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def _fmt_bytes(b: float) -> str:
    return f"{b / 2**30:.2f}"


def _cost(rec: dict) -> dict | None:
    return rec.get("cost_extrapolated") or rec.get("cost_raw")


def _terms(rec: dict) -> dict | None:
    cost = _cost(rec)
    if not cost:
        return None
    c = analyze.CellCost(
        flops=cost["flops"], bytes_accessed=cost["bytes_accessed"],
        coll_bytes=cost["coll_bytes"] or 0.0, coll_breakdown=cost.get("coll_breakdown", {}),
    )
    terms = analyze.roofline_terms(c, analyze.peak_for(rec.get("compute_dtype", "")))
    if cost["coll_bytes"] is None:  # not counted: no term, no dominance
        terms["collective_s"] = None
    return terms


def dryrun_table(recs: list[dict], mesh: str) -> str:
    rows = [
        f"| arch | shape | status | arg GiB/dev | temp GiB/dev | fits {hw.HBM_BYTES / 1e9:.0f} GB "
        "| top collectives |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("mesh") != mesh:
            continue
        if r["status"] != "ok":
            rows.append(
                f"| {r['arch']} | {r['shape']} | {r['status']} | — | — | — | "
                f"{r.get('reason', r.get('error', ''))[:60]} |"
            )
            continue
        mem = r["memory"]
        total = mem["argument_bytes"] + mem["temp_bytes"]
        fits = "yes" if total <= hw.HBM_BYTES else f"no ({total / 1e9:.1f} GB)"
        cost = _cost(r) or {}
        if cost.get("coll_bytes") is None:
            coll_s = "not counted"
        else:
            top = sorted(cost.get("coll_breakdown", {}).items(), key=lambda kv: -kv[1])[:2]
            coll_s = "; ".join(f"{k}:{v/2**20:.0f}M" for k, v in top if v > 0) or "none"
        rows.append(
            f"| {r['arch']} | {r['shape']} | ok | {_fmt_bytes(mem['argument_bytes'])} "
            f"| {_fmt_bytes(mem['temp_bytes'])} | {fits} | {coll_s} |"
        )
    return "\n".join(rows)


def roofline_table(recs: list[dict]) -> str:
    rows = [
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "MODEL_FLOPS/FLOPS |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("mesh") != "single" or r["status"] != "ok":
            continue
        t = _terms(r)
        if t is None:
            continue
        total = _cost(r)["flops"] * hw.SINGLE_POD_CHIPS
        ratio = r.get("model_flops_total", 0) / total if total else 0.0
        coll = "—" if t["collective_s"] is None else f"{t['collective_s']:.4f}"
        rows.append(
            f"| {r['arch']} | {r['shape']} | {t['compute_s']:.4f} | "
            f"{t['memory_s']:.4f} | {coll} | {t['dominant']} | {ratio:.2f} |"
        )
    return "\n".join(rows)


def main() -> None:
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun_torch"
    recs = load(out_dir)
    print(f"## §Dry-run (single-pod 16x16, {hw.SINGLE_POD_CHIPS} H100s; predictions)\n")
    print(dryrun_table(recs, "single"))
    print(f"\n## §Dry-run (multi-pod 2x16x16, {hw.MULTI_POD_CHIPS} H100s; predictions)\n")
    print(dryrun_table(recs, "multi"))
    print("\n## §Roofline (single-pod, per-device terms; predictions)\n")
    print(roofline_table(recs))


if __name__ == "__main__":
    main()
