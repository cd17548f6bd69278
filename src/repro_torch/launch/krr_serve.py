"""KRR serving launcher: load tuned artifacts, serve traffic, report stats;
the port of ``repro.launch.krr_serve``.

    # tune + refit + export an artifact, then serve it
    PYTHONPATH=src python -m repro_torch.launch.krr_tune --n 2000 --d 6 \\
        --export-artifact /tmp/krr_model [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.krr_serve \\
        --artifact demo=/tmp/krr_model --requests 200 --rate 500 [--device cpu]

    # restore a whole registry from an artifact tree
    PYTHONPATH=src python -m repro_torch.launch.krr_serve \\
        --artifacts-dir /tmp/krr_models --requests 0

Each ``--artifact NAME=DIR`` loads a ``save_model_artifact`` directory (the
``krr_tune --export-artifact`` output of either package) into a
:class:`repro_torch.serving.engine.ServingEngine`; every bucket is warmed at
load.  The launcher then replays open-loop Poisson traffic (request sizes
drawn from 1..``--max-rows``, models drawn uniformly, from ``--seed``)
through the coalescing worker and prints the report JSON with the JAX
launcher's keys: ``loaded``, ``traffic``, ``stats`` (per-model request
counts, qps, p50/p99 latency, bucket occupancy, bucket shapes launched),
``prometheus`` with ``--prometheus`` and ``telemetry`` with
``--telemetry PATH`` (``serve/batch`` spans and metrics as JSONL).

``--device`` (default ``cuda``) picks where the models live and every
bucket runs; ``cuda`` without a card is an error.  ``--mesh ROWSxMODEL``
(or ``auto``) serves every model row-sharded over ``make_solver_mesh(spec,
device)``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.obs import Telemetry
from repro_torch.serving.engine import ServingEngine


def main(argv: list[str] | None = None) -> dict:
    """Parse ``argv``, load, serve, print the report JSON and return it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifact", action="append", default=[],
                    metavar="NAME=DIR",
                    help="load a save_model_artifact directory as NAME "
                         "(repeatable)")
    ap.add_argument("--artifacts-dir", default=None, metavar="DIR",
                    help="restore the whole registry: register every "
                         "artifact subdirectory of DIR under its directory "
                         "name (ServingEngine.load_artifacts_dir)")
    ap.add_argument("--max-batch", type=int, default=1024,
                    help="largest bucket / coalescing drain cap")
    ap.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="coalescing window the worker holds a batch open")
    ap.add_argument("--max-bytes", type=int, default=None,
                    help="registry memory budget (LRU-evicts past it)")
    ap.add_argument("--requests", type=int, default=200,
                    help="simulated requests to replay (0: just load + stats)")
    ap.add_argument("--rate", type=float, default=500.0,
                    help="offered load, requests/s (Poisson arrivals)")
    ap.add_argument("--max-rows", type=int, default=16,
                    help="largest simulated request (rows drawn 1..max-rows)")
    ap.add_argument("--mesh", default=None,
                    help="ROWSxMODEL device mesh (e.g. 4x1) or 'auto': serve "
                         "each model row-sharded over it")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--telemetry", default=None, metavar="PATH",
                    help="write telemetry (serve/batch spans + metrics) "
                         "as JSONL to PATH (repro_torch.obs)")
    ap.add_argument("--prometheus", action="store_true",
                    help="also print the Prometheus text exposition of the "
                         "per-model latency histograms + counters")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the models and every bucket pass (cuda | cpu)")
    args = ap.parse_args(argv)
    if not args.artifact and args.artifacts_dir is None:
        ap.error("pass at least one --artifact NAME=DIR or --artifacts-dir")
    mesh = None
    if args.mesh is not None:
        from repro_torch.distributed.meshes import make_solver_mesh

        mesh = make_solver_mesh(args.mesh, device=args.device)

    tel = Telemetry(jsonl=args.telemetry) if args.telemetry else None
    engine = ServingEngine(max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                           max_bytes=args.max_bytes, telemetry=tel, device=args.device)
    report: dict = {"loaded": {}}
    try:
        if args.artifacts_dir is not None:
            report["loaded"].update(engine.load_artifacts_dir(args.artifacts_dir, mesh=mesh))
        for spec in args.artifact:
            if "=" not in spec:
                ap.error(f"--artifact wants NAME=DIR, got {spec!r}")
            name, path = spec.split("=", 1)
            report["loaded"][name] = engine.load_model(name, path, mesh=mesh)

        if args.requests > 0:
            r = np.random.default_rng(args.seed)
            names = engine.models()
            widths = {n: report["loaded"][n]["d"] for n in names}
            arrivals = np.cumsum(r.exponential(1.0 / args.rate, size=args.requests))
            t0 = time.monotonic()
            futures = []
            for t_arr, name in zip(
                arrivals, (names[int(i)] for i in r.integers(len(names), size=args.requests))
            ):
                lag = t_arr - (time.monotonic() - t0)
                if lag > 0:
                    time.sleep(lag)
                q = int(r.integers(1, args.max_rows + 1))
                xq = r.standard_normal((q, widths[name])).astype(np.float32)
                futures.append(engine.submit(name, xq))
            engine.drain()
            for f in futures:
                f.result()  # surface any serving error
            report["traffic"] = {
                "requests": args.requests,
                "offered_rps": args.rate,
                "seconds": round(time.monotonic() - t0, 3),
            }
        report["stats"] = engine.stats()
        if args.prometheus:
            report["prometheus"] = engine.prometheus_text()
    finally:
        engine.shutdown()
        if tel is not None:
            tel.close()  # flush metric events after the worker stops
            report["telemetry"] = args.telemetry
    print(json.dumps(report, indent=2, default=float))
    return report


if __name__ == "__main__":
    main()
