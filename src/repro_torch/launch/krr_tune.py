"""KRR hyperparameter tuning launcher — tune, refit, evaluate, export; the
port of ``repro.launch.krr_tune``.

    PYTHONPATH=src python -m repro_torch.launch.krr_tune --n 4000 --d 8 \\
        --sigmas 0.5,1.0,2.0 --lams 1e-6,1e-4,1e-2 --folds 5 [--device cpu]

    # multi-kernel: random search over convex kernel combinations
    PYTHONPATH=src python -m repro_torch.launch.krr_tune \\
        --kernels rbf,laplacian,matern52 --n-weight-samples 8

    # successive halving (prune losers mid-solve) + sigma-continuation
    PYTHONPATH=src python -m repro_torch.launch.krr_tune --policy halving \\
        --sigma-continuation --lams 1e-8,1e-6,1e-4,1e-2

The sweep is the tile-sharing path of ``repro_torch.core.tune``
(``--strategy naive`` runs the per-candidate reference loop); ``--kernels``
grows the weight axis.  After the sweep the best config is refit on the
full training set with ``--method`` (default askotch, warm-started from the
winner's fold-averaged CV solution) and scored on held-out test data;
``--export PATH`` writes the best-config JSON with the per-candidate
``trace``; ``--export-artifact DIR`` writes a full serving artifact (the
best config, the training rows and the refit weights: ``config.json`` +
``weights.npz``) that ``repro_torch.launch.krr_serve``, or either
package's ``ServingEngine.load_model``, loads; ``--telemetry PATH`` writes
the search's and the refit's spans, trace events and metrics as JSONL
(``repro_torch.obs``; summarize it with ``python -m repro_torch.obs.report
PATH``).  The JSON line has the JAX
launcher's keys in its order.

``--device`` (default ``cuda``) picks where the data and every kernel sweep
live; ``cuda`` without a card is an error.  ``--mesh ROWSxMODEL`` (or
``auto``) runs the search and the refit over ``make_solver_mesh(spec,
device)`` (the report gains ``mesh``; the refit then starts from zero, as
the reference's does).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.core.kernels import KERNEL_NAMES
from repro_torch.core.krr import KRRProblem, evaluate
from repro_torch.core.solver_api import METHOD_OPTIONS, tune
from repro_torch.core.solver_api import solve as solve_any
from repro_torch.core.tune import apply_best
from repro_torch.data import synthetic
from repro_torch.obs import Telemetry


def main(argv: list[str] | None = None) -> dict:
    """Parse ``argv``, tune (and refit), print the JSON report and return it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4_000)
    ap.add_argument("--d", type=int, default=8)
    ap.add_argument("--n-test", type=int, default=1_000)
    ap.add_argument("--kernel", default="rbf", choices=KERNEL_NAMES,
                    help="kernel zoo name (core.kernels.KERNEL_NAMES)")
    ap.add_argument("--kernels", default=None,
                    help="comma-separated kernel zoo names: tune a convex "
                         "multi-kernel combination (weight random search)")
    ap.add_argument("--n-weight-samples", type=int, default=8,
                    help="Dirichlet weight draws for --kernels search")
    ap.add_argument("--dirichlet-alpha", type=float, default=1.0,
                    help="Dirichlet concentration of the weight draws")
    ap.add_argument("--sigmas", default="0.5,1.0,2.0",
                    help="comma-separated candidate bandwidths")
    ap.add_argument("--lams", default="1e-6,1e-4,1e-2",
                    help="comma-separated candidate unscaled regularizers")
    ap.add_argument("--folds", type=int, default=5)
    ap.add_argument("--search", default="grid", choices=["grid", "random"])
    ap.add_argument("--samples", type=int, default=None,
                    help="random-search candidate count (default: full grid)")
    ap.add_argument("--policy", default=None,
                    choices=["grid", "random", "halving"],
                    help="search policy (supersedes --search); 'halving' "
                         "prunes losing candidates at rungs mid-solve")
    ap.add_argument("--halving-eta", type=float, default=3.0,
                    help="successive-halving reduction factor (> 1)")
    ap.add_argument("--sigma-continuation", action="store_true",
                    help="seed each sigma group's solve + sketch from the "
                         "previous group instead of from zero")
    ap.add_argument("--strategy", default="shared", choices=["shared", "naive"])
    ap.add_argument("--rank", type=int, default=100,
                    help="Nystrom preconditioner rank")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--precision", default="f32", choices=["f32", "bf16"],
                    help="kernel tile-compute policy for the sweep AND the "
                         "refit: bf16 tiles with f32 accumulation, or f32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default=None,
                    help="ROWSxMODEL device mesh (e.g. 4x1) or 'auto'; runs "
                         "the search and the refit over a ShardedKernelOperator")
    ap.add_argument("--dataset", default="regression",
                    choices=["regression", "classification", "one-vs-all", "taxi"])
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--method", default="askotch",
                    help="refit method for the best config")
    ap.add_argument("--refit-iters", type=int, default=300)
    ap.add_argument("--no-refit", action="store_true",
                    help="report the sweep only; skip refit + test metrics")
    ap.add_argument("--export", default=None,
                    help="write the best-config JSON here (serving input)")
    ap.add_argument("--export-artifact", default=None,
                    help="also write a full serving artifact directory here "
                         "(config + training rows + refit weights)")
    ap.add_argument("--telemetry", default=None, metavar="PATH",
                    help="write telemetry (spans + tune traces + metrics) "
                         "as JSONL to PATH (repro_torch.obs)")
    ap.add_argument("--device", default="cuda",
                    help="torch device for data and kernels (cuda | cpu)")
    args = ap.parse_args(argv)
    if args.export_artifact and args.no_refit:
        ap.error("--export-artifact needs the refit weights; drop --no-refit")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = args.device
    if args.dataset == "taxi":
        x, y = synthetic.taxi_like(args.seed, args.n + args.n_test, args.d, device=dev)
        x_tr, y_tr, x_te, y_te = x[: args.n], y[: args.n], x[args.n:], y[args.n:]
    elif args.dataset == "one-vs-all":
        x_tr, y_tr, _, x_te, y_te, _labels = synthetic.krr_one_vs_all(
            args.seed, args.n, args.d, num_classes=args.classes,
            n_test=args.n_test, device=dev,
        )
    else:
        gen = (synthetic.krr_classification if args.dataset == "classification"
               else synthetic.krr_regression)
        x_tr, y_tr, x_te, y_te = gen(args.seed, args.n, args.d, args.n_test, device=dev)

    prob = KRRProblem(x=x_tr, y=y_tr, kernel=args.kernel, precision=args.precision)
    mesh = None
    if args.mesh is not None:
        from repro_torch.distributed.meshes import make_solver_mesh

        mesh = make_solver_mesh(args.mesh, device=dev)

    t0 = time.perf_counter()
    tune_kw = dict(
        sigmas=tuple(float(s) for s in args.sigmas.split(",")),
        lams=tuple(float(lv) for lv in args.lams.split(",")),
        folds=args.folds,
        strategy=args.strategy,
        rank=args.rank,
        max_iters=args.iters,
        tol=args.tol,
        seed=args.seed,
        sigma_continuation=args.sigma_continuation,
    )
    tel = None
    if args.telemetry:
        tel = Telemetry(jsonl=args.telemetry)
        tune_kw["telemetry"] = tel
    if args.policy is not None:
        tune_kw.update(policy=args.policy, halving_eta=args.halving_eta)
    if args.kernels is not None:
        if args.search != "grid" or args.samples is not None:
            ap.error(
                "--search/--samples do not apply with --kernels; the weight "
                "axis IS the random search (use --n-weight-samples, or "
                "--policy halving to prune it)"
            )
        bad = [k for k in args.kernels.split(",") if k not in KERNEL_NAMES]
        if bad:
            ap.error(f"unknown kernel(s) {bad}; available: {KERNEL_NAMES}")
        tune_kw.update(
            kernels=tuple(args.kernels.split(",")),
            n_weight_samples=args.n_weight_samples,
            dirichlet_alpha=args.dirichlet_alpha,
        )
    else:
        tune_kw.update(search=args.search, num_samples=args.samples)
    result = tune(prob, mesh=mesh, **tune_kw)
    report = {
        "best": result.best,
        "strategy": result.strategy,
        "search": result.search,
        "policy": result.info["policy"],
        "candidates": result.info["candidates"],
        "folds": result.folds,
        "kernel_sweeps": round(result.sweeps, 2),
        "naive_sweep_estimate": round(result.info["naive_sweep_estimate"], 2),
        "records": result.records,
        "trace": result.trace,
    }
    if args.kernels is not None:
        report["weight_samples"] = result.info["weight_samples"]
    if mesh is not None:
        report["mesh"] = dict(mesh.shape)

    if not args.no_refit:
        best_prob, w0 = apply_best(prob, result, with_w0=True)
        kw = {"max_iters": args.refit_iters}
        if tel is not None:
            kw["telemetry"] = tel  # the refit rides the same JSONL stream
        if (w0 is not None and mesh is None
                and "w0" in METHOD_OPTIONS.get(args.method, ())):
            # warm-start the refit from the winner's fold-averaged CV
            # solution instead of zero
            kw["w0"] = w0
            report["refit_warm_start"] = True
        out = solve_any(best_prob, args.method, mesh=mesh, **kw)
        m = evaluate(out.predict_fn(x_te), y_te)
        report["refit"] = {
            "method": args.method,
            "test_rmse": float(m.rmse),
            "test_mae": float(m.mae),
            "test_acc": float(m.accuracy),
        }
        if args.export_artifact:
            from repro_torch.serving.engine import save_model_artifact

            # tune -> refit -> artifact: config + training rows + refit
            # weights as files on disk, loadable by either package's engine
            save_model_artifact(args.export_artifact, result.best, x_tr, out.w)
            report["exported_artifact"] = args.export_artifact
    report["seconds"] = round(time.perf_counter() - t0, 2)
    if tel is not None:
        tel.close()  # flush metric events after all spans close
        report["telemetry"] = args.telemetry

    if args.export:
        # the best config PLUS the audit trail
        with open(args.export, "w") as fh:
            json.dump({**result.best, "trace": result.trace}, fh, indent=2)
        report["exported"] = args.export
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
