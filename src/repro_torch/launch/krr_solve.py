"""KRR solve launcher — the port of ``repro.launch.krr_solve`` for every
method (askotch, skotch, pcg-nystrom, pcg-rpcholesky, pcg-rff, cg, falkon,
eigenpro, direct, dc).

    PYTHONPATH=src python -m repro_torch.launch.krr_solve --n 20000 --d 9 \\
        --method askotch --iters 300 [--device cpu] [--mesh 1x1]

    # one-vs-all multi-class: t heads solved in ONE multi-RHS pass
    PYTHONPATH=src python -m repro_torch.launch.krr_solve --dataset one-vs-all \\
        --classes 8 --method askotch

    # divide and conquer: 4 local solves, zero collectives
    PYTHONPATH=src python -m repro_torch.launch.krr_solve --method dc \\
        --dc-shards 4 --dc-method pcg-nystrom [--mesh auto]

``--mesh ROWSxMODEL`` (or ``auto``: every visible device of ``--device``'s
type on rows) runs askotch / skotch / pcg-nystrom / cg through
``solve(..., mesh=...)`` on a ``ShardedKernelOperator`` over
``make_solver_mesh(spec, device)``; ``--distributed`` is the deprecated
alias of ``--mesh auto``.  With ``--method dc`` the mesh runs the shards
device-parallel.

``--device`` (default ``cuda``) picks where the data and every kernel sweep
live; ``cuda`` without a card is an error.  The JSON line has the same keys
as the JAX launcher's: ``--iters`` is ``max_iters`` (EigenPro runs
``max(1, iters // 100)`` epochs, direct takes no option), Falkon uses
``m = min(1000, max(50, n // 20), n)`` centers and reports
``rel_residual = -1.0`` (its inducing-point weights have no full-K
residual).  ``--telemetry PATH`` writes the solve's span, trace events and
metrics as JSONL (``repro_torch.obs``; summarize it with
``python -m repro_torch.obs.report PATH``).  TF32 is off for every f32
matmul.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.core.kernels import KERNEL_NAMES
from repro_torch.core.krr import KRRProblem, evaluate, evaluate_per_head
from repro_torch.core.solver_api import solve as solve_any
from repro_torch.data import synthetic
from repro_torch.obs import Telemetry


def main(argv: list[str] | None = None) -> dict:
    """Parse ``argv``, solve, print the JSON report and return it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--d", type=int, default=9)
    ap.add_argument("--n-test", type=int, default=2_000)
    ap.add_argument("--kernel", default="rbf", choices=KERNEL_NAMES,
                    help="kernel zoo name (core.kernels.KERNEL_NAMES)")
    ap.add_argument("--sigma", type=float, default=1.0)
    ap.add_argument("--lam", type=float, default=1e-6)
    ap.add_argument("--precision", default="f32", choices=["f32", "bf16"],
                    help="kernel tile-compute policy: bf16 tiles with f32 "
                         "accumulation, or full f32")
    ap.add_argument("--method", default="askotch")
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--dc-shards", type=int, default=4,
                    help="method=dc: shard count k (k=1 == the plain solver)")
    ap.add_argument("--dc-partition", default="random",
                    choices=["random", "kmeans"],
                    help="method=dc: partitioner (distributed.partition)")
    ap.add_argument("--dc-combiner", default="uniform",
                    choices=["uniform", "softmax"],
                    help="method=dc: prediction combiner (distributed.dc)")
    ap.add_argument("--dc-method", default="askotch",
                    help="method=dc: the inner solver run per shard")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default=None,
                    help="ROWSxMODEL device mesh (e.g. 4x2) or 'auto'; "
                         "runs the solve distributed via ShardedKernelOperator")
    ap.add_argument("--distributed", action="store_true",
                    help="deprecated alias for --mesh auto")
    ap.add_argument("--dataset", default="regression",
                    choices=["regression", "classification", "one-vs-all", "taxi"])
    ap.add_argument("--classes", type=int, default=4,
                    help="number of one-vs-all heads (dataset=one-vs-all)")
    ap.add_argument("--telemetry", default=None, metavar="PATH",
                    help="write telemetry (spans + solver traces + metrics) "
                         "as JSONL to PATH (repro_torch.obs)")
    ap.add_argument("--device", default="cuda",
                    help="torch device for data and kernels (cuda | cpu)")
    args = ap.parse_args(argv)
    mesh_spec = args.mesh if args.mesh is not None else (
        "auto" if args.distributed else None)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = args.device
    if args.dataset == "taxi":
        x, y = synthetic.taxi_like(args.seed, args.n + args.n_test, args.d, device=dev)
        x_tr, y_tr = x[: args.n], y[: args.n]
        x_te, y_te = x[args.n:], y[args.n:]
    elif args.dataset == "one-vs-all":
        x_tr, y_tr, _, x_te, y_te, _labels = synthetic.krr_one_vs_all(
            args.seed, args.n, args.d, num_classes=args.classes,
            n_test=args.n_test, device=dev,
        )
    else:
        gen = (synthetic.krr_classification if args.dataset == "classification"
               else synthetic.krr_regression)
        x_tr, y_tr, x_te, y_te = gen(args.seed, args.n, args.d, args.n_test, device=dev)

    prob = KRRProblem(x=x_tr, y=y_tr, kernel=args.kernel, sigma=args.sigma,
                      lam_unscaled=args.lam, precision=args.precision)

    t0 = time.perf_counter()
    if args.method == "direct":
        kw = {}
    elif args.method == "eigenpro":
        kw = {"epochs": max(1, args.iters // 100)}  # SGD epochs, not iters
    else:
        kw = {"max_iters": args.iters}
    if args.method == "falkon":
        # default center count, clamped so tiny-n runs stay sampleable
        kw["m"] = min(1000, max(50, args.n // 20), args.n)
    if args.method == "dc":
        kw.update(dc_shards=args.dc_shards, dc_partition=args.dc_partition,
                  dc_combiner=args.dc_combiner, dc_method=args.dc_method)
    tel = None
    if args.telemetry:
        tel = Telemetry(jsonl=args.telemetry)
        kw["telemetry"] = tel
    if mesh_spec is not None:
        from repro_torch.distributed.meshes import make_solver_mesh

        mesh = make_solver_mesh(mesh_spec, device=dev)
        out = solve_any(prob, args.method, mesh=mesh, **kw)
        info = {"method": f"{args.method}-distributed", **out.info}
    else:
        out = solve_any(prob, args.method, **kw)
        info = {"method": args.method, **out.info}
    if tel is not None:
        tel.close()  # flush metric events after the solve span closes
    if args.method == "falkon":  # inducing-point weights: full-K residual undefined
        rel, rel_heads = -1.0, None
    elif args.method == "dc":
        # the global residual is undefined for the combined local models;
        # history's aggregate record carries the worst LOCAL shard residual
        rel = out.history[-1].get("rel_residual")
        rel = float(rel) if rel is not None else -1.0
        rel_heads = None
    elif mesh_spec is not None and out.history:
        # the distributed solve already evaluated the residual on the mesh
        rel = out.history[-1]["rel_residual"]
        rel_heads = out.history[-1].get("rel_residual_per_head")
    else:
        rel_agg, rel_heads = prob.residual_report(out.w)
        rel = float(rel_agg)
    pred = out.predict_fn(x_te)
    m = evaluate(pred, y_te)
    report = {
        **info,
        "n": args.n,
        "rel_residual": rel,
        "test_rmse": float(m.rmse),
        "test_mae": float(m.mae),
        "test_acc": float(m.accuracy),
        "seconds": round(time.perf_counter() - t0, 2),
    }
    if args.telemetry:
        report["telemetry"] = args.telemetry
    if prob.t > 1:
        mh = evaluate_per_head(pred, y_te)
        if rel_heads is not None:
            report["rel_residual_per_head"] = [float(v) for v in rel_heads]
        report["test_acc_per_head"] = mh.accuracy.tolist()
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
