"""KRR solve launcher — the port of ``repro.launch.krr_solve`` for every
single-device method (askotch, skotch, pcg-nystrom, pcg-rpcholesky,
pcg-rff, cg, falkon, eigenpro, direct).

    PYTHONPATH=src python -m repro_torch.launch.krr_solve --n 20000 --d 9 \\
        --method askotch --iters 300 [--device cpu]

    # one-vs-all multi-class: t heads solved in ONE multi-RHS pass
    PYTHONPATH=src python -m repro_torch.launch.krr_solve --dataset one-vs-all \\
        --classes 8 --method askotch

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
    ap.add_argument("--seed", type=int, default=0)
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
    tel = None
    if args.telemetry:
        tel = Telemetry(jsonl=args.telemetry)
        kw["telemetry"] = tel
    out = solve_any(prob, args.method, **kw)
    if tel is not None:
        tel.close()  # flush metric events after the solve span closes
    info = {"method": args.method, **out.info}
    if args.method == "falkon":  # inducing-point weights: full-K residual undefined
        rel, rel_heads = -1.0, None
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
            report["rel_residual_per_head"] = rel_heads.tolist()
        report["test_acc_per_head"] = mh.accuracy.tolist()
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
