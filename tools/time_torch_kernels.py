#!/usr/bin/env python3
"""Time the port's CUDA kernels at the main path's shapes on the card.

    PYTHONPATH=src python3 tools/time_torch_kernels.py [--label NAME] [--quick]

``kernel_matvec`` at (50,000 x 10^6, d = 9, t = 1) and ``kernel_block`` at
(50,000 x 50,000, d = 9), rbf, f32, on the operands of ``chip_smoke.py``'s
``main_path_inputs``, and ``kernel_matvec`` for 10^4 queries (the solve's
prediction) and for 64 (one block: the small-m case) against the 10^6 rows;
the weighted matvec ``kernel_matvec_multi`` (rbf + laplacian + matern52,
(q,) weights (0.665, 0.021, 0.314): the combination the tune of
``chip_smoke.py`` picks for the refit) at t = 1 on the same operands: the
refit's G_B (50,000 x 10^6) and its prediction (10^4 x 10^6); and the
weighted matvec
``kernel_matvec_multi`` on the first 20,000 of those rows (rbf + laplacian
+ matern52) at the widths its callers send: the tune's ``matvec_cols`` in
``chip_smoke.py`` (160 columns), the ``krr_tune`` launcher's default tune
(120 columns), both with per-column Dirichlet weights from seed 0, and a
Nystrom sketch of rank 100 with (q,) weights.  Each weighted-matvec time is
printed beside its bound (``chip_smoke._bound_multi``).  Also the stacked
matvec at the tune's sketch (20,000^2 x 100) and the weighted block at the
refit's K_BB (50,000^2): as the refit calls it (b is a: the symmetric path),
with b a copy of a (the full path) and for rbf alone.  ``--quick`` times only
the column path, the stacked matvec and the weighted block.  ``t1_parts_ms`` prices the parts of the t = 1
sweep at the solve's G_B, sigma 1: ``kernel_matvec`` per map (rbf f32 and
bf16, laplacian, matern52, linear, cosine) and the weighted matvec with
equal (q,) weights per combination (rbf, laplacian, matern52 alone,
rbf + matern52, rbf + laplacian, all three in f32 and bf16): the
differences between rows price a family's sum (laplacian's |a - b|
against rbf's a.b) and a map (matern52 over rbf).  ``kernel_matvec_cols``
times ``kernel_matvec`` at t > 1 on the solve's G_B operands (50,000 x
10^6) with t = 2, 4, 8, 10, 16, 17, 20, 24, 25 and 32 (a one-vs-all G_B: the
multi-column sweep at each width and one past the width below) and 100
(pcg-nystrom's sketch width: the column path), each beside its bound
(``chip_smoke._bound``); ``--quick`` keeps these rows and ``--matvec-t``
sets the widths.  ``tune_cg_ms`` times it at the single-kernel tune's CG
apply (the 20,000 tune rows, 4 lams x 5 folds = 20 columns).
``multi_heads`` times the weighted matvec with the refit's (q,) weights
at a multi-kernel one-vs-all G_B (50,000 x 10^6) with t = 2, 10 and 16
heads (the weighted heads), each beside its bound.
``serve_ms`` times the serving buckets against the 10^6 rows (the sweeps
split n over the grid up to 4096 rows): ``kernel_matvec`` at 8, 64 and
1024 queries, the weighted matvec at 64, ``kernel_matvec`` at t = 10
for 8, 64 and 1024 and the weighted matvec at t = 10 (the refit's
weights) for 8, 64 and 1024.
``--digests`` adds the sha256 of the output
of each multi-kernel call timed, of ``kernel_matvec`` at G_B, the
prediction and the residual pass (10^6 x 10^6), at each ``--matvec-t``
width, of the weighted matvec's residual pass, and of the serving buckets,
so two trees' outputs are compared bitwise from their two lines.  Timing is
``chip_smoke._time_ms`` (CUDA events), median of ``--reps`` (7) after one
warm-up, the card kept busy while each call is enqueued (as phase time
does), so a short call's time is the card's, not the host's.
``kernel_block_rows`` (``--block-only`` times only these, with the
weighted block for rbf alone) times ``kernel_block`` at the shapes its
paths give it, rbf, f32 unless named: K_BB (50,000^2) with b the same
tensor as a (the symmetric route), with b a copy and in bf16; Falkon's
K_mm (20,000^2, b the same tensor); the RPCholesky pivot column (10^6 x 1)
and SAP's row (1 x 20,000); and K_BB at d = 1 with the linear kernel (b the
same tensor: the least pair work the route can do, so its time is the
stores').  The K_BB and K_mm rows carry ``write_floor_ms``, the time of
``fill_(0.5)`` on the output each timed launch returned, rep by rep
between the launches (``chip_smoke.time_with_floor_ms``): what a pass that
only stores reaches on this card in the same allocation, and
``floor_ratio``, ms over it, both from the one run.  ``kbb_symmetric`` says
whether K_BB (rbf) and a (1000, 1000) K(A, A) of every kernel in f32 and
bf16 are bitwise their own transposes.  ``--crossover`` times each forced
route of ``kernel_block`` at few columns and few rows (the skinny routes
against the tile route at 10^6 rows), from which the library's limit
``kernel_block.skinny_max()`` is set.
``--tune-only`` times only the single-kernel tune of ``chip_smoke.py``'s
phase estimators end to end (``tune_s``: the first 20,000 taxi rows, rbf,
sigmas 0.5 / 1 / 2, each one stacked CG over 4 lams x 5 folds = 20
columns, 200 iterations at most; host clock after a synchronise, median
of ``--reps`` after one warm-up run), with its sweeps and best config.
Prints one JSON line.  Whichever ``repro_torch`` is first on ``PYTHONPATH``
is timed, so two versions are compared by alternating runs within one
session (A, B, B, A).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

# ops first: in older trees a wrapper module imported first hit a circular
# import through repro_torch.core, so A/B runs against them import it first
from repro_torch.kernels import ops  # noqa: E402, F401
from repro_torch.kernels.kernel_block import kernel_block_cuda  # noqa: E402
from repro_torch.kernels.kernel_matvec import kernel_matvec_cuda  # noqa: E402
from repro_torch.kernels.multi import (  # noqa: E402
    kernel_block_multi_cuda,
    kernel_matvec_components_cuda,
    kernel_matvec_multi_cuda,
)

#: the refit's (rbf, laplacian, matern52) weights: the tune's best in
#: chip_smoke.py, rounded
REFIT_WEIGHTS = (0.665, 0.021, 0.314)

#: kernel_matvec's widths at t > 1: one-vs-all G_Bs of 2 to 32 heads (the
#: multi-column sweep at each width and one past the width below it; 20:
#: the single-kernel tune's 4 lams x 5 folds) and pcg-nystrom's rank-100
#: sketch (the column path)
MATVEC_T = (2, 4, 8, 10, 16, 17, 20, 24, 25, 32, 100)
#: the weighted heads' widths: multi-kernel one-vs-all G_Bs of 2, 10 and 16
#: heads
MULTI_HEADS_T = (2, 10, 16)


def sha256_of(x: torch.Tensor) -> str:
    """sha256 of a tensor's bytes, copied to the host 4096 rows at a time."""
    h = hashlib.sha256()
    for i in range(0, x.shape[0], 4096):
        h.update(x[i:i + 4096].contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--quick", action="store_true",
                    help="only the column paths, the stacked matvec and the weighted block")
    ap.add_argument("--digests", action="store_true",
                    help="add the sha256 of each multi-kernel call's output")
    ap.add_argument("--matvec-t", default=",".join(map(str, MATVEC_T)),
                    help="kernel_matvec's widths t > 1, comma-separated")
    ap.add_argument("--block-only", action="store_true",
                    help="only kernel_block's rows, the write floor and the weighted block (rbf)")
    ap.add_argument("--crossover", action="store_true",
                    help="time kernel_block's forced routes at few columns / rows")
    ap.add_argument("--tune-only", action="store_true",
                    help="only the single-kernel tune of chip_smoke's phase estimators")
    ap.add_argument("--reps", type=int, default=7,
                    help="timed launches of each call, after one warm-up (the median is kept)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_torch_kernels: needs a CUDA card")
    if args.tune_only:
        finish({"label": args.label, "tune_s": time_tune(args.reps)}, {}, False)
        return
    x, xb, z = chip_smoke.main_path_inputs()
    q = xb[:chip_smoke.SMALL_M].contiguous()

    def median_ms(fn):
        return chip_smoke._time_ms(fn, reps=args.reps, hold=True)

    ks = chip_smoke.MK_KERNELS
    sg = (1.0,) * len(ks)
    w_refit = REFIT_WEIGHTS
    xq = xb[:chip_smoke.N_TEST].contiguous()
    report = {"label": args.label}
    calls = {}  # label -> the call, for --digests
    report["kernel_block_rows"] = block_rows(x, xb, median_ms, calls, args.reps)
    report["kbb_symmetric"] = block_symmetry(xb)
    if args.crossover:
        report["kernel_block_crossover"] = block_crossover(x, median_ms)
    if args.block_only:
        report["kernel_block_multi_rbf_ms"] = median_ms(lambda: kernel_block_multi_cuda(
            xb, xb, kernels=("rbf",), sigmas=(1.0,), weights=(1.0,), precision="f32"))
        finish(report, calls, args.digests)
        return
    mv_cols = {}
    gen_mv = torch.Generator(device="cuda").manual_seed(16)
    for t in (int(x) for x in args.matvec_t.split(",")):
        vt = torch.randn((x.shape[0], t), generator=gen_mv, device="cuda")
        calls[f"kernel_matvec t{t}"] = fn = (
            lambda vt=vt: kernel_matvec_cuda(xb, x, vt, kernel="rbf", sigma=1.0, precision="f32"))
        ms = median_ms(fn)
        bound = chip_smoke._bound(xb.shape[0], x.shape[0], chip_smoke.D, t)
        mv_cols[f"t{t}"] = {"t": t, "ms": ms, "bound_ms": bound["bound_ms"]}
    report["kernel_matvec_cols"] = mv_cols
    xt = x[:chip_smoke.N_TUNE]
    t_cg = len(chip_smoke.TUNE_LAMS) * chip_smoke.K_FOLDS
    v_cg = torch.randn((xt.shape[0], t_cg), generator=gen_mv, device="cuda")
    calls["kernel_matvec tune cg"] = fn = (
        lambda: kernel_matvec_cuda(xt, xt, v_cg, kernel="rbf", sigma=1.0, precision="f32"))
    report["tune_cg_ms"] = {"t": t_cg, "ms": median_ms(fn), "bound_ms": chip_smoke._bound(
        xt.shape[0], xt.shape[0], chip_smoke.D, t_cg)["bound_ms"]}
    heads = {}
    for t in MULTI_HEADS_T:
        vt = torch.randn((x.shape[0], t), generator=gen_mv, device="cuda")
        calls[f"multi heads t{t}"] = fn = (
            lambda vt=vt: kernel_matvec_multi_cuda(xb, x, vt, w_refit, kernels=ks, sigmas=sg,
                                                   precision="f32"))
        bound = chip_smoke._bound_multi(xb.shape[0], x.shape[0], chip_smoke.D, t, ks, "matvec")
        heads[f"t{t}"] = {"t": t, "ms": median_ms(fn), "bound_ms": bound["bound_ms"]}
    report["multi_heads"] = heads
    calls["kernel_matvec G_B"] = lambda: kernel_matvec_cuda(xb, x, z, kernel="rbf", sigma=1.0,
                                                            precision="f32")
    calls["kernel_matvec prediction"] = lambda: kernel_matvec_cuda(
        xq, x, z, kernel="rbf", sigma=1.0, precision="f32")
    calls["kernel_matvec residual"] = lambda: kernel_matvec_cuda(
        x, x, z, kernel="rbf", sigma=1.0, precision="f32")
    calls["multi t1 residual"] = lambda: kernel_matvec_multi_cuda(
        x, x, z, w_refit, kernels=ks, sigmas=sg, precision="f32")
    # the serving buckets: split over n at t = 1
    z10 = torch.randn((x.shape[0], 10), generator=gen_mv, device="cuda")
    serve = {f"mv m{m}": (lambda m=m: kernel_matvec_cuda(xb[:m], x, z, kernel="rbf", sigma=1.0,
                                                         precision="f32"))
             for m in (8, chip_smoke.SMALL_M, 1024)}
    serve[f"multi m{chip_smoke.SMALL_M}"] = lambda: kernel_matvec_multi_cuda(
        q, x, z, w_refit, kernels=ks, sigmas=sg, precision="f32")
    serve.update({f"mv t10 m{m}": (lambda m=m: kernel_matvec_cuda(
        xb[:m], x, z10, kernel="rbf", sigma=1.0, precision="f32")) for m in (8, chip_smoke.SMALL_M, 1024)})
    serve.update({f"multi t10 m{m}": (lambda m=m: kernel_matvec_multi_cuda(
        xb[:m], x, z10, w_refit, kernels=ks, sigmas=sg, precision="f32"))
        for m in (8, chip_smoke.SMALL_M, 1024)})
    report["serve_ms"] = {label: median_ms(fn) for label, fn in serve.items()}
    calls.update({f"serve {label}": fn for label, fn in serve.items()})
    if not args.quick:
        report["kernel_matvec_ms"] = median_ms(
            lambda: kernel_matvec_cuda(xb, x, z, kernel="rbf", sigma=1.0, precision="f32"))
        report["kernel_block_ms"] = median_ms(
            lambda: kernel_block_cuda(xb, xb, kernel="rbf", sigma=1.0, precision="f32"))
        report["kernel_matvec_predict_ms"] = median_ms(
            lambda: kernel_matvec_cuda(xq, x, z, kernel="rbf", sigma=1.0, precision="f32"))
        report["kernel_matvec_m64_ms"] = median_ms(
            lambda: kernel_matvec_cuda(q, x, z, kernel="rbf", sigma=1.0, precision="f32"))
    t1 = {}
    for label, rows in (() if args.quick else (("refit_gb", xb), ("refit_predict", xq))):
        calls[f"multi t1 {label}"] = fn = (
            lambda rows=rows: kernel_matvec_multi_cuda(rows, x, z, w_refit, kernels=ks, sigmas=sg,
                                                       precision="f32"))
        ms = median_ms(fn)
        bound = chip_smoke._bound_multi(rows.shape[0], x.shape[0], chip_smoke.D, 1, ks, "matvec")
        t1[label] = {"m": rows.shape[0], "ms": ms, "bound_ms": bound["bound_ms"]}
    gen = torch.Generator(device="cuda").manual_seed(5)
    cols = {}
    # (label, columns, per-column weights): chip_smoke's tune, the launcher's
    # default tune (8 weights x 3 lams x 5 folds) and a rank-100 sketch
    for label, t, per_column in (("tune160", 160, True), ("launcher120", 120, True),
                                 ("sketch100", chip_smoke.RANK, False)):
        w = (torch.from_numpy(np.random.default_rng(0).dirichlet(np.ones(len(ks)), size=t)
                              .T.astype(np.float32)).cuda() if per_column
             else tuple(float(x) for x in np.random.default_rng(0).dirichlet(np.ones(len(ks)))))
        vc = torch.randn((chip_smoke.N_TUNE, t), generator=gen, device="cuda")
        calls[f"multi cols {label}"] = fn = (
            lambda vc=vc, w=w: kernel_matvec_multi_cuda(xt, xt, vc, w, kernels=ks,
                                                        sigmas=(1.0,) * len(ks), precision="f32"))
        ms = median_ms(fn)
        bound = chip_smoke._bound_multi(chip_smoke.N_TUNE, chip_smoke.N_TUNE, chip_smoke.D, t, ks,
                                        "cols" if per_column else "matvec")
        cols[label] = {"t": t, "ms": ms, "bound_ms": bound["bound_ms"]}
    omega = torch.randn((chip_smoke.N_TUNE, chip_smoke.RANK), generator=gen, device="cuda")
    calls["components"] = lambda: kernel_matvec_components_cuda(xt, xt, omega, kernels=ks,
                                                                sigmas=sg, precision="f32")
    comp_ms = median_ms(calls["components"])
    calls["block_multi"] = lambda: kernel_block_multi_cuda(xb, xb, kernels=ks, sigmas=sg,
                                                           weights=w_refit, precision="f32")
    blk_multi_ms = median_ms(calls["block_multi"])
    xb_copy = xb.clone()
    calls["block_multi copy"] = lambda: kernel_block_multi_cuda(xb, xb_copy, kernels=ks, sigmas=sg,
                                                                weights=w_refit, precision="f32")
    blk_copy_ms = median_ms(calls["block_multi copy"])
    blk_rbf_ms = median_ms(lambda: kernel_block_multi_cuda(xb, xb, kernels=("rbf",), sigmas=(1.0,),
                                                           weights=(1.0,), precision="f32"))
    parts = {}
    for k, precs in (() if args.quick else
                     (("rbf", ("f32", "bf16")), ("laplacian", ("f32",)), ("matern52", ("f32",)),
                      ("linear", ("f32",)), ("cosine", ("f32",)))):
        for prec in precs:
            parts[f"mv {k} {prec}"] = median_ms(
                lambda: kernel_matvec_cuda(xb, x, z, kernel=k, sigma=1.0, precision=prec))
    for kk, precs in (() if args.quick else
                      ((("rbf",), ("f32",)), (("laplacian",), ("f32",)), (("matern52",), ("f32",)),
                       (("rbf", "matern52"), ("f32",)), (("rbf", "laplacian"), ("f32",)),
                       (ks, ("f32", "bf16")))):
        w = tuple(1.0 / len(kk) for _ in kk)
        for prec in precs:
            parts[f"multi {'+'.join(kk)} {prec}"] = median_ms(
                lambda: kernel_matvec_multi_cuda(xb, x, z, w, kernels=kk, sigmas=(1.0,) * len(kk),
                                                 precision=prec))
    report.update({"kernel_matvec_multi_t1": t1, "kernel_matvec_multi_cols": cols,
                   "kernel_matvec_components_ms": comp_ms, "kernel_block_multi_ms": blk_multi_ms,
                   "kernel_block_multi_copy_ms": blk_copy_ms, "kernel_block_multi_rbf_ms": blk_rbf_ms,
                   "t1_parts_ms": parts})
    finish(report, calls, args.digests)


def finish(report: dict, calls: dict, digests: bool) -> None:
    """Add the card's line and, with ``digests``, each call's sha256; print."""
    report["card"] = chip_smoke.nvidia_smi_line()
    if digests:
        report["digests"] = {}
        for label, fn in calls.items():
            out = fn()
            report["digests"][label] = sha256_of(out)
            del out
            torch.cuda.empty_cache()
    print(json.dumps(report))


def block_rows(x, xb, median_ms, calls: dict, reps: int) -> dict:
    """kernel_block at its paths' shapes (rbf, sigma 1) beside its bound,
    the K_BB and K_mm rows beside the write floor of their own output;
    fills ``calls`` for digests."""
    blk = lambda a, b, prec="f32": (lambda: kernel_block_cuda(  # noqa: E731
        a, b, kernel="rbf", sigma=1.0, precision=prec))
    gen = torch.Generator(device="cuda").manual_seed(13)
    xm = x.index_select(0, torch.randperm(x.shape[0], generator=gen, device="cuda")
                        [:chip_smoke.FALKON_M])
    xt = x[:chip_smoke.N_TUNE]
    x1 = xb[:, :1].contiguous()
    b = xb.shape[0]
    cases = {  # label -> (call, (m, n, d), with the write floor)
        "kbb same": (blk(xb, xb), (b, b, chip_smoke.D), True),
        "kbb copy": (blk(xb, xb.clone()), (b, b, chip_smoke.D), True),
        "kbb bf16": (blk(xb, xb, "bf16"), (b, b, chip_smoke.D), True),
        "kbb same d1 linear": (lambda: kernel_block_cuda(x1, x1, kernel="linear", sigma=1.0,
                                                         precision="f32"), (b, b, 1), True),
        "falkon kmm": (blk(xm, xm), (xm.shape[0], xm.shape[0], chip_smoke.D), True),
        "pivot column": (blk(x, xb[:1].contiguous()), (x.shape[0], 1, chip_smoke.D), False),
        "sap row": (blk(xt[7:8].contiguous(), xt), (1, xt.shape[0], chip_smoke.D), False),
    }
    rows = {}
    for label, (fn, (m, n, d), floor) in cases.items():
        calls[f"kernel_block {label}"] = fn
        rows[label] = {"shape": [m, n, d],
                       "bound_ms": chip_smoke._bound(m, n, d, None)["bound_ms"]}
        if floor:
            ms, fl = chip_smoke.time_with_floor_ms(fn, reps=reps)
            rows[label].update(ms=ms, write_floor_ms=fl, floor_ratio=ms / fl)
        else:
            rows[label]["ms"] = median_ms(fn)
        torch.cuda.empty_cache()
    return rows


def block_symmetry(xb) -> dict:
    """Whether K(A, A) is bitwise its own transpose: K_BB (rbf, f32), and
    every kernel in f32 and bf16 at (1000, 1000), d = 37."""
    from repro_torch.core.kernels import KERNEL_NAMES

    k = kernel_block_cuda(xb, xb, kernel="rbf", sigma=1.0, precision="f32")
    same = all(torch.equal(k[i:i + 4096], k[:, i:i + 4096].T) for i in range(0, k.shape[0], 4096))
    del k
    torch.cuda.empty_cache()
    a = torch.randn((1000, 37), generator=torch.Generator(device="cuda").manual_seed(3),
                    device="cuda") / 37 ** 0.5
    small = {f"{kern} {prec}": torch.equal(kk, kk.T) for kern in KERNEL_NAMES
             for prec in ("f32", "bf16")
             for kk in [kernel_block_cuda(a, a, kernel=kern, sigma=1.5, precision=prec)]}
    return {"kbb_rbf_f32": same, "d37": small}


def time_tune(reps: int) -> dict:
    """Seconds of the single-kernel tune of chip_smoke's phase estimators
    (median of ``reps`` after one warm-up run), its sweeps and best."""
    import statistics
    import time

    from repro_torch.core.krr import KRRProblem
    from repro_torch.core.solver_api import tune

    x, y = chip_smoke.taxi_data()
    xs, ys = x[:chip_smoke.N_TUNE], y[:chip_smoke.N_TUNE]
    # the phase's lams: its KernelRidgeCV alphas (n lam) over n
    lams = tuple(chip_smoke.N_TUNE * lam / chip_smoke.N_TUNE for lam in chip_smoke.TUNE_LAMS)

    def run():
        return tune(KRRProblem(x=xs, y=ys, kernel="rbf", precision="f32"),
                    sigmas=chip_smoke.CV_SIGMAS, lams=lams,
                    folds=chip_smoke.K_FOLDS, policy="grid", seed=0, rank=chip_smoke.RANK,
                    max_iters=chip_smoke.TUNE_ITERS, tol=chip_smoke.TUNE_TOL)

    res = run()
    secs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return {"seconds": statistics.median(secs), "all": secs, "sweeps": res.sweeps,
            "best": {k: res.best[k] for k in ("sigma", "lam_unscaled", "cv_mse")}}


#: columns (rows) at which --crossover times the skinny routes against the
#: tile route: 10^6 rows of A (columns of B) against n (m) of them
CROSSOVER_WIDTHS = (1, 2, 4, 8, 16, 24, 32, 48, 64)


def block_crossover(x, median_ms) -> dict:
    """kernel_block's forced routes at few columns (10^6 x n) and few rows
    (m x 10^6), rbf, f32, each beside its bound."""
    from repro_torch.kernels import kernel_block as kb

    out = {}
    for w in CROSSOVER_WIDTHS:
        few = x[:w].contiguous()
        for kind, (a, b), routes in (("cols", (x, few), ("skinny_cols", "tile")),
                                     ("rows", (few, x), ("skinny_rows", "tile"))):
            m, n = a.shape[0], b.shape[0]
            out[f"{kind} {w}"] = {
                **{r: median_ms(lambda a=a, b=b, r=r: kb.launch_route(a, b, kernel="rbf", sigma=1.0,
                                                                      route=r))
                   for r in routes},
                "bound_ms": chip_smoke._bound(m, n, chip_smoke.D, None)["bound_ms"]}
    return out

if __name__ == "__main__":
    main()
