#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Phases, each printing its own JSON line; any failure exits non-zero:

  1. card    — ``nvidia-smi`` name and power limit, torch / CUDA versions,
               TF32 off for every f32 matmul, and a sha256 of the sources
               this run used (``tree_digest``).
  2. build   — compile every CUDA kernel of the main path from
               ``src/repro_torch/csrc`` (one nvcc per source, in parallel,
               always, so each run prints its ``-Xptxas -v`` lines).
  3. check   — each kernel against its plain PyTorch version on the card:
               7 kernels x {f32, bf16} x {1-D v, t = 8} x d in {9, 37} at
               m = 1000, n = 3001.  Tolerances as the JAX package's kernel
               tests: f32 rtol 2e-4 / atol 2e-5 x max(1, |ref|max); bf16
               rtol 0.05 / atol 0.02 x max(1, |ref|max).
  4. solve   — the main path through ``solver_api.solve("askotch")`` at the
               paper's taxi configuration (d = 9, rbf, sigma = 1,
               lam_unscaled = 2e-7, b = 50,000, r = 100, f32), with n cut
               from 10^8 to 10^6 (+ 10^4 test points): the O(n^2 d) residual
               and the one-card time limit force the cut.  Launch counts
               are zeroed before and read after.  kernel_matvec's other two
               shapes on the path, the prediction (10^4 x 10^6) and the
               residual pass (10^6 x 10^6), are held against the plain
               version in full.
  5. time    — each kernel at the main path's shapes (CUDA events, median
               of 5 after warm-up) beside its plain version and its bound,
               with the kernel's result held against the plain one there;
               also kernel_matvec for 64 queries (the small-m case).
  6. launch  — ``python -m repro_torch.launch.krr_solve --method askotch
               --iters 50`` on cuda; its JSON keys must be the JAX
               launcher's.

It imports nothing of JAX or of the JAX package.  Full build logs go to
``chiprun_out/chip_smoke_build.log``.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

# the paper's taxi configuration (src/repro/configs/askotch_krr.py), n cut
N_TRAIN, N_TEST, D = 1_000_000, 10_000, 9
BLOCK, RANK, SIGMA, LAM_UNSCALED = 50_000, 100, 1.0, 2e-7
MAX_ITERS = 20
SMALL_M = 64  # a few prediction queries: fewer row tiles than SMs

# keys of the JSON line printed by ``python -m repro.launch.krr_solve`` for
# a single-head askotch solve (src/repro/launch/krr_solve.py:151-159)
LAUNCHER_KEYS = [
    "method", "iters", "converged", "wall_time_s", "t", "rel_residual_per_head",
    "n", "rel_residual", "test_rmse", "test_mae", "test_acc", "seconds",
]

TOL = {"f32": (2e-4, 2e-5), "bf16": (0.05, 0.02)}


def rbf_ops_per_pair(d: int, t: int) -> int:
    """f32 operations per (row, column) pair of the main path's rbf kernel:
    the squared distance ||a||^2 + ||b||^2 - 2 a.b (2d + 3: d products and
    sums, two adds, the clamp), the map (scale, exp), then 2 per value column."""
    return 2 * d + 3 + 2 + 2 * t


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def tree_digest() -> str:
    """sha256 over this script and the port's sources (build outputs and
    caches left out), so a run's output names the tree it ran."""
    pkg = SRC / "repro_torch"
    files = [ROOT / "chip_smoke.py"] + sorted(
        p for p in pkg.rglob("*")
        if p.is_file() and p.relative_to(pkg).parts[0] != "build"
        and "__pycache__" not in p.parts
    )
    h = hashlib.sha256()
    for p in files:
        h.update(p.relative_to(ROOT).as_posix().encode() + b"\0" + p.read_bytes())
    return h.hexdigest()


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_card() -> str:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "tree_sha256": tree_digest(),
          "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32})
    return smi


def _ptxas_summary(log: str) -> dict:
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    smem = [int(x) for x in re.findall(r"(\d+) bytes smem", log)]
    spill_st = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", log))
    spill_ld = sum(int(x) for x in re.findall(r"(\d+) bytes spill loads", log))
    return {"entries": len(regs), "registers_min": min(regs, default=None),
            "registers_max": max(regs, default=None), "smem_bytes_max": max(smem, default=None),
            "spill_store_bytes": spill_st, "spill_load_bytes": spill_ld}


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    report = _build.build(["kernel_matvec", "kernel_block"], force=True)
    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / "chip_smoke_build.log", "w") as fh:
        for name, rec in report.items():
            fh.write(f"== {name} ({rec['seconds']:.1f} s)\n{rec['log']}\n")
    for name in ("kernel_matvec", "kernel_block"):
        if not _build.lib_path(name).exists():
            fail(f"lib{name}.so was not built")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libs": {name: {"seconds": rec["seconds"], **_ptxas_summary(rec["log"])}
                   for name, rec in report.items()}})


def _err(got, ref, precision: str) -> tuple[float, bool]:
    """(max |got - ref|, within tolerance), walked in row chunks so a 10 GB
    block needs no full-size temporaries."""
    rtol, atol = TOL[precision]
    scale = max(1.0, float(ref.abs().max()))
    worst, ok = 0.0, got.shape == ref.shape
    for i in range(0, ref.shape[0], 4096):
        g, r = got[i:i + 4096], ref[i:i + 4096]
        diff = (g - r).abs()
        worst = max(worst, float(diff.max()))
        ok = ok and bool((diff <= rtol * r.abs() + atol * scale).all())
    return worst, ok


def phase_check() -> dict:
    import torch

    from repro_torch.core.kernels import KERNEL_NAMES
    from repro_torch.kernels import ref
    from repro_torch.kernels.kernel_block import kernel_block_cuda
    from repro_torch.kernels.kernel_matvec import kernel_matvec_cuda

    m, n, sigma = 1000, 3001, 1.5
    worst = {"kernel_matvec": 0.0, "kernel_block": 0.0}
    gen = torch.Generator().manual_seed(0)
    for d in (9, 37):
        a = (torch.randn((m, d), generator=gen) / math.sqrt(d)).cuda()
        b = (torch.randn((n, d), generator=gen) / math.sqrt(d)).cuda()
        a[3] = 0.0  # a zero row: cosine's zero-norm-as-1 rule
        for t in (1, 8):
            v = torch.randn((n,) if t == 1 else (n, t), generator=gen).cuda()
            for kern in KERNEL_NAMES:
                for prec in ("f32", "bf16"):
                    want = ref.kernel_matvec(a, b, v, sigma, kernel=kern, precision=prec)
                    got = kernel_matvec_cuda(a, b, v, kernel=kern, sigma=sigma, precision=prec)
                    torch.cuda.synchronize()
                    err, ok = _err(got, want, prec)
                    emit({"check": "kernel_matvec", "kernel": kern, "precision": prec,
                          "d": d, "t": t, "max_abs_err": err, "ok": ok})
                    if not ok or got.shape != want.shape:
                        fail(f"kernel_matvec {kern} {prec} d={d} t={t}: err {err}")
                    worst["kernel_matvec"] = max(worst["kernel_matvec"], err)
        for kern in KERNEL_NAMES:
            for prec in ("f32", "bf16"):
                want = ref.kernel_block(a, b, sigma, kernel=kern, precision=prec)
                got = kernel_block_cuda(a, b, kernel=kern, sigma=sigma, precision=prec)
                torch.cuda.synchronize()
                err, ok = _err(got, want, prec)
                emit({"check": "kernel_block", "kernel": kern, "precision": prec,
                      "d": d, "max_abs_err": err, "ok": ok})
                if not ok or got.shape != want.shape:
                    fail(f"kernel_block {kern} {prec} d={d}: err {err}")
                worst["kernel_block"] = max(worst["kernel_block"], err)
    emit({"phase": "check", "m": m, "n": n, "sigma": sigma, "worst_abs_err": worst})
    return worst


def phase_solve() -> dict:
    import torch

    from repro_torch.core.krr import KRRProblem, evaluate
    from repro_torch.core.solver_api import solve
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.kernel_matvec import kernel_matvec_cuda

    x, y = synthetic.taxi_like(0, N_TRAIN + N_TEST, D, device="cuda")
    problem = KRRProblem(x=x[:N_TRAIN], y=y[:N_TRAIN], kernel="rbf", sigma=SIGMA,
                         lam_unscaled=LAM_UNSCALED, precision="f32")
    x_te, y_te = x[N_TRAIN:], y[N_TRAIN:]
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = solve(problem, "askotch", block_size=BLOCK, rank=RANK, max_iters=MAX_ITERS,
                eval_every=MAX_ITERS)
    pred = out.predict_fn(x_te)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches()

    # the history's time_s includes the final O(n^2 d) residual; time one
    # more residual pass to split it from the iterations
    t1 = time.perf_counter()
    problem.residual_report(out.w)[0].item()
    residual_s = time.perf_counter() - t1

    # kernel_matvec's two other shapes on the path, each against the plain
    # version in full: the prediction (ragged last row tile at m = 10^4) and
    # the residual pass's K w (15,625 row tiles), relaunched on the same
    # inputs (the kernel is deterministic)
    pred_err, pred_ok = _err(pred, ref.kernel_matvec(x_te, problem.x, out.w, SIGMA), "f32")
    t2 = time.perf_counter()
    kw_want = ref.kernel_matvec(problem.x, problem.x, out.w, SIGMA)
    torch.cuda.synchronize()
    residual_plain_s = time.perf_counter() - t2
    kw_err, kw_ok = _err(
        kernel_matvec_cuda(problem.x, problem.x, out.w, kernel="rbf", sigma=SIGMA, precision="f32"),
        kw_want, "f32")
    del kw_want

    rel = out.history[-1]["rel_residual"]
    rmse = float(evaluate(pred, y_te).rmse)
    tensors = {"x": problem.x, "y": problem.y, "w": out.w, "pred": pred}
    off_card = [k for k, v in tensors.items() if v.device.type != "cuda"]
    rec = {"phase": "solve", "n": N_TRAIN, "n_test": N_TEST, "d": D, "block_size": BLOCK,
           "rank": RANK, "iters": out.info["iters"], "rel_residual": rel,
           "rel_residual_start": 1.0, "test_rmse": rmse,
           "solve_s": out.info["wall_time_s"], "residual_s": residual_s,
           "iter_ms": 1e3 * (out.history[-1]["time_s"] - residual_s) / out.info["iters"],
           "wall_s_with_predict": wall, "launches": launches,
           "predict_max_abs_err": pred_err, "predict_ok": pred_ok,
           "residual_kw_max_abs_err": kw_err, "residual_kw_ok": kw_ok,
           "residual_plain_s": residual_plain_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "reduced": "n 1e8 -> 1e6 (+1e4 test): O(n^2 d) residual, one-card time limit"}
    emit(rec)
    if off_card:
        fail(f"tensors off the card: {off_card}")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the main path was never launched: {launches}")
    if not (math.isfinite(rel) and rel < 1.0):
        fail(f"final rel_residual {rel} is not finite and below its start of 1.0")
    if not (math.isfinite(rmse) and pred.shape == (N_TEST,)):
        fail(f"prediction not finite / wrong shape: rmse {rmse}, shape {tuple(pred.shape)}")
    if not pred_ok:
        fail(f"kernel_matvec's prediction disagrees with its plain version: err {pred_err}")
    if not kw_ok:
        fail(f"kernel_matvec's residual pass disagrees with its plain version: err {kw_err}")
    return rec


def _time_ms(fn, reps: int = 5) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound(m: int, n: int, d: int, t: int | None) -> dict:
    """Least time for the rbf work on (m, d) x (n, d) rows: the larger of its
    operations at the f32 peak and its bytes (inputs read once, output
    written once) at the memory peak; ``t`` None is the block."""
    flops = m * n * rbf_ops_per_pair(d, t or 0)
    if t:  # matvec: read A, B, V once, write out once
        nbytes = 4 * (m * d + n * d + n * t + m * t)
    else:  # block: read A, B once, write K once
        nbytes = 4 * (m * d + n * d + m * n)
    t_ops, t_bytes = 1e3 * flops / PEAK_F32_FLOPS, 1e3 * nbytes / PEAK_BYTES_S
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def main_path_inputs():
    """The operands one iteration of the main path gives the kernels:
    ``taxi_like`` training rows on the card, a block of BLOCK of them, and
    a random right-hand side over all rows."""
    import torch

    from repro_torch.data import synthetic

    x, _ = synthetic.taxi_like(0, N_TRAIN, D, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    idx = torch.randperm(N_TRAIN, generator=gen, device="cuda")[:BLOCK]
    return x, x.index_select(0, idx), torch.randn((N_TRAIN,), generator=gen, device="cuda")


def _time_case(fn, plain_fn, bound: dict) -> dict:
    """Time a kernel and its plain version, then hold one against the other."""
    import torch

    ms, plain_ms = _time_ms(fn), _time_ms(plain_fn)
    err, ok = _err(fn(), plain_fn(), "f32")
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound, "ok": ok}


def phase_time(launches: dict) -> list[dict]:
    from repro_torch.kernels import ref
    from repro_torch.kernels.kernel_block import kernel_block_cuda
    from repro_torch.kernels.kernel_matvec import kernel_matvec_cuda

    x, xb, z = main_path_inputs()
    q = xb[:SMALL_M].contiguous()
    rows = [
        {"name": "kernel_matvec", "route": "cuda",
         "source": "src/repro_torch/csrc/kernel_matvec.cu",
         "replaces": "src/repro/kernels/kernel_matvec.py:164",
         "launches": launches["kernel_matvec"], "library_ms": None,
         "shape": [BLOCK, N_TRAIN, D, 1],
         **_time_case(lambda: kernel_matvec_cuda(xb, x, z, kernel="rbf", sigma=SIGMA,
                                                 precision="f32"),
                      lambda: ref.kernel_matvec(xb, x, z, SIGMA, kernel="rbf"),
                      _bound(BLOCK, N_TRAIN, D, 1))},
        {"name": "kernel_block", "route": "cuda",
         "source": "src/repro_torch/csrc/kernel_block.cu",
         "replaces": "src/repro/kernels/kernel_block.py:34",
         "launches": launches["kernel_block"], "library_ms": None,
         "shape": [BLOCK, BLOCK, D],
         **_time_case(lambda: kernel_block_cuda(xb, xb, kernel="rbf", sigma=SIGMA,
                                                precision="f32"),
                      lambda: ref.kernel_block(xb, xb, SIGMA, kernel="rbf"),
                      _bound(BLOCK, BLOCK, D, None))},
    ]
    # the small-m limit: SMALL_M queries fill one row tile, so one SM works
    small = {"name": "kernel_matvec", "case": "small_m", "shape": [SMALL_M, N_TRAIN, D, 1],
             **_time_case(lambda: kernel_matvec_cuda(q, x, z, kernel="rbf", sigma=SIGMA,
                                                     precision="f32"),
                          lambda: ref.kernel_matvec(q, x, z, SIGMA, kernel="rbf"),
                          _bound(SMALL_M, N_TRAIN, D, 1))}
    for r in [*rows, small]:
        emit({"phase": "time", **r})
        if not r["ok"]:
            fail(f"{r['name']} disagrees with its plain version at shape {r['shape']}")
    return rows


def phase_launch() -> dict:
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.krr_solve", "--method", "askotch",
         "--iters", "50"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        fail(f"launcher exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    emit({"phase": "launch", "report": report})
    if list(report) != LAUNCHER_KEYS:
        fail(f"launcher keys {list(report)} != the JAX launcher's {LAUNCHER_KEYS}")
    if not (math.isfinite(report["rel_residual"]) and report["rel_residual"] < 1.0):
        fail(f"launcher rel_residual {report['rel_residual']}")
    return report


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    t0 = time.perf_counter()
    smi = phase_card()
    phase_build()
    phase_check()
    solve_rec = phase_solve()
    rows = phase_time(solve_rec["launches"])
    phase_launch()
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": [{k: r[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms")} for r in rows]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
