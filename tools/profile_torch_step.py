#!/usr/bin/env python3
"""Where a step of the PyTorch port spends its time on the card.

    PYTHONPATH=src python3 tools/profile_torch_step.py [--n 1000000] [--steps 3]
    PYTHONPATH=src python3 tools/profile_torch_step.py --kernels rbf,laplacian,matern52 \\
        --weights 0.665,0.021,0.314
    PYTHONPATH=src python3 tools/profile_torch_step.py --path tune --n 20000 --steps 5
    PYTHONPATH=src python3 tools/profile_torch_step.py --path serve --block 64 --steps 50
    PYTHONPATH=src python3 tools/profile_torch_step.py --path lm --steps 5
    PYTHONPATH=src python3 tools/profile_torch_step.py --path train --steps 3

``--path askotch`` (default): the taxi configuration of ``chip_smoke.py``
(d = 9, sigma = 1, lam_unscaled = 2e-7, b = 50,000, r = 100, f32) with
``--kernels`` (one name, or a comma list: the weighted-sum refit with
``--weights``); two warm-up steps of ``repro_torch.core.askotch.make_step``,
then ``--steps`` steps under ``torch.profiler``.

``--path tune``: one sigma group of the multi-kernel tune of
``chip_smoke.py`` (rbf + laplacian + matern52, 8 Dirichlet weight samples x
4 lams x 5 folds = 160 columns, rank 100) through
``repro_torch.core.tune.engine.solve_sigma_group``; a warm-up group of 2 CG
iterations, then a group of ``--steps`` iterations (tol 0) under the
profiler.  The per-step wall time comes from the CG history (each iteration
ends in a host read of the column norms), the sketch and the scoring sweep
stay out of it.

``--path serve``: one serving bucket pass at a time of the taxi model
(``--kernels`` as for askotch, weights from seed 0) through
``repro_torch.serving.krr_serve.make_krr_predict_fn``: ``--block`` host
query rows (default 64) padded to their bucket, copied to the card, one
kernel launch (at t = 1 split over n: pack, sweep, reduce), the scores
copied back; ``--steps`` passes under the profiler, after a warm-up pass.

``--path lm``: decode steps of qwen2-1.5b at its published config (the
LM that ``chip_smoke.py`` times at full size; random weights from seed 0)
at the JAX serve launcher's batch of 4 after a 32-token prefill, each fed
its own greedy token and ending in a synchronize; one warm-up step first.

``--path train``: train steps of qwen2-1.5b at its published config (bf16
activations, f32 parameters, remat "full") at the JAX train launcher's
defaults (batch 8, seq 128, AdamW at 3e-4 through ``launch.train.build``),
as ``chip_smoke.py``'s phase ``train`` runs them on one repeated batch,
each ending in a synchronize; two warm-up steps first.

Prints one JSON line per device operation group (top 15 by device time, per
step), one per host operator (top 12 by its own CPU time) and a summary
line with the host wall time per step and the device time the trace saw.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import askotch
from repro_torch.core.krr import KRRProblem
from repro_torch.core.tune import engine
from repro_torch.data import synthetic
from repro_torch.obs.trace import TraceRecorder

TUNE_LAMS, TUNE_WEIGHTS, TUNE_FOLDS = (5e-8, 2e-7, 8e-7, 3.2e-6), 8, 5


def _askotch_steps(args, problem):
    step = askotch.make_step(problem, askotch.ASkotchConfig(block_size=args.block, rank=100))
    state = askotch.init_state(problem, seed=0)
    for _ in range(2):
        state, _ = step(state)
    torch.cuda.synchronize()

    walls = []

    def run():
        nonlocal state
        for _ in range(args.steps):
            t0 = time.perf_counter()
            state, _ = step(state)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)

    return run, walls


def _tune_steps(args, problem):
    rng = np.random.default_rng(0)
    group = engine.SigmaGroup(
        sigma=1.0, lam_list=TUNE_LAMS,
        weight_samples=rng.dirichlet(np.ones(len(problem.kernel)), size=TUNE_WEIGHTS).astype(np.float32),
    )
    folds = engine.make_folds(problem.n, TUNE_FOLDS, np.random.default_rng(1))
    y2 = problem.y.cpu().numpy()[:, None]

    def group_solve(iters):
        rec = TraceRecorder()
        engine.solve_sigma_group(problem.op, y2, group, folds, rank=100, max_iters=iters, tol=0.0,
                                 seed=0, warm_start=True, counter=engine.SweepCounter(),
                                 recorder=rec)
        return [b["time_s"] - a["time_s"] for a, b in zip(rec.history, rec.history[1:])]

    group_solve(2)
    torch.cuda.synchronize()
    walls = []

    def run():
        walls.extend(group_solve(args.steps + 1))

    return run, walls


def _serve_steps(args, problem):
    from repro_torch.serving.krr_serve import make_krr_predict_fn

    gen = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randn((problem.n,), generator=gen, device="cuda")
    predict = make_krr_predict_fn(problem.op, w, max_batch=1024)
    xq = problem.x[:args.block].cpu().numpy()  # the queries arrive on the host
    predict(xq).cpu()
    walls = []

    def run():
        for _ in range(args.steps):
            t0 = time.perf_counter()
            predict(xq).cpu()  # the copy back waits for the device
            walls.append(time.perf_counter() - t0)

    return run, walls


def _lm_steps(args):
    from repro_torch.configs.base import get_config
    from repro_torch.models.model_api import get_model, init_params
    from repro_torch.serving.serve_step import _copy_cache

    cfg = get_config("qwen2-1.5b")
    impl = get_model(cfg)
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    batch = synthetic.batch_for(cfg, (4, 32), 0, 0, device="cuda")
    batch.pop("labels", None)
    logits, cache = impl.prefill(params, batch, cfg)
    cache = _copy_cache(cache, impl.init_cache(cfg, 4, int(cache["pos"]) + args.steps + 1,
                                               device="cuda"))
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)

    def step():
        nonlocal cache, tok
        out, cache = impl.decode_step(params, cache, {"tokens": tok}, cfg)
        tok = torch.argmax(out[:, -1], -1)[:, None].to(torch.int32)

    step()
    torch.cuda.synchronize()
    walls = []

    def run():
        for _ in range(args.steps):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)

    return run, walls


def _train_steps(args):
    from repro_torch.configs.base import get_config
    from repro_torch.launch.train import build
    from repro_torch.models.model_api import init_params

    cfg = get_config("qwen2-1.5b")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    batch = synthetic.batch_for(cfg, (8, 128), 0, 0, device="cuda")
    opt, stepfn = build(cfg, 3e-4, 10)
    state = {"params": params, "opt": opt.init(params), "step": 0}

    def step():
        state["params"], state["opt"], _ = stepfn(state["params"], state["opt"], batch,
                                                  state["step"])
        state["step"] += 1

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    walls = []

    def run():
        for _ in range(args.steps):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)

    return run, walls


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", default="askotch", choices=["askotch", "tune", "serve", "lm", "train"])
    ap.add_argument("--n", type=int, default=None,
                    help="rows (default 10^6 for askotch, 20,000 for tune)")
    ap.add_argument("--block", type=int, default=None,
                    help="ASkotch block size (default 50,000) or serve's query rows (64)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--kernels", default=None,
                    help="comma list of kernel names (default rbf; rbf,laplacian,matern52 for tune)")
    ap.add_argument("--weights", default=None, help="comma list of combination weights")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if args.block is None:
        args.block = 64 if args.path == "serve" else 50_000
    default_kernels = "rbf,laplacian,matern52" if args.path == "tune" else "rbf"
    kernels = tuple((args.kernels or default_kernels).split(","))
    n = args.n or (20_000 if args.path == "tune" else 1_000_000)
    if args.path in ("lm", "train"):
        run, walls = (_lm_steps if args.path == "lm" else _train_steps)(args)
    else:
        x, y = synthetic.taxi_like(0, n, 9, device="cuda")
        weights = (None if args.weights is None
                   else tuple(float(w) for w in args.weights.split(",")))
        problem = KRRProblem(x=x, y=y, kernel=kernels[0] if len(kernels) == 1 else kernels,
                             weights=weights, sigma=1.0, lam_unscaled=2e-7)
        run, walls = {"askotch": _askotch_steps, "tune": _tune_steps,
                      "serve": _serve_steps}[args.path](args, problem)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()

    # device kernels only: a CPU op's device time is its kernels' time again
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        rows.append({"kernel": ev.key[:160], "calls": ev.count,
                     "device_ms_per_step": ev.self_device_time_total / 1e3 / args.steps})
    rows.sort(key=lambda r: -r["device_ms_per_step"])
    device_ms = sum(r["device_ms_per_step"] for r in rows) * args.steps
    for r in rows[:15]:
        print(json.dumps(r))
    # the host's side: operators by their own CPU time
    host = [{"host_op": ev.key[:120], "calls_per_step": ev.count / args.steps,
             "self_cpu_ms_per_step": ev.self_cpu_time_total / 1e3 / args.steps}
            for ev in prof.key_averages() if ev.device_type == DeviceType.CPU]
    host.sort(key=lambda r: -r["self_cpu_ms_per_step"])
    for r in host[:12]:
        print(json.dumps(r))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "summary": True, "path": args.path,
        **({"arch": "qwen2-1.5b"} if args.path in ("lm", "train")
           else {"kernels": list(kernels), "n": n}),
        "block": args.block, "steps": args.steps,
        "wall_ms_per_step": [1e3 * w for w in walls],
        "wall_ms_per_step_median": 1e3 * statistics.median(walls),
        "device_ms_per_step": device_ms / args.steps,
        "kernel_launches_per_step": sum(r["calls"] for r in rows) / args.steps,
        "host_ops_per_step": sum(r["calls_per_step"] for r in host),
        "idle_share": (1.0 - (device_ms / 1e3) / sum(walls)) if args.path != "tune" else None,
        "card": smi,
    }))


if __name__ == "__main__":
    main()
