#!/usr/bin/env python3
"""Where an ASkotch iteration of the PyTorch port spends its time on the card.

    PYTHONPATH=src python3 tools/profile_torch_step.py [--n 1000000] [--steps 3]

Builds the taxi configuration of ``chip_smoke.py`` (d = 9, rbf, sigma = 1,
lam_unscaled = 2e-7, b = 50,000, r = 100, f32), runs two warm-up steps of
``repro_torch.core.askotch.make_step``, then ``--steps`` steps under
``torch.profiler`` (CPU + CUDA activity).  Prints one JSON line per device
operation group (top 15 by device time) and a summary line with the host
wall time per step (synchronised) and the device time the trace saw.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import askotch
from repro_torch.core.krr import KRRProblem
from repro_torch.data import synthetic


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--block", type=int, default=50_000)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    x, y = synthetic.taxi_like(0, args.n, 9, device="cuda")
    problem = KRRProblem(x=x, y=y, kernel="rbf", sigma=1.0, lam_unscaled=2e-7)
    step = askotch.make_step(problem, askotch.ASkotchConfig(block_size=args.block, rank=100))
    state = askotch.init_state(problem, seed=0)
    for _ in range(2):
        state, _ = step(state)
    torch.cuda.synchronize()

    walls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            t0 = time.perf_counter()
            state, _ = step(state)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)

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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "summary": True, "n": args.n, "block": args.block, "steps": args.steps,
        "wall_ms_per_step": [1e3 * w for w in walls],
        "device_ms_per_step": device_ms / args.steps,
        "idle_share": 1.0 - (device_ms / 1e3) / sum(walls),
        "card": smi,
    }))


if __name__ == "__main__":
    main()
