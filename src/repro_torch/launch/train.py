"""Training launcher: config-driven, checkpoint/restart fault-tolerant — the
port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --reduced \\
        --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/run1 [--resume] [--device cpu]

``--device`` (default ``cuda``) holds the parameters, the optimizer state,
the batches and every step; ``cuda`` without a card is an error.  One
device: the reference's launcher builds parameter shardings on its 2-D mesh
but never applies them, so its mesh only installs activation hints, and the
port runs no sharded LM program those hints could steer (the logical-axis
rules themselves are in ``distributed.meshes``; the dry run plans with
them).  Parameters are random, drawn from a generator seeded with
``--seed`` (torch's streams, not JAX's).

Fault tolerance, as in the reference:
  * atomic checkpoints every ``--ckpt-every`` steps (parameters, optimizer
    state, step, the data pipeline's cursor);
  * the step loop runs under a supervised retry: on failure it restores the
    latest checkpoint and continues (from scratch when there is none);
  * ``--inject-failure N`` raises at step N once (the fault drill);
  * straggler watchdog: a step slower than ``--straggler-factor`` x the
    running median is logged.

Every ``--log-every`` steps (and at the last) one JSON line
``{"step", "loss", "sec"}``, the reference's; ``sec`` is the step's wall
time up to the device finishing it.  TF32 is off for every f32 matmul.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from repro_torch.checkpoint import checkpointer
from repro_torch.configs.base import get_config, get_reduced_config
from repro_torch.data.pipeline import LMDataPipeline
from repro_torch.device import resolve_device, synchronize
from repro_torch.models.model_api import init_params
from repro_torch.training.optimizers import make_optimizer
from repro_torch.training.schedules import warmup_cosine
from repro_torch.training.train_step import make_train_step


class FailureInjected(RuntimeError):
    pass


def build(cfg, lr: float = 3e-4, total_steps: int = 10_000):
    """(optimizer, train step) for ``cfg``: its optimizer under a warmup-cosine
    schedule with ``min(100, total_steps // 10 + 1)`` warmup steps."""
    opt = make_optimizer(cfg.optimizer,
                         warmup_cosine(lr, min(100, total_steps // 10 + 1), total_steps))
    return opt, make_train_step(cfg, opt)


def _fresh(cfg, opt, seed: int, dev):
    params = init_params(torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
    return params, opt.init(params)


def run(args) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device(getattr(args, "device", "cuda"))
    cfg = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
    opt, stepfn = build(cfg, args.lr, args.steps)

    start_step = 0
    if args.resume and checkpointer.latest_step(args.ckpt_dir) is not None:
        state, extra, start_step = checkpointer.restore(args.ckpt_dir, device=dev)
        params, opt_state = state["params"], state["opt_state"]
        data_state = extra.get("data", {"seed": args.seed, "step": start_step})
        print(f"[resume] step {start_step}")
    else:
        params, opt_state = _fresh(cfg, opt, args.seed, dev)
        data_state = {"seed": args.seed, "step": 0}

    pipe = LMDataPipeline.from_state(cfg, args.batch, args.seq, data_state, device=dev)
    history = []
    step_times: list[float] = []
    failed_once = False
    step = start_step
    while step < args.steps:
        try:
            t0 = time.perf_counter()
            batch = next(pipe)
            if args.inject_failure >= 0 and step == args.inject_failure and not failed_once:
                failed_once = True
                raise FailureInjected(f"injected failure at step {step}")
            params, opt_state, metrics = stepfn(params, opt_state, batch, step)
            synchronize(dev)
            dt = time.perf_counter() - t0
            step_times.append(dt)
            if len(step_times) > 8:
                med = statistics.median(step_times[-50:])
                if dt > args.straggler_factor * med:
                    print(f"[straggler] step {step}: {dt:.3f}s vs median {med:.3f}s")
            step += 1
            if step % args.log_every == 0 or step == args.steps:
                rec = {"step": step, "loss": float(metrics["loss"]), "sec": round(dt, 4)}
                history.append(rec)
                print(json.dumps(rec), flush=True)
            if args.ckpt_dir and step % args.ckpt_every == 0:
                checkpointer.save(
                    args.ckpt_dir, step,
                    {"params": params, "opt_state": opt_state},
                    extra={"data": pipe.state(), "arch": cfg.name},
                )
        except FailureInjected as e:
            print(f"[fault] {e}; restarting from checkpoint", flush=True)
            if checkpointer.latest_step(args.ckpt_dir) is None:
                # no checkpoint yet: restart from scratch
                params, opt_state = _fresh(cfg, opt, args.seed, dev)
                pipe = LMDataPipeline(cfg, args.batch, args.seq, seed=args.seed, device=dev)
                step = 0
            else:
                state, extra, step = checkpointer.restore(args.ckpt_dir, device=dev)
                params, opt_state = state["params"], state["opt_state"]
                pipe = LMDataPipeline.from_state(cfg, args.batch, args.seq, extra["data"],
                                                 device=dev)
    return {"history": history, "final_step": step}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--inject-failure", type=int, default=-1)
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device for parameters, state and steps (cuda | cpu)")
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    main()
