"""LM serving launcher: batched prefill + greedy decode for any --arch — the
port of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        [--reduced] --batch 4 --prompt-len 32 --max-new 16 [--device cpu]

``--device`` (default ``cuda``) holds the weights, the batch and every
step; ``cuda`` without a card is an error.  Weights are random, drawn from a
generator seeded with ``--seed``.  The JSON line has the JAX launcher's keys
in its order; ``sample`` differs from the JAX launcher's for the same seed
because torch's random streams are not JAX's.  TF32 is off for every f32
matmul.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs.base import get_config, get_reduced_config
from repro_torch.data import synthetic
from repro_torch.device import resolve_device, synchronize
from repro_torch.models.model_api import init_params
from repro_torch.serving.serve_step import greedy_generate


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device for weights and steps (cuda | cpu)")
    args = ap.parse_args(argv)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device(args.device)
    cfg = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
    params = init_params(torch.Generator(device=dev).manual_seed(args.seed), cfg, device=dev)
    batch = synthetic.batch_for(cfg, (args.batch, args.prompt_len), args.seed, 0, device=dev)
    batch.pop("labels", None)

    synchronize(dev)
    t0 = time.perf_counter()
    out = greedy_generate(cfg, params, batch, args.max_new)
    synchronize(dev)
    dt = time.perf_counter() - t0
    toks = args.batch * args.max_new
    report = {
        "arch": cfg.name,
        "generated_shape": list(out.shape),
        "tokens": toks,
        "seconds": round(dt, 3),
        "tok_per_s": round(toks / dt, 1),
        "sample": out[0, :8].tolist(),
    }
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
