#!/usr/bin/env python3
"""Time the port's CUDA kernels at the main path's shapes on the card.

    PYTHONPATH=src python3 tools/time_torch_kernels.py [--label NAME]

``kernel_matvec`` at (50,000 x 10^6, d = 9, t = 1) and ``kernel_block`` at
(50,000 x 50,000, d = 9), rbf, f32, on the operands of ``chip_smoke.py``'s
``main_path_inputs``, and ``kernel_matvec`` for 64 queries against the 10^6
rows (one block: the small-m prediction case).  Timing is
``chip_smoke._time_ms`` (CUDA events), median of 7 after one warm-up.
Prints one JSON line.  Whichever ``repro_torch`` is first on ``PYTHONPATH``
is timed, so two versions are compared by alternating runs within one
session (A, B, B, A).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

from repro_torch.kernels.kernel_block import kernel_block_cuda  # noqa: E402
from repro_torch.kernels.kernel_matvec import kernel_matvec_cuda  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_torch_kernels: needs a CUDA card")
    x, xb, z = chip_smoke.main_path_inputs()
    q = xb[:chip_smoke.SMALL_M].contiguous()

    def median_ms(fn):
        return chip_smoke._time_ms(fn, reps=7)

    mv_ms = median_ms(lambda: kernel_matvec_cuda(xb, x, z, kernel="rbf", sigma=1.0, precision="f32"))
    blk_ms = median_ms(lambda: kernel_block_cuda(xb, xb, kernel="rbf", sigma=1.0, precision="f32"))
    small_ms = median_ms(lambda: kernel_matvec_cuda(q, x, z, kernel="rbf", sigma=1.0, precision="f32"))
    print(json.dumps({"label": args.label, "kernel_matvec_ms": mv_ms, "kernel_block_ms": blk_ms,
                      "kernel_matvec_m64_ms": small_ms, "card": chip_smoke.nvidia_smi_line()}))


if __name__ == "__main__":
    main()
