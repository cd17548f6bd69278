#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Phases, each printing its own JSON line; any failure exits non-zero:

  1. card    — ``nvidia-smi`` name and power limit, torch / CUDA versions,
               TF32 off for every f32 matmul, and a sha256 of the sources
               this run used (``tree_digest``).
  2. build   — compile every CUDA kernel of the port from
               ``src/repro_torch/csrc`` (one nvcc per source, in parallel,
               always, so each run prints its ``-Xptxas -v`` lines).
  3. check   — kernel_matvec and kernel_block against their plain PyTorch
               versions on the card: 7 kernels x {f32, bf16} x {1-D v,
               t = 8} x d in {9, 37} at m = 1000, n = 3001, then
               kernel_matvec at t = 1 on the edges of its t = 1 sweep
               (T1_EDGES: d = 1, 16, 17; n below one staged B tile and one
               past a multiple of it), then kernel_matvec at t > 1 on the
               edges of its two routes (the multi-column sweep up to t = 32,
               the column path above): every kernel x {f32, bf16} x d in {9,
               37} at m = 1001, n = 2999 and t in COLS_T (each column
               width, t % 4 != 0, several column blocks); then the
               multi-column sweep on its own edges: every kernel x {f32,
               bf16} x d in HEADS_D (9, 16, 17, 37) x t in HEADS_T (2 to
               32: each width W = 2, 4, 8, 12, 16, 20, 24, 32, at it and
               below it) at
               n = 2999 with m = 1001 (split over n) and 4097 (above
               SPLIT_M: one range), and at m in HEADS_SPLIT_M (1, 8, 64,
               65) with n at the split's tile edges (split_ns).
               Then kernel_block on each of its routes
               (``block_route_cases``): few columns at n = 1, 2, 3, 16 and
               one past the skinny routes' limit (``skinny_max()``), few
               rows at m = 1, 2 and one past it, the symmetric route (b the same tensor as a)
               and the tile route on a copy at 132, 1000 and 1001 rows,
               the tile route at (1000, 3000) and (257, 1001) (n % 4 != 0:
               the threads store), each at d = 1, 16, 17, 37, every kernel
               x {f32, bf16}: 896 checks, one line a case with its route.
               Tolerances as the JAX package's kernel tests: f32 rtol 2e-4
               / atol 2e-5 x max(1, |ref|max); bf16 rtol 0.05 / atol 0.02 x
               max(1, |ref|max).  16,646 checks.
  3b. check_multi — the three multi-kernel kernels against their plain
               versions, same tolerances and shapes: the combinations
               (rbf, laplacian, matern52) (l2 + l1 families), (linear,
               polynomial, sigmoid, cosine) (dot + cos), (rbf, rbf) with
               sigmas (0.5, 2.0), and 9 kernels (above the per-launch cap:
               the wrapper splits them) x {f32, bf16} x d in {9, 37}; the
               weighted matvec with (q,) weights on a 1-D v and on t = 8
               and with per-column (q, 8) weights, the stacked matvec on a
               1-D v and on t = 8, and the weighted block; then the weighted
               matvec's column path at t = 160, 161 and 150, with (q,) and
               per-column (q, t) weights, for every combination (q = 9
               included); the weighted matvec at t = 1 with a device (q, 1)
               weight column on v (n, 1), and on T1_EDGES; the stacked
               matvec at t in STACKED_T = (2, 100, 101, 161) with q in
               {1, 3, 4, 5} (STACKED_CASES); the weighted block at
               BLOCK_EDGES (d = 1, 16, 17, 37; n % 4 == 0 with a ragged
               128-column strip, m and n below one tile) and, at
               SAME_EDGES, with b the same tensor as a (the symmetric
               path) and a copy of it; then the weighted heads ((q,)
               weights, 2 <= t <= 16) on the multi-column sweep's edges:
               every combination x {f32, bf16} x d in HEADS_D x t in
               WEIGHTED_HEADS_T (2, 3, 10, 16, 17) at n = 2999 with m = 1001
               and 4097, and at m in HEADS_SPLIT_M with n at split_ns
               (``_check_weighted_heads``, one line a (d, n, m)).  3,320
               checks.
  3b'. check_split — both t = 1 kernels (kernel_matvec, every kernel; the
               weighted matvec, every MULTI_CASES combination) on the route
               that splits n over the grid (m <= 4096), f32 and bf16, against
               their plain versions: m in SPLIT_M (1, 8, 63, 64, 65, 1024),
               d in SPLIT_D (9, 16, 17, 37) and n below one staged tile (no
               split), at 40 tiles and one either side.  One line a
               (d, n, m) with the ranges S.
  3c. determinism — two launches of each t = 1 kernel (kernel_matvec, the
               weighted matvec) at the solve's G_B shape and at a serving
               bucket (64 x 10^6, split), of the weighted block at the
               refit's K_BB, of the stacked matvec at the tune's sketch, of
               kernel_matvec's column path at t = 100 (20,000^2 x 100) and
               of its multi-column sweep at 50,000 x 10^6 x 8, 20 and 32
               and at 10- and 32-head serving buckets (64 x 10^6 x t,
               split), of the weighted heads at 50,000 x 10^6 x 10 and at a
               10-head bucket (split), and of
               kernel_block on each route (K_BB with b the same tensor: the
               symmetric route, also bitwise its own transpose; K_BB of a
               copy: the tile route; the pivot column 10^6 x 1 and SAP's
               row 1 x 20,000: the skinny routes) are bitwise equal.
  4. solve   — the main path through ``solver_api.solve("askotch")`` at the
               paper's taxi configuration (d = 9, rbf, sigma = 1,
               lam_unscaled = 2e-7, b = 50,000, r = 100, f32), with n cut
               from 10^8 to 10^6 (+ 10^4 test points): the O(n^2 d) residual
               and the one-card time limit force the cut.  Launch counts
               are zeroed before and read after.  kernel_matvec's other two
               shapes on the path, the prediction (10^4 x 10^6) and the
               residual pass (10^6 x 10^6), are held against the plain
               version in full.  Two warm-up steps run before it, so
               its ``iter_ms`` is the steady state.
  4b. telemetry — phase 4's solve with ``repro_torch.obs.Telemetry``:
               disabled, enabled (JSONL), enabled (ring), disabled; the
               JSONL validates, one trace event a history record, the
               ``solve/askotch`` span covers the last record, the tile
               counters equal ``record_tile_work``'s formula for 20 steps,
               ``roofline_time_s`` a step beside the step time, and the
               disabled step time within 2 % of phase 4's.  Then a
               single-kernel tune (20,000 rows, sigma 1, 4 lams, 5 folds)
               with telemetry: its ``repro_kernel_pairs_total`` delta equals
               sweeps x n^2 and ``repro_cg_iterations_total`` is positive.
  5. tune    — the multi-kernel path's search: ``tune_multikernel`` on the
               first 20,000 rows of the same taxi data, kernels (rbf,
               laplacian, matern52) (benchmarks/bench_multikernel.py), 8
               Dirichlet weight samples x 4 lams around 2e-7 x 5 folds
               (160 columns of one stacked blocked CG), sigma 1, rank 100,
               200 iterations at most, tol 1e-5; n cut from 10^8 to 2 x 10^4
               because every CG iteration is a 160-column sweep.  One
               ``matvec_cols`` (20,000^2 x 160) and one ``sketch_components``
               (20,000^2 x 100) are held against their plain versions.
  6. refit   — the tuned combination refit by ``solve("askotch")`` on the
               10^6-row problem of phase 4 (b = 50,000, r = 100, 20
               iterations); G_B (50,000 x 10^6), K_BB (50,000^2), the
               prediction (10^4 x 10^6) and the residual pass's K_w w
               (10^6 x 10^6) are held against their plain versions in full;
               the final residual must be finite and below 1.
  6b. baselines — the paper's baseline solvers through ``solve()`` on
               phase 4's taxi data (n = 10^6 + 10^4 test points), settings
               of benchmarks/bench_fig1_showdown.py:25-31 with the budgets
               cut: pcg-nystrom (rank 100, 20 iterations), pcg-rpcholesky
               (rank 50, 10), pcg-rff (rank 100, 400 features, 10), cg
               (10), falkon (m = 20,000, 20), eigenpro (rank 100, subsample
               1000, one epoch of 100 batches of 10^4) and direct (the first
               20,000 rows).  One line a method: iterations, seconds, the
               final relative residual (-1 for Falkon), CG's objective
               1/2 w'(K + lam I)w - y'w, test RMSE, the path's launches and,
               for pcg-nystrom, the sketch's time from CUDA events; pcg-rff
               also times its thin SVD two ways.  Held against the plain
               versions: 2,048 rows of the sketch's output, one RPCholesky
               pivot column (10^6 x 1), Falkon's K(X, X_m) v and K(X_m, X) u,
               EigenPro's batch gradient (10^4 x 10^6) and K_SB g (1000 x
               10^4), direct's K (20,000^2).  It fails on a disagreement, an
               unlaunched kernel of a path, a non-finite test RMSE (all but
               EigenPro), a PCG-family residual that is not finite or an
               objective not below its start of 0 (CG's residual norm is not
               monotone; its objective is), and a direct residual not below
               1.  EigenPro's residual and RMSE are recorded, not judged.
  6c. estimators — ``repro_torch.estimators`` with the device default
               (cuda) and without scikit-learn: ``KernelRidge`` (solver
               askotch, phase 4's options and seed) fit on phase 4's rows,
               its ``dual_coef_`` and test RMSE held against phase 4's
               (bitwise, or within the f32 tolerance), fit / solve seconds,
               predict ms and R²; ``KernelRidgeCV`` (alphas 20,000 x the
               tune's lams, sigmas 0.5 / 1 / 2, 5 folds) on the tune rows,
               its best equal to a direct ``tune()``'s; ``MultipleKernelRidgeCV``
               on phase 5's search with its 8 weight rows passed in, its
               best equal to phase 5's; a ``kernel="precomputed"`` direct
               fit on a 2,000^2 Gram from ``kernel_block`` against the rbf
               fit of the same rows; the direct ``tune()`` (3 sigmas, each
               one stacked CG over 4 lams x 5 folds = 20 columns:
               kernel_matvec at 20,000^2 x 20) is timed.  Each path's
               launches are read.
  6d. sap    — the exact SAP methods on the 20,000 tune rows (sigma 1,
               lam_unscaled 1e-4): randomized Newton and NSAP at b = 2,000
               (mu 0.01, nu n / b) for 60 steps, Kaczmarz and CD for 400,
               each with its own draws until its residual is below its
               start of 1; then 10 steps with injected indices on the card
               against the CPU plain run, within the f32 tolerance.
  6d'. ova   — one-vs-all solves through ``solve("askotch")`` at phase 4's
               configuration (n = 10^6 + 10^4 test rows, d = 9, rbf,
               b = 50,000, r = 100, 20 iterations) on
               ``synthetic.krr_one_vs_all`` blobs with 2, 4, 8 and 10
               classes (t heads: kernel_matvec's multi-column sweep at G_B,
               the prediction and the residual pass), 20, 24 and 32 (its
               widths 20, 24 and 32), then 10 classes with the refit's
               kernels, sigma and weights (``solve(..., kernel=,
               weights=)``: the weighted heads at G_B, the prediction and
               the residual pass; the weighted block at K_BB): every head's
               final residual finite and below its start of 1, test
               accuracy, seconds and the path's launches.
  6e. serve  — ``repro_torch.serving.ServingEngine`` on the card (max_batch
               1024, max_wait 5 ms) at n = 10^6: phase 4's model saved as an
               artifact, loaded and warmed (8 buckets), then 2,000 requests
               of 1-16 taxi test rows, Poisson at 2,000 requests/s from 4
               client threads; phase 6's multi-kernel model (the weighted
               t = 1 path), a 10-head rbf model (random weights from a
               seed: kernel_matvec's multi-column sweep split over n) and a
               10-head model of phase 6's kernels, sigma and weights with
               the same seeded weights (the weighted heads, split over n),
               500 requests each.  Held: every response within the f32
               tolerance of the plain version, the threaded responses
               bitwise the sequential closure's, the wrapper's launches =
               warm launches + bucket runs, and 8 rows bitwise the same in
               buckets 8, 64 and 1024, for the taxi model and both 10-head
               models.
               Printed: p50 / p99 ms, qps, per-bucket runs and fill.
  6f. dist   — the distributed tier (``repro_torch.distributed``):
               ``solve("askotch", mesh=make_solver_mesh("1x1"))`` at phase
               4's configuration (20 iterations after two warm-up steps;
               residual, test RMSE and ms per step beside phase 4's, the
               prediction against the plain version, no collective); every
               global primitive of ``ShardedKernelOperator`` on a
               ``SolverMesh`` of cuda:0 x 4 as (2, 2) at n = 2 x 10^5 (rbf,
               and the weighted (rbf, laplacian, matern52) for
               ``matvec_cols`` / ``sketch_components``) against the (1, 1)
               result within the f32 tolerance, ``gather_rows`` exact, the
               collective counts the reference's table and two runs bitwise
               equal (over two cards as (2, 1) as well where there are two);
               pcg-nystrom over the (2, 2) mesh at 2 x 10^5 rows (rank 100,
               20 iterations) against one device (CG's objective within
               1e-4, test RMSE recorded);
               DC with 4 shards of askotch at 10^6 rows, without and with a
               (1, 1) mesh (bitwise equal, zero collective dispatches, each
               shard's seconds) and at k = 1 (bitwise phase 4's w); a tune
               over the (2, 2) mesh (the tune rows, sigmas 0.5 / 1, two
               lams, 3 folds) picking the best of the same search without a
               mesh; phase 4's model served over the (2, 2) mesh (200
               requests: within the f32 tolerance of the one-device model,
               bitwise the mesh closure's sequential predict); ``krr_solve
               --mesh 1x1`` and ``--method dc --dc-shards 4`` with the JAX
               launcher's keys.  Each path's launches are read.
  7. time    — each kernel at the main path's shapes (CUDA events, median
               of 5 after warm-up; the plain version's of 3; the card held
               busy while each call is enqueued, so a short kernel's time is
               the card's, not the wrapper's) beside its plain version and
               its bound,
               with the kernel's result held against the plain one there;
               also kernel_matvec for the 10^4 prediction queries and for
               serving's buckets of 8, 64 (the small-m case) and 1024
               queries, at t = 10 for 8, 64 and 1024 queries, the weighted
               matvec for 64 queries, and the multi-kernel kernels at the
               tune's, the refit's and the prediction's shapes; the two
               t = 1 G_B rows carry the special-function floor
               (``sfu_floor_ms``) beside the bound.  The baselines' shapes:
               kernel_matvec at t = 100 (50,000 x 10^6, beside the sketch's
               one 10^6-row launch from phase 6b), kernel_block at (10^6, 1)
               and Falkon's two sweeps; and kernel_matvec at a one-vs-all
               G_B of 2, 4, 8, 10, 20, 24 and 32 heads (50,000 x 10^6 x t)
               and at the single-kernel tune's CG apply (20,000^2 x 20), the
               weighted heads at the multi-kernel one-vs-all's G_B (t = 10)
               and at its model's buckets of 8, 64 and 1024 queries; the distributed
               tier's (1, 1) Nystrom sketch (50,000^2 x 100) and powering
               (50,000^2, t = 1), and a DC shard's G_B (50,000 x 250,000)
               and K_BB; kernel_block at Falkon's K_mm (20,000^2, b the
               same tensor) and SAP's row (1 x 20,000, Kaczmarz's path).
               The K_BB, DC K_BB and K_mm rows carry ``write_floor_ms``,
               the time of ``fill_`` on the kernel's own output, timed rep
               by rep between its launches: what a pass that only stores
               reaches on the card.  The kernels
               line has one row per (kernel, path shape), each with the
               launches of that path.
  7b. lm    — LM serving (``repro_torch.models``, ``serving.serve_step``),
               which runs no hand-written kernel.  The ten architectures at
               their reduced size (f32): the same weights and batch (drawn on
               the CPU from seeds) through ``loss_fn``, ``prefill``, four
               decode steps (fed the CPU run's tokens) and
               ``greedy_generate`` on the card and on the CPU, within the f32
               tolerance, greedy tokens identical, and with experts every
               routing round routing each token alike; ``moe_ffn`` card
               against CPU at O(1) inputs with capacity drops and four
               token chunks (f32).  Then on the card alone, at the
               JAX serve launcher's defaults (batch 4, prompt 32, 16 new
               tokens): qwen2-1.5b at its published config (28 layers, bf16
               activations, f32 parameters), whisper-base and rwkv6-1.6b at
               theirs, deepseek-moe-16b at its published width with depth
               cut to 2 layers (28 layers of f32 parameters do not fit):
               generation, prefill and decode ms (CUDA events, median of
               5), tok/s, peak memory, the decode step's byte bound
               (parameters + cache over HBM bandwidth), and decode against
               a one-token-longer prefill in f32 (flat 2e-3; an MoE model
               dropless) and, for qwen2-1.5b, in bf16 (the bf16 tolerance,
               beside what a decode with its cache left unwritten reads).
  7c. train — LM training (``repro_torch.training``, ``checkpoint``,
               ``data.pipeline``, ``launch.train``), which runs no
               hand-written kernel.  The ten architectures at their reduced
               size (f32, B = 2, T = 16): the same numpy parameters and
               batch through ``value_and_grad`` and one AdamW train step
               (eps 1e-3) on the card and on the CPU: loss, every gradient
               leaf and every parameter after the step within the f32
               tolerance, with experts every routing round routing alike.
               qwen2-1.5b at its published config (28 layers, bf16
               activations, f32 parameters, remat "full") at the JAX train
               launcher's defaults (batch 8, seq 128, AdamW at 3e-4): the
               step-0 loss within 0.5-1.5 x ln(padded vocab); its gradient
               under remat "full" against "none" (each leaf within 1e-3 x
               its largest magnitude; bitwise or not recorded) and against
               an f32 twin's (cosine >= 0.99, norm ratio in [0.9, 1.1]);
               microbatches 2 against 1 (loss within 2e-3 relative, the
               update's cosine >= 0.99); then 10 steps of
               ``launch.train.build``'s optimizer on one repeated batch (the
               last loss below the first): step ms (CUDA events, median of
               the last 5), tok/s, peak memory with remat and of one step
               without (under 80 GB), and the step's bound (8 N tokens
               FLOPs at 989 TFLOP/s plus AdamW's 7 x the parameter bytes at
               3.35 TB/s).  Then ``python -m repro_torch.launch.train``:
               the JAX test's fault drill (reduced qwen2, 30 steps, batch 4,
               seq 16, checkpoints every 10, a failure injected at 17; the
               step-30 loss within 1e-4 of a clean run's) and qwen2-1.5b at
               its published config for 20 steps without a checkpoint
               directory (tok/s from the median of its last 10 steps).
  8. launch  — ``python -m repro_torch.launch.krr_solve --method askotch
               --iters 50``, ``python -m repro_torch.launch.krr_tune
               --kernels rbf,laplacian,matern52 --n 4000 --export-artifact
               DIR`` and ``python -m repro_torch.launch.krr_serve --artifact
               demo=DIR --requests 200 --rate 500 --prometheus`` on cuda, all
               with ``--telemetry`` (their JSONL files validate); then
               ``python -m repro_torch.launch.serve --arch qwen2-1.5b`` (the
               published config); their JSON keys must be the JAX
               launchers'.

  9. dryrun  — the dry run (``repro_torch.launch.dryrun``: meta-tensor
               traces, no card) held against the card.  (a) The KRR cell at
               phase 6f's (1, 1) size (n = 10^6, b = 50,000, r = 100): the
               predicted argument bytes equal the real step's inputs' bytes
               (the state in ``abstract_dist_inputs``' layout, x, y), the
               real step's ms (CUDA events, median of 5, draws injected) is
               at or above the dry run's roofline floor (its largest term at
               the f32 peak), and the predicted peak (arguments + temp) is
               recorded beside ``torch.cuda.max_memory_allocated``'s.  (b)
               The same for qwen2-1.5b at its published config: the train
               step at phase 7c's shape (batch 8, seq 128; parameters, the
               dry run's AdamW state, the batch and the step counter) and
               decode at phase 7b's (batch 4, a 48-slot cache; parameters,
               cache and batch).  (c) The dry-run CLI for the KRR cell on
               both production meshes and for qwen2-1.5b on its four shapes
               (``long_500k`` skipped, as ``shape_applicable`` says), timed,
               with the wrappers' launch counts unchanged (a meta trace
               launches nothing); its report goes to
               ``chiprun_out/dryrun_report.md``.

Each of the paths in phases 4-6f sets every launch count to 0 just before
it runs and reads the counts just after; a kernel of the path that was
never launched fails the run.  Phases run in the order 1-3b', 3c, 4, 4b, 5,
6, 6b, 6c, 6d, 6d', 6e, 6f, 7, 7b, 7c, 8, 9.

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

# the H100's peaks (f32 outside the tensor cores, HBM3 bandwidth, the
# special-function rate) come from one place, ``repro_torch.roofline.hw``,
# read where the bounds are computed.  Special-function operations a pair
# of each kernel map on the t = 1 sweep (a floor beside the bound, which
# counts them as operations)
SFU_OPS = {"rbf": 1, "laplacian": 1, "matern52": 2}

# the paper's taxi configuration (src/repro/configs/askotch_krr.py), n cut
N_TRAIN, N_TEST, D = 1_000_000, 10_000, 9
BLOCK, RANK, SIGMA, LAM_UNSCALED = 50_000, 100, 1.0, 2e-7
MAX_ITERS = 20
SMALL_M = 64  # a few prediction queries: fewer row tiles than SMs
OVA_HEADS = 10  # a one-vs-all G_B's heads (t), timed at the solve's G_B shape

# the multi-kernel tune (benchmarks/bench_multikernel.py:22-23 kernels and
# M / L / K), n cut; its C = M * L * K columns ride one stacked CG
MK_KERNELS = ("rbf", "laplacian", "matern52")
N_TUNE, M_WEIGHTS, K_FOLDS = 20_000, 8, 5
TUNE_LAMS = (5e-8, 2e-7, 8e-7, 3.2e-6)
TUNE_ITERS, TUNE_TOL = 200, 1e-5

# keys of the JSON line printed by ``python -m repro.launch.krr_solve`` for
# a single-head askotch solve (src/repro/launch/krr_solve.py:151-159)
LAUNCHER_KEYS = [
    "method", "iters", "converged", "wall_time_s", "t", "rel_residual_per_head",
    "n", "rel_residual", "test_rmse", "test_mae", "test_acc", "seconds",
]

# keys of the JSON line printed by ``python -m repro.launch.krr_tune
# --kernels ...`` with a refit that warm-starts (src/repro/launch/krr_tune.py:180-230)
TUNE_LAUNCHER_KEYS = [
    "best", "strategy", "search", "policy", "candidates", "folds", "kernel_sweeps",
    "naive_sweep_estimate", "records", "trace", "weight_samples", "refit_warm_start",
    "refit", "exported_artifact", "seconds",
]

# keys of the report ``python -m repro.launch.krr_serve --artifact ...
# --requests N --prometheus --telemetry PATH`` prints
# (src/repro/launch/krr_serve.py:91-138), of a loaded model's info
# (src/repro/serving/engine.py:306-313), of the engine's stats
# (src/repro/serving/engine.py:473-478) and of a model's stats
# (src/repro/serving/engine.py:193-209)
SERVE_LAUNCHER_KEYS = ["loaded", "traffic", "stats", "prometheus", "telemetry"]
SERVE_LOADED_KEYS = ["model", "version", "d", "bytes", "warmed_buckets", "evicted"]
SERVE_STATS_KEYS = ["models", "evictions", "bytes", "max_bytes"]
SERVE_MODEL_KEYS = ["model", "version", "n_requests", "n_rows", "qps", "p50_ms", "p99_ms",
                    "mean_ms", "occupancy", "compile_cache_depth", "bytes"]

TOL = {"f32": (2e-4, 2e-5), "bf16": (0.05, 0.02)}

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
    # per kernel template (the csrc entry functions are the templates
    # *_kernel and pack_b): its instantiations' registers, spills, static smem
    by_kernel: dict = {}
    for m in re.finditer(r"Function properties for (\w+)\n.*?(\d+) bytes spill stores, (\d+) bytes "
                         r"spill loads\n.*?Used (\d+) registers([^\n]*)", log, flags=re.S):
        name = re.search(r"[a-z]\w*?_kernel(?=I)|pack_b", m.group(1))
        rec = by_kernel.setdefault(name.group() if name else m.group(1), {
            "entries": 0, "registers": [999, 0], "spill_bytes": 0, "smem_bytes_max": 0})
        r = int(m.group(4))
        rec["entries"] += 1
        rec["registers"] = [min(rec["registers"][0], r), max(rec["registers"][1], r)]
        rec["spill_bytes"] += int(m.group(2)) + int(m.group(3))
        sm = re.search(r"(\d+) bytes smem", m.group(5))
        rec["smem_bytes_max"] = max(rec["smem_bytes_max"], int(sm.group(1)) if sm else 0)
    return {"entries": len(regs), "registers_min": min(regs, default=None),
            "registers_max": max(regs, default=None), "smem_bytes_max": max(smem, default=None),
            "spill_store_bytes": spill_st, "spill_load_bytes": spill_ld, "by_kernel": by_kernel}


LIBS = ("kernel_matvec", "kernel_block", "kernel_multi")


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    report = _build.build(LIBS, force=True)
    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / "chip_smoke_build.log", "w") as fh:
        for name, rec in report.items():
            fh.write(f"== {name} ({rec['seconds']:.1f} s)\n{rec['log']}\n")
    for name in LIBS:
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
    # the t = 1 sweep's edges: d = 1, the register cap and one above it, and
    # n below one staged B tile and one past a multiple of it
    gen_edge = torch.Generator().manual_seed(7)
    for d, n_e in T1_EDGES:
        a = (torch.randn((m, d), generator=gen_edge) / math.sqrt(d)).cuda()
        b = (torch.randn((n_e, d), generator=gen_edge) / math.sqrt(d)).cuda()
        a[3] = 0.0
        v = torch.randn((n_e,), generator=gen_edge).cuda()
        for kern in KERNEL_NAMES:
            for prec in ("f32", "bf16"):
                want = ref.kernel_matvec(a, b, v, sigma, kernel=kern, precision=prec)
                got = kernel_matvec_cuda(a, b, v, kernel=kern, sigma=sigma, precision=prec)
                torch.cuda.synchronize()
                err, ok = _err(got, want, prec)
                emit({"check": "kernel_matvec", "kernel": kern, "precision": prec,
                      "d": d, "n": n_e, "t": 1, "max_abs_err": err, "ok": ok})
                if not ok or got.shape != want.shape:
                    fail(f"kernel_matvec {kern} {prec} d={d} n={n_e} t=1: err {err}")
                worst["kernel_matvec"] = max(worst["kernel_matvec"], err)
    # the edges of the t > 1 routes: m, n ragged against the column path's
    # 32-row and 16-row tiles and the loop's 64-row ones
    m_c, n_c = 1001, 2999
    gen_cols = torch.Generator().manual_seed(14)
    n_checks = 0
    for d in (9, 37):
        a = (torch.randn((m_c, d), generator=gen_cols) / math.sqrt(d)).cuda()
        b = (torch.randn((n_c, d), generator=gen_cols) / math.sqrt(d)).cuda()
        a[3] = 0.0
        for t in COLS_T:
            v = torch.randn((n_c, t), generator=gen_cols).cuda()
            for kern in KERNEL_NAMES:
                for prec in ("f32", "bf16"):
                    want = ref.kernel_matvec(a, b, v, sigma, kernel=kern, precision=prec)
                    got = kernel_matvec_cuda(a, b, v, kernel=kern, sigma=sigma, precision=prec)
                    torch.cuda.synchronize()
                    err, ok = _err(got, want, prec)
                    emit({"check": "kernel_matvec", "kernel": kern, "precision": prec,
                          "d": d, "m": m_c, "n": n_c, "t": t, "max_abs_err": err, "ok": ok})
                    if not ok or got.shape != want.shape:
                        fail(f"kernel_matvec {kern} {prec} d={d} m={m_c} n={n_c} t={t}: err {err}")
                    worst["kernel_matvec"] = max(worst["kernel_matvec"], err)
                    n_checks += 1
    heads_checks, heads_worst = _check_heads(sigma)
    worst["kernel_matvec"] = max(worst["kernel_matvec"], heads_worst)
    block_checks, block_worst = _check_block_routes(sigma)
    worst["kernel_block"] = max(worst["kernel_block"], block_worst)
    emit({"phase": "check", "m": m, "n": n, "sigma": sigma, "t1_edges": T1_EDGES,
          "cols_t": COLS_T, "cols_checks": n_checks, "heads_t": HEADS_T, "heads_d": HEADS_D,
          "heads_split_m": HEADS_SPLIT_M, "heads_checks": heads_checks,
          "block_route_checks": block_checks, "worst_abs_err": worst})
    return worst


def _err_on_card(got, ref, precision: str):
    """``_err`` without a host sync: (max |got - ref|, within tolerance) as
    0-d tensors on the card, read in bulk by the caller."""
    import torch

    rtol, atol = TOL[precision]
    diff = (got - ref).abs()
    scale = torch.clamp(ref.abs().max(), min=1.0)
    ok = (diff <= rtol * ref.abs() + atol * scale).all() & (got.shape == ref.shape)
    return diff.max(), ok


def _check_heads(sigma: float) -> tuple[int, float]:
    """kernel_matvec's multi-column sweep against its plain version on its
    edges: every kernel x {f32, bf16} x d in HEADS_D x t in HEADS_T, at n =
    2999 with m = 1001 (split over n) and 4097 (above SPLIT_M: one range),
    and at m in HEADS_SPLIT_M with n at split_ns(d).  One line a (d, n, m)
    with its ranges S; returns (checks, worst error)."""
    import torch

    from repro_torch.core.kernels import KERNEL_NAMES
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.kernel_matvec import kernel_matvec_cuda, t1_splits

    lib = _build.load("kernel_matvec")
    gen = torch.Generator().manual_seed(25)
    n_checks, worst = 0, 0.0
    for d in HEADS_D:
        for edge, n in {"n 2999": 2999, **split_ns(d)}.items():
            b = (torch.randn((n, d), generator=gen) / math.sqrt(d)).cuda()
            v = torch.randn((n, max(HEADS_T)), generator=gen).cuda()
            for m in (1001, 4097) if edge == "n 2999" else HEADS_SPLIT_M:
                a = (torch.randn((m, d), generator=gen) / math.sqrt(d)).cuda()
                if m > 3:
                    a[3] = 0.0  # cosine's zero-norm-as-1 rule
                errs, labels = [], []
                for t in HEADS_T:
                    vt = v[:, :t].contiguous()
                    for kern in KERNEL_NAMES:
                        for prec in ("f32", "bf16"):
                            got = kernel_matvec_cuda(a, b, vt, kernel=kern, sigma=sigma,
                                                     precision=prec)
                            want = ref.kernel_matvec(a, b, vt, sigma, kernel=kern, precision=prec)
                            errs.append(_err_on_card(got, want, prec))
                            labels.append((t, kern, prec))
                err = torch.stack([e for e, _ in errs]).cpu()
                ok = torch.stack([k for _, k in errs]).cpu()
                n_checks += len(labels)
                worst = max(worst, float(err.max()))
                emit({"check": "heads", "d": d, "n": n, "edge": edge, "m": m,
                      "splits": t1_splits(lib, m, n, d), "checks": len(labels),
                      "max_abs_err": float(err.max()), "ok": bool(ok.all())})
                if not bool(ok.all()):
                    bad = [labels[i] for i in range(len(labels)) if not ok[i]]
                    fail(f"kernel_matvec (multi-column sweep) d={d} n={n} m={m}: "
                         f"{bad[:5]} off the plain version (worst err {float(err.max())})")
    return n_checks, worst


def _check_weighted_heads() -> tuple[int, float]:
    """The weighted matvec's heads (static (q,) weights) against its plain
    version on the multi-column sweep's edges: every MULTI_CASES combination
    x {f32, bf16} x d in HEADS_D x t in WEIGHTED_HEADS_T, at n = 2999 with
    m = 1001 (split over n) and 4097 (one range), and at m in HEADS_SPLIT_M
    with n at split_ns(d).  One line a (d, n, m) with its ranges S; returns
    (checks, worst error)."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.kernel_matvec import t1_splits
    from repro_torch.kernels.multi import kernel_matvec_multi_cuda

    lib = _build.load("kernel_multi")
    gen = torch.Generator().manual_seed(27)
    rng = np.random.default_rng(27)
    n_checks, worst = 0, 0.0
    for d in HEADS_D:
        for edge, n in {"n 2999": 2999, **split_ns(d)}.items():
            b = (torch.randn((n, d), generator=gen) / math.sqrt(d)).cuda()
            v = torch.randn((n, max(WEIGHTED_HEADS_T)), generator=gen).cuda()
            for m in (1001, 4097) if edge == "n 2999" else HEADS_SPLIT_M:
                a = (torch.randn((m, d), generator=gen) / math.sqrt(d)).cuda()
                if m > 3:
                    a[3] = 0.0  # cosine's zero-norm-as-1 rule
                errs, labels = [], []
                for t in WEIGHTED_HEADS_T:
                    vt = v[:, :t].contiguous()
                    for kernels, sigmas in MULTI_CASES:
                        w = tuple(float(x) for x in rng.dirichlet(np.ones(len(kernels))))
                        w_t = torch.tensor(w, device="cuda")
                        for prec in ("f32", "bf16"):
                            got = kernel_matvec_multi_cuda(a, b, vt, w, kernels=kernels,
                                                           sigmas=sigmas, precision=prec)
                            want = ref.kernel_matvec_multi(a, b, vt, sigmas, w_t, kernels=kernels,
                                                           precision=prec)
                            errs.append(_err_on_card(got, want, prec))
                            labels.append((t, len(kernels), prec))
                err = torch.stack([e for e, _ in errs]).cpu()
                ok = torch.stack([k for _, k in errs]).cpu()
                n_checks += len(labels)
                worst = max(worst, float(err.max()))
                emit({"check": "weighted heads", "d": d, "n": n, "edge": edge, "m": m,
                      "splits": t1_splits(lib, m, n, d), "checks": len(labels),
                      "max_abs_err": float(err.max()), "ok": bool(ok.all())})
                if not bool(ok.all()):
                    bad = [labels[i] for i in range(len(labels)) if not ok[i]]
                    fail(f"kernel_matvec_multi (weighted heads) d={d} n={n} m={m}: "
                         f"{bad[:5]} off the plain version (worst err {float(err.max())})")
    return n_checks, worst


def block_route_cases() -> list[tuple[int, int, int, bool]]:
    """(m, n, d, b is a) at which phase check holds each route of
    kernel_block: the few-columns route at n = 1, 2, 3, 16 and one past the
    skinny routes' limit (``skinny_max()``: the tile route there), m = 1000;
    the few-rows route at m = 1, 2 and one past the limit, n = 3001; the
    symmetric route (b the same tensor as a) and the tile route on a copy at
    132 (one mirrored tile of 4 rows), 1000 (eight tiles, the last ragged:
    float4 stores) and 1001 (n % 4 != 0: float stores); the tile route at
    (1000, 3000) (float4 stores, a ragged last strip) and (257, 1001) (float
    stores); each at d = 1, 16, 17 and 37 (one slab, a full one, the slab
    loop)."""
    from repro_torch.kernels.kernel_block import skinny_max

    limit = skinny_max()
    cases = []
    for d in BLOCK_ROUTE_D:
        cases += [(1000, n, d, False) for n in (1, 2, 3, 16, limit + 1)]
        cases += [(m, 3001, d, False) for m in (1, 2, limit + 1)]
        cases += [(m, m, d, same) for m in (132, 1000, 1001) for same in (True, False)]
        cases += [(1000, 3000, d, False), (257, 1001, d, False)]
    return cases


#: feature widths of block_route_cases
BLOCK_ROUTE_D = (1, 16, 17, 37)


def _check_block_routes(sigma: float) -> tuple[int, float]:
    """kernel_block against its plain version on every route's edges
    (``block_route_cases``), every kernel in f32 and bf16; one line a case
    with the route it took.  Returns (checks, worst error)."""
    import torch

    from repro_torch.core.kernels import KERNEL_NAMES
    from repro_torch.kernels import ref
    from repro_torch.kernels.kernel_block import block_route, kernel_block_cuda, skinny_max

    gen = torch.Generator().manual_seed(26)
    n_checks, worst = 0, 0.0
    for m, n, d, same in block_route_cases():
        a = (torch.randn((m, d), generator=gen) / math.sqrt(d)).cuda()
        b = a if same else (a.clone() if m == n else
                            (torch.randn((n, d), generator=gen) / math.sqrt(d)).cuda())
        if m > 3:
            a[3] = 0.0  # cosine's zero-norm-as-1 rule (b == a or its copy: row 3 of b too)
            if m == n:
                b[3] = 0.0
        errs, labels = [], []
        for kern in KERNEL_NAMES:
            for prec in ("f32", "bf16"):
                got = kernel_block_cuda(a, b, kernel=kern, sigma=sigma, precision=prec)
                want = ref.kernel_block(a, b, sigma, kernel=kern, precision=prec)
                errs.append(_err_on_card(got, want, prec))
                labels.append((kern, prec))
        err = torch.stack([e for e, _ in errs]).cpu()
        ok = torch.stack([k for _, k in errs]).cpu()
        n_checks += len(labels)
        worst = max(worst, float(err.max()))
        route = block_route(m, n, same, skinny_max())
        emit({"check": "kernel_block route", "route": route, "m": m, "n": n, "d": d,
              "b_is_a": same, "checks": len(labels), "max_abs_err": float(err.max()),
              "ok": bool(ok.all())})
        if not bool(ok.all()):
            bad = [labels[i] for i in range(len(labels)) if not ok[i]]
            fail(f"kernel_block ({route}) m={m} n={n} d={d} b_is_a={same}: {bad[:5]} off the "
                 f"plain version (worst err {float(err.max())})")
    return n_checks, worst


def phase_check_determinism() -> None:
    """Two launches of each redesigned kernel at its main-path shape give
    bitwise equal results: the t = 1 kernels at the solve's G_B (50,000 x
    10^6, d = 9), the weighted block at the refit's K_BB (50,000^2), the
    stacked matvec at the tune's sketch (20,000^2 x 100), kernel_matvec
    on its column path at a rank-100 sketch (20,000^2 x 100), both t = 1
    kernels on the split route at a serving bucket (64 x 10^6), and
    kernel_matvec's multi-column sweep at one-vs-all G_Bs of 8, 20 and 32
    heads (50,000 x 10^6 x t) and at 10- and 32-head serving buckets (64 x
    10^6 x t, split), and the weighted heads at a multi-kernel one-vs-all
    G_B of 10 heads and at a 10-head serving bucket (split)."""
    import torch

    from repro_torch.kernels.kernel_block import kernel_block_cuda
    from repro_torch.kernels.kernel_matvec import kernel_matvec_cuda
    from repro_torch.kernels.multi import (
        kernel_block_multi_cuda,
        kernel_matvec_components_cuda,
        kernel_matvec_multi_cuda,
    )

    x, xb, z = main_path_inputs()
    w = (0.5, 0.2, 0.3)
    sg = (SIGMA,) * len(MK_KERNELS)
    xt = x[:N_TUNE]
    omega = torch.randn((N_TUNE, RANK), generator=torch.Generator(device="cuda").manual_seed(9),
                        device="cuda")
    z8, z10, z32 = (torch.randn((N_TRAIN, t), device="cuda",
                                generator=torch.Generator(device="cuda").manual_seed(t))
                    for t in (8, OVA_HEADS, 32))
    z20 = z32[:, :20].contiguous()
    runs = {
        "kernel_matvec": ([BLOCK, N_TRAIN, D, 1], lambda: kernel_matvec_cuda(
            xb, x, z, kernel="rbf", sigma=SIGMA, precision="f32")),
        "kernel_matvec_multi": ([BLOCK, N_TRAIN, D, 1], lambda: kernel_matvec_multi_cuda(
            xb, x, z, w, kernels=MK_KERNELS, sigmas=sg, precision="f32")),
        "kernel_block_multi": ([BLOCK, BLOCK, D], lambda: kernel_block_multi_cuda(
            xb, xb, kernels=MK_KERNELS, sigmas=sg, weights=w, precision="f32")),
        "kernel_matvec_components": ([N_TUNE, N_TUNE, D, RANK], lambda: kernel_matvec_components_cuda(
            xt, xt, omega, kernels=MK_KERNELS, sigmas=sg, precision="f32")),
        "kernel_matvec (t = 100)": ([N_TUNE, N_TUNE, D, RANK], lambda: kernel_matvec_cuda(
            xt, xt, omega, kernel="rbf", sigma=SIGMA, precision="f32")),
        "kernel_matvec (split, m = 64)": ([SMALL_M, N_TRAIN, D, 1], lambda: kernel_matvec_cuda(
            xb[:SMALL_M], x, z, kernel="rbf", sigma=SIGMA, precision="f32")),
        "kernel_matvec_multi (split, m = 64)": (
            [SMALL_M, N_TRAIN, D, 1], lambda: kernel_matvec_multi_cuda(
                xb[:SMALL_M], x, z, w, kernels=MK_KERNELS, sigmas=sg, precision="f32")),
        "kernel_matvec (t = 8)": ([BLOCK, N_TRAIN, D, 8], lambda: kernel_matvec_cuda(
            xb, x, z8, kernel="rbf", sigma=SIGMA, precision="f32")),
        f"kernel_matvec (split, m = 64, t = {OVA_HEADS})": (
            [SMALL_M, N_TRAIN, D, OVA_HEADS], lambda: kernel_matvec_cuda(
                xb[:SMALL_M], x, z10, kernel="rbf", sigma=SIGMA, precision="f32")),
        "kernel_matvec (t = 20)": ([BLOCK, N_TRAIN, D, 20], lambda: kernel_matvec_cuda(
            xb, x, z20, kernel="rbf", sigma=SIGMA, precision="f32")),
        "kernel_matvec (t = 32)": ([BLOCK, N_TRAIN, D, 32], lambda: kernel_matvec_cuda(
            xb, x, z32, kernel="rbf", sigma=SIGMA, precision="f32")),
        "kernel_matvec (split, m = 64, t = 32)": (
            [SMALL_M, N_TRAIN, D, 32], lambda: kernel_matvec_cuda(
                xb[:SMALL_M], x, z32, kernel="rbf", sigma=SIGMA, precision="f32")),
        f"kernel_matvec_multi (t = {OVA_HEADS})": (
            [BLOCK, N_TRAIN, D, OVA_HEADS], lambda: kernel_matvec_multi_cuda(
                xb, x, z10, w, kernels=MK_KERNELS, sigmas=sg, precision="f32")),
        f"kernel_matvec_multi (split, m = 64, t = {OVA_HEADS})": (
            [SMALL_M, N_TRAIN, D, OVA_HEADS], lambda: kernel_matvec_multi_cuda(
                xb[:SMALL_M], x, z10, w, kernels=MK_KERNELS, sigmas=sg, precision="f32")),
    }
    # kernel_block on each route at its path's shape: K_BB (b is a: the
    # symmetric route; b a copy: the tile route), the pivot column (few
    # columns) and SAP's row (few rows)
    xb_copy = xb.clone()
    blk = lambda a, b: lambda: kernel_block_cuda(a, b, kernel="rbf", sigma=SIGMA,  # noqa: E731
                                                 precision="f32")
    runs.update({
        "kernel_block (symmetric, K_BB)": ([BLOCK, BLOCK, D], blk(xb, xb)),
        "kernel_block (tile, K_BB of a copy)": ([BLOCK, BLOCK, D], blk(xb, xb_copy)),
        "kernel_block (skinny columns, pivot column)": ([N_TRAIN, 1, D], blk(x, xb[:1])),
        "kernel_block (skinny rows, SAP row)": ([1, N_TUNE, D], blk(xt[7:8], xt)),
    })
    for name, (shape, fn) in runs.items():
        first = fn()
        second = fn()
        torch.cuda.synchronize()
        same = bool(torch.equal(first, second))
        rec = {"check": "determinism", "kernel": name, "shape": shape, "bitwise_equal": same}
        if name == "kernel_block (symmetric, K_BB)":
            # the mirrored tiles: K(A, A) bitwise its own transpose
            rec["bitwise_symmetric"] = all(
                torch.equal(first[i:i + 4096], first[:, i:i + 4096].T)
                for i in range(0, first.shape[0], 4096))
            if not rec["bitwise_symmetric"]:
                fail(f"{name}: K(A, A) is not bitwise its own transpose")
        emit(rec)
        if not same:
            fail(f"{name}: two launches at shape {shape} differ "
                 f"(max {float((first - second).abs().max())})")
        del first, second
        torch.cuda.empty_cache()
    del x, xb, z, omega, z8, z10, z20, z32, xb_copy
    torch.cuda.empty_cache()


#: the combinations check_multi holds against the plain versions: l2 + l1
#: families, dot + cos, one kernel twice with its own sigmas, and 9 kernels
#: (above the per-launch cap of 8, and of 4 for the stacked matvec)
MULTI_CASES = [
    (("rbf", "laplacian", "matern52"), (1.5, 0.8, 2.2)),
    (("linear", "polynomial", "sigmoid", "cosine"), (1.5, 1.1, 2.0, 1.0)),
    (("rbf", "rbf"), (0.5, 2.0)),
    (("rbf", "laplacian", "matern52", "linear", "polynomial", "sigmoid", "cosine",
      "rbf", "laplacian"), (1.5, 0.8, 2.2, 1.5, 1.1, 2.0, 1.0, 0.6, 3.0)),
]


#: (d, n) edges of the t = 1 sweep, held at t = 1 with m = 1000: d = 1, the
#: register cap (16) and one above it (the slab loop), then n below one
#: staged B tile and one past a multiple of it, for the register path (256
#: rows a tile, d = 9) and the slab loop (64 rows a tile, d = 37)
T1_EDGES = [(1, 3001), (16, 3001), (17, 3001), (9, 100), (9, 257), (37, 50), (37, 65)]


#: kernel_matvec's widths t > 1 in phase check: its multi-column sweep (2,
#: 3, 8, 9 and 10: widths 2, 4, 8 and 12; 17, 20 and 32: widths 20 and 32,
#: the single-kernel tune's 4 lams x 5 folds among them), then its column
#: path: 33 and 64 in a 64-column block, the sketch's rank 100 (one
#: 128-column block, cw 100), the edges of the 128- and 160-column blocks
#: (128; 129 in one 160-column block; 160) and several blocks (161: two of
#: 84 columns; 321: three of 108); the column path's V is padded to a
#: multiple of 4 columns
COLS_T = (2, 3, 8, 9, 10, 17, 20, 32, 33, 64, 100, 128, 129, 160, 161, 321)

#: the multi-column sweep's edges in phase check: each width W (2, 4, 8, 12,
#: 16, 20, 24, 32) at t = W and below it (3, 5, 9, 10, 13, 17, 21, 25), at
#: feature widths 9 and 16 (256-row staged tiles) and 17 and 37 (the slab
#: loop, 64-row tiles); rows of A on the split route (m <= 4096): one row,
#: a bucket of 8, a block's 64 rows and one more
HEADS_T = (2, 3, 5, 8, 9, 10, 12, 13, 16, 17, 20, 21, 24, 25, 32)
HEADS_D = (9, 16, 17, 37)
HEADS_SPLIT_M = (1, 8, 64, 65)

#: the weighted matvec's heads (static weights) in check_multi: widths 2,
#: 4, 12 and 16 at or below their edge, and 17, the first t of the column
#: path, on the multi-column sweep's edges (HEADS_D, split_ns)
WEIGHTED_HEADS_T = (2, 3, 10, 16, 17)

#: the widths at which check_multi also holds the weighted matvec's column
#: path: the tune's 160 columns (one 160-column block), 161 (two 128-column
#: blocks of 84 and 77 columns) and 150 (one ragged 160-column block)
WIDE_T = (160, 161, 150)

#: the stacked matvec's widths in check_multi: 2, the tune's rank 100 (one
#: 128-column block), a ragged 101 (not a multiple of 4: V copied in 4-byte
#: units) and 161 (two column blocks)
STACKED_T = (2, 100, 101, 161)

#: the stacked matvec's combinations: q = 1 (l1 alone), 3 (the tune's l2 +
#: l1), 4 (dot + cos, one full launch) and 5 (two launches of 4 and 1)
STACKED_CASES = [
    (("laplacian",), (0.8,)),
    MULTI_CASES[0],
    MULTI_CASES[1],
    (("rbf", "laplacian", "matern52", "cosine", "rbf"), (1.5, 0.8, 2.2, 1.0, 0.6)),
]

#: (d, m, n) edges of the weighted block, held with every MULTI_CASES
#: combination (q = 9: two launches, the second with accumulate): n % 4 == 0
#: with a ragged last 128-column strip (the float4 store path), m and n below
#: one 64 x 128 warp tile, d = 1, the register cap 16 and one above it (the
#: slab loop), and d = 37
BLOCK_EDGES = [(9, 1000, 3000), (9, 37, 50), (1, 200, 129), (16, 300, 260), (17, 65, 131),
               (37, 1000, 3000)]

#: (d, m) of the weighted block of one point set, b the same tensor as a
#: (the symmetric path: tiles on and above the diagonal, each above it also
#: written transposed) and b a copy of a (the full path): 1000 rows (eight
#: 128-row tiles, the last ragged), 132 (one mirrored tile of 4 rows), 256
#: (two whole tiles) at d = 16, and d = 37 (the slab loop)
SAME_EDGES = [(9, 1000), (9, 132), (16, 256), (37, 1000)]


def phase_check_multi() -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.multi import (
        kernel_block_multi_cuda,
        kernel_matvec_components_cuda,
        kernel_matvec_multi_cuda,
    )

    m, n, t = 1000, 3001, 8
    worst = {"kernel_matvec_multi": 0.0, "kernel_matvec_components": 0.0,
             "kernel_block_multi": 0.0}
    gen = torch.Generator().manual_seed(2)
    rng = np.random.default_rng(2)
    # the wide cases draw from their own streams, so the t = 8 inputs stay
    gen_wide = torch.Generator().manual_seed(6)
    rng_wide = np.random.default_rng(6)
    n_checks = 0

    def check(name, got, want, prec, **case):
        nonlocal n_checks
        torch.cuda.synchronize()
        err, ok = _err(got, want, prec)
        emit({"check": name, "precision": prec, **case, "max_abs_err": err, "ok": ok})
        if not ok:
            fail(f"{name} {prec} {case}: err {err}")
        worst[name] = max(worst[name], err)
        n_checks += 1

    for d in (9, 37):
        a = (torch.randn((m, d), generator=gen) / math.sqrt(d)).cuda()
        b = (torch.randn((n, d), generator=gen) / math.sqrt(d)).cuda()
        a[3] = 0.0  # a zero row: cosine's zero-norm-as-1 rule
        v1 = torch.randn((n,), generator=gen).cuda()
        vt = torch.randn((n, t), generator=gen).cuda()
        v_wide = {tw: torch.randn((n, tw), generator=gen_wide).cuda() for tw in WIDE_T}
        for kernels, sigmas in MULTI_CASES:
            q = len(kernels)
            w = tuple(float(x) for x in rng.dirichlet(np.ones(q)))
            w_t = torch.tensor(w, device="cuda")
            w_cols = torch.from_numpy(rng.dirichlet(np.ones(q), size=t).T.astype(np.float32)).cuda()
            case = {"kernels": list(kernels), "d": d}
            for prec in ("f32", "bf16"):
                for v, wts, label in ((v1, w, "w(q,) v(n,)"), (vt, w, "w(q,) v(n,8)"),
                                      (vt, w_cols, "w(q,8) v(n,8)")):
                    want = ref.kernel_matvec_multi(a, b, v, sigmas, w_cols if wts is w_cols else w_t,
                                                   kernels=kernels, precision=prec)
                    got = kernel_matvec_multi_cuda(a, b, v, wts, kernels=kernels, sigmas=sigmas,
                                                   precision=prec)
                    check("kernel_matvec_multi", got, want, prec, **case, operands=label)
                for v, label in ((v1, "v(n,)"), (vt, "v(n,8)")):
                    want = ref.kernel_matvec_components(a, b, v, sigmas, kernels=kernels,
                                                        precision=prec)
                    got = kernel_matvec_components_cuda(a, b, v, kernels=kernels, sigmas=sigmas,
                                                        precision=prec)
                    check("kernel_matvec_components", got, want, prec, **case, operands=label)
                want = ref.kernel_block_multi(a, b, sigmas, w, kernels=kernels, precision=prec)
                got = kernel_block_multi_cuda(a, b, kernels=kernels, sigmas=sigmas, weights=w,
                                              precision=prec)
                check("kernel_block_multi", got, want, prec, **case)
            # the weighted matvec's column path at the tune's width and at
            # ragged ones, on both column-block widths
            for tw in WIDE_T:
                w_wide = torch.from_numpy(
                    rng_wide.dirichlet(np.ones(q), size=tw).T.astype(np.float32)).cuda()
                for prec in ("f32", "bf16"):
                    for wts, label in ((w, f"w(q,) v(n,{tw})"), (w_wide, f"w(q,{tw}) v(n,{tw})")):
                        want = ref.kernel_matvec_multi(
                            a, b, v_wide[tw], sigmas, w_wide if wts is w_wide else w_t,
                            kernels=kernels, precision=prec)
                        got = kernel_matvec_multi_cuda(a, b, v_wide[tw], wts, kernels=kernels,
                                                       sigmas=sigmas, precision=prec)
                        check("kernel_matvec_multi", got, want, prec, **case, operands=label)
        # t = 1 with a device (q, 1) weight column and v of shape (n, 1)
        for kernels, sigmas in MULTI_CASES:
            q = len(kernels)
            w_col = torch.from_numpy(rng.dirichlet(np.ones(q))[:, None].astype(np.float32)).cuda()
            for prec in ("f32", "bf16"):
                want = ref.kernel_matvec_multi(a, b, v1[:, None], sigmas, w_col, kernels=kernels,
                                               precision=prec)
                got = kernel_matvec_multi_cuda(a, b, v1[:, None], w_col, kernels=kernels,
                                               sigmas=sigmas, precision=prec)
                check("kernel_matvec_multi", got, want, prec, kernels=list(kernels), d=d,
                      operands="w(q,1) v(n,1)")
    # the t = 1 sweep's edges (T1_EDGES), (q,) weights on a 1-D v
    gen_edge = torch.Generator().manual_seed(8)
    rng_edge = np.random.default_rng(8)
    for d, n_e in T1_EDGES:
        a = (torch.randn((m, d), generator=gen_edge) / math.sqrt(d)).cuda()
        b = (torch.randn((n_e, d), generator=gen_edge) / math.sqrt(d)).cuda()
        a[3] = 0.0
        v1 = torch.randn((n_e,), generator=gen_edge).cuda()
        for kernels, sigmas in MULTI_CASES:
            w = tuple(float(x) for x in rng_edge.dirichlet(np.ones(len(kernels))))
            for prec in ("f32", "bf16"):
                want = ref.kernel_matvec_multi(a, b, v1, sigmas, torch.tensor(w, device="cuda"),
                                               kernels=kernels, precision=prec)
                got = kernel_matvec_multi_cuda(a, b, v1, w, kernels=kernels, sigmas=sigmas,
                                               precision=prec)
                check("kernel_matvec_multi", got, want, prec, kernels=list(kernels), d=d, n=n_e,
                      operands="w(q,) v(n,)")
    # the stacked matvec at the tune's rank, ragged and two-block widths
    gen_st = torch.Generator().manual_seed(10)
    for d in (9, 37):
        a = (torch.randn((m, d), generator=gen_st) / math.sqrt(d)).cuda()
        b = (torch.randn((n, d), generator=gen_st) / math.sqrt(d)).cuda()
        a[3] = 0.0
        for ts in STACKED_T:
            v = torch.randn((n, ts), generator=gen_st).cuda()
            for kernels, sigmas in STACKED_CASES:
                for prec in ("f32", "bf16"):
                    want = ref.kernel_matvec_components(a, b, v, sigmas, kernels=kernels,
                                                        precision=prec)
                    got = kernel_matvec_components_cuda(a, b, v, kernels=kernels, sigmas=sigmas,
                                                        precision=prec)
                    check("kernel_matvec_components", got, want, prec, kernels=list(kernels), d=d,
                          operands=f"v(n,{ts})")
    # the weighted block at its edges, and with b the same tensor as a (packed
    # once) and a copy of it
    gen_bl = torch.Generator().manual_seed(11)
    rng_bl = np.random.default_rng(11)
    for d, m_e, n_e in BLOCK_EDGES:
        a = (torch.randn((m_e, d), generator=gen_bl) / math.sqrt(d)).cuda()
        b = (torch.randn((n_e, d), generator=gen_bl) / math.sqrt(d)).cuda()
        a[3] = 0.0
        for kernels, sigmas in MULTI_CASES:
            w = tuple(float(x) for x in rng_bl.dirichlet(np.ones(len(kernels))))
            for prec in ("f32", "bf16"):
                want = ref.kernel_block_multi(a, b, sigmas, w, kernels=kernels, precision=prec)
                got = kernel_block_multi_cuda(a, b, kernels=kernels, sigmas=sigmas, weights=w,
                                              precision=prec)
                check("kernel_block_multi", got, want, prec, kernels=list(kernels), d=d, m=m_e,
                      n=n_e)
    for d, m_e in SAME_EDGES:
        a = (torch.randn((m_e, d), generator=gen_bl) / math.sqrt(d)).cuda()
        for kernels, sigmas in MULTI_CASES:
            w = tuple(float(x) for x in rng_bl.dirichlet(np.ones(len(kernels))))
            for prec in ("f32", "bf16"):
                want = ref.kernel_block_multi(a, a.clone(), sigmas, w, kernels=kernels,
                                              precision=prec)
                for b, label in ((a, "b is a"), (a.clone(), "b a copy of a")):
                    got = kernel_block_multi_cuda(a, b, kernels=kernels, sigmas=sigmas,
                                                  weights=w, precision=prec)
                    check("kernel_block_multi", got, want, prec, kernels=list(kernels), d=d,
                          m=m_e, operands=label)
    heads_checks, heads_worst = _check_weighted_heads()
    worst["kernel_matvec_multi"] = max(worst["kernel_matvec_multi"], heads_worst)
    emit({"phase": "check_multi", "m": m, "n": n, "t": [t, *WIDE_T], "t1_edges": T1_EDGES,
          "stacked_t": STACKED_T, "block_edges": BLOCK_EDGES, "checks": n_checks,
          "weighted_heads_t": WEIGHTED_HEADS_T, "weighted_heads_checks": heads_checks,
          "worst_abs_err": worst})
    return worst


_TAXI = {}


def taxi_data():
    """The taxi configuration's rows on the card, made once: (x, y) of
    ``taxi_like(0, N_TRAIN + N_TEST, D)``."""
    from repro_torch.data import synthetic

    if not _TAXI:
        _TAXI["xy"] = synthetic.taxi_like(0, N_TRAIN + N_TEST, D, device="cuda")
    return _TAXI["xy"]


def _path_launches(launches: dict, names: tuple[str, ...], path: str) -> None:
    """Fail unless every kernel of ``names`` launched in the path's run."""
    if min(launches[k] for k in names) <= 0:
        fail(f"a kernel of the {path} path was never launched: {launches}")


def _on_card(path: str, **tensors) -> None:
    off_card = [k for k, v in tensors.items() if v.device.type != "cuda"]
    if off_card:
        fail(f"{path}: tensors off the card: {off_card}")


def phase_solve() -> dict:
    import torch

    from repro_torch.core.krr import KRRProblem, evaluate
    from repro_torch.core.solver_api import solve
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.kernel_matvec import kernel_matvec_cuda

    x, y = taxi_data()
    problem = KRRProblem(x=x[:N_TRAIN], y=y[:N_TRAIN], kernel="rbf", sigma=SIGMA,
                         lam_unscaled=LAM_UNSCALED, precision="f32")
    x_te, y_te = x[N_TRAIN:], y[N_TRAIN:]
    # two warm-up steps first (cuBLAS / cuSOLVER handles, the first QR and
    # eigh), so iter_ms is the steady state phase ``telemetry`` compares with
    solve(problem, "askotch", block_size=BLOCK, rank=RANK, max_iters=2, eval_every=2)
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
    _on_card("solve", x=problem.x, y=problem.y, w=out.w, pred=pred)
    _path_launches(launches, ("kernel_matvec", "kernel_block"), "solve")
    if not (math.isfinite(rel) and rel < 1.0):
        fail(f"final rel_residual {rel} is not finite and below its start of 1.0")
    if not (math.isfinite(rmse) and pred.shape == (N_TEST,)):
        fail(f"prediction not finite / wrong shape: rmse {rmse}, shape {tuple(pred.shape)}")
    if not pred_ok:
        fail(f"kernel_matvec's prediction disagrees with its plain version: err {pred_err}")
    if not kw_ok:
        fail(f"kernel_matvec's residual pass disagrees with its plain version: err {kw_err}")
    return rec, out.w


def _tune_weight_cols(result) -> "np.ndarray":
    """The (q, C) per-column weights of the tune's stacked solve: each
    weight sample's row repeated over its lams x folds columns."""
    import numpy as np

    w_mat = np.asarray([r["weights"] for r in result.records[::len(TUNE_LAMS)]], np.float32)
    return np.repeat(w_mat.T, len(TUNE_LAMS) * K_FOLDS, axis=1)


def phase_tune() -> tuple[dict, object]:
    import torch

    from repro_torch.core.krr import KRRProblem
    from repro_torch.core.tune import tune_multikernel
    from repro_torch.kernels import ops, ref

    x, y = taxi_data()
    problem = KRRProblem(x=x[:N_TUNE], y=y[:N_TUNE], kernel=MK_KERNELS, precision="f32")
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    result = tune_multikernel(
        problem, kernels=MK_KERNELS, sigmas=(SIGMA,), lams=TUNE_LAMS, folds=K_FOLDS,
        n_weight_samples=M_WEIGHTS, rank=RANK, max_iters=TUNE_ITERS, tol=TUNE_TOL, seed=0,
    )
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.launches()

    # the two kernel calls of the tune, each held against its plain version
    # at the tune's shapes: one CG step's matvec_cols and the sketch
    op = problem.op
    gen = torch.Generator(device="cuda").manual_seed(3)
    cols = len(TUNE_LAMS) * K_FOLDS * M_WEIGHTS
    v = torch.randn((N_TUNE, cols), generator=gen, device="cuda")
    wc = torch.from_numpy(_tune_weight_cols(result)).cuda()
    mv_err, mv_ok = _err(op.matvec_cols(v, wc),
                         ref.kernel_matvec_multi(op.x, op.x, v, op.sigmas, wc, kernels=op.kernels),
                         "f32")
    omega, _ = torch.linalg.qr(torch.randn((N_TUNE, RANK), generator=gen, device="cuda"))
    sk_err, sk_ok = _err(op.sketch_components(omega),
                         ref.kernel_matvec_components(op.x, op.x, omega, op.sigmas,
                                                      kernels=op.kernels), "f32")
    rec = {"phase": "tune", "n": N_TUNE, "d": D, "kernels": list(MK_KERNELS), "sigmas": [SIGMA],
           "lams": list(TUNE_LAMS), "folds": K_FOLDS, "weight_samples": M_WEIGHTS,
           "columns": cols, "rank": RANK, "max_iters": TUNE_ITERS, "tol": TUNE_TOL,
           "best": result.best, "sweeps": result.sweeps,
           "iters_by_sigma": result.info["iters_by_sigma"], "seconds": seconds,
           "launches": launches, "matvec_cols_max_abs_err": mv_err, "matvec_cols_ok": mv_ok,
           "sketch_components_max_abs_err": sk_err, "sketch_components_ok": sk_ok,
           "reduced": "n 1e8 -> 2e4: 160 columns per CG iteration, one-card time limit"}
    emit(rec)
    _on_card("tune", x=problem.x, y=problem.y)
    _path_launches(launches, ("kernel_matvec_multi", "kernel_matvec_components"), "tune")
    if not math.isfinite(result.best["cv_mse"]):
        fail(f"tune: best cv_mse {result.best['cv_mse']} is not finite")
    if not mv_ok:
        fail(f"matvec_cols disagrees with its plain version: err {mv_err}")
    if not sk_ok:
        fail(f"sketch_components disagrees with its plain version: err {sk_err}")
    return rec, result


def phase_refit(best: dict) -> tuple[dict, object]:
    import dataclasses

    import torch

    from repro_torch.core.krr import KRRProblem, evaluate
    from repro_torch.core.solver_api import solve
    from repro_torch.kernels import ops, ref

    x, y = taxi_data()
    kernels, weights = tuple(best["kernel"]), tuple(best["weights"])
    problem = KRRProblem(x=x[:N_TRAIN], y=y[:N_TRAIN], sigma=best["sigma"],
                         lam_unscaled=best["lam_unscaled"], precision="f32")
    x_te, y_te = x[N_TRAIN:], y[N_TRAIN:]
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = solve(problem, "askotch", kernel=kernels, weights=weights, block_size=BLOCK,
                rank=RANK, max_iters=MAX_ITERS, eval_every=MAX_ITERS)
    pred = out.predict_fn(x_te)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches()

    # the path's three shapes, each against the plain version: G_B for a
    # block of the rows with the solution as right-hand side, K_BB of that
    # block, and the prediction
    op = dataclasses.replace(problem, kernel=kernels, weights=weights).op
    w_t = torch.tensor(op.weights, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)
    xb = op.x.index_select(0, torch.randperm(N_TRAIN, generator=gen, device="cuda")[:BLOCK])
    gb_err, gb_ok = _err(op.row_block_matvec(xb, out.w),
                         ref.kernel_matvec_multi(xb, op.x, out.w, op.sigmas, w_t,
                                                 kernels=op.kernels), "f32")
    kbb_err, kbb_ok = _err(op.block(xb),
                           ref.kernel_block_multi(xb, xb, op.sigmas, op.weights,
                                                  kernels=op.kernels), "f32")
    torch.cuda.empty_cache()
    pred_err, pred_ok = _err(pred, ref.kernel_matvec_multi(x_te, op.x, out.w, op.sigmas, w_t,
                                                           kernels=op.kernels), "f32")
    # the residual pass's K_w w (15,625 row tiles), relaunched on the same
    # inputs (the kernel is deterministic)
    t1 = time.perf_counter()
    kw = op.matvec(out.w)
    torch.cuda.synchronize()
    residual_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    kw_want = ref.kernel_matvec_multi(op.x, op.x, out.w, op.sigmas, w_t, kernels=op.kernels)
    torch.cuda.synchronize()
    residual_plain_s = time.perf_counter() - t2
    kw_err, kw_ok = _err(kw, kw_want, "f32")
    del kw, kw_want
    rel = out.history[-1]["rel_residual"]
    rmse = float(evaluate(pred, y_te).rmse)
    rec = {"phase": "refit", "n": N_TRAIN, "n_test": N_TEST, "kernels": list(kernels),
           "weights": list(weights), "sigma": best["sigma"], "lam_unscaled": best["lam_unscaled"],
           "block_size": BLOCK, "rank": RANK, "iters": out.info["iters"], "rel_residual": rel,
           "test_rmse": rmse, "solve_s": out.info["wall_time_s"], "wall_s_with_predict": wall,
           "launches": launches, "gb_max_abs_err": gb_err, "gb_ok": gb_ok,
           "kbb_max_abs_err": kbb_err, "kbb_ok": kbb_ok,
           "predict_max_abs_err": pred_err, "predict_ok": pred_ok,
           "residual_kw_max_abs_err": kw_err, "residual_kw_ok": kw_ok,
           "residual_s": residual_s, "residual_plain_s": residual_plain_s,
           "reduced": "n 1e8 -> 1e6 (+1e4 test): O(n^2 d) residual, one-card time limit"}
    emit(rec)
    _on_card("refit", x=op.x, w=out.w, pred=pred)
    _path_launches(launches, ("kernel_matvec_multi", "kernel_block_multi"), "refit")
    if not (math.isfinite(rel) and rel < 1.0):
        fail(f"refit: final rel_residual {rel} is not finite and below its start of 1.0")
    if not (math.isfinite(rmse) and pred.shape == (N_TEST,)):
        fail(f"refit: prediction not finite / wrong shape: rmse {rmse}, shape {tuple(pred.shape)}")
    for name, ok, err in (("G_B", gb_ok, gb_err), ("K_BB", kbb_ok, kbb_err),
                          ("prediction", pred_ok, pred_err), ("residual pass", kw_ok, kw_err)):
        if not ok:
            fail(f"refit: {name} disagrees with its plain version: err {err}")
    return rec, out.w


#: the paper's baseline set (benchmarks/bench_fig1_showdown.py:25-31) with
#: the iteration budgets cut to fit the run: (method, options, the kernels
#: its path launches, what was cut beyond n 1e8 -> 1e6)
FALKON_M, N_DIRECT, SKETCH_ROWS = 20_000, 20_000, 2_048
EIGENPRO_BATCH, EIGENPRO_SUB = N_TRAIN // 100, 1000  # the reference's default batch
PCG_FAMILY = ("pcg-nystrom", "pcg-rpcholesky", "pcg-rff", "cg")
BASELINES = (
    ("pcg-nystrom", {"rank": 100, "max_iters": 20}, ("kernel_matvec",), ""),
    ("pcg-rpcholesky", {"rank": 50, "max_iters": 10}, ("kernel_matvec", "kernel_block"), ""),
    ("pcg-rff", {"rank": 100, "max_iters": 10}, ("kernel_matvec",), ""),
    ("cg", {"max_iters": 10}, ("kernel_matvec",), ""),
    ("falkon", {"m": FALKON_M, "max_iters": 20}, ("kernel_matvec", "kernel_block"),
     "; m 2e4: K_mm 1.6 GB and a 2e10-pair sweep a side"),
    ("eigenpro", {"rank": 100, "subsample": EIGENPRO_SUB, "epochs": 1},
     ("kernel_matvec", "kernel_block"), ""),
    ("direct", {}, ("kernel_matvec", "kernel_block"),
     "; n 1e6 -> 2e4 (the first rows): O(n^2) memory, O(n^3) time"),
)


def _sketch_probe(seen: dict):
    """A stand-in for ``KernelOperator.sketch`` that records CUDA events
    around the call and keeps its omega and output in ``seen``."""
    import torch

    from repro_torch.core.operator import KernelOperator

    plain_sketch = KernelOperator.sketch

    def sketch(self, omega):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = plain_sketch(self, omega)
        end.record()
        seen.update(x=self.x, omega=omega, out=out, events=(start, end))
        return out

    return plain_sketch, sketch


def _svd_times(z) -> dict:
    """One run each (CUDA events) of the thin SVD the port takes,
    ``torch.linalg.svd(z)``, and of the SVD of R from ``z = QR`` on a tall
    z, and the largest relative difference of their singular values."""
    import torch

    def timed(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        s = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), s

    svd_ms, s_plain = timed(lambda: torch.linalg.svd(z, full_matrices=False)[1])
    qr_ms, s_qr = timed(lambda: torch.linalg.svd(torch.linalg.qr(z)[1], full_matrices=False)[1])
    return {"svd_shape": list(z.shape), "svd_ms": svd_ms, "qr_svd_ms": qr_ms,
            "s_max_rel_diff": float(((s_plain - s_qr).abs() / s_plain.clamp_min(1e-30)).max())}


def _held(name: str, got, want) -> dict:
    """One check of a kernel at a baseline's path shape against its plain
    version (``_err`` tolerances)."""
    import torch

    torch.cuda.synchronize()
    err, ok = _err(got, want, "f32")
    return {"check": name, "shape": list(want.shape), "max_abs_err": err, "ok": ok}


def _baseline_checks(method: str, problem, seen: dict) -> list[dict]:
    """Hold each kernel launch shape of ``method``'s path against the plain
    version, on the path's own operands where the path exposes them."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.kernel_block import kernel_block_cuda
    from repro_torch.kernels.kernel_matvec import kernel_matvec_cuda

    x = problem.x
    gen = torch.Generator(device="cuda").manual_seed(12)
    mv = lambda a, b, v: kernel_matvec_cuda(a, b, v, kernel="rbf", sigma=SIGMA,  # noqa: E731
                                            precision="f32")
    if method == "pcg-nystrom":  # SKETCH_ROWS rows of the sketch's own output
        rows = torch.randperm(N_TRAIN, generator=gen, device="cuda")[:SKETCH_ROWS]
        got = seen["out"].index_select(0, rows)
        return [_held("sketch rows", got, ref.kernel_matvec(
            seen["x"].index_select(0, rows), seen["x"], seen["omega"], SIGMA))]
    if method == "pcg-rpcholesky":  # one pivot column, in full
        xp = x[int(torch.randint(N_TRAIN, (1,), generator=gen, device="cuda"))][None]
        return [_held("pivot column", kernel_block_cuda(x, xp, kernel="rbf", sigma=SIGMA,
                                                        precision="f32"),
                      ref.kernel_block(x, xp, SIGMA))]
    if method == "falkon":  # the solve's centers: K(X, X_m) v and K(X_m, X) u
        centers = torch.randperm(N_TRAIN, generator=torch.Generator(device="cuda").manual_seed(0),
                                 device="cuda")[:FALKON_M]
        xm = x.index_select(0, centers)
        v = torch.randn((FALKON_M,), generator=gen, device="cuda")
        u = torch.randn((N_TRAIN,), generator=gen, device="cuda")
        return [_held("K(X, X_m) v", mv(x, xm, v), ref.kernel_matvec(x, xm, v, SIGMA)),
                _held("K(X_m, X) u", mv(xm, x, u), ref.kernel_matvec(xm, x, u, SIGMA))]
    if method == "eigenpro":  # a batch gradient, and K_SB g
        # a unit-scale W: EigenPro's own iterate may diverge, and then K W
        # cancels terms far larger than itself, which f32 sums in another
        # order cannot match to a tolerance scaled by |K W|
        idx = torch.randperm(N_TRAIN, generator=gen, device="cuda")
        xb = x.index_select(0, idx[:EIGENPRO_BATCH])
        xs = x.index_select(0, idx[EIGENPRO_BATCH:EIGENPRO_BATCH + EIGENPRO_SUB])
        w = torch.randn((N_TRAIN, 1), generator=gen, device="cuda")
        g = torch.randn((EIGENPRO_BATCH, 1), generator=gen, device="cuda")
        return [_held("batch gradient K(x_B, X) W", mv(xb, x, w), ref.kernel_matvec(xb, x, w, SIGMA)),
                _held("K_SB g", mv(xs, xb, g), ref.kernel_matvec(xs, xb, g, SIGMA))]
    if method == "direct":  # K of the rows, in full
        return [_held("K", kernel_block_cuda(x, x, kernel="rbf", sigma=SIGMA, precision="f32"),
                      ref.kernel_block(x, x, SIGMA))]
    return []


def phase_baselines() -> list[dict]:
    """The paper's baselines through ``solver_api.solve`` on phase 4's taxi
    data (d = 9, rbf, sigma 1, lam_unscaled 2e-7, f32; n = 10^6, direct on
    the first 20,000 rows), one line a method: iterations, seconds, the
    final relative residual (Falkon -1, as the reference launcher), test
    RMSE, the path's launches (zeroed before, read after) and the checks of
    its kernel shapes against their plain versions."""
    import numpy as np
    import torch

    from repro_torch.core.krr import KRRProblem, evaluate
    from repro_torch.core.operator import KernelOperator
    from repro_torch.core.solver_api import solve
    from repro_torch.kernels import ops

    x, y = taxi_data()
    x_te, y_te = x[N_TRAIN:], y[N_TRAIN:]
    recs = []
    for method, kw, path_kernels, cut in BASELINES:
        n = N_DIRECT if method == "direct" else N_TRAIN
        problem = KRRProblem(x=x[:n], y=y[:n], kernel="rbf", sigma=SIGMA,
                             lam_unscaled=LAM_UNSCALED, precision="f32")
        seen: dict = {}
        plain_sketch, probe = _sketch_probe(seen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        KernelOperator.sketch = probe
        try:
            t0 = time.perf_counter()
            out = solve(problem, method, **kw)
            pred = out.predict_fn(x_te)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            KernelOperator.sketch = plain_sketch
        launches = ops.launches()
        rel, energy = -1.0, None
        if method != "falkon":  # one residual pass: the residual and CG's objective
            kw_w = problem.op.k_lam_matvec(out.w, problem.lam)
            rel = float(torch.linalg.vector_norm(kw_w - problem.y)
                        / torch.linalg.vector_norm(problem.y))
            energy = float(0.5 * (out.w.double() @ kw_w.double())
                           - problem.y.double() @ out.w.double())
            del kw_w
        rmse = float(evaluate(pred, y_te).rmse)
        rec = {"phase": "baselines", "method": method, "n": n, "n_test": N_TEST, **kw,
               "iters": out.info.get("iters"), "seconds": seconds,
               "solve_s": out.info.get("wall_time_s"), "rel_residual": rel,
               "rel_residual_start": 1.0, "energy": energy, "energy_start": 0.0,
               "history_rel_residual": [h["rel_residual"] for h in out.history],
               "test_rmse": rmse, "launches": launches,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        times = [h["time_s"] for h in out.history]
        if len(times) > 1:  # CG-type: host clock between iterations (each syncs)
            rec["iter_ms"] = 1e3 * float(np.median(np.diff(times)))
            rec["setup_s"] = times[0] - rec["iter_ms"] / 1e3
        if "events" in seen:
            rec["sketch_ms"] = seen["events"][0].elapsed_time(seen["events"][1])
            rec["sketch_shape"] = [n, n, D, int(seen["omega"].shape[1])]
        rec["checks"] = _baseline_checks(method, problem, seen)
        if method == "pcg-rff":  # the factor's thin SVD, two ways, on its features
            from repro_torch.core.rff import DEFAULT_OVERSAMPLE, rff_features

            rec.update(_svd_times(rff_features(
                torch.Generator(device="cuda").manual_seed(0), problem.x,
                DEFAULT_OVERSAMPLE["rbf"] * kw["rank"], SIGMA)))
        rec["reduced"] = "n 1e8 -> 1e6 (+1e4 test): O(n^2 d) residual, one-card time limit" + cut
        emit(rec)
        _on_card(method, w=out.w, pred=pred)
        _path_launches(launches, path_kernels, method)
        for c in rec["checks"]:
            if not c["ok"]:
                fail(f"{method}: {c['check']} disagrees with its plain version: "
                     f"err {c['max_abs_err']}")
        if method == "direct" and not (math.isfinite(rel) and rel < 1.0):
            fail(f"direct: final rel_residual {rel} is not finite and below its start of 1.0")
        # CG's residual norm is not monotone (on this data it climbs above its
        # start within 10 iterations, in the JAX package too); its objective
        # 1/2 w'(K + lam I)w - y'w is, and starts at 0 for w = 0
        if method in PCG_FAMILY and not (math.isfinite(rel) and energy < 0.0):
            fail(f"{method}: residual {rel} not finite or objective {energy} not below "
                 "its start of 0")
        if method != "eigenpro" and not (math.isfinite(rmse) and pred.shape == (N_TEST,)):
            fail(f"{method}: prediction not finite / wrong shape: rmse {rmse}, "
                 f"shape {tuple(pred.shape)}")
        recs.append(rec)
        del out, pred, seen
        torch.cuda.empty_cache()
    return recs


# phase estimators: the CV searches of phase tune (single-kernel sigmas as
# the krr_tune launcher's default), and the precomputed fit's rows and alpha
CV_SIGMAS = (0.5, 1.0, 2.0)
N_PRE, PRE_ALPHA = 2_000, LAM_UNSCALED * N_TRAIN
# phase sap: the tune rows, b and NSAP's (mu, nu) of tests/test_core_solvers.py;
# lam_unscaled 1e-4 keeps the exact block solves' f32 error (cond(K_BB + lam
# I) times the f32 epsilon) below the check's tolerance: at the taxi 2e-7
# the f32 iterate is 7e-4 off its f64 value after 10 steps
SAP_B, SAP_LAM_UNSCALED, SAP_CHECK_STEPS = 2_000, 1e-4, 10


def _step_ms(out, residual_s: float) -> float:
    """ms a step of a solve whose one evaluation is its last step: the last
    record's time less one residual pass, over the iterations."""
    return 1e3 * (out.history[-1]["time_s"] - residual_s) / out.info["iters"]


def _tile_work(b: int, n: int, d: int, steps: int) -> tuple[float, float]:
    """``record_tile_work``'s f32 flops and bytes for ``steps`` ASkotch
    steps: a (b, b) K_BB block and a (b, n) G_B matvec each."""
    def one(rows: int, cols: int) -> tuple[float, float]:
        return rows * cols * (2 * d + 8), (rows * d + cols * d + cols) * 4.0 + rows * 4.0

    (f1, b1), (f2, b2) = one(b, b), one(b, n)
    return steps * (f1 + f2), steps * (b1 + b2)


def phase_telemetry(solve_rec: dict) -> dict:
    """Phase solve's configuration with telemetry: disabled, enabled
    (JSONL), enabled (ring), disabled; then one tune with telemetry."""
    import torch

    from repro_torch.core.krr import KRRProblem
    from repro_torch.core.solver_api import solve, tune
    from repro_torch.obs import Telemetry, diff, snapshot, validate_jsonl
    from repro_torch.obs.metrics import roofline_time_s

    x, y = taxi_data()
    problem = KRRProblem(x=x[:N_TRAIN], y=y[:N_TRAIN], kernel="rbf", sigma=SIGMA,
                         lam_unscaled=LAM_UNSCALED, precision="f32")
    residual_s = solve_rec["residual_s"]
    OUT_DIR.mkdir(exist_ok=True)
    path = OUT_DIR / "telemetry_solve.jsonl"
    path.unlink(missing_ok=True)

    def run(tel):
        torch.cuda.synchronize()
        return solve(problem, "askotch", block_size=BLOCK, rank=RANK, max_iters=MAX_ITERS,
                     eval_every=MAX_ITERS, telemetry=tel)

    off1 = _step_ms(run(None), residual_s)
    tel = Telemetry(jsonl=str(path))
    s0 = snapshot()
    out = run(tel)
    delta = diff(s0, snapshot())
    tel.close()
    on1 = _step_ms(out, residual_s)
    on2 = _step_ms(run(Telemetry(ring=True)), residual_s)
    off2 = _step_ms(run(None), residual_s)
    off_ms, on_ms = statistics.median([off1, off2]), statistics.median([on1, on2])

    counts = validate_jsonl(str(path))
    with open(path) as fh:
        spans = [e for e in map(json.loads, fh)
                 if e["type"] == "span" and e["name"] == "solve/askotch"]
    flops, nbytes = _tile_work(BLOCK, N_TRAIN, D, MAX_ITERS)
    got_flops = delta.get('repro_tile_flops_total{dtype="f32"}')
    got_bytes = delta.get('repro_tile_bytes_total{dtype="f32"}')
    roof_ms = 1e3 * roofline_time_s(got_flops or 0.0, got_bytes or 0.0) / MAX_ITERS

    tp = KRRProblem(x=x[:N_TUNE], y=y[:N_TUNE], kernel="rbf", precision="f32")
    tune_path = OUT_DIR / "telemetry_tune.jsonl"
    tune_path.unlink(missing_ok=True)
    tel = Telemetry(jsonl=str(tune_path))
    s0 = snapshot()
    t0 = time.perf_counter()
    res = tune(tp, sigmas=(SIGMA,), lams=TUNE_LAMS, folds=K_FOLDS, rank=RANK,
               max_iters=TUNE_ITERS, tol=TUNE_TOL, seed=0, telemetry=tel)
    tune_s = time.perf_counter() - t0
    tdelta = diff(s0, snapshot())
    tel.close()
    tune_counts = validate_jsonl(str(tune_path))
    pairs = tdelta.get("repro_kernel_pairs_total", 0.0)
    cg_iters = tdelta.get("repro_cg_iterations_total", 0.0)

    rec = {"phase": "telemetry", "step_ms_disabled": [off1, off2],
           "step_ms_enabled": [on1, on2], "step_ms_disabled_median": off_ms,
           "step_ms_enabled_median": on_ms, "step_ms_phase_solve": solve_rec["iter_ms"],
           "disabled_vs_phase_solve": off_ms / solve_rec["iter_ms"] - 1.0,
           "enabled_overhead": on_ms / off_ms - 1.0, "jsonl_counts": counts,
           "history_records": len(out.history),
           "span_dur_s": spans[0]["dur_s"] if spans else None,
           "last_time_s": out.history[-1]["time_s"],
           "tile_flops": got_flops, "tile_bytes": got_bytes, "tile_flops_want": flops,
           "tile_bytes_want": nbytes, "roofline_step_ms": roof_ms,
           "tune_seconds": tune_s, "tune_sweeps": res.sweeps, "tune_pairs": pairs,
           "tune_cg_iterations": cg_iters, "tune_jsonl_counts": tune_counts}
    emit(rec)
    if counts.get("trace") != len(out.history) or counts.get("span") != 1:
        fail(f"telemetry: {counts} events for {len(out.history)} history records")
    if not spans or spans[0]["dur_s"] < out.history[-1]["time_s"]:
        fail("telemetry: the solve/askotch span does not cover the last record")
    if (got_flops, got_bytes) != (flops, nbytes):
        fail(f"telemetry: tile counters {got_flops}, {got_bytes} != {flops}, {nbytes}")
    if abs(off_ms / solve_rec["iter_ms"] - 1.0) > 0.02:
        fail(f"telemetry: disabled step {off_ms} ms not within 2 % of phase solve's "
             f"{solve_rec['iter_ms']} ms")
    if not math.isclose(pairs, res.sweeps * N_TUNE**2, rel_tol=1e-12) or cg_iters <= 0:
        fail(f"telemetry: tune pairs {pairs} != sweeps x n^2 = {res.sweeps * N_TUNE**2} "
             f"or cg iterations {cg_iters}")
    return rec


def phase_estimators(solve_rec: dict, solve_w, tune_result) -> dict:
    """The estimators on the card without scikit-learn: KernelRidge at the
    taxi configuration against phase solve, KernelRidgeCV against a direct
    ``tune()``, MultipleKernelRidgeCV against phase tune, and a precomputed
    fit against the rbf fit of the same rows."""
    import numpy as np
    import torch

    from repro_torch.core.krr import KRRProblem, evaluate
    from repro_torch.core.solver_api import tune
    from repro_torch.estimators import (
        HAVE_SKLEARN,
        KernelRidge,
        KernelRidgeCV,
        MultipleKernelRidgeCV,
    )
    from repro_torch.kernels import ops

    x, y = taxi_data()
    x_te, y_te = x[N_TRAIN:], y[N_TRAIN:]
    est = KernelRidge(alpha=LAM_UNSCALED * N_TRAIN, kernel="rbf", sigma=SIGMA, solver="askotch",
                      solver_opts=dict(block_size=BLOCK, rank=RANK, max_iters=MAX_ITERS,
                                       eval_every=MAX_ITERS, seed=0))
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    est.fit(x[:N_TRAIN], y[:N_TRAIN])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    pred = est.predict(x_te)
    torch.cuda.synchronize()
    predict_ms = 1e3 * (time.perf_counter() - t1)
    kr_launches = ops.launches()
    score = est.score(x_te, y_te)
    rmse = float(evaluate(pred, y_te).rmse)
    bitwise = bool(torch.equal(est.dual_coef_, solve_w))
    w_err, w_ok = _err(est.dual_coef_, solve_w, "f32")

    xs, ys = x[:N_TUNE], y[:N_TUNE]
    alphas = tuple(N_TUNE * lam for lam in TUNE_LAMS)
    tune_opts = dict(rank=RANK, max_iters=TUNE_ITERS, tol=TUNE_TOL)
    ops.reset_launches()
    t0 = time.perf_counter()
    cv = KernelRidgeCV(alphas=alphas, sigmas=CV_SIGMAS, cv=K_FOLDS, tune_opts=tune_opts).fit(xs, ys)
    torch.cuda.synchronize()
    cv_s = time.perf_counter() - t0
    cv_launches = ops.launches()
    # the single-kernel tune: per sigma one stacked CG over 4 lams x 5 folds
    # = 20 columns (kernel_matvec's multi-column sweep at 20,000^2 x 20)
    ops.reset_launches()
    t0 = time.perf_counter()
    direct = tune(KRRProblem(x=xs, y=ys, kernel="rbf", precision="f32"), sigmas=CV_SIGMAS,
                  lams=tuple(a / N_TUNE for a in alphas), folds=K_FOLDS, policy="grid", seed=0,
                  **tune_opts)
    torch.cuda.synchronize()
    tune_s = time.perf_counter() - t0
    tune_launches = ops.launches()
    direct_best = {"alpha": float(direct.best["lam_unscaled"]) * N_TUNE,
                   "sigma": direct.best["sigma"]}

    w_rows = np.asarray([r["weights"] for r in tune_result.records[::len(TUNE_LAMS)]])
    ops.reset_launches()
    t0 = time.perf_counter()
    mk = MultipleKernelRidgeCV(kernels=MK_KERNELS, alphas=alphas, sigmas=(SIGMA,), cv=K_FOLDS,
                               n_weight_samples=M_WEIGHTS, weights=w_rows,
                               tune_opts=tune_opts).fit(xs, ys)
    torch.cuda.synchronize()
    mk_s = time.perf_counter() - t0
    mk_launches = ops.launches()
    mk_same = (mk.kernel_weights_ == tuple(tune_result.best["weights"])
               and mk.alpha_ / N_TUNE == tune_result.best["lam_unscaled"])

    xp, yp = x[:N_PRE], y[:N_PRE]
    ops.reset_launches()
    gram = ops.kernel_block(xp, xp, kernel="rbf", sigma=SIGMA)
    cross = ops.kernel_block(x_te, xp, kernel="rbf", sigma=SIGMA)
    pre = KernelRidge(alpha=PRE_ALPHA, kernel="precomputed").fit(gram, yp)
    pre_pred = pre.predict(cross)
    rbf_pred = KernelRidge(alpha=PRE_ALPHA, kernel="rbf", sigma=SIGMA).fit(xp, yp).predict(x_te)
    pre_launches = ops.launches()
    pre_err, pre_ok = _err(pre_pred, rbf_pred, "f32")

    rec = {"phase": "estimators", "have_sklearn": HAVE_SKLEARN,
           "kernel_ridge": {"n": N_TRAIN, "fit_s": fit_s, "solve_s": est.solve_info_["wall_time_s"],
                            "predict_ms": predict_ms, "score": score, "test_rmse": rmse,
                            "test_rmse_phase_solve": solve_rec["test_rmse"],
                            "dual_coef_bitwise": bitwise, "dual_coef_max_abs_err": w_err,
                            "launches": kr_launches},
           "kernel_ridge_cv": {"n": N_TUNE, "seconds": cv_s, "sweeps": cv.tune_result_.sweeps,
                               "best_params": cv.best_params_, "tune_best": direct_best,
                               "refit_iters": cv.solve_info_.get("iters"),
                               "launches": cv_launches},
           "tune": {"n": N_TUNE, "sigmas": CV_SIGMAS, "columns": len(TUNE_LAMS) * K_FOLDS,
                    "seconds": tune_s, "sweeps": direct.sweeps, "launches": tune_launches},
           "multiple_kernel_ridge_cv": {"n": N_TUNE, "seconds": mk_s,
                                        "sweeps": mk.tune_result_.sweeps,
                                        "best_params": mk.best_params_,
                                        "phase_tune_best": {k: tune_result.best[k] for k in
                                                            ("weights", "lam_unscaled")},
                                        "launches": mk_launches},
           "precomputed": {"n": N_PRE, "alpha": PRE_ALPHA, "max_abs_err": pre_err,
                           "launches": pre_launches}}
    emit(rec)
    _on_card("estimators", w=est.dual_coef_, pred=pred, cv=cv.dual_coef_, mk=mk.dual_coef_,
             pre=pre_pred)
    _path_launches(kr_launches, ("kernel_matvec", "kernel_block"), "KernelRidge")
    _path_launches(cv_launches, ("kernel_matvec", "kernel_block"), "KernelRidgeCV")
    _path_launches(tune_launches, ("kernel_matvec",), "tune (single kernel)")
    _path_launches(mk_launches, ("kernel_matvec_multi", "kernel_matvec_components",
                                 "kernel_block_multi"), "MultipleKernelRidgeCV")
    _path_launches(pre_launches, ("kernel_block",), "precomputed")
    if not (bitwise or (w_ok and math.isclose(rmse, solve_rec["test_rmse"], rel_tol=TOL["f32"][0]))):
        fail(f"KernelRidge: dual_coef_ (err {w_err}) or RMSE {rmse} off phase solve's "
             f"{solve_rec['test_rmse']}")
    if bitwise and rmse != solve_rec["test_rmse"]:
        fail(f"KernelRidge: bitwise weights but RMSE {rmse} != {solve_rec['test_rmse']}")
    if not (math.isfinite(score) and pred.shape == (N_TEST,)):
        fail(f"KernelRidge: score {score}, prediction shape {tuple(pred.shape)}")
    if cv.best_params_ != direct_best:
        fail(f"KernelRidgeCV best {cv.best_params_} != tune()'s {direct_best}")
    if not mk_same:
        fail(f"MultipleKernelRidgeCV best {mk.best_params_} != phase tune's {tune_result.best}")
    if not pre_ok:
        fail(f"precomputed fit disagrees with the rbf fit: err {pre_err}")
    return rec


def phase_sap() -> list[dict]:
    """The exact SAP methods on the tune rows: each with its own draws
    until its residual falls below its start, then SAP_CHECK_STEPS steps
    with injected indices on the card against the CPU plain run."""
    import numpy as np
    import torch

    from repro_torch.core import sap
    from repro_torch.core.krr import KRRProblem
    from repro_torch.kernels import ops

    x, y = taxi_data()
    card = KRRProblem(x=x[:N_TUNE], y=y[:N_TUNE], sigma=SIGMA, lam_unscaled=SAP_LAM_UNSCALED)
    cpu = KRRProblem(x=card.x.cpu(), y=card.y.cpu(), sigma=SIGMA, lam_unscaled=SAP_LAM_UNSCALED)
    block = ("kernel_matvec", "kernel_block")
    methods = (  # (name, step maker, injected draw, steps, the path's kernels)
        ("randomized_newton", lambda p: sap.make_randomized_newton_step(p, SAP_B), "idx", 60,
         block),
        ("nsap", lambda p: sap.make_nsap_step(p, SAP_B, 0.01, N_TUNE / SAP_B), "idx", 60, block),
        ("kaczmarz", sap.make_kaczmarz_step, "j", 400, ("kernel_block",)),
        ("cd", sap.make_cd_step, "j", 400, ("kernel_block",)),
    )
    rng = np.random.default_rng(5)
    recs = []
    for name, make, kind, steps, kernels in methods:
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        w = sap.run(card, make(card), steps, seed=0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = ops.launches()
        rel = float(card.residual_report(w)[0])
        draws = [rng.choice(N_TUNE, SAP_B, replace=False) if kind == "idx"
                 else int(rng.integers(N_TUNE)) for _ in range(SAP_CHECK_STEPS)]
        ws = []
        for p in (card, cpu):
            step, state = make(p), sap.init_state(p)
            for draw in draws:
                state = step(state, **{kind: draw})
            ws.append(state.w)
        err, ok = _err(ws[0].cpu(), ws[1], "f32")
        rec = {"phase": "sap", "method": name, "n": N_TUNE, "d": D,
               "b": SAP_B if kind == "idx" else 1, "lam_unscaled": SAP_LAM_UNSCALED,
               "steps": steps, "seconds": seconds, "ms_a_step": 1e3 * seconds / steps,
               "rel_residual": rel, "rel_residual_start": 1.0, "launches": launches,
               "injected_steps": SAP_CHECK_STEPS, "vs_cpu_max_abs_err": err, "vs_cpu_ok": ok}
        emit(rec)
        _on_card(f"sap {name}", w=w)
        _path_launches(launches, kernels, f"sap {name}")
        if not (math.isfinite(rel) and rel < 1.0):
            fail(f"sap {name}: residual {rel} not finite and below its start of 1.0")
        if not ok:
            fail(f"sap {name}: the card's iterate disagrees with the CPU's: err {err}")
        recs.append(rec)
    return recs


#: rows of A the split route of the t = 1 sweep is held at (phase
#: check_split): one row, a bucket of 8, a block's 64 rows and one either
#: side, and a 16-block bucket; feature widths 9 and 16 (256-row staged
#: tiles) and 17 and 37 (the slab loop, 64-row tiles)
SPLIT_M = (1, 8, 63, 64, 65, 1024)
SPLIT_D = (9, 16, 17, 37)


def split_ns(d: int) -> dict:
    """n on the split route's edges at width d: below one staged tile (no
    split), at a multiple of it (40 tiles) and one either side of it."""
    tile = 256 if d <= 16 else 64
    return {"below": tile - 1, "multiple": 40 * tile, "minus1": 40 * tile - 1,
            "plus1": 40 * tile + 1}


def phase_check_split() -> dict:
    """kernel_matvec (every kernel) and the weighted matvec (every
    MULTI_CASES combination) at t = 1 on the split route's edges, f32 and
    bf16, against their plain versions: m in SPLIT_M, d in SPLIT_D, n in
    split_ns(d).  One line a (d, n, m) with the ranges S of the split."""
    import numpy as np
    import torch

    from repro_torch.core.kernels import KERNEL_NAMES
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.kernel_matvec import kernel_matvec_cuda, t1_splits
    from repro_torch.kernels.multi import kernel_matvec_multi_cuda

    lib = _build.load("kernel_matvec")
    sigma = 1.5
    gen = torch.Generator().manual_seed(16)
    rng = np.random.default_rng(16)
    worst = {"kernel_matvec": 0.0, "kernel_matvec_multi": 0.0}
    n_checks = 0
    for d in SPLIT_D:
        for edge, n in split_ns(d).items():
            b = (torch.randn((n, d), generator=gen) / math.sqrt(d)).cuda()
            v = torch.randn((n,), generator=gen).cuda()
            for m in SPLIT_M:
                a = (torch.randn((m, d), generator=gen) / math.sqrt(d)).cuda()
                errs = {"kernel_matvec": 0.0, "kernel_matvec_multi": 0.0}

                def check(name, label, prec, got, want):
                    nonlocal n_checks
                    torch.cuda.synchronize()
                    err, ok = _err(got, want, prec)
                    if not ok:
                        fail(f"{name} {label} {prec} d={d} n={n} m={m} (split): err {err}")
                    errs[name] = max(errs[name], err)
                    n_checks += 1

                for prec in ("f32", "bf16"):
                    for kern in KERNEL_NAMES:
                        check("kernel_matvec", kern, prec,
                              kernel_matvec_cuda(a, b, v, kernel=kern, sigma=sigma,
                                                 precision=prec),
                              ref.kernel_matvec(a, b, v, sigma, kernel=kern, precision=prec))
                    for kernels, sigmas in MULTI_CASES:
                        w = tuple(float(x) for x in rng.dirichlet(np.ones(len(kernels))))
                        check("kernel_matvec_multi", "+".join(kernels), prec,
                              kernel_matvec_multi_cuda(a, b, v, w, kernels=kernels,
                                                       sigmas=sigmas, precision=prec),
                              ref.kernel_matvec_multi(a, b, v, sigmas,
                                                      torch.tensor(w, device="cuda"),
                                                      kernels=kernels, precision=prec))
                emit({"check": "split", "d": d, "n": n, "edge": edge, "m": m,
                      "splits": t1_splits(lib, m, n, d), "max_abs_err": errs, "ok": True})
                for k, e in errs.items():
                    worst[k] = max(worst[k], e)
            if (t1_splits(lib, 8, n, d) > 1) != (edge != "below"):
                fail(f"split route at d={d} n={n}: {t1_splits(lib, 8, n, d)} ranges")
    rec = {"phase": "check_split", "m": SPLIT_M, "d": SPLIT_D, "checks": n_checks,
           "splits_taxi": [t1_splits(lib, m, N_TRAIN, D) for m in (1, 64, 4096, 4097)],
           "worst_abs_err": worst}
    emit(rec)
    return rec


#: one-vs-all classes of phase ova (t heads of one multi-RHS solve): the
#: multi-column sweep's widths up to 10 heads, then 20, 24 and 32
OVA_CLASSES = (2, 4, 8, OVA_HEADS, 20, 24, 32)


def phase_ova(refit_best: dict) -> dict:
    """One-vs-all askotch solves at phase solve's configuration on blobs of
    OVA_CLASSES classes (kernel_matvec's multi-column sweep at G_B, the
    prediction and the residual pass), then a multi-kernel one-vs-all of
    OVA_HEADS classes with the refit's kernels, sigma and weights (the
    weighted heads; the weighted block at K_BB).  Returns each path's
    launches, by ``"ova <classes>"`` and ``"ova multikernel"``."""
    import torch

    from repro_torch.core.krr import KRRProblem, evaluate
    from repro_torch.core.solver_api import solve
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops

    mk = {"kernel": tuple(refit_best["kernel"]), "weights": tuple(refit_best["weights"])}
    launches = {}
    for classes, label, over in (*((c, f"ova {c}", {}) for c in OVA_CLASSES),
                                 (OVA_HEADS, "ova multikernel", mk)):
        x, y, _, x_te, y_te, _ = synthetic.krr_one_vs_all(
            0, N_TRAIN, D, num_classes=classes, n_test=N_TEST, device="cuda")
        sigma = refit_best["sigma"] if over else SIGMA
        problem = KRRProblem(x=x, y=y, kernel="rbf", sigma=sigma, lam_unscaled=LAM_UNSCALED,
                             precision="f32")
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        out = solve(problem, "askotch", block_size=BLOCK, rank=RANK, max_iters=MAX_ITERS,
                    eval_every=MAX_ITERS, **over)
        pred = out.predict_fn(x_te)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[label] = ops.launches()
        heads = [float(h) for h in out.info["rel_residual_per_head"]]
        acc = float(evaluate(pred, y_te).accuracy)
        emit({"phase": "ova", "classes": classes, "n": N_TRAIN, "n_test": N_TEST, "d": D,
              "kernel": list(over.get("kernel", ("rbf",))), "sigma": sigma,
              "weights": list(over.get("weights", (1.0,))),
              "iters": out.info["iters"], "rel_residual": out.history[-1]["rel_residual"],
              "rel_residual_per_head": heads, "test_accuracy": acc, "seconds": seconds,
              "launches": launches[label]})
        _on_card(label, w=out.w, pred=pred)
        _path_launches(launches[label], ("kernel_matvec_multi", "kernel_block_multi") if over
                       else ("kernel_matvec", "kernel_block"), label)
        if not all(math.isfinite(h) and h < 1.0 for h in heads):
            fail(f"{label}: a head's final residual is not finite and below 1: {heads}")
        if pred.shape != (N_TEST, classes) or not math.isfinite(acc):
            fail(f"{label}: prediction {tuple(pred.shape)}, accuracy {acc}")
        del x, y, x_te, y_te, problem, out, pred
        torch.cuda.empty_cache()
    return launches


# phase serve: the engine's settings and its traffic (the JAX package's
# krr_serve launcher defaults: max_batch 1024, max_wait 5 ms, requests of
# 1..16 rows), the taxi model's load and the two side models'
SERVE_MAX_BATCH, SERVE_WAIT_MS, SERVE_MAX_ROWS = 1024, 5.0, 16
SERVE_REQUESTS, SERVE_RATE, SERVE_CLIENTS = 2_000, 2_000.0, 4
SERVE_SIDE_REQUESTS = 500


def _serve_traffic(engine, name: str, pool, requests: int, seed: int) -> dict:
    """Open-loop Poisson traffic at SERVE_RATE from SERVE_CLIENTS threads
    (each at SERVE_RATE / SERVE_CLIENTS), requests of 1..SERVE_MAX_ROWS rows
    drawn from ``pool`` (host numpy); waits for every response.  Returns
    the queries, the responses, the wall seconds and the engine's stats."""
    import threading

    import numpy as np

    rng = np.random.default_rng(seed)
    per = requests // SERVE_CLIENTS
    plans = []
    for _ in range(SERVE_CLIENTS):
        arrivals = np.cumsum(rng.exponential(SERVE_CLIENTS / SERVE_RATE, size=per))
        queries = [pool[rng.integers(0, pool.shape[0], size=int(q))]
                   for q in rng.integers(1, SERVE_MAX_ROWS + 1, size=per)]
        plans.append((arrivals, queries))
    futures = [[None] * per for _ in range(SERVE_CLIENTS)]
    errors = []

    def client(c):
        try:
            arrivals, queries = plans[c]
            for i, (t_arr, xq) in enumerate(zip(arrivals, queries)):
                lag = t_arr - (time.monotonic() - t0)
                if lag > 0:
                    time.sleep(lag)
                futures[c][i] = engine.submit(name, xq)
        except Exception as exc:  # reported by the main thread
            errors.append(exc)

    engine.reset_stats(name)
    threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        if t.is_alive():
            fail(f"serve {name}: a client thread did not finish")
    if errors:
        fail(f"serve {name}: a client failed: {errors[0]!r}")
    engine.drain(timeout=300)
    seconds = time.monotonic() - t0
    queries = [q for _, qs in plans for q in qs]
    outs = [f.result() for fs in futures for f in fs]
    return {"queries": queries, "outs": outs, "seconds": seconds, "stats": engine.stats(name)}


def _serve_model(engine, name: str, config: dict, x, w, requests: int, seed: int,
                 wrapper: str, plain, pool, path: str | None = None) -> dict:
    """Load (from an artifact at ``path``, else from memory) and warm one
    model, replay traffic, then hold it: every response within the f32
    tolerance of ``plain`` (the plain version over all requests' rows at
    once), the threaded responses bitwise the sequential closure's, and
    ``wrapper``'s launches = warm launches + bucket runs."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving.engine import bucket_sizes
    from repro_torch.serving.krr_serve import make_krr_predict_fn_from_config

    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    info = (engine.load_model(name, path) if path
            else engine.register(name, config, x, w))
    load_s = time.perf_counter() - t0
    warm = ops.launches()[wrapper]
    traffic = _serve_traffic(engine, name, pool, requests, seed)
    launches = ops.launches()
    st = traffic["stats"]
    runs = sum(o["runs"] for o in st["occupancy"].values())
    # the plain version over every request's rows, one call
    rows = np.concatenate(traffic["queries"])
    want = plain(torch.from_numpy(rows).cuda())
    got = torch.from_numpy(np.concatenate(traffic["outs"])).cuda()
    err, ok = _err(got, want, "f32")
    del want, got
    predict = make_krr_predict_fn_from_config(config, x, w, max_batch=SERVE_MAX_BATCH)
    same = all(np.array_equal(predict(q).cpu().numpy(), o)
               for q, o in zip(traffic["queries"], traffic["outs"]))
    rec = {"phase": "serve", "model": name, "kernel": config["kernel"],
           "heads": 1 if w.ndim == 1 else int(w.shape[1]), "n": int(x.shape[0]),
           "requests": requests, "offered_rps": SERVE_RATE, "clients": SERVE_CLIENTS,
           "rows": int(rows.shape[0]), "seconds": traffic["seconds"],
           "achieved_rps": requests / traffic["seconds"], "load_s": load_s,
           "warmed_buckets": info["warmed_buckets"], "qps": st["qps"], "p50_ms": st["p50_ms"],
           "p99_ms": st["p99_ms"], "mean_ms": st["mean_ms"],
           "bucket_runs": {b: o["runs"] for b, o in st["occupancy"].items()},
           "bucket_fill": {b: o["fill"] for b, o in st["occupancy"].items()},
           "compile_cache_depth": st["compile_cache_depth"], "launches": launches,
           "warm_launches": warm, "bucket_runs_total": runs,
           "max_abs_err": err, "ok": ok, "bitwise_sequential": same}
    emit(rec)
    if st["n_requests"] != requests:
        fail(f"serve {name}: {st['n_requests']} of {requests} requests served")
    if warm != len(bucket_sizes(SERVE_MAX_BATCH)) or launches[wrapper] != warm + runs:
        fail(f"serve {name}: {wrapper} launched {launches[wrapper]} times, "
             f"warm {warm} + bucket runs {runs} expected")
    if not ok:
        fail(f"serve {name}: responses disagree with the plain version: err {err}")
    if not same:
        fail(f"serve {name}: threaded responses differ from sequential predict")
    return rec


def phase_serve(solve_w, refit_best: dict, refit_w) -> list[dict]:
    """The serving engine on the card at full width (n = 10^6 taxi rows):
    phase solve's model saved as an artifact and loaded, 2,000 requests;
    phase refit's multi-kernel model (the weighted t = 1 path), a 10-head
    model (random weights from a seed; kernel_matvec's multi-column sweep,
    split over n) and a multi-kernel 10-head model (the refit's kernels,
    sigma and weights with the same seeded weights; the weighted heads,
    split over n), 500 requests each.  Also the same 8 rows bitwise in
    buckets of 8, 64 and 1024 rows, on the taxi model and both 10-head
    models."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.serving.engine import ServingEngine, save_model_artifact
    from repro_torch.serving.krr_serve import make_krr_predict_fn_from_config

    x, _ = taxi_data()
    xt = x[:N_TRAIN]
    pool = x[N_TRAIN:].cpu().numpy()  # the queries: the taxi test rows
    cfg = {"kernel": "rbf", "sigma": SIGMA, "lam_unscaled": LAM_UNSCALED, "precision": "f32"}
    art = OUT_DIR / "serve_artifacts" / "taxi"
    t0 = time.perf_counter()
    save_model_artifact(str(art), cfg, xt, solve_w)
    save_s = time.perf_counter() - t0
    kernels = tuple(refit_best["kernel"])
    mk_cfg = {"kernel": list(kernels), "sigma": refit_best["sigma"],
              "weights": list(refit_best["weights"]), "precision": "f32"}
    mk_sig = (float(refit_best["sigma"]),) * len(kernels)
    mk_w = torch.tensor(refit_best["weights"], device="cuda")
    w_heads = torch.randn((N_TRAIN, OVA_HEADS),
                          generator=torch.Generator(device="cuda").manual_seed(17), device="cuda")
    heads_cfg = {"kernel": "rbf", "sigma": SIGMA}
    recs = []
    with ServingEngine(max_batch=SERVE_MAX_BATCH, max_wait_ms=SERVE_WAIT_MS) as engine:
        recs.append(_serve_model(
            engine, "taxi", cfg, xt, solve_w, SERVE_REQUESTS, 21, "kernel_matvec",
            lambda q: ref.kernel_matvec(q, xt, solve_w, SIGMA), pool, path=str(art)))
        recs.append(_serve_model(
            engine, "taxi_multikernel", mk_cfg, xt, refit_w, SERVE_SIDE_REQUESTS, 22,
            "kernel_matvec_multi",
            lambda q: ref.kernel_matvec_multi(q, xt, refit_w, mk_sig, mk_w, kernels=kernels),
            pool))
        recs.append(_serve_model(
            engine, f"taxi_{OVA_HEADS}_heads", heads_cfg, xt, w_heads,
            SERVE_SIDE_REQUESTS, 23, "kernel_matvec",
            lambda q: ref.kernel_matvec(q, xt, w_heads, SIGMA), pool))
        recs.append(_serve_model(
            engine, f"taxi_multikernel_{OVA_HEADS}_heads", mk_cfg, xt, w_heads,
            SERVE_SIDE_REQUESTS, 24, "kernel_matvec_multi",
            lambda q: ref.kernel_matvec_multi(q, xt, w_heads, mk_sig, mk_w, kernels=kernels),
            pool))
    shutil.rmtree(art.parent)  # 40 MB: the output directory keeps logs, not models
    # the same 8 rows in buckets of 8, 64 and 1024 rows, other rows beside
    # them, on the taxi model (t = 1) and both 10-head models
    rows = pool[:8]
    same = {}
    for model, c, w in (("taxi", cfg, solve_w), (f"taxi_{OVA_HEADS}_heads", heads_cfg, w_heads),
                        (f"taxi_multikernel_{OVA_HEADS}_heads", mk_cfg, w_heads)):
        predict = make_krr_predict_fn_from_config(c, xt, w, max_batch=SERVE_MAX_BATCH)
        base = predict(rows).cpu().numpy()
        for bucket, at in ((64, 37), (1024, 1000)):
            q = pool[100:100 + bucket].copy()
            q[at:at + 8] = rows
            same[f"{model} {bucket}"] = bool(
                np.array_equal(predict(q)[at:at + 8].cpu().numpy(), base))
    emit({"phase": "serve", "check": "buckets", "rows": 8, "buckets": [8, 64, 1024],
          "bitwise_equal": same, "artifact_save_s": save_s})
    if not all(same.values()):
        fail(f"serve: the same rows score differently across buckets: {same}")
    return recs


# phase dist: the (2, 2) mesh of one card's cuda:0 x 4 at n = 2 x 10^5 rows
# (the primitive checks, pcg-nystrom, the tune rows' search), block rows of
# the primitive checks, and the served requests of the mesh-bound model
DIST_N22, DIST_B, DIST_SHARDS, DIST_REQUESTS = 200_000, 5_000, 4, 200
DIST_TUNE_SIGMAS, DIST_TUNE_FOLDS = (0.5, 1.0), 3
DIST_MK_WEIGHTS = (0.5, 0.3, 0.2)
# the dist tune: CV MSE of a candidate converged on the mesh and on one
# device (f32 CG stopped at TUNE_TOL on two sum orders) agrees to this; each
# fold's residual stays within 1 % of one device's through DIST_TUNE_AGREE
# CG iterations; the iterations at which each candidate's residual is kept
DIST_TUNE_RTOL, DIST_TUNE_AGREE = 1e-2, 10
_TRAJ_AT = (1, 10, 25, 50, 100, 150)
# keys of ``python -m repro.launch.krr_solve --mesh 1x1`` (askotch) and of
# ``--method dc`` (src/repro/launch/krr_solve.py:113-160,
# src/repro/core/solver_api.py:190-197, src/repro/distributed/dc.py:294-305)
DIST_LAUNCHER_KEYS = [
    "method", "iters", "converged", "wall_time_s", "mesh", "t", "rel_residual_per_head",
    "n", "rel_residual", "test_rmse", "test_mae", "test_acc", "seconds",
]
DC_LAUNCHER_KEYS = [
    "method", "shards", "partition", "combiner", "inner_method", "per_shard_iters",
    "converged", "wall_time_s", "collective_dispatches", "mesh", "t",
    "n", "rel_residual", "test_rmse", "test_mae", "test_acc", "seconds",
]


def _collectives(before: dict) -> dict:
    """The ``repro_collective_dispatch_total`` series grown since ``before``."""
    from repro_torch.obs import metrics

    return {k: v for k, v in metrics.diff(before, metrics.snapshot()).items()
            if k.startswith("repro_collective_dispatch_total")}


def _dist_expected(shape, calls) -> dict:
    """The reference's per-primitive collectives (src/repro/distributed/
    sharded_operator.py:19-29, counted at :454-628) for (primitive, rows of
    its block or of x) calls on an (S, M) mesh."""
    s, m = shape
    want: dict = {}

    def add(prim, coll, k=1):
        key = f'repro_collective_dispatch_total{{collective="{coll}",primitive="{prim}"}}'
        want[key] = want.get(key, 0.0) + k

    for prim, rows in calls:
        if prim in ("matvec", "matvec_cols", "sketch_components"):
            if s > 1:
                add(prim, "all_gather", 2)
            if m > 1 and rows % m == 0:
                add(prim, "psum")
        elif prim == "row_block_matvec":
            if s > 1:
                add(prim, "psum")
            if m > 1 and rows % m == 0:
                add(prim, "all_gather")
        elif prim == "block" and m > 1 and rows % m == 0:
            add(prim, "all_gather")
        elif prim == "gather_rows" and s > 1:
            add(prim, "psum")
    return want


#: the CUDA wrappers, by the global name ``kernels.ops`` calls them under
_OPS_WRAPPERS = ("kernel_matvec_cuda", "kernel_block_cuda", "kernel_matvec_multi_cuda",
                 "kernel_matvec_components_cuda", "kernel_block_multi_cuda")


def _plain_of(name: str, args: tuple, kw: dict):
    """The plain PyTorch version (``kernels.ref``) of one wrapper call."""
    import torch

    from repro_torch.kernels import ref

    prec = kw["precision"]
    if name == "kernel_matvec_cuda":
        return ref.kernel_matvec(*args, kw["sigma"], kernel=kw["kernel"], precision=prec)
    if name == "kernel_block_cuda":
        return ref.kernel_block(*args, kw["sigma"], kernel=kw["kernel"], precision=prec)
    if name == "kernel_matvec_multi_cuda":
        a, b, v, w = args
        if not isinstance(w, torch.Tensor):
            w = torch.tensor(w, dtype=torch.float32, device=a.device)
        return ref.kernel_matvec_multi(a, b, v, kw["sigmas"], w, kernels=kw["kernels"],
                                       precision=prec)
    if name == "kernel_matvec_components_cuda":
        return ref.kernel_matvec_components(*args, kw["sigmas"], kernels=kw["kernels"],
                                            precision=prec)
    return ref.kernel_block_multi(*args, kw["sigmas"], kw["weights"], kernels=kw["kernels"],
                                  precision=prec)


class _PathShapes:
    """While open, keeps a copy of the operands and the output of the first
    launch of each kernel wrapper at each set of operand shapes (kernel
    names and precision included), so that ``hold`` can set each against its
    plain version after the path's launches have been read.  It adds no
    launch.  The serving engine launches from its worker thread: a lock
    guards the record."""

    def __init__(self):
        import threading

        self.calls: dict = {}
        self._lock = threading.Lock()

    def __enter__(self):
        from repro_torch.kernels import ops

        self._saved = {name: getattr(ops, name) for name in _OPS_WRAPPERS}
        for name, fn in self._saved.items():
            setattr(ops, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        for name, fn in self._saved.items():
            setattr(ops, name, fn)
        return False

    def _wrap(self, name: str, fn):
        import torch

        def copy(a):
            return a.detach().clone() if isinstance(a, torch.Tensor) else a

        def call(*args, **kw):
            out = fn(*args, **kw)
            key = (name, tuple(tuple(a.shape) for a in args if isinstance(a, torch.Tensor)),
                   str(kw.get("kernel", kw.get("kernels"))), kw["precision"],
                   isinstance(kw.get("weights", args[3] if len(args) > 3 else None),
                              torch.Tensor))
            with self._lock:
                if key not in self.calls:
                    self.calls[key] = (tuple(copy(a) for a in args),
                                       {k: copy(v) for k, v in kw.items()}, copy(out))
            return out

        return call

    def hold(self, path: str) -> list[dict]:
        """Each recorded launch's output against its plain version on the
        same operands, within the precision's tolerance."""
        import torch

        recs = []
        for (name, shapes, kernels, prec, _), (args, kw, out) in self.calls.items():
            t0 = time.perf_counter()
            err, ok = _err(out, _plain_of(name, args, kw), prec)
            torch.cuda.synchronize()
            recs.append({"kernel": name.removesuffix("_cuda"), "shapes": shapes,
                         "kernels": kernels, "precision": prec, "max_abs_err": err, "ok": ok,
                         "plain_s": time.perf_counter() - t0})
        emit({"phase": "dist", "check": "path shapes against the plain version", "path": path,
              "calls": recs})
        bad = [(r["kernel"], r["shapes"]) for r in recs if not r["ok"]]
        if bad or not recs:
            fail(f"{path}: kernels off their plain version at the path's shapes: {bad} "
                 f"({len(recs)} shapes recorded)")
        self.calls.clear()
        return recs


def _dist_plain(cfg: dict, xs, v1, vt, a, idx, omega, wc) -> dict:
    """The plain versions (``kernels.ref``) of ``_dist_primitives``' global
    results on the same inputs: one pass of K(x, x) over every right-hand
    side at once (per kernel for the weighted operator)."""
    import torch

    from repro_torch.kernels import ref

    n, t = xs.shape[0], vt.shape[1]
    rhs = torch.cat([v1[:, None], vt, omega], dim=1)
    a_blk, x_idx = a[:2000], xs[idx[:2000]]
    if cfg["kernel"] == "rbf":
        full = ref.kernel_matvec(xs, xs, rhs, SIGMA)
        rbm = ref.kernel_matvec(a, xs, rhs[:, :1 + t], SIGMA)
        blocks = [ref.kernel_block(z, z, SIGMA) for z in (a_blk, x_idx)]
        trace = float(n)
    else:
        ks, wts = tuple(cfg["kernel"]), tuple(cfg["weights"])
        sg = (SIGMA,) * len(ks)
        w_dev = torch.tensor(wts, dtype=torch.float32, device=xs.device)
        comp = ref.kernel_matvec_components(xs, xs, rhs, sg, kernels=ks)
        full = torch.einsum("q,qnc->nc", w_dev, comp)
        rbm = ref.kernel_matvec_multi(a, xs, rhs[:, :1 + t], sg, w_dev, kernels=ks)
        blocks = [ref.kernel_block_multi(z, z, sg, wts, kernels=ks) for z in (a_blk, x_idx)]
        trace = float(sum(wts) * n)
    out = {"matvec (t = 1)": full[:, 0], "matvec (t = 8)": full[:, 1:1 + t],
           "row_block_matvec (t = 1)": rbm[:, 0], "row_block_matvec (t = 8)": rbm[:, 1:],
           "block": blocks[0], "block_idx": blocks[1],
           "trace_est": torch.tensor([trace], device=xs.device),
           "k_lam_matvec": full[:, 0] + 0.2 * v1, "sketch (r = 16)": full[:, 1 + t:]}
    if cfg["kernel"] != "rbf":
        out["matvec_cols (t = 8)"] = torch.einsum("qc,qnc->nc", wc, comp[:, :, 1:1 + t])
        out["sketch_components (r = 16)"] = comp[:, :, 1 + t:]
    return out


def _tune_heads(tel) -> dict:
    """Per sigma group of a tune run with ``tel`` (a ring), the relative
    residual of every (candidate, fold) column at each CG iteration:
    ``{sigma: [(iter, [residual per column]), ...]}``."""
    groups, pending = {}, []
    for e in tel.ring.events():
        if e["type"] == "trace" and "rel_residual_per_head" in e:
            pending.append((e["iter"], e["rel_residual_per_head"]))
        elif e["type"] == "span" and e["name"] == "tune/group":
            groups[e["attrs"]["sigma"]] = pending
            pending = []
    return groups


def _dist_primitives(mesh_b, mesh_a, label: str) -> list[dict]:
    """Every global primitive of ``ShardedKernelOperator`` on ``mesh_b``
    against the (1, 1) ``mesh_a`` and against the plain versions on the same
    inputs at n = DIST_N22 (rbf, and the weighted (rbf, laplacian,
    matern52) for the multi-kernel primitives): within the f32 tolerance,
    ``gather_rows`` exact, the collective counts the reference's table, and
    two runs bitwise equal."""
    import numpy as np
    import torch

    from repro_torch.distributed.sharded_operator import ShardedKernelOperator
    from repro_torch.obs import metrics

    x, _ = taxi_data()
    n, b = DIST_N22, DIST_B
    xs = x[:n]
    gen = torch.Generator(device="cuda").manual_seed(31)
    v1 = torch.randn((n,), generator=gen, device="cuda")
    vt = torch.randn((n, 8), generator=gen, device="cuda")
    a = x[N_TRAIN:N_TRAIN + b]
    idx = torch.randint(0, n, (b,), generator=gen, device="cuda")
    omega, _ = torch.linalg.qr(torch.randn((n, 16), generator=gen, device="cuda"))
    wc = torch.from_numpy(np.random.default_rng(31).dirichlet(np.ones(3), size=8).T
                          .astype(np.float32)).cuda()
    configs = {"rbf": {"kernel": "rbf", "sigma": SIGMA},
               "multi": {"kernel": MK_KERNELS, "sigma": SIGMA, "weights": DIST_MK_WEIGHTS}}
    recs = []
    for name, cfg in configs.items():
        def prims(op):
            out = {"matvec (t = 1)": op.matvec(v1), "matvec (t = 8)": op.matvec(vt),
                   "row_block_matvec (t = 1)": op.row_block_matvec(a, v1),
                   "row_block_matvec (t = 8)": op.row_block_matvec(a, vt),
                   "block": op.block(a[:2000]), "block_idx": op.block_idx(idx[:2000]),
                   "trace_est": op.trace_est()[None], "k_lam_matvec": op.k_lam_matvec(v1, 0.2),
                   "sketch (r = 16)": op.sketch(omega)}
            (xb, yb), owned = op.gather_rows(idx, v1)
            out["gather_rows"] = torch.cat([xb, yb[:, None]], dim=1)
            if name == "multi":
                out["matvec_cols (t = 8)"] = op.matvec_cols(vt, wc)
                out["sketch_components (r = 16)"] = op.sketch_components(omega)
            return out, owned

        calls = [("matvec", n), ("matvec", n), ("row_block_matvec", b),
                 ("row_block_matvec", b), ("block", 2000), ("gather_rows", 2000),
                 ("block", 2000), ("matvec", n), ("matvec", n), ("gather_rows", b)]
        if name == "multi":
            calls += [("matvec_cols", n), ("sketch_components", n)]
        want, _ = prims(ShardedKernelOperator.bind(mesh_a, xs, **cfg))
        op = ShardedKernelOperator.bind(mesh_b, xs, **cfg)
        torch.cuda.synchronize()
        before = metrics.snapshot()
        t0 = time.perf_counter()
        got, owned = prims(op)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _collectives(before)
        again, _ = prims(op)
        t0 = time.perf_counter()
        plain = _dist_plain(cfg, xs, v1, vt, a, idx, omega, wc)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        expected = _dist_expected(tuple(mesh_b.devices.shape), calls)
        checks = []
        for k, v in got.items():
            err, ok = _err(v, want[k], "f32")
            if k == "gather_rows":
                ok = ok and bool(torch.equal(v[:, :D], xs[idx]) and torch.equal(v[:, D], v1[idx]))
                plain_err, plain_ok = 0.0, ok
            else:
                plain_err, plain_ok = _err(v, plain[k], "f32")
            checks.append({"primitive": k, "max_abs_err": err, "ok": ok,
                           "plain_max_abs_err": plain_err, "plain_ok": plain_ok,
                           "bitwise_rerun": bool(torch.equal(v, again[k]))})
        rows = int(mesh_b.devices.shape[0])
        owned_ok = bool(torch.equal(owned.reshape(rows, b).sum(0), torch.ones(b, device="cuda")))
        rec = {"phase": "dist", "check": "primitives", "mesh": label, "config": name, "n": n,
               "devices": [str(dv) for dv in mesh_b.devices.flat], "seconds": seconds,
               "plain_s": plain_s, "collectives": counts, "collectives_expected": expected,
               "owned_ok": owned_ok, "primitives": checks}
        emit(rec)
        bad = [c["primitive"] for c in checks
               if not (c["ok"] and c["plain_ok"] and c["bitwise_rerun"])]
        if bad or not owned_ok:
            fail(f"dist {label} {name}: primitives off their (1, 1) result or their plain "
                 f"version, or not bitwise on a rerun: {bad}, ownership {owned_ok}")
        if counts != expected:
            fail(f"dist {label} {name}: collectives {counts} != the reference's {expected}")
        recs.append(rec)
        del got, want, again, plain
    torch.cuda.empty_cache()
    return recs


def phase_dist(solve_rec: dict, solve_w) -> dict:
    """The distributed tier on the card: ``solve(askotch, mesh=(1, 1))`` at
    the taxi width and n = 10^6; the (2, 2) mesh of cuda:0 x 4 (every
    primitive, pcg-nystrom, a tune); DC with 4 shards with and without a
    (1, 1) mesh and at k = 1; the taxi model served over the (2, 2) mesh;
    the launchers with ``--mesh`` and ``--method dc``.  Returns each path's
    launches (zeroed before, read after)."""
    import numpy as np
    import torch

    from repro_torch.core.krr import KRRProblem, evaluate
    from repro_torch.core.solver_api import solve, tune
    from repro_torch.distributed.dc import solve_dc
    from repro_torch.distributed.meshes import SolverMesh, make_solver_mesh
    from repro_torch.kernels import ops, ref
    from repro_torch.obs import Telemetry, metrics
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.krr_serve import make_krr_predict_fn_from_config

    x, y = taxi_data()
    problem = KRRProblem(x=x[:N_TRAIN], y=y[:N_TRAIN], kernel="rbf", sigma=SIGMA,
                         lam_unscaled=LAM_UNSCALED, precision="f32")
    x_te, y_te = x[N_TRAIN:], y[N_TRAIN:]
    mesh11 = make_solver_mesh("1x1")
    mesh22 = SolverMesh(["cuda:0"] * 4, shape=(2, 2))
    opts = dict(block_size=BLOCK, rank=RANK, max_iters=MAX_ITERS, eval_every=MAX_ITERS)
    launches: dict = {}

    # -- askotch over a (1, 1) mesh at the taxi width, n = 10^6 ---------------
    solve(problem, "askotch", mesh=mesh11, **dict(opts, max_iters=2, eval_every=2))  # warm-up
    torch.cuda.synchronize()
    before = metrics.snapshot()
    ops.reset_launches()
    out = solve(problem, "askotch", mesh=mesh11, **opts)
    pred = out.predict_fn(x_te)
    torch.cuda.synchronize()
    launches["dist askotch"] = ops.launches()
    coll = _collectives(before)
    t1 = time.perf_counter()
    problem.residual_report(out.w)[0].item()
    residual_s = time.perf_counter() - t1
    rel = out.history[-1]["rel_residual"]
    rmse = float(evaluate(pred, y_te).rmse)
    pred_err, pred_ok = _err(pred, ref.kernel_matvec(x_te, problem.x, out.w, SIGMA), "f32")
    rec = {"phase": "dist", "path": "askotch, mesh (1, 1)", "n": N_TRAIN, "d": D,
           "block_size": BLOCK, "rank": RANK, "iters": out.info["iters"],
           "rel_residual": rel, "rel_residual_start": 1.0, "test_rmse": rmse,
           "solve_test_rmse": solve_rec["test_rmse"],
           "iter_ms": 1e3 * (out.history[-1]["time_s"] - residual_s) / out.info["iters"],
           "solve_iter_ms": solve_rec["iter_ms"], "residual_s": residual_s,
           "launches": launches["dist askotch"], "collectives": coll,
           "predict_max_abs_err": pred_err, "predict_ok": pred_ok, "mesh": out.info["mesh"],
           "reduced": "n 1e8 -> 1e6 (+1e4 test): O(n^2 d) residual, one-card time limit"}
    emit(rec)
    _on_card("dist askotch", w=out.w, pred=pred)
    _path_launches(launches["dist askotch"], ("kernel_matvec",), "dist askotch")
    if not (math.isfinite(rel) and rel < 1.0 and math.isfinite(rmse)):
        fail(f"dist askotch: rel_residual {rel} / rmse {rmse} not finite or not below 1.0")
    if coll or not pred_ok:
        fail(f"dist askotch: collectives {coll} on a (1, 1) mesh, prediction ok {pred_ok}")
    del out, pred

    # -- the (2, 2) mesh of cuda:0 x 4: every primitive against (1, 1) ----------
    _dist_primitives(mesh22, mesh11, "(2, 2) cuda:0 x 4")
    if torch.cuda.device_count() >= 2:
        _dist_primitives(make_solver_mesh("2x1"), mesh11, "(2, 1) cuda:0, cuda:1")
    else:
        emit({"phase": "dist", "check": "two cards", "ran": False,
              "reason": f"{torch.cuda.device_count()} CUDA device: no (2, 1) mesh over two "
                        "cards; every check above ran on cuda:0 x 4"})

    # -- pcg-nystrom over the (2, 2) mesh at phase baselines' budget ----------
    n2 = DIST_N22
    p2 = KRRProblem(x=x[:n2], y=y[:n2], kernel="rbf", sigma=SIGMA,
                    lam_unscaled=LAM_UNSCALED, precision="f32")
    pcg_kw = {"rank": RANK, "max_iters": 20}
    one = solve(p2, "pcg-nystrom", **pcg_kw)
    torch.cuda.synchronize()
    before = metrics.snapshot()
    ops.reset_launches()
    with _PathShapes() as shapes:
        out = solve(p2, "pcg-nystrom", mesh=mesh22, **pcg_kw)
        torch.cuda.synchronize()
    launches["dist pcg"] = ops.launches()
    coll = _collectives(before)
    shapes.hold("dist pcg")
    times = [h["time_s"] for h in out.history]
    iter_ms = 1e3 * float(np.median(np.diff(times)))

    def objective(w):
        kw_w = p2.op.k_lam_matvec(w, p2.lam)
        return float(0.5 * (w.double() @ kw_w.double()) - p2.y.double() @ w.double())

    e_mesh, e_one = objective(out.w), objective(one.w)
    r_mesh = float(evaluate(out.predict_fn(x_te), y_te).rmse)
    r_one = float(evaluate(one.predict_fn(x_te), y_te).rmse)
    rec = {"phase": "dist", "path": "pcg-nystrom, mesh (2, 2) cuda:0 x 4", "n": n2, **pcg_kw,
           "iters": out.info["iters"], "setup_s": times[0] - iter_ms / 1e3, "iter_ms": iter_ms,
           "one_device_iter_ms": 1e3 * float(np.median(np.diff([h["time_s"]
                                                                for h in one.history]))),
           "one_device_setup_s": one.history[0]["time_s"],
           "energy": e_mesh, "one_device_energy": e_one, "test_rmse": r_mesh,
           "one_device_test_rmse": r_one, "collectives": coll,
           "launches": launches["dist pcg"],
           "reduced": "n 1e8 -> 2e5: the (2, 2) mesh's four shards share one card"}
    emit(rec)
    _path_launches(launches["dist pcg"], ("kernel_matvec",), "dist pcg")
    want = _dist_expected((2, 2), [("matvec", n2)] * (1 + out.info["iters"]))
    if coll != want:
        fail(f"dist pcg: collectives {coll} != the reference's {want}")
    # CG's objective is monotone, its residual and the test RMSE after 20
    # unconverged iterations are not (phase baselines), so the objective is
    # held and the RMSE recorded
    if not (e_mesh < 0.0 and abs(e_mesh - e_one) <= 1e-4 * abs(e_one)
            and math.isfinite(r_mesh)):
        fail(f"dist pcg: objective {e_mesh} vs one device {e_one}, rmse {r_mesh}")
    del out, one

    # -- divide and conquer at n = 10^6: 4 shards, with and without a mesh -----
    torch.cuda.synchronize()
    before = metrics.snapshot()
    ops.reset_launches()
    t0 = time.perf_counter()
    seq = solve_dc(problem, shards=DIST_SHARDS, method="askotch", **opts)
    pred_seq = seq.predict_fn(x_te)
    torch.cuda.synchronize()
    dc_s = time.perf_counter() - t0
    launches["dc"] = ops.launches()
    coll = _collectives(before)
    par = solve(problem, "dc", mesh=mesh11, dc_shards=DIST_SHARDS, dc_method="askotch", **opts)
    same = bool(torch.equal(seq.w, par.w) and torch.equal(pred_seq, par.predict_fn(x_te)))
    par_coll = par.info["collective_dispatches"]
    del par
    # the threaded branch: a (4, 1) mesh of cuda:0 x 4 gives the one card
    # one host thread, which solves the four shards in shard order
    mesh41 = SolverMesh(["cuda:0"] * DIST_SHARDS, shape=(DIST_SHARDS, 1))
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    thr = solve(problem, "dc", mesh=mesh41, dc_shards=DIST_SHARDS, dc_method="askotch", **opts)
    pred_thr = thr.predict_fn(x_te)
    torch.cuda.synchronize()
    thr_s = time.perf_counter() - t0
    thr_launches = ops.launches()
    thr_same = bool(torch.equal(seq.w, thr.w) and torch.equal(pred_seq, pred_thr))
    thr_coll = thr.info["collective_dispatches"]
    del thr, pred_thr
    k1 = solve(problem, "dc", dc_shards=1, dc_method="askotch", **opts)
    k1_same = bool(torch.equal(k1.w, solve_w))
    rmse_dc = float(evaluate(pred_seq, y_te).rmse)
    rec = {"phase": "dist", "path": f"dc, {DIST_SHARDS} shards (askotch)", "n": N_TRAIN,
           "shard_n": [int(len(i)) for i in seq.partition.shard_indices()],
           "shard_s": [o.info["wall_time_s"] for o in seq.shard_outputs],
           "shard_rel_residual": [h.get("rel_residual") for h in seq.history[:-1]],
           "seconds": dc_s, "solve_s": solve_rec["solve_s"], "test_rmse": rmse_dc,
           "solve_test_rmse": solve_rec["test_rmse"],
           "collective_dispatches": seq.info["collective_dispatches"],
           "mesh_collective_dispatches": par_coll,
           "collectives": coll, "mesh_11_bitwise_sequential": same,
           "mesh_41_s": thr_s, "mesh_41_bitwise_sequential": thr_same,
           "mesh_41_launches": thr_launches,
           "k1_bitwise_solve_w": k1_same, "launches": launches["dc"],
           "reduced": "n 1e8 -> 1e6 (+1e4 test): one-card time limit"}
    emit(rec)
    _path_launches(launches["dc"], ("kernel_matvec", "kernel_block"), "dc")
    if seq.info["collective_dispatches"] != 0 or par_coll != 0 or thr_coll != 0 or coll:
        fail(f"dc: collective dispatches {seq.info['collective_dispatches']} / {par_coll} / "
             f"{thr_coll} / {coll}, expected 0")
    if not (same and thr_same and thr_launches == launches["dc"] and k1_same
            and math.isfinite(rmse_dc)):
        fail(f"dc: (1, 1) mesh bitwise {same}, (4, 1) threads bitwise {thr_same} with "
             f"launches {thr_launches} against {launches['dc']}, k = 1 bitwise phase solve "
             f"{k1_same}, rmse {rmse_dc}")
    del seq, k1, pred_seq
    torch.cuda.empty_cache()

    # -- a small tune over the (2, 2) mesh: the tune rows, 2 x 2 grid, 3 folds --
    pt = KRRProblem(x=x[:N_TUNE], y=y[:N_TUNE], kernel="rbf", sigma=SIGMA,
                    lam_unscaled=LAM_UNSCALED, precision="f32")
    tkw = dict(sigmas=DIST_TUNE_SIGMAS, lams=TUNE_LAMS[1:3], folds=DIST_TUNE_FOLDS, rank=RANK,
               max_iters=TUNE_ITERS, tol=TUNE_TOL)
    tel_mesh, tel_one = Telemetry(ring=True), Telemetry(ring=True)
    ops.reset_launches()
    t0 = time.perf_counter()
    with _PathShapes() as shapes:
        r_mesh = tune(pt, mesh=mesh22, telemetry=tel_mesh, **tkw)
    tune_s = time.perf_counter() - t0
    launches["dist tune"] = ops.launches()
    shapes.hold("dist tune")
    r_one = tune(pt, telemetry=tel_one, **tkw)
    pick = lambda r: (r.best["sigma"], r.best["lam_unscaled"])  # noqa: E731
    heads_mesh, heads_one = _tune_heads(tel_mesh), _tune_heads(tel_one)
    cands = []
    for rm, ro in zip(r_mesh.records, r_one.records):
        c = list(tkw["lams"]).index(rm["lam_unscaled"])  # the candidate's place in its group
        cols = slice(c * DIST_TUNE_FOLDS, (c + 1) * DIST_TUNE_FOLDS)
        traj_m = [(it, max(h[cols])) for it, h in heads_mesh[rm["sigma"]]]
        traj_o = [(it, max(h[cols])) for it, h in heads_one[ro["sigma"]]]
        # the first CG iteration at which a fold's residual is 1 % off its
        # residual without a mesh
        apart = [it for (it, hm), (_, ho) in zip(heads_mesh[rm["sigma"]], heads_one[ro["sigma"]])
                 if any(abs(a - b) > 0.01 * b for a, b in zip(hm[cols], ho[cols]))]
        cands.append({
            "sigma": rm["sigma"], "lam_unscaled": rm["lam_unscaled"],
            "cv_mse": rm["cv_mse"], "one_device_cv_mse": ro["cv_mse"],
            "cv_mse_rel_diff": abs(rm["cv_mse"] - ro["cv_mse"]) / ro["cv_mse"],
            "converged": traj_m[-1][1] < TUNE_TOL, "one_device_converged": traj_o[-1][1] < TUNE_TOL,
            "iters": traj_m[-1][0], "one_device_iters": traj_o[-1][0],
            "residual_first_1pct_apart_at": apart[0] if apart else None,
            "residual": {it: r for it, r in traj_m if it in _TRAJ_AT or it == traj_m[-1][0]},
            "one_device_residual": {it: r for it, r in traj_o
                                    if it in _TRAJ_AT or it == traj_o[-1][0]}})
    rec = {"phase": "dist", "path": "tune, mesh (2, 2) cuda:0 x 4", "n": N_TUNE, **tkw,
           "best": r_mesh.best, "one_device_best": r_one.best, "seconds": tune_s,
           "candidates": cands, "cv_mse_rtol_converged": DIST_TUNE_RTOL,
           "residuals_agree_through": DIST_TUNE_AGREE,
           "launches": launches["dist tune"]}
    emit(rec)
    _path_launches(launches["dist tune"], ("kernel_matvec",), "dist tune")
    if pick(r_mesh) != pick(r_one):
        fail(f"dist tune: best {pick(r_mesh)} != the search without a mesh {pick(r_one)}")
    # every fold of every candidate follows the run without a mesh through
    # DIST_TUNE_AGREE iterations (a fault in one fold's or one lam's columns
    # shows there; f32 rounding drifts them apart only later); a candidate
    # converges on both runs or on neither; where both converged (every
    # fold's relative residual below TUNE_TOL) the CV MSE agrees
    off = [(c["sigma"], c["lam_unscaled"]) for c in cands
           if (c["residual_first_1pct_apart_at"] or math.inf) <= DIST_TUNE_AGREE
           or c["converged"] != c["one_device_converged"]
           or not math.isfinite(c["cv_mse"])
           or (c["converged"] and c["cv_mse_rel_diff"] > DIST_TUNE_RTOL)]
    if off:
        fail(f"dist tune: candidates {off} leave the run without a mesh within "
             f"{DIST_TUNE_AGREE} iterations, converge on one run only, or have a CV MSE off "
             f"it by more than {DIST_TUNE_RTOL}")

    # -- the taxi model served over the (2, 2) mesh ------------------------------
    xt = x[:N_TRAIN]
    pool = x_te.cpu().numpy()
    cfg = {"kernel": "rbf", "sigma": SIGMA, "lam_unscaled": LAM_UNSCALED, "precision": "f32"}
    with ServingEngine(max_batch=SERVE_MAX_BATCH, max_wait_ms=SERVE_WAIT_MS) as engine:
        ops.reset_launches()
        with _PathShapes() as shapes:
            info = engine.register("taxi_mesh", cfg, xt, solve_w, mesh=mesh22)
            traffic = _serve_traffic(engine, "taxi_mesh", pool, DIST_REQUESTS, 24)
        launches["dist serve"] = ops.launches()
    shapes.hold("dist serve")
    single = make_krr_predict_fn_from_config(cfg, xt, solve_w, max_batch=SERVE_MAX_BATCH)
    meshed = make_krr_predict_fn_from_config(cfg, xt, solve_w, mesh=mesh22,
                                             max_batch=SERVE_MAX_BATCH)
    rows = np.concatenate(traffic["queries"])
    served = torch.from_numpy(np.concatenate(traffic["outs"])).cuda()
    rows_dev = torch.from_numpy(rows).cuda()
    err, ok = _err(served, single(rows_dev), "f32")
    plain_err, plain_ok = _err(served, ref.kernel_matvec(rows_dev, xt, solve_w, SIGMA), "f32")
    same = all(np.array_equal(meshed(q).cpu().numpy(), o)
               for q, o in zip(traffic["queries"], traffic["outs"]))
    st = traffic["stats"]
    rec = {"phase": "dist", "path": "serve taxi, mesh (2, 2) cuda:0 x 4", "n": N_TRAIN,
           "requests": DIST_REQUESTS, "rows": int(rows.shape[0]),
           "seconds": traffic["seconds"], "p50_ms": st["p50_ms"], "p99_ms": st["p99_ms"],
           "bucket_runs": {b: o["runs"] for b, o in st["occupancy"].items()},
           "warmed_buckets": info["warmed_buckets"], "launches": launches["dist serve"],
           "max_abs_err_vs_phase_serve_model": err, "ok": ok,
           "max_abs_err_vs_plain": plain_err, "plain_ok": plain_ok, "bitwise_sequential": same}
    emit(rec)
    _path_launches(launches["dist serve"], ("kernel_matvec",), "dist serve")
    if st["n_requests"] != DIST_REQUESTS or not (ok and plain_ok and same):
        fail(f"dist serve: {st['n_requests']} of {DIST_REQUESTS} served, within tolerance "
             f"of one device {ok} and of the plain version {plain_ok}, bitwise sequential "
             f"{same}")

    # -- the launchers ---------------------------------------------------------
    for extra, keys in ((["--mesh", "1x1"], DIST_LAUNCHER_KEYS),
                        (["--method", "dc", "--dc-shards", str(DIST_SHARDS)], DC_LAUNCHER_KEYS)):
        report = _run_launcher("repro_torch.launch.krr_solve", "--iters", "50", *extra)
        emit({"phase": "dist", "launcher": " ".join(extra), "report": report})
        if list(report) != keys:
            fail(f"krr_solve {' '.join(extra)} keys {list(report)} != the JAX launcher's {keys}")
        if not math.isfinite(report["test_rmse"]):
            fail(f"krr_solve {' '.join(extra)}: test_rmse {report['test_rmse']}")
    return launches


#: cycles the card spins (``torch.cuda._sleep``, ~1 ms) ahead of each timed
#: call, so the call's launches are enqueued before its start event runs
HOLD_CYCLES = 2_000_000


def _time_ms(fn, reps: int = 5, warm: bool = True, hold: bool = False) -> float:
    """Median time of ``fn()`` between CUDA events.  ``hold``: the card is
    kept busy while the host enqueues the call, so a short kernel's time is
    the card's and not the wrapper's Python (phase time's kernel rows;
    without it, rows under ~0.2 ms carry ~40 us of host time)."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound_of(flops: float, nbytes: float) -> dict:
    """Least time for the work: the larger of its operations at the f32
    peak and its bytes (inputs read once, output written once) at the
    memory peak (``repro_torch.roofline.hw``)."""
    from repro_torch.roofline import hw

    t_ops, t_bytes = 1e3 * flops / hw.PEAK_FLOPS_F32, 1e3 * nbytes / hw.HBM_BW
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def _bound(m: int, n: int, d: int, t: int | None) -> dict:
    """Bound of the rbf work on (m, d) x (n, d) rows; ``t`` None is the
    block (``repro_torch.roofline.analyze.kernel_cost``: the formula the
    dry run's meta route reads too)."""
    from repro_torch.roofline import analyze

    return _bound_of(*analyze.kernel_cost(m, n, d, t))


def _bound_multi(m: int, n: int, d: int, t: int, kernels, kind: str) -> dict:
    """Bound of a multi-kernel op (``kind`` as in
    ``repro_torch.roofline.analyze.multi_ops_per_pair``)."""
    from repro_torch.roofline import analyze

    return _bound_of(*analyze.multi_kernel_cost(m, n, d, t, kernels, kind))


def _sfu_floor_ms(m: int, n: int, kernels) -> float:
    """Least time of the special-function unit for an (m, n) t = 1 sweep."""
    from repro_torch.roofline import hw

    return 1e3 * m * n * sum(SFU_OPS[k] for k in kernels) / hw.SFU_RESULTS_S


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


def time_with_floor_ms(fn, reps: int = 5) -> tuple[float, float]:
    """Median times of ``fn()`` and of ``fill_(0.5)`` on the tensor that
    call returned, rep by rep (after a warm-up): the write floor, what a
    pass that only stores reaches on this card in the very allocation the
    kernel wrote, the yardstick of kernel_block's output-bound routes.
    The card is held before each, as by ``_time_ms(hold=True)``."""
    import torch

    fn().fill_(0.5)  # warm-up
    torch.cuda.synchronize()
    ks, fs = [], []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda._sleep(HOLD_CYCLES)
        ev[0].record()
        y = fn()
        ev[1].record()
        torch.cuda._sleep(HOLD_CYCLES)
        ev[2].record()
        y.fill_(0.5)
        ev[3].record()
        torch.cuda.synchronize()
        ks.append(ev[0].elapsed_time(ev[1]))
        fs.append(ev[2].elapsed_time(ev[3]))
        del y
    return statistics.median(ks), statistics.median(fs)


def _time_case(fn, plain_fn, bound: dict, floor: bool = False, plain_reps: int = 3) -> dict:
    """Time a kernel (median of 5) and its plain version (median of
    ``plain_reps``, after the warm-up whose result the kernel's is held
    against); with ``floor`` also the write floor on the kernel's output
    (``time_with_floor_ms``)."""
    import torch

    want = plain_fn()  # also the plain version's warm-up
    extra = {}
    if floor:
        ms, extra["write_floor_ms"] = time_with_floor_ms(fn)
    else:
        ms = _time_ms(fn, hold=True)
    plain_ms = _time_ms(plain_fn, reps=plain_reps, warm=False, hold=True)
    err, ok = _err(fn(), want, "f32")
    del want
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound, **extra, "ok": ok}


def phase_time(launches: dict, weights: tuple[float, ...], tune_wc, baselines: list[dict]
               ) -> list[dict]:
    """Time every kernel at its main-path shapes.  ``launches`` holds each
    path's counts (``"solve"``, ``"tune"``, ``"refit"``, phase ova's
    ``"ova <classes>"``, and phase serve's models ``"serve taxi"``,
    ``"serve multikernel"``, ``"serve heads"``, ``"serve multikernel heads"``, phase
    ova's ``"ova multikernel"`` and phase estimators' ``"estimators tune"``:
    each path's reset and read), ``weights`` the refit's combination,
    ``tune_wc`` the tune's (q, C) per-column weights and ``baselines``
    phase ``baselines``' records (their launches and the sketch's time).
    One row per (kernel, path shape); ``path`` names the run whose count
    ``launches`` is."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.kernel_block import kernel_block_cuda
    from repro_torch.kernels.kernel_matvec import kernel_matvec_cuda
    from repro_torch.kernels.multi import (
        kernel_block_multi_cuda,
        kernel_matvec_components_cuda,
        kernel_matvec_multi_cuda,
    )

    x, xb, z = main_path_inputs()
    q = xb[:SMALL_M].contiguous()
    rows = [
        {"name": "kernel_matvec", "case": "solve G_B", "route": "cuda",
         "source": "src/repro_torch/csrc/kernel_matvec.cu",
         "replaces": "src/repro/kernels/kernel_matvec.py:164",
         "launches": launches["solve"]["kernel_matvec"], "library_ms": None,
         "shape": [BLOCK, N_TRAIN, D, 1],
         **_time_case(lambda: kernel_matvec_cuda(xb, x, z, kernel="rbf", sigma=SIGMA,
                                                 precision="f32"),
                      lambda: ref.kernel_matvec(xb, x, z, SIGMA, kernel="rbf"),
                      _bound(BLOCK, N_TRAIN, D, 1)),
         "sfu_floor_ms": _sfu_floor_ms(BLOCK, N_TRAIN, ("rbf",))},
        {"name": "kernel_block", "case": "solve K_BB", "route": "cuda",
         "source": "src/repro_torch/csrc/kernel_block.cu",
         "replaces": "src/repro/kernels/kernel_block.py:34",
         "launches": launches["solve"]["kernel_block"], "library_ms": None,
         "shape": [BLOCK, BLOCK, D],
         **_time_case(lambda: kernel_block_cuda(xb, xb, kernel="rbf", sigma=SIGMA,
                                                precision="f32"),
                      lambda: ref.kernel_block(xb, xb, SIGMA, kernel="rbf"),
                      _bound(BLOCK, BLOCK, D, None), floor=True)},
    ]
    rows[0]["path"], rows[1]["path"] = "solve", "solve"
    mv_id = {k: rows[0][k] for k in ("name", "route", "source", "replaces", "library_ms")}
    # the solve's prediction (10^4 queries), and serving's buckets of 8,
    # SMALL_M (the small_m row) and 1024 queries: fewer row tiles than SMs,
    # so the t = 1 sweep splits n over the grid
    xq = xb[:N_TEST].contiguous()
    rows += [{**mv_id, "case": "solve prediction", "path": "solve",
              "launches": launches["solve"]["kernel_matvec"], "shape": [N_TEST, N_TRAIN, D, 1],
              **_time_case(lambda: kernel_matvec_cuda(xq, x, z, kernel="rbf", sigma=SIGMA,
                                                      precision="f32"),
                           lambda: ref.kernel_matvec(xq, x, z, SIGMA, kernel="rbf"),
                           _bound(N_TEST, N_TRAIN, D, 1))}]
    for m_q, case in ((8, "serve bucket 8"), (SMALL_M, "small_m"), (1024, "serve bucket 1024")):
        rows.append({**mv_id, "case": case, "path": "serve taxi",
                     "launches": launches["serve taxi"]["kernel_matvec"],
                     "shape": [m_q, N_TRAIN, D, 1],
                     **_time_case(lambda: kernel_matvec_cuda(xb[:m_q], x, z, kernel="rbf",
                                                             sigma=SIGMA, precision="f32"),
                                  lambda: ref.kernel_matvec(xb[:m_q], x, z, SIGMA, kernel="rbf"),
                                  _bound(m_q, N_TRAIN, D, 1))})

    # the multi-kernel kernels: (rbf, laplacian, matern52), sigma 1
    ks, sg = MK_KERNELS, (SIGMA,) * len(MK_KERNELS)
    w_t = torch.tensor(weights, device="cuda")
    src = "src/repro_torch/csrc/kernel_multi.cu"
    xt = x[:N_TUNE]
    gen = torch.Generator(device="cuda").manual_seed(5)
    omega, _ = torch.linalg.qr(torch.randn((N_TUNE, RANK), generator=gen, device="cuda"))
    wc = torch.from_numpy(tune_wc).cuda()
    vc = torch.randn((N_TUNE, wc.shape[1]), generator=gen, device="cuda")
    multi = {"route": "cuda", "source": src, "library_ms": None}
    tune_path, refit_path = {"path": "tune"}, {"path": "refit"}
    rows += [
        {"name": "kernel_matvec_multi", "case": "tune matvec_cols", **multi, **tune_path,
         "replaces": "src/repro/kernels/multi.py:127",
         "launches": launches["tune"]["kernel_matvec_multi"],
         "shape": [N_TUNE, N_TUNE, D, wc.shape[1]],
         **_time_case(lambda: kernel_matvec_multi_cuda(xt, xt, vc, wc, kernels=ks, sigmas=sg,
                                                       precision="f32"),
                      lambda: ref.kernel_matvec_multi(xt, xt, vc, sg, wc, kernels=ks),
                      _bound_multi(N_TUNE, N_TUNE, D, wc.shape[1], ks, "cols"))},
        {"name": "kernel_matvec_multi", "case": "refit G_B", **multi, **refit_path,
         "replaces": "src/repro/kernels/multi.py:127",
         "launches": launches["refit"]["kernel_matvec_multi"],
         "shape": [BLOCK, N_TRAIN, D, 1],
         **_time_case(lambda: kernel_matvec_multi_cuda(xb, x, z, weights, kernels=ks, sigmas=sg,
                                                       precision="f32"),
                      lambda: ref.kernel_matvec_multi(xb, x, z, sg, w_t, kernels=ks),
                      _bound_multi(BLOCK, N_TRAIN, D, 1, ks, "matvec")),
         "sfu_floor_ms": _sfu_floor_ms(BLOCK, N_TRAIN, ks)},
        {"name": "kernel_matvec_components", "case": "tune sketch_components", **multi,
         **tune_path,
         "replaces": "src/repro/kernels/multi.py:187",
         "launches": launches["tune"]["kernel_matvec_components"],
         "shape": [N_TUNE, N_TUNE, D, RANK],
         **_time_case(lambda: kernel_matvec_components_cuda(xt, xt, omega, kernels=ks, sigmas=sg,
                                                            precision="f32"),
                      lambda: ref.kernel_matvec_components(xt, xt, omega, sg, kernels=ks),
                      _bound_multi(N_TUNE, N_TUNE, D, RANK, ks, "components"))},
        {"name": "kernel_block_multi", "case": "refit K_BB", **multi, **refit_path,
         "replaces": "src/repro/kernels/multi.py:237",
         "launches": launches["refit"]["kernel_block_multi"],
         "shape": [BLOCK, BLOCK, D],
         **_time_case(lambda: kernel_block_multi_cuda(xb, xb, kernels=ks, sigmas=sg,
                                                      weights=weights, precision="f32"),
                      lambda: ref.kernel_block_multi(xb, xb, sg, weights, kernels=ks),
                      _bound_multi(BLOCK, BLOCK, D, 0, ks, "block"))},
    ]
    mm_id = {"name": "kernel_matvec_multi", **multi, "replaces": "src/repro/kernels/multi.py:127"}
    rows += [
        {**mm_id, "case": "refit prediction", **refit_path,
         "launches": launches["refit"]["kernel_matvec_multi"],
         "shape": [N_TEST, N_TRAIN, D, 1],
         **_time_case(lambda: kernel_matvec_multi_cuda(xq, x, z, weights, kernels=ks, sigmas=sg,
                                                       precision="f32"),
                      lambda: ref.kernel_matvec_multi(xq, x, z, sg, w_t, kernels=ks),
                      _bound_multi(N_TEST, N_TRAIN, D, 1, ks, "matvec"))},
        {**mm_id, "case": "serve bucket 64 (weighted)", "path": "serve multikernel",
         "launches": launches["serve multikernel"]["kernel_matvec_multi"],
         "shape": [SMALL_M, N_TRAIN, D, 1],
         **_time_case(lambda: kernel_matvec_multi_cuda(q, x, z, weights, kernels=ks, sigmas=sg,
                                                       precision="f32"),
                      lambda: ref.kernel_matvec_multi(q, x, z, sg, w_t, kernels=ks),
                      _bound_multi(SMALL_M, N_TRAIN, D, 1, ks, "matvec"))},
    ]
    # kernel_matvec with t heads on its multi-column sweep: a one-vs-all G_B
    # of each of OVA_CLASSES (phase ova's paths), and serving buckets of the
    # OVA_HEADS-head model (split over n)
    gen_ova = torch.Generator(device="cuda").manual_seed(15)
    for t in OVA_CLASSES:
        z_ova = torch.randn((N_TRAIN, t), generator=gen_ova, device="cuda")
        rows.append(
            {**mv_id, "case": f"one-vs-all G_B (t = {t})", "path": f"ova {t}",
             "launches": launches[f"ova {t}"]["kernel_matvec"], "shape": [BLOCK, N_TRAIN, D, t],
             **_time_case(lambda: kernel_matvec_cuda(xb, x, z_ova, kernel="rbf", sigma=SIGMA,
                                                     precision="f32"),
                          lambda: ref.kernel_matvec(xb, x, z_ova, SIGMA, kernel="rbf"),
                          _bound(BLOCK, N_TRAIN, D, t))})
        if t == OVA_HEADS:
            z10 = z_ova
    del z_ova
    heads_path = {"path": "serve heads", "launches": launches["serve heads"]["kernel_matvec"]}
    for m_q in (8, SMALL_M, 1024):
        rows.append(
            {**mv_id, "case": f"serve bucket {m_q} (t = {OVA_HEADS})", **heads_path,
             "shape": [m_q, N_TRAIN, D, OVA_HEADS],
             **_time_case(lambda: kernel_matvec_cuda(xb[:m_q], x, z10, kernel="rbf",
                                                     sigma=SIGMA, precision="f32"),
                          lambda: ref.kernel_matvec(xb[:m_q], x, z10, SIGMA, kernel="rbf"),
                          _bound(m_q, N_TRAIN, D, OVA_HEADS))})
    # the single-kernel tune's stacked CG: 4 lams x 5 folds = 20 columns over
    # the 20,000 tune rows (phase estimators' tune)
    tune_t = len(TUNE_LAMS) * K_FOLDS
    v_tune = torch.randn((N_TUNE, tune_t), generator=gen_ova, device="cuda")
    rows.append(
        {**mv_id, "case": f"tune CG apply (t = {tune_t})", "path": "estimators tune",
         "launches": launches["estimators tune"]["kernel_matvec"],
         "shape": [N_TUNE, N_TUNE, D, tune_t],
         **_time_case(lambda: kernel_matvec_cuda(xt, xt, v_tune, kernel="rbf", sigma=SIGMA,
                                                 precision="f32"),
                      lambda: ref.kernel_matvec(xt, xt, v_tune, SIGMA, kernel="rbf"),
                      _bound(N_TUNE, N_TUNE, D, tune_t))})
    # the weighted heads: a multi-kernel one-vs-all G_B of OVA_HEADS classes
    # (phase ova's) and the buckets of the multi-kernel OVA_HEADS-head model,
    # the refit's combination; the plain G_B is timed once (~8 s a call)
    mk_heads = {"path": "serve multikernel heads",
                "launches": launches["serve multikernel heads"]["kernel_matvec_multi"]}
    rows.append(
        {**mm_id, "case": f"multi-kernel one-vs-all G_B (t = {OVA_HEADS})",
         "path": "ova multikernel",
         "launches": launches["ova multikernel"]["kernel_matvec_multi"],
         "shape": [BLOCK, N_TRAIN, D, OVA_HEADS],
         **_time_case(lambda: kernel_matvec_multi_cuda(xb, x, z10, weights, kernels=ks, sigmas=sg,
                                                       precision="f32"),
                      lambda: ref.kernel_matvec_multi(xb, x, z10, sg, w_t, kernels=ks),
                      _bound_multi(BLOCK, N_TRAIN, D, OVA_HEADS, ks, "matvec"), plain_reps=1)})
    for m_q in (8, SMALL_M, 1024):
        rows.append(
            {**mm_id, "case": f"serve bucket {m_q} (weighted, t = {OVA_HEADS})", **mk_heads,
             "shape": [m_q, N_TRAIN, D, OVA_HEADS],
             **_time_case(lambda: kernel_matvec_multi_cuda(xb[:m_q], x, z10, weights, kernels=ks,
                                                           sigmas=sg, precision="f32"),
                          lambda: ref.kernel_matvec_multi(xb[:m_q], x, z10, sg, w_t, kernels=ks),
                          _bound_multi(m_q, N_TRAIN, D, OVA_HEADS, ks, "matvec"))})
    del z10, v_tune
    # the baselines' new shapes: pcg-nystrom's sketch at t = 100 (timed at
    # G_B's 50,000 rows, beside the sketch's one 10^6-row launch from the
    # phase), an RPCholesky pivot column and Falkon's two sweeps
    by_method = {r["method"]: r for r in baselines}
    nys = by_method["pcg-nystrom"]
    gen_b = torch.Generator(device="cuda").manual_seed(13)
    omega_b, _ = torch.linalg.qr(torch.randn((N_TRAIN, RANK), generator=gen_b, device="cuda"))
    xm = x.index_select(0, torch.randperm(N_TRAIN, generator=gen_b, device="cuda")[:FALKON_M])
    vm = torch.randn((FALKON_M,), generator=gen_b, device="cuda")
    xp = xb[:1].contiguous()
    ident = ("name", "route", "source", "replaces", "library_ms")
    mv_row, blk_row = ({k: r[k] for k in ident} for r in rows[:2])
    mv = lambda a, b, v: kernel_matvec_cuda(a, b, v, kernel="rbf", sigma=SIGMA,  # noqa: E731
                                            precision="f32")
    sketch_bound = _bound(N_TRAIN, N_TRAIN, D, RANK)
    rows += [
        {**mv_row, "case": "pcg-nystrom sketch (t = 100)", "path": "baselines pcg-nystrom",
         "launches": nys["launches"]["kernel_matvec"], "shape": [BLOCK, N_TRAIN, D, RANK],
         **_time_case(lambda: mv(xb, x, omega_b),
                      lambda: ref.kernel_matvec(xb, x, omega_b, SIGMA),
                      _bound(BLOCK, N_TRAIN, D, RANK)),
         "sketch_ms": nys["sketch_ms"], "sketch_shape": nys["sketch_shape"],
         "sketch_bound_ms": sketch_bound["bound_ms"], "sketch_bound_by": sketch_bound["bound_by"]},
        {**blk_row, "case": "rpcholesky pivot column", "path": "baselines pcg-rpcholesky",
         "launches": by_method["pcg-rpcholesky"]["launches"]["kernel_block"],
         "shape": [N_TRAIN, 1, D],
         **_time_case(lambda: kernel_block_cuda(x, xp, kernel="rbf", sigma=SIGMA,
                                                precision="f32"),
                      lambda: ref.kernel_block(x, xp, SIGMA), _bound(N_TRAIN, 1, D, None))},
        {**blk_row, "case": "falkon K_mm", "path": "baselines falkon",
         "launches": by_method["falkon"]["launches"]["kernel_block"],
         "shape": [FALKON_M, FALKON_M, D],
         **_time_case(lambda: kernel_block_cuda(xm, xm, kernel="rbf", sigma=SIGMA,
                                                precision="f32"),
                      lambda: ref.kernel_block(xm, xm, SIGMA), _bound(FALKON_M, FALKON_M, D, None),
                      floor=True)},
        {**blk_row, "case": "sap row", "path": "sap kaczmarz",
         "launches": launches["sap kaczmarz"]["kernel_block"], "shape": [1, N_TUNE, D],
         **_time_case(lambda: kernel_block_cuda(x[7:8], x[:N_TUNE], kernel="rbf", sigma=SIGMA,
                                                precision="f32"),
                      lambda: ref.kernel_block(x[7:8], x[:N_TUNE], SIGMA),
                      _bound(1, N_TUNE, D, None))},
        {**mv_row, "case": "falkon K(X, X_m) v", "path": "baselines falkon",
         "launches": by_method["falkon"]["launches"]["kernel_matvec"],
         "shape": [N_TRAIN, FALKON_M, D, 1],
         **_time_case(lambda: mv(x, xm, vm), lambda: ref.kernel_matvec(x, xm, vm, SIGMA),
                      _bound(N_TRAIN, FALKON_M, D, 1))},
        {**mv_row, "case": "falkon K(X_m, X) u", "path": "baselines falkon",
         "launches": by_method["falkon"]["launches"]["kernel_matvec"],
         "shape": [FALKON_M, N_TRAIN, D, 1],
         **_time_case(lambda: mv(xm, x, z), lambda: ref.kernel_matvec(xm, x, z, SIGMA),
                      _bound(FALKON_M, N_TRAIN, D, 1))},
    ]
    # the distributed tier's new shapes: the (1, 1) mesh's Nystrom sketch
    # (K(x_B, x_B) Omega at t = r) and powering (t = 1 over the block), and
    # a DC shard's G_B and K_BB (the inner askotch on 10^6 / 4 rows)
    omega_bb, _ = torch.linalg.qr(torch.randn((BLOCK, RANK), generator=gen_b, device="cuda"))
    v_bb = torch.randn((BLOCK,), generator=gen_b, device="cuda")
    x_sh, z_sh = x[:N_TRAIN // DIST_SHARDS], z[:N_TRAIN // DIST_SHARDS]
    dist_path = {"path": "dist askotch", "launches": launches["dist askotch"]["kernel_matvec"]}
    rows += [
        {**mv_row, "case": "dist Nystrom sketch (t = 100)", **dist_path,
         "shape": [BLOCK, BLOCK, D, RANK],
         **_time_case(lambda: mv(xb, xb, omega_bb),
                      lambda: ref.kernel_matvec(xb, xb, omega_bb, SIGMA),
                      _bound(BLOCK, BLOCK, D, RANK))},
        {**mv_row, "case": "dist powering (t = 1)", **dist_path,
         "shape": [BLOCK, BLOCK, D, 1],
         **_time_case(lambda: mv(xb, xb, v_bb), lambda: ref.kernel_matvec(xb, xb, v_bb, SIGMA),
                      _bound(BLOCK, BLOCK, D, 1))},
        {**mv_row, "case": "dc shard G_B", "path": "dc",
         "launches": launches["dc"]["kernel_matvec"], "shape": [BLOCK, len(x_sh), D, 1],
         **_time_case(lambda: mv(xb, x_sh, z_sh), lambda: ref.kernel_matvec(xb, x_sh, z_sh, SIGMA),
                      _bound(BLOCK, len(x_sh), D, 1))},
        {**blk_row, "case": "dc shard K_BB", "path": "dc",
         "launches": launches["dc"]["kernel_block"], "shape": [BLOCK, BLOCK, D],
         **_time_case(lambda: kernel_block_cuda(xb, xb, kernel="rbf", sigma=SIGMA,
                                                precision="f32"),
                      lambda: ref.kernel_block(xb, xb, SIGMA, kernel="rbf"),
                      _bound(BLOCK, BLOCK, D, None), floor=True)},
    ]
    for r in rows:
        emit({"phase": "time", **r})
        if not r["ok"]:
            fail(f"{r['name']} disagrees with its plain version at shape {r['shape']}")
    return rows


# ---------------------------------------------------------------------------
# phase lm: LM serving (the ten architectures, four of them at full width)
# ---------------------------------------------------------------------------

# the JAX serve launcher's defaults (src/repro/launch/serve.py:26-29)
LM_BATCH, LM_PROMPT, LM_NEW = 4, 32, 16
LM_STEPS = 4  # decode steps held against the CPU at reduced size
LM_DMP_TOL = 2e-3  # decode-matches-prefill, f32 (tests/test_models_smoke.py:86-91)
# qwen2-1.5b in bf16 over 28 layers: atol 0.055 x max(1, |ref|max), for
# decode against prefill and for each against its f32 twin: about 1.5 x the
# largest of the three readings (0.149 on logits up to 3.89; bf16 rounding
# through 28 residual blocks)
LM_BF16_TOL = (0.0, 0.055, True)
# the full-width runs: qwen2-1.5b at its published config, whisper-base and
# rwkv6-1.6b at theirs, deepseek-moe-16b at its published width with depth
# cut from 28 to 2 layers (28 layers of f32 parameters, ~66 GB, leave no room)
LM_FULL = (("qwen2-1.5b", {}), ("whisper-base", {}), ("rwkv6-1.6b", {}),
           ("deepseek-moe-16b", {"num_layers": 2}))
# keys of the JSON line ``python -m repro.launch.serve`` prints
# (src/repro/launch/serve.py:40-47)
LM_LAUNCHER_KEYS = ["arch", "generated_shape", "tokens", "seconds", "tok_per_s", "sample"]


def _lm_err(got, ref, rtol: float, atol: float, scaled: bool = True) -> tuple[float, bool]:
    """(max |got - ref|, within rtol |ref| + atol, the atol scaled by
    max(1, |ref|max) when ``scaled``)."""
    got, ref = got.float(), ref.float().to(got.device)
    diff = (got - ref).abs()
    bound = rtol * ref.abs() + atol * (max(1.0, float(ref.abs().max())) if scaled else 1.0)
    return float(diff.max()), got.shape == ref.shape and bool((diff <= bound).all())


class _RecordRoutes:
    """Within the block, every MoE routing round of the port records its
    (input, gates, experts) on the CPU into ``self.rounds``."""

    def __enter__(self):
        from repro_torch.models import layers

        self.rounds, self._route = [], layers.moe_route

        def recording(xc, router, k):
            gates, experts = self._route(xc, router, k)
            self.rounds.append((xc.detach().cpu(), gates.detach().cpu(), experts.cpu()))
            return gates, experts

        layers.moe_route = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers

        layers.moe_route = self._route


def _routes_agree(card: list, cpu: list) -> tuple[float, bool]:
    """(worst gate difference, every round of the card run saw the CPU
    round's input within f32 tolerance and routed every token to the same
    experts, gates within f32 tolerance)."""
    import torch

    if len(card) != len(cpu) or not cpu:
        return math.inf, False
    worst, ok = 0.0, True
    for (xg, gg, eg), (xc, gc, ec) in zip(card, cpu):
        x_ok = _lm_err(xg, xc, *TOL["f32"])[1]
        g_err, g_ok = _lm_err(gg, gc, *TOL["f32"])
        worst = max(worst, g_err)
        ok = ok and x_ok and g_ok and torch.equal(eg, ec)
    return worst, ok


def _lm_run(cfg, params, batch, dev: str, tokens=None) -> dict:
    """loss, prefill logits, LM_STEPS decode logits (fed ``tokens``, else
    its own greedy ones), ``greedy_generate``'s tokens and every MoE routing
    round, all on ``dev``."""
    with _RecordRoutes() as routes:
        out = _lm_forward(cfg, params, batch, dev, tokens)
    return {**out, "routes": routes.rounds}


def _lm_forward(cfg, params, batch, dev: str, tokens=None) -> dict:
    import torch

    from repro_torch.models.model_api import get_model, tree_map
    from repro_torch.serving.serve_step import _copy_cache, greedy_generate

    impl = get_model(cfg)
    params = tree_map(lambda t: t.to(dev), params)
    batch = {k: v.to(dev) for k, v in batch.items()}
    loss, _ = impl.loss_fn(params, batch, cfg)
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    logits, cache = impl.prefill(params, prompt, cfg)
    big = _copy_cache(cache, impl.init_cache(cfg, logits.shape[0],
                                             int(cache["pos"]) + LM_STEPS, device=dev))
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    dec, fed = [], []
    for i in range(LM_STEPS):
        tok = tokens[i].to(dev) if tokens is not None else tok
        fed.append(tok.cpu())
        out, big = impl.decode_step(params, big, {"tokens": tok}, cfg)
        dec.append(out)
        tok = torch.argmax(out[:, -1], -1)[:, None].to(torch.int32)
    return {"loss": loss, "logits": logits, "dec": dec, "fed": fed,
            "greedy": greedy_generate(cfg, params, prompt, LM_STEPS).cpu()}


def _lm_reduced(arch: str) -> dict:
    """One reduced (f32) architecture on the card against the CPU: the same
    weights and batch (drawn on the CPU from seeds)."""
    import torch

    from repro_torch.configs.base import get_reduced_config
    from repro_torch.data import synthetic
    from repro_torch.models.model_api import init_params

    cfg = get_reduced_config(arch)
    params = init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    batch = synthetic.batch_for(cfg, (2, 16), 0, 0, device="cpu")
    cpu = _lm_run(cfg, params, batch, "cpu")
    card = _lm_run(cfg, params, batch, "cuda", tokens=cpu["fed"])
    tol = TOL["f32"]
    checks = {"loss": _lm_err(card["loss"], cpu["loss"], *tol),
              "prefill": _lm_err(card["logits"], cpu["logits"], *tol)}
    for i in range(LM_STEPS):
        checks[f"decode {i}"] = _lm_err(card["dec"][i], cpu["dec"][i], *tol)
    checks["greedy"] = (0.0, torch.equal(card["greedy"], cpu["greedy"]))
    if cfg.num_experts:
        checks["routing"] = _routes_agree(card["routes"], cpu["routes"])
    return {"phase": "lm", "arch": arch, "config": "reduced f32", "family": cfg.family,
            "device": str(card["logits"].device), "routing_rounds": len(card["routes"]),
            "max_abs_err": {k: e for k, (e, _) in checks.items()},
            "greedy_card": card["greedy"].tolist(), "greedy_cpu": cpu["greedy"].tolist(),
            "failed": [k for k, (_, ok) in checks.items() if not ok]}


def _lm_moe_layer() -> dict:
    """``moe_ffn`` on the card against the CPU at O(1) inputs, with capacity
    drops and four token chunks: deepseek-moe-16b's reduced layer (8
    experts top-2, one shared), 256 tokens routed 64 a round, capacity
    factor 0.25 (8 slots an expert for 16 assignments on average)."""
    import dataclasses

    import torch

    from repro_torch.configs.base import get_reduced_config
    from repro_torch.models import layers, transformer

    cfg = dataclasses.replace(get_reduced_config("deepseek-moe-16b"), capacity_factor=0.25,
                              moe_dispatch_tokens=64)
    gen = torch.Generator().manual_seed(5)
    params = {}
    for path, (shape, _) in transformer.param_defs(cfg).items():
        if path.startswith("layers.moe_"):
            shape = shape[1:]  # one layer
            params[path[len("layers."):]] = torch.randn(shape, generator=gen) * shape[-2] ** -0.5
    x = torch.randn((4, 64, cfg.d_model), generator=gen)
    with _RecordRoutes() as cpu_routes:
        want = layers.moe_ffn(cfg, x, params)
    with _RecordRoutes() as card_routes:
        got = layers.moe_ffn(cfg, x.cuda(), {k: v.cuda() for k, v in params.items()})
    per_expert = torch.stack([torch.bincount(e.reshape(-1), minlength=cfg.num_experts)
                              for _, _, e in cpu_routes.rounds])
    checks = {"output": _lm_err(got, want, *TOL["f32"]),
              "routing": _routes_agree(card_routes.rounds, cpu_routes.rounds),
              # the case it is meant to be: 4 rounds, some expert over its 8 slots
              "drops and chunks": (0.0, len(cpu_routes.rounds) == 4
                                   and int(per_expert.max()) > 8)}
    return {"phase": "lm", "arch": "deepseek-moe-16b", "config": "moe_ffn layer, O(1) inputs",
            "device": str(got.device), "rounds": len(card_routes.rounds),
            "max_assignments_an_expert": int(per_expert.max()),
            "max_abs_output": float(want.abs().max()),
            "max_abs_err": {k: e for k, (e, _) in checks.items()},
            "failed": [k for k, (_, ok) in checks.items() if not ok]}


def _decode_vs_prefill(cfg, params, batch, spoil: str = ""):
    """(decode logits of the next token, the same token's logits from a
    prefill one token longer).  ``spoil`` leaves the decode's k and v cache
    unwritten (zero) at the last prompt position ("last slot") or at every
    prompt position ("all slots")."""
    import torch

    from repro_torch.models.model_api import get_model
    from repro_torch.serving.serve_step import _copy_cache

    impl = get_model(cfg)
    logits_p, cache = impl.prefill(params, batch, cfg)
    big = _copy_cache(cache, impl.init_cache(cfg, logits_p.shape[0], int(cache["pos"]) + 4,
                                             device=logits_p.device))
    nt = torch.argmax(logits_p[:, -1], -1)[:, None].to(torch.int32)
    if spoil:
        lost = slice(int(cache["pos"]) - 1 if spoil == "last slot" else 0, int(cache["pos"]))
        big["k"][:, :, lost] = 0
        big["v"][:, :, lost] = 0
    logits_d, _ = impl.decode_step(params, big, {"tokens": nt}, cfg)
    longer = {**batch, "tokens": torch.cat([batch["tokens"], nt], dim=1)}
    return logits_d[:, 0], impl.prefill(params, longer, cfg)[0][:, -1]


def _lm_full(arch: str, cut: dict, smi: str) -> dict:
    """One architecture at its published width on the card: generation at
    the JAX launcher's defaults, prefill and decode times (CUDA events,
    median of 5), tok/s, peak memory, the decode's byte bound, and decode
    against prefill in f32 (and, for qwen2-1.5b, in its bf16)."""
    import dataclasses

    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.data import synthetic
    from repro_torch.models.model_api import flatten, get_model, init_params
    from repro_torch.roofline import hw
    from repro_torch.serving.serve_step import _copy_cache, greedy_generate

    cfg = dataclasses.replace(get_config(arch), **cut)
    impl = get_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    batch = synthetic.batch_for(cfg, (LM_BATCH, LM_PROMPT), 0, 0, device="cuda")
    batch.pop("labels", None)
    greedy_generate(cfg, params, batch, 2)  # warm-up (cuBLAS handles, allocator)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = greedy_generate(cfg, params, batch, LM_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    prefill_ms = _time_ms(lambda: impl.prefill(params, batch, cfg))
    logits, cache = impl.prefill(params, batch, cfg)
    big = _copy_cache(cache, impl.init_cache(cfg, LM_BATCH, int(cache["pos"]) + LM_NEW,
                                             device="cuda"))
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    decode_ms = _time_ms(lambda: impl.decode_step(params, big, {"tokens": tok}, cfg))
    peak = torch.cuda.max_memory_allocated()
    # a decode step reads every parameter once and the cache it attends over
    param_bytes = sum(t.numel() * t.element_size() for t in flatten(params).values())
    cache_bytes = sum(t.numel() * t.element_size() for t in big.values() if t.ndim)
    bound_ms = 1e3 * (param_bytes + cache_bytes) / hw.HBM_BW
    rec = {"phase": "lm", "arch": arch, "config": "published" if not cut else
           f"published width, {cut}", "card": smi, "n_params": cfg.n_params(),
           "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
           "batch": LM_BATCH, "prompt": LM_PROMPT, "new": LM_NEW,
           "generated_shape": list(out.shape), "sample": out[0, :8].tolist(),
           "generate_s": gen_s, "tok_per_s": LM_BATCH * LM_NEW / gen_s,
           "prefill_ms": prefill_ms, "decode_ms": decode_ms,
           "decode_tok_per_s": 1e3 * LM_BATCH / decode_ms,
           "peak_mem_gb": peak / 1e9, "param_gb": param_bytes / 1e9,
           "decode_bound_ms": bound_ms, "decode_bound_by": "bytes",
           "decode_over_bound": decode_ms / bound_ms, "failed": []}
    if tuple(out.shape) != (LM_BATCH, LM_NEW) or not (
            0 <= int(out.min()) and int(out.max()) < cfg.padded_vocab()):
        rec["failed"].append("generation")
    # decode against a one-token-longer prefill in f32, at the reference's
    # tolerance (flat 2e-3).  Capacity routing depends on the token
    # population: at the published capacity factor a prefill of 4 x 33
    # tokens over 64 experts drops assignments that a 4-token decode keeps,
    # so an MoE model is judged dropless (capacity_factor = E / k) and its
    # published-capacity error is recorded beside it.
    f32 = dataclasses.replace(cfg, dtype="float32")
    f32_pair = None  # (decode, prefill) logits of the f32 run, for bf16 below
    runs = [("f32", f32, (LM_DMP_TOL, LM_DMP_TOL, False))]
    if cfg.num_experts:
        runs = [("f32 dropless", dataclasses.replace(
                    f32, capacity_factor=cfg.num_experts / cfg.top_k),
                 (LM_DMP_TOL, LM_DMP_TOL, False)),
                ("f32 published capacity", f32, None)]
    for name, run_cfg, tol in runs:
        got, want = _decode_vs_prefill(run_cfg, params, batch)
        err, ok = _lm_err(got, want, *(tol or (0.0, 0.0)))
        rec[f"decode_vs_prefill {name}"] = {"max_abs_err": err, "tol": tol and list(tol),
                                            "max_abs_logit": float(want.abs().max())}
        if tol and not ok:
            rec["failed"].append(f"decode vs prefill {name}")
        if name == "f32":
            f32_pair = got, want
    if arch == "qwen2-1.5b":  # its own bf16: each path against its f32 twin too
        got, want = _decode_vs_prefill(cfg, params, batch)
        checks = {"decode vs prefill": _lm_err(got, want, *LM_BF16_TOL),
                  "decode vs f32 decode": _lm_err(got, f32_pair[0], *LM_BF16_TOL),
                  "prefill vs f32 prefill": _lm_err(want, f32_pair[1], *LM_BF16_TOL)}
        rec["bf16"] = {k: e for k, (e, _) in checks.items()}
        rec["bf16"]["tol"] = list(LM_BF16_TOL)
        rec["bf16"]["argmax_agree"] = float(
            (got.argmax(-1) == want.argmax(-1)).float().mean())
        # what a broken bf16 decode reads against the same limit (recorded,
        # not judged): its cache left unwritten at one or every prompt slot
        for spoil in ("last slot", "all slots"):
            broken, _ = _decode_vs_prefill(cfg, params, batch, spoil=spoil)
            rec["bf16"][f"broken: {spoil} unwritten"] = _lm_err(broken, want, *LM_BF16_TOL)
        rec["failed"] += [f"bf16 {k}" for k, (_, ok) in checks.items() if not ok]
    del params, cache, big, logits
    torch.cuda.empty_cache()
    return rec


def phase_lm(smi: str) -> list[dict]:
    """The ten reduced architectures on the card against the CPU, then four
    at full width on the card alone."""
    from repro_torch.configs.base import ARCH_IDS

    recs = [_lm_moe_layer()]
    emit(recs[-1])
    for arch in ARCH_IDS:
        recs.append(_lm_reduced(arch))
        emit(recs[-1])
    for arch, cut in LM_FULL:
        recs.append(_lm_full(arch, cut, smi))
        emit(recs[-1])
    bad = {r["arch"] + " " + r["config"]: r["failed"] for r in recs if r["failed"]}
    if bad:
        fail(f"phase lm: {bad}")
    return recs


# ---------------------------------------------------------------------------
# phase train: LM training (the ten reduced configs, qwen2-1.5b at full size)
# ---------------------------------------------------------------------------

# the JAX train launcher's defaults (src/repro/launch/train.py:138-150)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 128, 3e-4
TRAIN_STEPS = 10  # on one repeated batch
# AdamW's eps in the card-against-CPU step: at the default 1e-8 a first
# step moves a weight by ~lr x sign(g), so a gradient of ~1e-7 whose last
# digits differ (inside the gradient tolerance) moves it by another amount
TRAIN_CHECK_EPS = 1e-3
# remat "full" against "none" at qwen2-1.5b (bf16 activations): each
# gradient leaf within 1e-3 x its largest magnitude (recorded whether bitwise)
TRAIN_REMAT_TOL = 1e-3
# the bf16 step-0 gradient against its f32 twin's: cosine similarity >= 0.99,
# global-norm ratio within [0.9, 1.1]
TRAIN_BF16_COS, TRAIN_BF16_NORM = 0.99, (0.9, 1.1)
# microbatches 2 against 1 (bf16): losses within 2e-3 relative; the
# parameters' updates with cosine similarity >= 0.99
TRAIN_MB_LOSS_RTOL, TRAIN_MB_COS = 2e-3, 0.99
# the launcher's fault drill at the JAX test's shapes
# (tests/test_distributed.py:265-288)
DRILL_ARGS = ("--arch", "qwen2-1.5b", "--reduced", "--steps", "30", "--batch", "4",
              "--seq", "16", "--lr", "1e-3", "--ckpt-every", "10", "--log-every", "5")
LAUNCH_TRAIN_STEPS = 20  # the full-width launcher run, no checkpoint directory


def _np_lm_params(cfg, seed: int = 0) -> dict:
    """numpy parameters over the port's param_defs: uniform draws of
    standard deviation 0.02, norm scales 1 + 0.1 x a unit-variance draw
    (as the CPU parity tests draw them), as CPU tensors."""
    import numpy as np
    import torch

    from repro_torch.models.model_api import get_model, unflatten

    rng = np.random.default_rng(seed)
    flat = {}
    for path, (shape, _) in sorted(get_model(cfg).param_defs(cfg).items()):
        z = (rng.random(shape, dtype=np.float32) - 0.5) * (2.0 * 3.0**0.5)
        flat[path] = torch.from_numpy(1.0 + 0.1 * z if path.endswith("scale") else 0.02 * z)
    return unflatten(flat)


def _train_run(cfg, params, batch, dev: str) -> dict:
    """Loss, gradients and one AdamW train step on ``dev`` (from copies of
    the CPU inputs), with every MoE routing round recorded."""
    from repro_torch.models.model_api import flatten, get_model, tree_map
    from repro_torch.training.optimizers import adamw
    from repro_torch.training.train_step import make_train_step, value_and_grad

    params = tree_map(lambda t: t.to(dev, copy=True), params)
    batch = {k: v.to(dev) for k, v in batch.items()}
    with _RecordRoutes() as routes:
        loss, _, grads = value_and_grad(get_model(cfg).loss_fn, params, batch, cfg)
    opt = adamw(1e-2, eps=TRAIN_CHECK_EPS)
    new, _, metrics = make_train_step(cfg, opt)(params, opt.init(params), batch, 0)
    return {"loss": loss, "grads": flatten(grads), "params": flatten(new),
            "step_loss": metrics["loss"], "routes": routes.rounds}


def _train_reduced(arch: str) -> dict:
    """One reduced (f32) architecture's train step on the card against the
    CPU: the same numpy parameters and batch (B = 2, T = 16)."""
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.data import synthetic

    cfg = get_reduced_config(arch)
    params = _np_lm_params(cfg)
    batch = synthetic.batch_for(cfg, (2, 16), 0, 0, device="cpu")
    cpu = _train_run(cfg, params, batch, "cpu")
    card = _train_run(cfg, params, batch, "cuda")
    tol = TOL["f32"]
    checks = {"loss": _lm_err(card["loss"], cpu["loss"], *tol),
              "step loss": _lm_err(card["step_loss"], cpu["step_loss"], *tol)}
    grad_errs = {k: _lm_err(g, cpu["grads"][k], *tol) for k, g in card["grads"].items()}
    param_errs = {k: _lm_err(p, cpu["params"][k], *tol) for k, p in card["params"].items()}
    checks["grads"] = (max(e for e, _ in grad_errs.values()),
                       all(ok for _, ok in grad_errs.values()))
    checks["params after the step"] = (max(e for e, _ in param_errs.values()),
                                       all(ok for _, ok in param_errs.values()))
    if cfg.num_experts:
        checks["routing"] = _routes_agree(card["routes"], cpu["routes"])
    return {"phase": "train", "arch": arch, "config": "reduced f32", "family": cfg.family,
            "device": str(card["loss"].device), "grad_leaves": len(card["grads"]),
            "microbatches": cfg.microbatches_train, "routing_rounds": len(card["routes"]),
            "max_abs_err": {k: e for k, (e, _) in checks.items()},
            "failed": [k for k, (_, ok) in checks.items() if not ok]
            + [f"grad {k}" for k, (_, ok) in grad_errs.items() if not ok]}


def _cosine(a: dict, b: dict) -> tuple[float, float]:
    """(cosine similarity of two trees as flat vectors, |a| / |b|), in f64."""
    dot = sum(float((a[k].double() * b[k].double()).sum()) for k in b)
    na = math.sqrt(sum(float(a[k].double().square().sum()) for k in b))
    nb = math.sqrt(sum(float(b[k].double().square().sum()) for k in b))
    return dot / max(na * nb, 1e-300), na / max(nb, 1e-300)


def _peak_gb(fn) -> tuple[object, float]:
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 1e9


def _train_full(smi: str) -> dict:
    """qwen2-1.5b at its published config trained on the card at the JAX
    launcher's defaults: checks of remat, microbatches and bf16 against an
    f32 twin on the step-0 gradient, then TRAIN_STEPS steps of
    ``launch.train.build``'s AdamW on one repeated batch, timed."""
    import dataclasses

    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.data import synthetic
    from repro_torch.launch.train import build
    from repro_torch.models.model_api import flatten, get_model, init_params
    from repro_torch.roofline import hw
    from repro_torch.training.optimizers import adamw
    from repro_torch.training.train_step import make_train_step, value_and_grad

    cfg = get_config("qwen2-1.5b")
    torch.cuda.empty_cache()
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    batch = synthetic.batch_for(cfg, (TRAIN_BATCH, TRAIN_SEQ), 0, 0, device="cuda")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    param_bytes = sum(t.numel() * t.element_size() for t in flatten(params).values())
    rec = {"phase": "train", "arch": cfg.name, "config": "published", "card": smi,
           "n_params": cfg.n_params(), "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
           "remat": cfg.remat, "optimizer": cfg.optimizer, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "lr": TRAIN_LR, "param_gb": param_bytes / 1e9, "failed": []}

    def grads_of(c):
        return value_and_grad(get_model(c).loss_fn, params, batch, c)

    value_and_grad(get_model(cfg).loss_fn, params, batch, cfg)  # warm-up (cuBLAS, allocator)
    (loss0, _, g_full), rec["grad_peak_gb_remat_full"] = _peak_gb(lambda: grads_of(cfg))
    g_full = flatten(g_full)
    (_, _, g_none), rec["grad_peak_gb_remat_none"] = _peak_gb(
        lambda: grads_of(dataclasses.replace(cfg, remat="none")))
    g_none = flatten(g_none)
    errs = {k: float((g_full[k].float() - g_none[k].float()).abs().max()) for k in g_none}
    bad = [k for k in g_none if errs[k] > TRAIN_REMAT_TOL * float(g_none[k].abs().max())]
    rec["remat_full_vs_none"] = {"max_abs_err": max(errs.values()), "tol": TRAIN_REMAT_TOL,
                                 "bitwise": all(torch.equal(g_full[k], g_none[k])
                                                for k in g_none), "leaves_out": bad}
    if bad:
        rec["failed"].append("remat full vs none")
    del g_none
    _, _, g_f32 = grads_of(dataclasses.replace(cfg, dtype="float32"))
    cos, ratio = _cosine(g_full, flatten(g_f32))
    del g_f32
    rec["bf16_vs_f32_grad"] = {"cosine": cos, "norm_ratio": ratio, "min_cosine": TRAIN_BF16_COS,
                               "norm_band": list(TRAIN_BF16_NORM)}
    if not (cos >= TRAIN_BF16_COS and TRAIN_BF16_NORM[0] <= ratio <= TRAIN_BF16_NORM[1]):
        rec["failed"].append("bf16 vs f32 gradient")
    rec["loss0"] = float(loss0)
    lnv = math.log(cfg.padded_vocab())
    if not 0.5 * lnv <= rec["loss0"] <= 1.5 * lnv:
        rec["failed"].append("step-0 loss outside 0.5-1.5 x ln(padded vocab)")
    del g_full

    # microbatches 2 against 1: one constant-rate AdamW step from the same
    # parameters (the schedule's rate at step 0 is 0)
    steps, before = {}, flatten(params)
    for m in (1, 2):
        p = _tree_clone(params)
        opt = adamw(TRAIN_LR)
        new, state, metrics = make_train_step(dataclasses.replace(cfg, microbatches_train=m),
                                              opt)(p, opt.init(p), batch, 0)
        steps[m] = (float(metrics["loss"]), {k: v - before[k] for k, v in flatten(new).items()})
        del new, state, p
    (l1, d1), (l2, d2) = steps[1], steps[2]
    cos_mb, _ = _cosine(d2, d1)
    rec["microbatches_2_vs_1"] = {
        "loss": [l1, l2], "loss_rel_err": abs(l2 - l1) / abs(l1), "update_cosine": cos_mb,
        "update_max_abs_err": max(float((d2[k] - d1[k]).abs().max()) for k in d1),
        "loss_rtol": TRAIN_MB_LOSS_RTOL, "min_cosine": TRAIN_MB_COS}
    if not (abs(l2 - l1) <= TRAIN_MB_LOSS_RTOL * abs(l1) and cos_mb >= TRAIN_MB_COS):
        rec["failed"].append("microbatches 2 vs 1")
    del steps, d1, d2, before

    # TRAIN_STEPS steps of the launcher's optimizer and step on one batch
    opt, stepfn = build(cfg, TRAIN_LR, TRAIN_STEPS)
    opt_state = opt.init(params)
    losses, times = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for step in range(TRAIN_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt_state, metrics = stepfn(params, opt_state, batch, step)
        end.record()
        losses.append(float(metrics["loss"]))  # synchronizes
        times.append(start.elapsed_time(end))
    rec["peak_gb_remat_full"] = torch.cuda.max_memory_allocated() / 1e9
    # one more step without remat (the same state, step 10): its peak
    _, rec["peak_gb_remat_none"] = _peak_gb(lambda: make_train_step(
        dataclasses.replace(cfg, remat="none"), opt)(params, opt_state, batch, TRAIN_STEPS))
    step_ms = statistics.median(times[-5:])
    flops = 8 * cfg.n_params() * tokens  # forward, its remat recompute, backward
    nbytes = 7 * param_bytes  # AdamW: p, g, m, v read; p, m, v written
    bound_ms = 1e3 * flops / hw.PEAK_FLOPS_BF16 + 1e3 * nbytes / hw.HBM_BW
    rec.update({"losses": losses, "step_ms": step_ms, "step_ms_all": times,
                "tok_per_s": 1e3 * tokens / step_ms, "bound_ms": bound_ms,
                "bound_flops": flops, "bound_bytes": nbytes, "over_bound": step_ms / bound_ms})
    if not losses[-1] < losses[0]:
        rec["failed"].append("last loss not below the first")
    if not all(math.isfinite(x) for x in losses):
        rec["failed"].append("non-finite loss")
    if max(rec["peak_gb_remat_full"], rec["peak_gb_remat_none"]) >= hw.HBM_BYTES / 1e9:
        rec["failed"].append("peak memory at or above 80 GB")
    del params, opt_state
    torch.cuda.empty_cache()
    return rec


def _tree_clone(tree: dict) -> dict:
    return {k: _tree_clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _launcher_lines(module: str, *args: str) -> list[dict]:
    """Run ``python -m module args`` on the card; its JSON stdout lines."""
    return [json.loads(s) for s in _launcher_stdout(module, *args).splitlines()
            if s.startswith("{")]


def _train_launcher(smi: str) -> list[dict]:
    """The launcher's fault drill against a clean run (reduced qwen2-1.5b,
    checkpoints under chiprun_out/), then one full-width run without a
    checkpoint directory."""
    import shutil

    recs = []
    dirs = {name: OUT_DIR / f"train_{name}" for name in ("drill", "clean")}
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    drill = _launcher_lines("repro_torch.launch.train", *DRILL_ARGS, "--ckpt-dir",
                            str(dirs["drill"]), "--inject-failure", "17")
    clean = _launcher_lines("repro_torch.launch.train", *DRILL_ARGS, "--ckpt-dir",
                            str(dirs["clean"]))
    kept = sorted(p.name for p in dirs["drill"].iterdir())
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    gap = abs(drill[-1]["loss"] - clean[-1]["loss"])
    rec = {"phase": "train", "module": "launch.train", "run": "fault drill",
           "drill": drill, "clean_final": clean[-1], "loss_gap_step_30": gap,
           "checkpoints_kept": kept, "failed": []}
    if not (drill[-1]["step"] == clean[-1]["step"] == 30 and gap < 1e-4):
        rec["failed"].append("fault drill step-30 loss")
    if [list(r) for r in drill] != [["step", "loss", "sec"]] * len(drill):
        rec["failed"].append("launcher JSON keys")
    recs.append(rec)
    emit(rec)
    full = _launcher_lines("repro_torch.launch.train", "--arch", "qwen2-1.5b", "--steps",
                           str(LAUNCH_TRAIN_STEPS), "--log-every", "1")
    secs = [r["sec"] for r in full[-10:]]
    rec = {"phase": "train", "module": "launch.train", "run": "qwen2-1.5b published",
           "card": smi, "steps": len(full), "losses": [r["loss"] for r in full],
           "median_step_s_last_10": statistics.median(secs),
           "tok_per_s": TRAIN_BATCH * TRAIN_SEQ / statistics.median(secs),
           "checkpoint_save_s": "not measured (no --ckpt-dir: ~25 GB a save)", "failed": []}
    if len(full) != LAUNCH_TRAIN_STEPS or not all(math.isfinite(r["loss"]) for r in full):
        rec["failed"].append("launcher run")
    recs.append(rec)
    emit(rec)
    return recs


def phase_train(smi: str) -> list[dict]:
    """The ten reduced architectures' train step on the card against the
    CPU, qwen2-1.5b trained at its published config, and the launcher."""
    from repro_torch.configs.base import ARCH_IDS

    recs = []
    for arch in ARCH_IDS:
        recs.append(_train_reduced(arch))
        emit(recs[-1])
    recs.append(_train_full(smi))
    emit(recs[-1])
    recs += _train_launcher(smi)
    bad = {(r.get("arch") or r.get("run")) + " " + r.get("config", ""): r["failed"]
           for r in recs if r["failed"]}
    if bad:
        fail(f"phase train: {bad}")
    return recs


def _launcher_stdout(module: str, *args: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run(
        [sys.executable, "-m", module, *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        fail(f"{module} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    return proc.stdout


def _run_launcher(module: str, *args: str, whole: bool = False) -> dict:
    """Run ``python -m module args`` on the card; its last stdout line (its
    whole stdout with ``whole``: krr_serve prints indented JSON)."""
    out = _launcher_stdout(module, *args)
    return json.loads(out if whole else out.strip().splitlines()[-1])


def phase_launch() -> dict:
    from repro_torch.obs import validate_jsonl

    OUT_DIR.mkdir(exist_ok=True)
    solve_tel, tune_tel = OUT_DIR / "launch_solve.jsonl", OUT_DIR / "launch_tune.jsonl"
    serve_tel, artifact = OUT_DIR / "launch_serve.jsonl", OUT_DIR / "launch_artifact"
    for p in (solve_tel, tune_tel, serve_tel):
        p.unlink(missing_ok=True)
    report = _run_launcher("repro_torch.launch.krr_solve", "--method", "askotch", "--iters", "50",
                           "--telemetry", str(solve_tel))
    emit({"phase": "launch", "report": report, "telemetry": validate_jsonl(str(solve_tel))})
    if list(report) != LAUNCHER_KEYS + ["telemetry"]:
        fail(f"launcher keys {list(report)} != the JAX launcher's {LAUNCHER_KEYS} + telemetry")
    if not (math.isfinite(report["rel_residual"]) and report["rel_residual"] < 1.0):
        fail(f"launcher rel_residual {report['rel_residual']}")
    tune_report = _run_launcher(
        "repro_torch.launch.krr_tune", "--kernels", ",".join(MK_KERNELS),
        "--n-weight-samples", str(M_WEIGHTS), "--n", "4000", "--iters", "100",
        "--refit-iters", "100", "--telemetry", str(tune_tel), "--export-artifact", str(artifact))
    tune_counts = validate_jsonl(str(tune_tel))
    emit({"phase": "launch", "module": "krr_tune", "telemetry": tune_counts,
          "report": {k: v for k, v in tune_report.items() if k not in ("records", "trace")}})
    if list(tune_report) != TUNE_LAUNCHER_KEYS + ["telemetry"]:
        fail(f"krr_tune keys {list(tune_report)} != the JAX launcher's {TUNE_LAUNCHER_KEYS} "
             "+ telemetry")
    if not (tune_counts.get("span", 0) >= 3 and tune_counts.get("trace", 0) >= 1):
        fail(f"krr_tune --telemetry wrote {tune_counts}")
    if not math.isfinite(tune_report["refit"]["test_rmse"]):
        fail(f"krr_tune refit test_rmse {tune_report['refit']['test_rmse']}")
    # the exported artifact through the serving launcher, with Poisson traffic
    serve = _run_launcher("repro_torch.launch.krr_serve", "--artifact", f"demo={artifact}",
                          "--requests", "200", "--rate", "500", "--prometheus",
                          "--telemetry", str(serve_tel), whole=True)
    serve_counts = validate_jsonl(str(serve_tel))
    model = serve["stats"]["models"]["demo"]
    emit({"phase": "launch", "module": "krr_serve", "telemetry": serve_counts,
          "report": {k: v for k, v in serve.items() if k != "prometheus"}})
    keys = {"report": (list(serve), SERVE_LAUNCHER_KEYS),
            "loaded": (list(serve["loaded"]["demo"]), SERVE_LOADED_KEYS),
            "stats": (list(serve["stats"]), SERVE_STATS_KEYS),
            "model stats": (list(model), SERVE_MODEL_KEYS)}
    for what, (got, want) in keys.items():
        if got != want:
            fail(f"krr_serve {what} keys {got} != the JAX launcher's {want}")
    if model["n_requests"] != 200 or not serve_counts.get("span", 0) >= 1:
        fail(f"krr_serve served {model['n_requests']} of 200 requests, telemetry {serve_counts}")
    # the LM serving launcher at qwen2-1.5b's published config, its defaults
    lm = _run_launcher("repro_torch.launch.serve", "--arch", "qwen2-1.5b")
    emit({"phase": "launch", "module": "serve", "report": lm})
    if list(lm) != LM_LAUNCHER_KEYS:
        fail(f"serve keys {list(lm)} != the JAX launcher's {LM_LAUNCHER_KEYS}")
    if lm["generated_shape"] != [LM_BATCH, LM_NEW] or lm["tokens"] != LM_BATCH * LM_NEW:
        fail(f"serve generated {lm['generated_shape']}")
    return report


DRYRUN_TRAIN = ("train_smoke", "train", TRAIN_SEQ, TRAIN_BATCH)  # phase train's shape
DRYRUN_DECODE = ("decode_lm", "decode", LM_PROMPT + LM_NEW, LM_BATCH)  # phase lm's
DRYRUN_CLI_CELLS = 10  # the KRR cell x 2 meshes + qwen2-1.5b x 4 shapes x 2 meshes


def _tree_bytes(*trees) -> int:
    """Bytes of every tensor in nested dicts, tuples and lists."""
    total = 0
    for tree in trees:
        if isinstance(tree, dict):
            total += _tree_bytes(*tree.values())
        elif isinstance(tree, (tuple, list)):
            total += _tree_bytes(*tree)
        elif hasattr(tree, "element_size"):
            total += tree.numel() * tree.element_size()
    return total


def _against_prediction(what: str, pred: dict, args, fn, smi: str) -> dict:
    """A real step on the card against the dry run's prediction ``pred``
    (one cell's record at (1, 1)): argument bytes equal, ms at or above the
    roofline floor, the peak recorded.  ``args`` are the step's arguments."""
    import torch

    from repro_torch.launch import dryrun

    real_args = _tree_bytes(args)
    fn()  # warm-up
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    real_peak = real_args + torch.cuda.max_memory_allocated() - before
    ms = _time_ms(fn)
    mem = pred["memory"]
    floor_ms = 1e3 * dryrun.floor_s(pred)
    rec = {"phase": "dryrun", "cell": what, "card": smi,
           "predicted_argument_bytes": mem["argument_bytes"], "argument_bytes": real_args,
           "ms": ms, "floor_ms": floor_ms, "over_floor": ms / floor_ms,
           "predicted_peak_bytes": mem["argument_bytes"] + mem["temp_bytes"],
           "peak_bytes": real_peak, "cost": pred.get("cost_extrapolated") or pred["cost_raw"],
           "compute_dtype": pred["compute_dtype"], "failed": []}
    if mem["argument_bytes"] != real_args:
        rec["failed"].append("predicted argument bytes != the real step's")
    if not ms >= floor_ms:
        rec["failed"].append("real step below the dry run's floor: the count is wrong")
    emit(rec)
    return rec


def phase_dryrun(smi: str) -> list[dict]:
    import contextlib
    import dataclasses
    import shutil

    import torch

    from repro_torch.configs import askotch_krr
    from repro_torch.configs.base import get_config
    from repro_torch.data import synthetic
    from repro_torch.distributed.krr_dist import DistState, make_dist_askotch_step
    from repro_torch.distributed.meshes import AbstractMesh, SolverMesh
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.models.model_api import ShapeConfig, get_model, init_params
    from repro_torch.roofline import report
    from repro_torch.training.train_step import make_train_step

    recs = []
    # (a) the KRR cell at phase dist's (1, 1) size
    dcfg = dryrun.krr_dist_config(dataclasses.replace(askotch_krr.config(), n=N_TRAIN,
                                                      block_size=BLOCK, rank=RANK))
    pred = dryrun.krr_cell(dcfg, SolverMesh(["meta"], shape=(1, 1)))
    x, y = taxi_data()
    x, y = x[:N_TRAIN], y[:N_TRAIN]
    dev = x.device
    g = torch.Generator(device=dev).manual_seed(0)
    state = DistState(
        w=torch.zeros(N_TRAIN, device=dev), v=torch.zeros(N_TRAIN, device=dev),
        z=torch.zeros(N_TRAIN, device=dev),
        generator=torch.empty(2, dtype=torch.uint32, device=dev),  # the key's slot
        sketch_res=torch.zeros((), device=dev), pv=torch.randn(BLOCK, device=dev, generator=g))
    draws = dict(idx=torch.randint(0, N_TRAIN, (BLOCK,), device=dev, generator=g),
                 omega=torch.randn((BLOCK, RANK), device=dev, generator=g),
                 probe=torch.randn((BLOCK,), device=dev, generator=g))
    step = make_dist_askotch_step(SolverMesh(["cuda:0"], shape=(1, 1)), dcfg)
    ops.reset_launches()
    rec = _against_prediction("askotch-krr (1, 1), n 1e6", pred, (state, x, y),
                lambda: step(state, x, y, **draws), smi)
    rec["launches"] = ops.launches()
    rec["meta_kernel_calls"] = pred["kernel_calls"]
    if set(pred["kernel_calls"]) - {k for k, v in rec["launches"].items() if v}:
        rec["failed"].append("a kernel the trace calls never launched on the card")
    recs.append(rec)
    del state, draws

    # (b) qwen2-1.5b: the train step at phase train's shape, decode at phase lm's
    cfg, mesh11 = get_config("qwen2-1.5b"), AbstractMesh(("data", "model"), (1, 1))
    impl = get_model(cfg)
    torch.cuda.empty_cache()
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    shape = ShapeConfig(*DRYRUN_TRAIN)
    opt = dryrun._optimizer(cfg)
    opt_state = opt.init(params)
    batch = synthetic.batch_for(cfg, (shape.global_batch, shape.seq_len), 0, 0, device="cuda")
    step_t = torch.zeros((), dtype=torch.int32, device="cuda")
    train = make_train_step(cfg, opt)
    recs.append(_against_prediction(f"qwen2-1.5b train {shape.global_batch} x {shape.seq_len}",
                      dryrun.lm_cell(cfg, shape, mesh11), (params, opt_state, batch, step_t),
                      lambda: train(params, opt_state, batch, step_t), smi))
    del opt_state, batch
    torch.cuda.empty_cache()
    shape = ShapeConfig(*DRYRUN_DECODE)
    cache = impl.init_cache(cfg, shape.global_batch, shape.seq_len, device="cuda")
    batch = {"tokens": torch.zeros((shape.global_batch, 1), dtype=torch.int32, device="cuda")}
    recs.append(_against_prediction(f"qwen2-1.5b decode {shape.global_batch} x {shape.seq_len}",
                      dryrun.lm_cell(cfg, shape, mesh11), (params, cache, batch),
                      lambda: impl.decode_step(params, cache, batch, cfg), smi))
    del params, cache
    torch.cuda.empty_cache()

    # (c) the CLI: the KRR cell on both production meshes, qwen2-1.5b's four shapes
    out = OUT_DIR / "dryrun"
    shutil.rmtree(out, ignore_errors=True)
    OUT_DIR.mkdir(exist_ok=True)
    ops.reset_launches()
    t0 = time.perf_counter()
    with open(OUT_DIR / "dryrun_cli.log", "w") as log, contextlib.redirect_stdout(log):
        dryrun.main(["--arch", f"{dryrun.KRR_ARCH},qwen2-1.5b", "--shape", "all",
                     "--mesh", "both", "--out", str(out)])
    seconds = time.perf_counter() - t0
    cells = report.load(str(out))
    tables = "\n\n".join([report.dryrun_table(cells, "single"),
                          report.dryrun_table(cells, "multi"), report.roofline_table(cells)])
    (OUT_DIR / "dryrun_report.md").write_text(tables + "\n")
    status = {f"{r['arch']} {r['shape']} {r['mesh']}": r["status"] for r in cells}
    rec = {"phase": "dryrun", "cell": "cli", "seconds": seconds, "status": status,
           "launches": ops.launches(), "cells": [
               {k: r.get(k) for k in ("arch", "shape", "mesh", "memory", "cost_extrapolated",
                                      "seconds")} for r in cells if r["status"] == "ok"],
           "failed": []}
    want = {f"{a} {s} {m}": ("skipped" if s == "long_500k" else "ok")
            for a, shapes in ((dryrun.KRR_ARCH, ("krr_step",)),
                              ("qwen2-1.5b", ("train_4k", "prefill_32k", "decode_32k",
                                              "long_500k")))
            for s in shapes for m in ("single", "multi")}
    if len(cells) != DRYRUN_CLI_CELLS or status != want:
        rec["failed"].append(f"cells {status} != {want}")
    if any(rec["launches"].values()):
        rec["failed"].append("a meta trace launched a kernel")
    emit(rec)
    recs.append(rec)
    bad = [f"{r['cell']}: {f}" for r in recs for f in r["failed"]]
    if bad:
        fail(f"dryrun: {bad}")
    return recs


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
    phase_check_multi()
    phase_check_split()
    phase_check_determinism()
    solve_rec, solve_w = phase_solve()
    phase_telemetry(solve_rec)
    tune_rec, tune_result = phase_tune()
    refit_rec, refit_w = phase_refit(tune_result.best)
    baseline_recs = phase_baselines()
    est_rec = phase_estimators(solve_rec, solve_w, tune_result)
    sap_recs = phase_sap()
    ova_launches = phase_ova(tune_result.best)
    serve_recs = phase_serve(solve_w, tune_result.best, refit_w)
    dist_launches = phase_dist(solve_rec, solve_w)
    del solve_w, refit_w
    # each path's launch counts, from its own reset and read
    launches = {"solve": solve_rec["launches"], "tune": tune_rec["launches"],
                "refit": refit_rec["launches"],
                "estimators tune": est_rec["tune"]["launches"],
                **{f"serve {k}": r["launches"] for k, r in zip(
                    ("taxi", "multikernel", "heads", "multikernel heads"), serve_recs)},
                **ova_launches,
                **dist_launches, **{f"sap {r['method']}": r["launches"] for r in sap_recs}}
    rows = phase_time(launches, tuple(tune_result.best["weights"]),
                      _tune_weight_cols(tune_result), baseline_recs)
    phase_lm(smi)
    phase_train(smi)
    phase_launch()
    phase_dryrun(smi)
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": [{k: r[k] for k in (
        "name", "case", "route", "source", "replaces", "launches", "max_abs_err", "ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms", "write_floor_ms") if k in r}
        for r in rows]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
