"""Distributed KRR solvers — the paper's methods over a solver mesh, built
from :class:`~repro_torch.distributed.sharded_operator.
ShardedKernelOperator` composites; the port of ``repro.distributed.krr_dist``.

Two solve paths share the operator layer and the mesh:

  * **ASkotch** (``make_dist_askotch_step`` / ``solve_askotch_dist``) — one
    mapped body per iteration built from operator composites: the packed-
    psum block gather, the distributed Nystrom, Woodbury applies, powering.
  * **PCG** (``solve_pcg_dist``) — the blocked multi-RHS CG loop
    (``core/blocked_cg.py``) driven by the operator's distributed
    ``k_lam_matvec``; the Nystrom preconditioner's sketch is one distributed
    ``op.sketch`` pass.

Both are multi-RHS: a (n, t) Y gives a row-sharded (n, t) W.  Rows of X / Y
/ iterates shard over "data"; block rows also shard over "model".

Per iteration, the collectives of the ASkotch body: one packed psum over
rows (x_B | y_B | z_B), two r x r psums over "model" (Nystrom), per
powering iteration one all_gather and one packed psum over "model", one
psum over rows (the G_B partials) and one all_gather over "model" of the
packed [D_B | G_B].  A size-1 axis issues none of them.

Blocks are drawn i.i.d. uniform WITH replacement (Def. 9), as the reference
does, unlike the single-device sampler.  The replicated draws come from one
``torch.Generator`` per solve on the mesh's home device, in the reference's
order (block indices, the Nystrom test matrix, the powering probe); the
step also takes each of them injected.  Iterates are held as global views
on the home device (``sharded_operator``'s layout); the scatter of the
block update adds each shard's owned rows with ``index_put(...,
accumulate=True)``, which sums repeated indices in a fixed order.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.blocked_cg import blocked_cg
from repro_torch.core.kernels import KERNEL_NAMES
from repro_torch.core.krr import KRRProblem, residual_report, scaled_lam
from repro_torch.core.nystrom import nystrom_from_sketch
from repro_torch.core.operator import as_multirhs, maybe_squeeze
from repro_torch.device import resolve_device
from repro_torch.distributed.meshes import SolverMesh
from repro_torch.distributed.sharded_operator import (
    ShardedKernelOperator,
    join_rows,
    split_rows,
)
from repro_torch.kernels.precision import PRECISIONS


class DistState(NamedTuple):
    w: torch.Tensor  # (n,) or (n, t) row-sharded (global view on the home device)
    v: torch.Tensor
    z: torch.Tensor
    generator: torch.Generator  # the replicated draws, on the home device
    sketch_res: torch.Tensor
    pv: torch.Tensor  # (b,) replicated: warm-start vector for the powering


@dataclasses.dataclass(frozen=True)
class DistKRRConfig:
    n: int
    d: int
    kernel: str | tuple[str, ...] = "rbf"
    sigma: float | tuple[float, ...] = 1.0
    weights: tuple[float, ...] | None = None  # multi-kernel combination
    lam_unscaled: float = 2e-7
    block_size: int = 50_000
    rank: int = 100
    heads: int = 1  # t right-hand sides (one-vs-all); 1 -> 1-D iterates
    accelerated: bool = True
    mu: float | None = None
    nu: float | None = None
    powering_iters: int = 10
    powering_warm_start: bool = False  # start the powering from the previous
    #   block's eigenvector and run powering_warm_iters instead
    powering_warm_iters: int = 3
    precision: str = "f32"  # kernel tile-compute policy: "f32" | "bf16"

    def __post_init__(self) -> None:
        for field, minimum in (("n", 1), ("d", 1), ("block_size", 1),
                               ("rank", 1), ("heads", 1),
                               ("powering_iters", 1), ("powering_warm_iters", 1)):
            v = getattr(self, field)
            if not isinstance(v, int) or v < minimum:
                raise ValueError(
                    f"DistKRRConfig.{field} = {v!r} invalid; accepted: "
                    f"integers >= {minimum}"
                )
        if isinstance(self.kernel, tuple):
            from repro_torch.core.multikernel import canonical_kernels

            canonical_kernels(self.kernel, self.sigma, self.weights)
        elif self.kernel not in KERNEL_NAMES:
            raise ValueError(
                f"DistKRRConfig.kernel = {self.kernel!r} invalid; accepted: "
                f"{KERNEL_NAMES} or a tuple of them"
            )
        if self.precision not in PRECISIONS:
            raise ValueError(
                f"DistKRRConfig.precision = {self.precision!r} invalid; "
                f"accepted: {PRECISIONS}"
            )
        sig = self.sigma if isinstance(self.sigma, tuple) else (self.sigma,)
        if not all(s > 0 for s in sig):
            raise ValueError(
                f"DistKRRConfig.sigma = {self.sigma!r} invalid; accepted: "
                f"positive floats (or a per-kernel tuple of them)"
            )
        if not self.lam_unscaled > 0:
            raise ValueError(
                f"DistKRRConfig.lam_unscaled = {self.lam_unscaled!r} invalid; "
                f"accepted: positive floats"
            )
        if self.rank > self.block_size:
            raise ValueError(
                f"DistKRRConfig.rank = {self.rank} invalid; accepted: "
                f"rank <= block_size (= {self.block_size})"
            )
        for field in ("mu", "nu"):
            v = getattr(self, field)
            if v is not None and not v > 0:
                raise ValueError(
                    f"DistKRRConfig.{field} = {v!r} invalid; accepted: "
                    f"None or positive floats"
                )

    @property
    def lam(self) -> float:
        return scaled_lam(self.n, self.lam_unscaled)


def _operator_for(mesh: SolverMesh, cfg: DistKRRConfig) -> ShardedKernelOperator:
    """Unbound operator carrying (mesh, kernel config) for the step body."""
    return ShardedKernelOperator(
        mesh=mesh, kernel=cfg.kernel, sigma=cfg.sigma, weights=cfg.weights,
        precision=cfg.precision,
    )


def make_dist_askotch_step(mesh: SolverMesh, cfg: DistKRRConfig):
    """The distributed (A)Skotch step for ``cfg`` on ``mesh``.

    ``step(state, x, y, *, idx=None, omega=None, probe=None) -> state``.
    ``x``: the row shards of a bound operator (``op.x_shards``) or the
    (n, d) tensor; ``y``: (n,) when cfg.heads == 1, else (n, t).  The block
    indices (b,), the raw Gaussian Nystrom test matrix (b, r) and the raw
    powering probe (b,) may be injected; each one not given is drawn, in
    that order, from ``state.generator`` (the probe only without
    ``powering_warm_start``).
    """
    op = _operator_for(mesh, cfg)
    rows = op.rows
    n, b, r, t = cfg.n, cfg.block_size, cfg.rank, cfg.heads
    lam = float(np.float32(cfg.lam))  # the f32 value JAX uses
    if n % op.n_row_shards:
        raise ValueError(
            f"n = {n} does not shard over {op.n_row_shards} row shard(s) of "
            f"mesh axes {rows}; accepted: n divisible by the row-axis product"
        )
    if b % op.n_model:
        raise ValueError(
            f"block_size = {b} does not shard over {op.n_model} model "
            f"shard(s); accepted: multiples of {op.n_model}"
        )
    n_loc = n // op.n_row_shards
    home = mesh.home

    if cfg.accelerated:
        nu = cfg.nu if cfg.nu is not None else n / b
        mu = cfg.mu if cfg.mu is not None else min(lam, nu, 1.0 / nu)
        beta = 1.0 - (mu / nu) ** 0.5
        gamma = 1.0 / (mu * nu) ** 0.5
        alpha = 1.0 / (1.0 + gamma * nu)

    def as2d(a):
        return a if t > 1 else a[:, None]

    def like_y(a):
        return a if t > 1 else a[:, 0]

    def step(state: DistState, x, y, *, idx=None, omega=None, probe=None) -> DistState:
        g = state.generator
        if idx is None:
            idx = torch.randint(0, n, (b,), generator=g, device=home)
        if omega is None:
            omega = torch.randn((b, r), generator=g, dtype=torch.float32, device=home)
        if cfg.powering_warm_start:
            v0, n_power = state.pv, cfg.powering_warm_iters
        else:
            if probe is None:
                probe = torch.randn((b,), generator=g, dtype=torch.float32, device=home)
            v0, n_power = probe, cfg.powering_iters
        x_l = x if isinstance(x, dict) else split_rows(mesh, x.to(home), n_loc)
        zref = state.z if cfg.accelerated else state.w

        # -- gather x_B, y_B, z_B from the row shards (ONE packed psum) -----
        (xb, yb, zb), owned, local_pos = op.shard_gather_rows(
            x_l, mesh.replicate(idx.to(home, torch.int64)),
            (split_rows(mesh, y, n_loc), split_rows(mesh, zref, n_loc)))
        yb_l = op.shard_block_slice({c: as2d(a) for c, a in yb.items()})
        zb_l = op.shard_block_slice({c: as2d(a) for c, a in zb.items()})

        # -- distributed Nystrom of K_BB (U rows over "model") ---------------
        u_l, lam_ny = op.shard_block_nystrom(xb, r, omega.to(home))
        rho = {c: lam + a[-1] for c, a in lam_ny.items()}  # damped (paper default)

        # -- get_L: randomized powering (Algorithm 5) ------------------------
        pv, step_l = op.shard_block_powering(
            xb, u_l, lam_ny, rho, lam, mesh.replicate(v0.to(home)), n_power)
        eta = {c: 1.0 / torch.clamp_min(s, 1.0) for c, s in step_l.items()}

        # -- the O(nbt) kernel matvec: G_B = (K_lam)_{B,:} Z - Y_B ----------
        xb_l = op.shard_block_slice(xb)
        part = op.shard_row_block_matvec(x_l, xb_l, split_rows(mesh, zref, n_loc))
        g_l = {c: as2d(part[c]) + lam * zb_l[c] - yb_l[c] for c in part}
        d_l = op.shard_woodbury_apply(u_l, lam_ny, rho, g_l)
        # packed gather: [D | G] in one collective, residual norm locally
        dg = op.model_all_gather({c: torch.cat([d_l[c], g_l[c]], dim=1) for c in d_l})

        # -- scatter the updates on each shard's owned rows -------------------
        new_w, new_v, new_z = {}, {}, {}
        for i in range(op.n_row_shards):
            c = (i, 0)
            upd = like_y(torch.where(owned[c][:, None] > 0, -eta[c] * dg[c][:, :t], 0.0))
            pos = (local_pos[c],)
            if cfg.accelerated:
                z_i = state.z[i * n_loc:(i + 1) * n_loc].to(mesh.device(c))
                v_i = state.v[i * n_loc:(i + 1) * n_loc].to(mesh.device(c))
                new_w[c] = z_i.index_put(pos, upd, accumulate=True)
                new_v[c] = (beta * v_i + (1.0 - beta) * z_i).index_put(
                    pos, gamma * upd, accumulate=True)
                new_z[c] = alpha * new_v[c] + (1.0 - alpha) * new_w[c]
            else:
                w_i = state.w[i * n_loc:(i + 1) * n_loc].to(mesh.device(c))
                new_w[c] = new_v[c] = new_z[c] = w_i.index_put(pos, upd, accumulate=True)
        w_new = join_rows(mesh, new_w)
        v_new, z_new = (w_new, w_new) if not cfg.accelerated else (
            join_rows(mesh, new_v), join_rows(mesh, new_z))
        return DistState(
            w=w_new, v=v_new, z=z_new, generator=g,
            sketch_res=torch.linalg.vector_norm(dg[(0, 0)][:, t:]).to(home),
            pv=pv[(0, 0)].to(home),
        )

    return step


def init_dist_state(cfg: DistKRRConfig, seed: int = 0, *, device="cuda") -> DistState:
    """Zero iterates on ``device`` (the mesh's home device), the step's
    generator seeded with ``seed`` and the powering's warm-start vector
    drawn from a generator seeded with ``seed + 7``."""
    dev = resolve_device(device)
    shape = (cfg.n,) if cfg.heads == 1 else (cfg.n, cfg.heads)
    z = torch.zeros(shape, dtype=torch.float32, device=dev)
    pv = torch.randn((cfg.block_size,), dtype=torch.float32, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(seed + 7))
    return DistState(
        w=z, v=z, z=z, generator=torch.Generator(device=dev).manual_seed(seed),
        sketch_res=torch.full((), float("inf"), dtype=torch.float32, device=dev), pv=pv,
    )


def abstract_dist_inputs(cfg: DistKRRConfig):
    """Meta tensors of the step's inputs (shapes and dtypes, no
    allocation): ``(state, x, y)`` in the reference's shapes and dtypes.
    The generator's slot holds the reference's PRNG key, a (2,) uint32, so
    the state's bytes are the reference's; a step on these inputs takes its
    draws injected, since nothing draws on meta."""
    shape = (cfg.n,) if cfg.heads == 1 else (cfg.n, cfg.heads)

    def meta(*dims, dtype=torch.float32):
        return torch.empty(dims, dtype=dtype, device="meta")

    state = DistState(
        w=meta(*shape), v=meta(*shape), z=meta(*shape),
        generator=meta(2, dtype=torch.uint32),
        sketch_res=meta(), pv=meta(cfg.block_size),
    )
    return state, meta(cfg.n, cfg.d), meta(*shape)


# ---------------------------------------------------------------------------
# the solve loops (the mesh= path behind core.solver_api.solve)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DistSolveResult:
    w: torch.Tensor  # (n,) or (n, t): global view on the mesh's home device
    iters: int
    history: list[dict]
    converged: bool
    wall_time_s: float
    op: ShardedKernelOperator  # bound operator: serving / predict reuse it


def _bind(problem: KRRProblem, mesh: SolverMesh) -> ShardedKernelOperator:
    return ShardedKernelOperator.bind(
        mesh, problem.x, kernel=problem.kernel, sigma=problem.sigma,
        weights=problem.weights, precision=problem.precision,
    )


def solve_askotch_dist(
    problem: KRRProblem,
    mesh: SolverMesh,
    *,
    accelerated: bool = True,
    block_size: int | None = None,
    rank: int = 100,
    mu: float | None = None,
    nu: float | None = None,
    powering_iters: int = 10,
    max_iters: int = 500,
    tol: float = 1e-8,
    eval_every: int = 25,
    seed: int = 0,
    time_budget_s: float | None = None,
) -> DistSolveResult:
    """Mesh-distributed (A)Skotch with the loop contract of
    ``core.askotch.solve``: steps + a full residual every ``eval_every``
    iterations (the host reads device values only there), multi-RHS
    throughout.  W stays row-sharded; predictions go through the returned
    bound operator."""
    t0 = time.perf_counter()
    op0 = ShardedKernelOperator(mesh=mesh)
    b = block_size if block_size is not None else max(problem.n // 100, 1)
    b = int(min(max(b, rank + 8), problem.n))
    b += (-b) % op0.n_model  # round up so block rows shard over "model"
    cfg = DistKRRConfig(
        n=problem.n, d=problem.x.shape[1], kernel=problem.kernel,
        sigma=problem.sigma, weights=problem.weights,
        lam_unscaled=problem.lam_unscaled,
        block_size=b, rank=min(rank, b), heads=problem.t,
        accelerated=accelerated, mu=mu, nu=nu, powering_iters=powering_iters,
        precision=problem.precision,
    )
    step = make_dist_askotch_step(mesh, cfg)
    bound = _bind(problem, mesh)
    # the step's iterates follow cfg.heads: a (n, 1) y is the t = 1 case and
    # solves as 1-D (the column is restored on the way out)
    column = problem.y.ndim == 2 and problem.t == 1
    y = (problem.y[:, 0] if column else problem.y).to(mesh.home)
    state = init_dist_state(cfg, seed, device=mesh.home)

    history: list[dict] = []
    converged = False
    it = 0
    for it in range(1, max_iters + 1):
        state = step(state, bound.x_shards, y)
        if it % eval_every == 0 or it == max_iters:
            rel_agg, rel_heads = residual_report(bound, y, cfg.lam, state.w)
            heads = rel_heads.tolist()
            history.append({
                "iter": it,
                "rel_residual": float(rel_agg),
                "rel_residual_per_head": heads,
                "sketch_res": float(state.sketch_res),
                "time_s": time.perf_counter() - t0,
            })
            if all(h < tol for h in heads):
                converged = True
                break
        if time_budget_s is not None and time.perf_counter() - t0 > time_budget_s:
            break
    w = state.w[:, None] if column else state.w
    return DistSolveResult(
        w=w, iters=it, history=history, converged=converged,
        wall_time_s=time.perf_counter() - t0, op=bound,
    )


def solve_pcg_dist(
    problem: KRRProblem,
    mesh: SolverMesh,
    *,
    precond: str = "nystrom",
    rank: int = 100,
    rho_mode: str = "damped",
    max_iters: int = 200,
    tol: float = 1e-8,
    seed: int = 0,
    time_budget_s: float | None = None,
) -> DistSolveResult:
    """Mesh-distributed blocked PCG on (K + lam I) W = Y.

    The iteration is the ``core.blocked_cg`` loop every single-device
    CG-family solver uses; the distributed pieces are the operator's
    ``k_lam_matvec`` and the one ``op.sketch`` pass that builds the Nystrom
    preconditioner (its (n, r) Gaussian drawn from a generator seeded with
    ``seed`` on the home device).
    """
    t0 = time.perf_counter()
    if precond not in ("nystrom", "identity"):
        raise ValueError(
            f"unknown distributed preconditioner {precond!r}; accepted: "
            f"('nystrom', 'identity')"
        )
    lam = float(np.float32(problem.lam))
    bound = _bind(problem, mesh)
    y2, squeeze = as_multirhs(problem.y.to(mesh.home))

    pinv = None
    if precond == "nystrom":
        r = min(rank, problem.n)
        gen = torch.Generator(device=mesh.home).manual_seed(seed)
        omega = torch.randn((problem.n, r), generator=gen, dtype=torch.float32,
                            device=mesh.home)
        omega, _ = torch.linalg.qr(omega)
        f = nystrom_from_sketch(bound.sketch(omega), omega, bound.trace_est())
        rho = lam + f.lam[-1] if rho_mode == "damped" else lam
        coeff = (f.lam[-1] + rho) / (f.lam + rho)

        def pinv(v: torch.Tensor) -> torch.Tensor:
            utv = f.u.T @ v
            return f.u @ (utv * coeff[:, None]) + (v - f.u @ utv)

    res = blocked_cg(
        lambda v: bound.k_lam_matvec(v, lam), y2, pinv, max_iters=max_iters, tol=tol,
        t0=t0, time_budget_s=time_budget_s,
    )
    return DistSolveResult(
        w=maybe_squeeze(res.x, squeeze), iters=res.iters, history=res.history,
        converged=res.converged, wall_time_s=time.perf_counter() - t0, op=bound,
    )
