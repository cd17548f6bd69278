"""Carry a solved or tuned problem of the JAX package across to the port.

The reference hands over numpy arrays (``np.asarray(out.w)``) and plain
dicts (``TuneResult.best``); these helpers put them on a device as the
port's containers, so both packages predict, report residuals and refit
from the same weights and the same tuned model.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.askotch import SolverState
from repro_torch.core.krr import KRRProblem
from repro_torch.device import resolve_device


def _tensor(a, dev: torch.device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), device=dev)  # a copy: JAX arrays are read-only


def _sigma(sigma):
    """One bandwidth as a float, or per-kernel bandwidths as a tuple of floats
    (``KRRProblem`` makes kernel lists tuples and weights floats itself)."""
    return tuple(float(s) for s in sigma) if isinstance(sigma, (list, tuple)) else float(sigma)


def from_reference(x, y, w, *, kernel="rbf", sigma=1.0, weights=None,
                   lam_unscaled: float = 1e-6, precision: str = "f32",
                   device="cuda") -> tuple[KRRProblem, torch.Tensor]:
    """The port's :class:`KRRProblem` over the reference's (x, y) and its
    solved weights ``w`` as a tensor, both on ``device``.  ``kernel`` may be
    a tuple of names (a weighted-sum problem) with per-kernel ``sigma`` and
    combination ``weights``."""
    dev = resolve_device(device)
    problem = KRRProblem(
        x=_tensor(x, dev), y=_tensor(y, dev), kernel=kernel, sigma=_sigma(sigma),
        weights=weights, lam_unscaled=float(lam_unscaled), precision=precision,
    )
    return problem, _tensor(w, dev)


def problem_from_best(x, y, best: dict, *, device="cuda") -> KRRProblem:
    """The port's :class:`KRRProblem` for a tuned model: the reference's
    ``TuneResult.best`` dict (kernel or kernel list, sigma or per-kernel
    sigmas, ``weights`` for a multi-kernel search, ``lam_unscaled``,
    ``precision``) over (x, y) on ``device``."""
    dev = resolve_device(device)
    return KRRProblem(
        x=_tensor(x, dev), y=_tensor(y, dev), kernel=best["kernel"], sigma=_sigma(best["sigma"]),
        weights=best.get("weights"), lam_unscaled=float(best["lam_unscaled"]),
        precision=best.get("precision", "f32"),
    )


def state_from_reference(w, v, z, it, *, seed: int = 0, device="cuda") -> SolverState:
    """A port :class:`SolverState` from a reference ``SolverState``'s
    (w, v, z, it) arrays; the port's draws come from a fresh generator
    seeded with ``seed`` (JAX keys do not carry across)."""
    dev = resolve_device(device)
    w_t = _tensor(w, dev)
    return SolverState(
        w=w_t, v=_tensor(v, dev), z=_tensor(z, dev),
        generator=torch.Generator(device=dev).manual_seed(seed),
        it=int(np.asarray(it)),
        sketch_res=torch.full(() if w_t.ndim == 1 else (w_t.shape[1],), float("inf"),
                              dtype=torch.float32, device=dev),
    )
