"""Randomized Nystrom approximation (paper Algorithm 4, App. A.1) and the
Woodbury solves used to apply it (Eqs. (15)/(16), App. A.1.1).

The port of ``repro.core.nystrom``.  Factors (U, lam) satisfy
K_hat = U diag(lam) U^T; the approximation is never formed.

Cholesky failure: ``jnp.linalg.cholesky`` returns NaN where
``torch.linalg.cholesky`` raises.  The port uses ``cholesky_ex`` and keeps
JAX's meaning without a host sync: :func:`nystrom_from_sketch` selects the
jittered retry where ``info != 0``, and :func:`stable_inv_apply_setup` (no
retry in JAX) yields a NaN factor on failure instead of raising mid-solve.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class NystromFactors(NamedTuple):
    u: torch.Tensor  # (p, r) approximate top-r eigenvectors
    lam: torch.Tensor  # (r,) approximate top-r eigenvalues (>= 0, descending)


def _eps(x: torch.Tensor) -> float:
    return torch.finfo(x.dtype).eps


def cholesky_or_nan(m: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of ``m``, all-NaN where the factorization
    fails (JAX's convention) — decided on the device."""
    chol, info = torch.linalg.cholesky_ex(m)
    return torch.where(info == 0, chol, torch.full_like(chol, float("nan")))


def nystrom_from_sketch(
    y: torch.Tensor, omega: torch.Tensor, trace_hint: torch.Tensor
) -> NystromFactors:
    """Algorithm 4 given a precomputed sketch y = M @ omega (omega orthonormal)."""
    shift = _eps(y) * trace_hint
    y_shift = y + shift * omega
    gram = omega.T @ y_shift
    gram = 0.5 * (gram + gram.T)
    # escalating jitter where the plain factorization fails; both run, the
    # device picks (the counterpart of JAX's lax.cond on NaN)
    chol, info = torch.linalg.cholesky_ex(gram)
    jitter = 10.0 * _eps(y) * (torch.trace(gram) + 1.0)
    eye = torch.eye(gram.shape[0], dtype=y.dtype, device=y.device)
    chol_retry = cholesky_or_nan(gram + jitter * eye)
    chol = torch.where(info == 0, chol, chol_retry)
    b = torch.linalg.solve_triangular(chol, y_shift.T, upper=False).T
    u, s, _ = torch.linalg.svd(b, full_matrices=False)
    lam = torch.clamp_min(s * s - shift, 0.0)
    return NystromFactors(u=u, lam=lam)


def nystrom(m: torch.Tensor, rank: int, *, generator: torch.Generator | None = None,
            omega: torch.Tensor | None = None) -> NystromFactors:
    """Algorithm 4 on a psd matrix ``m`` (p x p).  ``omega`` is the raw
    Gaussian test matrix (drawn from ``generator`` when not given)."""
    p = m.shape[0]
    if omega is None:
        omega = torch.randn((p, rank), generator=generator, dtype=m.dtype, device=m.device)
    omega, _ = torch.linalg.qr(omega)
    return nystrom_from_sketch(m @ omega, omega, torch.trace(m))


def _scale_rows(m: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """diag(coeff) @ m for m of shape (r,) or (r, t)."""
    return m * coeff[:, None] if m.ndim == 2 else m * coeff


def woodbury_inv_apply(f: NystromFactors, rho, g: torch.Tensor) -> torch.Tensor:
    """(U diag(lam) U^T + rho I)^{-1} g in O(p r t) (Eq. (15)); g (p,) or (p, t)."""
    utg = f.u.T @ g
    core = _scale_rows(utg, 1.0 / (f.lam + rho))
    return f.u @ core + (g - f.u @ utg) / rho


def stable_inv_apply_setup(f: NystromFactors, rho) -> torch.Tensor:
    """Cholesky factor L of (rho diag(lam^{-1}) + U^T U) — App. A.1.1;
    zero eigenvalues are floored (their direction drops out)."""
    lam_safe = torch.clamp_min(f.lam, torch.finfo(f.lam.dtype).tiny * 1e8)
    gram = rho * torch.diag(1.0 / lam_safe) + f.u.T @ f.u
    return cholesky_or_nan(0.5 * (gram + gram.T))


def stable_inv_apply(f: NystromFactors, rho, chol_l: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(K_hat + rho I)^{-1} g via the f32-stable Cholesky path (App. A.1.1);
    g (p,) or (p, t)."""
    utg = f.u.T @ g
    utg2 = utg[:, None] if utg.ndim == 1 else utg  # solve_triangular needs 2-D
    z = torch.linalg.solve_triangular(chol_l, utg2, upper=False)
    z = torch.linalg.solve_triangular(chol_l.T, z, upper=True)
    if utg.ndim == 1:
        z = z[:, 0]
    return (g - f.u @ z) / rho


def woodbury_invsqrt_apply(f: NystromFactors, rho, v: torch.Tensor) -> torch.Tensor:
    """(U diag(lam) U^T + rho I)^{-1/2} v in O(p r t) (Eq. (16)); v (p,) or (p, t)."""
    utv = f.u.T @ v
    core = _scale_rows(utv, 1.0 / torch.sqrt(f.lam + rho))
    return f.u @ core + (v - f.u @ utv) / torch.sqrt(torch.as_tensor(rho, dtype=v.dtype, device=v.device))


def nystrom_dense(f: NystromFactors) -> torch.Tensor:
    """Materialize K_hat (tests only)."""
    return (f.u * f.lam) @ f.u.T
