"""Random Fourier features (Rahimi & Recht 2007) for the shift-invariant
kernels and the RFF-based PCG preconditioner factors built from them — the
port of ``repro.core.rff``.

With ``z(x) = sqrt(2 / r) * cos(x @ W.T + b)``, ``b ~ U[0, 2 pi)^r`` and W's
rows drawn from the kernel's spectral measure, ``Z Z^T`` is an unbiased
rank-r estimate of K.  The three measures (:data:`RFF_KERNELS`):

  rbf        W_ij ~ N(0, 1/sigma^2)
  laplacian  W_ij ~ Cauchy(0, 1/sigma)
  matern52   W_i ~ t_5(0, I/sigma^2), sampled as ``(z / sigma) / sqrt(u / 5)``
             with z ~ N(0, I) and u ~ chi^2_5

Every draw comes from an explicit ``torch.Generator``; chi^2_5 is the sum of
five squared standard normals (exact for an integer df; ``torch.distributions
.Chi2`` takes no generator).  ``freqs=`` / ``phases=`` inject W and b (the
tests feed in the reference's draws).  The features are a plain GEMM plus
``cos`` in f32 whatever the solve's tile precision, as in the reference,
which computes them outside any Pallas kernel.  A thin SVD ``Z = U S V^T``
(``torch.linalg.svd``: on the H100 it takes as long at 10^6 x 400 as the
SVD of R from a QR of Z, PERF.md) gives the (U, lam = S^2) factors the
Nystrom-type Woodbury apply of :func:`repro_torch.core.pcg.make_preconditioner`
takes.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.nystrom import NystromFactors

#: shift-invariant kernels with an implemented spectral measure — the
#: vocabulary of ``method="pcg-rff"``
RFF_KERNELS = ("rbf", "laplacian", "matern52")


def sample_freqs(
    generator: torch.Generator | None, kernel: str, rank: int, d: int, sigma: float,
    *, device=None,
) -> torch.Tensor:
    """Draw the (rank, d) frequency matrix W from ``kernel``'s spectral
    measure (see the module docstring)."""
    sig = float(sigma)
    kw = dict(generator=generator, dtype=torch.float32, device=device)
    if kernel == "rbf":
        return torch.randn((rank, d), **kw) / sig
    if kernel == "laplacian":
        return torch.empty((rank, d), dtype=torch.float32, device=device).cauchy_(
            generator=generator) / sig
    if kernel == "matern52":
        z = torch.randn((rank, d), **kw)
        u = torch.randn((rank, 1, 5), **kw).square().sum(-1)  # chi^2 with 5 df
        return (z / sig) / torch.sqrt(u / 5.0)
    raise ValueError(
        f"kernel {kernel!r} has no RFF spectral measure; implemented: {RFF_KERNELS}"
    )


def rff_features(
    generator: torch.Generator | None,
    x: torch.Tensor,
    rank: int,
    sigma: float,
    chunk: int = 8192,
    kernel: str = "rbf",
    *,
    freqs: torch.Tensor | None = None,
    phases: torch.Tensor | None = None,
) -> torch.Tensor:
    """The (n, rank) random-Fourier feature matrix Z with E[Z Z^T] = K.

    Args:
      generator: draws W (then b) where they are not injected.
      x: (n, d) data points.
      rank: number of features r.
      sigma: kernel bandwidth / length scale.
      chunk: rows a GEMM at a time (bounds the temporary of ``x @ W.T``).
      kernel: one of :data:`RFF_KERNELS`.
      freqs: (rank, d) W to use instead of a draw.
      phases: (rank,) b to use instead of a draw.

    Returns:
      Z of shape (n, rank), float32: ``sqrt(2/r) cos(x @ W.T + b)``.
    """
    n, d = x.shape
    dev = x.device
    w = sample_freqs(generator, kernel, rank, d, sigma, device=dev) if freqs is None else freqs
    b = (torch.rand((rank,), generator=generator, dtype=torch.float32, device=dev)
         * (2.0 * math.pi)) if phases is None else phases
    w, b = w.to(device=dev, dtype=torch.float32), b.to(device=dev, dtype=torch.float32)
    x = x.to(torch.float32)
    scale = math.sqrt(2.0 / rank)
    z = torch.empty((n, rank), dtype=torch.float32, device=dev)
    for i in range(0, n, chunk):
        zc = z[i:i + chunk]
        torch.addmm(b, x[i:i + chunk], w.T, out=zc)
        zc.cos_().mul_(scale)
    return z


#: default feature oversampling per spectral measure: the heavier the tail,
#: the noisier each feature's contribution to the Gram estimate
DEFAULT_OVERSAMPLE = {"rbf": 4, "laplacian": 6, "matern52": 8}


def rff_factors(
    generator: torch.Generator | None,
    x: torch.Tensor,
    rank: int,
    sigma: float,
    chunk: int = 8192,
    oversample: int | None = None,
    kernel: str = "rbf",
    *,
    freqs: torch.Tensor | None = None,
    phases: torch.Tensor | None = None,
) -> NystromFactors:
    """Rank-r eigen-factors (U, lam) of the RFF Gram ``Z Z^T ~= K``: builds
    ``oversample * rank`` features, takes a thin SVD and keeps the top
    ``rank`` eigenpairs.  ``freqs`` / ``phases`` are the injected draws of
    all ``oversample * rank`` features."""
    if oversample is None:
        oversample = DEFAULT_OVERSAMPLE.get(kernel, 4)
    c = max(int(oversample), 1)
    z = rff_features(generator, x, c * rank, sigma, chunk, kernel, freqs=freqs, phases=phases)
    u, s, _ = torch.linalg.svd(z, full_matrices=False)
    return NystromFactors(u=u[:, :rank], lam=(s * s)[:rank])
