"""sklearn-compatible estimator front end over the solver stack — the port
of ``repro.estimators``.

Three classes with the ``fit`` / ``predict`` / ``score`` / ``get_params``
surface sklearn tooling expects (``clone``, ``GridSearchCV``, pipelines):

* :class:`KernelRidge` — ``sklearn.kernel_ridge.KernelRidge`` semantics
  over ``solver_api.solve`` (whole kernel zoo + ``"precomputed"``; solver,
  device and precision pass-throughs).
* :class:`KernelRidgeCV` — built-in (sigma, alpha) k-fold search over the
  tile-sharing tune engine, sklearn's ``best_params_`` / ``cv_results_``
  reporting idiom.
* :class:`MultipleKernelRidgeCV` — Dirichlet weight search over convex
  kernel combinations (per-kernel bandwidths included).

scikit-learn itself is optional: with it installed the classes subclass
``sklearn.base.BaseEstimator``; without it a structural shim provides the
same surface (``HAVE_SKLEARN`` reports which).  ``device=`` ("cuda" by
default, or "cpu") takes the reference's ``backend=`` slot.
"""

from repro_torch.estimators.base import HAVE_SKLEARN
from repro_torch.estimators.cv import KernelRidgeCV, MultipleKernelRidgeCV
from repro_torch.estimators.kernel_ridge import (
    AUTO_DIRECT_MAX_N,
    KernelRidge,
    resolve_sigma,
)

__all__ = [
    "AUTO_DIRECT_MAX_N",
    "HAVE_SKLEARN",
    "KernelRidge",
    "KernelRidgeCV",
    "MultipleKernelRidgeCV",
    "resolve_sigma",
]
