"""The port of ``repro.core``: the Skotch/ASkotch approximate
sketch-and-project solvers for full KRR, every baseline the paper compares
against, the exact SAP references (``core.sap``) and the policy-driven
(sigma, lam) tuning subsystem (``repro_torch.core.tune``) that picks their
hyperparameters.  Exports what ``repro.core`` exports.
"""

from repro_torch.core.askotch import ASkotchConfig, SolveResult, solve, solve_scan
from repro_torch.core.krr import KRRProblem, evaluate, evaluate_per_head
from repro_torch.core.multikernel import WeightedSumKernelOperator, make_operator
from repro_torch.core.operator import KernelOperator
from repro_torch.core.skotch import solve_skotch
from repro_torch.core.solver_api import (
    METHOD_OPTIONS,
    METHODS,
    MULTIKERNEL_TUNE_OPTIONS,
    TUNE_OPTIONS,
    SolveOutput,
)
from repro_torch.core.solver_api import solve as solve_any
from repro_torch.core.tune import TuneResult, apply_best, tune_multikernel

# Importing the repro_torch.core.tune PACKAGE above binds the module object to the
# ``tune`` attribute of this package; rebind the solver-API entry point last
# so ``from repro_torch.core import tune`` keeps meaning the function.  The package
# stays importable through FROM-imports (``from repro_torch.core.tune import X``,
# resolved via sys.modules); attribute access after a plain ``import
# repro_torch.core.tune`` yields this function instead — use from-imports.
from repro_torch.core.solver_api import tune  # noqa: E402  (must stay below)

__all__ = [
    "ASkotchConfig",
    "KRRProblem",
    "KernelOperator",
    "METHODS",
    "METHOD_OPTIONS",
    "MULTIKERNEL_TUNE_OPTIONS",
    "SolveOutput",
    "SolveResult",
    "TUNE_OPTIONS",
    "TuneResult",
    "WeightedSumKernelOperator",
    "apply_best",
    "evaluate",
    "evaluate_per_head",
    "make_operator",
    "solve",
    "solve_any",
    "solve_scan",
    "solve_skotch",
    "tune",
    "tune_multikernel",
]
