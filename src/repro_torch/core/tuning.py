"""Compatibility shim — the port of ``repro.core.tuning``: re-exports the
public names of :mod:`repro_torch.core.tune` (engine, policies and api) so
imports of the old module path keep working."""

from repro_torch.core.tune import (  # noqa: F401
    SEARCHES,
    STRATEGIES,
    SweepCounter,
    TuneResult,
    apply_best,
    tune,
    tune_multikernel,
)

__all__ = [
    "SEARCHES",
    "STRATEGIES",
    "SweepCounter",
    "TuneResult",
    "apply_best",
    "tune",
    "tune_multikernel",
]
