"""The kernel tile-compute precision policy — shared vocabulary and validation.

The port's own copy of ``repro.kernels.precision``.  ``"f32"`` — operands,
distances, kernel maps and accumulators all f32.  ``"bf16"`` — the A/B/V
operands and the kernel-times-value product run in bf16 with f32
accumulation; distances, kernel maps, outputs and every solver-internal
quantity stay f32.
"""

from __future__ import annotations

PRECISIONS = ("f32", "bf16")


def check_precision(precision: str) -> str:
    """Validate a precision-policy string ("f32" | "bf16") and return it."""
    if precision not in PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}; expected one of {PRECISIONS}"
        )
    return precision
