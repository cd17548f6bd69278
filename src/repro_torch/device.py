"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU.  Asking for
``cuda`` where there is no card raises: nothing quietly runs on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises ``RuntimeError`` when a CUDA
    device is requested and none is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def synchronize(device: str | torch.device) -> None:
    """Wait for the work queued on ``device`` (a no-op off CUDA).  Telemetry
    calls it, only when enabled, before closing a span whose region ends in
    no host read of a device value."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
