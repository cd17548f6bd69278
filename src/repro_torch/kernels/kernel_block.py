"""Wrapper of the CUDA kernel ``csrc/kernel_block.cu``: K(A, B) materialised.

Replaces the TPU kernel ``src/repro/kernels/kernel_block.py:
kernel_block_pallas``.  The kernel is bound by its output write (4 bytes per
entry against O(d) operations); its source note says how the design keeps
the stores coalesced.  Its plain version is
``repro_torch.kernels.ref.kernel_block``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.kernel_matvec import check_operands, kernel_names

_SIGNATURE = (
    [ctypes.c_void_p] * 3
    + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
)


def _fn():
    lib = _build.load("kernel_block")
    fn = lib.kernel_block_launch
    fn.argtypes = _SIGNATURE
    fn.restype = ctypes.c_int
    return fn


def kernel_block_cuda(
    a: torch.Tensor, b: torch.Tensor, *, kernel: str, sigma: float, precision: str
) -> torch.Tensor:
    """Launch the kernel on the current stream (no synchronisation).

    a: (m, d), b: (n, d), CUDA, f32 or bf16 -> (m, n) f32.  The operands are
    cast to the policy's type and made contiguous before the launch.
    """
    check_operands(a, b)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1] or a.shape[1] < 1:
        raise ValueError(f"expected a (m, d), b (n, d) with d >= 1; got {tuple(a.shape)}, {tuple(b.shape)}")
    dt = torch.bfloat16 if precision == "bf16" else torch.float32
    a, b = (x.to(dt).contiguous() for x in (a, b))
    m, d = a.shape
    n = b.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if out.numel() == 0:  # nothing to launch
        return out
    with torch.cuda.device(a.device):  # the launch goes to the runtime's current device
        err = _fn()(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, d, float(sigma),
            kernel_names().index(kernel), int(dt == torch.bfloat16),
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"kernel_block launch failed: CUDA error {err}")
    _build.count_launch(kernel_block_cuda)
    return out


#: launches since the last reset (``chip_smoke.py`` sets it to 0 before the
#: main path and reads it after)
kernel_block_cuda.launches = 0
