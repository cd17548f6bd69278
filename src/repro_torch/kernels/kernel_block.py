"""Wrapper of the CUDA kernel ``csrc/kernel_block.cu``: K(A, B) materialised.

Replaces the TPU kernel ``src/repro/kernels/kernel_block.py:
kernel_block_pallas``.  The kernel is bound by its output write (4 bytes per
entry against O(d) operations), or for a column or a row of K by reading
the many rows once.  It has three routes, one launch each, picked here by
:func:`block_route` from the shape and from whether ``b`` is ``a``:

* ``"tile"``: a persistent grid over 128 x 128 output tiles, each mapped
  into shared memory and stored as whole 512-byte rows;
* ``"symmetric"`` (``b`` is ``a``): the same grid over the tiles on and
  above the diagonal, each one above it also written transposed;
* ``"skinny_cols"`` / ``"skinny_rows"``: at most :func:`skinny_max`
  columns (RPCholesky's pivot column) or rows (SAP's row): one thread an
  output row (column), the many rows read once.

The source note says how each route keeps its stores coalesced.  Every
route gives the same bits.  Its plain version is
``repro_torch.kernels.ref.kernel_block``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.kernel_matvec import check_operands, kernel_names

#: the C launcher's route codes, by index
ROUTES = ("tile", "symmetric", "skinny_cols", "skinny_rows")

_SIGNATURE = (
    [ctypes.c_void_p] * 3
    + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
)


def _fn():
    lib = _build.load("kernel_block")
    fn = lib.kernel_block_launch
    fn.argtypes = _SIGNATURE
    fn.restype = ctypes.c_int
    return fn


def skinny_max() -> int:
    """The most columns (rows) the skinny routes take, read from the library
    (``SK_QMAX``, ``kernel_block_skinny_max``): the threshold of
    :func:`block_route`.  At 10^6 rows the skinny routes beat the tile route
    at every width timed, 1 to 64 (``tools/time_torch_kernels.py
    --crossover`` on the H100, PERF.md); that crossover was measured at 10^6
    rows only."""
    return _build.load("kernel_block").kernel_block_skinny_max()


def block_route(m: int, n: int, same: bool, limit: int) -> str:
    """The route for an (m, n) output; ``same``: b is a (so m == n);
    ``limit``: the skinny routes' threshold (:func:`skinny_max`)."""
    if n <= limit:
        return "skinny_cols"
    if m <= limit:
        return "skinny_rows"
    return "symmetric" if same else "tile"


def prepare_operands(
    a: torch.Tensor, b: torch.Tensor, precision: str
) -> tuple[torch.Tensor, torch.Tensor, bool]:
    """(a, b, same): the operands cast to the policy's type and made
    contiguous, ``b`` returned as the very tensor ``a`` when it is ``a`` (the
    same object, or the same view of the same memory), so the cast copies
    once and the symmetric route sees one operand."""
    same = b is a or (
        b.device == a.device and b.dtype == a.dtype and b.shape == a.shape
        and b.stride() == a.stride() and b.data_ptr() == a.data_ptr()
    )
    dt = torch.bfloat16 if precision == "bf16" else torch.float32
    a = a.to(dt).contiguous()
    return a, (a if same else b.to(dt).contiguous()), same


def launch_route(
    a: torch.Tensor, b: torch.Tensor, *, kernel: str, sigma: float, route: str
) -> torch.Tensor:
    """Launch one route of the kernel on prepared operands (the current
    stream, no synchronisation); raises if the launch fails or the route
    does not take the shape.  :func:`kernel_block_cuda` picks the route."""
    m, d = a.shape
    n = b.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if out.numel() == 0:  # nothing to launch
        return out
    with torch.cuda.device(a.device):  # the launch goes to the runtime's current device
        err = _fn()(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, d, float(sigma),
            kernel_names().index(kernel), int(a.dtype == torch.bfloat16), ROUTES.index(route),
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"kernel_block launch ({route}) failed: CUDA error {err}")
    return out


def kernel_block_cuda(
    a: torch.Tensor, b: torch.Tensor, *, kernel: str, sigma: float, precision: str
) -> torch.Tensor:
    """Launch the kernel on the current stream (no synchronisation).

    a: (m, d), b: (n, d), CUDA, f32 or bf16 -> (m, n) f32.  The operands are
    cast to the policy's type and made contiguous before the launch (once
    when ``b`` is ``a``).
    """
    check_operands(a, b)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1] or a.shape[1] < 1:
        raise ValueError(f"expected a (m, d), b (n, d) with d >= 1; got {tuple(a.shape)}, {tuple(b.shape)}")
    a, b, same = prepare_operands(a, b, precision)
    route = block_route(a.shape[0], b.shape[0], same, skinny_max())
    out = launch_route(a, b, kernel=kernel, sigma=sigma, route=route)
    if out.numel():
        _build.count_launch(kernel_block_cuda)
    return out


#: launches since the last reset (``chip_smoke.py`` sets it to 0 before the
#: main path and reads it after)
kernel_block_cuda.launches = 0
