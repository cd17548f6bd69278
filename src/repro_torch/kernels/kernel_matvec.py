"""Wrapper of the CUDA kernel ``csrc/kernel_matvec.cu``: out = K(A, B) @ V.

Replaces the TPU kernel ``src/repro/kernels/kernel_matvec.py:
kernel_matvec_pallas``.  The kernel is bound by operations (O(m n d) f32
FMAs plus one kernel-map evaluation per pair, and t FMAs a pair for t
columns); its source note says how the design keeps every pair in registers
and shared memory.  The route is chosen by t alone: t = 1 runs on the t = 1
sweep (``csrc/sweep_t1.cuh``), 2 <= t <= 32 on the same sweep with V's
columns packed beside B (a compile-time width of 2, 4, 8, 12, 16, 20, 24
or 32), t > 32 on the column path (``csrc/sweep_cols.cuh``).  Up to 4096 rows of A (a
serving bucket) both sweeps split B over grid.y, so a few rows still fill
the card; the split is set by n alone, so a row's result is bitwise the
same whatever rows travel with it.  Its plain version is
``repro_torch.kernels.ref.kernel_matvec``.

The library is built from the sources and loaded at the first call, never
at import, so this module imports on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_SIGNATURE = (
    [ctypes.c_void_p] * 4
    + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
       ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
)


def kernel_names() -> tuple[str, ...]:
    """The kernel zoo's names in the CUDA sources' id order
    (``repro_torch.core.kernels.KERNEL_NAMES``), imported at call time:
    ``repro_torch.core`` imports the operators, which import these
    wrappers, so a wrapper module imported first must not import it."""
    from repro_torch.core.kernels import KERNEL_NAMES

    return KERNEL_NAMES


def _fn():
    lib = _build.load("kernel_matvec")
    fn = lib.kernel_matvec_launch
    fn.argtypes = _SIGNATURE
    fn.restype = ctypes.c_int
    return fn


def sweep_t_max() -> int:
    """The widest t that runs on a sweep (the library's
    ``kernel_matvec_sweep_t_max``); wider V goes to the column path."""
    return _build.load("kernel_matvec").kernel_matvec_sweep_t_max()


def t1_scratch(lib: ctypes.CDLL, m: int, n: int, d: int, device) -> torch.Tensor:
    """The f32 scratch of a t = 1 launch of ``lib`` over m rows: B packed
    with its norms and v, then, where the launch splits n (m <= 4096), the
    (S, m) partial row sums (its size from the library's
    ``sweep_t1_scratch_floats(m, n, d)``)."""
    size = lib.sweep_t1_scratch_floats
    size.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int]
    size.restype = ctypes.c_longlong
    return torch.empty((size(m, n, d),), dtype=torch.float32, device=device)


def _scratch(m: int, n: int, d: int, t: int, device) -> torch.Tensor | None:
    """The f32 scratch of a launch at t columns: B packed with its norms and
    V, then, where the launch splits n (m <= 4096), the (S, m, t) partials
    (``kernel_matvec_scratch_floats``); None on the column path (t >
    ``sweep_t_max()``)."""
    size = _build.load("kernel_matvec").kernel_matvec_scratch_floats
    size.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    size.restype = ctypes.c_longlong
    floats = size(m, n, d, t)
    return torch.empty((floats,), dtype=torch.float32, device=device) if floats else None


def t1_splits(lib: ctypes.CDLL, m: int, n: int, d: int) -> int:
    """The ranges S a sweep of ``lib`` over m rows splits B (n rows, d
    features) into, at t = 1 and on the multi-column sweep alike: 1 above
    4096 rows or for a short B, else a number set by n and the feature
    route alone (``sweep_t1_splits``)."""
    fn = lib.sweep_t1_splits
    fn.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(m, n, d)


def check_operands(*xs: torch.Tensor) -> None:
    """Raise unless every operand is a CUDA tensor on one device, f32 or
    bf16 (f64 and other types are refused)."""
    dev = xs[0].device
    for x in xs:
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(
                f"CUDA kernel operands must share one CUDA device; got {x.device} and {dev}"
            )
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"CUDA kernel operands must be float32 or bfloat16, got {x.dtype}")


def kernel_matvec_cuda(
    a: torch.Tensor,
    b: torch.Tensor,
    v: torch.Tensor,
    *,
    kernel: str,
    sigma: float,
    precision: str,
) -> torch.Tensor:
    """Launch the kernel on the current stream (no synchronisation).

    a: (m, d), b: (n, d), v: (n,) | (n, t), CUDA, f32 or bf16 -> f32 (m,) | (m, t).
    The operands are cast to the policy's type (bf16 for ``"bf16"``, f32
    otherwise) and made contiguous before the launch.  Up to 32 columns
    (``sweep_t_max()``) the launch runs a sweep: B packed with its norms and
    V's t columns into a scratch buffer first (zero columns up to the
    sweep's width, 2 to 32), then, up to 4096 rows of A, B split into
    ranges over grid.y, each value's range sums added in a fixed order by a
    third kernel.  Wider V reads f32 operands (bf16 values widen exactly)
    with V padded by zero columns to a multiple of 4, so its rows are copied
    in 16-byte units, on the column path, which forms each pair's kernel
    value once for up to 160 columns.
    """
    check_operands(a, b, v)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1] or a.shape[1] < 1:
        raise ValueError(f"expected a (m, d), b (n, d) with d >= 1; got {tuple(a.shape)}, {tuple(b.shape)}")
    if v.ndim not in (1, 2) or v.shape[0] != b.shape[0] or (v.ndim == 2 and v.shape[1] < 1):
        raise ValueError(f"expected v (n,) or (n, t) with n = {b.shape[0]}; got {tuple(v.shape)}")
    dt = torch.bfloat16 if precision == "bf16" else torch.float32
    a, b, v = (x.to(dt).contiguous() for x in (a, b, v))
    m, d = a.shape
    n = b.shape[0]
    t = 1 if v.ndim == 1 else v.shape[1]
    if m == 0:  # nothing to launch
        return torch.empty((0,) if v.ndim == 1 else (0, t), dtype=torch.float32, device=a.device)
    fn = _fn()
    cols = t > sweep_t_max()
    tp = -(-t // 4) * 4 if cols else t  # the columns launched
    if cols:  # the column path: f32 operands (bf16 values widen exactly)
        a, b, v = (x.float() for x in (a, b, v))
        if tp > t:
            v = torch.nn.functional.pad(v, (0, tp - t))
    out = torch.empty((m,) if v.ndim == 1 else (m, tp), dtype=torch.float32, device=a.device)
    # a sweep packs B with its norms and V into a scratch buffer first
    scratch = _scratch(m, n, d, tp, a.device)
    with torch.cuda.device(a.device):  # the launch goes to the runtime's current device
        err = fn(
            a.data_ptr(), b.data_ptr(), v.data_ptr(), out.data_ptr(), m, n, d, tp,
            float(sigma), kernel_names().index(kernel), int(dt == torch.bfloat16),
            None if scratch is None or scratch.numel() == 0 else scratch.data_ptr(),
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"kernel_matvec launch failed: CUDA error {err}")
    _build.count_launch(kernel_matvec_cuda)
    return out[:, :t].contiguous() if tp > t else out


#: launches since the last reset (``chip_smoke.py`` sets it to 0 before the
#: main path and reads it after)
kernel_matvec_cuda.launches = 0
