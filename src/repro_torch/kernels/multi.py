"""Wrappers of the CUDA kernels ``csrc/kernel_multi.cu``: the weighted-sum
(multi-kernel) matvec, the stacked per-kernel matvec and the weighted-sum
block.

Replace the TPU kernels of ``src/repro/kernels/multi.py``
(``kernel_matvec_multi_pallas``, ``kernel_matvec_components_pallas``,
``kernel_block_multi_pallas``).  One shared library holds all three; it is
built from the sources and loaded at the first call, never at import.  Their
plain versions are ``repro_torch.kernels.ref.kernel_matvec_multi``,
``kernel_matvec_components`` and ``kernel_block_multi``.

The weighted matvec has three routes, chosen by :func:`matvec_multi_route`
from t and the kind of weights: the weighted t = 1 sweep, the weighted heads
(the same sweep at W value columns, 2 <= t <= 16 with static weights) and
the column path (per-column weights, or wider V).

A launch takes at most :data:`QMAX` kernels (:data:`QMAX_COMPONENTS` for the
stacked matvec).  A larger q is split into groups, launched in order on the
current stream: the group outputs are summed (matvec, block) or concatenated
(components).  Each launch adds one to its wrapper's count.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.kernel_matvec import check_operands, kernel_names, t1_scratch

#: kernels per launch of the weighted matvec and block (``QMAX`` in the source)
QMAX = 8
#: kernels per launch of the stacked matvec (``QC`` in the source)
QMAX_COMPONENTS = 4

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "kernel_matvec_multi_launch": [_P] * 5 + [_LL, _LL, _I, _I, _I] + [_P] * 3 + [_I, _I, _P, _P],
    "kernel_matvec_multi_heads_launch": [_P] * 4 + [_LL, _LL, _I, _I, _I] + [_P] * 3 + [_I, _I, _P, _P],
    "kernel_matvec_multi_heads_scratch_floats": [_LL, _LL, _I, _I],
    "kernel_matvec_multi_heads_t_max": [],
    "kernel_matvec_multi_cols_launch": [_P] * 5 + [_LL, _LL, _I, _I, _I] + [_P] * 3 + [_I, _I, _P],
    "kernel_matvec_components_launch": [_P] * 4 + [_LL, _LL, _I, _I, _I] + [_P] * 2 + [_I, _P],
    "kernel_block_multi_launch": [_P] * 3 + [_LL, _LL, _I, _I] + [_P] * 3 + [_I, _I, _P, _P],
    "kernel_block_multi_scratch_floats": [_LL, _LL, _I, _I],
}


def _fn(name: str, restype=ctypes.c_int):
    fn = getattr(_build.load("kernel_multi"), name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = restype
    return fn


#: the C launcher of each weighted-matvec route
_MATVEC_LAUNCH = {"t1": "kernel_matvec_multi_launch", "heads": "kernel_matvec_multi_heads_launch",
                  "cols": "kernel_matvec_multi_cols_launch"}


def heads_t_max() -> int:
    """The widest t the weighted heads take (the library's
    ``kernel_matvec_multi_heads_t_max``)."""
    return _fn("kernel_matvec_multi_heads_t_max")()


def matvec_multi_route(t: int, per_column: bool, heads_max: int) -> str:
    """The route of a weighted matvec of t columns: ``"t1"`` at t = 1 (the
    weighted t = 1 sweep, with (q,) weights or a device (q, 1) column);
    ``"heads"`` at 2 <= t <= ``heads_max`` with static (q,) weights (the
    same sweep at W value columns, split over n up to 4096 rows);
    ``"cols"`` for per-column (q, t) weights or a wider t (the column
    path, 160 columns a block)."""
    if t == 1:
        return "t1"
    return "cols" if per_column or t > heads_max else "heads"


def _host_table(kernels, sigmas, weights=None):
    """ctypes arrays of the kernel ids, bandwidths (and static weights)."""
    q = len(kernels)
    ids = (ctypes.c_int * q)(*(kernel_names().index(k) for k in kernels))
    sig = (ctypes.c_float * q)(*(float(s) for s in sigmas))
    w = None if weights is None else (ctypes.c_float * q)(*(float(x) for x in weights))
    return ids, sig, w


def _check_spec(kernels, sigmas, weights=None) -> int:
    q = len(kernels)
    if q < 1 or len(sigmas) != q or (weights is not None and len(weights) != q):
        raise ValueError(
            f"need q >= 1 kernels with one sigma (and weight) each; got {len(kernels)} "
            f"kernels, {len(sigmas)} sigmas" + ("" if weights is None else f", {len(weights)} weights")
        )
    unknown = [k for k in kernels if k not in kernel_names()]
    if unknown:
        raise ValueError(f"unknown kernel(s) {unknown}; available: {kernel_names()}")
    return q


def _check_ab(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1] or a.shape[1] < 1:
        raise ValueError(f"expected a (m, d), b (n, d) with d >= 1; got {tuple(a.shape)}, {tuple(b.shape)}")


def _check_v(v: torch.Tensor, n: int) -> int:
    if v.ndim not in (1, 2) or v.shape[0] != n or (v.ndim == 2 and v.shape[1] < 1):
        raise ValueError(f"expected v (n,) or (n, t) with n = {n}; got {tuple(v.shape)}")
    return 1 if v.ndim == 1 else v.shape[1]


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def kernel_matvec_multi_cuda(
    a: torch.Tensor,
    b: torch.Tensor,
    v: torch.Tensor,
    weights,
    *,
    kernels: tuple[str, ...],
    sigmas: tuple[float, ...],
    precision: str,
) -> torch.Tensor:
    """(sum_i w_i K_i(a, b)) @ v on the current stream (no synchronisation).

    a: (m, d), b: (n, d), v: (n,) | (n, t), CUDA, f32 or bf16 -> f32 (m,) |
    (m, t).  ``weights`` is a sequence of q floats (one weight per kernel,
    passed to the kernel by value) or a CUDA f32 tensor (q, t) (per-column
    weights, read by the kernel).  The operands are cast to the policy's
    type; the weights stay f32.  The route is :func:`matvec_multi_route`'s:
    t = 1 launches the t = 1 sweep it shares with ``kernel_matvec`` and 2
    <= t <= 16 with (q,) weights the same sweep at W value columns (B
    packed with its norms and V into a scratch buffer first; up to 4096
    rows of A, B split over grid.y and each value's range sums added in a
    fixed order, so a row's result is the same in every bucket); per-column
    weights and t > 16 the column path (f32 operands: bf16 values widen
    exactly), which forms each pair's kernel values once for up to 160
    columns.
    """
    q = _check_spec(kernels, sigmas)
    check_operands(a, b, v)
    _check_ab(a, b)
    t = _check_v(v, b.shape[0])
    w_dev, w_host = None, None
    if isinstance(weights, torch.Tensor):
        if weights.device != a.device:
            raise ValueError(f"weights must be on {a.device}; got {weights.device}")
        if weights.shape != (q, t) or weights.dtype != torch.float32:
            raise ValueError(f"expected f32 weights ({q}, {t}); got {weights.dtype} "
                             f"{tuple(weights.shape)}")
        w_dev = weights.contiguous()
    else:
        w_host = tuple(float(x) for x in weights)
        if len(w_host) != q:
            raise ValueError(f"expected {q} weights; got {len(w_host)}")
    route = matvec_multi_route(t, w_dev is not None, heads_t_max())
    dt = torch.bfloat16 if precision == "bf16" else torch.float32
    a, b, v = (x.to(dt).contiguous() for x in (a, b, v))
    if route == "cols":  # the column path reads f32 operands: bf16 values widen exactly
        a, b, v = (x.float() for x in (a, b, v))
    m, d = a.shape
    n = b.shape[0]
    out = torch.empty((m,) if v.ndim == 1 else (m, t), dtype=torch.float32, device=a.device)
    if m == 0:  # nothing to launch
        return out
    fn = _fn(_MATVEC_LAUNCH[route])
    # the sweeps pack B with its norms and V into a scratch buffer first
    extra = ()
    if route == "t1":
        scratch = t1_scratch(_build.load("kernel_multi"), m, n, d, a.device)
        extra = (scratch.data_ptr() if scratch.numel() else None,)
    elif route == "heads":
        size = _fn("kernel_matvec_multi_heads_scratch_floats", _LL)(m, n, d, t)
        scratch = torch.empty((size,), dtype=torch.float32, device=a.device)
        extra = (scratch.data_ptr() if size else None,)
    with torch.cuda.device(a.device):  # the launch goes to the runtime's current device
        stream = torch.cuda.current_stream(a.device).cuda_stream
        for g0 in range(0, q, QMAX):
            g = slice(g0, g0 + QMAX)
            ids, sig, w_static = _host_table(kernels[g], sigmas[g], None if w_host is None else w_host[g])
            w_ptr = () if route == "heads" else (None if w_dev is None else w_dev[g].data_ptr(),)
            err = fn(
                a.data_ptr(), b.data_ptr(), v.data_ptr(), *w_ptr, out.data_ptr(),
                m, n, d, t, len(ids), ids, sig, w_static, int(dt == torch.bfloat16),
                int(g0 > 0), *extra, stream,
            )
            _raise_on(err, "kernel_matvec_multi")
            _build.count_launch(kernel_matvec_multi_cuda)
    return out


def kernel_matvec_components_cuda(
    a: torch.Tensor,
    b: torch.Tensor,
    v: torch.Tensor,
    *,
    kernels: tuple[str, ...],
    sigmas: tuple[float, ...],
    precision: str,
) -> torch.Tensor:
    """Stacked K_i(a, b) @ v on the current stream (no synchronisation).

    a: (m, d), b: (n, d), v: (n,) | (n, t), CUDA, f32 or bf16 -> f32
    (q, m) | (q, m, t).  The operands are cast to the policy's type, then
    read as f32 (bf16 values widen exactly) by the column path, one kernel
    a grid slice.
    """
    q = _check_spec(kernels, sigmas)
    check_operands(a, b, v)
    _check_ab(a, b)
    t = _check_v(v, b.shape[0])
    dt = torch.bfloat16 if precision == "bf16" else torch.float32
    a, b, v = (x.to(dt).contiguous().float() for x in (a, b, v))
    m, d = a.shape
    n = b.shape[0]
    out = torch.empty((q, m, t), dtype=torch.float32, device=a.device)
    if m > 0:
        fn = _fn("kernel_matvec_components_launch")
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            for g0 in range(0, q, QMAX_COMPONENTS):
                g = slice(g0, g0 + QMAX_COMPONENTS)
                ids, sig, _ = _host_table(kernels[g], sigmas[g])
                err = fn(a.data_ptr(), b.data_ptr(), v.data_ptr(), out[g].data_ptr(),
                         m, n, d, t, len(ids), ids, sig, int(dt == torch.bfloat16), stream)
                _raise_on(err, "kernel_matvec_components")
                _build.count_launch(kernel_matvec_components_cuda)
    return out[:, :, 0] if v.ndim == 1 else out


def kernel_block_multi_cuda(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    kernels: tuple[str, ...],
    sigmas: tuple[float, ...],
    weights: tuple[float, ...],
    precision: str,
) -> torch.Tensor:
    """sum_i w_i K_i(a, b) materialised on the current stream.

    a: (m, d), b: (n, d), CUDA, f32 or bf16 -> (m, n) f32; ``weights`` q floats.
    Each launch packs A and B with their norms into a scratch buffer first;
    when ``b`` is ``a`` (a block of one point set, K_BB) they are packed once.
    """
    q = _check_spec(kernels, sigmas, weights)
    check_operands(a, b)
    _check_ab(a, b)
    same = a is b
    dt = torch.bfloat16 if precision == "bf16" else torch.float32
    a = a.to(dt).contiguous()
    b = a if same else b.to(dt).contiguous()
    m, d = a.shape
    n = b.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if out.numel() == 0:  # nothing to launch
        return out
    fn = _fn("kernel_block_multi_launch")
    size = _fn("kernel_block_multi_scratch_floats", _LL)(m, n, d, int(same))
    scratch = torch.empty((size,), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        for g0 in range(0, q, QMAX):
            g = slice(g0, g0 + QMAX)
            ids, sig, w = _host_table(kernels[g], sigmas[g], weights[g])
            err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, d, len(ids), ids, sig, w,
                     int(dt == torch.bfloat16), int(g0 > 0), scratch.data_ptr(), stream)
            _raise_on(err, "kernel_block_multi")
            _build.count_launch(kernel_block_multi_cuda)
    return out


#: launches since the last reset (``chip_smoke.py`` sets them to 0 before a
#: path and reads them after)
kernel_matvec_multi_cuda.launches = 0
kernel_matvec_components_cuda.launches = 0
kernel_block_multi_cuda.launches = 0
