"""Roofline terms of the dry run, and where the port gets its costs — the
counterpart of ``repro.roofline.analyze``.

Terms, per device:

    compute    = FLOPs / peak rate (bf16 tensor cores for LM compute,
                 the CUDA cores' f32 rate for the f32 policy)
    memory     = bytes accessed / HBM_BW
    collective = collective operand bytes / COLLECTIVE_BW

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` of a
compiled program.  The port has no compiler, so :func:`trace_cost` runs the
program itself on ``meta`` tensors (shapes and dtypes, no data) under a
``TorchDispatchMode`` that sees every aten op:

  * FLOPs: ``torch.utils.flop_counter``'s formulas for products and
    attention; one a result element for other pointwise arithmetic; one an
    input element for a reduction or a softmax; none for copies, casts,
    views and factories;
  * bytes accessed: each op's operand plus result bytes (none for a view or
    a factory).  This is the eager port's unfused traffic: every op reads
    and writes memory.  It is an upper bound on XLA's fused count;
  * peak live bytes: each result's storage counts from the op that made it
    until its last tensor is freed (a weak reference on the storage); a
    view adds nothing, and storages live at entry (the arguments) are not
    counted.

The CUDA kernels are ctypes calls no dispatch mode sees: on ``meta``
operands ``kernels.ops`` adds their analytic FLOPs and bytes
(:func:`kernel_cost`, :func:`multi_kernel_cost`) with :func:`record_kernel`,
and a ``SolverMesh`` collective adds its operand bytes, by kind, with
:func:`record_collective` — the counterpart of the reference's collective
parse of the HLO text, which the port does not emit.

Models whose depth makes a whole trace slow are traced at two depths and
extrapolated (:func:`extrapolate`), as the reference extrapolates its
unrolled probes:

    per_layer = cost(L=2) - cost(L=1);   total = cost(L=1) + per_layer*(L-1)
"""

from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline import hw

COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# ---------------------------------------------------------------------------
# the hand-written kernels' analytic work
# ---------------------------------------------------------------------------

# f32 operations per pair of each base-tile family at feature width d (l2:
# d products and sums, two adds, the clamp; l1: subtract, abs, add per
# feature; cos: the dot product and its division by the norms) and of each
# kernel map on that tile
FAMILY_OPS = {"l2": lambda d: 2 * d + 3, "l1": lambda d: 3 * d, "dot": lambda d: 2 * d,
              "cos": lambda d: 2 * d + 3}
MAP_OPS = {"rbf": 2, "laplacian": 2, "matern52": 8, "linear": 1, "polynomial": 4,
           "sigmoid": 3, "cosine": 0}


def kernel_ops_per_pair(kernel: str, d: int, t: int) -> int:
    """f32 operations per (row, column) pair of one kernel: its base tile,
    its map, then 2 per value column (none for a block: ``t`` 0)."""
    from repro_torch.core.kernels import kernel_family

    return FAMILY_OPS[kernel_family(kernel)](d) + MAP_OPS[kernel] + 2 * t


def rbf_ops_per_pair(d: int, t: int) -> int:
    """f32 operations per (row, column) pair of the main path's rbf kernel:
    the squared distance ||a||^2 + ||b||^2 - 2 a.b (2d + 3: d products and
    sums, two adds, the clamp), the map (scale, exp), then 2 per value column."""
    return kernel_ops_per_pair("rbf", d, t)


def multi_ops_per_pair(kernels, d: int, t: int, kind: str) -> int:
    """f32 operations per pair of a multi-kernel op: one base tile per
    family present, every kernel's map, then the products — ``"matvec"``
    with (q,) weights: combine the q values (2 each) and 2 per column;
    ``"cols"`` (per-column weights) and ``"components"``: 2 per kernel and
    column; ``"block"``: the weighted sum (2 per kernel)."""
    from repro_torch.core.kernels import kernel_family

    q = len(kernels)
    ops = sum(FAMILY_OPS[f](d) for f in dict.fromkeys(kernel_family(k) for k in kernels))
    ops += sum(MAP_OPS[k] for k in kernels)
    return ops + {"matvec": 2 * q + 2 * t, "cols": 2 * q * t, "components": 2 * q * t,
                  "block": 2 * q}[kind]


def kernel_cost(m: int, n: int, d: int, t: int | None, kernel: str = "rbf"
                ) -> tuple[float, float]:
    """(FLOPs, bytes) of ``kernel_matvec`` on (m, d) x (n, d) rows with t
    value columns, or of ``kernel_block`` when ``t`` is None: each f32
    input read once, the output written once."""
    flops = m * n * kernel_ops_per_pair(kernel, d, t or 0)
    if t:  # matvec: read A, B, V once, write out once
        nbytes = 4 * (m * d + n * d + n * t + m * t)
    else:  # block: read A, B once, write K once
        nbytes = 4 * (m * d + n * d + m * n)
    return float(flops), float(nbytes)


def multi_kernel_cost(m: int, n: int, d: int, t: int, kernels, kind: str
                      ) -> tuple[float, float]:
    """(FLOPs, bytes) of a multi-kernel op (``kind`` as in
    :func:`multi_ops_per_pair`)."""
    q = len(kernels)
    flops = m * n * multi_ops_per_pair(kernels, d, t, kind)
    nbytes = 4 * (m * d + n * d)
    nbytes += {"matvec": 4 * (n * t + m * t), "cols": 4 * (n * t + q * t + m * t),
               "components": 4 * (n * t + q * m * t), "block": 4 * m * n}[kind]
    return float(flops), float(nbytes)


# ---------------------------------------------------------------------------
# the reference's cost record and its arithmetic
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CellCost:
    flops: float  # per device
    bytes_accessed: float  # per device
    coll_bytes: float  # per device
    coll_breakdown: dict[str, float]


def extrapolate(base1: CellCost, base2: CellCost, layers_probe_delta: int,
                layers_full_minus_probe1: int) -> CellCost:
    """cost(L_full) from two probes."""

    def ext(a1, a2):
        per = max((a2 - a1) / max(layers_probe_delta, 1), 0.0)
        return a1 + per * layers_full_minus_probe1

    breakdown = {
        k: ext(base1.coll_breakdown.get(k, 0), base2.coll_breakdown.get(k, 0))
        for k in COLLECTIVE_OPS
    }
    return CellCost(
        flops=ext(base1.flops, base2.flops),
        bytes_accessed=ext(base1.bytes_accessed, base2.bytes_accessed),
        coll_bytes=sum(breakdown.values()),
        coll_breakdown=breakdown,
    )


def roofline_terms(cost: CellCost, peak_flops: float = hw.PEAK_FLOPS_BF16) -> dict[str, float]:
    """Seconds of each term on one H100.  ``peak_flops``: the bf16 tensor
    cores' rate (LM compute, the default) or ``hw.PEAK_FLOPS_F32`` (the f32
    policy: KRR, and LM configs that compute in f32)."""
    compute = cost.flops / peak_flops
    memory = cost.bytes_accessed / hw.HBM_BW
    collective = cost.coll_bytes / hw.COLLECTIVE_BW
    dominant = max(
        ("compute", compute), ("memory", memory), ("collective", collective),
        key=lambda kv: kv[1],
    )[0]
    return {
        "compute_s": compute,
        "memory_s": memory,
        "collective_s": collective,
        "dominant": dominant,
    }


def peak_for(compute_dtype: str) -> float:
    """The peak rate of a record's ``compute_dtype``: f32 on the CUDA
    cores, anything narrower on the bf16 tensor cores."""
    return hw.PEAK_FLOPS_F32 if compute_dtype == "float32" else hw.PEAK_FLOPS_BF16


def model_flops(n_params: int, n_active: int, tokens: int, train: bool) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); decode/prefill use the fwd 2*N*D."""
    n = n_active or n_params
    per_token = 6.0 * n if train else 2.0 * n
    return per_token * tokens


# ---------------------------------------------------------------------------
# the counter and the traced run
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
#: ops that move or make data and compute nothing
_NO_FLOPS = {_aten.clone, _aten._to_copy, _aten.copy_, _aten.copy, _aten.fill_, _aten.fill,
             _aten.zero_, _aten.zeros_like, _aten.ones_like, _aten.full_like,
             _aten.empty_like}
#: ops that allocate without touching memory
_NO_BYTES = {_aten.empty, _aten.empty_strided, _aten.empty_like, _aten.new_empty,
             _aten.new_empty_strided, _aten.lift_fresh, _aten.detach, _aten.alias,
             _aten._local_scalar_dense}
#: one pass over the input (named here, not read from aten's tags, which
#: differ between torch versions)
_REDUCTIONS = {_aten.sum, _aten.mean, _aten.amax, _aten.amin, _aten.max, _aten.min,
               _aten.prod, _aten.var, _aten.std, _aten.var_mean, _aten.std_mean,
               _aten.linalg_vector_norm, _aten.norm, _aten.argmax, _aten.argmin, _aten.any,
               _aten.all, _aten._softmax, _aten._log_softmax, _aten._softmax_backward_data,
               _aten._log_softmax_backward_data, _aten.logsumexp, _aten.cumsum,
               _aten.nll_loss_forward, _aten.nll_loss_backward}

_STATE = threading.local()


def _active() -> list:
    if not hasattr(_STATE, "stack"):
        _STATE.stack = []
    return _STATE.stack


def record_kernel(name: str, flops: float, nbytes: float) -> None:
    """Add one call of the hand-written kernel ``name`` and its analytic
    work to the innermost active counter (none active: nothing)."""
    stack = _active()
    if stack:
        c = stack[-1]
        c.flops += flops
        c.bytes_accessed += nbytes
        c.kernels[name] = c.kernels.get(name, 0) + 1


def record_collective(kind: str, nbytes: float) -> None:
    """Add one device's operand bytes of a collective of ``kind`` (one of
    :data:`COLLECTIVE_OPS`) to the innermost active counter."""
    stack = _active()
    if stack:
        br = stack[-1].coll_breakdown
        br[kind] = br.get(kind, 0.0) + float(nbytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class CostCounter:
    """What a traced run did: FLOPs and bytes of every device's work
    together, collective operand bytes per device, and the live-bytes peak."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    coll_breakdown: dict = dataclasses.field(default_factory=dict)
    ops: int = 0
    kernels: dict = dataclasses.field(default_factory=dict)  # meta-route calls by kernel
    live_bytes: int = 0
    peak_bytes: int = 0
    _storages: dict = dataclasses.field(default_factory=dict, repr=False)

    def cell_cost(self, divide: int = 1) -> CellCost:
        """The counts as a :class:`CellCost`, FLOPs and bytes divided by
        ``divide`` (the device count: perfect sharding)."""
        br = {k: float(self.coll_breakdown.get(k, 0.0)) for k in COLLECTIVE_OPS}
        return CellCost(flops=self.flops / divide, bytes_accessed=self.bytes_accessed / divide,
                        coll_bytes=sum(br.values()), coll_breakdown=br)

    def _known(self, t: torch.Tensor) -> None:
        """Mark ``t``'s storage as live before the trace (never counted)."""
        st = t.untyped_storage()
        self._storages.setdefault(id(st), (weakref.ref(st, self._freed(id(st))), 0))

    def _freed(self, key: int):
        def callback(_ref):
            entry = self._storages.pop(key, None)
            if entry is not None:
                self.live_bytes -= entry[1]
        return callback

    def _allocated(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if id(st) in self._storages:
            return  # a view, an in-place result or an argument
        nbytes = st.nbytes()
        self._storages[id(st)] = (weakref.ref(st, self._freed(id(st))), nbytes)
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def op(self, func, args, kwargs, out) -> tuple[float, float] | None:
        """Count one op; returns its (FLOPs, bytes), or None for an op
        that moves nothing (a view, a factory, a result aliasing an input)."""
        self.ops += 1
        info = _info(func)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        for o in outs:
            self._allocated(o)
        in_storages = {id(a.untyped_storage()) for a in ins}
        if info.is_view or info.packet in _NO_BYTES or (not info.in_place and any(
                id(o.untyped_storage()) in in_storages for o in outs)):
            return None
        # an in-place result is its first operand: read once, written once
        nbytes = float(sum(_nbytes(a) for a in ins) + sum(_nbytes(o) for o in outs))
        flops = 0.0
        if info.packet in flop_registry:
            flops = float(flop_registry[info.packet](*args, **kwargs, out_val=out))
        elif info.packet in _NO_FLOPS:
            pass
        elif info.reduction:
            flops = float(ins[0].numel() if ins else 0)
        elif info.pointwise:
            flops = float(sum(o.numel() for o in outs))
        self.flops += flops
        self.bytes_accessed += nbytes
        return flops, nbytes

    def replay(self, outs: list, flops: float, nbytes: float) -> None:
        """Count an op whose memo made its fresh outputs."""
        self.ops += 1
        for o in outs:
            self._allocated(o)
        self.flops += flops
        self.bytes_accessed += nbytes


@dataclasses.dataclass(frozen=True)
class _FuncInfo:
    packet: Any
    is_view: bool
    in_place: bool  # writes an operand (in-place or out=)
    reduction: bool
    pointwise: bool


_INFOS: dict = {}


def _info(func) -> _FuncInfo:
    info = _INFOS.get(func)
    if info is None:
        schema = func._schema
        info = _FuncInfo(
            packet=func.overloadpacket,
            # a view returns an alias of an input that it does not write
            is_view=any(r.alias_info is not None and not r.alias_info.is_write
                        for r in schema.returns),
            in_place=schema.is_mutable,
            reduction=func.overloadpacket in _REDUCTIONS,
            pointwise=torch.Tag.pointwise in func.tags)
        _INFOS[func] = info
    return info


def _tensors(obj, acc: list | None = None) -> list:
    """The tensors in nested tuples, lists and dicts."""
    acc = [] if acc is None else acc
    if isinstance(obj, torch.Tensor):
        acc.append(obj)
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            _tensors(o, acc)
    elif isinstance(obj, dict):
        for o in obj.values():
            _tensors(o, acc)
    return acc


_PLAIN = (int, float, bool, str, type(None), torch.dtype, torch.device, torch.memory_format,
          torch.layout)


def _key(obj):
    """A hashable stand-in for an op's arguments: each tensor by its shape,
    strides, dtype and device; None where an argument is of another kind."""
    if isinstance(obj, torch.Tensor):
        return (tuple(obj.shape), obj.stride(), obj.dtype, obj.device.type)
    if isinstance(obj, _PLAIN):
        return (type(obj), obj)
    if isinstance(obj, (tuple, list)):
        parts = tuple(_key(o) for o in obj)
        return None if None in parts else parts
    return None


def _layout(out):
    """(shape, strides, dtype, device) of each output, in the output's
    nesting; None where an output is not a tensor."""
    if isinstance(out, torch.Tensor):
        return (tuple(out.shape), out.stride(), out.dtype, out.device)
    if isinstance(out, (tuple, list)) and out:
        parts = [_layout(o) for o in out]
        return None if any(p is None for p in parts) else (type(out), parts)
    return None


def _fresh(layout):
    if isinstance(layout[1], list):
        return layout[0](_fresh(p) for p in layout[1])
    shape, stride, dtype, device = layout
    return torch.empty_strided(shape, stride, dtype=dtype, device=device)


class _CountingMode(TorchDispatchMode):
    """Counts every op into ``counter``.  A meta op's result depends only on
    its inputs' metadata, so an op that made fresh outputs is memoized by
    (op, argument layouts): a repeat makes empty tensors of the same
    layout and adds the same counts, without running the op's meta
    function again (a mesh program repeats each op on every coordinate)."""

    def __init__(self, counter: CostCounter):
        super().__init__()
        self.counter = counter
        self.memo: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        key = None
        info = _info(func)
        if not info.in_place and not info.is_view:
            key = _key((args, tuple(sorted(kwargs.items()))))
            if key is not None:
                key = (func, key)
                hit = self.memo.get(key)
                if hit is not None:
                    out = _fresh(hit[0])
                    self.counter.replay(_tensors(out), hit[1], hit[2])
                    return out
        out = func(*args, **kwargs)
        counts = self.counter.op(func, args, kwargs, out)
        if key is not None and counts is not None:
            layout = _layout(out)
            if layout is not None and all(
                    t.device.type == "meta" for t in _tensors(out)):
                self.memo[key] = (layout, *counts)
        return out


@dataclasses.dataclass
class Trace:
    out: Any  # what fn returned
    counter: CostCounter

    @property
    def peak_bytes(self) -> int:
        """The most bytes live at once beyond the arguments' storages."""
        return self.counter.peak_bytes


def trace_cost(fn, *args, **kwargs) -> Trace:
    """Run ``fn(*args, **kwargs)`` (meta tensors in, so nothing computes)
    and count its FLOPs, bytes, collectives and live-bytes peak; every
    device's work of a mesh program counts together."""
    counter = CostCounter()
    for a in _tensors((args, kwargs)):
        counter._known(a)
    stack = _active()
    stack.append(counter)
    try:
        with _CountingMode(counter):
            out = fn(*args, **kwargs)
    finally:
        stack.pop()
    return Trace(out=out, counter=counter)
