"""Meshes and logical-axis rules — the port of ``repro.distributed.meshes``:
the solver mesh (``parse_mesh_spec`` / ``make_solver_mesh``) and the rules
that map logical axes onto a mesh.

One process drives a ``(rows, model)`` array of ``torch.device``s: a single
controller, as the JAX package's ``solve(problem, mesh=mesh)`` is.  There are
no ranks: a value inside a mapped body is a dict from mesh coordinate
``(i, j)`` to a tensor on that coordinate's device, and the mesh owns the two
collectives the solver stack needs, made of ``Tensor.to(device,
non_blocking=True)``, ``torch.cat`` and sums:

  * :meth:`SolverMesh.all_gather` — concatenate the shards of an axis in
    shard order, on every device of the axis;
  * :meth:`SolverMesh.psum` — add the partials of an axis in shard order on
    the first shard's device, then place the sum on every device of the axis.

A size-1 axis issues nothing, and the fixed order makes two runs of one mesh
bitwise equal.  The device list may repeat a device: ``cpu`` x 4 is the
counterpart of the JAX package's forced host device count (the tests), and
``cuda:0`` x 4 runs the multi-shard code on one card.  Every device of a
mesh has one type, so a copy between two of them never crosses to the host.

Each collective adds one device's operand bytes, by kind ("all-gather",
"all-reduce"), to the dry run's active cost counter
(``roofline.analyze.record_collective``): the counterpart of the
reference's collective parse of the HLO.  A mesh of ``meta`` devices runs
a mapped body on shapes alone (the dry run's KRR cell).

Logical axes.  Models annotate arrays with *logical* axes ("dp", "fsdp",
"tp"); a rule set maps them onto whatever physical mesh is live:

  single pod (16, 16) ("data", "model"):   dp=("data",), fsdp="data", tp="model"
  multi-pod (2, 16, 16) ("pod","data","model"):
                                            dp=("pod","data"), fsdp="data", tp="model"

A spec is a tuple of names, ``None`` or tuples of names (``param_pspecs``
gives them); a "sharding" is the pair (mesh, physical spec).  The rules
read only a mesh's ``axis_names`` and ``shape`` (axis name -> size), so
they serve a :class:`SolverMesh` and an :class:`AbstractMesh` alike: the
latter is a mesh of axis sizes without devices, the counterpart of the
reference's 512 forced host devices, which is all a planner needs.  Keeping
models in logical axes is what makes elastic re-meshing (a checkpoint
restored onto another topology, ``checkpoint.checkpointer.restore(
shardings=)``) a launcher's concern.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.roofline.analyze import record_collective

_STATE = threading.local()

#: the solver mesh's axis names: rows shard over "data", blocks over "model"
AXES = ("data", "model")


def _shard_shape(sizes: dict, spec: tuple, global_shape) -> tuple[int, ...]:
    """Per-device shape of ``global_shape`` laid out by the physical
    ``spec`` over axes of ``sizes``; raises where an axis product does not
    divide its dim (sanitize the spec first) or an axis is unknown."""
    global_shape = tuple(int(s) for s in global_shape)
    if len(spec) > len(global_shape):
        raise ValueError(f"spec {spec} has more entries than shape {global_shape}")
    out = []
    for dim, entry in zip(global_shape, tuple(spec) + (None,) * (len(global_shape) - len(spec))):
        if entry is None:
            out.append(dim)
            continue
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        unknown = [a for a in axes if a not in sizes]
        if unknown:
            raise ValueError(f"mesh axes {tuple(sizes)} have no axis {unknown[0]!r}")
        total = math.prod(sizes[a] for a in axes)
        if dim % total:
            raise ValueError(f"dim {dim} of shape {global_shape} does not divide over "
                             f"{total} shards of {axes} (spec {spec})")
        out.append(dim // total)
    return tuple(out)


class AbstractMesh:
    """A mesh of axis sizes and no devices: what the dry run plans on.

    ``axis_names`` / ``shape`` (axis name -> size) as on a
    :class:`SolverMesh`; ``size`` is the device count."""

    def __init__(self, axis_names, shape):
        if len(axis_names) != len(shape) or not axis_names:
            raise ValueError(f"axis names {axis_names} do not match shape {shape}")
        self.axis_names = tuple(axis_names)
        self.shape = {a: int(s) for a, s in zip(self.axis_names, shape)}
        self.size = math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"

    def shard_shape(self, spec: tuple, global_shape) -> tuple[int, ...]:
        """Per-device shape of ``global_shape`` under the physical ``spec``."""
        return _shard_shape(self.shape, spec, global_shape)


class ShardedValue(dict):
    """A global array laid out on a :class:`SolverMesh` by a physical spec:
    the mesh's representation of a mapped value, ``{coord: shard}`` with
    each shard on its coordinate's device, plus the layout that cut it."""

    def __init__(self, mesh: "SolverMesh", spec: tuple, global_shape, parts: dict):
        super().__init__(parts)
        self.mesh, self.spec, self.global_shape = mesh, tuple(spec), tuple(global_shape)

    def global_array(self, device="cpu") -> torch.Tensor:
        """The global array assembled on ``device``."""
        first = next(iter(self.values()))
        out = torch.empty(self.global_shape, dtype=first.dtype, device=device)
        for c, part in self.items():
            out[self.mesh._slices(self.spec, self.global_shape, c)] = part.to(device)
        return out


def _device_count(kind: str) -> int:
    return torch.cuda.device_count() if kind == "cuda" else 1


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class SolverMesh:
    """A ``(rows, model)`` grid of ``torch.device``s with axis names
    ``("data", "model")``.

    ``devices`` is a nested ``(rows, model)`` sequence of devices (or device
    strings), or a flat sequence with ``shape=(rows, model)``.  Repeats are
    allowed.  ``mesh.devices`` is the numpy object array of devices,
    ``mesh.shape`` the dict ``{"data": rows, "model": model}``.
    """

    axis_names = AXES

    def __init__(self, devices, shape: tuple[int, int] | None = None):
        flat = [torch.device(d) for d in np.asarray(devices, dtype=object).reshape(-1)]
        if shape is None:
            shape = np.asarray(devices, dtype=object).shape
        if len(shape) != 2 or shape[0] * shape[1] != len(flat) or not flat:
            raise ValueError(
                f"a solver mesh needs a (rows, model) grid of devices; got "
                f"{len(flat)} device(s) for shape {tuple(shape)}"
            )
        kinds = {d.type for d in flat}
        if len(kinds) != 1:
            raise ValueError(f"a mesh's devices must have one type; got {sorted(kinds)}")
        for d in flat:
            resolve_device(d)  # cuda without a card raises
        grid = np.empty(len(flat), dtype=object)
        grid[:] = flat
        self.devices = grid.reshape(int(shape[0]), int(shape[1]))
        self.shape = {"data": int(shape[0]), "model": int(shape[1])}

    def __repr__(self) -> str:
        return f"SolverMesh(shape={self.shape}, devices={[str(d) for d in self.devices.flat]})"

    @property
    def home(self) -> torch.device:
        """The first device: global views of row-sharded arrays and
        replicated results live here."""
        return self.devices[0, 0]

    def coords(self) -> list[tuple[int, int]]:
        """Every mesh coordinate ``(i, j)`` in row-major order."""
        rows, model = self.devices.shape
        return [(i, j) for i in range(rows) for j in range(model)]

    @property
    def size(self) -> int:
        """The device count of the grid (repeats included)."""
        return self.devices.size

    def shard_shape(self, spec: tuple, global_shape) -> tuple[int, ...]:
        """Per-device shape of ``global_shape`` under the physical ``spec``."""
        return _shard_shape(self.shape, spec, global_shape)

    def _slices(self, spec: tuple, global_shape, coord) -> tuple[slice, ...]:
        """Coordinate ``coord``'s block of ``global_shape`` under ``spec``:
        an entry's axes index the block in row-major order over them."""
        local = self.shard_shape(spec, global_shape)
        at = dict(zip(self.axis_names, coord))
        out = []
        for size, entry in zip(local, tuple(spec) + (None,) * (len(local) - len(spec))):
            axes = () if entry is None else (
                entry if isinstance(entry, (tuple, list)) else (entry,))
            k = 0
            for a in axes:
                k = k * self.shape[a] + at[a]
            out.append(slice(k * size, (k + 1) * size))
        return tuple(out)

    def shard(self, t: torch.Tensor, spec: tuple) -> ShardedValue:
        """``t`` cut by the physical ``spec``: each coordinate's block on its
        device (one copy per distinct (device, block))."""
        seen: dict = {}
        parts = {}
        for c in self.coords():
            sl = self._slices(spec, t.shape, c)
            key = (self.device(c), tuple((s.start, s.stop) for s in sl))
            if key not in seen:
                seen[key] = t[sl].to(self.device(c)).contiguous()
            parts[c] = seen[key]
        return ShardedValue(self, spec, t.shape, parts)

    def device(self, coord: tuple[int, int]) -> torch.device:
        """The device at mesh coordinate ``coord``."""
        return self.devices[coord]

    def each(self, fn) -> dict:
        """``{coord: fn(coord)}`` over the mesh (a mapped body's value)."""
        return {c: fn(c) for c in self.coords()}

    def replicate(self, t: torch.Tensor) -> dict:
        """``t`` on every mesh device (one copy per distinct device)."""
        per_dev: dict[torch.device, torch.Tensor] = {}
        out = {}
        for c in self.coords():
            dev = self.device(c)
            if dev not in per_dev:
                per_dev[dev] = t.to(dev, non_blocking=True)
            out[c] = per_dev[dev]
        return out

    def _groups(self, axis: str) -> list[list[tuple[int, int]]]:
        rows, model = self.devices.shape
        if axis == "data":
            return [[(i, j) for i in range(rows)] for j in range(model)]
        if axis == "model":
            return [[(i, j) for j in range(model)] for i in range(rows)]
        raise ValueError(f"unknown mesh axis {axis!r}; accepted: {AXES}")

    def all_gather(self, parts: dict, axis: str, dim: int = 0) -> dict:
        """Concatenate each group's shards along ``dim`` in shard order and
        place the result on every device of the group.  A size-1 axis
        returns ``parts`` as they are."""
        if self.shape[axis] == 1:
            return dict(parts)
        groups = self._groups(axis)
        record_collective("all-gather", _nbytes(parts[groups[0][0]]))
        out = {}
        for group in groups:
            per_dev: dict[torch.device, torch.Tensor] = {}
            for c in group:
                dev = self.device(c)
                if dev not in per_dev:
                    per_dev[dev] = torch.cat(
                        [parts[g].to(dev, non_blocking=True) for g in group], dim=dim)
                out[c] = per_dev[dev]
        return out

    def psum(self, parts: dict, axis: str) -> dict:
        """Sum each group's partials in shard order on its first device and
        place the sum on every device of the group.  A size-1 axis returns
        ``parts`` as they are."""
        if self.shape[axis] == 1:
            return dict(parts)
        groups = self._groups(axis)
        record_collective("all-reduce", _nbytes(parts[groups[0][0]]))
        out = {}
        for group in groups:
            acc = parts[group[0]]
            for c in group[1:]:
                acc = acc + parts[c].to(acc.device, non_blocking=True)
            for c in group:
                out[c] = acc.to(self.device(c), non_blocking=True)
        return out


def parse_mesh_spec(spec: str, device: str = "cuda") -> tuple[int, int]:
    """Parse a ``--mesh ROWSxMODEL`` spec ("4x2" -> (4, 2)).

    "auto" (or "") puts every visible device of ``device``'s type on the row
    axis: every CUDA device, or the one CPU.
    """
    if spec in ("auto", ""):
        kind = resolve_device(device).type
        return (max(_device_count(kind), 1), 1)
    parts = spec.lower().split("x")
    if len(parts) != 2 or not all(p.isdigit() and int(p) > 0 for p in parts):
        raise ValueError(
            f"mesh spec {spec!r} invalid; accepted: 'ROWSxMODEL' with "
            f"positive integers (e.g. '4x2') or 'auto'"
        )
    return (int(parts[0]), int(parts[1]))


def make_solver_mesh(spec: str | tuple[int, int] | None = None,
                     device: str = "cuda") -> SolverMesh:
    """("data", "model") mesh of distinct devices for distributed KRR solves.

    ``spec``: "ROWSxMODEL" string, (rows, model) tuple, or None/"auto" for
    every visible device on rows.  ``device`` is ``"cuda"`` (the default:
    ``cuda:0 .. cuda:D-1``; raises without a card) or ``"cpu"`` (one CPU
    device, so only a (1, 1) mesh).  A spec larger than the device count
    raises; a mesh that repeats a device is built with :class:`SolverMesh`
    directly.
    """
    if spec is None or isinstance(spec, str):
        rows, model = parse_mesh_spec(spec if isinstance(spec, str) else "auto", device)
    else:
        rows, model = (int(s) for s in spec)
    kind = resolve_device(device).type
    have = _device_count(kind)
    if rows * model > have:
        raise ValueError(
            f"mesh {rows}x{model} needs {rows * model} {kind} device(s); "
            f"{have} visible"
        )
    devs = [torch.device("cpu")] if kind == "cpu" else [
        torch.device("cuda", i) for i in range(rows * model)]
    return SolverMesh(devs, shape=(rows, model))


# ---------------------------------------------------------------------------
# logical-axis rules
# ---------------------------------------------------------------------------


def default_rules(mesh) -> dict[str, Any]:
    """The logical -> physical axis map of ``mesh`` (reads its axis names)."""
    axes = mesh.axis_names
    if "pod" in axes:
        return {"dp": ("pod", "data"), "fsdp": "data", "tp": "model"}
    if "data" in axes:
        return {"dp": ("data",), "fsdp": "data", "tp": "model"}
    # degenerate single-axis test meshes
    ax = axes[0]
    return {"dp": (ax,), "fsdp": ax, "tp": None}


@contextlib.contextmanager
def logical_rules(rules: dict[str, Any]):
    """Install ``rules`` for this thread; the previous set comes back on exit."""
    prev = getattr(_STATE, "rules", None)
    _STATE.rules = rules
    try:
        yield
    finally:
        _STATE.rules = prev


def current_rules() -> dict[str, Any] | None:
    return getattr(_STATE, "rules", None)


def to_physical(spec: tuple, rules: dict[str, Any] | None = None) -> tuple:
    """Translate a logical spec to physical mesh axes (``spec`` unchanged
    without rules)."""
    rules = rules or current_rules()
    if rules is None:
        return tuple(spec)
    out: list = []
    for entry in spec:
        if entry is None:
            out.append(None)
        elif isinstance(entry, (tuple, list)):
            phys: list[str] = []
            for e in entry:
                r = rules.get(e, e)
                if r is None:
                    continue
                phys.extend(r if isinstance(r, (tuple, list)) else (r,))
            out.append(tuple(phys) if phys else None)
        else:
            r = rules.get(entry, entry)
            if r is None:
                out.append(None)
            elif isinstance(r, (tuple, list)):
                out.append(tuple(r))
            else:
                out.append(r)
    return tuple(out)


def logical_constraint(x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """The reference's sharding hint in logical axes: ``x`` itself, once
    ``spec`` translates under the installed rules.  The port runs no
    sharded LM program, so there is nothing for the hint to steer."""
    rules = current_rules()
    if rules is not None:
        to_physical(spec, rules)
    return x


def _map_specs(fn, spec_tree, *others):
    """``fn(spec, *other_leaves)`` over a nested dict of specs."""
    if isinstance(spec_tree, dict):
        return {k: _map_specs(fn, v, *(o[k] for o in others)) for k, v in spec_tree.items()}
    return fn(spec_tree, *others)


def tree_to_physical(spec_tree, rules: dict[str, Any] | None = None):
    return _map_specs(lambda s: to_physical(s, rules), spec_tree)


def named_shardings(mesh, spec_tree, rules: dict[str, Any] | None = None):
    """A tree of (mesh, physical spec) pairs."""
    rules = rules or default_rules(mesh)
    return _map_specs(lambda s: (mesh, to_physical(s, rules)), spec_tree)


def sanitize_pspec(spec: tuple, shape: tuple[int, ...], mesh) -> tuple:
    """Drop sharded axes that don't divide the dim (e.g. batch=1 decode)."""
    sizes = dict(mesh.shape)
    out: list = []
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        total = 1
        for a in axes:
            total *= sizes.get(a, 1)
        out.append(entry if dim % total == 0 else None)
    return tuple(out)


def sanitized_shardings(mesh, spec_tree, struct_tree, rules: dict[str, Any] | None = None):
    """named_shardings + per-dim divisibility sanitation against the
    struct tree's shapes (tensors, meta tensors or shapes)."""
    rules = rules or default_rules(mesh)

    def one(spec, struct):
        shape = tuple(struct.shape) if hasattr(struct, "shape") else tuple(struct)
        return mesh, sanitize_pspec(to_physical(spec, rules), shape, mesh)

    return _map_specs(one, spec_tree, struct_tree)
