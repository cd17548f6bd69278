"""The solver mesh — the port of ``repro.distributed.meshes``'s
``parse_mesh_spec`` / ``make_solver_mesh``.

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

The LM stack's logical-axis rules (``logical_rules``, ``to_physical``,
``named_shardings`` and the sanitizers) are not ported: nothing on the KRR
path uses them.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

#: the solver mesh's axis names: rows shard over "data", blocks over "model"
AXES = ("data", "model")


def _device_count(kind: str) -> int:
    return torch.cuda.device_count() if kind == "cuda" else 1


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
        out = {}
        for group in self._groups(axis):
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
        out = {}
        for group in self._groups(axis):
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
