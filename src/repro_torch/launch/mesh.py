"""Production mesh construction — the port of ``repro.launch.mesh``.

A production mesh is an :class:`~repro_torch.distributed.meshes.AbstractMesh`:
axis names and sizes with no devices behind them, which is all the dry run
needs to plan shard shapes and per-device costs.  The reference forces 512
host devices for the same purpose.
"""

from __future__ import annotations

from repro_torch.distributed.meshes import AbstractMesh, SolverMesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16x16 single pod (256 cards) or 2x16x16 multi-pod (512 cards)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(axes, shape)


def make_test_mesh(shape=(2, 4), axes=("data", "model"), devices=None):
    """Small mesh for tests: an :class:`AbstractMesh`, or, given
    ``devices`` (a flat sequence, repeats allowed), a :class:`SolverMesh`
    of them, whose axes are ("data", "model")."""
    if devices is None:
        return AbstractMesh(axes, shape)
    if tuple(axes) != SolverMesh.axis_names:
        raise ValueError(f"a mesh of devices has axes {SolverMesh.axis_names}; got {tuple(axes)}")
    return SolverMesh(devices, shape=tuple(shape))
