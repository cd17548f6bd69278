"""Fault-tolerant checkpointing: atomic and manifest-driven — the port of
``repro.checkpoint.checkpointer``, in its layout (one directory per step):

    <root>/step_00000123.tmp/    # written first
        arrays.npz               # flattened tree leaves ('a||b||c' keys)
        manifest.json            # step, time, keys, dtypes, extra (data cursor ...)
    <root>/step_00000123/        # atomic rename on success

Either package reads the other's checkpoints.  A bf16 leaf is written as
its two bytes (a 2-byte void array, as numpy writes the reference's
``ml_dtypes`` bf16) under the manifest dtype ``"bfloat16"``; ``restore``
rebuilds every leaf in the dtype its manifest names, so bf16 parameters and
optimizer state come back as bf16 (the reference's own ``restore`` hands
them back as raw bytes).  ``device=`` places the restored tensors on one
device.

Elastic restore: ``restore(root, shardings=)`` takes a tree of (mesh,
physical spec) pairs (``distributed.meshes.named_shardings`` /
``sanitized_shardings`` of a ``SolverMesh``) and returns each leaf as a
``ShardedValue``, ``{coord: shard}`` with each shard on its coordinate's
device, cut by the spec's shard shape: a checkpoint written on one mesh
comes back on another.  ``save`` takes such a leaf and writes its global
array, as the reference writes a sharded array through ``np.asarray``.

``latest_step`` / ``restore`` skip ``.tmp`` directories, so a crash
mid-write is never mistaken for a checkpoint.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.meshes import ShardedValue

SEP = "||"


def _flatten(tree) -> dict[str, Any]:
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict) and not isinstance(node, ShardedValue):
            for k, v in node.items():
                walk(v, f"{prefix}{SEP}{k}" if prefix else str(k))
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{SEP}#{i}" if prefix else f"#{i}")
        else:
            flat[prefix] = node

    walk(tree, "")
    return flat


def _unflatten(flat: dict[str, Any]):
    root: dict = {}
    for path, v in flat.items():
        parts = path.split(SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def fix(node):
        if isinstance(node, dict) and node and all(k.startswith("#") for k in node):
            return tuple(fix(node[f"#{i}"]) for i in range(len(node)))
        if isinstance(node, dict):
            return {k: fix(v) for k, v in node.items()}
        return node

    return fix(root)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(the array written, the manifest dtype)."""
    if isinstance(leaf, ShardedValue):
        leaf = leaf.global_array()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
        if a.dtype.name == "bfloat16":  # an ml_dtypes array
            return a.view("V2"), "bfloat16"
    return a, str(a.dtype)


def _to_tensor(a: np.ndarray, dtype: str, dev: torch.device) -> torch.Tensor:
    """The leaf in its manifest dtype: bf16 from its bits, any other dtype
    as numpy stored it."""
    if dtype == "bfloat16":
        a = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(a.copy()).view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def save(root: str, step: int, state: dict, extra: dict | None = None,
         keep_last: int = 3) -> str:
    """Atomically persist ``state`` (a tree of tensors or arrays) and its
    metadata; keep the last ``keep_last`` checkpoints."""
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays, dtypes = {}, {}
    for k, v in _flatten(state).items():
        arrays[k], dtypes[k] = _to_numpy(v)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "time": time.time(),
        "keys": sorted(arrays.keys()),
        "dtypes": dtypes,
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic on POSIX
    _gc(root, keep_last)
    return final


def _gc(root: str, keep_last: int) -> None:
    steps = sorted(
        d for d in os.listdir(root)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(root, d), ignore_errors=True)


def latest_step(root: str) -> int | None:
    if not os.path.isdir(root):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(root)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(root, d, "manifest.json"))
    ]
    return max(steps) if steps else None


def _is_sharding(node) -> bool:
    return (isinstance(node, tuple) and len(node) == 2 and hasattr(node[0], "shard")
            and isinstance(node[1], tuple))


def _reshard(state, shardings):
    """Each leaf of ``state`` cut onto the mesh of its (mesh, spec) pair in
    ``shardings`` (a leaf whose pair is None stays as it is)."""
    if shardings is None:
        return state
    if _is_sharding(shardings):
        mesh, spec = shardings
        return mesh.shard(state, spec)
    if isinstance(state, dict):
        return {k: _reshard(v, shardings[k]) for k, v in state.items()}
    if isinstance(state, tuple):
        return tuple(_reshard(v, sh) for v, sh in zip(state, shardings))
    raise ValueError(f"no (mesh, spec) pair for a leaf: got {shardings!r}")


def restore(root: str, step: int | None = None, *, device="cuda", shardings=None):
    """Load a checkpoint (the latest when ``step`` is None), each leaf in
    its manifest dtype: tensors on ``device``, or, under ``shardings`` (a
    tree of (mesh, physical spec) pairs mirroring the state), each leaf as
    a ``ShardedValue`` on its mesh (elastic relayout).  Returns (state,
    extra, step)."""
    dev = torch.device("cpu") if shardings is not None else resolve_device(device)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    path = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    dtypes = manifest["dtypes"]
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: _to_tensor(z[k], dtypes[k], dev) for k in z.files}
    return _reshard(_unflatten(flat), shardings), manifest["extra"], step
