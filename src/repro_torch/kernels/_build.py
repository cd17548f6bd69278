"""Build the CUDA sources under ``repro_torch/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles, at first use, into its own shared library
``build/lib<name>.so`` beside the package sources::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>.so csrc/<name>.cu

A source with a line ``#define PK_PARTS k`` compiles instead as k
translation units of the same file (``-DPK_PART=0 .. k - 1``, ``-c``), all
at once, linked into the one library (:func:`parts`): ``kernel_matvec.cu``'s
multi-column sweep has one part a width, beside part 0 (the rest of the
file).

The sources are the only input: a library is rebuilt whenever it is older
than any file in ``csrc/``.  The C functions take plain pointers, sizes and
a stream, so no PyTorch header is compiled and a build takes seconds.
:func:`build` starts every ``nvcc`` at once (one per source or part), which
is how ``chip_smoke.py`` builds them all before timing anything.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
TARGET_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
NVCC_FLAGS = (*TARGET_FLAGS, "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
PART_FLAGS = (*TARGET_FLAGS, "-c", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PARTS_LINE = re.compile(r"^#define PK_PARTS (\d+)\b", re.MULTILINE)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, under a lock: a divide-and-conquer
    solve over a mesh launches from one host thread per device."""
    with _count_lock:
        wrapper.launches += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "repro_torch are built from csrc/ on the machine with the card"
    )


def lib_path(name: str) -> pathlib.Path:
    """Where the shared library built from ``csrc/<name>.cu`` lives."""
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    out = lib_path(name)
    if not out.exists():
        return True
    newest_src = max(p.stat().st_mtime for p in CSRC.iterdir() if p.is_file())
    return out.stat().st_mtime < newest_src


def parts(name: str) -> int:
    """Translation units ``csrc/<name>.cu`` is built in: its ``#define
    PK_PARTS k`` (the source checks k against what it instantiates), else 1."""
    found = _PARTS_LINE.search((CSRC / f"{name}.cu").read_text())
    return int(found.group(1)) if found else 1


def _run(cmd: list[str]) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build(names: list[str] | tuple[str, ...], *, force: bool = False) -> dict[str, dict]:
    """Compile every stale ``csrc/<name>.cu`` in parallel (one nvcc each, or
    one a part for a source built in :func:`parts`, then one link).

    Returns ``{name: {"seconds": float, "log": str}}`` for the sources it
    compiled (``-Xptxas -v`` register / shared-memory / spill lines in
    ``log``); an up-to-date library is skipped unless ``force``.  Raises
    ``RuntimeError`` with the compiler's output when any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if not (force or _stale(name)):
            continue
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        src = str(CSRC / f"{name}.cu")
        k = parts(name)
        if k > 1:
            objs = [BUILD_DIR / f"{name}.part{i}.{os.getpid()}.o" for i in range(k)]
            cmds = [[_nvcc(), *PART_FLAGS, f"-DPK_PART={i}", "-o", str(o), src]
                    for i, o in enumerate(objs)]
        else:
            objs, cmds = [], [[_nvcc(), *NVCC_FLAGS, "-o", str(tmp), src]]
        procs[name] = ([_run(c) for c in cmds], objs, tmp, time.perf_counter())
    report, failed = {}, []
    for name, (units, objs, tmp, t0) in procs.items():
        logs = [proc.communicate()[0] for proc in units]
        log = "".join(logs)
        rc = next((proc.returncode for proc in units if proc.returncode), 0)
        if rc == 0 and objs:
            link = _run([_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)])
            log += link.communicate()[0]
            rc = link.returncode
        for o in objs:
            o.unlink(missing_ok=True)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if rc != 0:
            failed.append(f"nvcc for {name}.cu failed ({rc}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib_path(name))  # atomic: readers never see a partial file
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``lib<name>.so``, building it first if stale."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            _libs[name] = lib
        return lib
