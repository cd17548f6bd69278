#!/usr/bin/env python3
"""Instruction mix of the loops of one of the port's CUDA kernels, from its SASS.

    python3 tools/sass_torch_loops.py kernel_multi kernel_matvec_cols_kernel ILb0ELb1ELb1ELi10E

Builds ``src/repro_torch/csrc/<source>.cu`` as the kernels' own build does
(``_build.build``, skipped while the library is current), disassembles the
library with ``cuobjdump -sass`` and, for the first function whose mangled
name contains every given pattern, prints one JSON line per loop (a branch
to a lower address): its address range, its instruction count and the
count of each opcode, the innermost loops first.  ``--sass FILE`` reads a
saved ``cuobjdump -sass`` listing instead.  Building needs nvcc and
cuobjdump (the machine with the card).
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

_INSN = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(.*?);")


def sass_of(source: str) -> str:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    _build.build([source])
    cuobjdump = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(_build.lib_path(source))], check=True,
                          capture_output=True, text=True).stdout


def loops(sass: str, patterns: list[str]) -> tuple[str, list[dict]]:
    for func in re.split(r"\n\s+Function : ", sass)[1:]:
        name = func.split("\n", 1)[0].strip()
        if all(p in name for p in patterns):
            break
    else:
        raise SystemExit(f"no function matches {patterns}")
    insns = []
    for line in func.splitlines():
        m = _INSN.match(line)
        if m:
            text = re.sub(r"^@!?U?P\w+\s+", "", m.group(2).strip())
            insns.append((int(m.group(1), 16), text))
    found = []
    for addr, text in insns:
        target = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
        if target and int(target.group(1), 16) < addr:
            lo = int(target.group(1), 16)
            body = [t for a, t in insns if lo <= a <= addr]
            ops = collections.Counter(t.split()[0].split(".")[0] for t in body)
            found.append({"from": hex(lo), "to": hex(addr), "instructions": len(body),
                          "opcodes": dict(ops.most_common())})
    return name, sorted(found, key=lambda r: r["instructions"])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("source", help="csrc/<source>.cu")
    ap.add_argument("patterns", nargs="+", help="substrings of the function's mangled name")
    ap.add_argument("--sass", help="a saved cuobjdump -sass listing")
    args = ap.parse_args()
    sass = pathlib.Path(args.sass).read_text() if args.sass else sass_of(args.source)
    name, found = loops(sass, args.patterns)
    print(json.dumps({"function": name}))
    for rec in found:
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
