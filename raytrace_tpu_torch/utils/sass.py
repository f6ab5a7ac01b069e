"""SASS instructions per inner-loop test of a built kernel, from
`cuobjdump -sass` (CUDA toolkit).

    python -m raytrace_tpu_torch.utils.sass epoch_cull [--lib LIB.so]

builds csrc/<name>.cu as the port builds it (or reads LIB.so, the library
another checkout built of it) and prints one JSON line: the kernel's innermost loop that holds the most
marker instructions, its length, the tests it runs (marker count ÷ markers
per test) and instructions per test; and the registers a thread of the
kernel holds (`cuobjdump -res-usage`). A marker occurs a fixed number of
times per test in every version of a kernel: FMUL for the ray-box tests
(6: one product per slab plane), MUFU.RCP for the ray-triangle tests (1:
the reciprocal of det), FMUL for the gather's pair test (9: dist2's three
squares, the three products of n_s·wi and the three weights into S). Needs
nvcc and cuobjdump, so it runs where the card is; a loop the compiler
unrolled counts all its copies.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
from pathlib import Path

from raytrace_tpu_torch.ops import cuda_lib

# kernel → (its __global__ function, marker opcode, markers per test)
KERNELS = {"tri_intersect": ("tri_closest_kernel", "MUFU.RCP", 1),
           "dense_gather": ("dense_gather_kernel", "FMUL", 9),
           "epoch_cull": ("epoch_cull_kernel", "FMUL", 6),
           "epoch_mt": ("epoch_mt_kernel", "MUFU.RCP", 1),
           "cluster_cull": ("cluster_cull_kernel", "FMUL", 6),
           "cluster_pair": ("cluster_pair_kernel", "MUFU.RCP", 1)}

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
# a branch target: an address (cuobjdump) or a label (nvdisasm)
_TARGET = re.compile(r"BRA\S*\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")


def _function_sass(text: str, function: str) -> list[str]:
    """The lines of one function's SASS in `cuobjdump -sass` output."""
    lines, keep = [], False
    for line in text.splitlines():
        if "Function :" in line:
            keep = function in line
            continue
        if keep:
            lines.append(line)
    if not lines:
        raise RuntimeError(f"no SASS for {function}")
    return lines


def loop_report(text: str, function: str, marker: str,
                per_test: int) -> dict:
    """The innermost loop of `function` that holds the most `marker`
    instructions → its instruction count, tests and instructions per test.
    A loop is a branch back to an earlier label; innermost: no other loop's
    back branch lies strictly inside it."""
    instrs, at, labels = [], {}, {}
    for line in _function_sass(text, function):
        m = _LABEL.match(line)
        if m:
            labels[m.group(1)] = len(instrs)
            continue
        m = _INSTR.search(line)
        if m:
            at[int(m.group(1), 16)] = len(instrs)
            instrs.append(m.group(2))
    op = lambda ins: re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]
    loops = []  # (first, last) instruction of each loop
    for i, ins in enumerate(instrs):
        m = _TARGET.search(ins)
        if not (m and op(ins).startswith("BRA")):
            continue
        j = labels.get(m.group(1)) if m.group(1) else at.get(
            int(m.group(2), 16))
        if j is not None and j <= i:
            loops.append((j, i))
    inner = [(a, b) for a, b in loops
             if not any(a <= a2 and b2 <= b and (a2, b2) != (a, b)
                        for a2, b2 in loops)]
    best = None
    for a, b in inner:
        body = instrs[a:b + 1]
        marks = sum(op(x).startswith(marker) for x in body)
        if marks and (best is None or marks > best[2]):
            best = (a, b, marks)
    if best is None:
        raise RuntimeError(f"{function}: no loop holds {marker}")
    a, b, marks = best
    tests = marks / per_test
    return dict(function=function, marker=marker, loop_instructions=b - a + 1,
                tests_per_iteration=tests,
                instructions_per_test=(b - a + 1) / tests)


def registers(text: str, function: str) -> int:
    """Registers per thread of `function` in `cuobjdump -res-usage`
    output."""
    lines = text.splitlines()
    for i, line in enumerate(lines):
        if "Function " in line and function in line:
            m = re.search(r"REG:(\d+)", " ".join(lines[i:i + 2]))
            if m:
                return int(m.group(1))
    raise RuntimeError(f"no resource usage for {function}")


def report(name: str, lib: Path | None = None) -> dict:
    function, marker, per_test = KERNELS[name]
    lib = lib or cuda_lib.build(name)
    cuobjdump = os.path.join(os.path.dirname(cuda_lib.nvcc_path()),
                             "cuobjdump")
    dump = lambda flag: subprocess.run([cuobjdump, flag, str(lib)],
                                       check=True, capture_output=True,
                                       text=True).stdout
    return dict(kernel=name, lib=str(lib),
                **loop_report(dump("-sass"), function, marker, per_test),
                registers=registers(dump("-res-usage"), function))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("name", choices=sorted(KERNELS))
    ap.add_argument("--lib", type=Path)
    args = ap.parse_args()
    print(json.dumps(report(args.name, args.lib)))


if __name__ == "__main__":
    main()
