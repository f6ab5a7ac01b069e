"""Run one cell of the benchmark once and print its result line.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell, its configuration, traffic, limits and per-layer metrics are
found by name (spec.py). The traffic's `entry` names the module of
benchmark/entries/ that drives the program. With --trace 0 the line holds
the cell's end-to-end metrics, with --trace 1 its per-layer metrics from a
profiled window. Both check the outputs against the plain reference
(reference/) and print each compared number beside its limit, last on
standard error and last in the line. The run exits 2 without a result
where CUDA or the cell's cards are missing, and 3 where a JAX module was
loaded, in this process or in a rank's."""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from benchmark import spec  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "raytrace_tpu"}
CACHE = spec.ROOT / ".benchcache"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device: str = "cuda", shrink=None,
         root=spec.ROOT) -> int:
    """Run the cell of the checkout at `root`; `device` "cpu" and
    `shrink(cell)` (which edits the cell's configuration in place) serve
    the CPU tests at toy sizes."""
    args = parse(argv)
    device_check = device == "cuda"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    cell = spec.load_cell(args.workload, root)
    if shrink is not None:
        shrink(cell)
    import torch

    if device_check and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < cell.chips):
        print(f"{cell.name}: needs {cell.chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    entry = spec.load_module("entries", cell.traffic["entry"], cell.root)
    out = entry.run(cell, args, T0, device)
    bad = forbidden_modules() + out.get("forbidden", [])  # the ranks' too
    if bad:
        print("JAX modules loaded: " + ", ".join(bad), file=sys.stderr)
        return 3
    checks = out["checks"]
    correct = all(c["ok"] for c in checks.values())
    info = dict(out.get("info", {}), card=power_limit() if device_check
                else "cpu")
    print(json.dumps({"info": info}))
    line = dict(correct=correct, attempted=out["attempted"],
                failed=out["failed"], metrics=out["metrics"],
                device=out["device"])
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                      for k, c in checks.items()}
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r}) "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
