"""Toy sizes of the benchmark's cells for the CPU tests, and a copy of the
checkout that also declares the cells of extra_cells.json."""
from __future__ import annotations

import contextlib
import io
import json
import shutil
from pathlib import Path

import torch

from benchmark import run, spec

TOY = dict(width=24, height=24, photon_paths=4096)
EXTRA = Path(__file__).with_name("extra_cells.json")


def shrink(cell):
    cell.config["render"].update(TOY)
    if cell.config["scene"]["kind"] == "triangle_field":
        # the terrain keeps few photons (a deposit needs a second hit):
        # more paths and a wider radius give each toy pixel some
        cell.config["scene"]["n_triangles"] = 2048
        cell.config["render"].update(photon_paths=32768, initial_radius2=1.0)
    cell.traffic.update(check_pixels=256, warmup=1, trace_calls=2)


def checkout(dest: Path) -> Path:
    """A copy of the checkout's BENCHMARK.json and benchmark/ at `dest`,
    with the configurations, cells, metrics and toy limits of
    extra_cells.json added by files and entries alone → `dest`."""
    shutil.copytree(spec.HERE, dest / spec.HERE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    extra = json.loads(EXTRA.read_text())
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        bench[key] += extra[key]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in extra["add_to"]:
            m["workloads"] = m["workloads"] + extra["add_to"][m["name"]]
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    for name, limits in extra["limits"].items():
        (dest / spec.HERE.name / "limits" / f"{name}.json").write_text(
            json.dumps(limits))
    return dest


def run_toy(workload: str, seed: int = 7, trace: int = 0, root=None,
            plant: str | None = None):
    """Run a cell at toy size on the CPU through the harness → (exit code,
    the parsed last line of standard output, standard error); `plant`
    names a fault that a multi-rank cell's processes plant (faults.py)."""
    torch.set_num_threads(2)

    def toy(cell):
        shrink(cell)
        if plant:
            cell.traffic["plant"] = plant
    out, err = io.StringIO(), io.StringIO()
    kw = {} if root is None else {"root": root}
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", "0.5", "--trace", str(trace)],
                      device="cpu", shrink=toy, **kw)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
