"""The cell a run measures, found by name: its entry of BENCHMARK.json, its
configuration (configs/<config>.json), its traffic (traffic/<traffic>.json),
its limits (limits/<workload>.json) and the per-layer metrics that list it
or report an end-to-end metric it reports (metrics/<name>.py)."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list   # the metric entries of BENCHMARK.json this cell reports
    per_layer: list
    root: Path = ROOT


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, workload: str, e2e_names: set) -> bool:
    """Whether a metric entry belongs to the cell: by its `workloads` list,
    or, without one, where the cell reports the metric it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell `workload` of the checkout at `root`."""
    here = root / HERE.name
    bench = _load_json(root / "BENCHMARK.json")
    entry = {w["name"]: w for w in bench["workloads"]}.get(workload)
    if entry is None:
        raise SystemExit(f"unknown workload {workload!r}")
    cfg = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    config = _load_json(root / cfg["file"])
    traffic = _load_json(here / "traffic" / f"{entry['traffic']}.json")
    limits = _load_json(here / "limits" / f"{workload}.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if reports(m, workload, names)]
    return Cell(workload, int(entry["chips"]), config, traffic, limits, e2e,
                layer, root)


def load_module(kind: str, name: str, root: Path = ROOT):
    """benchmark/<kind>/<name>.py of the checkout at `root` as a module
    (names may hold dots)."""
    path = root / HERE.name / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # pickled functions of it resolve by name
    spec.loader.exec_module(mod)
    return mod
