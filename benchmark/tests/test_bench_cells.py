"""Every cell of BENCHMARK.json, and each cell of extra_cells.json that
drives another entry, runs at toy size on the CPU through the harness and
prints the contract's last line; no JAX module is loaded, in the run's
process or in a rank's."""
import json
import subprocess
import sys

import pytest

from benchmark import spec
from benchmark.tests.bench_util import EXTRA, run_toy

WORKLOADS = [w["name"] for w in
             json.loads((spec.ROOT / "BENCHMARK.json").read_text())
             ["workloads"]]
EXTRA_WORKLOADS = [w["name"] for w in json.loads(EXTRA.read_text())
                   ["workloads"]]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", WORKLOADS + EXTRA_WORKLOADS)
def test_cell_runs_at_toy_size(workload, trace, toy_root):
    rc, line, err = run_toy(workload, seed=2**31 + 11, trace=trace,
                            root=toy_root)
    assert rc == 0, err
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    cell = spec.load_cell(workload, toy_root)
    want = ({m["name"] for m in cell.end_to_end} if not trace else set())
    assert want <= set(line["metrics"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for name, c in line["checks"].items():
        assert f"check {name}:" in err


def test_no_jax_module_is_loaded():
    code = ("import sys; from benchmark.tests.bench_util import run_toy; "
            "rc, line, err = run_toy('field4m.frame'); "
            "from benchmark.run import forbidden_modules; "
            "print(rc, line['correct'], forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.stdout.strip().splitlines()[-1] == "0 True []", out.stderr


def test_jax_in_a_rank_gives_no_result(toy_root):
    """A JAX module that only the ranks' processes hold is found: the run
    exits 3 and prints no result."""
    rc, line, err = run_toy("field4m.frame_x4", seed=5, root=toy_root,
                            plant="jax_loaded")
    assert rc == 3
    assert line is None or "correct" not in line
    assert "rank 0: jax" in err and "rank 3: jax" in err


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    from benchmark import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", WORKLOADS[0], "--seed", "1", "--seconds",
                   "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_forbidden_names_compare_whole_top_level(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "raytrace_tpu_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    found = run.forbidden_modules()
    assert "jaxlib.xla_client" in found
    assert "raytrace_tpu_torch_like" not in found
    assert not [m for m in found if m.split(".")[0] == "raytrace_tpu_torch"]
