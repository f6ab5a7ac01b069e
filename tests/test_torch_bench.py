"""The port's harness (raytrace_tpu_torch/bench.py) on the CPU: each cell's
RenderConfig equals the one the JAX package's bench.py builds for the same
cell and sizes, every cell runs at toy sizes with every check true, the
headline's frame is render_photon's bit for bit, the resume probe catches a
changed checkpoint, the harness refuses to run without a card unless asked
for the CPU, and `python -m raytrace_tpu_torch.bench` prints its last
line."""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import raytrace_tpu.diff.render as j_diff
import raytrace_tpu.renderers.photon as j_photon
import raytrace_tpu.renderers.simple as j_simple
from raytrace_tpu.core.config import RenderConfig as JConfig
from raytrace_tpu_torch import bench
from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.renderers import photon
from raytrace_tpu_torch.scene import presets
from raytrace_tpu_torch.utils import checkpoint
from raytrace_tpu_torch.utils.timing import union_us

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, PATHS, NTRIS, PASSES, REPS = 16, 256, 1 << 11, 4, 2
TOY = ["--cpu", "--size", str(SIZE), "--paths", str(PATHS), "--ntris",
       str(NTRIS), "--passes", str(PASSES), "--reps", str(REPS), "--ranks",
       "2"]


@pytest.fixture(scope="module")
def jax_bench():
    """The JAX package's bench.py, loaded from its path under another name
    than `bench`."""
    spec = importlib.util.spec_from_file_location(
        "jax_package_bench", os.path.join(ROOT, "bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Caught(Exception):
    pass


def _raise_config(*args, **kwargs):
    raise _Caught(next(a for a in (*args, *kwargs.values())
                       if isinstance(a, JConfig)))


# cell → (the JAX callee bench.py imports inside the cell's function, its
# call of that function at the toy sizes)
JAX_CELLS = {
    "headline": (j_photon, "render_photon",
                 lambda b: b.run_once(SIZE, PATHS)),
    "grad": (j_diff, "loss_and_grad", lambda b: b.run_grad(SIZE, PATHS)),
    "multiwave": (j_photon, "_ppm_setup",
                  lambda b: b.run_multiwave(SIZE, PATHS, PASSES)),
    "combined": (j_photon, "render_photon",
                 lambda b: b.run_combined(NTRIS, PATHS, SIZE)),
    "combined_multiwave": (j_photon, "_ppm_setup",
                           lambda b: b.run_combined_multiwave(
                               NTRIS, PATHS, SIZE, PASSES)),
    "triangle_field": (j_simple, "render_simple",
                       lambda b: b.run_triangle_field(NTRIS, SIZE)),
}
# bench.py builds run_scaling's config only with two devices or more
# visible (bench.py:436-437): its values (bench.py:443-448)
SCALING = JConfig(width=256, height=256, spp=1, scene_epsilon=1e-3,
                  photon_paths=1 << 16, photon_passes=1, max_photon_bounces=8)


@pytest.mark.parametrize("cell", list(bench.CELLS))
def test_settings_held_to_bench_py(cell, jax_bench, monkeypatch):
    if cell in JAX_CELLS:
        module, callee, call = JAX_CELLS[cell]
        monkeypatch.setattr(module, callee, _raise_config)
        with pytest.raises(_Caught) as caught:
            call(jax_bench)
        want = caught.value.args[0]
        got = bench.cell_config(cell, SIZE, PATHS, PASSES)
    else:
        want, got = SCALING, bench.cell_config(cell)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _lines(capsys) -> list:
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


# a metric each cell reports under bench.py's name
BENCH_KEYS = {
    "headline": "camera_rays_per_sec_full_ppm_pipeline",
    "grad": "grad_rays_per_s",
    "multiwave": "ppm_multiwave_photons_per_s",
    "combined": "ppm_4mtri_16mphotons_rays_per_s",
    "combined_multiwave": "ppm_4mtri_16mphotons_multiwave_resume_ok",
    "triangle_field": "triangle_field_rays_per_s",
    "scaling": "scaling_rays_per_s",
    "scaling_cpu": "scaling_efficiency_cpu_virtual",
}


@pytest.mark.parametrize("cell", list(bench.CELLS))
def test_cell_at_toy_size(cell, capsys):
    assert bench.main(["--cell", cell, *TOY]) == 0
    line, last = _lines(capsys)
    assert line["cell"] == cell and line["checks"]
    assert all(line["checks"].values())
    assert last["ok"] and last["seed"] == 0 and last["device"] == "cpu"
    assert set(last["cells"]) == {cell}
    metrics = last["cells"][cell]["metrics"]
    assert metrics == line["metrics"]
    assert set(last["cells"][cell]["units"]) == set(metrics)
    assert BENCH_KEYS[cell] in metrics
    assert last["checks"] == {f"{cell}.{k}": v
                              for k, v in line["checks"].items()}
    timings = [v for v in metrics.values()
               if isinstance(v, dict) and "median" in v]
    for t in timings:
        assert set(t) == {"median", "min", "max", "n"}
        assert t["min"] <= t["median"] <= t["max"]
    if cell == "scaling":
        assert set(metrics["scaling_rays_per_s"]) == {"1"}
    elif cell == "scaling_cpu":
        assert set(metrics["scaling_rays_per_s_cpu_virtual"]) == {"1", "2"}
    else:
        assert timings[0]["n"] == (REPS if "multiwave" not in cell
                                   else PASSES - 1)


def test_headline_frame_is_render_photons(monkeypatch, capsys):
    frames, render = [], photon.render_photon

    def recorded(*args, **kwargs):
        out = render(*args, **kwargs)
        frames.append((args[3], out[0]))
        return out

    monkeypatch.setattr(photon, "render_photon", recorded)
    assert bench.main(["--cell", "headline", "--seed", "3", *TOY]) == 0
    scene, cam = presets.cornell_box("cpu", SIZE, ball="glass")
    cfg = bench.cell_config("headline", SIZE, PATHS)
    # the warm-up (key 3), then the timed calls (keys 4, 5)
    assert len(frames) >= 1 + REPS
    for i, (key, img) in enumerate(frames[:1 + REPS]):
        assert torch.equal(key, prng.PRNGKey(3 + i, "cpu"))
        want = render(scene, cam, cfg, prng.PRNGKey(3 + i, "cpu"))
        assert torch.equal(img, want)


@pytest.mark.parametrize("tamper", [False, True])
def test_resume_probe(tamper, monkeypatch, capsys):
    """resume_ok holds at toy size; a flux value changed in the saved
    checkpoint makes it false and the run exit 1."""
    save = checkpoint.save_progressive

    def save_changed(path, state, *args, **kwargs):
        save(path, state, *args, **kwargs)
        with np.load(path) as z:
            data = dict(z)
        data["flux"].flat[np.argmax(data["flux"])] += 1.0
        with open(path, "wb") as f:
            np.savez(f, **data)

    if tamper:
        monkeypatch.setattr(checkpoint, "save_progressive", save_changed)
    argv = ["--cell", "combined_multiwave", *TOY, "--paths", str(1 << 12)]
    assert bench.main(argv) == (1 if tamper else 0)
    line, last = _lines(capsys)
    m = line["metrics"]
    assert m["ppm_4mtri_16mphotons_multiwave_resume_ok"] is (not tamper)
    assert m["resume_unequal_fields"] == (["flux"] if tamper else [])
    assert m["resume_pass"] == PASSES // 2
    assert last["checks"]["combined_multiwave.resume_ok"] is (not tamper)
    assert last["ok"] is (not tamper)
    trace = m["ppm_4mtri_16mphotons_multiwave_radius2_trace"]
    assert len(trace) == PASSES and trace[-1] < trace[0]


@pytest.mark.parametrize("spans,want", [
    ([], 0.0), ([(0.0, 2.0), (5.0, 6.0)], 3.0),
    ([(1.0, 3.0), (0.0, 2.0), (5.0, 6.0)], 4.0), ([(0.0, 10.0), (2.0, 3.0)],
                                                  10.0)])
def test_device_busy_counts_overlaps_once(spans, want):
    """Device busy is the union of the records' intervals: kernels on two
    streams that overlap count once."""
    assert union_us(spans) == want


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--cell", "headline", "--size", str(SIZE)])


def test_module_entry_point():
    """`python -m raytrace_tpu_torch.bench` on the scaling cell: the rank
    it spawns finds its function by import path, and the last line
    parses."""
    out = subprocess.run(
        [sys.executable, "-m", "raytrace_tpu_torch.bench", "--cell",
         "scaling", *TOY], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    last = json.loads(out.stdout.splitlines()[-1])
    assert last["ok"] and last["device"] == "cpu"
    assert last["cells"]["scaling"]["metrics"]["scaling_devices"] == 1
