"""The yardstick itself: the rooflines' counts do not depend on the route
that implements a layer, the reference comparison fails a lower-precision
control and each fault the frame cells can have, and a cell is added by
adding files and a `workloads` entry alone."""
import contextlib
import json
import shutil

import pytest
import torch

from benchmark import program, spec
from benchmark import roofline as R
from benchmark import trace as T
from benchmark.entries import render_photon as RP
from benchmark.faults import FAULTS
from benchmark.reference import frame as RF
from benchmark.reference import scene as RS
from benchmark.scenes import triangle_field
from benchmark.tests.bench_util import TOY, run_toy

# a frame on the BVH engines (K6-K9) and one on K1 over a few primitives
FRAME_CELLS = ["field4m.frame", "cornell_glass.frame"]
DECLARED_FRAME_CELLS = [
    w["name"] for w in json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    ["workloads"] if spec.load_cell(w["name"]).traffic["entry"]
    == "render_photon"]


def _toy_frame(desc, render, use_bvh):
    """One toy frame of the program, its layer counters on → counters."""
    from raytrace_tpu_torch.core import prng
    from raytrace_tpu_torch.renderers import photon

    scene, cam = program.build_scene(desc, "cpu")
    if not use_bvh:
        import dataclasses
        scene = dataclasses.replace(scene, bvh=None, clusters=None)
    counters = T.Counters()
    with T.count_layers(counters):
        photon.render_photon(scene, cam, program.render_config(render),
                             prng.PRNGKey(11, "cpu"))
    return counters


def _work(counters):
    casts = sorted(counters.casts)
    gathers = [(p, q, int(m.sum())) for p, q, m in counters.gathers]
    least = (sum(R.least_s(*R.intersect_work(*c)) for c in casts),
             sum(R.least_s(*R.gather_work(*g)) for g in gathers))
    return casts, gathers, least


def test_roofline_counts_do_not_depend_on_the_route(monkeypatch):
    torch.set_num_threads(2)
    render = dict(spec.load_cell("field4m.frame").config["render"], **TOY)
    desc = triangle_field.describe({"n_triangles": 2048}, 5, 24, 24)
    runs = []
    for engine in ("epoch", "cluster"):
        monkeypatch.setenv("RAYTRACE_TPU_ENGINE", engine)
        runs.append(_work(_toy_frame(desc, render, use_bvh=True)))
    monkeypatch.delenv("RAYTRACE_TPU_ENGINE")
    runs.append(_work(_toy_frame(desc, render, use_bvh=False)))  # K1
    from raytrace_tpu_torch.renderers import photon
    monkeypatch.setattr(photon, "DENSE_GATHER_SLOTS", 1 << 30)  # K4
    runs.append(_work(_toy_frame(desc, render, use_bvh=False)))
    assert runs[0] == runs[1] == runs[2] == runs[3]
    assert runs[0][0] and runs[0][1]


@pytest.mark.parametrize("workload", FRAME_CELLS)
def test_bfloat16_control_fails_the_limit(workload, toy_root):
    """The reference in bfloat16, put in the program's place, reads above
    the cell's limit; the float32 reference against itself reads 0."""
    torch.set_num_threads(2)
    cell = spec.load_cell(workload, toy_root)
    render = dict(cell.config["render"], **TOY)
    scene_p = dict(cell.config["scene"])
    if scene_p["kind"] == "triangle_field":
        scene_p["n_triangles"] = 2048
    desc = spec.load_module("scenes", scene_p["kind"]).describe(
        scene_p, 3, TOY["width"], TOY["height"])
    pix = torch.arange(TOY["width"] * TOY["height"])
    ref, _ = RF.render_pixels(RS.build(desc, "cpu"), render, 77, pix)
    rel, _ = RP.compare(desc, render, 77, pix, ref, torch.device("cpu"))
    assert rel == 0.0
    ctl, _ = RF.render_pixels(RS.build(desc, "cpu", dt=torch.bfloat16),
                              render, 77, pix)
    rel, _ = RP.compare(desc, render, 77, pix, ctl, torch.device("cpu"))
    assert rel > cell.limits["rel_l1"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", FRAME_CELLS)
def test_each_fault_comes_out_not_correct(workload, fault, toy_root):
    with FAULTS[fault]():
        rc, line, err = run_toy(workload, seed=9, root=toy_root)
    assert rc == 0, err
    assert line["correct"] is False
    assert line["checks"]["rel_l1"]["value"] > line["checks"]["rel_l1"][
        "limit"]


def test_a_cell_is_added_by_files_and_an_entry(tmp_path):
    """A configuration and a cell: a config file, a traffic file, a limits
    file and entries in BENCHMARK.json, no other file touched."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    here = root / "benchmark"
    (here / "traffic" / "frame_two_waves.json").write_text(json.dumps(dict(
        json.loads((spec.HERE / "traffic" / "frame.json").read_text()),
        about="two warm-up frames more")))
    (here / "limits" / "cornell_glass.frame_two_waves.json").write_text(
        json.dumps({"rel_l1": 1e-3}))
    bench["configs"].append(dict(
        name="cornell_glass", source="the box", reduced=[], why="a test",
        file="benchmark/configs/cornell_glass.json"))
    bench["workloads"].append(dict(
        name="cornell_glass.frame_two_waves", config="cornell_glass",
        traffic="frame_two_waves", chips=1, why="a test cell"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("cornell_glass.frame_two_waves", root)
    assert cell.traffic["about"] == "two warm-up frames more"
    assert cell.config["render"]["width"] == 512
    rc, line, err = run_toy("cornell_glass.frame_two_waves", root=root)
    assert rc == 0 and line["correct"] is True, err


@pytest.mark.card
@pytest.mark.parametrize("workload", DECLARED_FRAME_CELLS)
def test_tf32_control_fails_the_limit_on_the_card(workload, card):
    """The control the limits are set against: the reference with TF32
    matrix products in the program's place, at a size a test run holds."""
    from benchmark.control import tf32

    cell = spec.load_cell(workload)
    render = dict(cell.config["render"], width=256, height=256,
                  photon_paths=1 << 18)
    scene_p = dict(cell.config["scene"])
    if scene_p["kind"] == "triangle_field":
        scene_p["n_triangles"] = 1 << 18
    desc = spec.load_module("scenes", scene_p["kind"]).describe(
        scene_p, 3, 256, 256)
    pix = torch.arange(256 * 256, device=card)
    with tf32():
        ctl, _ = RF.render_pixels(RS.build(desc, card), render, 77, pix)
    rel, _ = RP.compare(desc, render, 77, pix, ctl, card)
    assert rel > cell.limits["rel_l1"]


@pytest.mark.parametrize("fault", sorted(FAULTS) + ["optimizer_unchanged"])
def test_each_fault_fails_the_step(fault, monkeypatch, toy_root):
    """The step cell's faults: the render's (faults.py) and a step that
    leaves the parameters unchanged."""
    if fault == "optimizer_unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
        ctx = contextlib.nullcontext()
    else:
        ctx = FAULTS[fault]()
    with ctx:
        rc, line, err = run_toy("cornell_glass.step", seed=9, root=toy_root)
    assert rc == 0, err
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS) + ["exchange_left_out"])
def test_each_fault_fails_the_four_rank_frame(fault, toy_root):
    """The four-rank frame on four gloo ranks at toy size, each fault
    planted in every rank's process."""
    rc, line, err = run_toy("field4m.frame_x4", seed=9, root=toy_root,
                            plant=fault)
    assert rc == 0, err
    assert line["correct"] is False, line["checks"]
