"""BASELINE config[2] on the BVH path: the glass Cornell box with the ball as
an icosphere mesh (benchmark/scenes/caustic_glass_mesh.py), at a toy size
that still builds a BVH and a cluster set (3 levels: 1,290 triangles with
the box). The port's frame against the plain reference
(benchmark/reference/) within the cell's limit, with specular chains past
depth 1 and both overflows 0; the chain's hits on the BVH route against the
dense route on the same rays; the chain's span and counters
(utils/metrics.py) under a profiler and without one."""
from __future__ import annotations

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import program, spec
from benchmark.reference import frame as RF
from benchmark.reference import scene as RS
from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.renderers import common, photon
from raytrace_tpu_torch.scene.camera import generate_rays, pixel_samples
from raytrace_tpu_torch.utils import metrics

CELL = "caustic_glass_mesh.frame"
SIZE = 24
PATHS = 4096
WORD = 0x5EED2026


@pytest.fixture(scope="module")
def toy():
    """(description, the port's scene and camera, the render block) of the
    cell's configuration at 3 levels, 24², 4,096 paths."""
    torch.set_num_threads(2)
    cfg = spec.load_cell(CELL).config
    scene_p = dict(cfg["scene"], subdivisions=3)
    desc = spec.load_module("scenes", scene_p["kind"]).describe(
        scene_p, 0, SIZE, SIZE)
    render = dict(cfg["render"], width=SIZE, height=SIZE, photon_paths=PATHS)
    scene, cam = program.build_scene(desc, "cpu")
    assert scene.clusters is not None  # the BVH path
    assert scene.tris.count == 1290
    return desc, scene, cam, render


@pytest.fixture
def chain_casts(monkeypatch):
    """Every intersect call of the camera walk past depth 0, recorded as
    (o, d, tmin, tmax, hit) while the fixture is active."""
    calls = []
    real = common.isect_ops.intersect

    def record(scene, o, d, tmin, tmax, *a, **k):
        hit = real(scene, o, d, tmin, tmax, *a, **k)
        calls.append((o, d, tmin, tmax, hit))
        return hit

    def walk(*a, **k):
        calls.append(None)  # the walk starts: the next call is depth 0
        return real_walk(*a, **k)

    real_walk = common._camera_walk
    monkeypatch.setattr(common.isect_ops, "intersect", record)
    monkeypatch.setattr(common, "_camera_walk", walk)

    def chain():
        out, depth = [], None
        for c in calls:
            if c is None:
                depth = 0
            elif depth is not None:
                if depth >= 1:
                    out.append(c)
                depth += 1
        return out
    return chain


def camera(scene, cam, render, key_word: int):
    config = program.render_config(render)
    keys = prng.split(prng.PRNGKey(key_word, "cpu"), 3)
    xy, lens = pixel_samples(keys[0], config.width, config.height,
                             config.spp)
    rays = generate_rays(cam, xy, lens, config.spp)
    return common.camera_pass(scene, rays.o, rays.d, config, rays=rays)


def test_frame_matches_the_reference(toy):
    desc, scene, cam, render = toy
    metrics.COUNTERS.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        img, aux = photon.render_photon(
            scene, cam, program.render_config(render),
            prng.PRNGKey(WORD, "cpu"), return_aux=True)
    assert metrics.COUNTERS["chain_depths"] >= 2  # lanes past depth 1
    assert int(aux["pair_overflow"]) == 0
    assert int(aux["gather_overflow"]) == 0
    pix = torch.arange(SIZE * SIZE)
    ref, _ = RF.render_pixels(RS.build(desc, "cpu"), render, WORD, pix)
    got = img.reshape(-1, 3)[pix].double()
    rel = float((got - ref).abs().sum() / ref.abs().sum())
    assert rel <= spec.load_cell(CELL).limits["rel_l1"], rel
    assert float(ref.abs().sum()) > 0


def test_bfloat16_reference_fails_the_limit(toy):
    """The limit is tight enough to catch a lower precision: the reference
    in bfloat16 reads above it against the float32 reference."""
    desc, _, _, render = toy
    pix = torch.arange(SIZE * SIZE)
    ref, _ = RF.render_pixels(RS.build(desc, "cpu"), render, WORD, pix)
    low, _ = RF.render_pixels(RS.build(desc, "cpu", dt=torch.bfloat16),
                              render, WORD, pix)
    rel = float((low.double() - ref).abs().sum() / ref.abs().sum())
    assert rel > spec.load_cell(CELL).limits["rel_l1"], rel


def test_chain_hits_equal_the_dense_route(toy, chain_casts):
    from raytrace_tpu_torch.ops import intersect as isect_ops

    _, scene, cam, render = toy
    camera(scene, cam, render, WORD + 1)
    casts = chain_casts()
    assert len(casts) >= 2
    dense = dataclasses.replace(scene, bvh=None, clusters=None)
    for o, d, tmin, tmax, hit in casts:
        ref = isect_ops.intersect(dense, o, d, tmin, tmax)
        assert torch.equal(hit.valid, ref.valid)
        assert torch.equal(hit.mat, ref.mat)
        v = hit.valid
        torch.testing.assert_close(hit.t[v], ref.t[v], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(hit.ng[v], ref.ng[v], rtol=0, atol=1e-5)


def test_chain_span_and_counters(toy, chain_casts):
    _, scene, cam, render = toy
    metrics.COUNTERS.clear()
    camera(scene, cam, render, WORD + 2)
    assert not metrics.COUNTERS  # no profiler: nothing counted
    n_before = len(chain_casts())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        camera(scene, cam, render, WORD + 2)
    casts = chain_casts()[n_before:]
    assert casts
    assert metrics.COUNTERS["chain_lanes"] == sum(c[0].shape[0]
                                                  for c in casts)
    assert metrics.COUNTERS["chain_depths"] == len(casts)
    spans = [e for e in prof.events() if e.name == "rt.frame.camera.chain"]
    cams = [e for e in prof.events() if e.name == "rt.frame.camera"]
    assert len(spans) == 1 and len(cams) == 1
    assert (cams[0].time_range.start <= spans[0].time_range.start
            and spans[0].time_range.end <= cams[0].time_range.end)
