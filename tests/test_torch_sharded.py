"""The port's sharded renderer (raytrace_tpu_torch/parallel/sharded.py) on
4 gloo ranks on the CPU, against the JAX package's on 4 of the conftest's
virtual devices (exact_gather=True, jitter=False) and against its own
world of 1.

The world is spawned once for the module (tests/torch_parallel_cases.py
`sharded_world`, started in a thread while JAX compiles) and returns every
case's result. Bounds: frames within rtol 5e-4 and atol 5e-5, the JAX
package's own tests' bound (tests/test_sharded.py), on every pixel but
the edge flips, which are counted: with jitter off, the pixel centres on
the image's diagonals look exactly along the box's corner edges, and there
XLA's and PyTorch's arithmetic may pick different walls (3 of the 12 such
pixels at 16×16). The train step (lr the API's default, 0.05): the loss
within rtol 1e-4, the gradient and the new kd and intensity within rtol
5e-3. A path-id slice of the port's own wave is held to its full wave to
1e-6 (valid equal), and so are JAX's; the port's slices against JAX's:
valid equal, positions and α within 1e-6 on all but 1% of the valid
slots (one of ~250 here, 1.5e-6 off) and within tests/test_torch_render.py's
2e-5 on all.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parallel_cases as cases
from tests.torch_port_util import (assert_frames_close,
                                  corner_edge_pixels, n, np_tree,
                                  port_scene)
from raytrace_tpu.core.config import RenderConfig as JConfig
from raytrace_tpu.diff.render import extract_params as j_extract
from raytrace_tpu.parallel import sharded as J
from raytrace_tpu.renderers import photon as j_photon
from raytrace_tpu.scene import presets as j_presets
from raytrace_tpu_torch import interop
from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.core.config import RenderConfig as PConfig
from raytrace_tpu_torch.parallel import launch
from raytrace_tpu_torch.renderers import photon as p_photon

SIZE, SEED, WORLD, LR = 16, 21, 4, 0.05
BASE = dict(width=SIZE, height=SIZE, spp=1, scene_epsilon=1e-3,
            photon_paths=1 << 10, photon_passes=1, max_photon_bounces=4,
            exact_gather=True)
CASES = dict(
    render=BASE,
    odd=dict(BASE, photon_paths=1008),
    # the default gather: maps under 2^14 slots take K4's route
    passes=dict(BASE, photon_passes=2, exact_gather=False),
    indivisible=dict(BASE, width=9, height=9),
    train=dict(BASE, photon_paths=1 << 9, differentiable=True))
PHOTON_RTOL, PHOTON_ATOL, PHOTON_OFF_FRAC = 2e-5, 2e-6, 0.01


def _jax_mesh(n_devices):
    return J.make_mesh(jax.devices()[:n_devices])


@pytest.fixture(scope="module")
def scene():
    return j_presets.cornell_box(SIZE)


@pytest.fixture(scope="module")
def inputs(scene):
    """The port's side of every case: the scene, camera and parameters
    carried over from JAX's, and the configs."""
    js, jc = scene
    return dict(scene=port_scene(js),
                camera=interop.camera_from_numpy(np_tree(jc), "cpu"),
                params=interop.params_from_numpy(np_tree(j_extract(js)),
                                                 "cpu"),
                target=torch.zeros(SIZE, SIZE, 3), seed=SEED, lr=LR,
                **{k: PConfig(**v) for k, v in CASES.items()})


@pytest.fixture(scope="module")
def world(inputs):
    """The port's 4-rank world, running in a thread: .result() → each
    rank's dict."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(launch.run_world, cases.sharded_world, WORLD, "cpu",
                          (inputs,))


@pytest.fixture(scope="module")
def edge(inputs):
    return corner_edge_pixels(inputs["scene"], inputs["camera"],
                              inputs["render"])


def _two_light(js):
    """The box with a second, dimmer disk light beside the first: paths
    striped over two lights."""
    two = jax.tree_util.tree_map(lambda a: jnp.concatenate([a, a]),
                                 js.lights)
    two = two.replace(o=two.o.at[1].add(jnp.array([0.4, 0.3, 0.0])),
                      intensity=two.intensity.at[1].multiply(0.5))
    return js.with_lights(two)


@pytest.mark.parametrize("lights", [1, 2])
def test_path_offset_slices_equal_the_full_wave(scene, lights):
    """Four path-id slices of a wave, concatenated, are the full wave: in
    the port to 1e-6 (valid equal), in JAX likewise, and the port's equal
    JAX's (module docstring)."""
    js = scene[0] if lights == 1 else _two_light(scene[0])
    ps = port_scene(js)
    assert ps.lights.count == js.lights.count == lights
    cfg = dict(BASE, photon_paths=512)
    per = cfg["photon_paths"] // WORLD
    jcfg, pcfg = JConfig(**cfg), PConfig(**cfg)
    jlocal = dataclasses.replace(jcfg, photon_paths=per)
    plocal = dataclasses.replace(pcfg, photon_paths=per)
    key = prng.PRNGKey(SEED, "cpu")
    jtrace = jax.jit(j_photon.trace_photons, static_argnums=(1, 3))
    jfull = jtrace(js, jcfg, jax.random.PRNGKey(SEED), 0)
    jparts = [jtrace(js, jlocal, jax.random.PRNGKey(SEED), 0, None, c * per)
              for c in range(WORLD)]
    pfull = p_photon.trace_photons(ps, pcfg, key, 0)
    pparts = [p_photon.trace_photons(ps, plocal, key, 0, path_offset=c * per)
              for c in range(WORLD)]
    cat = lambda parts, f: np.concatenate([n(getattr(p, f)) for p in parts])
    for parts, full in ((pparts, pfull), (jparts, jfull)):
        for f in ("p", "alpha"):
            np.testing.assert_allclose(cat(parts, f), n(getattr(full, f)),
                                       rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(cat(parts, "valid"), n(full.valid))
    valid = cat(pparts, "valid")
    np.testing.assert_array_equal(valid, cat(jparts, "valid"))
    assert valid.sum() > 100
    for f in ("p", "alpha"):
        got, want = cat(pparts, f)[valid], cat(jparts, f)[valid]
        np.testing.assert_allclose(got, want, rtol=PHOTON_RTOL,
                                   atol=PHOTON_ATOL)
        off = ~np.isclose(got, want, rtol=1e-6, atol=1e-6).all(-1)
        assert off.sum() <= PHOTON_OFF_FRAC * len(off), (f, off.sum())


def test_path_offset_slices_replay_the_light_rows():
    """Differentiable slices of a two-light wave: each deposit's replayed
    alpha and its gradient in the light intensities equal the full wave's,
    which holds only if the replay reads each slot's light by global id."""
    ps = port_scene(_two_light(j_presets.cornell_box(SIZE)[0]))
    cfg = PConfig(**dict(BASE, photon_paths=512, differentiable=True))
    per = cfg.photon_paths // WORLD
    local = dataclasses.replace(cfg, photon_paths=per)
    key = prng.PRNGKey(SEED, "cpu")

    def alpha_and_grad(parts):
        le = ps.lights.intensity.clone().requires_grad_(True)
        s = ps.with_lights(dataclasses.replace(ps.lights, intensity=le))
        alpha = torch.cat([p_photon.trace_photons(s, c, key, 0,
                                                  path_offset=off).alpha
                           for c, off in parts])
        weights = torch.arange(alpha.numel(), dtype=torch.float32).reshape(
            alpha.shape) % 7
        (g,) = torch.autograd.grad((alpha * weights).sum(), le)
        return alpha.detach(), g

    a_full, g_full = alpha_and_grad([(cfg, 0)])
    a_parts, g_parts = alpha_and_grad([(local, c * per)
                                       for c in range(WORLD)])
    np.testing.assert_allclose(n(a_parts), n(a_full), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(n(g_parts), n(g_full), rtol=1e-5)
    assert (n(g_full) != 0).all()


def test_light_index_forces_one_light_unscaled(scene):
    """light_index=1 on the two-light box shoots every path from light 1
    with Le unscaled, as JAX's does: the wave of the scene whose only light
    is light 1, photon for photon."""
    ps = port_scene(_two_light(scene[0]))
    alone = ps.with_lights(dataclasses.replace(
        ps.lights, **{f.name: getattr(ps.lights, f.name)[1:]
                      for f in dataclasses.fields(ps.lights)}))
    cfg = PConfig(**dict(BASE, photon_paths=256))
    key = prng.PRNGKey(3, "cpu")
    forced = p_photon.trace_photons(ps, cfg, key, 0, light_index=1)
    want = p_photon.trace_photons(alone, cfg, key, 0)
    assert int(want.valid.sum()) > 50
    for f in ("p", "alpha", "wi", "valid"):
        assert torch.equal(getattr(forced, f), getattr(want, f)), f


def test_render_matches_jax_world_4_and_world_1(scene, world, edge):
    js, jc = scene
    jcfg = JConfig(**CASES["render"])
    key = jax.random.PRNGKey(SEED)
    j4 = J.render_photon_sharded(js, jc, jcfg, key, _jax_mesh(4),
                                 jitter=False)
    j1 = J.render_photon_sharded(js, jc, jcfg, key, _jax_mesh(1),
                                 jitter=False)
    ranks = world.result()
    assert_frames_close(ranks[0]["img4"], j4, edge)
    assert_frames_close(ranks[0]["img1"], j1, edge)
    # within the port, world 4 is world 1 to the bit: each pixel's sums
    # run over the same photons in the same order
    assert torch.equal(ranks[0]["img4"], ranks[0]["img1"])
    for r in ranks[1:]:  # every rank splats the whole image
        assert torch.equal(r["img4"], ranks[0]["img4"])
    aux = ranks[0]["aux4"]
    assert aux["gather_overflow"] == 0 and aux["pair_overflow"] == 0
    assert aux["valid_photons"] > 0


def test_render_with_odd_paths_matches_jax(scene, world, edge):
    """1,008 paths: each rank traces floor(1008 / 4) of them."""
    js, jc = scene
    j4 = J.render_photon_sharded(js, jc, JConfig(**CASES["odd"]),
                                 jax.random.PRNGKey(SEED), _jax_mesh(4),
                                 jitter=False)
    assert_frames_close(world.result()[0]["odd4"], j4, edge)


def test_pixel_samples_must_divide(world):
    assert "must divide the chip count 4" in world.result()[0]["indivisible"]


def test_pipelined_waves_equal_waves_gathered_in_sequence(world):
    """photon_passes = 2: wave 1's all_gather overlaps wave 0's gather
    pass; the frame equals the waves gathered one after the other."""
    r = world.result()[0]
    assert float(r["pipelined"].mean()) > 0.01
    assert torch.equal(r["pipelined"], r["sequential"])


def test_train_step_matches_world_1_and_jax(scene, world):
    """The gradient summed over 4 ranks is world 1's, not 4× it, and both
    step as JAX's sharded train step does."""
    js, jc = scene
    loss_j, new_j = J.train_step_sharded(
        j_extract(js), jnp.zeros((SIZE, SIZE, 3)), js, jc,
        JConfig(**CASES["train"]), jax.random.PRNGKey(SEED), _jax_mesh(4),
        lr=LR)
    r = world.result()[0]
    g4, g1 = n(r["grad4"]), n(r["grad1"])
    gj = np.concatenate([n(j_extract(js).kd - new_j.kd).reshape(-1),
                         n(j_extract(js).intensity
                           - new_j.intensity).reshape(-1)]) / LR
    assert np.linalg.norm(g1) > 0
    scale = float(g4 @ g1 / (g1 @ g1))
    assert abs(scale - 1.0) < 1e-3, f"world 4's gradient is {scale}× world 1's"
    np.testing.assert_allclose(g4, g1, rtol=5e-3, atol=1e-6)
    np.testing.assert_allclose(g4, gj, rtol=5e-3, atol=1e-6)
    np.testing.assert_allclose(r["loss4"], r["loss1"], rtol=1e-4)
    np.testing.assert_allclose(r["loss4"], float(loss_j), rtol=1e-4)
    np.testing.assert_allclose(n(r["kd4"]), n(new_j.kd), rtol=5e-3,
                               atol=1e-5)
    np.testing.assert_allclose(n(r["intensity4"]), n(new_j.intensity),
                               rtol=5e-3, atol=1e-4)
