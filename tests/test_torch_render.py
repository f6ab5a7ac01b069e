"""The port's forward photon-mapping frame against the JAX package at 32×32,
1 spp, 2^12 photon paths (16,384 slots, so the row-span gather runs) on the
glass Cornell box with the bench settings.

Bounds: the two frameworks round a few float32 ops differently (fusion,
reduction order), which moves values by ulps and, rarely, flips a grazing
hit or a Russian-roulette draw that sits on its threshold. Flipped rays,
slots and pixels are counted against the bounds stated in each test; the
rest must be allclose.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import n, np_tree, port_scene, t
from raytrace_tpu.core.config import RenderConfig as JConfig
from raytrace_tpu.ops import intersect as j_isect_mod
from raytrace_tpu.renderers import common as j_common
from raytrace_tpu.renderers import photon as j_photon
from raytrace_tpu.scene import camera as j_camera
from raytrace_tpu.scene import presets as j_presets
from raytrace_tpu.utils import film as j_film
from raytrace_tpu_torch import interop
from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.core.config import RenderConfig as PConfig
from raytrace_tpu_torch.renderers import common as p_common
from raytrace_tpu_torch.renderers import photon as p_photon
from raytrace_tpu_torch.renderers import simple as p_simple
from raytrace_tpu_torch.scene import presets as p_presets
from raytrace_tpu_torch.utils import film as p_film

SIZE = 32
BENCH = dict(width=SIZE, height=SIZE, spp=1, scene_epsilon=1e-3,
             photon_paths=1 << 12, max_photon_bounces=8,
             footprint_radius_scale=8.0)
RTOL, ATOL = 2e-5, 2e-6
# rays / slots / pixels allowed to flip (see the module docstring)
RAY_FLIP_FRAC = 0.005
SLOT_FLIP_FRAC = 0.02


def _configs(**kw):
    return JConfig(**BENCH, **kw), PConfig(**BENCH, **kw)


def _setup(**kw):
    jcfg, pcfg = _configs(**kw)
    js, jc = j_presets.cornell_box(SIZE, ball="glass")
    xy, lens = j_camera.pixel_samples(jax.random.PRNGKey(1), SIZE, SIZE, 1)
    rays = j_camera.generate_rays(jc, xy, lens, 1)
    return js, port_scene(js), jcfg, pcfg, rays


def _rays_to_port(rays):
    from raytrace_tpu_torch.scene.camera import RayDifferentials

    return RayDifferentials(**{f.name: t(getattr(rays, f.name))
                               for f in dataclasses.fields(RayDifferentials)})


def _rec_agree(a, b):
    """Per-ray agreement of two CameraRecords (status and hit frame)."""
    ok = n(a.status) == n(b.status)
    hit = n(a.status) == 0
    for f in ("p", "ns", "ng", "dpdu", "dpdv", "uv", "atten", "footprint",
              "direction"):
        close = np.isclose(n(getattr(a, f)), n(getattr(b, f)), rtol=RTOL,
                           atol=ATOL)
        ok &= close.reshape(len(ok), -1).all(axis=1) | ~hit
    ok &= (n(a.mat) == n(b.mat)) | ~hit
    return ok


@pytest.mark.parametrize("compact_queue", [0, 64])
def test_camera_records_and_direct_lighting(compact_queue):
    """compact_queue 0 keeps the full-batch camera pass at this size; 64
    takes the compacted form on both sides."""
    js, ps, jcfg, pcfg, rays = _setup(compact_queue=compact_queue)
    jrec = j_common.camera_pass(js, rays.o, rays.d, jcfg, rays=rays)
    prec = p_common.camera_pass(ps, t(rays.o), t(rays.d), pcfg,
                                rays=_rays_to_port(rays))
    ok = _rec_agree(prec, jrec)
    assert (~ok).sum() <= RAY_FLIP_FRAC * len(ok)
    assert (n(prec.status) == 0).mean() > 0.4
    assert (n(prec.status) == 2).sum() == (n(jrec.status) == 2).sum()

    # direct lighting from the same records and the same key
    ls = j_common.static_light_samples(js, jcfg)
    assert p_common.static_light_samples(ps, pcfg) == ls
    jL = j_common.direct_lighting(js, jrec, jax.random.PRNGKey(5), jcfg, ls)
    pL = p_common.direct_lighting(
        ps, interop.records_from_numpy(np_tree(jrec), "cpu"),
        prng.PRNGKey(5, "cpu"), pcfg, ls)
    close = np.isclose(n(pL), n(jL), rtol=RTOL, atol=ATOL).all(axis=1)
    assert (~close).sum() <= RAY_FLIP_FRAC * len(close)
    assert n(pL).sum() > 0


@pytest.mark.parametrize("compact_queue", [0, 512])
def test_trace_photons(compact_queue):
    """compact_queue 512 takes the walk's warm-steps-then-survivors form."""
    js, ps, jcfg, pcfg, _ = _setup(compact_queue=compact_queue)
    jpm = j_photon.trace_photons(js, jcfg, jax.random.PRNGKey(7), 0)
    ppm = p_photon.trace_photons(ps, pcfg, prng.PRNGKey(7, "cpu"), 0)
    jv, pv = n(jpm.valid), n(ppm.valid)
    ok = jv == pv
    for f in ("p", "alpha", "wi"):
        close = np.isclose(n(getattr(ppm, f)), n(getattr(jpm, f)),
                           rtol=RTOL, atol=ATOL).all(axis=1)
        ok &= close | ~jv
    assert pv.sum() > 1000
    assert (~ok).sum() <= SLOT_FLIP_FRAC * len(ok)
    for f in ("p", "alpha", "wi"):
        np.testing.assert_allclose(n(getattr(ppm, f))[ok & jv],
                                   n(getattr(jpm, f))[ok & jv], rtol=RTOL,
                                   atol=ATOL)


def _gather_inputs():
    js, ps, jcfg, pcfg, rays = _setup()
    jrec = j_common.camera_pass(js, rays.o, rays.d, jcfg, rays=rays)
    z = jnp.zeros((SIZE * SIZE,), jnp.float32)
    jstate = j_photon.ProgressiveState(
        radius2=j_photon.initial_radius2(jrec, jcfg), photon_count=z,
        flux=jnp.zeros((SIZE * SIZE, 3), jnp.float32), emitted=z)
    jpm = j_photon.trace_photons(js, jcfg, jax.random.PRNGKey(7), 0)
    prec = interop.records_from_numpy(np_tree(jrec), "cpu")
    pstate = interop.state_from_numpy(np_tree(jstate), "cpu")
    np.testing.assert_allclose(n(p_photon.initial_radius2(prec, pcfg)),
                               n(jstate.radius2), rtol=RTOL)
    np.testing.assert_allclose(n(p_photon.gather_cell_size(prec, pstate)),
                               n(j_photon.gather_cell_size(jrec, jstate)),
                               rtol=RTOL)
    return (js, ps, jcfg, pcfg, jrec, prec, jstate, pstate, jpm,
            interop.photon_map_from_numpy(np_tree(jpm), "cpu"))


def _assert_states_close(p, j):
    for f in ("radius2", "photon_count", "flux", "emitted"):
        np.testing.assert_allclose(n(getattr(p, f)), n(getattr(j, f)),
                                   rtol=RTOL, atol=ATOL, err_msg=f)


@pytest.mark.parametrize("port_exact", [False, True])
def test_gathering_pass_matches_exact_gather(port_exact):
    """The port's row-span gather (or its exact all-pairs gather) against
    JAX's exact all-pairs gather, from the same photon map."""
    (js, ps, jcfg, pcfg, jrec, prec, jstate, pstate, jpm,
     ppm) = _gather_inputs()
    pcfg = dataclasses.replace(pcfg, exact_gather=port_exact)
    jnew, jinfo = j_photon.gathering_pass(
        js, jrec, jstate, jpm, dataclasses.replace(jcfg, exact_gather=True))
    pnew, pinfo = p_photon.gathering_pass(ps, prec, pstate, ppm, pcfg)
    assert int(pinfo["gather_overflow"]) == 0
    assert int(pinfo["valid_photons"]) == int(jinfo["valid_photons"])
    _assert_states_close(pnew, jnew)
    assert n(pnew.photon_count).sum() > 0
    # a second wave on top of the first (radii shrink, flux accumulates)
    jnew2, _ = j_photon.gathering_pass(
        js, jrec, jnew, jpm, dataclasses.replace(jcfg, exact_gather=True))
    pnew2, _ = p_photon.gathering_pass(ps, prec, pnew, ppm, pcfg)
    _assert_states_close(pnew2, jnew2)

    L = p_photon.final_gathering(prec, t(np.ones((SIZE * SIZE, 3),
                                                 np.float32)), pnew2)
    jL = j_photon.final_gathering(jrec, jnp.ones((SIZE * SIZE, 3)), jnew2,
                                  jnp.float32(2 * jcfg.photon_paths))
    # flux, r² and the emitted count each carry RTOL: their quotient ~3×
    np.testing.assert_allclose(n(L), n(jL), rtol=1e-4, atol=1e-6)


def test_gathering_pass_forced_overflow_matches_rowspan(monkeypatch):
    """A job budget too small for the map: the JAX rowspan path (interpret
    mode) and the port skip the same tiles and leave them out of the
    emitted-path normalization."""
    (js, ps, jcfg, pcfg, jrec, prec, jstate, pstate, jpm,
     ppm) = _gather_inputs()
    knobs = dict(gather_rounds=1, gather_job_budget=8)
    monkeypatch.setattr(j_isect_mod, "_pallas_enabled", lambda: True)
    monkeypatch.setenv("RAYTRACE_TPU_INTERPRET", "1")
    jnew, jinfo = j_photon.gathering_pass(
        js, jrec, jstate, jpm, dataclasses.replace(jcfg, **knobs))
    with pytest.warns(RuntimeWarning, match="overflow"):
        pnew, pinfo = p_photon.gathering_pass(
            ps, prec, pstate, ppm, dataclasses.replace(pcfg, **knobs))
    assert int(pinfo["gather_overflow"]) == int(jinfo["gather_overflow"]) > 0
    np.testing.assert_array_equal(n(pnew.emitted), n(jnew.emitted))
    emitted = n(pnew.emitted)
    assert (emitted == 0).any() and (emitted > 0).any()
    _assert_states_close(pnew, jnew)


def test_render_photon_whole_frame():
    """The port's render_photon against JAX's render_photon with
    exact_gather=True, both from key 0: relative L1 ≤ 1e-4 and at most 1%
    of the pixels off by more than 1e-3 relative."""
    jcfg, pcfg = _configs()
    js, jc = j_presets.cornell_box(SIZE, ball="glass")
    ps, pc = p_presets.cornell_box("cpu", SIZE, ball="glass")
    jimg, jaux = j_photon.render_photon(
        js, jc, dataclasses.replace(jcfg, exact_gather=True),
        jax.random.PRNGKey(0), return_aux=True)
    pimg, paux = p_photon.render_photon(ps, pc, pcfg, prng.PRNGKey(0, "cpu"),
                                        return_aux=True)
    jimg, pimg = n(jimg), n(pimg)
    assert pimg.shape == (SIZE, SIZE, 3) and np.isfinite(pimg).all()
    assert pimg.mean() > 0.05
    rel_l1 = np.abs(pimg - jimg).sum() / np.abs(jimg).sum()
    assert rel_l1 <= 1e-4
    off = np.abs(pimg - jimg).max(-1) > 1e-3 * np.maximum(jimg.max(-1), 1.0)
    assert off.mean() <= 0.01
    assert int(paux["gather_overflow"]) == 0 and paux["pair_overflow"] == 0
    assert int(paux["valid_photons"]) > 0
    assert abs(int(paux["valid_photons"]) - int(jaux["valid_photons"])) <= (
        SLOT_FLIP_FRAC * BENCH["photon_paths"] * jcfg.max_photon_depth)


@pytest.mark.parametrize("field,value,item", [
    ("grid_max_photons_per_cell", 64, "hash-grid gather")])
def test_unported_config_field_is_refused(field, value, item):
    """A field that selects a path the port does not have raises instead of
    being silently ignored."""
    ps, pc = p_presets.cornell_box("cpu", 8, ball="glass")
    cfg = PConfig(width=8, height=8, photon_paths=64, **{field: value})
    with pytest.raises(NotImplementedError, match=f"{field}.*{item}"):
        p_photon.render_photon(ps, pc, cfg, prng.PRNGKey(0, "cpu"))


@pytest.mark.parametrize("filt,radius", [("box", 0.0), ("triangle", 0.0),
                                          ("gaussian", 1.5)])
def test_film_splat(filt, radius):
    """Film splat through each pbrt filter, with NaN/negative/inf samples
    zeroed first (a sum of ≤ 49 weighted taps per pixel: rtol 1e-5)."""
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, [10, 7], (300, 2)).astype(np.float32)
    L = rng.uniform(0, 2, (300, 3)).astype(np.float32)
    L[:5] = [np.nan, 1.0, 1.0]
    L[5:8] = -1.0
    L[8] = np.inf
    want = j_film.splat(jnp.asarray(xy), jnp.asarray(L), 10, 7, filt, radius)
    got = p_film.splat(t(xy), t(L), 10, 7, filt, radius)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-6)


def test_intersect_rounds_raises_the_cluster_capacity(monkeypatch):
    """intersect_rounds, which sizes JAX's cluster-engine capacity, is
    accepted and leaves the frame equal bit for bit, without a warning: the
    port's cluster engine runs every pair of its camera and shadow
    launches, so its frame is the epoch engine's up to tie breaks."""
    ps, pc = p_presets.triangle_field("cpu", 2048, 8)
    base = dict(width=8, height=8, spp=1, scene_epsilon=1e-3)
    key = prng.PRNGKey(0, "cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        full = p_simple.render_simple(ps, pc, PConfig(**base), key)
        for rounds in (2, 256):
            assert torch.equal(p_simple.render_simple(
                ps, pc, PConfig(**base, intersect_rounds=rounds), key), full)
    monkeypatch.setenv("RAYTRACE_TPU_ENGINE", "epoch")
    want = p_simple.render_simple(ps, pc, PConfig(**base), key)
    np.testing.assert_allclose(n(full), n(want), rtol=1e-4, atol=1e-6)
