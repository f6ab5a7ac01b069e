"""The port's large-scene path against the JAX package on a small
`triangle_field` (2,048 triangles, so both builders attach a BVH and a
cluster set): the port intersects coherent (camera and shadow) launches
through its cluster engine (kernels K6 and K7 through their plain versions)
and the others through its epoch engine (K8 and K9), JAX through its CPU
route, the BVH traversal, and gathers with exact_gather=True.

Both find the exact closest hit, so they differ only where float32 rounds
differently: a ray through a shared terrain edge may take either triangle
(the same t), and a grazing ray may hit on one side and miss on the other.
Such rays are counted and bounded, not hidden by a loose tolerance. Frames
are held to tests/test_torch_render.py's bounds: relative L1 ≤ 1e-4 and at
most 1% of the pixels off by more than 1e-3 relative.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import n, np_tree, t
from raytrace_tpu.core.config import RenderConfig as JConfig
from raytrace_tpu.diff import render as j_diff
from raytrace_tpu.ops import intersect as j_isect
from raytrace_tpu.renderers import common as j_common
from raytrace_tpu.renderers import photon as j_photon
from raytrace_tpu.renderers import simple as j_simple
from raytrace_tpu.scene import camera as j_camera
from raytrace_tpu.scene import presets as j_presets
from raytrace_tpu_torch import interop
from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.core.config import RenderConfig as PConfig
from raytrace_tpu_torch.diff import render as p_diff
from raytrace_tpu_torch.ops import cluster_kernels as ck
from raytrace_tpu_torch.ops import epoch_kernels as ek
from raytrace_tpu_torch.ops import intersect as p_isect
from raytrace_tpu_torch.renderers import photon as p_photon
from raytrace_tpu_torch.renderers import simple as p_simple
from raytrace_tpu_torch.scene import presets as p_presets

SIZE = 24
N_TRIS = 2048
# run_combined's settings (bench.py:253-262) at a small size
SETTINGS = dict(width=SIZE, height=SIZE, spp=1, scene_epsilon=1e-3,
                photon_paths=1 << 13, photon_passes=1, max_photon_bounces=8,
                footprint_radius_scale=8.0, initial_radius2=0.04)
BIG = 1e30
# hit/miss flips and winners at different t, of the rays of one launch
RAY_FLIP_FRAC = 0.005
FRAME_REL_L1, PIXEL_OFF_FRAC = 1e-4, 0.01


@pytest.fixture(scope="module")
def scenes():
    """JAX's triangle_field and the port's own build of it (the builders
    are held equal in tests/test_torch_bvh.py)."""
    js, jc = j_presets.triangle_field(N_TRIS, SIZE)
    ps, pc = p_presets.triangle_field("cpu", N_TRIS, SIZE)
    assert ps.clusters is not None and js.clusters is not None
    return js, jc, ps, pc


def _frames_close(p_img, j_img):
    p_img, j_img = n(p_img), n(j_img)
    assert p_img.shape == (SIZE, SIZE, 3) and np.isfinite(p_img).all()
    assert p_img.mean() > 0.01
    rel_l1 = np.abs(p_img - j_img).sum() / np.abs(j_img).sum()
    off = np.abs(p_img - j_img).max(-1) > 1e-3 * np.maximum(j_img.max(-1),
                                                            1.0)
    assert rel_l1 <= FRAME_REL_L1 and off.mean() <= PIXEL_OFF_FRAC, (
        rel_l1, off.mean())


def _launches(js, jc):
    """A camera launch (the frame's jitter-free primary rays) and a bounce
    launch (cosine-weighted directions about the normal at each camera hit,
    from numpy) → [(o, d)] as numpy."""
    xy, lens = j_camera.pixel_samples(jax.random.PRNGKey(3), SIZE, SIZE, 1,
                                      jitter=False)
    rays = j_camera.generate_rays(jc, xy, lens, 1)
    o, d = n(rays.o), n(rays.d)
    k = o.shape[0]
    hit = j_isect.intersect(js, rays.o, rays.d, jnp.full((k,), 1e-3),
                            jnp.full((k,), BIG))
    rng = np.random.default_rng(4)
    nrm = np.where(n(hit.valid)[:, None], n(hit.ns), [0.0, 0.0, 1.0])
    nrm = nrm * np.where(np.sum(nrm * d, -1, keepdims=True) > 0, -1.0, 1.0)
    w = rng.standard_normal((k, 3)) + nrm
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    p = np.where(n(hit.valid)[:, None], n(hit.p), o)
    return [(o, d), (p.astype(np.float32), w.astype(np.float32))]


@pytest.mark.parametrize("launch", ["camera", "bounce"])
def test_intersect_and_occluded_equal_jax(scenes, launch):
    """Closest hit and any-hit of the port (coherent launches: the cluster
    engine) against JAX's (BVH traversal): the same hits but for counted
    flips, t rtol 2e-5 and the winner's material and point on the rest; the
    port's any-hit through the cluster and the epoch engine alike."""
    js, jc, ps, _ = scenes
    o, d = _launches(js, jc)[launch == "bounce"]
    k = o.shape[0]
    lo, hi = np.full(k, 1e-3, np.float32), np.full(k, BIG, np.float32)
    jh = j_isect.intersect(js, jnp.asarray(o), jnp.asarray(d),
                           jnp.asarray(lo), jnp.asarray(hi))
    counts = lambda: (ek.cull_bits.launches, ek.mt_jobs.launches,
                      ck.cull_tiles.launches, ck.pair_hits.launches)
    before = counts()
    ph = p_isect.intersect(ps, t(o), t(d), t(lo), t(hi), coherent=True)
    assert counts() == before
    jv, pv = n(jh.valid), n(ph.valid)
    jt, pt = n(jh.t), n(ph.t)
    same = (jv == pv) & (~jv | np.isclose(pt, jt, rtol=2e-5, atol=0.0))
    flips = int((~same).sum())
    print(f"{launch}: {flips} flips of {k} rays, {int(jv.sum())} hits")
    # most bounce rays leave the terrain upward and miss
    assert jv.sum() > (0.5 if launch == "camera" else 0.05) * k
    assert flips <= RAY_FLIP_FRAC * k
    both = same & jv
    np.testing.assert_array_equal(n(ph.mat)[both], n(jh.mat)[both])
    np.testing.assert_allclose(n(ph.p)[both], n(jh.p)[both], rtol=2e-5,
                               atol=2e-5)
    # shadow rays from each hit toward a low light, which the terrain's
    # bumps hide from some of them, over [eps, 1 - eps]
    light = np.array([-14.0, 3.0, 1.0], np.float32)
    so = np.where(jv[:, None], n(jh.p), o).astype(np.float32)
    sd = (light - so).astype(np.float32)
    s_lo, s_hi = np.full(k, 1e-3, np.float32), np.full(k, 1 - 1e-3,
                                                       np.float32)
    j_occ, j_ovf = j_isect.occluded_aux(js, jnp.asarray(so), jnp.asarray(sd),
                                        jnp.asarray(s_lo), jnp.asarray(s_hi),
                                        coherent=True)
    p_occ = p_isect.occluded(ps, t(so), t(sd), t(s_lo), t(s_hi),
                             coherent=True)
    assert int(j_ovf) == 0
    occ_flips = int((n(p_occ) != n(j_occ)).sum())
    assert occ_flips <= RAY_FLIP_FRAC * k
    assert n(j_occ).any() and not n(j_occ).all()
    np.testing.assert_array_equal(n(p_isect.occluded(ps, t(so), t(sd),
                                                     t(s_lo), t(s_hi))),
                                  n(p_occ))


def test_render_simple_equals_jax(scenes):
    js, jc, ps, pc = scenes
    cfg = dict(width=SIZE, height=SIZE, spp=1, scene_epsilon=1e-3)
    jimg = j_simple.render_simple(js, jc, JConfig(**cfg),
                                  jax.random.PRNGKey(0))
    pimg = p_simple.render_simple(ps, pc, PConfig(**cfg),
                                  prng.PRNGKey(0, "cpu"))
    _frames_close(pimg, jimg)


def test_render_photon_equals_jax(scenes):
    """The run_combined frame at 24×24 with 8,192 paths: the image, and
    both pair_overflow and gather_overflow 0 on both sides."""
    js, jc, ps, pc = scenes
    jimg, jaux = j_photon.render_photon(
        js, jc, JConfig(**SETTINGS, exact_gather=True), jax.random.PRNGKey(0),
        return_aux=True)
    pimg, paux = p_photon.render_photon(ps, pc, PConfig(**SETTINGS),
                                        prng.PRNGKey(0, "cpu"),
                                        return_aux=True)
    _frames_close(pimg, jimg)
    assert int(paux["pair_overflow"]) == int(jaux["pair_overflow"]) == 0
    assert int(paux["gather_overflow"]) == 0
    assert int(paux["valid_photons"]) == int(jaux["valid_photons"]) > 0


def test_progressive_two_waves_resume_equals_jax(scenes, tmp_path):
    """Two progressive waves against JAX's; a render stopped after wave 1
    and resumed from its checkpoint equals the uninterrupted one bit for
    bit."""
    js, jc, ps, pc = scenes
    settings = dict(SETTINGS, photon_paths=1 << 12, photon_passes=2)
    jimg, jstate = j_photon.render_photon_progressive(
        js, jc, JConfig(**settings, exact_gather=True), jax.random.PRNGKey(2))
    cfg = PConfig(**settings)
    key = prng.PRNGKey(2, "cpu")
    img, state, aux = p_photon.render_photon_progressive(ps, pc, cfg, key,
                                                         return_aux=True)
    _frames_close(img, jimg)
    jstate = np_tree(jstate)
    for f in ("radius2", "photon_count", "flux"):
        np.testing.assert_allclose(n(getattr(state, f)), getattr(jstate, f),
                                   rtol=2e-5, atol=2e-6, err_msg=f)
    assert int(aux["pair_overflow"]) == 0 and len(aux["wave_s"]) == 2
    path = str(tmp_path / "ppm.ckpt")
    p_photon.render_photon_progressive(
        ps, pc, dataclasses.replace(cfg, photon_passes=1), key,
        checkpoint_path=path)
    img_res, state_res = p_photon.render_photon_progressive(
        ps, pc, cfg, key, checkpoint_path=path)
    assert torch.equal(img_res, img)
    for f in ("radius2", "photon_count", "flux", "emitted"):
        assert torch.equal(getattr(state_res, f), getattr(state, f)), f


def test_loss_and_grad_kd_equals_jax(scenes):
    """loss_and_grad on the large-scene path: the winner's re-intersection
    keeps the differentiable surface, so g.kd (and g.intensity) agree with
    JAX's to tests/test_torch_diff.py's bounds (kd 5e-3, intensity 2e-4
    relative L1)."""
    js, jc, ps, pc = scenes
    setup = dict(SETTINGS, photon_paths=1 << 12, max_photon_bounces=4,
                 differentiable=True)
    jcfg, pcfg = JConfig(**setup), PConfig(**setup)
    ls = j_common.static_light_samples(js, jcfg)
    jparams = j_diff.extract_params(js)
    pparams = interop.params_from_numpy(np_tree(jparams), "cpu")
    target = np.full((SIZE, SIZE, 3), 0.05, np.float32)
    jl, jg = j_diff.loss_and_grad(jparams, jnp.asarray(target), js, jc, jcfg,
                                  jax.random.PRNGKey(7), ls, False)
    pl, pg = p_diff.loss_and_grad(pparams, t(target), ps, pc, pcfg,
                                  prng.PRNGKey(7, "cpu"), ls, False)
    rel = lambda a, b: np.abs(n(a) - n(b)).sum() / np.abs(n(b)).sum()
    assert np.isfinite(n(pg.kd)).all() and np.abs(n(pg.kd)).sum() > 0
    assert rel(pg.kd, jg.kd) <= 5e-3
    assert rel(pg.intensity, jg.intensity) <= 2e-4
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-4)


def test_use_bvh_and_budget_scale_take_effect(scenes, monkeypatch):
    """use_bvh is accepted and changes nothing (JAX's renderers ignore it);
    intersect_budget_scale, which sizes JAX's epoch-engine budgets, is
    accepted and leaves the frame of a render whose photon walk takes the
    epoch engine equal bit for bit, without a warning."""
    _, _, ps, pc = scenes
    cfg = dict(width=SIZE, height=SIZE, spp=1, scene_epsilon=1e-3)
    key = prng.PRNGKey(0, "cpu")
    img = p_simple.render_simple(ps, pc, PConfig(**cfg), key)
    assert torch.equal(p_simple.render_simple(
        ps, pc, PConfig(**cfg, use_bvh=True), key), img)
    calls = []
    engine = p_isect.epoch_intersect.intersect_epochs

    def spy(*args, **kw):
        calls.append(args[1].shape[0])
        return engine(*args, **kw)

    monkeypatch.setattr(p_isect.epoch_intersect, "intersect_epochs", spy)
    base = PConfig(**dict(SETTINGS, photon_paths=1 << 10))
    want, aux = p_photon.render_photon(ps, pc, base, key, return_aux=True)
    assert len(calls) > 2 and aux["pair_overflow"] == 0
    for scale in (1e-3, 3.0):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = p_photon.render_photon(
                ps, pc, dataclasses.replace(base,
                                            intersect_budget_scale=scale),
                key)
        assert torch.equal(got, want)
