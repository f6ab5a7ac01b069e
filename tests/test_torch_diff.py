"""The port's gradient path (record-and-replay `loss_and_grad`, `fit`)
against the JAX package's at tests/test_diff.py's sizes: 16×16, 1 spp,
2^10 photon paths, 4 bounces, differentiable=True, key 7, no jitter.

Bounds: the two frameworks round a few float32 ops differently. Without
jitter the pixel centres of this 16×16 frame fall on the box's inner
edges, where JAX and the port can pick different walls for a ray that
hits a shared edge; such rays, and the photon slots and pixels that
differ by more than rounding, are counted against the bounds below.
The rest must agree: the loss over agreeing pixels to 1e-5 relative,
each gradient field to a relative L1 that leaves room for the flipped
pixels' own terms (measured ≤ 1e-3 for kd, ≤ 3e-5 for the intensities).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import n, np_tree, port_scene, t
from raytrace_tpu.core.config import RenderConfig as JConfig
from raytrace_tpu.diff import optim as j_optim
from raytrace_tpu.diff import render as j_diff
from raytrace_tpu.renderers import common as j_common
from raytrace_tpu.renderers import photon as j_photon
from raytrace_tpu.scene import camera as j_camera
from raytrace_tpu.scene import presets as j_presets
from raytrace_tpu_torch import interop
from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.core.config import RenderConfig as PConfig
from raytrace_tpu_torch.diff import optim as p_optim
from raytrace_tpu_torch.diff import render as p_diff
from raytrace_tpu_torch.renderers import common as p_common
from raytrace_tpu_torch.renderers import photon as p_photon
from raytrace_tpu_torch.scene.camera import RayDifferentials

SIZE = 16
SETUP = dict(width=SIZE, height=SIZE, spp=1, scene_epsilon=1e-3,
             photon_paths=1 << 10, photon_passes=1, max_photon_bounces=4,
             differentiable=True)
LOSS_RTOL = 1e-5
KD_REL_L1, INTENSITY_REL_L1 = 5e-3, 2e-4
# flips seen: 2-4 camera rays (the mirror ball adds reflected edge hits),
# 0-1 photon slots and 3 pixels per ball
RAY_FLIPS_MAX = 6  # of 256 camera rays
SLOT_FLIP_FRAC = 0.02  # of the 4,096 photon slots
PIXEL_OFF_MAX = 6  # of 256 pixels


def _setup(ball):
    js, jc = j_presets.cornell_box(size=SIZE, ball=ball)
    jcfg, pcfg = JConfig(**SETUP), PConfig(**SETUP)
    ls = j_common.static_light_samples(js, jcfg)
    assert p_common.static_light_samples(port_scene(js), pcfg) == ls
    return (js, jc, jcfg, port_scene(js),
            interop.camera_from_numpy(np_tree(jc), "cpu"), pcfg, ls)


def _flips(js, jc, jcfg, ps, pcfg):
    """(camera rays, photon slots) that flip between the two sides: the
    records of the frame's jitter-free camera rays and the photon map of
    its wave, from the same keys."""
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    xy, lens = j_camera.pixel_samples(keys[0], SIZE, SIZE, 1, jitter=False)
    rays = j_camera.generate_rays(jc, xy, lens, 1)
    jrec = j_common.camera_pass(js, rays.o, rays.d, jcfg, rays=rays)
    prays = RayDifferentials(**{f.name: t(getattr(rays, f.name))
                                for f in dataclasses.fields(RayDifferentials)})
    prec = p_common.camera_pass(ps, prays.o, prays.d, pcfg, rays=prays)
    hit = n(jrec.status) == 0
    ok = (n(prec.status) == n(jrec.status)) & (
        (n(prec.mat) == n(jrec.mat)) | ~hit)
    for f in ("p", "ns", "atten"):
        close = np.isclose(n(getattr(prec, f).detach()),
                           n(getattr(jrec, f)), rtol=2e-5, atol=2e-6)
        ok &= close.all(axis=1) | ~hit
    jpm = j_photon.trace_photons(js, jcfg, keys[2], 0)
    ppm = p_photon.trace_photons(ps, pcfg, prng.split(
        prng.PRNGKey(7, "cpu"), 3)[2], 0)
    jv = n(jpm.valid)
    slot_ok = n(ppm.valid) == jv
    for f in ("p", "alpha", "wi"):
        close = np.isclose(n(getattr(ppm, f).detach()), n(getattr(jpm, f)),
                           rtol=2e-5, atol=2e-6)
        slot_ok &= close.all(axis=1) | ~jv
    assert jv.sum() > 300
    return int((~ok).sum()), int((~slot_ok).sum())


@pytest.mark.parametrize("ball", [None, "glass", "mirror"])
def test_loss_and_grad_matches_jax(ball):
    js, jc, jcfg, ps, pc, pcfg, ls = _setup(ball)
    jparams = j_diff.extract_params(js)
    pparams = interop.params_from_numpy(np_tree(jparams), "cpu")
    zeros = np.zeros((SIZE, SIZE, 3), np.float32)
    jl, jg = j_diff.loss_and_grad(jparams, jnp.asarray(zeros), js, jc, jcfg,
                                  jax.random.PRNGKey(7), ls, False)
    pl, pg = p_diff.loss_and_grad(pparams, t(zeros), ps, pc, pcfg,
                                  prng.PRNGKey(7, "cpu"), ls, False)
    # the caller's tensors are left as they were
    assert not pparams.kd.requires_grad and pparams.kd.grad is None

    ray_flips, slot_flips = _flips(js, jc, jcfg, ps, pcfg)
    jimg = n(j_diff.render_image_from_params(
        jparams, js, jc, jcfg, jax.random.PRNGKey(7), ls, jitter=False))
    pimg = n(p_diff.render_image_from_params(
        pparams, ps, pc, pcfg, prng.PRNGKey(7, "cpu"), ls, jitter=False))
    off = (np.abs(pimg - jimg).max(-1)
           > 1e-3 * np.maximum(jimg.max(-1), 1.0))
    print(f"ball={ball}: {ray_flips} camera rays, {slot_flips} photon slots"
          f" and {int(off.sum())} pixels flip")
    assert ray_flips <= RAY_FLIPS_MAX
    assert slot_flips <= SLOT_FLIP_FRAC * SETUP["photon_paths"] * 4
    assert off.sum() <= PIXEL_OFF_MAX

    # each side's loss is its own image's MSE; over the pixels that agree
    # the two losses agree to LOSS_RTOL
    np.testing.assert_allclose(float(pl), np.mean(pimg ** 2), rtol=1e-6)
    np.testing.assert_allclose(float(jl), np.mean(jimg ** 2), rtol=1e-6)
    np.testing.assert_allclose(np.sum(pimg[~off] ** 2),
                               np.sum(jimg[~off] ** 2), rtol=LOSS_RTOL)
    for field, tol in (("kd", KD_REL_L1), ("intensity", INTENSITY_REL_L1)):
        a, b = n(getattr(pg, field)), n(getattr(jg, field))
        assert np.isfinite(a).all() and np.abs(a).sum() > 0
        rel = np.abs(a - b).sum() / np.abs(b).sum()
        assert rel <= tol, (field, rel)
    if ball == "glass":
        # glass throughput is kd-free: its row gets exactly 0 on both sides
        assert not n(pg.kd)[3].any() and not np.asarray(jg.kd)[3].any()


def test_differentiable_primal_equals_forward_render(monkeypatch):
    """Record and replay changes no primal value: the differentiable frame
    is the forward frame bit for bit (glass box: camera chains and photon
    walks through the ball, every gather through RowspanS). A forward wave
    of this size (4,096 slots) would take the dense small-map gather K4,
    which adds the same terms in another order, so the forward frame is
    held on the row-span gather the differentiable frame runs."""
    monkeypatch.setattr(p_photon, "DENSE_GATHER_SLOTS", 0)
    _, _, _, ps, pc, pcfg, ls = _setup("glass")
    params = p_diff.extract_params(ps)
    leaves = p_diff.SceneParams(kd=params.kd.clone().requires_grad_(True),
                                intensity=params.intensity.clone()
                                .requires_grad_(True))
    key = prng.PRNGKey(3, "cpu")
    img_d = p_diff.render_image_from_params(leaves, ps, pc, pcfg, key, ls)
    img_f = p_photon.render_photon(
        ps, pc, dataclasses.replace(pcfg, differentiable=False), key)
    assert img_d.requires_grad and not img_f.requires_grad
    assert torch.equal(img_d.detach(), img_f)
    # remat_walks is accepted and changes nothing, as in the JAX render
    img_r = p_photon.render_photon(
        ps, pc, dataclasses.replace(pcfg, remat_walks=True), key)
    assert torch.equal(img_r, img_f)


def test_transforms_match_jax():
    rng = np.random.default_rng(0)
    kd = rng.uniform(0, 1, (5, 3)).astype(np.float32)
    kd[0] = [0.0, 1.0, 0.5]  # clamped to [1e-6, 1 - 1e-6]
    inten = rng.uniform(0, 40, (2, 3)).astype(np.float32)
    inten[1, 0] = 0.0  # clamped to 1e-6
    jt = j_optim.to_transformed(j_diff.SceneParams(
        kd=jnp.asarray(kd), intensity=jnp.asarray(inten)))
    pt = p_optim.to_transformed(p_diff.SceneParams(kd=t(kd),
                                                   intensity=t(inten)))
    np.testing.assert_allclose(n(pt.kd_logit), n(jt.kd_logit), rtol=1e-5)
    np.testing.assert_allclose(n(pt.log_intensity), n(jt.log_intensity),
                               rtol=1e-6, atol=1e-6)
    jb = j_optim.from_transformed(jt)
    pb = p_optim.from_transformed(pt)
    np.testing.assert_allclose(n(pb.kd), n(jb.kd), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(n(pb.intensity), n(jb.intensity), rtol=1e-6)


def test_fit_matches_jax():
    """Three Adam steps from a 1.8× over-bright emitter, each side against
    its own target rendered at the true parameters with the same key: the
    losses agree to 1e-4 relative and the parameters to 1e-5 (Adam's first
    steps are ≈ lr·sign(g), so small gradient differences barely move
    them)."""
    js, jc, jcfg, ps, pc, pcfg, ls = _setup(None)
    jtrue = j_diff.extract_params(js)
    jtarget = j_diff.render_image_from_params(
        jtrue, js, jc, jcfg, jax.random.PRNGKey(7), ls, jitter=False)
    ptrue = interop.params_from_numpy(np_tree(jtrue), "cpu")
    ptarget = p_diff.render_image_from_params(
        ptrue, ps, pc, pcfg, prng.PRNGKey(7, "cpu"), ls, jitter=False)
    j0 = jtrue.replace(intensity=jtrue.intensity * 1.8)
    p0 = dataclasses.replace(ptrue, intensity=ptrue.intensity * 1.8)
    jrec, jlosses = j_optim.fit(j0, jtarget, js, jc, jcfg,
                                jax.random.PRNGKey(7), steps=3, lr=0.1,
                                light_samples=ls)
    prec, plosses = p_optim.fit(p0, ptarget, ps, pc, pcfg,
                                prng.PRNGKey(7, "cpu"), steps=3, lr=0.1,
                                light_samples=ls)
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-4)
    assert plosses[-1] < plosses[0]
    np.testing.assert_allclose(n(prec.kd), n(jrec.kd), rtol=1e-5)
    np.testing.assert_allclose(n(prec.intensity), n(jrec.intensity),
                               rtol=1e-5)
    assert not prec.kd.requires_grad
