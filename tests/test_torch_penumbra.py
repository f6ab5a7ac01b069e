"""The port's penumbra gradient and joint loss (raytrace_tpu_torch/diff/
edges.py area_shadow_boundary_image_grad, joint_loss_and_grad) against the
JAX package's on the same inputs at 32×32 on the CPU, and the port's FD
check and joint recovery at tests/test_penumbra.py's settings.

Bounds as in tests/test_torch_edges.py: dimg to relative L1 ≤ 1e-4 with at
most 1% of its nonzero pixels off by more than 1e-3 of max |dimg|; losses,
gradients and weighted scalars within 1e-4 relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_edge_scenes as ps
from tests.test_torch_edges import (THETA, X, assert_dimg_close, j_camera,
                                    j_occluder_scene, scalar_close, weights)
from tests.torch_port_util import n
from raytrace_tpu.core.config import RenderConfig as JConfig
from raytrace_tpu.diff import edges as J
from raytrace_tpu.diff.render import SceneParams as JParams
from raytrace_tpu.scene import transform as j_tr
from raytrace_tpu.scene.builder import SceneBuilder as JBuilder
from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.core.config import RenderConfig as PConfig
from raytrace_tpu_torch.diff import edges as P
from raytrace_tpu_torch.diff.render import SceneParams as PParams
from raytrace_tpu_torch.renderers.simple import render_simple

SIZE = 32
SPP = 16
KEY = 23


def j_penumbra_scene(verts, kd_floor=(0.7, 0.7, 0.7)):
    """ps.penumbra_scene on the JAX package's builder."""
    b = JBuilder()
    floor = b.matte(kd_floor)
    occ = b.matte((0.3, 0.3, 0.3))
    b.triangle_mesh(ps.FLOOR, ps.QUAD_FACES, material=floor)
    b.triangle_mesh(np.asarray(verts, np.float64), ps.QUAD_FACES,
                    material=occ)
    o2w = j_tr.look_at(ps.LIGHT, (1.6, 0.0, 0.0), (0.0, 1.0, 0.0))
    b.area_light_disk((60.0, 60.0, 60.0), radius=ps.LIGHT_R,
                      object_to_world=o2w, n_samples=ps.N_LIGHT)
    return b.build()


def config(cls, spp=SPP):
    return cls(width=SIZE, height=SIZE, spp=spp, scene_epsilon=1e-3,
               max_light_samples=ps.N_LIGHT)


def test_area_shadow_boundary_matches_jax():
    verts = ps.penumbra_base_verts() + THETA * ps.X
    want = J.area_shadow_boundary_image_grad(
        j_penumbra_scene(verts), j_camera(), config(JConfig),
        jnp.asarray(verts, jnp.float32), ps.QUAD_FACES, jnp.asarray(X),
        samples_per_edge=64, n_light_samples=ps.N_LIGHT)
    got = P.area_shadow_boundary_image_grad(
        ps.penumbra_scene("cpu", verts), ps.camera("cpu", SIZE),
        config(PConfig), verts, ps.QUAD_FACES, X, samples_per_edge=64,
        n_light_samples=ps.N_LIGHT)
    assert_dimg_close(got, want)


def _disk_case():
    return dict(base=ps.penumbra_base_verts(), faces=ps.QUAD_FACES,
                jbuild=j_penumbra_scene, pbuild=ps.penumbra_builder("cpu"),
                primary=False)


def _point_primary_case():
    v, f = ps.cube_mesh((0.3, 0.0, 0.8))
    kd = (0.25, 0.4, 0.3)
    return dict(base=v, faces=f,
                jbuild=lambda vv: j_occluder_scene(vv, f, occ_kd=kd),
                pbuild=lambda vv: ps.occluder_scene(
                    "cpu", vv.cpu().numpy(), f, occ_kd=kd),
                primary=True)


JOINT_CASES = {"disk": _disk_case, "point_primary": _point_primary_case}


@pytest.mark.parametrize("case", list(JOINT_CASES))
def test_joint_loss_and_grad_matches_jax(case):
    c = JOINT_CASES[case]()
    target = np.random.default_rng(4).uniform(
        0.0, 0.3, (SIZE, SIZE, 3)).astype(np.float32)
    js0 = c["jbuild"](c["base"])
    want = J.joint_loss_and_grad(
        JParams(kd=js0.materials.kd, intensity=js0.lights.intensity),
        THETA, jnp.asarray(X), c["base"], c["faces"], c["jbuild"],
        j_camera(), config(JConfig, spp=4), jnp.asarray(target),
        jax.random.PRNGKey(KEY), samples_per_edge=64, n_light_samples=8,
        include_primary=c["primary"])
    ps0 = c["pbuild"](torch.tensor(c["base"], dtype=torch.float32))
    params = PParams(kd=ps0.materials.kd, intensity=ps0.lights.intensity)
    got = P.joint_loss_and_grad(
        params, THETA, X, c["base"], c["faces"], c["pbuild"],
        ps.camera("cpu", SIZE), config(PConfig, spp=4), torch.tensor(target),
        prng.PRNGKey(KEY, "cpu"), samples_per_edge=64, n_light_samples=8,
        include_primary=c["primary"])
    loss, g_params, g_theta, img = got
    scalar_close(loss, want[0])
    for g, w in ((g_params.kd, want[1].kd),
                 (g_params.intensity, want[1].intensity)):
        w = np.asarray(w)
        np.testing.assert_allclose(n(g), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())
    assert float(np.abs(n(g_params.kd)).sum()) > 0.0
    scalar_close(g_theta, want[2])
    jimg = np.asarray(want[3])
    assert np.abs(n(img) - jimg).sum() / np.abs(jimg).sum() <= 1e-4
    assert not (loss.requires_grad or img.requires_grad)
    # the caller's parameters are left as they were
    assert params.kd.grad is None and not params.kd.requires_grad


def test_penumbra_gradient_matches_fd():
    cam = ps.camera("cpu", SIZE)
    cfg = config(PConfig)
    wmat = torch.tensor(weights(5))

    def loss_at(theta):
        verts = ps.penumbra_base_verts() + theta * ps.X
        img = render_simple(ps.penumbra_scene("cpu", verts), cam, cfg,
                            prng.PRNGKey(KEY, "cpu"), jitter=True)
        return float(torch.mean(img * wmat))

    h = 0.08
    fd = (loss_at(+h) - loss_at(-h)) / (2 * h)
    base = ps.penumbra_base_verts()
    dimg = P.area_shadow_boundary_image_grad(
        ps.penumbra_scene("cpu", base), cam, cfg, base, ps.QUAD_FACES, X,
        samples_per_edge=128, n_light_samples=ps.N_LIGHT)
    ad = float(torch.mean(dimg * wmat))
    assert abs(fd) > 1e-5, "penumbra must actually move the loss"
    assert np.sign(fd) == np.sign(ad), (fd, ad)
    assert abs(fd - ad) <= 0.3 * max(abs(fd), abs(ad)), (fd, ad)


def test_joint_recovery_albedo_and_translation():
    """Recover the floor albedo AND the occluder translation from a target
    image with one loss (tests/test_penumbra.py's loop and settings)."""
    cam = ps.camera("cpu", SIZE)
    cfg = config(PConfig)
    key = prng.PRNGKey(KEY, "cpu")
    theta_star = 0.35
    kd_star = np.array([[0.75, 0.55, 0.35], [0.3, 0.3, 0.3]])
    build = ps.penumbra_builder("cpu")
    target = render_simple(
        ps.penumbra_scene("cpu", ps.penumbra_base_verts()
                          + theta_star * ps.X, kd_floor=tuple(kd_star[0])),
        cam, cfg, key, jitter=True)
    scene0 = ps.penumbra_scene("cpu", ps.penumbra_base_verts())
    params = PParams(kd=scene0.materials.kd,
                     intensity=scene0.lights.intensity)
    step = lambda p, th: P.joint_loss_and_grad(
        p, th, X, ps.penumbra_base_verts(), ps.QUAD_FACES, build, cam, cfg,
        target, key, samples_per_edge=96, n_light_samples=8, jitter=True)
    theta = 0.0
    lr_p, lr_t = 10.0, 40.0
    best = (float("inf"), theta, params)
    for _ in range(28):
        loss, g_p, g_t, _ = step(params, theta)
        if float(loss) < best[0]:
            best = (float(loss), theta, params)
        else:
            lr_t *= 0.5
            lr_p *= 0.85
            _, theta, params = best
            loss, g_p, g_t, _ = step(params, theta)
        params = PParams(kd=torch.clamp(params.kd - lr_p * g_p.kd, 0.02,
                                        0.98),
                         intensity=params.intensity)
        theta = float(theta - lr_t * float(g_t))
    loss_end = float(step(params, theta)[0])
    kd_err = float((params.kd[0] - torch.tensor(kd_star[0])).abs().max())
    assert abs(theta - theta_star) < 0.1, (theta, theta_star)
    assert kd_err < 0.08, kd_err
    assert loss_end < 0.25 * best[0] + 1e-9 or loss_end < 1e-5
