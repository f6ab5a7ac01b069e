"""Scene, camera and shading modules of the PyTorch port against the JAX
package: config fields, preset arrays, camera rays, BSDFs and lights."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_port_util import n, np_tree, port_scene, t
from raytrace_tpu.core.config import RenderConfig as JConfig
from raytrace_tpu.scene import camera as j_camera
from raytrace_tpu.scene import presets as j_presets
from raytrace_tpu.scene import transform as j_tr
from raytrace_tpu.scene.builder import SceneBuilder as JBuilder
from raytrace_tpu.shading import light as j_light
from raytrace_tpu.shading import material as j_mat
from raytrace_tpu_torch import interop
from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.core.config import RenderConfig as PConfig
from raytrace_tpu_torch.scene import camera as p_camera
from raytrace_tpu_torch.scene import presets as p_presets
from raytrace_tpu_torch.scene.builder import SceneBuilder as PBuilder
from raytrace_tpu_torch.shading import light as p_light
from raytrace_tpu_torch.shading import material as p_mat

# float32 elementwise math in two frameworks: XLA and PyTorch may fuse or
# order a handful of ops differently, a few ulps at most
RTOL, ATOL = 2e-5, 2e-6


def _assert_tree_equal(port_obj, jax_obj):
    for f in dataclasses.fields(port_obj):
        a, b = getattr(port_obj, f.name), getattr(jax_obj, f.name)
        if dataclasses.is_dataclass(a):
            _assert_tree_equal(a, b)
        elif a is None:
            assert b is None, f.name
        else:
            np.testing.assert_array_equal(n(a), n(b), err_msg=f.name)


def test_render_config_fields_and_defaults():
    jf = [(f.name, f.default) for f in dataclasses.fields(JConfig)]
    pf = [(f.name, f.default) for f in dataclasses.fields(PConfig)]
    assert jf == pf
    assert PConfig(width=3, height=5, spp=2).n_pixel_samples == 30


@pytest.mark.parametrize("ball", [None, "mirror", "glass"])
def test_cornell_box_arrays_equal(ball):
    js, jc = j_presets.cornell_box(24, ball=ball)
    ps, pc = p_presets.cornell_box("cpu", 24, ball=ball)
    _assert_tree_equal(ps, np_tree(js))
    _assert_tree_equal(pc, np_tree(jc))
    # the interop path gives the same scene as the port's own builder
    _assert_tree_equal(port_scene(js), ps)


def test_sphere_plane_and_builder_lights_equal():
    js, _ = j_presets.sphere_plane(16)
    ps, _ = p_presets.sphere_plane("cpu", 16)
    _assert_tree_equal(ps, np_tree(js))

    def build(b, **kw):
        m = b.matte((0.4, 0.5, 0.6), texture="checker")
        b.disk(height=0.2, radius=2.0, inner_radius=0.5, phi_max_deg=270.0,
               material=m, object_to_world=j_tr.rotate(30.0, (1, 1, 0)))
        b.sphere(0.5, material=b.mirror(), reverse_orientation=True,
                 object_to_world=j_tr.translate(1, 2, 3))
        b.point_light((1.0, 2.0, 3.0), (5.0, 5.0, 5.0))
        b.distant_light((0.3, -1.0, -0.5), (2.0, 2.0, 2.0))
        return b.build(**kw)

    _assert_tree_equal(build(PBuilder(), device="cpu"), np_tree(build(
        JBuilder())))


def test_scene_with_materials_and_lights():
    """Scene.with_materials / with_lights swap one table and keep the rest,
    in both packages alike."""
    js, _ = j_presets.cornell_box(16, ball="mirror")
    jl, _ = j_presets.sphere_plane(16)
    ps, pl = port_scene(js), port_scene(jl)
    j_new = js.with_materials(jl.materials).with_lights(jl.lights)
    p_new = ps.with_materials(pl.materials).with_lights(pl.lights)
    assert p_new.materials is pl.materials and p_new.lights is pl.lights
    assert p_new.tris is ps.tris and ps.lights is not pl.lights
    _assert_tree_equal(p_new, np_tree(j_new))


@pytest.mark.parametrize("spp,jitter", [(1, True), (4, True), (2, False)])
def test_pixel_samples(spp, jitter):
    jxy, jlens = j_camera.pixel_samples(jax.random.PRNGKey(3), 12, 10, spp,
                                        jitter=jitter)
    pxy, plens = p_camera.pixel_samples(prng.PRNGKey(3, "cpu"), 12, 10, spp,
                                        jitter=jitter)
    np.testing.assert_array_equal(n(jxy), n(pxy))
    np.testing.assert_array_equal(n(jlens), n(plens))


@pytest.mark.parametrize("lens_radius", [0.0, 0.05])
def test_generate_rays(lens_radius):
    c2w = j_tr.look_at((0.0, -2.4, 1.0), (0.0, 1.0, 1.0), (0.0, 0.0, 1.0))
    jc = j_camera.PerspectiveCamera.make(c2w, 60.0, 20, 14,
                                         lens_radius=lens_radius,
                                         focal_distance=3.0)
    pc = p_camera.PerspectiveCamera.make(c2w, 60.0, 20, 14,
                                         lens_radius=lens_radius,
                                         focal_distance=3.0, device="cpu")
    _assert_tree_equal(pc, np_tree(jc))
    _assert_tree_equal(interop.camera_from_numpy(np_tree(jc), "cpu"), pc)
    xy, lens = j_camera.pixel_samples(jax.random.PRNGKey(1), 20, 14, 2)
    jr = j_camera.generate_rays(jc, xy, lens, 2)
    pr = p_camera.generate_rays(pc, t(xy), t(lens), 2)
    for f in ("o", "d", "rx_o", "rx_d", "ry_o", "ry_d"):
        np.testing.assert_allclose(n(getattr(pr, f)), n(getattr(jr, f)),
                                   rtol=RTOL, atol=ATOL, err_msg=f)


def _materials():
    jb, pb = JBuilder(), PBuilder()
    for b in (jb, pb):
        b.matte((0.7, 0.2, 0.1))
        b.mirror((0.9, 0.8, 0.7))
        b.glass(1.5)
        b.matte((0.3, 0.6, 0.9), texture="checker", tex_scale=4.0)
    return (np_tree(jb.build()).materials,
            pb.build("cpu").materials)


def _unit(rng, k):
    v = rng.normal(size=(k, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _shading_inputs(seed, k=256):
    rng = np.random.default_rng(seed)
    mat = rng.integers(-1, 4, k).astype(np.int32)
    ns, dpdu, wo = _unit(rng, k), _unit(rng, k), _unit(rng, k)
    u = rng.uniform(size=(k, 2)).astype(np.float32)
    uv = rng.uniform(size=(k, 2)).astype(np.float32)
    return mat, ns, dpdu, wo, u, uv


@pytest.mark.parametrize("seed", [0, 1])
def test_material_functions(seed):
    jm, pm = _materials()
    jm = jax.tree_util.tree_map(jnp.asarray, jm)
    mat, ns, dpdu, wo, u, uv = _shading_inputs(seed)
    J = lambda x: jnp.asarray(x)
    np.testing.assert_array_equal(
        n(j_mat.texture_eval(jm, J(mat), J(uv))),
        n(p_mat.texture_eval(pm, t(mat), t(uv))))
    np.testing.assert_allclose(
        n(p_mat.f(pm, t(mat), t(wo), t(wo), uv=t(uv))),
        n(j_mat.f(jm, J(mat), J(wo), J(wo), uv=J(uv))), rtol=RTOL, atol=ATOL)
    for name in ("is_specular", "kd_in_specular"):
        np.testing.assert_array_equal(
            n(getattr(j_mat, name)(jm, J(mat))),
            n(getattr(p_mat, name)(pm, t(mat))))
    jf = j_mat.sample_f(jm, J(mat), J(ns), J(dpdu), J(wo), J(u[:, 0]),
                        J(u[:, 1]), uv=J(uv))
    pf = p_mat.sample_f(pm, t(mat), t(ns), t(dpdu), t(wo), t(u[:, 0]),
                        t(u[:, 1]), uv=t(uv))
    for a, b in zip(pf, jf):
        np.testing.assert_allclose(n(a), n(b), rtol=RTOL, atol=ATOL)
    js = j_mat.specular(jm, J(mat), J(ns), J(dpdu), J(wo))
    ps = p_mat.specular(pm, t(mat), t(ns), t(dpdu), t(wo))
    for a, b in zip(ps, js):
        np.testing.assert_allclose(n(a), n(b), rtol=RTOL, atol=ATOL)


def _light_scenes():
    out = []
    for b in (JBuilder(), PBuilder()):
        m = b.matte()
        b.triangle_mesh(np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0.]]),
                        np.array([[0, 1, 2]]), material=m)
        b.point_light((0.5, 0.2, 2.0), (3.0, 2.0, 1.0))
        b.area_light_disk((4.0, 4.0, 4.0), radius=0.4,
                          object_to_world=j_tr.translate(0, 0, 1.5)
                          @ j_tr.rotate(180.0, (1, 0, 0)))
        b.distant_light((0.2, 0.1, -1.0), (1.0, 0.5, 0.25))
        out.append(b)
    return np_tree(out[0].build()).lights, out[1].build("cpu").lights


@pytest.mark.parametrize("i_light", [0, 1, 2])
def test_light_functions(i_light):
    jl, pl = _light_scenes()
    jl = jax.tree_util.tree_map(jnp.asarray, jl)
    rng = np.random.default_rng(i_light)
    k = 200
    p = rng.uniform(-1, 1, (k, 3)).astype(np.float32)
    u = rng.uniform(size=(k, 4)).astype(np.float32)
    J = jnp.asarray
    ji = j_light.sample_L_illum(jl, i_light, J(p), J(u[:, :2]))
    pi = p_light.sample_L_illum(pl, i_light, t(p), t(u[:, :2]))
    for a, b in zip(pi, ji):
        np.testing.assert_allclose(n(a), n(b), rtol=RTOL, atol=ATOL)
    for lidx in (i_light, rng.integers(0, 3, k).astype(np.int32)):
        je = j_light.sample_Le(jl, J(lidx) if np.ndim(lidx) else lidx,
                               *(J(u[:, c]) for c in range(4)))
        pe = p_light.sample_Le(pl, t(lidx) if np.ndim(lidx) else lidx,
                               *(t(u[:, c]) for c in range(4)))
        for a, b in zip(pe, je):
            np.testing.assert_allclose(n(a), n(b), rtol=RTOL, atol=ATOL)
    lid = rng.integers(-1, 3, k).astype(np.int32)
    wow = _unit(rng, k)
    np.testing.assert_array_equal(
        n(j_light.light_L(jl, J(lid), J(wow))),
        n(p_light.light_L(pl, t(lid), t(wow))))
