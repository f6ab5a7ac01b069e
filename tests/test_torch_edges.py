"""The port's edge gradients (raytrace_tpu_torch/diff/edges.py) against the
JAX package's on the same inputs, at 32×32 on the CPU, and its FD checks and
geometry fits.

Bounds: an image derivative dimg to relative L1 ≤ 1e-4 of JAX's, with at
most 1% of its nonzero pixels off by more than 1e-3 of max |dimg|; a
weighted scalar within 1e-4 relative; silhouette integers equal, front
normals within 1e-6; the projection's JVP to rtol 1e-5.

The quad cases sit at θ = 0.03, not 0: at θ = 0 the shadow of the quad's
right edge lands exactly on the image's centre line, a pixel boundary,
where the last bit of a raster coordinate picks the pixel (both packages
are right there, and they split those samples differently)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_edge_scenes as ps
from tests.torch_port_util import n
from raytrace_tpu.core.config import RenderConfig as JConfig
from raytrace_tpu.diff import edges as J
from raytrace_tpu.ops import intersect as j_isect
from raytrace_tpu.scene import transform as j_tr
from raytrace_tpu.scene.builder import SceneBuilder as JBuilder
from raytrace_tpu.scene.camera import PerspectiveCamera as JCamera
from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.core.config import RenderConfig as PConfig
from raytrace_tpu_torch.diff import edges as P
from raytrace_tpu_torch.ops import intersect as p_isect
from raytrace_tpu_torch.renderers.simple import render_simple

SIZE = 32
THETA = 0.03
X = [1.0, 0.0, 0.0]
CFG = dict(width=SIZE, height=SIZE, spp=1, scene_epsilon=1e-3)


def j_camera():
    c2w = j_tr.look_at((0.0, 0.0, 6.0), (0.0, 1e-6, 0.0), (0.0, 1.0, 0.0))
    return JCamera.make(c2w, 2 * np.degrees(np.arctan(1.5 / 6.0)), SIZE,
                        SIZE)


def j_occluder_scene(verts, faces, occ_kd=(0.3, 0.3, 0.3), light=ps.LIGHT):
    """ps.occluder_scene on the JAX package's builder."""
    b = JBuilder()
    floor = b.matte((0.7, 0.7, 0.7))
    occ = b.matte(occ_kd)
    b.triangle_mesh(ps.FLOOR, ps.QUAD_FACES, material=floor)
    b.triangle_mesh(np.asarray(verts, np.float64), faces, material=occ)
    b.point_light(light, ps.INTENSITY)
    return b.build()


def weights(seed=3):
    return ps.weights(SIZE, seed)


def assert_dimg_close(got, want):
    """dimg against JAX's, and its weighted sum (ps.dimg_check)."""
    ps.dimg_check(n(got), n(want))


def scalar_close(got, want, rel=ps.SCALAR_REL):
    got, want = float(got), float(want)
    assert abs(got - want) <= rel * abs(want), (got, want)


# ---------------------------------------------------------------------------
# Projection
# ---------------------------------------------------------------------------

def _points(count=64, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1.5, 1.5, size=(count, 3)).astype(np.float32)
    p[:, 2] = rng.uniform(0.0, 4.0, size=count)
    return p


def test_project_to_raster_matches_jax():
    p = _points()
    want = np.asarray(J.project_to_raster(j_camera(), jnp.asarray(p)))
    got = n(P.project_to_raster(ps.camera("cpu", SIZE), torch.tensor(p)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_projection_jvp_matches_jax():
    p = _points()
    tans = np.random.default_rng(1).normal(size=(3, 64, 3)).astype(
        np.float32)
    jc, pc = j_camera(), ps.camera("cpu", SIZE)
    xy, outs = P._project_jvp(pc, torch.tensor(p),
                              *(torch.tensor(t) for t in tans))
    for tan, got in zip(tans, outs):
        want_xy, want = jax.jvp(lambda q: J.project_to_raster(jc, q),
                                (jnp.asarray(p),), (jnp.asarray(tan),))
        np.testing.assert_allclose(n(xy), np.asarray(want_xy), rtol=1e-5)
        np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# Silhouettes
# ---------------------------------------------------------------------------

MESHES = {
    "cube": lambda: ps.cube_mesh((0.0, 0.0, 0.0)),
    "icosphere320": lambda: ps.icosphere(2, 0.5, (0.2, -0.1, 0.3)),
}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_edge_adjacency_matches_jax(mesh):
    v, f = MESHES[mesh]()
    want_vid, want_fid = J.mesh_edge_adjacency(f)
    got_vid, got_fid = P.mesh_edge_adjacency(f)
    np.testing.assert_array_equal(got_vid, want_vid)
    np.testing.assert_array_equal(got_fid, want_fid)
    assert got_vid.dtype == want_vid.dtype and (got_fid >= 0).all()
    assert len(got_vid) == 3 * len(f) // 2  # closed: E = 3F/2


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("viewpoint", [(0.0, 0.0, 10.0), (3.0, 2.0, 7.0),
                                       ps.LIGHT])
def test_silhouettes_match_jax(mesh, viewpoint):
    v, f = MESHES[mesh]()
    vp = np.asarray(viewpoint, np.float32)
    want = J.silhouette_edges_full(v, f, jnp.asarray(vp))
    got = P.silhouette_edges_full(torch.tensor(v, dtype=torch.float32), f,
                                  torch.tensor(vp))
    np.testing.assert_array_equal(n(got[2]), np.asarray(want[2]))
    np.testing.assert_array_equal(n(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(n(got[1]), np.asarray(want[1]))
    np.testing.assert_allclose(n(got[3]), np.asarray(want[3]), atol=1e-6)
    assert int(n(got[2]).sum()) > 0
    _, fid = P.mesh_edge_adjacency(f)
    np.testing.assert_array_equal(
        n(P.silhouette_mask(torch.tensor(v, dtype=torch.float32),
                            torch.tensor(f), torch.tensor(fid),
                            torch.tensor(vp))), np.asarray(want[2]))
    # the numpy and the JAX route give the same edges
    np.testing.assert_array_equal(
        n(P.silhouette_edges(v, f, vp)[2]), np.asarray(want[2]))


def test_quad_boundary_edges_match_jax():
    c = ps.occ_corners(THETA)
    for got, want in zip(P.quad_boundary_edges(c), J.quad_boundary_edges(c)):
        np.testing.assert_array_equal(n(got), np.asarray(want))


# ---------------------------------------------------------------------------
# Shadow-boundary and primary-boundary estimators
# ---------------------------------------------------------------------------

def _per_edge_vel(shape):
    return np.random.default_rng(7).normal(size=shape).astype(np.float32)


def _quad(edge_vel):
    c = ps.occ_corners(THETA)
    return dict(verts=c, faces=ps.QUAD_FACES, edges="quad", vel=edge_vel)


SHADOW_CASES = {
    # quad out of view: rigid, per-edge and per-endpoint velocities
    "quad_rigid": lambda: _quad(np.asarray(X, np.float32)),
    "quad_per_edge": lambda: _quad(_per_edge_vel((4, 3))),
    "quad_per_endpoint": lambda: _quad(_per_edge_vel((4, 2, 3))),
    # closed cube out of view: all 18 edges with the silhouette mask
    "cube_mask": lambda: dict(
        verts=ps.cube_mesh((1.7 + THETA, 0.0, ps.OCC_Z))[0],
        faces=ps.cube_mesh((0, 0, 0))[1], edges="mask", vel=X),
    # the cube in view: mask and occluder box
    "in_view_aabb": lambda: dict(
        verts=ps.cube_mesh((0.3, 0.0, 0.8))[0],
        faces=ps.cube_mesh((0, 0, 0))[1], edges="mask", vel=X,
        aabb=True, occ_kd=(0.25, 0.4, 0.3)),
}


def _shadow_inputs(case):
    c = SHADOW_CASES[case]()
    v, f = c["verts"], c["faces"]
    kd = c.get("occ_kd", (0.3, 0.3, 0.3))
    js = j_occluder_scene(v, f, occ_kd=kd)
    pscene = ps.occluder_scene("cpu", v, f, occ_kd=kd)
    if c["edges"] == "quad":
        jargs = (*J.quad_boundary_edges(v), jnp.asarray(c["vel"]))
        pargs = (*P.quad_boundary_edges(v), torch.tensor(c["vel"]))
        jkw, pkw = {}, {}
    else:
        lp = np.asarray(ps.LIGHT, np.float32)
        e0, e1, m = J.silhouette_edges(v, f, jnp.asarray(lp))
        jargs, jkw = (e0, e1, jnp.asarray(c["vel"])), dict(edge_mask=m)
        e0, e1, m = P.silhouette_edges(v, f, torch.tensor(lp))
        pargs, pkw = (e0, e1, c["vel"]), dict(edge_mask=m)
    if c.get("aabb"):
        lo, hi = v.min(0).astype(np.float32), v.max(0).astype(np.float32)
        jkw["occluder_aabb"] = (jnp.asarray(lo), jnp.asarray(hi))
        pkw["occluder_aabb"] = (torch.tensor(lo), torch.tensor(hi))
    return js, pscene, jargs, pargs, jkw, pkw


@pytest.mark.parametrize("case", list(SHADOW_CASES))
def test_shadow_boundary_matches_jax(case):
    js, pscene, jargs, pargs, jkw, pkw = _shadow_inputs(case)
    want = J.shadow_boundary_image_grad(js, j_camera(), JConfig(**CFG),
                                        *jargs, samples_per_edge=64, **jkw)
    got = P.shadow_boundary_image_grad(pscene, ps.camera("cpu", SIZE),
                                       PConfig(**CFG), *pargs,
                                       samples_per_edge=64, **pkw)
    assert_dimg_close(got, want)


def test_masked_edges_contribute_exactly_zero():
    _, pscene, _, pargs, _, pkw = _shadow_inputs("cube_mask")
    cam, cfg = ps.camera("cpu", SIZE), PConfig(**CFG)
    full = P.shadow_boundary_image_grad(pscene, cam, cfg, *pargs, **pkw)
    only = pkw["edge_mask"].clone()
    only[torch.nonzero(only)[0]] = False
    part = P.shadow_boundary_image_grad(pscene, cam, cfg, *pargs,
                                        edge_mask=only)
    none = P.shadow_boundary_image_grad(
        pscene, cam, cfg, *pargs, edge_mask=torch.zeros_like(only))
    assert float(none.abs().sum()) == 0.0
    assert 0.0 < float(part.abs().sum()) < float(full.abs().sum())


def test_splat_keeps_nan_and_off_image_points_out():
    """NaN, infinite and off-image raster points, and a NaN contribution
    of an off-image point, leave the image untouched."""
    xy = torch.tensor([[1.5, 2.5], [float("nan"), 3.0], [3.0, float("inf")],
                       [-0.5, 1.0], [SIZE + 0.0, 1.0], [1.0, 1e20],
                       [2.25, 2.75]])
    contrib = torch.ones((7, 3))
    contrib[1:6] = float("nan")
    img = P._splat(xy, contrib, PConfig(**CFG))
    want = torch.zeros((SIZE, SIZE, 3))
    want[2, 1] = 1.0
    want[2, 2] = 1.0
    assert torch.equal(img, want)


def _in_view_primary():
    v, f = ps.cube_mesh((0.3, 0.0, 0.8))
    js = j_occluder_scene(v, f, occ_kd=(0.25, 0.4, 0.3))
    pscene = ps.occluder_scene("cpu", v, f, occ_kd=(0.25, 0.4, 0.3))
    cam_o = np.asarray(j_camera().camera_to_world)[:, 3]
    return v, f, js, pscene, cam_o


def _grazing_flips(pscene, js, e0, e1, mask, cam_o, k):
    """Silhouette samples whose front ray (camera → edge point, the
    fallback's re-intersection) hits on one side and misses on the other:
    the ray grazes the edge, and the last bit of the barycentric test
    decides → (such samples, the masked samples)."""
    _, e, _ = P._edge_samples(e0, e1, k)
    w = e - torch.tensor(cam_o, dtype=torch.float32)
    t_e = torch.linalg.vector_norm(w, dim=-1)
    d = w / t_e[:, None]
    m = e.shape[0]
    o = torch.tensor(cam_o, dtype=torch.float32).expand(m, 3).contiguous()
    tmin, tmax = torch.full((m,), 1e-3), t_e * (1.0 + 1e-4)
    got = p_isect.intersect(pscene, o, d, tmin, tmax).valid.numpy()
    want = np.asarray(j_isect.intersect(
        js, jnp.asarray(n(o)), jnp.asarray(n(d)), jnp.asarray(n(tmin)),
        jnp.asarray(n(tmax))).valid)
    sample_mask = np.repeat(n(mask), k)
    return int(((got != want) & sample_mask).sum()), int(sample_mask.sum())


def _inset_edges(v, f, cam_o, share=0.05):
    """The silhouette edges w.r.t. the camera, each moved `share` of the way
    toward its front face's centroid: the fallback's front ray then hits
    that face inside, not on its edge."""
    e0, e1, mask, _ = P.silhouette_edges_full(v, f, cam_o)
    vid, fid = P.mesh_edge_adjacency(f)
    c = v[f].mean(1)  # face centroids
    n_f = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    front = (n_f * (cam_o - v[f[:, 0]])).sum(-1) > 0.0
    fc = np.where(front[fid[:, 0]][:, None], c[fid[:, 0]], c[fid[:, 1]])
    a, b = v[vid[:, 0]], v[vid[:, 1]]
    inset = lambda p: (p + share * (fc - p)).astype(np.float32)
    return inset(a), inset(b), n(mask)


@pytest.mark.parametrize("branch", ["front_normal", "reintersect"])
def test_primary_boundary_matches_jax(branch):
    """Both branches. The re-intersecting fallback casts a ray that grazes
    the silhouette edge, where XLA and PyTorch round the barycentric test
    differently (JAX documents the fallback missing ~half its samples in
    float32): that count is bounded, and the two are held to the usual
    bounds on the silhouette edges moved 5% into their front faces, where
    the front ray hits a face inside."""
    v, f, js, pscene, cam_o = _in_view_primary()
    k = 64
    fn = branch == "front_normal"
    if fn:
        jw = J.silhouette_edges_full(v, f, cam_o)
        pw = P.silhouette_edges_full(v, f, cam_o)
        jargs, pargs = (jw[0], jw[1]), (pw[0], pw[1])
        jkw = dict(edge_mask=jw[2], front_normal=jw[3])
        pkw = dict(edge_mask=pw[2], front_normal=pw[3])
    else:
        pw = P.silhouette_edges_full(v, f, cam_o)
        flips, samples = _grazing_flips(pscene, js, pw[0], pw[1], pw[2],
                                        cam_o, k)
        assert flips <= samples // 2, (flips, samples)
        a, b, mask = _inset_edges(v, f, cam_o)
        jargs, pargs = (jnp.asarray(a), jnp.asarray(b)), (a, b)
        jkw, pkw = dict(edge_mask=jnp.asarray(mask)), dict(edge_mask=mask)
    want = J.primary_boundary_image_grad(
        js, j_camera(), JConfig(**CFG), *jargs, jnp.asarray(X),
        samples_per_edge=k, front_mat=1, **jkw)
    got = P.primary_boundary_image_grad(
        pscene, ps.camera("cpu", SIZE), PConfig(**CFG), *pargs, X,
        samples_per_edge=k, front_mat=1, **pkw)
    assert_dimg_close(got, want)


# ---------------------------------------------------------------------------
# Losses over θ, against JAX at θ ≠ 0
# ---------------------------------------------------------------------------

FIT_CFG = dict(CFG, spp=4)


def test_translation_loss_and_grad_matches_jax():
    v, f = ps.cube_mesh((1.7, 0.0, ps.OCC_Z))
    target = np.random.default_rng(2).uniform(
        0.0, 0.2, (SIZE, SIZE, 3)).astype(np.float32)
    want = J.translation_loss_and_grad(
        THETA, jnp.asarray(X), v, f, lambda vv: j_occluder_scene(vv, f),
        j_camera(), JConfig(**FIT_CFG), jnp.asarray(target),
        jax.random.PRNGKey(17), samples_per_edge=64)
    got = P.translation_loss_and_grad(
        THETA, X, v, f, ps.mesh_builder("cpu", f), ps.camera("cpu", SIZE),
        PConfig(**FIT_CFG), torch.tensor(target), prng.PRNGKey(17, "cpu"),
        samples_per_edge=64)
    scalar_close(got[0], want[0])
    scalar_close(got[1], want[1])
    img, jimg = n(got[2]), np.asarray(want[2])
    assert np.abs(img - jimg).sum() / np.abs(jimg).sum() <= ps.REL_L1


def test_jacobian_loss_and_grad_matches_jax():
    base, vel, build = ps.dof_parts("cpu")
    thetas = np.array([THETA, -0.02])
    jbuild = lambda vv: j_occluder_scene(vv, ps.QUAD_FACES,
                                         light=ps.DOF_LIGHT)
    target = np.zeros((SIZE, SIZE, 3), np.float32)
    want = J.jacobian_loss_and_grad(
        thetas, vel, base, ps.QUAD_FACES, jbuild, j_camera(),
        JConfig(**FIT_CFG), jnp.asarray(target), jax.random.PRNGKey(17),
        samples_per_edge=64)
    got = P.jacobian_loss_and_grad(
        thetas, vel, base, ps.QUAD_FACES, build, ps.camera("cpu", SIZE),
        PConfig(**FIT_CFG), torch.tensor(target), prng.PRNGKey(17, "cpu"),
        samples_per_edge=64)
    scalar_close(got[0], want[0])
    assert got[1].shape == (2,)
    for d in range(2):
        scalar_close(got[1][d], want[1][d])


# ---------------------------------------------------------------------------
# The port alone: FD and the geometry fits, at tests/test_edges.py's
# settings and bounds
# ---------------------------------------------------------------------------

SPP = 64
KEY = 17


def test_shadow_boundary_gradient_matches_fd():
    cam = ps.camera("cpu", SIZE)
    config = PConfig(width=SIZE, height=SIZE, spp=SPP, scene_epsilon=1e-3)
    wmat = torch.tensor(weights())

    def loss_at(theta):
        img = render_simple(ps.quad_scene("cpu", theta), cam, config,
                            prng.PRNGKey(KEY, "cpu"), jitter=True)
        return float(torch.mean(img * wmat))

    h = 0.06
    fd = (loss_at(+h) - loss_at(-h)) / (2 * h)
    e0, e1 = P.quad_boundary_edges(ps.occ_corners(0.0))
    dimg = P.shadow_boundary_image_grad(ps.quad_scene("cpu", 0.0), cam,
                                        config, e0, e1, X,
                                        samples_per_edge=256)
    ad = float(torch.mean(dimg * wmat))
    assert abs(fd) > 1e-5, "shadow must actually move the loss"
    assert np.sign(fd) == np.sign(ad), (fd, ad)
    assert abs(fd - ad) <= 0.25 * max(abs(fd), abs(ad)), (fd, ad)


def test_occluder_translation_recovery():
    cam = ps.camera("cpu", SIZE)
    config = PConfig(width=SIZE, height=SIZE, spp=16, scene_epsilon=1e-3)
    scene, v, f = ps.cube_scene("cpu", 0.0)
    key = prng.PRNGKey(KEY, "cpu")
    target = render_simple(scene, cam, config, key, jitter=True)
    theta_hat, losses = P.recover_translation(
        0.22, X, v, f, ps.mesh_builder("cpu", f), cam, config, target, key,
        steps=20, lr=2.0, samples_per_edge=128, jitter=True)
    assert losses[-1] < 0.25 * losses[0], losses
    assert abs(theta_hat) < 0.06, (theta_hat, losses)


def test_recover_two_dofs():
    cam = ps.camera("cpu", SIZE)
    config = PConfig(width=SIZE, height=SIZE, spp=16, scene_epsilon=1e-3)
    base, vel, build = ps.dof_parts("cpu")
    key = prng.PRNGKey(KEY, "cpu")
    target = render_simple(build(torch.tensor(base, dtype=torch.float32)),
                           cam, config, key, jitter=True)
    th0 = np.array([0.35, -0.3])
    th_hat, losses = P.recover_dofs(
        th0, vel, base, ps.QUAD_FACES, build, cam, config, target, key,
        steps=26, lr=0.4, samples_per_edge=128)
    assert np.linalg.norm(th_hat) < 0.35 * np.linalg.norm(th0), (th_hat,
                                                                 losses)
