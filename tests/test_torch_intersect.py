"""Kernel K1's plain version and the port's `intersect`/`occluded` against
the JAX package: the Pallas kernel in interpret mode, the jnp scan, and the
full family combine on Cornell camera and bounce rays.

Every comparison has two parts: the rays whose outcome flips (hit vs miss,
or another primitive) are counted and bounded, and the remaining rays are
allclose. Flips come from grazing hits on shared edges, where XLA and
PyTorch round the same Möller–Trumbore terms differently; they are never
hidden by a wider tolerance.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_port_util import n, port_scene, t
from raytrace_tpu.ops import intersect as j_isect
from raytrace_tpu.ops import pallas_intersect as j_pallas
from raytrace_tpu.scene import camera as j_camera
from raytrace_tpu.scene import presets as j_presets
from raytrace_tpu.scene import transform as j_tr
from raytrace_tpu.scene.builder import SceneBuilder as JBuilder
from raytrace_tpu.scene.scene import Triangles as JTriangles
from raytrace_tpu_torch.ops import intersect as p_isect
from raytrace_tpu_torch.ops import tri_intersect as p_tri
from raytrace_tpu_torch.scene.scene import Triangles as PTriangles

BIG = 1e30
# float32 Möller–Trumbore terms of O(1) scenes: a few ulps apart
RTOL, ATOL = 1e-5, 1e-5


def _flip_bound(n_rays):
    """At most 0.2% of the rays (and at least 2) may flip."""
    return max(2, int(0.002 * n_rays))


def _soup(seed, n_rays=700, n_tris=300):
    """Random triangles (a tenth degenerate: a point or a line) and rays
    with random t-windows, some of them empty or short."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    v1 = (v0 + rng.normal(0, 0.3, (n_tris, 3))).astype(np.float32)
    v2 = (v0 + rng.normal(0, 0.3, (n_tris, 3))).astype(np.float32)
    deg = rng.uniform(size=n_tris) < 0.1
    v1[deg] = v0[deg]
    line = rng.uniform(size=n_tris) < 0.05
    v2[line] = (2 * v1[line] - v0[line])
    o = rng.uniform(-1.5, 1.5, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = rng.choice([0.0, 1e-3, 0.5], n_rays).astype(np.float32)
    tmax = rng.choice([BIG, 1.0, 0.0, 2.5], n_rays).astype(np.float32)
    return o, d, tmin, tmax, v0, v1, v2


def _tris_pair(v0, v1, v2):
    k = v0.shape[0]
    z3 = np.zeros((k, 3), np.float32)
    z2 = np.zeros((k, 2), np.float32)
    fields = dict(v0=v0, v1=v1, v2=v2, n0=z3, n1=z3, n2=z3, uv0=z2, uv1=z2,
                  uv2=z2, has_normals=np.zeros(k, bool),
                  mat=np.zeros(k, np.int32), light=np.full(k, -1, np.int32))
    return (JTriangles(**{a: jnp.asarray(b) for a, b in fields.items()}),
            PTriangles(**{a: t(b) for a, b in fields.items()}))


def _agree(idx_a, t_a, idx_b, t_b):
    hit_a, hit_b = t_a < BIG, t_b < BIG
    return (hit_a == hit_b) & (~hit_a | (idx_a == idx_b))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k1_plain_matches_pallas_kernel_and_scan(seed):
    o, d, tmin, tmax, v0, v1, v2 = _soup(seed)
    jt, pt = _tris_pair(v0, v1, v2)
    J = jnp.asarray
    want = j_pallas.intersect_triangles_pallas(jt, J(o), J(d), J(tmin),
                                               J(tmax), interpret=True)
    got = p_tri.intersect_triangles(pt, t(o), t(d), t(tmin), t(tmax))
    ok = _agree(n(want[1]), n(want[0]), n(got[1]), n(got[0]))
    assert (~ok).sum() <= _flip_bound(len(o))
    assert (n(got[0]) < BIG).sum() > 100  # the soup is really hit
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a)[ok], n(b)[ok], rtol=RTOL, atol=ATOL)

    # the raw kernel contract against the jnp scan: same winner, same t
    class _Scene:
        tris = jt

    s_t, s_i, _, _ = j_isect.intersect_triangles(_Scene, J(o), J(d),
                                                 J(tmin), J(tmax))
    k_t, k_i = p_tri.closest_hit_plain(t(o), t(d), t(tmin), t(tmax), t(v0),
                                       t(v1), t(v2))
    ok = _agree(n(s_i), n(s_t), n(k_i), n(k_t))
    assert (~ok).sum() <= _flip_bound(len(o))
    miss = n(k_t) >= BIG
    assert (n(k_i)[miss] == 0).all() and (n(k_t)[miss] == BIG).all()
    np.testing.assert_allclose(n(k_t)[ok & ~miss], n(s_t)[ok & ~miss],
                               rtol=RTOL, atol=ATOL)
    # the kernel's (t, idx) is the wrapper's winner; its t is the
    # re-intersected one's up to rounding
    np.testing.assert_array_equal(n(got[1])[~miss], n(k_i)[~miss])
    np.testing.assert_allclose(n(got[0])[~miss], n(k_t)[~miss], rtol=RTOL,
                               atol=ATOL)
    assert (n(got[0])[miss] == BIG).all()


def test_k1_plain_matches_pallas_kernel_at_511_triangles():
    """The top of K1's range: 511 triangles (the builder's BVH threshold −
    1), one 512-triangle chunk of the Pallas kernel, a few hundred rays."""
    o, d, tmin, tmax, v0, v1, v2 = _soup(11, n_rays=400, n_tris=511)
    jt, pt = _tris_pair(v0, v1, v2)
    J = jnp.asarray
    want = j_pallas.intersect_triangles_pallas(jt, J(o), J(d), J(tmin),
                                               J(tmax), interpret=True)
    k_t, k_i = p_tri.closest_hit_plain(t(o), t(d), t(tmin), t(tmax), t(v0),
                                       t(v1), t(v2))
    ok = _agree(n(want[1]), n(want[0]), n(k_i), n(k_t))
    assert (~ok).sum() <= _flip_bound(len(o))
    hit = ok & (n(k_t) < BIG)
    assert hit.sum() > 100
    np.testing.assert_allclose(n(k_t)[hit], n(want[0])[hit], rtol=RTOL,
                               atol=ATOL)
    got = p_tri.intersect_triangles(pt, t(o), t(d), t(tmin), t(tmax))
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a)[ok], n(b)[ok], rtol=RTOL, atol=ATOL)


def test_k1_tie_keeps_lowest_index():
    """Two copies of one triangle: the lower index must win, as in the TPU
    kernel (lowest lane within a chunk, strict < across chunks)."""
    v0 = np.array([[-1, -1, 1], [5, 5, 5], [-1, -1, 1]], np.float32)
    v1 = np.array([[1, -1, 1], [6, 5, 5], [1, -1, 1]], np.float32)
    v2 = np.array([[0, 1, 1], [5, 6, 5], [0, 1, 1]], np.float32)
    o = np.zeros((4, 3), np.float32)
    d = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    big = np.full(4, BIG, np.float32)
    tt, idx = p_tri.closest_hit_plain(t(o), t(d), t(big * 0), t(big), t(v0),
                                      t(v1), t(v2))
    np.testing.assert_array_equal(n(idx), 0)
    np.testing.assert_allclose(n(tt), 1.0)


def _hit_fields_close(a, b, rtol=RTOL, atol=ATOL):
    """Per-ray: the two Intersections agree on validity, material and
    every attribute (the rest are counted as flips)."""
    valid = n(a.valid)
    ok = (valid == n(b.valid)) & (n(a.mat) == n(b.mat))
    for f in ("t", "p", "ng", "ns", "dpdu", "dpdv", "uv"):
        x, y = n(getattr(a, f)), n(getattr(b, f))
        close = np.isclose(x, y, rtol=rtol, atol=atol)
        # a miss carries no hit frame to compare
        ok &= close.reshape(len(ok), -1).all(axis=1) | ~valid
    return ok


def _cornell_rays(size=24):
    js, jc = j_presets.cornell_box(size, ball="glass")
    xy, lens = j_camera.pixel_samples(jax.random.PRNGKey(0), size, size, 1)
    rays = j_camera.generate_rays(jc, xy, lens, 1)
    return js, np.asarray(rays.o), np.asarray(rays.d)


def test_intersect_cornell_camera_and_bounce_rays():
    js, o, d = _cornell_rays()
    ps = port_scene(js)
    m = len(o)
    J = jnp.asarray
    eps = np.full(m, 1e-3, np.float32)
    big = np.full(m, BIG, np.float32)
    jh = j_isect.intersect(js, J(o), J(d), J(eps), J(big))
    ph = p_isect.intersect(ps, t(o), t(d), t(eps), t(big))
    ok = _hit_fields_close(ph, jh)
    assert (~ok).sum() <= _flip_bound(m)
    assert n(ph.valid).mean() > 0.4  # the open box fills half the view
    np.testing.assert_array_equal(n(ph.light)[ok], n(jh.light)[ok])

    # bounce rays: from each hit, a random direction into the box
    rng = np.random.default_rng(4)
    bo = np.asarray(jh.p)
    bd = rng.normal(size=(m, 3)).astype(np.float32)
    bd /= np.linalg.norm(bd, axis=1, keepdims=True)
    ng = np.asarray(jh.ng)
    bd = np.where((np.sum(bd * ng, 1) * np.sum(-d * ng, 1) < 0)[:, None],
                  -bd, bd).astype(np.float32)
    jb = j_isect.intersect(js, J(bo), J(bd), J(eps), J(big))
    pb = p_isect.intersect(ps, t(bo), t(bd), t(eps), t(big))
    ok = _hit_fields_close(pb, jb)
    assert (~ok).sum() <= _flip_bound(m)

    # shadow rays toward random points near the ceiling light
    target = rng.uniform([-0.5, 0.5, 1.9], [0.5, 1.5, 1.99], (m, 3))
    uwi = (target - bo).astype(np.float32)
    lo, hi = np.full(m, 1e-3, np.float32), np.full(m, 1 - 1e-3, np.float32)
    j_occ, _ = j_isect.occluded_aux(js, J(bo), J(uwi), J(lo), J(hi))
    p_occ = p_isect.occluded(ps, t(bo), t(uwi), t(lo), t(hi))
    assert (n(j_occ) != n(p_occ)).sum() <= _flip_bound(m)
    assert 0 < n(p_occ).sum() < m


def test_intersect_many_spheres_and_disks():
    """More than 8 spheres and disks take the batched [N, C] tests.

    Tolerance: a small sphere seen from afar is ill-conditioned in float32
    — with the origin at |oo| ≈ 10 and r ≥ 0.2 the quadratic's b² − 4ac
    cancels log2(|oo|²/r²) ≈ 11 bits, so t agrees to ~3e-5 relative and
    the normal p/r to ~1e-4."""
    rng = np.random.default_rng(9)
    b = JBuilder()
    mats = [b.matte((0.5, 0.5, 0.5)), b.glass(1.5)]
    for i in range(10):
        b.sphere(float(rng.uniform(0.2, 0.6)), material=mats[i % 2],
                 object_to_world=j_tr.translate(*rng.uniform(-3, 3, 3)),
                 reverse_orientation=bool(i % 3 == 0))
        b.disk(height=float(rng.uniform(-1, 1)),
               radius=float(rng.uniform(0.3, 1.0)),
               inner_radius=0.1, phi_max_deg=300.0, material=mats[0],
               object_to_world=j_tr.translate(*rng.uniform(-3, 3, 3))
               @ j_tr.rotate(float(rng.uniform(0, 180)), (1, 0.5, 0)))
    js = b.build()
    ps = port_scene(js)
    m = 600
    o = rng.uniform(-5, 5, (m, 3)).astype(np.float32)
    d = (rng.uniform(-3, 3, (m, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lo, hi = np.full(m, 1e-3, np.float32), np.full(m, BIG, np.float32)
    J = jnp.asarray
    jh = j_isect.intersect(js, J(o), J(d), J(lo), J(hi))
    ph = p_isect.intersect(ps, t(o), t(d), t(lo), t(hi))
    ok = _hit_fields_close(ph, jh, rtol=2e-4, atol=2e-4)
    assert (~ok).sum() <= _flip_bound(m)
    assert 50 < n(ph.valid).sum() < m
    j_occ, _ = j_isect.occluded_aux(js, J(o), J(d), J(lo), J(hi))
    p_occ = p_isect.occluded(ps, t(o), t(d), t(lo), t(hi))
    np.testing.assert_array_equal(n(p_occ), n(ph.valid))
    assert (n(j_occ) != n(p_occ)).sum() <= _flip_bound(m)


def test_k1_wrapper_takes_plain_version_on_cpu():
    o, d, tmin, tmax, v0, v1, v2 = _soup(5, n_rays=64, n_tris=20)
    before = p_tri.closest_hit.launches
    args = [t(x) for x in (o, d, tmin, tmax, v0, v1, v2)]
    for a, b in zip(p_tri.closest_hit(*args), p_tri.closest_hit_plain(*args)):
        np.testing.assert_array_equal(n(a), n(b))
    assert p_tri.closest_hit.launches == before  # no kernel on CPU tensors


@pytest.mark.parametrize("case", ["cornell_shadow", "soup"])
def test_occluded_triangles_takes_the_kernel_t(case):
    """The any-hit query on the K1 route reads the kernel's t and does not
    re-intersect the winner: the same mask as the re-intersected
    `t < BIG`, and as JAX's on this route,
    `intersect_triangles_pallas(..., interpret=True)[0] < BIG`."""
    J = jnp.asarray
    if case == "soup":
        o, d, lo, hi, v0, v1, v2 = _soup(3)
        jt, pt = _tris_pair(v0, v1, v2)
        scene = SimpleNamespace(tris=pt, clusters=None, bvh=None)
    else:
        # shadow rays from the camera's hits: toward the ceiling light
        # (which no wall blocks) and toward points around the box, which
        # the walls block
        js, co, cd = _cornell_rays()
        m = len(co)
        jh = j_isect.intersect(js, J(co), J(cd),
                               J(np.full(m, 1e-3, np.float32)),
                               J(np.full(m, BIG, np.float32)))
        o = np.asarray(jh.p)
        rng = np.random.default_rng(6)
        target = np.where(
            (np.arange(m) % 2 == 0)[:, None],
            rng.uniform([-0.5, 0.5, 1.9], [0.5, 1.5, 1.99], (m, 3)),
            rng.uniform([-3.0, -2.0, -1.0], [3.0, 4.0, 3.0], (m, 3)))
        d = (target - o).astype(np.float32)
        lo = np.full(m, 1e-3, np.float32)
        hi = np.full(m, 1 - 1e-3, np.float32)
        scene = port_scene(js)
        jt = js.tris
    args = [t(x) for x in (o, d, lo, hi)]
    occ = p_isect._occluded_triangles(scene, *args, False)
    before = p_tri.intersect_triangles(scene.tris, *args)[0] < BIG
    np.testing.assert_array_equal(n(occ), n(before))
    want = j_pallas.intersect_triangles_pallas(
        jt, *(J(x) for x in (o, d, lo, hi)), interpret=True)[0] < BIG
    np.testing.assert_array_equal(n(occ), n(want))
    assert 0 < n(occ).sum() < len(o)
