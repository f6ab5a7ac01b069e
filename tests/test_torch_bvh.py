"""BVH build, traversal and the large-scene builder of the PyTorch port
against the JAX package (raytrace_tpu/ops/bvh.py, scene/builder.py) on the
same numpy inputs, on the CPU."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import assert_t_close, n, np_tree, port_scene, t
from raytrace_tpu.ops import bvh as j_bvh
from raytrace_tpu.ops import bvh_native as j_bvh_native
from raytrace_tpu.scene import presets as j_presets
from raytrace_tpu.scene.builder import SceneBuilder as JBuilder
from raytrace_tpu_torch.ops import bvh as p_bvh
from raytrace_tpu_torch.ops import bvh_native as p_bvh_native
from raytrace_tpu_torch.ops import cuda_lib
from raytrace_tpu_torch.scene import presets as p_presets
from raytrace_tpu_torch.scene.builder import SceneBuilder as PBuilder

BIG = 1e30
_ARRAYS = ("bmin", "bmax", "right", "first", "count", "axis")


def _soup(n_tris, seed):
    """tests/test_bvh.py random_soup_scene's triangles, as [T, 3] arrays."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-4, 4, (n_tris, 3))
    offs = rng.normal(size=(n_tris, 3, 3)) * 0.35
    v = (centers[:, None, :] + offs).astype(np.float32)
    return v[:, 0], v[:, 1], v[:, 2]


def _soup_builder(builder, n_tris, seed=3):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-4, 4, (n_tris, 3))
    offs = rng.normal(size=(n_tris, 3, 3)) * 0.35
    verts = (centers[:, None, :] + offs).reshape(-1, 3)
    b = builder()
    m = b.matte((0.5, 0.5, 0.5))
    b.triangle_mesh(verts, np.arange(3 * n_tris).reshape(-1, 3), material=m)
    b.point_light((0, 0, 10), (100.0, 100.0, 100.0))
    return b


def _rays(count, seed):
    """tests/test_bvh.py random_rays."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-5, 5, (count, 3)).astype(np.float32)
    d = rng.normal(size=(count, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _assert_arrays_equal(pa, ja):
    for k in _ARRAYS:
        np.testing.assert_array_equal(n(pa[k]), n(ja[k]), err_msg=k)
    assert pa["max_depth"] == ja["max_depth"]
    assert pa["leaf_size"] == ja["leaf_size"]


def _assert_bvh_equal(pb, jb):
    for k in _ARRAYS + ("skip", "packed"):
        np.testing.assert_array_equal(n(getattr(pb, k)), n(getattr(jb, k)),
                                      err_msg=k)
    assert (pb.max_depth, pb.leaf_size) == (jb.max_depth, jb.leaf_size)


@pytest.mark.parametrize("n_tris,seed,leaf", [(300, 0, 4), (777, 1, 2),
                                               (64, 2, 8)])
def test_median_build_skip_links_and_packed(n_tris, seed, leaf):
    v0, v1, v2 = _soup(n_tris, seed)
    ja, jperm = j_bvh.build_bvh(v0, v1, v2, leaf_size=leaf)
    pa, pperm = p_bvh.build_bvh(v0, v1, v2, leaf_size=leaf)
    _assert_arrays_equal(pa, ja)
    np.testing.assert_array_equal(pperm, jperm)
    np.testing.assert_array_equal(
        p_bvh.compute_skip_links(pa["right"], pa["count"]),
        j_bvh.compute_skip_links(ja["right"], ja["count"]))
    _assert_bvh_equal(p_bvh.bvh_from_arrays(pa, "cpu"),
                      np_tree(j_bvh.bvh_from_arrays(ja)))


@pytest.mark.parametrize("n_tris,seed", [(800, 3), (2000, 4)])
def test_sah_build_equals_jax_native(n_tris, seed):
    """The port's copy of csrc/bvh_builder.cc builds what JAX's native
    builder builds, arrays and permutation; JAX took its native builder
    (not the median fallback), and the port warned of no fallback."""
    v0, v1, v2 = _soup(n_tris, seed)
    ja, jperm = j_bvh.build_bvh_native(v0, v1, v2)
    na, nperm = j_bvh_native.build_bvh_sah(v0, v1, v2)
    _assert_arrays_equal(ja, na)
    np.testing.assert_array_equal(jperm, nperm)
    _, mperm = j_bvh.build_bvh(v0, v1, v2)
    assert not np.array_equal(jperm, mperm)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pa, pperm = p_bvh.build_bvh_native(v0, v1, v2)
    _assert_arrays_equal(pa, ja)
    np.testing.assert_array_equal(pperm, jperm)


def test_sah_fallback_warns(monkeypatch, tmp_path):
    """Without a working C++ compiler the median split builds, with a
    RuntimeWarning, never silently."""
    v0, v1, v2 = _soup(100, 5)
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(p_bvh_native, "_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.warns(RuntimeWarning, match="median split"):
        pa, pperm = p_bvh.build_bvh_native(v0, v1, v2)
    ma, mperm = p_bvh.build_bvh(v0, v1, v2)
    _assert_arrays_equal(pa, ma)
    np.testing.assert_array_equal(pperm, mperm)


@pytest.fixture(scope="module")
def soup_scenes():
    js = _soup_builder(JBuilder, 800).build(use_bvh=True)
    return js, port_scene(js)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("ray_seed", [11, 12])
def test_traverse_equals_jax(soup_scenes, any_hit, ray_seed):
    """Closest-hit and any-hit traversal on tests/test_bvh.py's soup: t
    within rtol 1e-6; idx equal wherever t is not tied."""
    js, ps = soup_scenes
    o, d = _rays(512, ray_seed)
    tmin = np.full(512, 1e-3, np.float32)
    tmax = np.where(np.arange(512) % 3 == 0, 2.5, BIG).astype(np.float32)
    jt, ji = j_bvh._traverse(js.bvh, js.tris, jnp.asarray(o), jnp.asarray(d),
                             jnp.asarray(tmin), jnp.asarray(tmax), any_hit)
    pt, pi = p_bvh._traverse(ps.bvh, ps.tris, t(o), t(d), t(tmin), t(tmax),
                             any_hit)
    jt, ji = n(jt), n(ji)
    assert_t_close(n(pt), jt)
    hit = jt < np.minimum(BIG, tmax)
    assert hit.sum() > 50
    if not any_hit:
        # where the winners differ, both triangles must reach the same t
        differ = hit & (n(pi) != ji)
        found = t(np.ones(512, bool))
        ta, _, _ = p_bvh.reintersect_winner(ps.tris, pi, t(o), t(d), found)
        tb, _, _ = p_bvh.reintersect_winner(ps.tris, t(ji), t(o), t(d), found)
        assert_t_close(n(ta)[differ], n(tb)[differ], share=0.0)
        assert differ.sum() <= 2
    assert pi.dtype == torch.int32


def test_intersect_triangles_bvh_reintersects(soup_scenes):
    js, ps = soup_scenes
    o, d = _rays(400, 13)
    tmin = np.full(400, 1e-3, np.float32)
    tmax = np.full(400, BIG, np.float32)
    jr = j_bvh.intersect_triangles_bvh(js.bvh, js.tris, jnp.asarray(o),
                                       jnp.asarray(d), jnp.asarray(tmin),
                                       jnp.asarray(tmax))
    pr = p_bvh.intersect_triangles_bvh(ps.bvh, ps.tris, t(o), t(d), t(tmin),
                                       t(tmax))
    np.testing.assert_array_equal(n(pr[1]), n(jr[1]))
    for k in (0, 2, 3):
        np.testing.assert_allclose(n(pr[k]), n(jr[k]), rtol=2e-5,
                                   atol=2e-6)
    # the re-intersection keeps the differentiable surface: d t / d o
    o_req = t(o).requires_grad_(True)
    tt, _, _, _ = p_bvh.intersect_triangles_bvh(ps.bvh, ps.tris, o_req, t(d),
                                                t(tmin), t(tmax))
    hit = tt < BIG
    tt[hit].sum().backward()
    assert torch.isfinite(o_req.grad).all() and o_req.grad[hit].abs().sum() > 0
    occ = p_bvh.occluded_triangles_bvh(ps.bvh, ps.tris, t(o), t(d), t(tmin),
                                       t(tmax))
    jocc = j_bvh.occluded_triangles_bvh(js.bvh, js.tris, jnp.asarray(o),
                                        jnp.asarray(d), jnp.asarray(tmin),
                                        jnp.asarray(tmax))
    np.testing.assert_array_equal(n(occ), n(jocc))


@pytest.mark.parametrize("n_tris", [511, 512])
def test_auto_bvh_threshold(n_tris):
    """Below 512 triangles no BVH or cluster set; from 512 on both, equal
    to JAX's."""
    js = _soup_builder(JBuilder, n_tris).build()
    ps = _soup_builder(PBuilder, n_tris).build("cpu")
    assert (js.bvh is None) == (ps.bvh is None) == (n_tris < 512)
    assert (js.clusters is None) == (ps.clusters is None)
    np.testing.assert_array_equal(n(ps.tris.v0), n(js.tris.v0))
    if n_tris >= 512:
        _assert_bvh_equal(ps.bvh, np_tree(js.bvh))
        for k in ("tv", "cmin", "cmax"):
            np.testing.assert_array_equal(n(getattr(ps.clusters, k)),
                                          n(getattr(js.clusters, k)))


def test_triangle_field_build_equals_jax():
    """SceneBuilder.build on triangle_field(2048): every triangle array in
    the SAH permutation, the BVH and the cluster set (256-triangle clusters,
    padded to 128) equal JAX's; interop carries JAX's scene across
    unchanged."""
    js, jc = j_presets.triangle_field(2048, 16)
    ps, pc = p_presets.triangle_field("cpu", 2048, 16)
    jt = np_tree(js)
    for k in ("v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
              "has_normals", "mat", "light"):
        np.testing.assert_array_equal(n(getattr(ps.tris, k)),
                                      n(getattr(jt.tris, k)), err_msg=k)
    _assert_bvh_equal(ps.bvh, jt.bvh)
    assert ps.clusters.tv.shape == (128, 9, 256)
    assert ps.clusters.n_tris == js.clusters.n_tris == 2048
    for k in ("tv", "cmin", "cmax"):
        np.testing.assert_array_equal(n(getattr(ps.clusters, k)),
                                      n(getattr(jt.clusters, k)), err_msg=k)
    xs = port_scene(js)
    _assert_bvh_equal(xs.bvh, ps.bvh)
    assert torch.equal(xs.clusters.tv, ps.clusters.tv)
    np.testing.assert_array_equal(n(pc.camera_to_world),
                                  n(jc.camera_to_world))
