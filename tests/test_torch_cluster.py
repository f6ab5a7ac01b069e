"""The cluster engine of the PyTorch port (ops/cluster_intersect.py, kernels
K6 and K7 through their plain versions) against the JAX package's
raytrace_tpu/ops/cluster_intersect.py, whose Pallas kernels run with
interpret=True, on the same numpy inputs, on the CPU; and JAX's routing of
coherent launches to it.

JAX's interpret mode steps through every one of its pair_budget·rounds grid
points, so its calls here take budgets of at most 2^11 on a few hundred
rays. The budgets are JAX's alone: the port runs every pair of a launch.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_cluster_intersect import down_rays, field_scene
from tests.test_epoch_intersect import _random_tris, _rays
from tests.test_torch_epoch import _assert_same_hits
from tests.torch_port_util import n, t
from raytrace_tpu.ops import cluster_intersect as j_ci
from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.core.config import RenderConfig as PConfig
from raytrace_tpu_torch.ops import cluster_intersect as p_ci
from raytrace_tpu_torch.ops import cluster_kernels as ck
from raytrace_tpu_torch.ops import epoch_kernels as ek
from raytrace_tpu_torch.ops import intersect as p_isect
from raytrace_tpu_torch.ops.work_items import work_items
from raytrace_tpu_torch.renderers import photon as p_photon
from raytrace_tpu_torch.renderers import simple as p_simple
from raytrace_tpu_torch.scene import presets as p_presets

BIG = 1e30
# cluster route against epoch route on one frame: both exact, they break
# ties between triangles at the same t differently (a shared terrain edge)
FRAME_REL_L1, PIXEL_OFF_FRAC = 1e-4, 0.01


def _clusters(v0, v1, v2, size):
    return (j_ci.build_clusters(v0, v1, v2, cluster_size=size),
            p_ci.build_clusters(v0, v1, v2, "cpu", cluster_size=size))


def _counts():
    return ck.cull_tiles.launches, ck.pair_hits.launches


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------

def _cull_inputs(n_rays, seed):
    """900 random triangles sorted along x in clusters of 128 (8 real
    clusters, padded to 128 with +inf/-inf boxes) and rays in tile order:
    live rays with axis-parallel directions among them, dead rays (tmax ≤
    tmin), and the engine's zero padding rays at the end."""
    rng = np.random.default_rng(seed)
    v0, v1, v2 = _random_tris(900, rng)
    by_x = np.argsort(v0[:, 0] + v1[:, 0] + v2[:, 0])  # boxes: slabs in x
    v0, v1, v2 = v0[by_x], v1[by_x], v2[by_x]
    o, d = _rays(n_rays, rng)
    d[::97, 1] = 0.0  # inv = 1e30
    d[::89, 2] = 0.0
    tmin = np.full(n_rays, 1e-3, np.float32)
    tmax = np.where(rng.random(n_rays) < 0.3, rng.random(n_rays) * 8,
                    BIG).astype(np.float32)
    dead = rng.random(n_rays) < 0.1
    tmin[dead], tmax[dead] = 1.0, 0.5
    n_pad = 300
    o[-n_pad:], d[-n_pad:], tmin[-n_pad:], tmax[-n_pad:] = 0.0, 0.0, 0.0, 0.0
    return (v0, v1, v2), o, d, tmin, tmax


@pytest.mark.parametrize("tile_rays", [128, 256])
def test_cull_plain_equals_jax(tile_rays):
    """Plain K6 against JAX `_cull` (interpret): the same mask, bit for bit;
    the padding clusters pass for every tile, the padded rays' tiles
    included, as JAX's slab test makes them."""
    (v0, v1, v2), o, d, tmin, tmax = _cull_inputs(2048, tile_rays)
    jcs, pcs = _clusters(v0, v1, v2, 128)
    n_tiles = 2048 // tile_rays
    jmask = j_ci._cull(jcs, jnp.asarray(o.T), jnp.asarray(d.T),
                       jnp.asarray(tmin)[None, :], jnp.asarray(tmax)[None, :],
                       n_tiles, True, tile_rays=tile_rays)
    pmask = ck.cull_tiles(t(o), t(d), t(tmin), t(tmax), pcs.cmin, pcs.cmax,
                          tile_rays)
    assert pmask.dtype == torch.uint8 and pmask.shape == (n_tiles, 128)
    np.testing.assert_array_equal(n(pmask).astype(np.float32), n(jmask))
    real = -(-900 // 128)
    assert n(pmask)[:, real:].all()
    # the last tile holds only padding rays (o = d = 0, tmin = tmax = 0):
    # they pass for exactly the boxes that hold the origin
    holds_origin = (n(pcs.cmin)[:real] < 0).all(1) & (
        n(pcs.cmax)[:real] > 0).all(1)
    assert holds_origin.any() and not holds_origin.all()
    np.testing.assert_array_equal(n(pmask)[-1, :real], holds_origin)


# ---------------------------------------------------------------------------
# intersect_clusters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def field():
    """tests/test_cluster_intersect.py's 4,000-triangle terrain in BVH
    order (every seed there gives the same terrain) → (v0, v1, v2, the
    two packages' cluster sets of 256)."""
    tris = field_scene(n_tris=4000).tris
    v0, v1, v2 = (np.asarray(x) for x in (tris.v0, tris.v1, tris.v2))
    return (v0, v1, v2) + _clusters(v0, v1, v2, 256)


def _field_case(name):
    """The rays of each case of tests/test_cluster_intersect.py → (o, d,
    tmin, tmax, keyword arguments for both engines, JAX's pair_budget among
    them). 300 rays (off the tile boundary) and a budget of 2^10 wherever
    the case allows, so that JAX compiles its interpret-mode engine once
    for them."""
    big = lambda k: np.full(k, BIG, np.float32)
    eps = lambda k: np.full(k, 1e-3, np.float32)
    kw = dict(pair_budget=1 << 10)
    o, d = (n(x) for x in down_rays(300))
    if name == "unsorted":
        kw["sort_rays"] = False
    elif name == "tmax_window":
        # rays start 5.5–6.5 above the terrain: most end before it
        return o, d, eps(300), np.full(300, 7.0, np.float32), kw
    elif name == "all_miss":
        rng = np.random.default_rng(1)
        o = np.stack([rng.uniform(-3, 3, 300), rng.uniform(-3, 3, 300),
                      np.full(300, 8.0)], -1).astype(np.float32)
        d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (300, 1))
    elif name == "tile_256":
        o, d = (n(x) for x in down_rays(600, seed=13))
        return o, d, eps(600), big(600), dict(pair_budget=1 << 11,
                                              tile_rays=256)
    else:
        assert name == "closest_hit"
    return o, d, eps(300), big(300), kw


def _run_both(field, o, d, tmin, tmax, pair_budget, **kw):
    """JAX's engine at `pair_budget`, which must hold the launch (its own
    overflow 0), and the port's → ([t, idx], [t, idx]) as numpy."""
    v0, v1, v2, jcs, pcs = field
    jr = j_ci.intersect_clusters(jcs, jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(tmin), jnp.asarray(tmax),
                                 interpret=True, pair_budget=pair_budget,
                                 **kw)
    assert int(jr[3]) == 0
    before = _counts()
    pr = p_ci.intersect_clusters(pcs, t(o), t(d), t(tmin), t(tmax), **kw)
    assert _counts() == before  # CPU tensors: plain versions, no launch
    return [n(x) for x in jr[:2]], [n(x) for x in pr]


@pytest.mark.parametrize("name", ["closest_hit", "tmax_window", "all_miss",
                                  "tile_256", "unsorted"])
def test_intersect_clusters_equals_jax(field, name):
    """Each case of tests/test_cluster_intersect.py that JAX's budget holds,
    tile sizes 128 and 256, sort_rays on and off: t and idx as
    tests/test_torch_epoch.py holds the epoch engine."""
    o, d, tmin, tmax, kw = _field_case(name)
    jr, pr = _run_both(field, o, d, tmin, tmax, **kw)
    _assert_same_hits(jr, pr, *field[:3], o, d)
    hits = int((pr[0] < BIG).sum())
    if name == "all_miss":
        assert hits == 0
    else:
        share = 0.1 if name == "tmax_window" else 0.3
        assert hits > share * o.shape[0]
    if name == "tmax_window":
        hit = pr[0] < BIG
        assert ((pr[0][hit] > 1e-3) & (pr[0][hit] < 7.0)).all()
        assert hits < 0.9 * o.shape[0]


def test_tie_between_clusters(field):
    """The same large triangle at indices 5 and 300 (clusters 0 and 1): on
    the rays that hit it both engines name the lower index."""
    v0, v1, v2 = (x.copy() for x in field[:3])
    big = np.array([[-1.0, -1.0, 2.0], [1.0, -1.0, 2.0], [0.0, 1.0, 2.0]],
                   np.float32)
    for k in (5, 300):
        v0[k], v1[k], v2[k] = big
    rng = np.random.default_rng(31)
    o = np.zeros((300, 3), np.float32)
    o[:, :2] = (rng.random((300, 2)) - 0.5).astype(np.float32) * 0.6
    o[:, 2] = 4.0 + rng.random(300).astype(np.float32)
    d = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (300, 1))
    tmin, tmax = np.full(300, 1e-3, np.float32), np.full(300, BIG, np.float32)
    tied = (v0, v1, v2) + _clusters(v0, v1, v2, 256)
    jr, pr = _run_both(tied, o, d, tmin, tmax, pair_budget=1 << 10)
    on_big = np.isclose(jr[0], o[:, 2] - 2.0, rtol=1e-6)
    assert on_big.all()
    assert (jr[1] == 5).all() and (pr[1] == 5).all()
    _assert_same_hits(jr, pr, v0, v1, v2, o, d)


def _tied_clusters(field):
    """The field with the same large triangle at indices 5 and 300 (clusters
    0 and 1 of 256), and 256 rays straight down onto it (tiles 0 and 1)."""
    v0, v1, v2 = (x.copy() for x in field[:3])
    big = np.array([[-1.0, -1.0, 2.0], [1.0, -1.0, 2.0], [0.0, 1.0, 2.0]],
                   np.float32)
    for k in (5, 300):
        v0[k], v1[k], v2[k] = big
    rng = np.random.default_rng(31)
    o = np.zeros((256, 3), np.float32)
    o[:, :2] = (rng.random((256, 2)) - 0.5).astype(np.float32) * 0.6
    o[:, 2] = 4.0 + rng.random(256).astype(np.float32)
    d = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (256, 1))
    return p_ci.build_clusters(v0, v1, v2, "cpu", cluster_size=256), t(o), t(d)


# (case, pairs of tile 0, pairs per work item): the terrain's pairs one at a
# time, in items of 2 and 3 (the last one short) and in one item; clusters 0
# and 1, which hold the same triangle, in two items (a tie across an item
# boundary) and in one
FOLDS = [("terrain", [0, 3, 4, 9, 15], 1), ("terrain", [0, 3, 4, 9, 15], 2),
         ("terrain", [0, 3, 4, 9, 15], 3), ("terrain", [0, 3, 4, 9, 15], 5),
         ("tie", [0, 1], 1), ("tie", [0, 1], 2)]


@pytest.mark.parametrize("case,pairs,size", FOLDS,
                         ids=[f"{c}-{len(p)}pairs-items_of_{s}"
                              for c, p, s in FOLDS])
def test_pair_hits_plain_folds_pairs_in_any_grouping(field, case, pairs,
                                                     size):
    """Plain K7 over one tile's pairs equals the fold of its work items
    (ops/work_items.py), each through the plain version, by K7's rule
    across items: the smaller t, at equal t the lower index. Tile 1 has no
    pair, hence no item, and stays the defined miss (1e30, 0)."""
    if case == "tie":
        pcs, o, d = _tied_clusters(field)
    else:
        pcs = field[4]
        o, d = (t(n(x)) for x in down_rays(256, seed=3))
    tmin = torch.full((256,), 1e-3)
    tmax = torch.full((256,), BIG)
    pairs = torch.tensor(pairs, dtype=torch.int32)
    begin = torch.tensor([0, len(pairs)], dtype=torch.int32)
    end = torch.tensor([len(pairs), len(pairs)], dtype=torch.int32)
    t_all, i_all = ck.pair_hits_plain(pairs, begin, end, o, d, tmin, tmax,
                                      pcs.tv)
    _, lo, hi, first, count = work_items(begin, end, size,
                                         2 + len(pairs) // size)
    assert count.tolist() == [-(-len(pairs) // size), 0]
    t_ref = torch.full((128,), BIG)
    i_ref = torch.zeros((128,), dtype=torch.int32)
    for k in range(int(count[0])):
        t_p, i_p = ck.pair_hits_plain(pairs[lo[k]:hi[k]], begin[:1] * 0,
                                      hi[k:k + 1] - lo[k:k + 1], o[:128],
                                      d[:128], tmin[:128], tmax[:128], pcs.tv)
        better = (t_p < t_ref) | ((t_p == t_ref) & (i_p < i_ref))
        t_ref, i_ref = torch.where(better, t_p, t_ref), torch.where(
            better, i_p, i_ref)
    assert torch.equal(t_all[:128], t_ref) and torch.equal(i_all[:128], i_ref)
    assert (t_all[:128] < BIG).sum() > 8
    assert (t_all[128:] == BIG).all() and (i_all[128:] == 0).all()
    if case == "tie":  # every ray hits both copies at one t: the lower wins
        assert torch.equal(t_all[:128], o[:128, 2] - 2.0)
        assert (i_all[:128] == 5).all()


def test_wrappers_on_cpu_take_the_plain_versions(field):
    """On CPU tensors the wrappers return the plain versions' results and
    count no launch."""
    (v0, v1, v2), o, d, tmin, tmax = _cull_inputs(512, 7)
    _, pcs = _clusters(v0, v1, v2, 128)
    before = _counts()
    args = (t(o), t(d), t(tmin), t(tmax), pcs.cmin, pcs.cmax, 128)
    assert torch.equal(ck.cull_tiles(*args), ck.cull_tiles_plain(*args))
    pargs = (torch.tensor([0, 2, 1], dtype=torch.int32),
             torch.tensor([0, 2, 3, 3], dtype=torch.int32),
             torch.tensor([2, 3, 3, 3], dtype=torch.int32),
             t(o), t(d), t(tmin), t(tmax), pcs.tv)
    for a, b in zip(ck.pair_hits(*pargs), ck.pair_hits_plain(*pargs)):
        assert torch.equal(a, b)
    assert _counts() == before


# ---------------------------------------------------------------------------
# routing through the renderers; intersect_rounds and
# intersect_budget_scale, which only JAX reads
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def terrain():
    return p_presets.triangle_field("cpu", 2048, 24)


def test_render_routes_and_rounds(terrain, monkeypatch):
    """render_photon sends its camera and shadow launches to the cluster
    engine and its photon walk to the epoch engine; render_simple with
    intersect_rounds 2 and intersect_budget_scale 1e-3 equals the default
    frame bit for bit, without a warning; the cluster route and the epoch
    route give the same frame up to tie breaks."""
    scene, cam = terrain
    calls = []
    for mod, fn in ((p_isect.cluster_intersect, "intersect_clusters"),
                    (p_isect.epoch_intersect, "intersect_epochs")):
        orig = getattr(mod, fn)

        def spy(*args, _orig=orig, _fn=fn, **kw):
            calls.append((_fn, args[1].shape[0]))
            return _orig(*args, **kw)

        monkeypatch.setattr(mod, fn, spy)
    cfg = PConfig(width=24, height=24, spp=1, scene_epsilon=1e-3,
                  photon_paths=1 << 10, max_photon_bounces=4,
                  footprint_radius_scale=8.0, initial_radius2=0.04,
                  intersect_rounds=3)
    _, aux = p_photon.render_photon(scene, cam, cfg, prng.PRNGKey(0, "cpu"),
                                    return_aux=True)
    assert int(aux["pair_overflow"]) == 0
    coherent = [c for c in calls if c[0] == "intersect_clusters"]
    walk = [c for c in calls if c[0] == "intersect_epochs"]
    # the camera launch and one shadow launch (one point light)
    assert [c[1] for c in coherent] == [576, 576]
    assert walk and max(c[1] for c in walk) <= 1 << 10

    base = dict(width=24, height=24, spp=1, scene_epsilon=1e-3)
    key = prng.PRNGKey(1, "cpu")
    img = p_simple.render_simple(scene, cam, PConfig(**base), key)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        img2 = p_simple.render_simple(
            scene, cam, PConfig(**base, intersect_rounds=2,
                                intersect_budget_scale=1e-3), key)
    assert torch.equal(img, img2)
    monkeypatch.setenv("RAYTRACE_TPU_ENGINE", "epoch")
    calls.clear()
    img_e = p_simple.render_simple(scene, cam, PConfig(**base), key)
    assert {c[0] for c in calls} == {"intersect_epochs"}
    img, img_e = n(img), n(img_e)
    assert img.mean() > 0.01
    rel_l1 = np.abs(img - img_e).sum() / np.abs(img_e).sum()
    off = np.abs(img - img_e).max(-1) > 1e-3 * np.maximum(img_e.max(-1), 1.0)
    assert rel_l1 <= FRAME_REL_L1 and off.mean() <= PIXEL_OFF_FRAC


def test_engines_agree_on_a_camera_launch(terrain):
    """The cluster and epoch engines on one 24×24 camera launch: hit/miss
    flips and idx differences at equal t counted and bounded, t within
    2e-5 where both hit; no kernel launch on the CPU."""
    scene, cam = terrain
    from raytrace_tpu_torch.ops import epoch_intersect as p_ei
    from raytrace_tpu_torch.scene.camera import generate_rays, pixel_samples
    xy, lens = pixel_samples(prng.PRNGKey(3, "cpu"), 24, 24, 1, jitter=False)
    rays = generate_rays(cam, xy, lens, 1)
    k = rays.o.shape[0]
    lo, hi = torch.full((k,), 1e-3), torch.full((k,), BIG)
    before = _counts() + (ek.cull_bits.launches, ek.mt_jobs.launches)
    tc, ic = p_ci.intersect_clusters(scene.clusters, rays.o, rays.d, lo, hi)
    te, ie = p_ei.intersect_epochs(scene.clusters, rays.o, rays.d, lo, hi)
    assert _counts() + (ek.cull_bits.launches, ek.mt_jobs.launches) == before
    hc, he = tc < BIG, te < BIG
    assert hc.sum() > 0.5 * k
    assert int((hc != he).sum()) <= 0.005 * k
    both = hc & he
    np.testing.assert_allclose(n(tc[both]), n(te[both]), rtol=2e-5)
    assert int((both & (ic != ie)).sum()) <= 0.01 * k
