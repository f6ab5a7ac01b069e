"""The cluster engine of the PyTorch port (ops/cluster_intersect.py, kernels
K6 and K7 through their plain versions) against the JAX package's
raytrace_tpu/ops/cluster_intersect.py, whose Pallas kernels run with
interpret=True, on the same numpy inputs, on the CPU; and JAX's routing of
coherent launches to it.

JAX's interpret mode steps through every one of its pair_budget·rounds grid
points, so its calls here take budgets of at most 2^11 on a few hundred
rays.
"""
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
    tmin, tmax, keyword arguments for both engines). 300 rays (off the tile
    boundary) and a budget of 2^10 wherever the case allows, so that JAX
    compiles its interpret-mode engine once for them."""
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
    elif name == "overflow":
        o, d = (n(x) for x in down_rays(512, seed=12))
        return o, d, eps(512), big(512), dict(pair_budget=4)
    elif name == "tile_256":
        o, d = (n(x) for x in down_rays(600, seed=13))
        return o, d, eps(600), big(600), dict(pair_budget=1 << 11,
                                              tile_rays=256)
    else:
        assert name == "closest_hit"
    return o, d, eps(300), big(300), kw


def _run_both(field, o, d, tmin, tmax, **kw):
    v0, v1, v2, jcs, pcs = field
    jr = j_ci.intersect_clusters(jcs, jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(tmin), jnp.asarray(tmax),
                                 interpret=True, **kw)
    before = _counts()
    pr = p_ci.intersect_clusters(pcs, t(o), t(d), t(tmin), t(tmax), **kw)
    assert _counts() == before  # CPU tensors: plain versions, no launch
    assert pr[2].dtype == pr[3].dtype == torch.int64
    return [n(x) for x in jr], [n(x) for x in pr]


@pytest.mark.parametrize("name", ["closest_hit", "tmax_window", "all_miss",
                                  "overflow", "tile_256", "unsorted"])
def test_intersect_clusters_equals_jax(field, name):
    """Each case of tests/test_cluster_intersect.py, tile sizes 128 and 256,
    sort_rays on and off: n_pairs and overflow equal integers, t and idx as
    tests/test_torch_epoch.py holds the epoch engine (truncated tiles are
    the same defined misses on both sides)."""
    o, d, tmin, tmax, kw = _field_case(name)
    jr, pr = _run_both(field, o, d, tmin, tmax, **kw)
    _assert_same_hits(jr, pr, *field[:3], o, d)
    hits = int((pr[0] < BIG).sum())
    if name == "all_miss":
        assert hits == 0
    elif name == "overflow":
        assert int(pr[3]) == int(pr[2]) - 4 > 0
    else:
        share = 0.1 if name == "tmax_window" else 0.3
        assert int(pr[3]) == 0 and hits > share * o.shape[0]
    if name == "tmax_window":
        hit = pr[0] < BIG
        assert ((pr[0][hit] > 1e-3) & (pr[0][hit] < 7.0)).all()
        assert hits < 0.9 * o.shape[0]


def test_rounds_equal_one_round_and_jax(field):
    """rounds × pair_budget capacity (tests/test_cluster_intersect.py
    multiround): rounds that hold the whole list equal one large round bit
    for bit and JAX's rounds; two rounds overflow, equal JAX's defined
    misses for the dropped tail, and every other ray keeps its exact
    hit."""
    v0, v1, v2, _, pcs = field
    o, d = (n(x) for x in down_rays(1024, seed=8))
    tmin, tmax = np.full(1024, 1e-3, np.float32), np.full(1024, BIG,
                                                         np.float32)
    ref = p_ci.intersect_clusters(pcs, t(o), t(d), t(tmin), t(tmax),
                                  pair_budget=1 << 14)
    n_pairs = int(ref[2])
    assert int(ref[3]) == 0
    b = max(2, n_pairs // 5)
    rounds = -(-n_pairs // b) + 1
    jr, pr = _run_both(field, o, d, tmin, tmax, pair_budget=b, rounds=rounds)
    assert int(pr[3]) == 0 and int(pr[2]) == n_pairs
    assert np.array_equal(pr[0], n(ref[0])) and np.array_equal(pr[1],
                                                               n(ref[1]))
    _assert_same_hits(jr, pr, v0, v1, v2, o, d)
    jr, pr = _run_both(field, o, d, tmin, tmax, pair_budget=b, rounds=2)
    assert int(pr[3]) == n_pairs - 2 * b > 0
    _assert_same_hits(jr, pr, v0, v1, v2, o, d)
    kept = pr[0] < BIG
    np.testing.assert_array_equal(pr[0][kept], n(ref[0])[kept])
    assert (pr[1][~kept] == 0).all() and kept.sum() < (n(ref[0]) < BIG).sum()


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


def test_pair_hits_plain_folds_pairs_in_any_grouping(field):
    """Plain K7 over one tile's pairs equals the fold of its pairs one at a
    time (strict `<`, earlier pair kept on ties), with a tile of no pairs a
    defined miss."""
    _, _, _, _, pcs = field
    o, d = (t(n(x)) for x in down_rays(256, seed=3))
    tmin = torch.full((256,), 1e-3)
    tmax = torch.full((256,), BIG)
    pairs = torch.tensor([0, 3, 4, 9, 15], dtype=torch.int32)
    begin = torch.tensor([0, 5], dtype=torch.int32)
    end = torch.tensor([5, 5], dtype=torch.int32)
    t_all, i_all = ck.pair_hits_plain(pairs, begin, end, o, d, tmin, tmax,
                                      pcs.tv)
    t_ref = torch.full((128,), BIG)
    i_ref = torch.zeros((128,), dtype=torch.int32)
    for p in range(5):
        t_p, i_p = ck.pair_hits_plain(pairs[p:p + 1], begin[:1] * 0,
                                      begin[:1] * 0 + 1, o[:128], d[:128],
                                      tmin[:128], tmax[:128], pcs.tv)
        better = t_p < t_ref
        t_ref, i_ref = torch.where(better, t_p, t_ref), torch.where(
            better, i_p, i_ref)
    assert torch.equal(t_all[:128], t_ref) and torch.equal(i_all[:128], i_ref)
    assert (t_all[:128] < BIG).sum() > 8
    assert (t_all[128:] == BIG).all() and (i_all[128:] == 0).all()


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
# routing and intersect_rounds through the renderers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def terrain():
    return p_presets.triangle_field("cpu", 2048, 24)


def test_cluster_rounds_follow_jax(terrain):
    """JAX's `_cluster_rounds`: one round per 2,048 clusters at least, and
    never fewer than asked for."""
    scene, _ = terrain
    assert scene.clusters.cmin.shape[0] == 128
    assert p_isect._cluster_rounds(scene, 1) == 1
    assert p_isect._cluster_rounds(scene, 3) == 3
    wide = type("S", (), {"clusters": p_ci.ClusterSet(
        tv=torch.zeros(8192, 9, 1), cmin=torch.zeros(8192, 3),
        cmax=torch.zeros(8192, 3))})()
    assert p_isect._cluster_rounds(wide, 1) == 4  # BASELINE config[4]
    assert p_isect._cluster_rounds(wide, 6) == 6


def test_render_routes_and_rounds(terrain, monkeypatch):
    """render_photon sends its camera and shadow launches to the cluster
    engine with intersect_rounds' capacity and its photon walk to the epoch
    engine; render_simple with intersect_rounds 2 equals 1 bit for bit;
    the cluster route and the epoch route give the same frame up to tie
    breaks."""
    scene, cam = terrain
    calls = []
    for mod, fn in ((p_isect.cluster_intersect, "intersect_clusters"),
                    (p_isect.epoch_intersect, "intersect_epochs")):
        orig = getattr(mod, fn)

        def spy(*args, _orig=orig, _fn=fn, **kw):
            calls.append((_fn, kw.get("rounds"), args[1].shape[0]))
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
    assert [c[2] for c in coherent] == [576, 576]
    assert {c[1] for c in coherent} == {3}
    assert walk and max(c[2] for c in walk) <= 1 << 10

    base = dict(width=24, height=24, spp=1, scene_epsilon=1e-3)
    key = prng.PRNGKey(1, "cpu")
    img = p_simple.render_simple(scene, cam, PConfig(**base), key)
    img2 = p_simple.render_simple(scene, cam,
                                  PConfig(**base, intersect_rounds=2), key)
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
    2e-5 where both hit, overflow 0; no kernel launch on the CPU."""
    scene, cam = terrain
    from raytrace_tpu_torch.ops import epoch_intersect as p_ei
    from raytrace_tpu_torch.scene.camera import generate_rays, pixel_samples
    xy, lens = pixel_samples(prng.PRNGKey(3, "cpu"), 24, 24, 1, jitter=False)
    rays = generate_rays(cam, xy, lens, 1)
    k = rays.o.shape[0]
    lo, hi = torch.full((k,), 1e-3), torch.full((k,), BIG)
    before = _counts() + (ek.cull_bits.launches, ek.mt_jobs.launches)
    tc, ic, npairs, ovc = p_ci.intersect_clusters(scene.clusters, rays.o,
                                                  rays.d, lo, hi)
    te, ie, _, ove = p_ei.intersect_epochs(scene.clusters, rays.o, rays.d,
                                           lo, hi)
    assert _counts() + (ek.cull_bits.launches, ek.mt_jobs.launches) == before
    assert int(ovc) == int(ove) == 0 and int(npairs) >= 8
    hc, he = tc < BIG, te < BIG
    assert hc.sum() > 0.5 * k
    assert int((hc != he).sum()) <= 0.005 * k
    both = hc & he
    np.testing.assert_allclose(n(tc[both]), n(te[both]), rtol=2e-5)
    assert int((both & (ic != ie)).sum()) <= 0.01 * k
