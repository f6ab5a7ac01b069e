"""The exact pre-culls of K8 (ops/epoch_kernels.py `precull_plain` on the
scene box and `group_precull_plain` on the hulls of groups of 32 real
clusters, which csrc/epoch_cull.cu evaluates per ray and skips a warp's
clusters on), the count of the tests they leave (`cull_tests_plain`, the
kernel's counter) and the job-list property K9's staging relies on
(csrc/epoch_mt.cu), on the CPU.

The pre-culls test each ray against a box that holds some real clusters'
boxes (the scene box all of them, a group hull its group's); a ray a hull
drops must set no bit of any cluster under it, whatever the input: NaN and
infinite origins, zero and denormal direction components (1/1e-40 is inf
in float32, so 0·inf gives NaN), origins on box faces, rays that graze the
scene box, epoch-1 windows of resolved rays, a room-sized cluster in a
group of small ones, a partial last group. Padding clusters (boxes (+inf,
−inf)) are outside the pre-culls and belong to no group: the kernel always
tests them. With finite boxes and directions a ray whose hull test is NaN
hits no member; with an unbounded cluster and an infinite direction
component it can, and the NaN rule keeps it.
"""
import numpy as np
import pytest
import torch

from raytrace_tpu_torch.core.config import RenderConfig
from raytrace_tpu_torch.ops import cluster_intersect as ci
from raytrace_tpu_torch.ops import epoch_intersect as ei
from raytrace_tpu_torch.ops import epoch_kernels as ek
from raytrace_tpu_torch.renderers import photon
from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.scene import presets

BIG = np.float32(1e30)
F32 = np.float32


def _clusters(rng, n_real, n_pad):
    """n_real random boxes in [-5, 5]³ (some flat on an axis) and n_pad
    padding boxes (+inf, −inf) → cmin, cmax [C, 3] float32."""
    lo = rng.uniform(-5, 4, (n_real, 3)).astype(F32)
    hi = (lo + rng.uniform(0, 1.5, (n_real, 3))).astype(F32)
    hi[::7, 2] = lo[::7, 2]  # flat boxes, as a terrain cluster can be
    cmin = np.concatenate([lo, np.full((n_pad, 3), np.inf, F32)])
    cmax = np.concatenate([hi, np.full((n_pad, 3), -np.inf, F32)])
    return cmin, cmax


def _windows(rng, k, epoch):
    """tmin, tbest, w0, w1 [k] for epoch 0 (w0 −BIG) or a later epoch,
    with a share of resolved rays (tbest finite)."""
    tmin = np.where(rng.random(k) < 0.5, 1e-3, rng.uniform(0, 3, k))
    tbest = np.where(rng.random(k) < 0.4, rng.uniform(0, 12, k), BIG)
    if epoch == 0:
        w0 = np.full(k, -BIG)
        w1 = np.where(rng.random(k) < 0.5, BIG, rng.uniform(0, 8, k))
    else:
        w0 = rng.uniform(0, 8, k)
        w1 = np.where(rng.random(k) < 0.5, BIG, w0 + rng.uniform(0, 8, k))
    return [a.astype(F32) for a in (tmin, tbest, w0, w1)]


def _inv(d):
    with np.errstate(over="ignore"):  # 1/denormal: inf, as in float32
        return (1.0 / np.where(d == 0.0, F32(1e-30), d)).astype(F32)


def _rays(rng, k):
    o = rng.uniform(-9, 9, (k, 3)).astype(F32)
    d = rng.standard_normal((k, 3)).astype(F32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _case(name):
    """(o, d, tmin, tbest, w0, w1, cmin, cmax, n_real) of one case."""
    rng = np.random.default_rng(CASES.index(name))
    k = 2048
    cmin, cmax = _clusters(rng, 96, 32)
    n_real = 96
    smin, smax = cmin[:n_real].min(0), cmax[:n_real].max(0)
    o, d = _rays(rng, k)
    epoch = 0
    if name == "random_epoch1":
        epoch = 1
    elif name == "nan_inf_origins":
        o[0::5, 0] = np.nan
        o[1::5, 1] = np.inf
        o[2::5, 2] = -np.inf
        o[3::5] = np.inf
    elif name == "zero_denormal_dirs":
        for j, v in enumerate((0.0, -0.0, 1e-40, -1e-40, 1e-45)):
            d[j::6, j % 3] = v
            d[j + 1::12, (j + 1) % 3] = v
            o[j::30, j % 3] = smin[j % 3]  # and on a scene-box face plane
    elif name == "origins_on_faces":
        # on a face plane of a real cluster or of the scene box, with the
        # direction along that plane (zero or denormal component): 0·inf
        pick = rng.integers(0, n_real, k)
        ax = rng.integers(0, 3, k)
        face = np.where(rng.random(k) < 0.5, cmin[pick, ax], cmax[pick, ax])
        face = np.where(rng.random(k) < 0.3,
                        np.where(rng.random(k) < 0.5, smin[ax], smax[ax]),
                        face)
        o[np.arange(k), ax] = face
        d[np.arange(k), ax] = np.where(rng.random(k) < 0.5, 0.0, 1e-40)
        o[::3] = np.clip(o[::3], smin, smax)  # on faces inside the box too
    elif name == "grazing":
        # from outside, aimed at a point on the scene box's surface
        ax = rng.integers(0, 3, k)
        target = rng.uniform(smin, smax, (k, 3)).astype(F32)
        target[np.arange(k), ax] = np.where(rng.random(k) < 0.5, smin[ax],
                                            smax[ax])
        d = (target - o).astype(F32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        d[::4, ax[::4]] = 0.0  # in the face plane
    elif name == "epoch1_resolved":
        epoch = 1
    elif name == "infinite_extent":
        # cluster 0 unbounded below on x makes the scene box's smin.x −inf;
        # a ray with d.x = ±inf (inv.x = 0) reads (−inf − o)·0 = NaN there,
        # while its x slab through a finite cluster is [0, 0]: from inside
        # that cluster's y and z range with tmin < 0 it hits
        cmin[0, 0] = -np.inf
        pick = rng.integers(1, n_real, k)
        half = np.arange(k) % 2 == 0
        d[half, 0] = np.where(rng.random(k) < 0.5, np.inf, -np.inf)[half]
        o[half, 1:] = ((cmin[pick, 1:] + cmax[pick, 1:]) / 2)[half]
    tmin, tbest, w0, w1 = _windows(rng, k, epoch)
    if name == "infinite_extent":
        tmin = np.where(half, F32(-1.0), tmin).astype(F32)
    if name == "epoch1_resolved":
        tbest = np.where(rng.random(k) < 0.8,
                         w0 - rng.uniform(0, 2, k).astype(F32), tbest)
        tbest = tbest.astype(F32)
    return o, d, tmin, tbest, w0, w1, cmin, cmax, n_real


CASES = ["random_epoch0", "random_epoch1", "nan_inf_origins",
         "zero_denormal_dirs", "origins_on_faces", "grazing",
         "epoch1_resolved", "infinite_extent"]


def _tensors(o, d, tmin, tbest, w0, w1, cmin, cmax, n_real):
    t = torch.as_tensor
    box = torch.stack([t(cmin[:n_real]).amin(0), t(cmax[:n_real]).amax(0)])
    return (t(o), t(_inv(d)), t(tmin), t(tbest), t(w0), t(w1), t(cmin),
            t(cmax), box)


@pytest.mark.parametrize("name", CASES)
def test_precull_drops_no_ray_that_hits_a_real_cluster(name):
    """Per ray: a ray the pre-cull drops enters no real cluster's box in
    its window (`_cull_hits`, the cull's own test); per subtile: where all
    32 rays are dropped, the plain cull's bit is 0 for every real cluster.
    A NaN in the scene-box test keeps the ray."""
    *arrays, n_real = _case(name)
    o, inv, tmin, tbest, w0, w1, cmin, cmax, box = _tensors(*arrays, n_real)
    may = ek.precull_plain(o, inv, tmin, tbest, w0, w1, box)
    hits = ek._cull_hits(o, inv, tmin, tbest, w0, w1, cmin[:n_real],
                         cmax[:n_real])
    assert not bool((hits & ~may[:, None]).any())
    tn, tf = ek._slab(o, inv, box[:1], box[1:])
    assert bool(may[torch.isnan(tn[:, 0])].all())
    n = o.shape[0]
    bits = ek.cull_bits_plain(o, inv, tmin, tbest, w0, w1, cmin, cmax,
                              torch.tensor([n], dtype=torch.int32))
    dropped = ~may.reshape(-1, ek.SUB).any(1)  # [subtiles]
    sub_bits = ((bits[:n_real, :, None].int()
                 >> torch.arange(ek.NSUB)) & 1).reshape(n_real, -1)
    assert not bool(sub_bits[:, dropped].any())
    # not vacuous: the case drops rays, and keeps rays that hit
    assert 0 < int((~may).sum()) and bool(hits.any())
    if name in ("nan_inf_origins", "zero_denormal_dirs", "origins_on_faces",
                "infinite_extent"):
        assert bool(torch.isnan(tn).any())
    if name == "infinite_extent":  # the NaN rule keeps rays that hit
        assert int((hits.any(1) & torch.isnan(tn[:, 0])).sum()) > 256
    if name == "epoch1_resolved":
        assert float((~may).float().mean()) > 0.7


def test_precull_leaves_padding_clusters_to_the_test():
    """Padding clusters' slab is (−inf, +inf): in epoch 0 they pass the
    cull for every live ray, rays the pre-cull drops included — which is
    why the kernel tests them whatever the pre-cull says."""
    *arrays, n_real = _case("random_epoch0")
    o, inv, tmin, tbest, w0, w1, cmin, cmax, box = _tensors(*arrays, n_real)
    may = ek.precull_plain(o, inv, tmin, tbest, w0, w1, box)
    pad_hits = ek._cull_hits(o, inv, tmin, tbest, w0, w1, cmin[n_real:],
                             cmax[n_real:])
    live = tmin < torch.minimum(w1, tbest)
    assert bool(pad_hits[live & ~may].all())
    assert int((live & ~may).sum()) > 100


@pytest.fixture(scope="module")
def field():
    scene, cam = presets.triangle_field("cpu", 2048, 16)
    cfg = RenderConfig(width=16, height=16, scene_epsilon=1e-3,
                       photon_paths=1 << 13, max_photon_bounces=8,
                       footprint_radius_scale=8.0, initial_radius2=0.04)
    em = photon.emission(scene, cfg, prng.PRNGKey(0, "cpu"), 0)
    n = em["o"].shape[0]
    launch = (em["o"], em["d"], torch.full((n,), 1e-3),
              torch.where(em["alive"], 1e30, 0.0))
    return scene, launch


def _capture(monkeypatch, name):
    calls = []
    orig = getattr(ek, name)

    def rec(*args, **kw):
        calls.append(args)
        return orig(*args, **kw)

    monkeypatch.setattr(ek, name, rec)
    return calls


def test_precull_drops_most_of_a_point_light_emission(field, monkeypatch):
    """The engine hands K8 the hull of the real clusters' boxes and their
    count; on triangle_field's point-light emission launch the pre-cull
    drops most rays in epoch 0 (they leave the scene box) and more in
    epoch 1 (resolved in epoch 0), and is exact on them."""
    scene, (o, d, tmin, tmax) = field
    calls = _capture(monkeypatch, "cull_bits")
    ei.intersect_epochs(scene.clusters, o, d, tmin, tmax)
    assert len(calls) == 2
    cs = scene.clusters
    n_real = -(-cs.n_tris // cs.tv.shape[2])
    drops = []
    for (o_p, inv, lo, tb, w0, w1, cmin, cmax, n_live, box, nr, gmin,
         gmax) in calls:
        assert nr == n_real < cmin.shape[0]
        assert torch.equal(box[0], cmin[:n_real].amin(0))
        assert torch.equal(box[1], cmax[:n_real].amax(0))
        assert gmin is cs.gmin and gmax is cs.gmax
        live = int(n_live)
        may = ek.precull_plain(o_p, inv, lo, tb, w0, w1, box)[:live]
        hits = ek._cull_hits(o_p[:live], inv[:live], lo[:live], tb[:live],
                             w0[:live], w1[:live], cmin[:n_real],
                             cmax[:n_real])
        assert not bool((hits & ~may[:, None]).any())
        drops.append(float((~may).float().mean()))
    assert drops[0] >= 0.5 and drops[1] >= 0.8, drops


@pytest.mark.parametrize("padding", [True, False])
def test_job_groups_of_four_name_one_cluster(field, monkeypatch, padding):
    """Every aligned group of 4 jobs K9 receives from the engine names one
    cluster, with padding clusters in the set (their runs are dropped
    whole by `keep`) and without: K9 stages one cluster per group."""
    scene, (o, d, tmin, tmax) = field
    cs = scene.clusters
    if not padding:  # 2,048 triangles in 128 clusters of 16: no padding
        tris = scene.tris
        cs = ci.build_clusters(tris.v0.numpy(), tris.v1.numpy(),
                               tris.v2.numpy(), "cpu", cluster_size=16)
    n_real = -(-cs.n_tris // cs.tv.shape[2])
    assert (n_real < cs.n_clusters) == padding
    calls = _capture(monkeypatch, "mt_jobs")
    ei.intersect_epochs(cs, o, d, tmin, tmax)
    assert calls
    for job_cluster, *_ in calls:
        assert job_cluster.shape[0] % ei.JPS == 0
        groups = job_cluster.reshape(-1, ei.JPS)
        assert bool((groups == groups[:, :1]).all())
        assert int(job_cluster.max()) < n_real


def test_cull_bits_on_cpu_takes_the_plain_version_with_the_box():
    """On CPU tensors cull_bits with the pre-culls' box, n_real and group
    hulls returns the plain version's bits and counts no launch."""
    *arrays, n_real = _case("random_epoch0")
    o, inv, tmin, tbest, w0, w1, cmin, cmax, box = _tensors(*arrays, n_real)
    n_live = torch.tensor([1500], dtype=torch.int32)
    before = ek.cull_bits.launches
    got = ek.cull_bits(o, inv, tmin, tbest, w0, w1, cmin, cmax, n_live, box,
                       n_real, *ek.group_hulls(cmin, cmax, n_real))
    want = ek.cull_bits_plain(o, inv, tmin, tbest, w0, w1, cmin, cmax,
                              n_live)
    assert torch.equal(got, want) and ek.cull_bits.launches == before


GROUP_CASES = CASES + ["wall_among_ball", "partial_last_group", "two_blocks"]


def _ball_case():
    """The glass Cornell box in miniature: a ball of radius 0.5 as 191
    small boxes (a mesh's clusters, in three bands of z, each split by the
    sign of x, as BVH-leaf order keeps a mesh's patches together) with a
    room-sized cluster (the walls' triangles) at index 100, inside group 3,
    and 64 padding boxes; half the rays from a disk light under the
    ceiling, downward, half from anywhere in the room, in the engine's
    coherence order."""
    rng = np.random.default_rng(101)
    k = 4096
    p = rng.standard_normal((191, 3))
    p = p / np.linalg.norm(p, axis=1, keepdims=True)
    band = np.minimum((p[:, 2] + 1) * 1.5, 2).astype(int)
    p = 0.5 * p[np.lexsort((p[:, 1], p[:, 0] > 0, band))]
    lo, hi = (p - 0.08).astype(F32), (p + 0.08).astype(F32)
    pad = np.full((64, 3), np.inf, F32)
    cmin = np.concatenate([lo[:100], np.full((1, 3), -3, F32), lo[100:], pad])
    cmax = np.concatenate([hi[:100], np.full((1, 3), 3, F32), hi[100:], -pad])
    half = k // 2
    r, a = 0.5 * np.sqrt(rng.random(half)), 2 * np.pi * rng.random(half)
    o = np.concatenate([np.stack([r * np.cos(a), r * np.sin(a),
                                  np.full(half, 2.9)], 1),
                        rng.uniform(-2.9, 2.9, (half, 3))]).astype(F32)
    d = rng.standard_normal((k, 3))
    d[:half, 2] = -np.abs(d[:half, 2])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(F32)
    tmin, tbest, w0, w1 = _windows(rng, k, 0)
    t = torch.as_tensor
    key = ei._sort_key(t(cmin), t(cmax), t(o), t(d), torch.full((k,), 1e30),
                       t(tmin))
    order = torch.argsort(key, stable=True).numpy()
    rays = [x[order] for x in (o, d, tmin, tbest, w0, w1)]
    return (*rays, cmin, cmax, 192)


def _group_case(name):
    """(o, d, tmin, tbest, w0, w1, cmin, cmax, n_real) of a group case: a
    case of CASES with its real clusters in order of x (so that a group is
    compact, as in BVH-leaf order); a partial last group (83 real
    clusters); clusters over two of the kernel's blocks (1,100 real, 52
    padding); the ball and room of `_ball_case`."""
    if name == "wall_among_ball":
        return _ball_case()
    if name == "two_blocks":
        rng = np.random.default_rng(102)
        cmin, cmax = _clusters(rng, 1100, 52)
        o, d = _rays(rng, 1024)
        arrays = [o, d, *_windows(rng, 1024, 1), cmin, cmax]
        n_real = 1100
    else:
        *arrays, n_real = _case("random_epoch0" if name == "partial_last_group"
                                else name)
    cmin, cmax = arrays[6], arrays[7]
    order = np.argsort(cmin[:n_real, 0], kind="stable")
    cmin[:n_real], cmax[:n_real] = cmin[order], cmax[order]
    if name == "partial_last_group":
        n_real = 83
        cmin[n_real:], cmax[n_real:] = np.inf, -np.inf
    return (*arrays, n_real)


def _warp_nibbles(bits, n_real):
    """The plain cull's bits of the real clusters by kernel warp → [n_real,
    warps]: warp w holds subtiles 4(w % 2) .. +3 of tile w // 2."""
    b = bits[:n_real].int()
    return torch.stack([b & 0xF, b >> 4], dim=2).reshape(n_real, -1)


@pytest.mark.parametrize("name", GROUP_CASES)
def test_group_precull_hides_no_bit_of_the_plain_cull(name):
    """Per ray: a ray a group hull drops enters none of the group's boxes
    in its window, and a NaN in the hull test keeps it. Per warp, as the
    kernel skips: where no ray of a warp passes the scene box and a group's
    hull, the plain cull's bits of that warp are 0 for every cluster of
    the group; so the kernel's mask is the plain version's bit for bit."""
    *arrays, n_real = _group_case(name)
    o, inv, tmin, tbest, w0, w1, cmin, cmax, box = _tensors(*arrays, n_real)
    gmin, gmax = ek.group_hulls(cmin, cmax, n_real)
    n_groups = -(-n_real // ek.GROUP)
    assert gmin.shape == gmax.shape == (n_groups, 3)
    may = ek.precull_plain(o, inv, tmin, tbest, w0, w1, box)
    gmay = ek.group_precull_plain(o, inv, tmin, tbest, w0, w1, gmin, gmax)
    group = torch.arange(n_real) // ek.GROUP
    hits = ek._cull_hits(o, inv, tmin, tbest, w0, w1, cmin[:n_real],
                         cmax[:n_real])
    assert not bool((hits & ~gmay[:, group]).any())
    tn, _ = ek._slab(o, inv, gmin, gmax)
    assert bool(gmay[torch.isnan(tn)].all())
    n = o.shape[0]
    warp_g = (gmay & may[:, None]).reshape(-1, ek.CULL_WARP_RAYS,
                                           n_groups).any(1)
    bits = ek.cull_bits_plain(o, inv, tmin, tbest, w0, w1, cmin, cmax,
                              torch.tensor([n], dtype=torch.int32))
    nib = _warp_nibbles(bits, n_real)
    assert not bool(nib[~warp_g[:, group].T].any())
    # not vacuous: the hulls drop rays the scene box keeps, and rays hit
    assert bool((may[:, None] & ~gmay).any()) and bool(hits.any())
    if name == "wall_among_ball":
        # the room's group is as wide as the scene box; of the ball's
        # groups, whole warps that the scene box keeps skip each, and some
        # warp tests each
        assert torch.equal(gmay[:, 3], may)
        ball = warp_g[:, [0, 1, 2, 4, 5]]
        kept = may.reshape(-1, ek.CULL_WARP_RAYS).any(1)[:, None]
        assert bool(ball.any(0).all()) and bool((~ball & kept).any(0).all())
    if name == "partial_last_group":
        assert n_real % ek.GROUP and bool(warp_g[:, -1].any())


def test_group_hulls_hold_their_members():
    """Each hull is its members' min and max, the last group partial; a NaN
    corner makes its group's hull NaN; padding is in no group; no real
    cluster, no group."""
    rng = np.random.default_rng(7)
    cmin, cmax = _clusters(rng, 83, 45)
    cmin[5, 1] = np.nan
    lo, hi = torch.as_tensor(cmin), torch.as_tensor(cmax)
    gmin, gmax = ek.group_hulls(lo, hi, 83)
    assert gmin.shape == (3, 3) and gmin.is_contiguous()
    for g in range(3):
        m = slice(32 * g, min(32 * g + 32, 83))
        want_lo, want_hi = np.min(cmin[m], 0), np.max(cmax[m], 0)
        np.testing.assert_array_equal(gmin[g].numpy(), want_lo)
        np.testing.assert_array_equal(gmax[g].numpy(), want_hi)
    assert bool(torch.isnan(gmin[0, 1])) and bool(torch.isfinite(gmin[1:]).all())
    assert ek.group_hulls(lo, hi, 0)[0].shape == (0, 3)


def test_cluster_set_carries_its_groups_hulls(field):
    """build_clusters gives the set its groups' hulls (made on the host);
    a set made without them makes the same from its boxes."""
    scene, _ = field
    tris = scene.tris
    cs = ci.build_clusters(tris.v0.numpy(), tris.v1.numpy(), tris.v2.numpy(),
                           "cpu", cluster_size=16)
    assert cs.n_real == 128 and cs.gmin.shape == (4, 3)
    want = ek.group_hulls(cs.cmin, cs.cmax, cs.n_real)
    assert torch.equal(cs.gmin, want[0]) and torch.equal(cs.gmax, want[1])
    bare = ci.ClusterSet(tv=cs.tv, cmin=cs.cmin, cmax=cs.cmax,
                         n_tris=cs.n_tris)
    assert torch.equal(bare.gmin, cs.gmin) and torch.equal(bare.gmax, cs.gmax)
    assert scene.clusters.gmin.shape == (1, 3)  # 8 real clusters of 256


def _count_by_rule(o, inv, tmin, tbest, w0, w1, cmin, cmax, n_live, box,
                   n_real, gmin, gmax):
    """K8's counter read off csrc/epoch_cull.cu block by block and warp by
    warp: (tests its live warps run, live warps × real clusters)."""
    g_size, tiles_per_block, cpb = ek.GROUP, 4, ek.CULL_BLOCK_CLUSTERS
    n_tiles, n_clusters, live = o.shape[0] // ek.TILE, cmin.shape[0], int(
        n_live)
    may = ek.precull_plain(o, inv, tmin, tbest, w0, w1, box)
    gmay = ek.group_precull_plain(o, inv, tmin, tbest, w0, w1, gmin, gmax)
    ran = asked = 0
    for bx in range(-(-n_tiles // tiles_per_block)):
        if bx * tiles_per_block * ek.TILE >= live:
            continue
        for c_begin in range(0, n_clusters, cpb):
            c_end = min(n_clusters, c_begin + cpb)
            c_real = max(c_begin, min(c_end, n_real))
            n_hulls = -(-(c_real - c_begin) // g_size)
            for w in range(8):
                tile = bx * tiles_per_block + w // 2
                if not (tile < n_tiles and tile * ek.TILE < live):
                    continue
                asked += c_real - c_begin
                if not n_hulls:
                    continue
                rays = slice(tile * ek.TILE + (w % 2) * 128,
                             tile * ek.TILE + (w % 2) * 128 + 128)
                keep = bool(may[rays].any())
                ran += 1 + (n_hulls if keep else 0)
                groups = {g for g in range(c_begin // g_size,
                                           c_begin // g_size + n_hulls)
                          if keep and bool(gmay[rays, g].any())}
                for c0 in range(c_begin, c_end, 32):
                    c1 = min(c0 + 32, c_end)
                    if c1 > n_real or any(c // g_size in groups
                                          for c in range(c0, c1)):
                        ran += max(0, min(c1, n_real) - c0)
    return ran, asked


@pytest.mark.parametrize("name", ["random_epoch0", "epoch1_resolved",
                                  "wall_among_ball", "partial_last_group",
                                  "two_blocks"])
@pytest.mark.parametrize("dead", [0, 300, 2047])
def test_cull_tests_plain_counts_as_the_kernel(name, dead):
    """`cull_tests_plain` (the kernel's counter on the card) equals the
    kernel's rule applied block by block and warp by warp, with a live
    prefix that ends inside a tile, a block or the first tile; it lies
    between a scene-box test a warp and block and every test besides, and
    on the coherent rays of the ball below what the scene box alone
    leaves."""
    *arrays, n_real = _group_case(name)
    o, inv, tmin, tbest, w0, w1, cmin, cmax, box = _tensors(*arrays, n_real)
    n_live = torch.tensor([max(1, o.shape[0] - dead)], dtype=torch.int32)
    args = (o, inv, tmin, tbest, w0, w1, cmin, cmax, n_live, box, n_real,
            *ek.group_hulls(cmin, cmax, n_real))
    got = ek.cull_tests_plain(*args)
    assert got == _count_by_rule(*args)
    ran, asked = got
    live_warps = -(-int(n_live) // ek.TILE) * 2
    assert asked == live_warps * n_real
    blocks = -(-n_real // ek.CULL_BLOCK_CLUSTERS)
    most = live_warps * (blocks + -(-n_real // ek.GROUP) + n_real)
    assert live_warps * blocks <= ran <= most
    if name == "wall_among_ball":  # the scene box alone: every real cluster
        warp_may = ek.precull_plain(o, inv, tmin, tbest, w0, w1, box)
        kept = warp_may.reshape(-1, ek.CULL_WARP_RAYS).any(1)[:live_warps]
        assert ran < int(kept.sum()) * n_real
