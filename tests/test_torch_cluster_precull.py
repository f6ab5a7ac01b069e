"""The exact pre-cull of K6 (ops/cluster_kernels.py `precull_plain`, which
csrc/cluster_cull.cu evaluates per ray and skips a tile on), on the CPU.

The pre-cull tests each ray against the scene box that holds every real
cluster; a ray it drops must set no byte of any real cluster, whatever the
input: NaN and infinite origins, zero and denormal direction components
(1/1e-40 is inf in float32, so 0·inf gives NaN), origins on box faces,
grazing rays, padded rays (o = d = 0, tmin = tmax = 0) and empty
t-windows. Padding clusters (boxes (+inf, −inf)) are outside the pre-cull:
the kernel always tests them. With finite boxes and directions a ray whose
scene-box test is NaN hits no real cluster; with an unbounded cluster and
an infinite direction component it can, and the NaN rule keeps it. The
cluster count (101 real and 18 padding, or 1,100 and 37) is not a multiple
of the kernel's 32-box word; chip_smoke.py runs the same cases on the card
against the plain version at 128 and 256 rays a tile.
"""
import numpy as np
import pytest
import torch

from raytrace_tpu_torch.ops import cluster_kernels as ck

F32 = np.float32
K = 2048  # rays per case: 16 tiles of 128, 8 of 256


def _clusters(rng, n_real, n_pad):
    """n_real random boxes in [-5, 5]³ (some flat on an axis) and n_pad
    padding boxes (+inf, −inf) → cmin, cmax [C, 3] float32."""
    lo = rng.uniform(-5, 4, (n_real, 3)).astype(F32)
    hi = (lo + rng.uniform(0, 1.5, (n_real, 3))).astype(F32)
    hi[::7, 2] = lo[::7, 2]  # flat boxes, as a terrain cluster can be
    cmin = np.concatenate([lo, np.full((n_pad, 3), np.inf, F32)])
    cmax = np.concatenate([hi, np.full((n_pad, 3), -np.inf, F32)])
    return cmin, cmax


def _case(name):
    """(o, d, tmin, tmax, cmin, cmax, n_real) of one case, float32 numpy."""
    rng = np.random.default_rng(CASES.index(name))
    n_real, n_pad = (1100, 37) if name == "many_clusters" else (101, 18)
    cmin, cmax = _clusters(rng, n_real, n_pad)
    smin, smax = cmin[:n_real].min(0), cmax[:n_real].max(0)
    o = rng.uniform(-9, 9, (K, 3)).astype(F32)
    d = rng.standard_normal((K, 3)).astype(F32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.where(rng.random(K) < 0.5, 1e-3, rng.uniform(-1, 3, K))
    tmax = np.where(rng.random(K) < 0.5, 1e30, rng.uniform(0, 12, K))
    if name == "nan_inf_origins":
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
        pick = rng.integers(0, n_real, K)
        ax = rng.integers(0, 3, K)
        face = np.where(rng.random(K) < 0.5, cmin[pick, ax], cmax[pick, ax])
        face = np.where(rng.random(K) < 0.3,
                        np.where(rng.random(K) < 0.5, smin[ax], smax[ax]),
                        face)
        o[np.arange(K), ax] = face
        d[np.arange(K), ax] = np.where(rng.random(K) < 0.5, 0.0, 1e-40)
        o[::3] = np.clip(o[::3], smin, smax)  # on faces inside the box too
    elif name == "grazing":
        # from outside, aimed at a point on the scene box's surface
        ax = rng.integers(0, 3, K)
        target = rng.uniform(smin, smax, (K, 3)).astype(F32)
        target[np.arange(K), ax] = np.where(rng.random(K) < 0.5, smin[ax],
                                            smax[ax])
        d = (target - o).astype(F32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        d[::4, ax[::4]] = 0.0  # in the face plane
    elif name == "padded_and_empty":
        # the engine's padded rays (o = d = 0, tmin = tmax = 0: they pass
        # for the boxes that hold the origin) and empty windows: tmax equal
        # to tmin, below it, or both negative
        o[::4], d[::4], tmin[::4], tmax[::4] = 0.0, 0.0, 0.0, 0.0
        tmax[1::4] = tmin[1::4]
        tmax[2::4] = tmin[2::4] - rng.uniform(0, 2, K)[2::4]
        tmin[3::8], tmax[3::8] = -2.0, -1.0
    elif name == "infinite_extent":
        # cluster 0 unbounded below on x makes the scene box's smin.x −inf;
        # a ray with d.x = ±inf (inv.x = 0) reads (−inf − o)·0 = NaN there,
        # while its x slab through a finite cluster is [0, 0]: from inside
        # that cluster's y and z range with tmin < 0 it hits
        cmin[0, 0] = -np.inf
        pick = rng.integers(1, n_real, K)
        half = np.arange(K) % 2 == 0
        d[half, 0] = np.where(rng.random(K) < 0.5, np.inf, -np.inf)[half]
        o[half, 1:] = ((cmin[pick, 1:] + cmax[pick, 1:]) / 2)[half]
        tmin = np.where(half, -1.0, tmin)
    f = lambda a: np.ascontiguousarray(a, F32)
    return f(o), f(d), f(tmin), f(tmax), f(cmin), f(cmax), n_real


CASES = ["random", "nan_inf_origins", "zero_denormal_dirs",
         "origins_on_faces", "grazing", "padded_and_empty",
         "infinite_extent", "many_clusters"]


def _tensors(name):
    """The case as torch tensors, with its scene box [2, 3] over the real
    clusters → (o, d, tmin, tmax, cmin, cmax, box, n_real)."""
    *arrays, n_real = _case(name)
    o, d, tmin, tmax, cmin, cmax = (torch.as_tensor(a) for a in arrays)
    box = torch.stack([cmin[:n_real].amin(0), cmax[:n_real].amax(0)])
    return o, d, tmin, tmax, cmin, cmax, box, n_real


def _reach(name):
    """(rays dropped, rays kept by the NaN rule alone that hit a real
    cluster, rays hitting a padding cluster) of a case, asserting the
    pre-cull exact on it."""
    o, d, tmin, tmax, cmin, cmax, box, n_real = _tensors(name)
    may = ck.precull_plain(o, d, tmin, tmax, box)
    hits = ck.cull_tiles_plain(o, d, tmin, tmax, cmin, cmax, 1).bool()
    real = hits[:, :n_real].any(1)
    assert not bool((real & ~may).any()), \
        f"{name}: a dropped ray hits a real cluster"
    inv = 1.0 / torch.where(d == 0.0, 1e-30, d)
    nan = (torch.isnan((box[0] - o) * inv).any(1)
           | torch.isnan((box[1] - o) * inv).any(1))
    return (int((~may).sum()), int((nan & real).sum()),
            int(hits[:, n_real:].any(1).sum()))


@pytest.mark.parametrize("name", CASES)
def test_precull_drops_no_ray_that_hits_a_real_cluster(name):
    """Every ray that precull_plain drops sets no byte of any real cluster
    (the plain K6 per ray, tile_rays 1); each case drops rays or keeps some
    by the NaN rule, and has rays that pass the padding clusters."""
    dropped, nan_hits, pad_hits = _reach(name)
    assert dropped > 0 or nan_hits > 0
    assert pad_hits > 0


def test_nan_rule_keeps_rays_that_hit():
    """A ray whose scene-box test is NaN can hit a real cluster (an
    unbounded cluster, an infinite direction component): dropping it would
    change the mask, so the NaN rule is needed, not just safe."""
    assert _reach("infinite_extent")[1] > 0


@pytest.mark.parametrize("tile_rays", [128, 256])
def test_cull_tiles_on_cpu_takes_the_plain_version(tile_rays):
    """On CPU tensors the wrapper takes the plain version, n_real given or
    not: the pre-cull changes no byte."""
    o, d, tmin, tmax, cmin, cmax, _, n_real = _tensors("random")
    want = ck.cull_tiles_plain(o, d, tmin, tmax, cmin, cmax, tile_rays)
    before = ck.cull_tiles.launches
    got = ck.cull_tiles(o, d, tmin, tmax, cmin, cmax, tile_rays, n_real)
    assert torch.equal(got, want) and ck.cull_tiles.launches == before
    assert want.shape == (K // tile_rays, cmin.shape[0])
