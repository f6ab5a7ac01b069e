"""The exact pre-cull of K4 (ops/dense_gather.py `precull_plain`, which
csrc/dense_gather.cu evaluates per warp before its pair tests), on the CPU.

Each group of 32 consecutive queries (a warp) keeps only the photons whose
gap to the box of its queries with r² > 0 is under their largest r². A
photon it drops must count for no query of the group, whatever the input:
photons one ulp inside and outside the box's reach, dist² exactly r², NaN
photon and query positions, NaN and zero r², invalid photons, a query
count that is not a multiple of 32, and one query with a miss's starting
radius (4.0 at p = 0) in a group of small ones. With the cull applied,
`dense_S_plain` gives the same output bit for bit. chip_smoke.py holds the
kernel, culled, bit for bit against the sums in photon index order on
these cases (`inputs`) and on the preview's first wave, with and without
the misses' radii.

The renderer passes a miss a radius of 0, so that its starting radius does
not widen its warp's box; the wave's state and the image stay equal bit
for bit, since a miss's count is masked after the gather.
"""
import dataclasses

import numpy as np
import pytest
import torch

from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.core.config import RenderConfig
from raytrace_tpu_torch.ops import dense_gather as dg
from raytrace_tpu_torch.renderers import photon
from raytrace_tpu_torch.scene import presets

F32 = np.float32
CASES = ["ulp_edges", "dist2_at_r2", "nan_photons", "nan_queries",
         "zero_r2_invalid", "ragged", "one_big_radius", "random"]


def _up(x, k=1):
    """x moved k float32 ulps up (k < 0: down)."""
    x = np.asarray(x, F32)
    for _ in range(abs(k)):
        x = np.nextafter(x, F32(np.inf if k > 0 else -np.inf)).astype(F32)
    return x


def _edges(q, r):
    """Photons around the reach of queries q [N, 3] of radius r: on each
    axis just below, at and just above qmin − r and qmax + r, and on a
    diagonal at about r from a corner query, each nudged by ±1 and ±2
    ulps."""
    lo, hi = q.min(0), q.max(0)
    pts = []
    for axis in range(3):
        for edge, sign in ((lo, -1.0), (hi, 1.0)):
            base = edge.astype(F32).copy()
            base[axis] = F32(edge[axis] + sign * r)
            for k in (-2, -1, 0, 1, 2):
                p = base.copy()
                p[axis] = _up(base[axis], k)
                pts.append(p)
    s = F32(r / np.sqrt(F32(3.0)))
    for k in (-2, -1, 0, 1, 2):
        pts.append(_up(hi + s, k))
        pts.append(_up(lo - s, k))
    return np.array(pts, F32)


def _case(name):
    """(q_p [N, 3], r2 [N], photons p [P, 3], valid [P]) of one case."""
    rng = np.random.default_rng(CASES.index(name))
    n = 45 if name == "ragged" else 64
    # a row of pixels' hit points: a short segment with small radii
    q = (np.array([0.2, 0.3, 0.4], F32)
         + np.linspace(0, 1, n, dtype=F32)[:, None]
         * np.array([0.3, 0.05, 0.0], F32)).astype(F32)
    r2 = np.full(n, 0.01, F32)
    p = rng.uniform(-1, 1.5, (300, 3)).astype(F32)
    valid = np.ones(len(p), bool)
    if name == "ulp_edges":
        p = np.concatenate([_edges(q[:32], 0.1), _edges(q[32:], 0.1), p])
    elif name == "dist2_at_r2":
        # r2 the rounded square of the distance, or one ulp above and below
        p = np.concatenate([q[:32] + np.array([0.5, 0, 0], F32), p])
        dx = (q[:32, 0] - p[:32, 0]).astype(F32)
        d2 = (dx * dx).astype(F32)
        r2[:32] = d2
        r2[1:32:3] = _up(d2[1:32:3], 1)
        r2[2:32:3] = _up(d2[2:32:3], -1)
    elif name == "nan_photons":
        p[0::7, 0] = np.nan
        p[1::7] = np.nan
        p[2::7, 2] = np.inf
        p[3::7, 1] = -np.inf
        p = np.concatenate([p, q[::3] + F32(0.01)])  # and some that count
    elif name == "nan_queries":
        q[0::5, 0] = np.nan
        q[1::5] = np.nan
        r2[2::5] = np.nan
        q[3::9, 2] = np.inf
        r2[4::11] = np.inf
        p = np.concatenate([p, q[::2] + F32(0.01)])
    elif name == "zero_r2_invalid":
        r2[0::3] = 0.0
        r2[1::7] = -0.5
        r2[40:] = 0.0  # a group with its last 24 queries off
        p = np.concatenate([p, q + F32(0.01)])
        valid = rng.random(len(p)) < 0.6
    elif name == "ragged":
        p = np.concatenate([p, q + F32(0.02)])
    elif name == "one_big_radius":
        q[5] = 0.0
        r2[5] = 4.0
        p = np.concatenate([p, q + F32(0.01)])
    else:  # a wider patch, radii of a few pixels, photons everywhere
        q = rng.uniform(-0.2, 0.2, (n, 3)).astype(F32)
        r2 = rng.uniform(0.0, 0.05, n).astype(F32)
        p = rng.uniform(-1, 1, (1000, 3)).astype(F32)
        valid = rng.random(len(p)) < 0.9
    valid = np.resize(valid, len(p))
    return q.astype(F32), r2.astype(F32), p.astype(F32), valid


def _counted(q, r2, p, valid):
    """[N, P] pairs that count: dist² < r² as the kernel rounds it (each
    operation in float32, no fused multiply-add), and a valid photon."""
    with np.errstate(invalid="ignore", over="ignore"):
        d = (q[:, None, :] - p[None, :, :]).astype(F32)
        sq = (d * d).astype(F32)
        dist2 = ((sq[..., 0] + sq[..., 1]).astype(F32)
                 + sq[..., 2]).astype(F32)
        return (dist2 < r2[:, None]) & valid[None, :]


@pytest.mark.parametrize("name", CASES)
def test_precull_never_drops_a_pair_that_counts(name):
    q, r2, p, valid = _case(name)
    keep = dg.precull_plain(torch.from_numpy(q), torch.from_numpy(r2),
                            torch.from_numpy(p), torch.from_numpy(valid),
                            torch.tensor(len(p), dtype=torch.int32))
    n = len(q)
    assert keep.shape == (-(-n // dg.GROUP), len(p))
    kept = keep.numpy().repeat(dg.GROUP, 0)[:n]
    counted = _counted(q, r2, p, valid)
    assert counted.any()
    assert not (counted & ~kept).any()
    if name == "one_big_radius":
        # the 4.0 radius at p = 0 widens its group's reach to the scene
        assert keep[0].sum() == valid.sum() and keep[1].float().mean() < 0.5
    elif name != "nan_queries":  # an infinite coordinate widens the box
        assert kept.mean() < 0.5  # the cull drops most pairs


def inputs(name, device="cpu") -> tuple:
    """K4's arguments (q_p, radius2, q_ns, photons p, alpha, wi, valid,
    n_valid) of one case, with normals and photon powers drawn from a
    seed."""
    q, r2, p, valid = _case(name)
    rng = np.random.default_rng(100 + CASES.index(name))
    ns = rng.standard_normal(q.shape).astype(F32)
    alpha = rng.uniform(0, 2, p.shape).astype(F32)
    wi = rng.standard_normal(p.shape).astype(F32)
    args = [torch.from_numpy(x).to(device)
            for x in (q, r2, ns, p, alpha, wi, valid)]
    return (*args, torch.tensor(len(p), dtype=torch.int32, device=device))


@pytest.mark.parametrize("name", CASES)
def test_plain_version_with_the_cull_equals_it_without(name):
    """Each group of GROUP queries with its photons past the cull only
    (the others marked invalid) gives the same sums as with all of them."""
    q, r2, ns, p, alpha, wi, valid, n_valid = inputs(name)
    keep = dg.precull_plain(q, r2, p, valid, n_valid)
    bits = lambda x: x.view(torch.int32)
    counted = 0.0
    for g in range(keep.shape[0]):
        qs = slice(g * dg.GROUP, (g + 1) * dg.GROUP)
        group = (q[qs], r2[qs], ns[qs], p, alpha, wi)
        full = dg.dense_S_plain(*group, valid, n_valid)
        culled = dg.dense_S_plain(*group, valid & keep[g], n_valid)
        assert torch.equal(bits(full), bits(culled))
        counted += float(full[3].sum())
    assert counted > 0


def test_miss_radius_zero_leaves_state_and_image_equal(monkeypatch):
    """The small-map gather with a miss's radius 0 (the renderer's call)
    against its starting radius (the call before): every wave's
    ProgressiveState and the image equal bit for bit, though the misses'
    unmasked gathers counted photons."""
    scene, cam = presets.cornell_box("cpu", 16, ball="glass")
    cfg = RenderConfig(width=16, height=16, spp=1, scene_epsilon=1e-3,
                       photon_paths=1 << 9, photon_passes=3,
                       max_photon_bounces=8, footprint_radius_scale=8.0)
    assert cfg.photon_paths * cfg.max_photon_depth < photon.DENSE_GATHER_SLOTS
    gather, gpass = photon.gather_radius_dense_tiles, photon.gathering_pass
    seen = {"new": [], "old": []}

    def run(kind):
        def gathering_pass(scene, rec, state, photons, config):
            def dense(*args):
                if kind == "old":  # the starting radius, misses included
                    args = args[:6] + (state.radius2,) + args[7:]
                L, m = gather(*args)
                seen[kind].append(int(m[~rec.hit].sum()))
                return L, m

            monkeypatch.setattr(photon, "gather_radius_dense_tiles", dense)
            out = gpass(scene, rec, state, photons, config)
            seen[kind + "_state"] = seen.get(kind + "_state", []) + [out[0]]
            return out

        monkeypatch.setattr(photon, "gathering_pass", gathering_pass)
        return photon.render_photon_progressive(scene, cam, cfg,
                                                prng.PRNGKey(5, "cpu"))

    img_new, state_new = run("new")
    img_old, state_old = run("old")
    assert seen["new"] == [0] * 3 and sum(seen["old"]) > 0
    bits = lambda x: x.view(torch.int32)
    for a, b in zip(seen["new_state"] + [state_new],
                    seen["old_state"] + [state_old]):
        for f in dataclasses.fields(a):
            assert torch.equal(bits(getattr(a, f.name)),
                               bits(getattr(b, f.name))), f.name
    assert torch.equal(bits(img_new), bits(img_old))
