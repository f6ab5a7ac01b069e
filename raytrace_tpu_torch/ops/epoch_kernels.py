"""The epoch engine's two kernels and their plain versions (port of
`_cull_kernel`/`_cull_bits` and `_mt_kernel`/`_mt_rounds` of
raytrace_tpu/ops/epoch_intersect.py).

  K8 `cull_bits`  epoch-windowed slab cull of 256-ray tiles against the
                  cluster boxes → uint8 [C, n_tiles], bit k: subtile k
                  (csrc/epoch_cull.cu); `precull_plain` and
                  `group_precull_plain` are its exact pre-culls on the
                  scene box and on the hulls of `group_hulls`,
                  `cull_tests_plain` counts the tests they leave
  K9 `mt_jobs`    Möller–Trumbore of 32-ray subtiles against one cluster's
                  triangles per job → per-job (t, idx) [J, 32]
                  (csrc/epoch_mt.cu)

On CUDA tensors each wrapper launches its kernel or raises; on CPU tensors
it runs the plain PyTorch version beside it, the same arithmetic in the
same order. Each wrapper counts its launches in `.launches`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from raytrace_tpu_torch.ops import cuda_lib
from raytrace_tpu_torch.utils import metrics

BIG = 1e30
TILE = 256  # cull-tile rays
SUB = 32  # subtile rays: one warp, one bit of the mask
NSUB = TILE // SUB
CULL_WARP_RAYS = 128  # csrc/epoch_cull.cu: a warp's four rays per lane
GROUP = 32  # csrc/epoch_cull.cu: real clusters under one hull
CULL_BLOCK_CLUSTERS = 1024  # csrc/epoch_cull.cu: clusters a block tests
_ELEMS_PER_STEP = 1 << 24  # plain versions: tests per block of work


# ---------------------------------------------------------------------------
# K8: the cull
# ---------------------------------------------------------------------------

def _slab(o, inv, bmin, bmax):
    """Rays [R] through boxes [C] → entry and exit distances tn, tf [R, C]
    (JAX `_cull_kernel_body` :101-117, minimum/maximum propagating NaN)."""
    r = lambda a: a[:, None]
    c = lambda a: a[None, :]

    def axis_slab(k):
        t0 = (c(bmin[:, k]) - r(o[:, k])) * r(inv[:, k])
        t1 = (c(bmax[:, k]) - r(o[:, k])) * r(inv[:, k])
        return torch.minimum(t0, t1), torch.maximum(t0, t1)

    n0, f0 = axis_slab(0)
    n1, f1 = axis_slab(1)
    n2, f2 = axis_slab(2)
    return (torch.maximum(torch.maximum(n0, n1), n2),
            torch.minimum(torch.minimum(f0, f1), f2))


def _cull_hits(o, inv, tmin, tbest, w0, w1, cmin, cmax):
    """Rays [R] against boxes [C] → hit [R, C] bool (JAX `_cull_kernel_body`
    :101-120)."""
    r = lambda a: a[:, None]
    tn, tf = _slab(o, inv, cmin, cmax)
    tnc = torch.maximum(tn, r(tmin))
    return ((tn <= tf) & (tf > r(tmin)) & (tnc >= r(w0)) & (tnc < r(w1))
            & (tnc < r(tbest)))


def group_hulls(cmin, cmax, n_real: int):
    """The hull of each group of GROUP consecutive real clusters (0 ..
    n_real − 1; the last group may be partial) → gmin, gmax
    [ceil(n_real / GROUP), 3], K8's second level of pre-culls. A NaN corner
    of a member makes its group's hull NaN, which turns the group's
    pre-cull off."""
    n_groups = -(-n_real // GROUP)
    pad = n_groups * GROUP - n_real

    def hull(b, fill, reduce):
        x = torch.cat([b[:n_real], b.new_full((pad, 3), fill)])
        return reduce(x.reshape(n_groups, GROUP, 3), dim=1).contiguous()

    return hull(cmin, math.inf, torch.amin), hull(cmax, -math.inf, torch.amax)


def group_precull_plain(o, inv, tmin, tbest, w0, w1, gmin, gmax):
    """The exact pre-culls of K8: rays [N] against hulls [G] (gmin, gmax
    [G, 3]), each holding some real clusters' boxes → bool [N, G], False
    where the ray can set no bit of any cluster the hull holds. The same
    slab test as the cull; without NaN every member's tn, tf, tnc lie
    inside the hull's (rounding is monotone), so a hit needs tn ≤ tf,
    tf > tmin, w0 ≤ tf, tnc < w1, tnc < tbest and w0 < tbest on the hull; a
    NaN there (0·inf) means "may hit". csrc/epoch_cull.cu tests the scene
    box (`precull_plain`), then each group hull, and leaves a group's
    clusters untested for a warp none of whose rays may hit it."""
    r = lambda a: a[:, None]
    tn, tf = _slab(o, inv, gmin, gmax)
    tnc = torch.maximum(tn, r(tmin))
    return torch.isnan(tn) | ((tn <= tf) & (tf > r(tmin)) & (r(w0) <= tf)
                              & (tnc < r(w1)) & (tnc < r(tbest))
                              & r(w0 < tbest))


def precull_plain(o, inv, tmin, tbest, w0, w1, box):
    """The exact pre-cull of K8 on the scene box `box` [2, 3] (min row, max
    row), which holds every real cluster → bool [N], False where the ray
    can set no bit of any real cluster (`group_precull_plain`'s test).
    csrc/epoch_cull.cu tests no hull for a warp none of whose rays may
    hit."""
    return group_precull_plain(o, inv, tmin, tbest, w0, w1, box[:1],
                               box[1:])[:, 0]


def cull_tests_plain(o, inv, tmin, tbest, w0, w1, cmin, cmax, n_live, box,
                     n_real, gmin, gmax) -> tuple[int, int]:
    """The counter of K8 for one launch, from `cull_bits`' arguments →
    (ran, asked): the box tests its live warps run on the scene box, the
    group hulls and the real clusters, and live warps × real clusters.

    Per live warp (128 rays; tile t live when t·256 < n_live) and block of
    1,024 clusters holding real ones: one scene-box test; unless no ray of
    the warp may hit it (`precull_plain`), a test of each group hull of the
    block; then every real cluster of each 32-cluster word that holds
    padding or a cluster of a group some ray of the warp may hit
    (`group_precull_plain`)."""
    n_tiles, n_clusters = o.shape[0] // TILE, cmin.shape[0]
    n_real = min(max(int(n_real), 0), n_clusters)
    n_groups = -(-n_real // GROUP)
    live_warps = -(-int(n_live) // TILE) * (TILE // CULL_WARP_RAYS)
    live_warps = min(live_warps, n_tiles * (TILE // CULL_WARP_RAYS))
    c0 = torch.arange(0, n_clusters, 32, device=o.device)
    c1 = torch.clamp(c0 + 32, max=n_clusters)
    real_in = torch.clamp(torch.clamp(c1, max=n_real) - c0, min=0)
    padded = c1 > n_real
    # each word's real clusters' groups, as a [words, groups] incidence
    g = torch.arange(n_groups, device=o.device)
    in_word = ((g[None, :] * GROUP < torch.clamp(c1, max=n_real)[:, None])
               & ((g[None, :] + 1) * GROUP > c0[:, None]))
    blocks = -(-n_real // CULL_BLOCK_CLUSTERS)
    ran = 0
    step = max(1, _ELEMS_PER_STEP // (CULL_WARP_RAYS * max(n_groups, 1)))
    for k in range(0, live_warps, step):
        n_w = min(live_warps - k, step)
        rs = slice(k * CULL_WARP_RAYS, (k + n_w) * CULL_WARP_RAYS)
        args = (o[rs], inv[rs], tmin[rs], tbest[rs], w0[rs], w1[rs])
        may = precull_plain(*args, box).reshape(n_w, CULL_WARP_RAYS).any(1)
        gmay = group_precull_plain(*args, gmin, gmax).reshape(
            n_w, CULL_WARP_RAYS, n_groups).any(1) & may[:, None]
        words = ((gmay.to(torch.float32) @ in_word.to(torch.float32).T) > 0
                 ) | padded[None, :]
        ran += (blocks * n_w + n_groups * int(may.sum())
                + int((words.to(torch.int64) * real_in).sum()))
    return ran, live_warps * n_real


def cull_bits_plain(o, inv, tmin, tbest, w0, w1, cmin, cmax, n_live):
    """Plain PyTorch version of K8, the same arguments but the pre-cull's
    box and n_real, which change no bit → uint8 [C, n_tiles]."""
    n_tiles = o.shape[0] // TILE
    n_clusters = cmin.shape[0]
    out = torch.zeros((n_clusters, n_tiles), dtype=torch.uint8,
                      device=o.device)
    step = max(1, _ELEMS_PER_STEP // (TILE * max(n_clusters, 1)))
    weight = (1 << torch.arange(NSUB, device=o.device)).to(torch.uint8)
    for t0 in range(0, n_tiles, step):
        t1 = min(n_tiles, t0 + step)
        rs = slice(t0 * TILE, t1 * TILE)
        hit = _cull_hits(o[rs], inv[rs], tmin[rs], tbest[rs], w0[rs], w1[rs],
                         cmin, cmax)
        sub = hit.reshape(t1 - t0, NSUB, SUB, n_clusters).any(dim=2)
        bits = (sub.to(torch.uint8) * weight[None, :, None]).sum(
            dim=1, dtype=torch.uint8)
        out[:, t0:t1] = bits.T
    live = torch.arange(n_tiles, device=o.device) * TILE < n_live
    return torch.where(live[None, :], out, 0).to(torch.uint8)


_CULL_SIGNATURES = {"epoch_cull": [ctypes.c_void_p] * 12
                    + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3}


def cull_bits(o, inv, tmin, tbest, w0, w1, cmin, cmax, n_live, box, n_real,
              gmin, gmax):
    """Kernel K8. Rays in tile order: o, inv [N, 3] (inv = 1/d, 1e-30 where
    d is 0), tmin, tbest, w0, w1 [N] (N a multiple of 256); cluster boxes
    cmin, cmax [C, 3]; n_live int32 [1], the live-prefix ray count (tiles
    past it give zeros untested) → uint8 [C, N/256], bit k of (c, tile) set
    when a ray of subtile k enters box c at a distance in [w0, w1), below
    tbest, past tmin.

    `box` float32 [2, 3] (min row, max row) must hold the boxes of clusters
    0 .. n_real − 1, and gmin, gmax [ceil(n_real / GROUP), 3] the hulls of
    their groups (`group_hulls`), each box with min ≤ max (NaN allowed):
    the kernel then leaves a group's clusters untested for warps whose rays
    all fail its hull's or the box's test (`group_precull_plain`), which
    changes no bit. Clusters from n_real on (the padding) are always
    tested. While a torch.profiler records, the kernel adds its tests to
    the counter `metrics.device_counter("cull_tests")` (`cull_tests_plain`
    counts the same).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if o.device.type == "cpu":
        return cull_bits_plain(o, inv, tmin, tbest, w0, w1, cmin, cmax,
                               n_live)
    n, n_clusters = o.shape[0], cmin.shape[0]
    if n % TILE:
        raise ValueError(f"cull_bits: {n} rays, not a multiple of {TILE}")
    n_real = min(max(int(n_real), 0), n_clusters)
    n_groups = -(-n_real // GROUP)
    f32 = torch.float32
    cuda_lib.check_inputs("cull_bits", o.device, [
        (o, f32, (n, 3)), (inv, f32, (n, 3)), (tmin, f32, (n,)),
        (tbest, f32, (n,)), (w0, f32, (n,)), (w1, f32, (n,)),
        (cmin, f32, (n_clusters, 3)), (cmax, f32, (n_clusters, 3)),
        (box, f32, (2, 3)), (gmin, f32, (n_groups, 3)),
        (gmax, f32, (n_groups, 3)), (n_live, torch.int32, (1,))])
    lib = cuda_lib.load("epoch_cull", _CULL_SIGNATURES)
    out = torch.empty((n_clusters, n // TILE), dtype=torch.uint8,
                      device=o.device)
    counter = metrics.device_counter("cull_tests", o.device)
    p = cuda_lib.ptr
    err = lib.epoch_cull(p(o), p(inv), p(tmin), p(tbest), p(w0), p(w1),
                         p(cmin), p(cmax), p(box), p(gmin), p(gmax),
                         p(n_live), n_clusters, n_real, n // TILE, p(out),
                         None if counter is None else p(counter),
                         cuda_lib.stream_ptr(o.device))
    cuda_lib.check(err, "epoch_cull")
    cull_bits.launches += 1
    return out


cull_bits.launches = 0


# ---------------------------------------------------------------------------
# K9: the per-job intersection
# ---------------------------------------------------------------------------

def mt_jobs_plain(job_cluster, job_subtile, o, d, tmin, tmax, tv):
    """Plain PyTorch version of K9, the same arguments → (t [J, 32],
    idx [J, 32] int32)."""
    n_jobs, s = job_cluster.shape[0], tv.shape[2]
    t_out = torch.empty((n_jobs, SUB), dtype=torch.float32, device=o.device)
    i_out = torch.empty((n_jobs, SUB), dtype=torch.int32, device=o.device)
    lanes = torch.arange(SUB, device=o.device)
    step = max(1, _ELEMS_PER_STEP // (SUB * s))
    for j0 in range(0, n_jobs, step):
        js = slice(j0, j0 + step)
        cl = job_cluster[js].long()
        ray = job_subtile[js].long()[:, None] * SUB + lanes  # [Jc, 32]
        r = lambda a: a[ray][..., None]  # [Jc, 32, 1]
        tri = tv[cl]  # [Jc, 9, S]
        v = [tri[:, k, None, :] for k in range(9)]  # each [Jc, 1, S]
        v0x, v0y, v0z = v[0], v[1], v[2]
        e1x, e1y, e1z = v[3] - v0x, v[4] - v0y, v[5] - v0z
        e2x, e2y, e2z = v[6] - v0x, v[7] - v0y, v[8] - v0z
        ox, oy, oz = r(o[:, 0]), r(o[:, 1]), r(o[:, 2])
        dx, dy, dz = r(d[:, 0]), r(d[:, 1]), r(d[:, 2])
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        inv_det = torch.where(det != 0.0,
                              1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
        tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
        beta = (tvx * px + tvy * py + tvz * pz) * inv_det
        qx = tvy * e1z - tvz * e1y
        qy = tvz * e1x - tvx * e1z
        qz = tvx * e1y - tvy * e1x
        gamma = (dx * qx + dy * qy + dz * qz) * inv_det
        t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        ok = ((det != 0.0) & (beta >= 0.0) & (gamma >= 0.0)
              & (beta + gamma <= 1.0) & (t > r(tmin)) & (t < r(tmax)))
        t = torch.where(ok, t, BIG)
        j = torch.argmin(t, dim=2)  # first triangle at the minimum
        t_out[js] = torch.gather(t, 2, j[..., None])[..., 0]
        i_out[js] = (cl[:, None] * s + j).to(torch.int32)
    return t_out, i_out


_MT_SIGNATURES = {"epoch_mt": [ctypes.c_void_p] * 2 + [ctypes.c_int]
                  + [ctypes.c_void_p] * 5 + [ctypes.c_int]
                  + [ctypes.c_void_p] * 3}


def mt_jobs(job_cluster, job_subtile, o, d, tmin, tmax, tv):
    """Kernel K9. Jobs job_cluster, job_subtile int32 [J]; rays in tile
    order o, d [N, 3], tmin, tmax [N]; cluster triangles tv [C, 9, S] → per
    job and lane (ray subtile·32 + lane) the closest t within (tmin, tmax)
    over the cluster's triangles and its index cluster·S + k, the first k
    at that t; (1e30, cluster·S) without a hit.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if o.device.type == "cpu":
        return mt_jobs_plain(job_cluster, job_subtile, o, d, tmin, tmax, tv)
    n_jobs, n = job_cluster.shape[0], o.shape[0]
    f32, i32 = torch.float32, torch.int32
    cuda_lib.check_inputs("mt_jobs", o.device, [
        (job_cluster, i32, (n_jobs,)), (job_subtile, i32, (n_jobs,)),
        (o, f32, (n, 3)), (d, f32, (n, 3)), (tmin, f32, (n,)),
        (tmax, f32, (n,)), (tv, f32, None)])
    if tv.dim() != 3 or tv.shape[1] != 9:
        raise ValueError(f"mt_jobs: tv must be [C, 9, S], got "
                         f"{tuple(tv.shape)}")
    lib = cuda_lib.load("epoch_mt", _MT_SIGNATURES)
    t_out = torch.empty((n_jobs, SUB), dtype=f32, device=o.device)
    i_out = torch.empty((n_jobs, SUB), dtype=i32, device=o.device)
    p = cuda_lib.ptr
    err = lib.epoch_mt(p(job_cluster), p(job_subtile), n_jobs, p(o), p(d),
                       p(tmin), p(tmax), p(tv), tv.shape[2], p(t_out),
                       p(i_out), cuda_lib.stream_ptr(o.device))
    cuda_lib.check(err, "epoch_mt")
    mt_jobs.launches += 1
    return t_out, i_out


mt_jobs.launches = 0
