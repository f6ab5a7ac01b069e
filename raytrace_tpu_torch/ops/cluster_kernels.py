"""The cluster engine's two kernels and their plain versions (port of
`_cull_kernel`/`_cull` and `_pair_kernel` of
raytrace_tpu/ops/cluster_intersect.py).

  K6 `cull_tiles`  slab cull of 128- or 256-ray tiles against the cluster
                   boxes → uint8 [n_tiles, C], 1 where any ray of the tile
                   crosses the box (csrc/cluster_cull.cu)
  K7 `pair_hits`   Möller–Trumbore of each tile's rays against the
                   triangles of the clusters of its kept pairs → per-ray
                   (t, idx) (csrc/cluster_pair.cu)

On CUDA tensors each wrapper launches its kernel or raises; on CPU tensors
it runs the plain PyTorch version beside it, the same arithmetic in the
same order. Each wrapper counts its launches in `.launches`.
"""
from __future__ import annotations

import ctypes

import torch

from raytrace_tpu_torch.ops import cuda_lib

BIG = 1e30
_ELEMS_PER_STEP = 1 << 24  # plain versions: tests per block of work


# ---------------------------------------------------------------------------
# K6: the tile cull
# ---------------------------------------------------------------------------

def cull_tiles_plain(o, d, tmin, tmax, cmin, cmax, tile_rays: int):
    """Plain PyTorch version of K6, the same arguments → uint8 [n_tiles,
    C] (JAX `_cull_kernel` :115-138, minimum/maximum propagating NaN)."""
    n_tiles = o.shape[0] // tile_rays
    n_clusters = cmin.shape[0]
    out = torch.empty((n_tiles, n_clusters), dtype=torch.uint8,
                      device=o.device)
    inv = 1.0 / torch.where(d == 0.0, 1e-30, d)
    r = lambda a: a[:, None]
    step = max(1, _ELEMS_PER_STEP // (tile_rays * max(n_clusters, 1)))
    for t0 in range(0, n_tiles, step):
        t1 = min(n_tiles, t0 + step)
        rs = slice(t0 * tile_rays, t1 * tile_rays)
        oo, ii = o[rs], inv[rs]

        def axis_slab(k):
            a = (cmin[None, :, k] - r(oo[:, k])) * r(ii[:, k])
            b = (cmax[None, :, k] - r(oo[:, k])) * r(ii[:, k])
            return torch.minimum(a, b), torch.maximum(a, b)

        n0, f0 = axis_slab(0)
        n1, f1 = axis_slab(1)
        n2, f2 = axis_slab(2)
        tn = torch.maximum(torch.maximum(n0, n1), n2)
        tf = torch.minimum(torch.minimum(f0, f1), f2)
        hit = (tn <= tf) & (tf > r(tmin[rs])) & (tn < r(tmax[rs]))
        out[t0:t1] = hit.reshape(t1 - t0, tile_rays, n_clusters).any(
            dim=1).to(torch.uint8)
    return out


_CULL_SIGNATURES = {"cluster_cull": [ctypes.c_void_p] * 6
                    + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2}


def cull_tiles(o, d, tmin, tmax, cmin, cmax, tile_rays: int):
    """Kernel K6. Rays in tile order: o, d [N, 3], tmin, tmax [N] (N a
    multiple of tile_rays, 128 or 256); cluster boxes cmin, cmax [C, 3] →
    uint8 [N / tile_rays, C], 1 where a ray of the tile crosses box c
    within its (tmin, tmax) segment (inv = 1 / d, 1e-30 where d is 0).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if o.device.type == "cpu":
        return cull_tiles_plain(o, d, tmin, tmax, cmin, cmax, tile_rays)
    n, n_clusters = o.shape[0], cmin.shape[0]
    if tile_rays not in (128, 256) or n % tile_rays:
        raise ValueError(f"cull_tiles: {n} rays in tiles of {tile_rays}")
    f32 = torch.float32
    cuda_lib.check_inputs("cull_tiles", o.device, [
        (o, f32, (n, 3)), (d, f32, (n, 3)), (tmin, f32, (n,)),
        (tmax, f32, (n,)), (cmin, f32, (n_clusters, 3)),
        (cmax, f32, (n_clusters, 3))])
    lib = cuda_lib.load("cluster_cull", _CULL_SIGNATURES)
    out = torch.empty((n // tile_rays, n_clusters), dtype=torch.uint8,
                      device=o.device)
    p = cuda_lib.ptr
    err = lib.cluster_cull(p(o), p(d), p(tmin), p(tmax), p(cmin), p(cmax),
                           n_clusters, n // tile_rays, tile_rays, p(out),
                           cuda_lib.stream_ptr(o.device))
    cuda_lib.check(err, "cluster_cull")
    cull_tiles.launches += 1
    return out


cull_tiles.launches = 0


# ---------------------------------------------------------------------------
# K7: the pair pass
# ---------------------------------------------------------------------------

def pair_hits_plain(pair_cluster, tile_begin, tile_end, o, d, tmin, tmax, tv):
    """Plain PyTorch version of K7, the same arguments → (t [N], idx [N]
    int32): per pair the first triangle at its smallest t, then per ray
    the smallest t and, among pairs at it, the lowest index."""
    dev = o.device
    n, n_tiles, s = o.shape[0], tile_begin.shape[0], tv.shape[2]
    tile_rays = n // max(n_tiles, 1)
    t_out = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    i_out = torch.zeros((n,), dtype=torch.int64, device=dev)
    counts = (tile_end - tile_begin).long().clamp(min=0)
    total = int(counts.sum())
    tiles = torch.repeat_interleave(torch.arange(n_tiles, device=dev), counts,
                                    output_size=total)
    first = torch.cumsum(counts, 0) - counts
    pairs = (tile_begin.long()[tiles]
             + torch.arange(total, device=dev) - first[tiles])
    lanes = torch.arange(tile_rays, device=dev)
    # the first pair's bound: JAX's min(tmax, running best = 1e30)
    hi = torch.minimum(tmax, torch.tensor(BIG, device=dev))
    no_key = torch.iinfo(torch.int64).max
    step = max(1, _ELEMS_PER_STEP // (tile_rays * s))
    for j0 in range(0, pairs.shape[0], step):
        js = slice(j0, j0 + step)
        cl = pair_cluster[pairs[js]].long()
        ray = tiles[js][:, None] * tile_rays + lanes  # [Pc, TR]
        r = lambda a: a[ray][..., None]  # [Pc, TR, 1]
        tri = tv[cl]  # [Pc, 9, S]
        v = [tri[:, k, None, :] for k in range(9)]  # each [Pc, 1, S]
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
              & (beta + gamma <= 1.0) & (t > r(tmin)) & (t < r(hi)))
        t = torch.where(ok, t, BIG)
        k = torch.argmin(t, dim=2)  # the first triangle at the minimum
        t_pair = torch.gather(t, 2, k[..., None])[..., 0].reshape(-1)
        i_pair = (cl[:, None] * s + k).reshape(-1)
        ray = ray.reshape(-1)
        # fold into the running (t, idx): the smallest t, then the lowest
        # index among the pairs (earlier blocks included) at that t
        t_new = t_out.scatter_reduce(0, ray, t_pair, "amin")
        key = torch.where((t_out == t_new) & (t_out < BIG), i_out, no_key)
        win = (t_pair == t_new[ray]) & (t_pair < BIG)
        key = key.scatter_reduce(0, ray, torch.where(win, i_pair, no_key),
                                 "amin")
        t_out, i_out = t_new, torch.where(key < no_key, key, 0)
    return t_out, i_out.to(torch.int32)


_PAIR_SIGNATURES = {"cluster_pair": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                    + [ctypes.c_void_p] * 5 + [ctypes.c_int]
                    + [ctypes.c_void_p] * 3}


def pair_hits(pair_cluster, tile_begin, tile_end, o, d, tmin, tmax, tv):
    """Kernel K7. Kept pairs pair_cluster int32 [P], sorted tile-major and
    by ascending cluster inside a tile; tile t's pairs are [tile_begin[t],
    tile_end[t]) (int32 [T]); rays in tile order o, d [N, 3], tmin, tmax [N]
    (N = T·tile_rays); cluster triangles tv [C, 9, S] → per ray the closest
    t within (tmin, min(tmax, 1e30)) over its tile's clusters and its index
    cluster·S + k, the lowest at that t; (1e30, 0) without a hit.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if o.device.type == "cpu":
        return pair_hits_plain(pair_cluster, tile_begin, tile_end, o, d,
                               tmin, tmax, tv)
    n, n_tiles, n_pairs = o.shape[0], tile_begin.shape[0], pair_cluster.shape[0]
    if n_tiles == 0 or n % n_tiles or (n // n_tiles) % 32:
        raise ValueError(f"pair_hits: {n} rays in {n_tiles} tiles")
    f32, i32 = torch.float32, torch.int32
    cuda_lib.check_inputs("pair_hits", o.device, [
        (pair_cluster, i32, (n_pairs,)), (tile_begin, i32, (n_tiles,)),
        (tile_end, i32, (n_tiles,)), (o, f32, (n, 3)), (d, f32, (n, 3)),
        (tmin, f32, (n,)), (tmax, f32, (n,)), (tv, f32, None)])
    if tv.dim() != 3 or tv.shape[1] != 9:
        raise ValueError(f"pair_hits: tv must be [C, 9, S], got "
                         f"{tuple(tv.shape)}")
    lib = cuda_lib.load("cluster_pair", _PAIR_SIGNATURES)
    t_out = torch.empty((n,), dtype=f32, device=o.device)
    i_out = torch.empty((n,), dtype=i32, device=o.device)
    p = cuda_lib.ptr
    err = lib.cluster_pair(p(pair_cluster), p(tile_begin), p(tile_end),
                           n_tiles, n // n_tiles, p(o), p(d), p(tmin),
                           p(tmax), p(tv), tv.shape[2], p(t_out), p(i_out),
                           cuda_lib.stream_ptr(o.device))
    cuda_lib.check(err, "cluster_pair")
    pair_hits.launches += 1
    return t_out, i_out


pair_hits.launches = 0
