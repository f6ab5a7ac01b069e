"""Epoch-subtile cluster intersector: exact closest hit for any ray mix on
scenes with a cluster set (port of raytrace_tpu/ops/epoch_intersect.py).

Rays are sorted for coherence (origin cell, then fine direction; dead rays
last), padded to 2,048-ray groups and cut into 256-ray tiles of eight 32-ray
subtiles. They advance through t-windows anchored at each ray's scene-entry
distance ([-inf, te + L0), [te + L0, inf) at two epochs, L0 twice the mean
cluster extent); a cluster belongs to the one window holding its entry
distance, and a ray resolved in an earlier window culls nothing later.
Per epoch:

  1. K8 (ops/epoch_kernels.py `cull_bits`): each tile against every cluster
     box → uint8 mask [C, n_tiles], one bit per subtile crossing the box;
     warps whose rays cannot reach a real cluster through the scene box,
     or a group of 32 through its hull (`ClusterSet.gmin`, `.gmax`), leave
     those clusters untested (exact pre-culls);
  2. pair compaction: every set entry of the cluster-major mask in
     ascending order — one `torch.nonzero`, the list JAX builds by a sort
     or by its word-packed form, without its fixed-size budget;
  3. subpair expansion: each pair's set bits → (cluster, subtile) jobs;
     each cluster's run padded to a multiple of 4 with (cluster, last
     subtile) jobs, as JAX aligns its job list;
  4. K9 (`mt_jobs`): every job's 32 rays against the cluster's triangles,
     one launch for the epoch;
  5. per-subtile combine with JAX's tie rules: the smallest t, then the
     earliest 2^17-job round, then the smallest triangle index. Across
     epochs strict `<` keeps the earlier winner.

Every pair and subpair of the mask runs, so the engine is exact for any
ray mix; `round_size` is the unit of JAX's tie rule, not a budget. The
compaction reads its counts on the host. Hit-finding takes no gradient:
the callers re-intersect the winner (ops/tri_intersect.reintersect_winner).
"""
from __future__ import annotations

import math

import torch

from raytrace_tpu_torch.ops import epoch_kernels as ek
from raytrace_tpu_torch.ops.cluster_intersect import ClusterSet, floor_cell
from raytrace_tpu_torch.ops.photon_grid import morton3
from raytrace_tpu_torch.utils import metrics

BIG = 1e30
TILE = ek.TILE
SUB = ek.SUB
NSUB = ek.NSUB
ROUND = 1 << 17  # jobs per round of JAX's job scan: the tie-rule unit
TILE_GROUP = 8  # rays are padded to whole groups of 8 tiles, as in JAX
JPS = 4  # each cluster's run of jobs is aligned to this multiple
_KEY_DEAD = 0xFFFFFFFF
_I64_MAX = (1 << 63) - 1


def _sort_key(cmin, cmax, o, d, tmax, tmin):
    """Ray-coherence sort key: the origin's Morton cell (32³ over the
    cluster bounds), then a fine direction Morton cell (16³ over [-1, 1]³);
    rays with an empty t-window last."""
    smin = torch.amin(cmin, dim=0)
    smax = torch.amax(cmax, dim=0)
    ext = torch.clamp(smax - smin, min=1e-6) / 32.0
    ocell = floor_cell((o - smin[None, :]) / ext[None, :], 31)
    dcell = floor_cell((d + 1.0) * 8.0, 15)
    key = (morton3(ocell) << 12) | morton3(dcell)
    return torch.where(tmax > tmin, key, _KEY_DEAD)


def compact_pairs(maskT):
    """Every set entry of the cluster-major mask [C, n_tiles], in ascending
    flat order → (flat indices int64, their mask bytes)."""
    flat = maskT.reshape(-1)
    with metrics.sync("epoch_pairs"):
        pairs = torch.nonzero(flat)[:, 0]
    return pairs, flat[pairs]


def _aligned_jobs(clus, subtile, cp: int, n_subtiles: int):
    """JAX's job alignment (epoch_intersect.py:592-626): the cluster-major
    job list with each cluster's run padded to a multiple of JPS by
    (cluster, last subtile) jobs → (cluster, subtile) int64 per position."""
    with metrics.sync("epoch_job_lens"):
        lens = torch.bincount(clus, minlength=cp)
    al = (lens + JPS - 1) // JPS * JPS
    with metrics.sync("epoch_jobs"):
        total = int(al.sum())
    starts = torch.cumsum(lens, 0) - lens
    new_starts = torch.cumsum(al, 0) - al
    pos = new_starts[clus] + (torch.arange(clus.shape[0], device=clus.device)
                              - starts[clus])
    a_clus = torch.repeat_interleave(
        torch.arange(cp, device=clus.device), al, output_size=total)
    a_sub = torch.full((total,), n_subtiles - 1, dtype=torch.int64,
                       device=clus.device)
    a_sub[pos] = subtile
    return a_clus, a_sub


def _combine(t_rows, i_rows, a_sub, rnd, n_rays: int):
    """Per-ray winner over the jobs' rows → (t [n_rays], idx [n_rays]):
    the smallest t, then the earliest round, then the smallest index
    (JAX's segment-min per round, strict `<` across rounds)."""
    dev = t_rows.device
    ray = (a_sub[:, None] * SUB
           + torch.arange(SUB, device=dev)[None, :]).reshape(-1)
    tf = t_rows.reshape(-1)
    t_e = torch.full((n_rays,), BIG, dtype=torch.float32, device=dev)
    t_e = t_e.scatter_reduce(0, ray, tf, "amin")
    win = (tf <= t_e[ray]) & (tf < BIG)
    key = (rnd[:, None] << 32) | i_rows.to(torch.int64)
    key = torch.where(win, key.reshape(-1), _I64_MAX)
    k_e = torch.full((n_rays,), _I64_MAX, dtype=torch.int64, device=dev)
    k_e = k_e.scatter_reduce(0, ray, key, "amin")
    i_e = torch.where(k_e < _I64_MAX, k_e & 0xFFFFFFFF, 0).to(torch.int32)
    return t_e, i_e


def intersect_epochs(clusters: ClusterSet, o, d, tmin, tmax,
                     n_epochs: int = 2, round_size: int = ROUND):
    """Closest hit through the cluster set with epoch-segmented early
    termination → (t [N], idx [N] int32). Exact for any scene and ray mix.
    No gradient: callers re-intersect the winner."""
    with torch.no_grad():
        return _intersect_epochs(clusters, o.detach(), d.detach(),
                                 tmin.detach(), tmax.detach(), n_epochs,
                                 round_size)


def _intersect_epochs(clusters, o, d, tmin, tmax, n_epochs, round_size):
    dev = o.device
    n = o.shape[0]
    tv, cmin, cmax = clusters.tv, clusters.cmin, clusters.cmax
    cp = tv.shape[0]
    # clusters past this one hold only padding (degenerate triangles that
    # never hit): their jobs are not tested
    n_real = clusters.n_real

    # sort rays for tile coherence (a pure permutation)
    order = torch.argsort(_sort_key(cmin, cmax, o, d, tmax, tmin),
                          stable=True)
    unsort = torch.argsort(order)
    n_pad = -n % (TILE * TILE_GROUP)
    np_ = n + n_pad
    pad = lambda x: torch.cat([x[order], x.new_zeros((n_pad,) + x.shape[1:])])
    o_p, d_p = pad(o).contiguous(), pad(d).contiguous()
    tmin_p, tmax_p = pad(tmin).contiguous(), pad(tmax)  # tmax 0: dead
    n_tiles, n_subtiles = np_ // TILE, np_ // SUB

    # epoch windows: L0 = 2 × the mean cluster extent, growing ×4, anchored
    # at each ray's entry distance into the scene box (clamped to tmin)
    real = torch.isfinite(cmin[:, 0])
    extm = torch.where(real[:, None], cmax - cmin, 0.0)
    mean_ext = torch.sum(torch.amax(extm, dim=1)) / torch.clamp(
        torch.sum(real.to(torch.float32)), min=1.0)
    l0 = 2.0 * torch.clamp(mean_ext, min=1e-6)
    with metrics.sync("epoch_bounds"):
        uppers = torch.tensor([4.0 ** e for e in range(n_epochs - 1)]
                              + [math.inf], dtype=torch.float32, device=dev)
    bounds = torch.cat([torch.zeros((1,), dtype=torch.float32, device=dev),
                        uppers * l0])
    smin = torch.amin(torch.where(real[:, None], cmin, BIG), dim=0)
    smax = torch.amax(torch.where(real[:, None], cmax, -BIG), dim=0)
    inv_d = (1.0 / torch.where(d_p == 0.0, 1e-30, d_p)).contiguous()
    t0 = (smin[None, :] - o_p) * inv_d
    t1 = (smax[None, :] - o_p) * inv_d
    t_enter = torch.maximum(torch.amax(torch.minimum(t0, t1), dim=1), tmin_p)
    n_live = torch.sum(tmax_p > tmin_p).to(torch.int32).reshape(1)
    # K8's pre-cull box: the hull of the real clusters' boxes (smin, smax
    # when every vertex is finite; a NaN vertex makes it NaN, which turns
    # the pre-cull off)
    real_box = torch.stack([torch.amin(cmin[:max(n_real, 1)], dim=0),
                            torch.amax(cmax[:max(n_real, 1)], dim=0)])

    t_best = torch.full((np_,), BIG, dtype=torch.float32, device=dev)
    i_best = torch.zeros((np_,), dtype=torch.int32, device=dev)
    for e in range(n_epochs):
        with metrics.span("rt.intersect.epoch"):
            w0 = (torch.full_like(t_enter, -BIG) if e == 0
                  else t_enter + bounds[e])
            w1 = (torch.full_like(t_enter, BIG) if e == n_epochs - 1
                  else t_enter + bounds[e + 1])
            tb = torch.minimum(t_best, tmax_p).contiguous()
            maskT = ek.cull_bits(o_p, inv_d, tmin_p, tb, w0.contiguous(),
                                 w1.contiguous(), cmin, cmax, n_live, real_box,
                                 n_real, clusters.gmin, clusters.gmax)

            pairs, pbits = compact_pairs(maskT)
            sub = ((pbits[:, None].to(torch.int32)
                    >> torch.arange(NSUB, device=dev)[None, :]) & 1) > 0
            # row-major: ascending (cluster, subtile)
            with metrics.sync("epoch_subpairs"):
                nzs = torch.nonzero(sub)
            pair = pairs[nzs[:, 0]]
            a_clus, a_sub = _aligned_jobs(
                pair // n_tiles, (pair % n_tiles) * NSUB + nzs[:, 1], cp,
                n_subtiles)
            rnd = torch.arange(a_clus.shape[0], device=dev) // round_size
            keep = a_clus < n_real
            with metrics.sync("epoch_keep_clus"):
                a_clus = a_clus[keep]
            with metrics.sync("epoch_keep_sub"):
                a_sub = a_sub[keep]
            with metrics.sync("epoch_keep_round"):
                rnd = rnd[keep]
            if a_clus.shape[0]:
                t_rows, i_rows = ek.mt_jobs(
                    a_clus.to(torch.int32), a_sub.to(torch.int32), o_p, d_p,
                    tmin_p, tb, tv)
                t_e, i_e = _combine(t_rows, i_rows, a_sub, rnd, np_)
                better = t_e < t_best
                t_best = torch.where(better, t_e, t_best)
                i_best = torch.where(better, i_e, i_best)

    t = t_best[:n][unsort]
    return t, torch.clamp(i_best[:n][unsort], 0, max(clusters.n_tris - 1, 0))
