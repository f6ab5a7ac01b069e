"""The cluster set of a large triangle scene and the cluster engine that
intersects coherent launches through it (port of
raytrace_tpu/ops/cluster_intersect.py).

Triangles, already in the BVH's spatially coherent leaf order, are grouped
into contiguous clusters of fixed size with one bounding box each. The
layout is JAX's, so the two packages exchange cluster sets one to one. Two
engines intersect through it: the epoch engine (ops/epoch_intersect.py),
exact for any ray mix, and the cluster engine here, which JAX runs on
coherent camera and shadow launches (ops/intersect.py `_engine`):

  1. sort: rays by the Morton code of the origin's cell (64³ over the
     cluster bounds), then the direction octant, dead rays last; padded
     with zero rays to whole groups of 8 tiles of 128 rays (256 at ≥ 2^21
     rays);
  2. K6 (ops/cluster_kernels.py `cull_tiles`): every tile against every
     cluster box → uint8 mask [n_tiles, C] (a tile whose rays all miss the
     real clusters' hull skips them, which changes no byte); column 0 is
     then set, JAX's seed pair of every tile;
  3. compaction: the first pair_budget·rounds set entries of the
     tile-major mask in ascending order — one `torch.nonzero`, JAX's
     packed pair list and its rounds in one;
  4. K7 (`pair_hits`): each tile's rays against the triangles of its kept
     pairs' clusters, one launch; pairs of padding clusters are counted
     but not run;
  5. unsort, idx clipped to the triangle count.

Per ray the winner is the smallest t, then the lowest triangle index: what
JAX's per-round strict `<` fold and strict-`<` min-combine of its rounds
give, since pairs come sorted by tile and then by cluster. Pairs past the
capacity are dropped and counted in `overflow`; a tile left without a pair
is a defined miss (t 1e30, idx 0). Hit-finding takes no gradient: the
callers re-intersect the winner (ops/bvh.reintersect_winner).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import Tensor

from raytrace_tpu_torch.ops import cluster_kernels as ck
from raytrace_tpu_torch.ops.photon_grid import morton3

BIG = 1e30
CLUSTER_SIZE = 256
TILE_RAYS = 128
TILE_GROUP = 8  # rays are padded to whole groups of 8 tiles, as in JAX
_KEY_DEAD = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class ClusterSet:
    """tv: [C, 9, S] v0/v1/v2 xyz as 9 rows per cluster, triangles along the
    last axis, padded with degenerate (all-zero, never hit) triangles.
    cmin/cmax: [C, 3] cluster boxes; the cluster count is padded to a
    multiple of 128 with +inf/-inf boxes. n_tris: the unpadded count."""
    tv: Tensor
    cmin: Tensor
    cmax: Tensor
    n_tris: int = 0

    @property
    def n_clusters(self) -> int:
        return self.tv.shape[0]


def build_clusters(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, device,
                   cluster_size: int = CLUSTER_SIZE) -> ClusterSet:
    """Group triangles (in BVH-leaf order) into contiguous clusters of
    `cluster_size` and compute their boxes, on the host."""
    t = v0.shape[0]
    pad = -t % cluster_size
    z = lambda a: np.concatenate(
        [a.astype(np.float32), np.zeros((pad, 3), np.float32)]) if pad else (
        a.astype(np.float32))
    v0p, v1p, v2p = z(v0), z(v1), z(v2)
    tp = t + pad
    c = tp // cluster_size
    tv = np.concatenate([v0p, v1p, v2p], axis=1)  # [Tp, 9]
    tv = tv.reshape(c, cluster_size, 9).transpose(0, 2, 1)  # [C, 9, S]

    valid = np.zeros(tp, bool)
    valid[:t] = True
    bmin = np.minimum(np.minimum(v0p, v1p), v2p)
    bmax = np.maximum(np.maximum(v0p, v1p), v2p)
    bmin = np.where(valid[:, None], bmin, np.float32(np.inf))
    bmax = np.where(valid[:, None], bmax, np.float32(-np.inf))
    cmin = bmin.reshape(c, cluster_size, 3).min(axis=1)
    cmax = bmax.reshape(c, cluster_size, 3).max(axis=1)
    cpad = -c % 128
    if cpad:
        tv = np.concatenate(
            [tv, np.zeros((cpad,) + tv.shape[1:], np.float32)])
        cmin = np.concatenate([cmin, np.full((cpad, 3), np.inf, np.float32)])
        cmax = np.concatenate([cmax, np.full((cpad, 3), -np.inf,
                                             np.float32)])
    f = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                  device=device)
    return ClusterSet(tv=f(tv), cmin=f(cmin), cmax=f(cmax), n_tris=int(t))


def floor_cell(x, hi: int):
    """floor(x) clipped to [0, hi] as int64 (NaN → 0), as XLA casts it."""
    f = torch.floor(x)
    return torch.clamp(torch.where(torch.isnan(f), 0.0, f), 0, hi).long()


def _sort_key(cmin, cmax, o, d, tmin, tmax):
    """JAX's ray-coherence key: the origin's Morton cell (64³ over the
    cluster bounds) shifted by 3, or-ed with the direction octant; rays
    with an empty t-window last."""
    smin = torch.amin(cmin, dim=0)  # padding rows are +inf
    smax = torch.amax(cmax, dim=0)
    ext = torch.clamp(smax - smin, min=1e-6) / 64.0
    ocell = floor_cell((o - smin[None, :]) / ext[None, :], 63)
    octant = ((d[:, 0] > 0).long() * 4 + (d[:, 1] > 0).long() * 2
              + (d[:, 2] > 0).long())
    key = (morton3(ocell) << 3) | octant
    return torch.where(tmax > tmin, key, _KEY_DEAD)


def intersect_clusters(clusters: ClusterSet, o, d, tmin, tmax,
                       pair_budget: int = 1 << 17, sort_rays: bool = True,
                       rounds: int = 1, tile_rays: int | None = None):
    """Closest hit through the cluster engine → (t [N], idx [N] int32,
    n_pairs [], overflow [] int64 on the device). idx is the global
    triangle index. Exact while overflow is 0; pairs past the capacity
    pair_budget·rounds are dropped and counted. No gradient: callers
    re-intersect the winner."""
    with torch.no_grad():
        return _intersect_clusters(clusters, o.detach(), d.detach(),
                                   tmin.detach(), tmax.detach(), pair_budget,
                                   sort_rays, rounds, tile_rays)


def _intersect_clusters(clusters, o, d, tmin, tmax, pair_budget, sort_rays,
                        rounds, tile_rays):
    dev = o.device
    n = o.shape[0]
    tv, cmin, cmax = clusters.tv, clusters.cmin, clusters.cmax
    cp, s = tv.shape[0], tv.shape[2]
    # coarser tiles at launch scale keep the mask O(rays·clusters/tile)
    if tile_rays is None:
        tile_rays = 256 if n >= (1 << 21) else TILE_RAYS

    order = None
    if sort_rays and n > tile_rays:  # a pure permutation
        order = torch.argsort(_sort_key(cmin, cmax, o, d, tmin, tmax),
                              stable=True)
        o, d, tmin, tmax = o[order], d[order], tmin[order], tmax[order]
    n_pad = -n % (tile_rays * TILE_GROUP)
    pad = lambda x: torch.cat([x, x.new_zeros((n_pad,) + x.shape[1:])])
    o_p, d_p = pad(o).contiguous(), pad(d).contiguous()
    tmin_p, tmax_p = pad(tmin).contiguous(), pad(tmax).contiguous()
    n_tiles = (n + n_pad) // tile_rays

    # clusters from n_real on are padding (degenerate triangles that never
    # hit, boxes (+inf, −inf)); K6 pre-culls against the real ones' hull
    n_real = -(-clusters.n_tris // s)
    mask = ck.cull_tiles(o_p, d_p, tmin_p, tmax_p, cmin, cmax, tile_rays,
                         n_real)
    mask[:, 0] = 1  # the seed pair (tile, cluster 0)
    flat_pairs = torch.nonzero(mask.reshape(-1))[:, 0]  # tile·cp + cluster
    n_pairs = flat_pairs.shape[0]
    capacity = pair_budget * rounds
    kept = flat_pairs[:capacity]
    # tile t's kept pairs are the entries in [t·cp, (t+1)·cp), by ascending
    # cluster; padding clusters close that run and are counted, not run:
    # K7 takes [t·cp, t·cp + n_real)
    starts = torch.arange(n_tiles, device=dev) * cp
    begin = torch.searchsorted(kept, starts).to(torch.int32)
    end = torch.searchsorted(kept, starts + n_real).to(torch.int32)
    t_p, i_p = ck.pair_hits((kept % cp).to(torch.int32), begin, end, o_p,
                            d_p, tmin_p, tmax_p, tv)
    t, idx = t_p[:n], i_p[:n]
    if order is not None:
        t = torch.empty_like(t).index_put_((order,), t)
        idx = torch.empty_like(idx).index_put_((order,), idx)
    idx = torch.clamp(idx, 0, max(clusters.n_tris - 1, 0))
    count = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)
    return t, idx, count(n_pairs), count(max(n_pairs - capacity, 0))
