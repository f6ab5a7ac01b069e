"""Flattened BVH over the triangle soup and its stackless traversal (port of
raytrace_tpu/ops/bvh.py).

The BVH is built on the host — the numpy median split here, or the binned
SAH of the C++ builder (csrc/bvh_builder.cc, ops/bvh_native.py) — into the
pbrt-style depth-first flat layout (left child = node+1, explicit right
child), with skip links so a traversal needs no per-ray stack, and the
triangle arrays are reordered so each leaf covers a contiguous range.

`_traverse` walks the skip links as a masked wavefront: every ray of the
batch steps together, one node record and one leaf of triangles per step.
On a scene with a cluster set every launch takes the cluster or the epoch
engine (ops/intersect.py `_engine`); the traversal serves scenes with a BVH
and no cluster set, and is the exact oracle the engines are checked against.
Traversal is bookkeeping under no_grad; the winner is re-intersected with
differentiable tensor ops (`reintersect_winner`).
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch
from torch import Tensor

from raytrace_tpu_torch.ops.tri_intersect import reintersect_winner

BIG = 1e30
# rays are traversed in chunks so that finished chunks retire early instead
# of stepping with the slowest ray of the whole batch
TRAVERSE_CHUNK = 1 << 15

__all__ = ["FlatBVH", "build_bvh", "build_bvh_native", "bvh_from_arrays",
           "compute_skip_links", "intersect_triangles_bvh",
           "occluded_triangles_bvh", "reintersect_winner"]


@dataclasses.dataclass(frozen=True)
class FlatBVH:
    """pbrt-style flattened BVH with skip links ("ropes"): on a missed or
    finished subtree a ray jumps to `skip[node]`, the next node in DFS
    order outside the subtree. `packed` is the node record as one [Nn, 8]
    f32 row (bmin, bmax, bitcast skip, bitcast first | count << 28), so a
    traversal step gathers once."""
    bmin: Tensor  # [Nn, 3]
    bmax: Tensor  # [Nn, 3]
    right: Tensor  # [Nn] int32 right child (interior nodes)
    first: Tensor  # [Nn] int32 first primitive (leaves)
    count: Tensor  # [Nn] int32 primitive count (0 = interior)
    axis: Tensor  # [Nn] int32 split axis (interior nodes)
    skip: Tensor  # [Nn] int32 DFS skip link (Nn = done)
    packed: Tensor  # [Nn, 8] f32 node record
    max_depth: int = 32
    leaf_size: int = 4


def compute_skip_links(right: np.ndarray, count: np.ndarray) -> np.ndarray:
    """Skip link per node: the next node in DFS pre-order outside the
    node's subtree (n_nodes for the last). One forward pass: a visited
    interior node hands skip[left] = its right child, skip[right] = its
    own skip."""
    n = right.shape[0]
    skip = np.empty(n, np.int32)
    skip[0] = n
    interior = count == 0
    for i in range(n):
        if interior[i]:
            skip[i + 1] = right[i]
            skip[right[i]] = skip[i]
    return skip


def _pack_nodes(bmin, bmax, skip, first, count) -> np.ndarray:
    packed = np.empty((bmin.shape[0], 8), np.float32)
    packed[:, 0:3] = bmin
    packed[:, 3:6] = bmax
    packed[:, 6] = skip.astype(np.int32).view(np.float32)
    fc = first.astype(np.uint32) | (count.astype(np.uint32) << 28)
    packed[:, 7] = fc.view(np.float32)
    return packed


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
              leaf_size: int = 4) -> tuple[dict, np.ndarray]:
    """Median-split BVH build on the host → (flat node arrays, primitive
    permutation). Splits at the centroid median along the largest-extent
    axis, so leaves never exceed `leaf_size`."""
    t = v0.shape[0]
    bbmin = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    bbmax = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    cent = (0.5 * (bbmin + bbmax)).astype(np.float64)

    n_bmin, n_bmax = [], []
    n_right, n_first, n_count, n_axis = [], [], [], []
    perm: list[np.ndarray] = []
    perm_n = 0
    max_depth = 0
    # iterative DFS: 'patch' frames set the right child once the left
    # subtree has been emitted
    stack: list[tuple] = [("build", np.arange(t, dtype=np.int64), 1)]
    while stack:
        frame = stack.pop()
        if frame[0] == "patch":
            n_right[frame[1]] = len(n_bmin)
            continue
        _, idx, depth = frame
        max_depth = max(max_depth, depth)
        node_id = len(n_bmin)
        n_bmin.append(bbmin[idx].min(axis=0))
        n_bmax.append(bbmax[idx].max(axis=0))
        if len(idx) <= leaf_size:
            n_right.append(0)
            n_first.append(perm_n)
            n_count.append(len(idx))
            n_axis.append(0)
            perm.append(idx)
            perm_n += len(idx)
            continue
        c = cent[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argsort(c[:, axis], kind="stable")
        mid = len(idx) // 2
        left, right = idx[order[:mid]], idx[order[mid:]]
        n_right.append(-1)
        n_first.append(0)
        n_count.append(0)
        n_axis.append(axis)
        stack.append(("build", right, depth + 1))
        stack.append(("patch", node_id))
        stack.append(("build", left, depth + 1))

    arrays = dict(
        bmin=np.asarray(n_bmin, np.float32),
        bmax=np.asarray(n_bmax, np.float32),
        right=np.asarray(n_right, np.int32),
        first=np.asarray(n_first, np.int32),
        count=np.asarray(n_count, np.int32),
        axis=np.asarray(n_axis, np.int32),
        max_depth=int(max_depth),
        leaf_size=int(leaf_size),
    )
    return arrays, (np.concatenate(perm) if perm
                    else np.arange(0, dtype=np.int64))


def build_bvh_native(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                     leaf_size: int = 4) -> tuple[dict, np.ndarray]:
    """The binned-SAH build of csrc/bvh_builder.cc. Where the C++ compiler
    is missing or fails, the median split builds instead, with a
    RuntimeWarning: the two builders order the triangles differently."""
    from raytrace_tpu_torch.ops import bvh_native

    try:
        return bvh_native.build_bvh_sah(v0, v1, v2, leaf_size=leaf_size)
    except (OSError, RuntimeError) as e:
        warnings.warn(f"the binned-SAH BVH builder is unavailable ({e}); "
                      "building with the median split, which orders the "
                      "triangles differently", RuntimeWarning)
        return build_bvh(v0, v1, v2, leaf_size=leaf_size)


def bvh_from_arrays(arrays: dict, device) -> FlatBVH:
    right = np.asarray(arrays["right"], np.int32)
    count = np.asarray(arrays["count"], np.int32)
    first = np.asarray(arrays["first"], np.int32)
    bmin = np.asarray(arrays["bmin"], np.float32)
    bmax = np.asarray(arrays["bmax"], np.float32)
    skip = compute_skip_links(right, count)
    t = lambda a: torch.as_tensor(a, device=device)
    return FlatBVH(
        bmin=t(bmin), bmax=t(bmax), right=t(right), first=t(first),
        count=t(count), axis=t(np.asarray(arrays["axis"], np.int32)),
        skip=t(skip), packed=t(_pack_nodes(bmin, bmax, skip, first, count)),
        max_depth=int(arrays["max_depth"]),
        leaf_size=int(arrays["leaf_size"]))


# ---------------------------------------------------------------------------
# Traversal
# ---------------------------------------------------------------------------

def _dot(a: Tensor, b: Tensor) -> Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a: Tensor, b: Tensor) -> Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _tri_hit_leaf(o, d, v0, v1, v2, tmin, tlimit):
    """Rays [N,3] against their own leaf triangles [N,L,3] (Möller–Trumbore)
    → t [N, L], BIG where the test fails."""
    e1 = v1 - v0
    e2 = v2 - v0
    dn = d[:, None, :]
    pvec = _cross(dn.expand_as(e2), e2)
    det = _dot(e1, pvec)
    inv_det = torch.where(det != 0.0,
                          1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
    tvec = o[:, None, :] - v0
    beta = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    gamma = _dot(dn, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    ok = ((det != 0.0) & (beta >= 0.0) & (gamma >= 0.0)
          & (beta + gamma <= 1.0) & (t > tmin[:, None])
          & (t < tlimit[:, None]))
    return torch.where(ok, t, BIG)


def _traverse(bvh: FlatBVH, tris, o, d, tmin, tmax, any_hit: bool):
    """Stackless wavefront traversal over the skip links → (best_t [N],
    best_idx [N] int32). A ray descends (node+1) into a hit interior node
    and otherwise jumps its rope (skip[node]); it retires at node n_nodes.
    With any_hit a ray retires at its first hit (shadow rays)."""
    with torch.no_grad():
        tv = torch.cat([tris.v0, tris.v1, tris.v2], dim=-1)  # [T, 9]
        n = o.shape[0]
        if n > TRAVERSE_CHUNK and n % TRAVERSE_CHUNK == 0:
            out = [_traverse_chunk(bvh, tv, o[s:s + TRAVERSE_CHUNK],
                                   d[s:s + TRAVERSE_CHUNK],
                                   tmin[s:s + TRAVERSE_CHUNK],
                                   tmax[s:s + TRAVERSE_CHUNK], any_hit)
                   for s in range(0, n, TRAVERSE_CHUNK)]
            return (torch.cat([a for a, _ in out]),
                    torch.cat([b for _, b in out]))
        return _traverse_chunk(bvh, tv, o, d, tmin, tmax, any_hit)


def _traverse_chunk(bvh: FlatBVH, tv, o, d, tmin, tmax, any_hit: bool):
    n = o.shape[0]
    dev = o.device
    n_nodes = bvh.packed.shape[0]
    rows = torch.arange(n, device=dev)
    leaf_lane = torch.arange(bvh.leaf_size, device=dev)
    inv_d = 1.0 / torch.where(d == 0.0, 1e-30, d)

    node = torch.zeros((n,), dtype=torch.int64, device=dev)
    best_t = torch.clamp(tmax, max=BIG).to(torch.float32)
    best_i = torch.zeros((n,), dtype=torch.int64, device=dev)
    while bool((node < n_nodes).any()):
        active = node < n_nodes
        nd = torch.clamp(node, max=n_nodes - 1)
        rec = bvh.packed[nd]  # [N, 8]: one gather for the node record
        bits = rec[:, 6:8].contiguous().view(torch.int32).to(torch.int64)
        skip = bits[:, 0]
        fc = bits[:, 1] & 0xFFFFFFFF
        first = fc & ((1 << 28) - 1)
        cnt = fc >> 28

        t0 = (rec[:, 0:3] - o) * inv_d
        t1 = (rec[:, 3:6] - o) * inv_d
        tnear = torch.amax(torch.minimum(t0, t1), dim=-1)
        tfar = torch.amin(torch.maximum(t0, t1), dim=-1)
        box_hit = (active & (tnear <= tfar) & (tfar > tmin)
                   & (tnear < best_t))
        is_leaf = cnt > 0
        do_leaf = box_hit & is_leaf

        # leaf: up to leaf_size contiguous triangles, one gather
        pidx = torch.clamp(first[:, None] + leaf_lane[None, :], 0,
                           tv.shape[0] - 1)
        tri = tv[pidx]  # [N, L, 9]
        t = _tri_hit_leaf(o, d, tri[..., 0:3], tri[..., 3:6], tri[..., 6:9],
                          tmin, best_t)
        lane_ok = leaf_lane[None, :] < cnt[:, None]
        t = torch.where(lane_ok & do_leaf[:, None], t, BIG)
        j = torch.argmin(t, dim=1)  # first lane among equal t
        tj = t[rows, j]
        better = tj < best_t
        best_i = torch.where(better, pidx[rows, j], best_i)
        best_t = torch.where(better, tj, best_t)

        # advance: descend or jump the rope
        nxt = torch.where(box_hit & ~is_leaf, nd + 1, skip)
        node = torch.where(active, nxt, node)
        if any_hit:
            node = torch.where(best_t < tmax, n_nodes, node)
    return best_t, best_i.to(torch.int32)


def intersect_triangles_bvh(bvh: FlatBVH, tris, o, d, tmin, tmax):
    """Closest hit through the BVH → (t, idx, beta, gamma), the contract of
    ops/tri_intersect.intersect_triangles; the winner is re-intersected
    with differentiable tensor ops."""
    best_t, idx = _traverse(bvh, tris, o, d, tmin, tmax, any_hit=False)
    found = best_t < torch.clamp(tmax, max=BIG)
    t, beta, gamma = reintersect_winner(tris, idx, o, d, found)
    return t, idx, beta, gamma


def occluded_triangles_bvh(bvh: FlatBVH, tris, o, d, tmin, tmax) -> Tensor:
    """Any hit through the BVH (the shadow ray type) → [N] bool."""
    best_t, _ = _traverse(bvh, tris, o, d, tmin, tmax, any_hit=True)
    return best_t < torch.clamp(tmax, max=BIG)
