"""The cluster set of a large triangle scene (port of the `ClusterSet` and
`build_clusters` of raytrace_tpu/ops/cluster_intersect.py).

Triangles, already in the BVH's spatially coherent leaf order, are grouped
into contiguous clusters of fixed size with one bounding box each. The
epoch engine (ops/epoch_intersect.py) culls rays against the boxes and
tests the surviving (ray group, cluster) pairs triangle by triangle. The
layout is JAX's, so the two packages exchange cluster sets one to one. The
cluster engine that JAX runs on coherent launches (`_cull`,
`intersect_clusters`, TPU kernels K6 and K7) is not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import Tensor

BIG = 1e30
CLUSTER_SIZE = 256


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
