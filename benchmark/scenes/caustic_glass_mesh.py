"""BASELINE config[2]'s glass-sphere caustics with the ball as a triangle
mesh: the Cornell box of cornell_box.py (its quads, disk light and camera)
with the glass ball (eta 1.5, centre (-0.35, 1.2, 0.45), radius 0.45) as a
closed icosphere of `subdivisions` levels with flat normals. Past 512
triangles the program builds a BVH and a cluster set for it."""
from __future__ import annotations

import numpy as np

from benchmark.scenes import cornell_box

CENTRE = (-0.35, 1.2, 0.45)
RADIUS = 0.45
ETA = 1.5


def icosahedron():
    """(unit vertices [12, 3], faces [20, 3] wound outward)."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
                 np.float64)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
                 np.int64)
    return v / np.linalg.norm(v, axis=1, keepdims=True), f


def icosphere(levels: int):
    """A unit icosphere: each level splits every face into four at its
    edges' midpoints, pushed out to the sphere → (vertices [10·4^levels + 2,
    3] float64, faces [20·4^levels, 3] int64, wound outward)."""
    v, f = icosahedron()
    for _ in range(levels):
        n = v.shape[0]
        edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
        key = np.minimum(edges[:, 0], edges[:, 1]) * n + np.maximum(
            edges[:, 0], edges[:, 1])
        uniq, inv = np.unique(key, return_inverse=True)
        a, b = uniq // n, uniq % n
        mid = v[a] + v[b]
        v = np.concatenate([v, mid / np.linalg.norm(mid, axis=1,
                                                    keepdims=True)])
        m = (n + inv).reshape(3, -1)  # midpoints of edges 01, 12, 20
        m01, m12, m20 = m[0], m[1], m[2]
        f = np.concatenate([np.stack([f[:, 0], m01, m20], 1),
                            np.stack([f[:, 1], m12, m01], 1),
                            np.stack([f[:, 2], m20, m12], 1),
                            np.stack([m01, m12, m20], 1)])
    return v, f


def describe(params: dict, seed: int, width: int, height: int) -> dict:
    """The box has no random part: every seed gives the same scene."""
    desc = cornell_box.describe({k: v for k, v in params.items()
                                 if k != "ball"}, seed, width, height)
    v, f = icosphere(int(params["subdivisions"]))
    desc["materials"]["ball"] = dict(type="glass", eta=ETA)
    desc["meshes"].append(dict(v=v * RADIUS + np.asarray(CENTRE), idx=f,
                               mat="ball"))
    return desc
