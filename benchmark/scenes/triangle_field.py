"""BASELINE config[4]'s many-triangle scene: a jittered terrain grid of
`n_triangles` matte triangles under a point light (the settings of
raytrace_tpu's scene/presets.py triangle_field). The jitter of the heights
is drawn from the run's seed."""
from __future__ import annotations

import numpy as np

from benchmark.scenes.transforms import look_at


def terrain(n_triangles: int, seed: int):
    """(float64 vertices [V, 3], int64 indices [n_triangles, 3])."""
    rng = np.random.default_rng(seed)
    g = int(np.ceil(np.sqrt(n_triangles / 2)))
    xs = np.linspace(-10, 10, g + 1)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    gz = (0.6 * np.sin(gx * 0.9) * np.cos(gy * 0.9)
          + 0.08 * rng.standard_normal(gx.shape))
    verts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    vid = np.arange((g + 1) * (g + 1)).reshape(g + 1, g + 1)
    a, b = vid[:-1, :-1].ravel(), vid[1:, :-1].ravel()
    c, d = vid[1:, 1:].ravel(), vid[:-1, 1:].ravel()
    idx = np.concatenate([np.stack([a, b, c], -1),
                          np.stack([a, c, d], -1)])[:n_triangles]
    return verts, idx


def describe(params: dict, seed: int, width: int, height: int) -> dict:
    verts, idx = terrain(int(params["n_triangles"]), seed)
    return dict(
        materials={"ground": dict(type="matte", kd=[0.55, 0.55, 0.6])},
        meshes=[dict(v=verts, idx=idx, mat="ground")], spheres=[],
        lights=[dict(kind="point", pos=[0.0, 0.0, 14.0],
                     intensity=[500.0, 500.0, 500.0])],
        camera=dict(c2w=look_at((0.0, -14.0, 9.0), (0.0, 0.0, 0.0),
                                (0.0, 0.0, 1.0)),
                    fov=55.0, width=width, height=height))
