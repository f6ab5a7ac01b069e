"""The Cornell box of BASELINE configs [1] and [2]: a 2x2x2 box of five
matte quads, a disk area light under the ceiling, and an optional mirror or
glass ball (the settings of raytrace_tpu's scene/presets.py cornell_box)."""
from __future__ import annotations

import numpy as np

from benchmark.scenes.transforms import look_at, rotate, translate

QUADS = (  # (corners, material name)
    (([-1, 0, 0], [1, 0, 0], [1, 2, 0], [-1, 2, 0]), "white"),    # floor
    (([-1, 0, 2], [-1, 2, 2], [1, 2, 2], [1, 0, 2]), "white"),    # ceiling
    (([-1, 2, 0], [1, 2, 0], [1, 2, 2], [-1, 2, 2]), "white"),    # back
    (([-1, 0, 0], [-1, 2, 0], [-1, 2, 2], [-1, 0, 2]), "red"),    # left
    (([1, 0, 0], [1, 0, 2], [1, 2, 2], [1, 2, 0]), "green"),      # right
)


def describe(params: dict, seed: int, width: int, height: int) -> dict:
    """The box has no random part: every seed gives the same scene."""
    del seed
    mats = {"white": dict(type="matte", kd=[0.73, 0.73, 0.73]),
            "red": dict(type="matte", kd=[0.65, 0.05, 0.05]),
            "green": dict(type="matte", kd=[0.12, 0.45, 0.15])}
    meshes = [dict(v=np.asarray(pts, np.float64),
                   idx=np.array([[0, 1, 2], [0, 2, 3]]), mat=m)
              for pts, m in QUADS]
    spheres = []
    ball = params.get("ball")
    if ball:
        mats["ball"] = (dict(type="glass", eta=1.5) if ball == "glass"
                        else dict(type="mirror", kd=[0.95, 0.95, 0.95]))
        spheres.append(dict(o2w=translate(-0.35, 1.2, 0.45), radius=0.45,
                            mat="ball"))
    emit = float(params.get("emit", 30.0))
    light = dict(kind="disk", emit=[emit] * 3,
                 radius=float(params.get("light_radius", 0.5)),
                 o2w=translate(0.0, 1.0, float(params.get("light_height",
                                                          1.99)))
                 @ rotate(180.0, (1, 0, 0)),
                 n_samples=int(params.get("n_light_samples", 1)),
                 mat="white")
    return dict(materials=mats, meshes=meshes, spheres=spheres,
                lights=[light],
                camera=dict(c2w=look_at((0.0, -2.4, 1.0), (0.0, 1.0, 1.0),
                                        (0.0, 0.0, 1.0)),
                            fov=60.0, width=width, height=height))
