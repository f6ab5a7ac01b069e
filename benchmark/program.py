"""The system under test, raytrace_tpu_torch, built from the benchmark's
scene description: its SceneBuilder (BVH and cluster set included), its
camera and its RenderConfig. Everything of the program the harness calls
goes through here or the entries."""
from __future__ import annotations

import numpy as np

from raytrace_tpu_torch.core.config import RenderConfig
from raytrace_tpu_torch.scene.builder import SceneBuilder
from raytrace_tpu_torch.scene.camera import PerspectiveCamera

def render_config(render: dict, **over) -> RenderConfig:
    """The program's RenderConfig of a configuration's `render` block (every
    key of it is a RenderConfig field)."""
    return RenderConfig(**render, **over)


def build_scene(desc: dict, device):
    """(Scene, PerspectiveCamera) of the description on `device`."""
    b = SceneBuilder()
    mid = {}
    for name, m in desc["materials"].items():
        if m["type"] == "matte":
            mid[name] = b.matte(tuple(m["kd"]))
        elif m["type"] == "glass":
            mid[name] = b.glass(m["eta"])
        else:
            mid[name] = b.mirror(tuple(m["kd"]))
    for mesh in desc["meshes"]:
        b.triangle_mesh(mesh["v"], mesh["idx"], material=mid[mesh["mat"]])
    for s in desc["spheres"]:
        b.sphere(s["radius"], material=mid[s["mat"]],
                 object_to_world=s["o2w"])
    for l in desc["lights"]:
        if l["kind"] == "point":
            b.point_light(tuple(l["pos"]), tuple(l["intensity"]))
        else:
            b.area_light_disk(tuple(l["emit"]), radius=l["radius"],
                              object_to_world=l["o2w"],
                              n_samples=l["n_samples"],
                              material=mid[l["mat"]])
    cam = desc["camera"]
    camera = PerspectiveCamera.make(np.asarray(cam["c2w"]), cam["fov"],
                                    cam["width"], cam["height"],
                                    device=device)
    return b.build(device), camera
