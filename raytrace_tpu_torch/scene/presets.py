"""Built-in scenes mirroring the BASELINE configs (port of
raytrace_tpu/scene/presets.py: `sphere_plane` and `cornell_box`; the
many-triangle `triangle_field` waits for the BVH port)."""
from __future__ import annotations

import numpy as np

from raytrace_tpu_torch.scene import transform as tr
from raytrace_tpu_torch.scene.builder import SceneBuilder
from raytrace_tpu_torch.scene.camera import PerspectiveCamera


def _quad(p0, p1, p2, p3):
    verts = np.array([p0, p1, p2, p3], dtype=np.float64)
    idx = np.array([[0, 1, 2], [0, 2, 3]])
    return verts, idx


def sphere_plane(device, size: int = 256):
    """BASELINE config[0]: single sphere + ground plane, one point light."""
    b = SceneBuilder()
    m_floor = b.matte((0.7, 0.7, 0.7))
    m_ball = b.matte((0.6, 0.3, 0.2))
    v, i = _quad([-10, -10, 0], [10, -10, 0], [10, 10, 0], [-10, 10, 0])
    b.triangle_mesh(v, i, material=m_floor)
    b.sphere(1.0, material=m_ball, object_to_world=tr.translate(0, 0, 1))
    b.point_light((3.0, -2.0, 5.0), (60.0, 60.0, 60.0))
    c2w = tr.look_at((4.0, -4.0, 2.5), (0.0, 0.0, 1.0), (0.0, 0.0, 1.0))
    cam = PerspectiveCamera.make(c2w, 50.0, size, size, device=device)
    return b.build(device), cam


def cornell_box(
    device,
    size: int = 512,
    ball: str | None = None,
    light_radius: float = 0.5,
    light_height: float = 1.99,
    emit: float = 30.0,
    n_light_samples: int = 1,
):
    """BASELINE config[1]/[2]: 2x2x2 Cornell-ish box, ceiling disk area
    light, optional specular ball ('mirror' | 'glass')."""
    b = SceneBuilder()
    white = b.matte((0.73, 0.73, 0.73))
    red = b.matte((0.65, 0.05, 0.05))
    green = b.matte((0.12, 0.45, 0.15))

    def add_quad(pts, mat):
        v, i = _quad(*pts)
        b.triangle_mesh(v, i, material=mat)

    add_quad(([-1, 0, 0], [1, 0, 0], [1, 2, 0], [-1, 2, 0]), white)   # floor
    add_quad(([-1, 0, 2], [-1, 2, 2], [1, 2, 2], [1, 0, 2]), white)   # ceiling
    add_quad(([-1, 2, 0], [1, 2, 0], [1, 2, 2], [-1, 2, 2]), white)   # back
    add_quad(([-1, 0, 0], [-1, 2, 0], [-1, 2, 2], [-1, 0, 2]), red)   # left
    add_quad(([1, 0, 0], [1, 0, 2], [1, 2, 2], [1, 2, 0]), green)     # right

    if ball == "mirror":
        mb = b.mirror((0.95, 0.95, 0.95))
        b.sphere(0.45, material=mb,
                 object_to_world=tr.translate(-0.35, 1.2, 0.45))
    elif ball == "glass":
        gb = b.glass(1.5)
        b.sphere(0.45, material=gb,
                 object_to_world=tr.translate(-0.35, 1.2, 0.45))

    o2w = tr.translate(0.0, 1.0, light_height) @ tr.rotate(180.0, (1, 0, 0))
    b.area_light_disk((emit, emit, emit), radius=light_radius,
                      object_to_world=o2w, n_samples=n_light_samples,
                      material=white)
    c2w = tr.look_at((0.0, -2.4, 1.0), (0.0, 1.0, 1.0), (0.0, 0.0, 1.0))
    cam = PerspectiveCamera.make(c2w, 60.0, size, size, device=device)
    return b.build(device), cam
