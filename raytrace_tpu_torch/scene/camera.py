"""Perspective camera with ray differentials, fully vectorized (port of
raytrace_tpu/scene/camera.py): pbrt-v2's PerspectiveCamera raster→camera
chain, differentials shifted one pixel, ScaleDifferentials(1/sqrt(spp)),
and lens sampling for depth of field."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import Tensor

from raytrace_tpu_torch.core import prng, vec
from raytrace_tpu_torch.core.sampling import concentric_sample_disk


@dataclasses.dataclass(frozen=True)
class RayDifferentials:
    """SoA batch of camera rays (reference: CudaRayDifferential)."""
    o: Tensor  # [N, 3]
    d: Tensor  # [N, 3]
    rx_o: Tensor  # [N, 3]
    rx_d: Tensor  # [N, 3]
    ry_o: Tensor  # [N, 3]
    ry_d: Tensor  # [N, 3]


@dataclasses.dataclass(frozen=True)
class PerspectiveCamera:
    raster_to_camera: Tensor  # [4, 4]
    camera_to_world: Tensor  # [3, 4]
    dx_camera: Tensor  # [3]
    dy_camera: Tensor  # [3]
    lens_radius: float  # float32-rounded, as the JAX camera stores it
    focal_distance: float
    width: int = 256
    height: int = 256

    @staticmethod
    def make(
        camera_to_world: np.ndarray,
        fov_deg: float,
        width: int,
        height: int,
        lens_radius: float = 0.0,
        focal_distance: float = 1e6,
        screen_window: Optional[tuple] = None,
        *,
        device,
    ) -> "PerspectiveCamera":
        """Build from a pbrt-style LookAt camera-to-world 4x4 and fov (the
        projection chain is computed in float64 numpy, as in the JAX
        package, then stored as float32)."""
        aspect = width / height
        if screen_window is None:
            if aspect > 1.0:
                screen = (-aspect, aspect, -1.0, 1.0)
            else:
                screen = (-1.0, 1.0, -1.0 / aspect, 1.0 / aspect)
        else:
            screen = screen_window
        x0, x1, y0, y1 = screen
        n_, f_ = 1e-2, 1000.0
        persp = np.array(
            [[1, 0, 0, 0],
             [0, 1, 0, 0],
             [0, 0, f_ / (f_ - n_), -f_ * n_ / (f_ - n_)],
             [0, 0, 1, 0]], dtype=np.float64)
        inv_tan = 1.0 / math.tan(math.radians(fov_deg) / 2.0)
        camera_to_screen = np.diag([inv_tan, inv_tan, 1.0, 1.0]) @ persp
        screen_to_raster = (
            np.diag([width, height, 1.0, 1.0])
            @ np.diag([1.0 / (x1 - x0), 1.0 / (y0 - y1), 1.0, 1.0])
            @ np.array([[1, 0, 0, -x0], [0, 1, 0, -y1], [0, 0, 1, 0],
                        [0, 0, 0, 1.0]]))
        raster_to_camera = (np.linalg.inv(camera_to_screen)
                            @ np.linalg.inv(screen_to_raster))

        def r2c(p):
            q = raster_to_camera @ np.array([p[0], p[1], p[2], 1.0])
            return q[:3] / q[3]

        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                        device=device)
        return PerspectiveCamera(
            raster_to_camera=f32(raster_to_camera),
            camera_to_world=f32(np.asarray(camera_to_world,
                                           np.float64)[:3, :4]),
            dx_camera=f32(r2c((1, 0, 0)) - r2c((0, 0, 0))),
            dy_camera=f32(r2c((0, 1, 0)) - r2c((0, 0, 0))),
            lens_radius=float(np.float32(lens_radius)),
            focal_distance=float(np.float32(focal_distance)),
            width=width,
            height=height,
        )


def spp_grid(spp: int) -> tuple[int, int]:
    """Factor spp into an (sx, sy) grid (reference: pbrtcamera.cpp:38-50)."""
    sx, sy = spp, 1
    while sx > sy and (sx & 1) == 0:
        sx //= 2
        sy *= 2
    return sx, sy


def pixel_samples(key: Tensor, width: int, height: int, spp: int,
                  jitter: bool = True):
    """Stratified raster-space sample positions → (image_xy [N,2],
    lens_uv [N,2]), N = width·height·spp, pixel-major."""
    dev = key.device
    sx, sy = spp_grid(spp)
    px, py, si = torch.meshgrid(
        torch.arange(width, device=dev), torch.arange(height, device=dev),
        torch.arange(spp, device=dev), indexing="xy")
    kx, ky = si % sx, si // sx
    if jitter:
        keys = prng.split(key)
        j = prng.uniform(keys[0], tuple(px.shape) + (2,))
        lens = prng.uniform(keys[1], tuple(px.shape) + (2,))
    else:
        j = torch.full(tuple(px.shape) + (2,), 0.5, dtype=torch.float32,
                       device=dev)
        lens = j
    ix = px + (kx + j[..., 0]) / sx
    iy = py + (ky + j[..., 1]) / sy
    xy = torch.stack([ix, iy], dim=-1).reshape(-1, 2)
    return xy.to(torch.float32), lens.reshape(-1, 2)


def generate_rays(camera: PerspectiveCamera, image_xy: Tensor,
                  lens_uv: Tensor, spp: int) -> RayDifferentials:
    """pbrt GenerateRayDifferential for a batch of raster samples."""
    n = image_xy.shape[0]
    dev = image_xy.device
    p_ras = torch.cat([image_xy,
                       torch.zeros((n, 1), dtype=image_xy.dtype, device=dev),
                       torch.ones((n, 1), dtype=image_xy.dtype, device=dev)],
                      dim=-1)
    p_cam_h = p_ras @ camera.raster_to_camera.T
    p_cam = p_cam_h[:, :3] / p_cam_h[:, 3:4]

    o_cam = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    d_cam = vec.normalize(p_cam)
    rx_d_cam = vec.normalize(p_cam + camera.dx_camera)
    ry_d_cam = vec.normalize(p_cam + camera.dy_camera)
    rx_o_cam = o_cam
    ry_o_cam = o_cam

    if camera.lens_radius > 0.0:
        # depth of field (pbrt perspective.cpp lens sampling)
        lx, ly = concentric_sample_disk(lens_uv[:, 0], lens_uv[:, 1])
        lens_p = camera.lens_radius * torch.stack(
            [lx, ly, torch.zeros_like(lx)], -1)

        def with_lens(o, d):
            ft = camera.focal_distance / torch.clamp(d[:, 2:3], min=1e-8)
            p_focus = o + d * ft
            o2 = o + lens_p
            return o2, vec.normalize(p_focus - o2)

        o_cam, d_cam = with_lens(o_cam, d_cam)
        rx_o_cam, rx_d_cam = with_lens(rx_o_cam, rx_d_cam)
        ry_o_cam, ry_d_cam = with_lens(ry_o_cam, ry_d_cam)

    c2w = camera.camera_to_world
    o = vec.transform_point(c2w, o_cam)
    d = vec.transform_vector(c2w, d_cam)
    rx_o = vec.transform_point(c2w, rx_o_cam)
    ry_o = vec.transform_point(c2w, ry_o_cam)
    rx_d = vec.transform_vector(c2w, rx_d_cam)
    ry_d = vec.transform_vector(c2w, ry_d_cam)

    # ScaleDifferentials(1/sqrt(spp)) (reference: pbrtcamera.cpp:99)
    s = float(np.float32(1.0 / math.sqrt(spp)))
    return RayDifferentials(
        o=o, d=d,
        rx_o=o + (rx_o - o) * s, rx_d=d + (rx_d - d) * s,
        ry_o=o + (ry_o - o) * s, ry_d=d + (ry_d - d) * s,
    )
