"""Render the sphere+plane direct-lighting scene (BASELINE config[0]) with
the port's render_simple and write PNG/PFM output to the temporary
directory — the twin of render_sphere_plane.py. Renders on the CUDA device;
--cpu selects the CPU."""
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.core.config import RenderConfig
from raytrace_tpu_torch.renderers.simple import render_simple
from raytrace_tpu_torch.scene import transform as tr
from raytrace_tpu_torch.scene.builder import SceneBuilder
from raytrace_tpu_torch.scene.camera import PerspectiveCamera
from raytrace_tpu_torch.utils import image as img_util


def build_scene(device):
    b = SceneBuilder()
    m_floor = b.matte((0.7, 0.7, 0.7))
    m_ball = b.matte((0.6, 0.3, 0.2))
    verts = np.array([[-10, -10, 0], [10, -10, 0], [10, 10, 0], [-10, 10, 0]],
                     np.float64)
    b.triangle_mesh(verts, [[0, 1, 2], [0, 2, 3]], material=m_floor)
    b.sphere(1.0, material=m_ball, object_to_world=tr.translate(0, 0, 1))
    b.point_light((3.0, -2.0, 5.0), (60.0, 60.0, 60.0))
    return b.build(device)


def render(scene, cam, config, seed, device):
    """One frame → (image as numpy, seconds), device work included."""
    t0 = time.perf_counter()
    img = render_simple(scene, cam, config, prng.PRNGKey(seed, device))
    if img.is_cuda:
        torch.cuda.synchronize(img.device)
    return img.cpu().numpy(), time.perf_counter() - t0


def main():
    if "--cpu" in sys.argv:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda")
    else:
        raise RuntimeError("no CUDA device; pass --cpu to render on the CPU")
    print("device:", torch.cuda.get_device_name(device)
          if device.type == "cuda" else "cpu")
    scene = build_scene(device)
    c2w = tr.look_at((4.0, -4.0, 2.5), (0.0, 0.0, 1.0), (0.0, 0.0, 1.0))
    size = 256
    cam = PerspectiveCamera.make(c2w, 50.0, size, size, device=device)
    config = RenderConfig(width=size, height=size, spp=4, scene_epsilon=1e-3)

    img, secs = render(scene, cam, config, 0, device)
    print(f"first render (incl. kernel builds): {secs:.2f}s")
    img, secs = render(scene, cam, config, 1, device)
    rays = size * size * config.spp
    print(f"steady render: {secs:.3f}s  ({rays / secs / 1e6:.2f} Mrays/s "
          "primary)")

    out = os.path.join(tempfile.gettempdir(), "sphere_plane_torch")
    img_util.write_png(out + ".png", img)
    img_util.write_pfm(out + ".pfm", img)
    print(f"wrote {out}.png  max={img.max():.3f} mean={img.mean():.4f}")


if __name__ == "__main__":
    main()
