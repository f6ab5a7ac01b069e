"""The "simple" direct-lighting renderer (port of
raytrace_tpu/renderers/simple.py) — the reference's sanity/test path
(simple_render/simplerender.{h,cpp,cu}: one bounce, per-light shadow rays,
film splat).

Deviation documented, as in the JAX package: the reference kernel omits the
1/pdf factor for area lights (simplerender.cu:69 has no pdf division — a
bug its own photon renderer does not share, raytracing.cu:78). The correct
estimator is used, matching pbrt-v2.
"""
from __future__ import annotations

from torch import Tensor

from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.core.config import RenderConfig
from raytrace_tpu_torch.renderers import common
from raytrace_tpu_torch.scene.camera import (PerspectiveCamera,
                                             generate_rays, pixel_samples)
from raytrace_tpu_torch.scene.scene import Scene
from raytrace_tpu_torch.utils import film


def render_simple(scene: Scene, camera: PerspectiveCamera,
                  config: RenderConfig, key: Tensor,
                  jitter: bool = True) -> Tensor:
    """Render and return the [H, W, 3] image.

    Camera pass with specular chains followed to the cap, then direct
    lighting at the first diffuse hit weighted by the chain throughput —
    the reference's simple kernel has no specular path (a mirror renders
    black there); following the chain matches the photon renderer's camera
    pass."""
    light_samples = common.static_light_samples(scene, config)
    keys = prng.split(key)
    xy, lens = pixel_samples(keys[0], config.width, config.height,
                             config.spp, jitter=jitter)
    rays = generate_rays(camera, xy, lens, config.spp)
    rec = common.camera_pass(scene, rays.o, rays.d, config)
    L = common.direct_lighting(scene, rec, keys[1], config, light_samples,
                               include_emitted=False)
    return film.splat(xy, rec.atten * L, config.width, config.height,
                      config.pixel_filter, config.filter_radius)
