"""Differentiable rendering: `render(params) → image` with gradients through
shading, photon transport and gathering (port of raytrace_tpu/diff/render.py).

Hit-finding is non-differentiable bookkeeping; radiance is smooth in the
material albedo / mirror reflectance (kd) and the emitter power given the
hit points. With config.differentiable the renderer makes the camera-chain
throughput and the photon flux differentiable by record and replay
(renderers/common.py `replay`) and the row-span gather by its backward
kernel K3 (ops/rowspan_gather.py `RowspanS`); direct lighting and the film
differentiate through plain autograd. The PPM radius and count statistics
take no gradient, as in the JAX package.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import Tensor

from raytrace_tpu_torch.core.config import RenderConfig
from raytrace_tpu_torch.renderers import photon as photon_renderer
from raytrace_tpu_torch.scene.camera import PerspectiveCamera
from raytrace_tpu_torch.scene.scene import Scene


@dataclasses.dataclass(frozen=True)
class SceneParams:
    """The differentiable knobs: albedo / mirror Kr and emitter power."""
    kd: Tensor  # [M, 3] matte albedo / mirror Kr
    intensity: Tensor  # [L, 3] light emission


def extract_params(scene: Scene) -> SceneParams:
    return SceneParams(kd=scene.materials.kd, intensity=scene.lights.intensity)


def apply_params(scene: Scene, params: SceneParams) -> Scene:
    return dataclasses.replace(
        scene,
        materials=dataclasses.replace(scene.materials, kd=params.kd),
        lights=dataclasses.replace(scene.lights, intensity=params.intensity))


def render_image_from_params(params: SceneParams, scene: Scene,
                             camera: PerspectiveCamera, config: RenderConfig,
                             key: Tensor, light_samples: tuple,
                             jitter: bool = True) -> Tensor:
    """Photon render of `scene` with `params` → [H, W, 3]; differentiable
    in params when config.differentiable is True."""
    img, _ = photon_renderer._render_photon(
        apply_params(scene, params), camera, config, key, light_samples,
        jitter)
    return img


def loss_and_grad(params: SceneParams, target: Tensor, scene: Scene,
                  camera: PerspectiveCamera, config: RenderConfig,
                  key: Tensor, light_samples: tuple, jitter: bool = True):
    """MSE image loss and its gradient with respect to the scene parameters
    → (loss [], SceneParams of gradients): the inner step of inverse
    rendering.

    The gradient is taken with torch.autograd.grad with respect to detached
    copies of params.kd and params.intensity, so the caller's tensors are
    not changed, get no `.grad` and keep whatever graph they belong to."""
    leaves = SceneParams(kd=params.kd.detach().requires_grad_(True),
                         intensity=params.intensity.detach()
                         .requires_grad_(True))
    img = render_image_from_params(leaves, scene, camera, config, key,
                                   light_samples, jitter)
    loss = torch.mean((img - target) ** 2)
    g_kd, g_int = torch.autograd.grad(loss, (leaves.kd, leaves.intensity))
    return loss.detach(), SceneParams(kd=g_kd, intensity=g_int)
