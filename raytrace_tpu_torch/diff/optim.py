"""Inverse-rendering optimisation: recover albedo / emitter power from a
target image (port of raytrace_tpu/diff/optim.py).

The raw parameters live on very different scales (kd ∈ (0, 1), emitter
intensity ~30) and are positively constrained, so Adam runs on an
unconstrained transform of them: kd through a logit, intensity through a
log. `torch.optim.Adam` with its defaults (β 0.9/0.999, eps 1e-8) takes
the same steps as the JAX package's `optax.adam`.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import Tensor

from raytrace_tpu_torch.core.config import RenderConfig
from raytrace_tpu_torch.diff.render import (SceneParams,
                                            render_image_from_params)
from raytrace_tpu_torch.renderers import common
from raytrace_tpu_torch.scene.camera import PerspectiveCamera
from raytrace_tpu_torch.scene.scene import Scene

_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class TransformedParams:
    """Unconstrained reparameterisation of SceneParams."""
    kd_logit: Tensor  # kd = sigmoid(kd_logit) ∈ (0, 1)
    log_intensity: Tensor  # intensity = exp(log_intensity) > 0


def to_transformed(params: SceneParams) -> TransformedParams:
    kd = torch.clamp(params.kd, _EPS, 1.0 - _EPS)
    return TransformedParams(
        kd_logit=torch.log(kd) - torch.log1p(-kd),
        log_intensity=torch.log(torch.clamp(params.intensity, min=_EPS)))


def from_transformed(t: TransformedParams) -> SceneParams:
    return SceneParams(kd=torch.sigmoid(t.kd_logit),
                       intensity=torch.exp(t.log_intensity))


def fit(params0: SceneParams, target: Tensor, scene: Scene,
        camera: PerspectiveCamera, config: RenderConfig, key: Tensor,
        steps: int = 20, lr: float = 0.1, jitter: bool = False,
        light_samples: tuple | None = None
        ) -> tuple[SceneParams, list[float]]:
    """Adam on the transformed parameters against the image MSE → (recovered
    SceneParams, the loss before each step)."""
    if light_samples is None:
        light_samples = common.static_light_samples(scene, config)
    t0 = to_transformed(params0)
    t = TransformedParams(
        kd_logit=t0.kd_logit.detach().clone().requires_grad_(True),
        log_intensity=t0.log_intensity.detach().clone().requires_grad_(True))
    opt = torch.optim.Adam([t.kd_logit, t.log_intensity], lr=lr)
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        img = render_image_from_params(from_transformed(t), scene, camera,
                                       config, key, light_samples, jitter)
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    with torch.no_grad():
        return from_transformed(t), losses
