"""RGB spectra as `[..., 3]` tensors (port of raytrace_tpu/core/spectrum.py)."""
from __future__ import annotations

import torch
from torch import Tensor

from raytrace_tpu_torch.utils import metrics

# pbrt RGBSpectrum::y() luminance weights
_Y_WEIGHT = (0.212671, 0.715160, 0.072169)


def is_black(s: Tensor) -> Tensor:
    """True where all three channels are exactly zero."""
    return torch.all(s == 0.0, dim=-1)


def luminance(s: Tensor) -> Tensor:
    """pbrt RGBSpectrum::y()."""
    with metrics.sync("luminance_weights"):
        w = torch.tensor(_Y_WEIGHT, dtype=s.dtype, device=s.device)
    return torch.sum(s * w, dim=-1)


def sanitize(s: Tensor) -> Tensor:
    """Zero out NaN / negative-luminance / infinite samples before the film
    splat (reference: photonmappingrenderer.cpp:254-268)."""
    y = luminance(s)
    bad = (torch.isnan(y) | torch.isinf(y) | (y < -1e-5)
           | torch.any(torch.isnan(s) | torch.isinf(s), dim=-1))
    return torch.where(bad[..., None], torch.zeros_like(s), s)
