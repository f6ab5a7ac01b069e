"""Film: sample accumulation into the image raster (port of
raytrace_tpu/utils/film.py) — one scatter-add over all samples through a
pbrt reconstruction filter (box, triangle or gaussian), with NaN / negative
/ infinite samples zeroed first like the reference's guards."""
from __future__ import annotations

import math

import torch
from torch import Tensor

from raytrace_tpu_torch.core import spectrum


def _resolve(acc: Tensor, wsum: Tensor, width: int, height: int) -> Tensor:
    img = acc / torch.clamp(wsum, min=1e-20)[:, None]
    return img.reshape(height, width, 3)


def splat_box(image_xy: Tensor, radiance: Tensor, width: int,
              height: int) -> Tensor:
    """Box-filter (radius 0.5) film: a sample at continuous x lands in
    pixel floor(x) → [height, width, 3]."""
    l = spectrum.sanitize(radiance)
    px = torch.clamp(torch.floor(image_xy[:, 0]).long(), 0, width - 1)
    py = torch.clamp(torch.floor(image_xy[:, 1]).long(), 0, height - 1)
    flat = py * width + px
    acc = torch.zeros((height * width, 3), dtype=l.dtype, device=l.device)
    wsum = torch.zeros((height * width,), dtype=l.dtype, device=l.device)
    acc.index_add_(0, flat, l)
    wsum.index_add_(0, flat, torch.ones_like(l[:, 0]))
    return _resolve(acc, wsum, width, height)


def splat(image_xy: Tensor, radiance: Tensor, width: int, height: int,
          filter_type: str = "box", filter_radius: float = 0.0,
          gaussian_alpha: float = 2.0) -> Tensor:
    """Film accumulation through a pbrt filter: "box" (radius 0.5),
    "triangle" or "gaussian" (default radius 2, gaussian alpha 2), each
    sample scattered into the (2·ceil(r)+1)² pixel taps and the result
    weight-normalized per pixel like pbrt's Film::WriteImage."""
    if filter_type == "box":
        return splat_box(image_xy, radiance, width, height)
    if filter_type not in ("triangle", "gaussian"):
        raise ValueError(f"unknown pixel filter {filter_type!r}")
    r = float(filter_radius) if filter_radius > 0.0 else 2.0
    l = spectrum.sanitize(radiance)
    x, y = image_xy[:, 0], image_xy[:, 1]
    px0 = torch.floor(x).long()
    py0 = torch.floor(y).long()
    taps = int(math.ceil(r))
    if filter_type == "gaussian":
        edge = math.exp(-gaussian_alpha * r * r)
        w1d = lambda t: torch.clamp(
            torch.exp(-gaussian_alpha * t * t) - edge, min=0.0)
    else:
        w1d = lambda t: torch.clamp(r - torch.abs(t), min=0.0)
    acc = torch.zeros((height * width, 3), dtype=l.dtype, device=l.device)
    wsum = torch.zeros((height * width,), dtype=l.dtype, device=l.device)
    for dy in range(-taps, taps + 1):
        for dx in range(-taps, taps + 1):
            pxc = px0 + dx
            pyc = py0 + dy
            w = (w1d(x - (pxc.to(x.dtype) + 0.5))
                 * w1d(y - (pyc.to(y.dtype) + 0.5)))
            inb = (pxc >= 0) & (pxc < width) & (pyc >= 0) & (pyc < height)
            w = torch.where(inb, w, 0.0)
            flat = (torch.clamp(pyc, 0, height - 1) * width
                    + torch.clamp(pxc, 0, width - 1))
            acc.index_add_(0, flat, w[:, None] * l)
            wsum.index_add_(0, flat, w)
    return _resolve(acc, wsum, width, height)
