"""Batched light sampling (port of raytrace_tpu/shading/light.py):
illumination sampling for direct lighting, emission sampling for photon
shooting, and the emitted-radiance lookup."""
from __future__ import annotations

import math

import torch
from torch import Tensor

from raytrace_tpu_torch.core import vec
from raytrace_tpu_torch.core.sampling import (
    INV_TWOPI,
    concentric_sample_disk,
    uniform_sample_sphere,
    uniform_sphere_pdf,
)
from raytrace_tpu_torch.scene.scene import LIGHT_DISTANT, LIGHT_POINT, Lights
from raytrace_tpu_torch.utils import metrics


def sample_L_illum(lights: Lights, i_light: int, p: Tensor, u2d: Tensor):
    """Illumination sampling toward light i from points p [N,3] with 2D
    samples u2d [N,2] (reference: cudalight.cu.h:18-64) → (li [N,3],
    uwi [N,3] unnormalized toward the light, pdf [N])."""
    o, p1, p2 = lights.o[i_light], lights.p1[i_light], lights.p2[i_light]
    normal, area = lights.normal[i_light], lights.area[i_light]
    intensity = lights.intensity[i_light]
    with metrics.sync("light_type"):
        ltype = int(lights.ltype[i_light])
    n = p.shape[0]
    ones = torch.ones(n, dtype=p.dtype, device=p.device)

    if ltype == LIGHT_POINT:
        uwi = o - p
        inv_len2 = 1.0 / torch.clamp(vec.length_squared(uwi), min=1e-20)
        return intensity * inv_len2[:, None], uwi, ones
    if ltype == LIGHT_DISTANT:
        r_w = torch.sqrt(torch.clamp(area, min=1e-20) * (1.0 / math.pi))
        uwi = (-normal).expand(n, 3) * (2.0 * r_w)
        return intensity.expand(n, 3), uwi, ones
    # disk area light (cu.h:31-52)
    dx, dy = concentric_sample_disk(u2d[:, 0], u2d[:, 1])
    uwi = o + dx[:, None] * p1 + dy[:, None] * p2 - p
    wi = vec.normalize(uwi)
    dist2 = vec.length_squared(uwi)
    cos_t = -vec.dot(normal.expand_as(wi), wi)
    ca = cos_t * area
    pdf = dist2 / torch.where(ca == 0.0, torch.full_like(ca, 1e-20), ca)
    li = torch.where(cos_t[:, None] > 0.0, intensity.expand(n, 3),
                     torch.zeros((n, 3), dtype=p.dtype, device=p.device))
    return li, uwi, pdf


def sample_Le(lights: Lights, i_light, lu1: Tensor, lu2: Tensor, u1: Tensor,
              u2: Tensor):
    """Emission sampling for photon shooting (reference: cudalight.cu.h:78-124).

    i_light: an int (every sample from one light) or an [N] index tensor
    (per-path light selection). Returns (Le, ray_o, ray_d, Ns [N,3], pdf [N]).
    """
    n = lu1.shape[0]
    if isinstance(i_light, int):
        i_light = torch.full((n,), i_light, dtype=torch.long,
                             device=lu1.device)
    i_light = i_light.long()
    o, p1, p2 = lights.o[i_light], lights.p1[i_light], lights.p2[i_light]
    normal = lights.normal[i_light]
    area = lights.area[i_light]
    intensity = lights.intensity[i_light]
    ltype = lights.ltype[i_light]

    # point light: uniform sphere (cu.h:78-88)
    d_pt = uniform_sample_sphere(lu1, lu2)
    pdf_pt = torch.full((n,), uniform_sphere_pdf(), dtype=lu1.dtype,
                        device=lu1.device)

    # disk area light: disk point + uniform-sphere dir flipped into the
    # normal hemisphere, pdf 1/2π, Le = intensity·area (cu.h:90-110)
    dx, dy = concentric_sample_disk(lu1, lu2)
    o_ar = o + dx[:, None] * p1 + dy[:, None] * p2
    d_ar = uniform_sample_sphere(u1, u2)
    flip = vec.dot(d_ar, normal) < 0.0
    d_ar = torch.where(flip[:, None], -d_ar, d_ar)
    pdf_ar = torch.full((n,), INV_TWOPI, dtype=lu1.dtype, device=lu1.device)
    le_ar = intensity * area[:, None]

    # distant light (pbrt DistantLight::Sample_L ray variant)
    r_w = torch.sqrt(torch.clamp(area, min=1e-20) * (1.0 / math.pi))
    o_di = o - r_w[:, None] * normal + dx[:, None] * p1 + dy[:, None] * p2
    pdf_di = 1.0 / torch.clamp(area, min=1e-20)

    ip = (ltype == LIGHT_POINT)
    idi = (ltype == LIGHT_DISTANT)
    ip3, id3 = ip[:, None], idi[:, None]
    le = torch.where(ip3 | id3, intensity, le_ar)
    ray_o = torch.where(ip3, o, torch.where(id3, o_di, o_ar))
    ray_d = torch.where(ip3, d_pt, torch.where(id3, normal, d_ar))
    ns = torch.where(ip3, d_pt, normal)
    pdf = torch.where(ip, pdf_pt, torch.where(idi, pdf_di, pdf_ar))
    return le, ray_o, ray_d, ns, pdf


def light_L(lights: Lights, i_light: Tensor, wow: Tensor) -> Tensor:
    """Emitted radiance where a camera ray hits emitter geometry front-face
    (reference: cudalight.cu.h:128-138); i_light -1 = not an emitter."""
    idx = torch.clamp(i_light, min=0).long()
    normal = lights.normal[idx]
    intensity = vec.take_rows(lights.intensity, idx)
    front = vec.dot(normal, wow) > 0.0
    hit = (front & (i_light >= 0))[..., None]
    return torch.where(hit, intensity, torch.zeros_like(intensity))
