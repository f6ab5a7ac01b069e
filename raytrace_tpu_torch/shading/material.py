"""Batched BSDF evaluation/sampling (port of raytrace_tpu/shading/material.py):
the tagged-union dispatch of the reference's device material library as
masked tensor math, with the JAX package's documented fixes (mirror Kr,
glass TIR reflects, per-material eta)."""
from __future__ import annotations

import torch
from torch import Tensor

from raytrace_tpu_torch.core import vec
from raytrace_tpu_torch.core.sampling import INV_PI, cosine_sample_hemisphere
from raytrace_tpu_torch.scene.scene import GLASS, MATTE, MIRROR, Materials

TEX_CHECKER_LO = 0.25  # odd checker cells scale kd by this


def _row(mat: Tensor) -> Tensor:
    return torch.clamp(mat, min=0).long()


def texture_eval(materials: Materials, mat: Tensor, uv: Tensor) -> Tensor:
    """Per-material texture factor at uv [N, 2] → [N]: constant or checker."""
    m = _row(mat)
    tt = materials.tex_type[m]
    sc = materials.tex_scale[m]
    cell = torch.floor(uv[..., 0] * sc) + torch.floor(uv[..., 1] * sc)
    odd = torch.remainder(cell, 2.0) >= 1.0
    one = torch.ones_like(cell)
    checker = torch.where(odd, torch.full_like(cell, TEX_CHECKER_LO), one)
    return torch.where(tt == 1, checker, one)


def f(materials: Materials, mat: Tensor, wo_w: Tensor, wi_w: Tensor,
      uv: Tensor | None = None) -> Tensor:
    """Lambert kd/π for matte, black otherwise (cudamaterial.cu.h:17-32)."""
    m = _row(mat)
    kd = vec.take_rows(materials.kd, m)
    if uv is not None:
        kd = kd * texture_eval(materials, mat, uv)[..., None]
    is_matte = (materials.mtype[m] == MATTE) & (mat >= 0)
    return torch.where(is_matte[..., None], kd * INV_PI, torch.zeros_like(kd))


def is_specular(materials: Materials, mat: Tensor) -> Tensor:
    """(reference: cudamaterial.cu.h:168-173)"""
    mt = materials.mtype[_row(mat)]
    return ((mt == MIRROR) | (mt == GLASS)) & (mat >= 0)


def kd_in_specular(materials: Materials, mat: Tensor) -> Tensor:
    """True where the specular throughput multiplies by the kd row (mirror)."""
    return (materials.mtype[_row(mat)] == MIRROR) & (mat >= 0)


def pdf_lambert(wo_local: Tensor, wi_local: Tensor) -> Tensor:
    """(reference: cudamaterial.cu.h:44-47)"""
    same_hemi = wo_local[..., 2] * wi_local[..., 2] > 0.0
    pdf = torch.abs(wi_local[..., 2]) * INV_PI
    return torch.where(same_hemi, pdf, torch.zeros_like(pdf))


def sample_f(materials: Materials, mat: Tensor, ns: Tensor, dpdu: Tensor,
             wo_w: Tensor, u1: Tensor, u2: Tensor, uv: Tensor | None = None):
    """Cosine-hemisphere BSDF sampling in the shading frame
    (cudamaterial.cu.h:68-98) → (f, wi_world, pdf)."""
    nn, sn, tn = vec.shading_frame(ns, dpdu)
    wo = vec.world_to_local(wo_w, nn, sn, tn)
    wi = cosine_sample_hemisphere(u1, u2)
    wz = torch.where(wo[..., 2] < 0.0, -wi[..., 2], wi[..., 2])
    wi = torch.stack([wi[..., 0], wi[..., 1], wz], dim=-1)
    pdf = pdf_lambert(wo, wi)
    fr = f(materials, mat, wo_w, wo_w, uv=uv)  # Lambert: dir-independent
    return fr, vec.local_to_world(wi, nn, sn, tn), pdf


def specular(materials: Materials, mat: Tensor, ns: Tensor, dpdu: Tensor,
             wo_w: Tensor):
    """Specular scattering for mirror/glass (cudamaterial.cu.h:136-165)
    → (throughput [N,3], wi_world [N,3])."""
    nn, sn, tn = vec.shading_frame(ns, dpdu)
    wo = vec.world_to_local(wo_w, nn, sn, tn)
    m = _row(mat)
    mt = materials.mtype[m]
    kr = materials.kd[m]
    eta_mat = materials.eta[m]

    wi_mirror = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)

    cos_o = wo[..., 2]
    entering = cos_o > 0.0
    eta = torch.where(entering, 1.0 / eta_mat, eta_mat)
    sini2 = torch.clamp(1.0 - cos_o * cos_o, min=0.0)
    sint2 = eta * eta * sini2
    tir = sint2 >= 1.0
    cost = torch.sqrt(torch.clamp(1.0 - sint2, min=0.0))
    cost = torch.where(entering, -cost, cost)
    wi_refract = torch.stack([eta * -wo[..., 0], eta * -wo[..., 1], cost], -1)
    wi_glass = torch.where(tir[..., None], wi_mirror, wi_refract)

    is_mirror = (mt == MIRROR)[..., None]
    wi = torch.where(is_mirror, wi_mirror, wi_glass)
    thr = torch.where(is_mirror, kr, torch.ones_like(kr))
    return thr, vec.local_to_world(wi, nn, sn, tn)
