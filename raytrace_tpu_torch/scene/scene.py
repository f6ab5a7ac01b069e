"""The scene as dataclasses of SoA tensors (port of raytrace_tpu/scene/scene.py).

Triangles pre-transformed to world space, disks flattened to a world frame,
spheres kept in object space behind an affine o2w/w2o pair — the same flat
per-family arrays as the JAX package, as plain frozen dataclasses of torch
tensors instead of flax pytrees.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import Tensor

# Material types (reference: util/common.cu.h:61-63)
MATTE, MIRROR, GLASS = 0, 1, 2
# Light types (reference: util/common.cu.h:48)
LIGHT_POINT, LIGHT_AREA_DISK, LIGHT_DISTANT = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class Triangles:
    """World-space triangle soup with shading normals and UVs."""
    v0: Tensor  # [T, 3]
    v1: Tensor  # [T, 3]
    v2: Tensor  # [T, 3]
    n0: Tensor  # [T, 3] shading normals (geometric normal where absent)
    n1: Tensor  # [T, 3]
    n2: Tensor  # [T, 3]
    uv0: Tensor  # [T, 2]
    uv1: Tensor  # [T, 2]
    uv2: Tensor  # [T, 2]
    has_normals: Tensor  # [T] bool
    mat: Tensor  # [T] int32 material index, -1 = padding
    light: Tensor  # [T] int32 area-light index, -1 = none

    @property
    def count(self) -> int:
        return self.v0.shape[0]


@dataclasses.dataclass(frozen=True)
class Spheres:
    """Full spheres intersected in object space (reference: cudasphere.cu)."""
    o2w: Tensor  # [S, 3, 4]
    w2o: Tensor  # [S, 3, 4]
    radius: Tensor  # [S]
    mat: Tensor  # [S] int32
    light: Tensor  # [S] int32
    flip: Optional[Tensor] = None  # [S] bool, pbrt ReverseOrientation

    @property
    def count(self) -> int:
        return self.radius.shape[0]


@dataclasses.dataclass(frozen=True)
class Disks:
    """Disks flattened to a world frame (reference: cudadisk.cpp:23-43)."""
    o: Tensor  # [D, 3]
    x: Tensor  # [D, 3]
    y: Tensor  # [D, 3]
    z: Tensor  # [D, 3]
    moffset: Tensor  # [D]
    inv_r2: Tensor  # [D, 2]
    inner_radius: Tensor  # [D]
    phi_max: Tensor  # [D]
    mat: Tensor  # [D] int32
    light: Tensor  # [D] int32

    @property
    def count(self) -> int:
        return self.moffset.shape[0]


@dataclasses.dataclass(frozen=True)
class Materials:
    """Tagged material table (reference: util/material/cudamaterial.{h,cpp})."""
    mtype: Tensor  # [M] int32
    kd: Tensor  # [M, 3]
    eta: Tensor  # [M]
    tex_type: Tensor  # [M] int32: 0 constant, 1 checker
    tex_scale: Tensor  # [M] f32


@dataclasses.dataclass(frozen=True)
class Lights:
    """Flattened light table (reference: CudaLightDevice, common.cu.h:47-59)."""
    ltype: Tensor  # [L] int32
    o: Tensor  # [L, 3]
    p1: Tensor  # [L, 3]
    p2: Tensor  # [L, 3]
    normal: Tensor  # [L, 3]
    area: Tensor  # [L]
    intensity: Tensor  # [L, 3]
    n_samples: Tensor  # [L] int32

    @property
    def count(self) -> int:
        return self.ltype.shape[0]


@dataclasses.dataclass(frozen=True)
class Scene:
    tris: Triangles
    spheres: Spheres
    disks: Disks
    materials: Materials
    lights: Lights


def empty_triangles(device) -> Triangles:
    """0-length triangle family: intersect() skips empty families."""
    z3 = torch.zeros((0, 3), dtype=torch.float32, device=device)
    z2 = torch.zeros((0, 2), dtype=torch.float32, device=device)
    zi = torch.zeros((0,), dtype=torch.int32, device=device)
    return Triangles(v0=z3, v1=z3, v2=z3, n0=z3, n1=z3, n2=z3,
                     uv0=z2, uv1=z2, uv2=z2,
                     has_normals=torch.zeros((0,), dtype=torch.bool,
                                             device=device),
                     mat=zi, light=zi)


def empty_spheres(device) -> Spheres:
    z = torch.zeros((0, 3, 4), dtype=torch.float32, device=device)
    zi = torch.zeros((0,), dtype=torch.int32, device=device)
    return Spheres(o2w=z, w2o=z,
                   radius=torch.zeros((0,), dtype=torch.float32, device=device),
                   mat=zi, light=zi,
                   flip=torch.zeros((0,), dtype=torch.bool, device=device))


def empty_disks(device) -> Disks:
    z3 = torch.zeros((0, 3), dtype=torch.float32, device=device)
    z1 = torch.zeros((0,), dtype=torch.float32, device=device)
    zi = torch.zeros((0,), dtype=torch.int32, device=device)
    return Disks(o=z3, x=z3, y=z3, z=z3, moffset=z1,
                 inv_r2=torch.zeros((0, 2), dtype=torch.float32, device=device),
                 inner_radius=z1, phi_max=z1, mat=zi, light=zi)
