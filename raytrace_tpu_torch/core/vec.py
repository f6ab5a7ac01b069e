"""Batched 3-vector math on `[..., 3]` tensors (port of
raytrace_tpu/core/vec.py). Every op is elementwise over stacked tensors, in
the same order of operations as the JAX module."""
from __future__ import annotations

import torch
from torch import Tensor


def take_rows(table: Tensor, idx: Tensor) -> Tensor:
    """table[idx] for a small parameter table [M, C] and many indices. A
    table that requires grad is read through a one-hot product, exact in
    float32 (one term is nonzero), whose backward is one matrix product:
    autograd's backward of `table[idx]` is a scatter that serialises on the
    duplicates of each of the M rows, which on the card took ~0.1 s per
    lookup of a 2^20-row index."""
    if not table.requires_grad:
        return table[idx]
    onehot = torch.nn.functional.one_hot(idx.long(), table.shape[0])
    return onehot.to(table.dtype) @ table


def dot(a: Tensor, b: Tensor) -> Tensor:
    """Batched dot product over the trailing axis."""
    return torch.sum(a * b, dim=-1)


def absdot(a: Tensor, b: Tensor) -> Tensor:
    """|a·b| (reference: util/util.cu.h:14-16 AbsDot)."""
    return torch.abs(dot(a, b))


def cross(a: Tensor, b: Tensor) -> Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def length_squared(v: Tensor) -> Tensor:
    return dot(v, v)


def length(v: Tensor) -> Tensor:
    return torch.sqrt(length_squared(v))


def distance_squared(p1: Tensor, p2: Tensor) -> Tensor:
    return length_squared(p2 - p1)


def normalize(v: Tensor, eps: float = 1e-20) -> Tensor:
    """Normalize over the trailing axis; zero vectors stay finite."""
    return v * torch.reciprocal(torch.sqrt(length_squared(v) + eps))[..., None]


def faceforward(n: Tensor, v: Tensor) -> Tensor:
    """Flip n so it lies in the same hemisphere as v."""
    return torch.where((dot(n, v) < 0.0)[..., None], -n, n)


def world_to_local(v: Tensor, nn: Tensor, sn: Tensor, tn: Tensor) -> Tensor:
    """World → shading frame (reference: cudamaterial.cu.h:57-60)."""
    return torch.stack([dot(v, sn), dot(v, tn), dot(v, nn)], dim=-1)


def local_to_world(v: Tensor, nn: Tensor, sn: Tensor, tn: Tensor) -> Tensor:
    """Shading frame → world (reference: cudamaterial.cu.h:61-66)."""
    return sn * v[..., 0:1] + tn * v[..., 1:2] + nn * v[..., 2:3]


def shading_frame(ns: Tensor, dpdu: Tensor):
    """(nn, sn, tn) = (normalize(ns), normalize(dpdu), nn × sn)
    (reference: cudamaterial.cu.h:85-88)."""
    nn = normalize(ns)
    sn = normalize(dpdu)
    return nn, sn, cross(nn, sn)


def coordinate_system(v1: Tensor):
    """Arbitrary orthonormal basis around unit v1 (pbrt-style)."""
    x, y, z = v1[..., 0], v1[..., 1], v1[..., 2]
    use_x = torch.abs(x) > torch.abs(y)
    inv_len_a = torch.reciprocal(torch.sqrt(x * x + z * z + 1e-20))
    a = torch.stack([-z * inv_len_a, torch.zeros_like(x), x * inv_len_a], -1)
    inv_len_b = torch.reciprocal(torch.sqrt(y * y + z * z + 1e-20))
    b = torch.stack([torch.zeros_like(x), z * inv_len_b, -y * inv_len_b], -1)
    v2 = torch.where(use_x[..., None], a, b)
    return v2, cross(v1, v2)


def transform_point(m: Tensor, p: Tensor) -> Tensor:
    """Apply `[..., 3, 4]` affine rows to `[..., 3]` points."""
    return torch.einsum("...ij,...j->...i", m[..., :3, :3], p) + m[..., :3, 3]


def transform_vector(m: Tensor, v: Tensor) -> Tensor:
    """Apply the linear part of a `[..., 3, 4]` affine transform."""
    return torch.einsum("...ij,...j->...i", m[..., :3, :3], v)


def transform_normal(m_inv: Tensor, n: Tensor) -> Tensor:
    """Normals map by (w2o)^T given w2o = inverse of o2w."""
    return torch.einsum("...ji,...j->...i", m_inv[..., :3, :3], n)
