"""Monte-Carlo sampling primitives, batched and branch-free (port of
raytrace_tpu/core/sampling.py): concentric disk, cosine hemisphere, uniform
sphere, stratified 2D arrays and the permuted Halton sequence of the photon
tracer."""
from __future__ import annotations

import math

import torch
from torch import Tensor

from raytrace_tpu_torch.core import prng

INV_PI = 1.0 / math.pi
INV_TWOPI = 1.0 / (2.0 * math.pi)
INV_FOURPI = 1.0 / (4.0 * math.pi)

# Halton bases used by the reference photon tracer (photontracing.cu:15).
HALTON_BASES = (2, 3, 5, 7, 11, 13)


def concentric_sample_disk(u1: Tensor, u2: Tensor):
    """pbrt's concentric square→disk map (reference: util/util.cu.h:23-65)."""
    sx = 2.0 * u1 - 1.0
    sy = 2.0 * u2 - 1.0
    r1 = (sx >= -sy) & (sx > sy)
    r2 = (sx >= -sy) & ~(sx > sy)
    r3 = ~(sx >= -sy) & (sx <= sy)
    r = torch.where(r1, sx, torch.where(r2, sy, torch.where(r3, -sx, -sy)))
    safe_r = torch.where(r == 0.0, torch.ones_like(r), r)
    theta = torch.where(
        r1,
        torch.where(sy > 0.0, sy / safe_r, 8.0 + sy / safe_r),
        torch.where(r2, 2.0 - sx / safe_r,
                    torch.where(r3, 4.0 - sy / safe_r, 6.0 + sx / safe_r)),
    )
    theta = theta * (math.pi / 4.0)
    degenerate = (sx == 0.0) & (sy == 0.0)
    zero = torch.zeros_like(r)
    dx = torch.where(degenerate, zero, r * torch.cos(theta))
    dy = torch.where(degenerate, zero, r * torch.sin(theta))
    return dx, dy


def cosine_sample_hemisphere(u1: Tensor, u2: Tensor) -> Tensor:
    """Cosine-weighted direction in the local (+z) frame."""
    dx, dy = concentric_sample_disk(u1, u2)
    z = torch.sqrt(torch.clamp(1.0 - dx * dx - dy * dy, min=0.0))
    return torch.stack([dx, dy, z], dim=-1)


def uniform_sample_sphere(u1: Tensor, u2: Tensor) -> Tensor:
    """Uniform direction on the unit sphere (reference: cudalight.cu.h:66-74)."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_sphere_pdf() -> float:
    return INV_FOURPI


def stratified_2d(key: Tensor, nx: int, ny: int, jitter: bool = True) -> Tensor:
    """`[nx*ny, 2]` stratified samples over [0,1)² (pbrt StratifiedSample2D)."""
    dev = key.device
    ix, iy = torch.meshgrid(torch.arange(nx, device=dev),
                            torch.arange(ny, device=dev), indexing="ij")
    base = torch.stack([ix, iy], dim=-1).reshape(-1, 2).to(torch.float32)
    j = prng.uniform(key, (nx * ny, 2)) if jitter else 0.5
    inv = torch.tensor([1.0 / nx, 1.0 / ny], dtype=torch.float32, device=dev)
    return (base + j) * inv


def halton_permutations(key: Tensor, n_dims: int = 5) -> tuple[Tensor, ...]:
    """Per-base digit permutations, one `[base]` int64 tensor per dimension
    (pbrt PermutedHalton; photonmappingrenderer.cpp:200-217)."""
    perms = []
    for i in range(n_dims):
        keys = prng.split(key)
        key, sub = keys[0], keys[1]
        perms.append(prng.permutation(sub, HALTON_BASES[i]))
    return tuple(perms)


def _digits_needed(base: int, max_bits: int = 32) -> int:
    return int(math.ceil(max_bits / math.log2(base)))


def permuted_radical_inverse(n: Tensor, base: int, perm: Tensor) -> Tensor:
    """Permuted radical inverse of non-negative integer indices `n` (< 2^32)
    in `base` (reference: photontracing.cu:19-31), dropping the perm[0] tail
    exactly like the reference kernel (see the JAX module's note)."""
    inv_base = torch.tensor(1.0 / base, dtype=torch.float32)
    val = torch.zeros(n.shape, dtype=torch.float32, device=n.device)
    inv_bi = torch.full(n.shape, float(inv_base), dtype=torch.float32,
                        device=n.device)
    rem = n.to(torch.int64)
    for _ in range(_digits_needed(base)):
        digit = rem % base
        active = rem > 0
        d = perm[digit].to(torch.float32)
        val = val + torch.where(active, d * inv_bi, torch.zeros_like(val))
        inv_bi = inv_bi * inv_base
        rem = rem // base
    return val


def halton_sample_4d(n: Tensor, perms: tuple[Tensor, ...]) -> Tensor:
    """`[..., 4]` permuted-Halton points at indices n, bases (2, 3, 5, 7)
    (reference: photontracing.cu:34-43, used at :83-92)."""
    dims = [permuted_radical_inverse(n, HALTON_BASES[i], perms[i])
            for i in range(4)]
    return torch.stack(dims, dim=-1)
