"""Dense closest-hit triangle intersection — kernel K1 and its plain version
(port of raytrace_tpu/ops/pallas_intersect.py, plus `reintersect_winner`
from raytrace_tpu/ops/bvh.py).

`closest_hit` is the kernel's wrapper: on CUDA tensors it launches the
hand-written CUDA kernel (csrc/tri_intersect.cu) or raises; on CPU tensors
it runs `closest_hit_plain`, the same Möller–Trumbore arithmetic as
PyTorch ops. `intersect_triangles` keeps the contract of
`intersect_triangles_pallas`: the kernel returns the winner's (t, idx),
and the winner is re-intersected outside it with plain tensor ops for
beta, gamma and a differentiable t. `occluded_triangles`, the any-hit
query, needs the kernel's t alone.
"""
from __future__ import annotations

import ctypes

import torch

from raytrace_tpu_torch.ops import cuda_lib

BIG = 1e30
_PAIRS_PER_STEP = 1 << 22  # plain version: rays × triangles per block


def _mt(o, d, tmin, tmax, v0, v1, v2):
    """Möller–Trumbore for rays [N,3] × triangles [C,3] → t [N, C], BIG
    where the test fails; operation order as in the TPU kernel and
    csrc/tri_intersect.cu."""
    e1 = v1 - v0
    e2 = v2 - v0
    r = lambda a: a[:, None]
    c = lambda a: a[None, :]
    dx, dy, dz = r(d[:, 0]), r(d[:, 1]), r(d[:, 2])
    e1x, e1y, e1z = c(e1[:, 0]), c(e1[:, 1]), c(e1[:, 2])
    e2x, e2y, e2z = c(e2[:, 0]), c(e2[:, 1]), c(e2[:, 2])
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = torch.where(det != 0.0,
                          1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
    tvx = r(o[:, 0]) - c(v0[:, 0])
    tvy = r(o[:, 1]) - c(v0[:, 1])
    tvz = r(o[:, 2]) - c(v0[:, 2])
    beta = (tvx * px + tvy * py + tvz * pz) * inv_det
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    gamma = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = ((det != 0.0) & (beta >= 0.0) & (gamma >= 0.0)
          & (beta + gamma <= 1.0) & (t > r(tmin)) & (t < r(tmax)))
    return torch.where(ok, t, BIG)


def closest_hit_plain(o, d, tmin, tmax, v0, v1, v2):
    """Plain PyTorch version of K1 → (t, idx) per ray: the lowest triangle
    index wins among equal t; a miss gives (BIG, 0)."""
    n, n_tris = o.shape[0], v0.shape[0]
    t = torch.full((n,), BIG, dtype=torch.float32, device=o.device)
    idx = torch.zeros((n,), dtype=torch.int32, device=o.device)
    tri_step = max(1, min(n_tris, 512))
    ray_step = max(1, _PAIRS_PER_STEP // tri_step)
    for r0 in range(0, n, ray_step):
        rs = slice(r0, r0 + ray_step)
        rows = torch.arange(o[rs].shape[0], device=o.device)
        for c0 in range(0, n_tris, tri_step):
            cs = slice(c0, c0 + tri_step)
            tc = _mt(o[rs], d[rs], tmin[rs], tmax[rs], v0[cs], v1[cs],
                     v2[cs])
            j = torch.argmin(tc, dim=1)  # first index among equal t
            tj = tc[rows, j]
            better = tj < t[rs]
            t[rs] = torch.where(better, tj, t[rs])
            idx[rs] = torch.where(better, (j + c0).to(torch.int32), idx[rs])
    return t, idx


_SIGNATURES = {"tri_closest": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
               + [ctypes.c_void_p] * 3}


def closest_hit(o, d, tmin, tmax, v0, v1, v2):
    """Kernel K1: closest hit of rays o, d [N,3] within (tmin, tmax) [N]
    against triangles v0, v1, v2 [T,3] → (t, idx) [N].

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if o.device.type == "cpu":
        return closest_hit_plain(o, d, tmin, tmax, v0, v1, v2)
    n, n_tris = o.shape[0], v0.shape[0]
    f32 = torch.float32
    cuda_lib.check_inputs("closest_hit", o.device, [
        (o, f32, (n, 3)), (d, f32, (n, 3)), (tmin, f32, (n,)),
        (tmax, f32, (n,)), (v0, f32, (n_tris, 3)), (v1, f32, (n_tris, 3)),
        (v2, f32, (n_tris, 3))])
    lib = cuda_lib.load("tri_intersect", _SIGNATURES)
    t = torch.empty((n,), dtype=f32, device=o.device)
    idx = torch.empty((n,), dtype=torch.int32, device=o.device)
    p = cuda_lib.ptr
    err = lib.tri_closest(p(o), p(d), p(tmin), p(tmax), p(v0), p(v1), p(v2),
                          n, n_tris, p(t), p(idx),
                          cuda_lib.stream_ptr(o.device))
    cuda_lib.check(err, "tri_closest")
    closest_hit.launches += 1
    return t, idx


closest_hit.launches = 0


def reintersect_winner(tris, idx, o, d, found):
    """Re-intersect the winning triangle with plain tensor ops → (t, beta,
    gamma) (ops/bvh.py reintersect_winner): the kernel finds `idx`, this
    recomputes the hit from it."""
    i = idx.long()
    v0, v1, v2 = tris.v0[i], tris.v1[i], tris.v2[i]
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = torch.linalg.cross(d, e2)
    det = torch.sum(e1 * pvec, dim=-1)
    inv_det = torch.where(det != 0.0,
                          1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
    tvec = o - v0
    beta = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = torch.linalg.cross(tvec, e1)
    gamma = torch.sum(d * qvec, dim=-1) * inv_det
    t = torch.sum(e2 * qvec, dim=-1) * inv_det
    zero = torch.zeros_like(t)
    return (torch.where(found, t, BIG), torch.where(found, beta, zero),
            torch.where(found, gamma, zero))


def _closest(tris, o, d, tmin, tmax):
    """K1 on the scene's triangles → (t, idx) of the kernel's contract."""
    c = lambda x: x.contiguous()
    return closest_hit(c(o), c(d), c(tmin), c(tmax), c(tris.v0), c(tris.v1),
                       c(tris.v2))


def intersect_triangles(tris, o, d, tmin, tmax):
    """Closest triangle hit through K1 → (t, idx, beta, gamma), the contract
    of intersect_triangles_pallas: idx clipped to the table, (t, beta,
    gamma) re-intersected from the winner, t = BIG on a miss."""
    t_k, idx = _closest(tris, o, d, tmin, tmax)
    idx = torch.clamp(idx, 0, tris.v0.shape[0] - 1)
    found = t_k < torch.clamp(tmax, max=BIG)
    t, beta, gamma = reintersect_winner(tris, idx, o, d, found)
    return t, idx, beta, gamma


def occluded_triangles(tris, o, d, tmin, tmax):
    """Any triangle hit within (tmin, tmax) through K1 → occluded [N]: the
    kernel's t of a hit, with no re-intersection. JAX's any-hit on this
    route is `found & (t_reint < BIG)`, and a found ray's re-intersected t
    is finite."""
    t_k, _ = _closest(tris, o, d, tmin, tmax)
    return t_k < torch.clamp(tmax, max=BIG)
