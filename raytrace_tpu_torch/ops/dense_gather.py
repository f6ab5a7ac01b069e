"""Dense small-map photon gather — kernel K4, its plain version, and the
valid-prefix compaction (port of raytrace_tpu/ops/pallas_gather.py:
`gather_radius_pallas`, its `_kernel`, and `compact_photons`).

The renderer takes this route for forward waves of fewer than 2^14 photon
slots (renderers/photon.py `gathering_pass`): the photons are compacted to a
valid prefix, and every query is tested against every photon of that prefix
— exact, with no job budget, in O(queries × valid photons).

`dense_S` is the kernel's wrapper: CUDA tensors launch csrc/dense_gather.cu
(one thread per query, the valid prefix staged through shared memory, each
warp's photons pre-culled against its queries' box) or raise; CPU tensors
take `dense_S_plain`. Both form every term as the TPU kernel does, element
by element, `|n_s·wi|·α` per channel, and differ only in the order of the
sums. kd/π multiplies once, outside, on the sums (the TPU kernel
multiplied each chunk's partial sum). `precull_plain` is the kernel's
pre-cull as a predicate: the photons each warp keeps.
"""
from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from raytrace_tpu_torch.ops import cuda_lib
from raytrace_tpu_torch.ops.photon_grid import PhotonMap
from raytrace_tpu_torch.utils import metrics

_PAIRS_PER_STEP = 1 << 22  # plain version: queries × photons per batch
# queries that share one pre-cull box: a warp of the kernel, 32
# consecutive queries (csrc/dense_gather.cu)
GROUP = 32


def compact_photons(photons: PhotonMap):
    """Sort a PhotonMap so that its valid photons form a prefix → (p, alpha,
    wi, valid, n_valid [] int32). The stable sort keeps deposition order
    within each class, as JAX's does, so both packages give the same
    order."""
    order = torch.argsort((~photons.valid).to(torch.int32), stable=True)
    return (photons.p[order], photons.alpha[order], photons.wi[order],
            photons.valid[order], photons.valid.sum().to(torch.int32))


def group_box(q, r2) -> tuple[Tensor, Tensor, Tensor]:
    """The pre-cull box of each group of queries, q [..., GROUP, 3] and r2
    [..., GROUP] → (lo, hi [..., 3], r2max [...]), as K4's and K5's warps
    take it: the box spans the group's queries with r2 > 0, NaN coordinates
    ignored, and r2max is their largest r2 (0 for none). A query with a
    NaN position or r2, or r2 ≤ 0, never counts a photon (dist2 < r2 is
    false)."""
    live = r2 > 0.0
    use = live[..., None] & ~torch.isnan(q)
    lo = torch.where(use, q, float("inf")).amin(-2)
    hi = torch.where(use, q, float("-inf")).amax(-2)
    return lo, hi, torch.where(live, r2, 0.0).amax(-1)


def gap2(plo, phi, lo, hi) -> Tensor:
    """G = (gx² + gy²) + gz² between the boxes [plo, phi] and [lo, hi]
    (a point p is the box [p, p]), [..., 3] → [...]. Per axis the gap
    g = lo − phi where phi < lo, plo − hi where plo > hi, else 0, each
    rounded as dist2 is. Rounding is monotone, so dist2 ≥ G for every
    query in [lo, hi] and every photon in [plo, phi]; a NaN coordinate
    gives a gap of 0 on its axis."""
    g = torch.where(phi < lo, lo - phi, torch.where(plo > hi, plo - hi, 0.0))
    gg = g * g
    return gg[..., 0] + gg[..., 1] + gg[..., 2]


def precull_plain(q_p, radius2, photons_p, photons_valid,
                  n_valid) -> Tensor:
    """K4's pre-cull → keep [ceil(N / GROUP), n_valid] bool: the photons of
    the valid prefix that each group of GROUP consecutive queries tests.

    Per photon G to the group's box (`group_box`, `gap2`): a photon with
    G ≥ r2max, or an invalid one, counts for no query of the group and is
    dropped; a NaN G is kept."""
    n, nv = q_p.shape[0], int(n_valid)
    pad = -n % GROUP
    q = torch.nn.functional.pad(q_p, (0, 0, 0, pad)).view(-1, GROUP, 3)
    r2 = torch.nn.functional.pad(radius2, (0, pad)).view(-1, GROUP)
    lo, hi, r2max = group_box(q, r2)
    p = photons_p[:nv][None]  # [1, nv, 3]
    big = gap2(p, p, lo[:, None, :], hi[:, None, :])
    return ~(big >= r2max[:, None]) & photons_valid[None, :nv]


def dense_S_plain(q_p, radius2, q_ns, photons_p, photons_alpha, photons_wi,
                  photons_valid, n_valid) -> Tensor:
    """Plain PyTorch version of K4 → [4, N]: rows 0-2 the weighted flux
    S = Σ_{dist² < r², valid} |n_s·wi|·α over the photons [0, n_valid), row
    3 the count M."""
    n = q_p.shape[0]
    nv = int(n_valid)
    out = torch.zeros((4, n), dtype=torch.float32, device=q_p.device)
    step = max(1, _PAIRS_PER_STEP // max(1, n))
    r = lambda a: a[:, None]  # [N] → [N, 1]
    for c0 in range(0, nv, step):
        cs = slice(c0, min(nv, c0 + step))
        pp, pa, pw = (x[cs].T[:, None, :]  # [3, 1, chunk]
                      for x in (photons_p, photons_alpha, photons_wi))
        dx = r(q_p[:, 0]) - pp[0]
        dy = r(q_p[:, 1]) - pp[1]
        dz = r(q_p[:, 2]) - pp[2]
        dist2 = dx * dx + dy * dy + dz * dz
        ok = (dist2 < r(radius2)) & photons_valid[None, cs]
        w = torch.abs(r(q_ns[:, 0]) * pw[0] + r(q_ns[:, 1]) * pw[1]
                      + r(q_ns[:, 2]) * pw[2])
        wm = torch.where(ok, w, 0.0)
        out += torch.stack([torch.sum(wm * pa[0], dim=1),
                            torch.sum(wm * pa[1], dim=1),
                            torch.sum(wm * pa[2], dim=1),
                            torch.sum(ok, dim=1, dtype=torch.float32)])
    return out


_SIGNATURES = {"dense_gather": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
               + [ctypes.c_void_p] * 3}


def dense_S(q_p, radius2, q_ns, photons_p, photons_alpha, photons_wi,
            photons_valid, n_valid) -> Tensor:
    """Kernel K4 → [4, N] (see dense_S_plain).

    q_p/q_ns [N, 3], radius2 [N] f32; photons p/alpha/wi [P, 3] f32 and
    valid [P] bool, compacted to a valid prefix; n_valid [] int32 on the
    same device, read by the kernel (no host sync). CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if q_p.device.type == "cpu":
        return dense_S_plain(q_p, radius2, q_ns, photons_p, photons_alpha,
                             photons_wi, photons_valid, n_valid)
    n, p = q_p.shape[0], photons_p.shape[0]
    cuda_lib.check_inputs("dense_S", q_p.device, [
        (q_p, torch.float32, (n, 3)), (radius2, torch.float32, (n,)),
        (q_ns, torch.float32, (n, 3)), (photons_p, torch.float32, (p, 3)),
        (photons_alpha, torch.float32, (p, 3)),
        (photons_wi, torch.float32, (p, 3)),
        (photons_valid, torch.bool, (p,)), (n_valid, torch.int32, ())])
    lib = cuda_lib.load("dense_gather", _SIGNATURES)
    out = torch.empty((4, n), dtype=torch.float32, device=q_p.device)
    ptr = cuda_lib.ptr
    err = lib.dense_gather(ptr(q_p), ptr(radius2), ptr(q_ns), ptr(photons_p),
                           ptr(photons_alpha), ptr(photons_wi),
                           ptr(photons_valid), n, p, ptr(n_valid), ptr(out),
                           cuda_lib.stream_ptr(q_p.device))
    cuda_lib.check(err, "dense_gather")
    dense_S.launches += 1
    return out


dense_S.launches = 0


def gather_radius_dense_tiles(photons_p, photons_alpha, photons_wi,
                              photons_valid, n_valid, q_p, radius2, q_ns,
                              q_kd_over_pi):
    """Exact radius search + photon shading over a validity-compacted photon
    map (valid prefix, n_valid of them) → (L [N, 3], M [N] int32), the
    contract of JAX `gather_radius_pallas`. radius2 = 0 disables a query.
    Forward only: every input is read detached."""
    c = lambda x: x.detach().contiguous()
    with metrics.span("rt.gather.kernel"):
        out = dense_S(c(q_p), c(radius2), c(q_ns), c(photons_p),
                      c(photons_alpha), c(photons_wi), c(photons_valid),
                      c(n_valid))
    return q_kd_over_pi * out[:3].T, out[3].to(torch.int32)
