"""Wavefront ray–scene intersection (port of raytrace_tpu/ops/intersect.py).

Each shape family is intersected as a dense batched pass; hit attributes
are computed only for each family's winner, and the families combine with
the first family winning ties. Triangles take the first route that
applies, as in JAX (`_closest_triangles`):
  - a scene with a cluster set (≥ 512 triangles): on coherent (camera and
    shadow) launches the cluster engine (ops/cluster_intersect.py, kernels
    K6 and K7), on the others the epoch engine (ops/epoch_intersect.py, K8
    and K9), as JAX's `_engine` routes them; the winner is re-intersected
    with differentiable tensor ops;
  - a scene with a BVH and no cluster set: the skip-link traversal
    (ops/bvh.py);
  - otherwise the dense closest hit, kernel K1 (ops/tri_intersect.py).
Spheres and disks are plain tensor math, unrolled per primitive for ≤ 8
primitives and batched [N, C] beyond. Closest-hit and any-hit mirror the
reference's RayTracing and Shadow ray types.

The epoch engine has pair and subpair budgets (`intersect_budget_scale`),
the cluster engine a pair capacity (`intersect_rounds`); what a launch
drops past them comes back as `pair_overflow`, a device tensor the
renderers add up and warn on once per frame (0 means the launch was
exact).
"""
from __future__ import annotations

import dataclasses
import math
import os
import warnings

import torch
from torch import Tensor

from raytrace_tpu_torch.core import vec
from raytrace_tpu_torch.ops import bvh as bvh_ops
from raytrace_tpu_torch.ops import cluster_intersect
from raytrace_tpu_torch.ops import epoch_intersect
from raytrace_tpu_torch.ops import tri_intersect
from raytrace_tpu_torch.scene.scene import Scene

BIG = 1e30


@dataclasses.dataclass(frozen=True)
class Intersection:
    """Full hit frame (reference attributes, util/shape/cudashape.cu.h:7-11)."""
    valid: Tensor  # [N] bool
    t: Tensor  # [N]
    p: Tensor  # [N, 3]
    ng: Tensor  # [N, 3] geometric normal (normalized)
    ns: Tensor  # [N, 3] shading normal (normalized)
    dpdu: Tensor  # [N, 3]
    dpdv: Tensor  # [N, 3]
    uv: Tensor  # [N, 2]
    mat: Tensor  # [N] int32
    light: Tensor  # [N] int32
    # pairs and subpairs the engine dropped past its budgets in this
    # launch: a device tensor on cluster scenes, the int 0 on the others
    pair_overflow: Tensor | int = 0


def _safe_div(x: Tensor, y: Tensor) -> Tensor:
    return torch.where(y != 0.0, x / torch.where(y == 0.0, 1.0, y), BIG)


def _first_min(t_cols: Tensor):
    """Closest column per row and its index (first index among ties)."""
    i = torch.argmin(t_cols, dim=1)
    rows = torch.arange(t_cols.shape[0], device=t_cols.device)
    return t_cols[rows, i], i.to(torch.int32)


def _first_min_unrolled(count: int, hit_one, n: int, device):
    """_first_min over primitives tested one at a time (hit_one(c) → t [N]):
    the form for ≤ 8 primitives, pure [N]-vector math."""
    best_t = torch.full((n,), BIG, device=device)
    best_i = torch.zeros((n,), dtype=torch.int32, device=device)
    for c in range(count):
        t = hit_one(c)
        best_i = torch.where(t < best_t, c, best_i)
        best_t = torch.minimum(best_t, t)
    return best_t, best_i


# ---------------------------------------------------------------------------
# Triangles
# ---------------------------------------------------------------------------

def triangle_attributes(scene: Scene, idx, beta, gamma, o, d, t):
    """Hit frame for winning triangles (reference: cudatrianglemesh.cu:26-77)."""
    tris = scene.tris
    i = idx.long()
    v0, v1, v2 = tris.v0[i], tris.v1[i], tris.v2[i]
    uv0, uv1, uv2 = tris.uv0[i], tris.uv1[i], tris.uv2[i]
    ng = vec.normalize(vec.cross(v1 - v0, v2 - v0))

    du1 = uv0[:, 0] - uv2[:, 0]
    du2 = uv1[:, 0] - uv2[:, 0]
    dv1 = uv0[:, 1] - uv2[:, 1]
    dv2 = uv1[:, 1] - uv2[:, 1]
    dp1 = v0 - v2
    dp2 = v1 - v2
    det = du1 * dv2 - dv1 * du2
    inv_det = torch.where(det != 0.0, 1.0 / det, 0.0)[:, None]
    dpdu = (dv2[:, None] * dp1 - dv1[:, None] * dp2) * inv_det
    dpdv = (-du2[:, None] * dp1 + du1[:, None] * dp2) * inv_det
    # degenerate-UV fallback (reference: cudatrianglemesh.cu:50-60)
    fb_u, fb_v = vec.coordinate_system(ng)
    degen = (det == 0.0)[:, None]
    dpdu = torch.where(degen, fb_u, dpdu)
    dpdv = torch.where(degen, fb_v, dpdv)

    b1 = beta[:, None]
    b2 = gamma[:, None]
    b0 = 1.0 - b1 - b2
    uv = b0 * uv0 + b1 * uv1 + b2 * uv2
    ns_interp = vec.normalize(b1 * tris.n1[i] + b2 * tris.n2[i]
                              + b0 * tris.n0[i])
    ns = torch.where(tris.has_normals[i][:, None], ns_interp, ng)
    p = o + d * t[:, None]
    return p, ng, ns, dpdu, dpdv, uv, tris.mat[i], tris.light[i]


# ---------------------------------------------------------------------------
# Spheres (object-space quadratic; reference: cudasphere.cu:7-72)
# ---------------------------------------------------------------------------

def _sphere_roots(a, b, c, radius, tmin, tmax):
    disc = b * b - 4.0 * a * c
    ok = (disc >= 0.0) & (radius > 0.0)  # radius 0 = padding
    root = torch.sqrt(torch.clamp(disc, min=0.0))
    q = torch.where(b < 0.0, -0.5 * (b - root), -0.5 * (b + root))
    t0 = _safe_div(q, a)
    t1 = _safe_div(c, q)
    tlo = torch.minimum(t0, t1)
    thi = torch.maximum(t0, t1)
    in_range = lambda t: ok & (t > tmin) & (t < tmax)
    return torch.where(in_range(tlo), tlo,
                       torch.where(in_range(thi), thi, BIG))


def _sphere_hit_one(o, d, w2o_c, radius_c, tmin, tmax):
    """One sphere vs rays [N,3] → t [N]."""
    R = w2o_c[:3, :3]
    oo = o @ R.T + w2o_c[:3, 3]
    od = d @ R.T
    a = torch.sum(od * od, dim=-1)
    b = 2.0 * torch.sum(od * oo, dim=-1)
    c = torch.sum(oo * oo, dim=-1) - radius_c * radius_c
    return _sphere_roots(a, b, c, radius_c, tmin, tmax)


def _sphere_hit_batch(o, d, w2o, radius, tmin, tmax):
    """Rays [N,3] vs spheres [C] → t [N, C]."""
    oo = torch.einsum("cij,nj->nci", w2o[:, :3, :3], o) + w2o[None, :, :3, 3]
    od = torch.einsum("cij,nj->nci", w2o[:, :3, :3], d)
    a = vec.dot(od, od)
    b = 2.0 * vec.dot(od, oo)
    c = vec.dot(oo, oo) - (radius * radius)[None, :]
    return _sphere_roots(a, b, c, radius[None, :], tmin[:, None],
                         tmax[:, None])


def intersect_spheres(scene: Scene, o, d, tmin, tmax):
    """Closest sphere → (t [N], idx [N] int32)."""
    sph = scene.spheres
    if sph.count <= 8:
        return _first_min_unrolled(
            sph.count, lambda c: _sphere_hit_one(o, d, sph.w2o[c],
                                                 sph.radius[c], tmin, tmax),
            o.shape[0], o.device)
    return _first_min(_sphere_hit_batch(o, d, sph.w2o, sph.radius, tmin,
                                        tmax))


def sphere_attributes(scene: Scene, idx, o, d, t):
    """Hit frame for winning spheres (reference: cudasphere.cu:33-72)."""
    sph = scene.spheres
    i = idx.long()
    w2o, o2w, radius = sph.w2o[i], sph.o2w[i], sph.radius[i]
    oo = vec.transform_point(w2o, o)
    od = vec.transform_vector(w2o, d)
    phit = oo + od * t[:, None]
    # avoid the pole singularity like the reference (cudasphere.cu:36)
    degen = (phit[:, 0] == 0.0) & (phit[:, 1] == 0.0)
    phit = torch.cat([torch.where(degen, 1e-5 * radius, phit[:, 0])[:, None],
                      phit[:, 1:]], dim=1)
    phi = torch.atan2(phit[:, 1], phit[:, 0])
    phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
    u = phi / (2.0 * math.pi)
    r_safe = torch.clamp(radius, min=1e-20)
    theta = torch.arccos(torch.clamp(phit[:, 2] / r_safe, -1.0, 1.0))
    v = theta / math.pi
    n_obj = phit / r_safe[:, None]
    dpdu_obj = torch.stack([-n_obj[:, 1], n_obj[:, 0], torch.zeros_like(u)],
                           dim=-1)
    dpdv_obj = vec.cross(n_obj, dpdu_obj)
    ng = vec.normalize(vec.transform_normal(w2o, n_obj))
    if sph.flip is not None:
        ng = torch.where(sph.flip[i][:, None], -ng, ng)
    dpdu = vec.transform_vector(o2w, dpdu_obj)
    dpdv = vec.transform_vector(o2w, dpdv_obj)
    p = o + d * t[:, None]
    uv = torch.stack([u, v], dim=-1)
    return p, ng, ng, dpdu, dpdv, uv, sph.mat[i], sph.light[i]


# ---------------------------------------------------------------------------
# Disks (world-frame plane test; reference: cudadisk.cu:18-50)
# ---------------------------------------------------------------------------

def _disk_ok(thit, lx, ly, inner, phi_max, tmin, tmax):
    dist2 = lx * lx + ly * ly
    phi = torch.atan2(ly, lx)
    phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
    ok = ((thit > tmin) & (thit < tmax) & (dist2 <= 1.0)
          & (dist2 >= inner * inner) & (phi <= phi_max))
    return torch.where(ok, thit, BIG)


def _disk_hit_one(dk, c, o, d, tmin, tmax):
    """One disk vs rays [N,3] → t [N]."""
    zdotd = d @ dk.z[c]
    zdoto = o @ dk.z[c]
    thit = (dk.moffset[c] - zdoto) / torch.where(zdotd == 0.0, 1e-20, zdotd)
    local = o + thit[:, None] * d - dk.o[c]
    lx = (local @ dk.x[c]) * dk.inv_r2[c, 0]
    ly = (local @ dk.y[c]) * dk.inv_r2[c, 1]
    return _disk_ok(thit, lx, ly, dk.inner_radius[c], dk.phi_max[c], tmin,
                    tmax)


def _disk_hit_batch(dk, o, d, tmin, tmax):
    """Rays [N,3] vs disks [D] → t [N, D]."""
    zdotd = torch.einsum("nj,dj->nd", d, dk.z)
    zdoto = torch.einsum("nj,dj->nd", o, dk.z)
    thit = (dk.moffset[None, :] - zdoto) / torch.where(zdotd == 0.0, 1e-20,
                                                       zdotd)
    local = o[:, None, :] + thit[..., None] * d[:, None, :] - dk.o[None]
    lx = vec.dot(local, dk.x[None]) * dk.inv_r2[None, :, 0]
    ly = vec.dot(local, dk.y[None]) * dk.inv_r2[None, :, 1]
    return _disk_ok(thit, lx, ly, dk.inner_radius[None, :],
                    dk.phi_max[None, :], tmin[:, None], tmax[:, None])


def intersect_disks(scene: Scene, o, d, tmin, tmax):
    """Closest disk → (t [N], idx [N] int32)."""
    dk = scene.disks
    if dk.count <= 8:
        return _first_min_unrolled(
            dk.count, lambda c: _disk_hit_one(dk, c, o, d, tmin, tmax),
            o.shape[0], o.device)
    return _first_min(_disk_hit_batch(dk, o, d, tmin, tmax))


def disk_attributes(scene: Scene, idx, o, d, t):
    """(reference: cudadisk.cu:33-50)"""
    dk = scene.disks
    i = idx.long()
    phit = o + d * t[:, None]
    local = phit - dk.o[i]
    lx = vec.dot(local, dk.x[i]) * dk.inv_r2[i][:, 0]
    ly = vec.dot(local, dk.y[i]) * dk.inv_r2[i][:, 1]
    dist2 = lx * lx + ly * ly
    phi = torch.atan2(ly, lx)
    phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
    inner = dk.inner_radius[i]
    one_minus_v = ((torch.sqrt(torch.clamp(dist2, min=0.0)) - inner)
                   / torch.clamp(1.0 - inner, min=1e-20))
    uv = torch.stack([phi / torch.clamp(dk.phi_max[i], min=1e-20),
                      1.0 - one_minus_v], -1)
    ng = dk.z[i]
    dpdu = -ly[:, None] * dk.x[i] + lx[:, None] * dk.y[i]
    dpdv = -lx[:, None] * dk.x[i] - ly[:, None] * dk.y[i]
    return phit, ng, ng, dpdu, dpdv, uv, dk.mat[i], dk.light[i]


# ---------------------------------------------------------------------------
# Triangle dispatch
# ---------------------------------------------------------------------------

def _engine(coherent: bool) -> str:
    """Cluster-scene engine (JAX `_engine`): coherent camera and shadow
    launches take the cluster engine (ops/cluster_intersect.py, kernels K6
    and K7), the rest the epoch engine (ops/epoch_intersect.py, K8 and K9),
    which is exact for any ray mix. JAX measured the cluster engine ~15%
    faster on coherent launches on a TPU; PERF.md has the card's numbers.
    RAYTRACE_TPU_ENGINE=epoch|cluster forces either."""
    forced = os.environ.get("RAYTRACE_TPU_ENGINE")
    if forced:
        if forced not in ("epoch", "cluster"):
            raise ValueError(f"RAYTRACE_TPU_ENGINE={forced!r}: must be "
                             "'epoch' or 'cluster'")
        return forced
    return "cluster" if coherent else "epoch"


def _cluster_rounds(scene: Scene, rounds: int) -> int:
    """The cluster engine's rounds of 2^17 pairs, scaled with the cluster
    count (JAX `_cluster_rounds`): at least one round per 2,048 clusters."""
    cp = scene.clusters.cmin.shape[0]
    return max(rounds, -(-cp // 2048))


def _cluster_hits(scene: Scene, o, d, tmin, tmax, coherent: bool,
                  budget_scale: float, rounds: int):
    """→ (t, idx, overflow) through the engine `_engine` picks."""
    if _engine(coherent) == "epoch":
        t, idx, _, overflow = epoch_intersect.intersect_epochs(
            scene.clusters, o, d, tmin, tmax, budget_scale=budget_scale)
    else:
        t, idx, _, overflow = cluster_intersect.intersect_clusters(
            scene.clusters, o, d, tmin, tmax,
            rounds=_cluster_rounds(scene, rounds))
    return t, idx, overflow


def _closest_triangles(scene: Scene, o, d, tmin, tmax, coherent: bool,
                       budget_scale: float, rounds: int = 1):
    """→ (t, idx, beta, gamma, pair_overflow) through the scene's route."""
    if scene.clusters is not None:
        t, idx, overflow = _cluster_hits(scene, o, d, tmin, tmax, coherent,
                                         budget_scale, rounds)
        found = t < torch.clamp(tmax, max=BIG)
        t_diff, beta, gamma = bvh_ops.reintersect_winner(scene.tris, idx, o,
                                                         d, found)
        return t_diff, idx, beta, gamma, overflow
    if scene.bvh is not None:
        return bvh_ops.intersect_triangles_bvh(
            scene.bvh, scene.tris, o, d, tmin, tmax) + (0,)
    return tri_intersect.intersect_triangles(scene.tris, o, d, tmin,
                                             tmax) + (0,)


def _occluded_triangles(scene: Scene, o, d, tmin, tmax, coherent: bool,
                        budget_scale: float, rounds: int = 1):
    """Any triangle hit within (tmin, tmax) → (occluded [N], overflow)."""
    if scene.clusters is not None:
        t, _, overflow = _cluster_hits(scene, o, d, tmin, tmax, coherent,
                                       budget_scale, rounds)
        return t < torch.clamp(tmax, max=BIG), overflow
    if scene.bvh is not None:
        return bvh_ops.occluded_triangles_bvh(scene.bvh, scene.tris, o, d,
                                              tmin, tmax), 0
    return tri_intersect.occluded_triangles(scene.tris, o, d, tmin,
                                            tmax), 0


# ---------------------------------------------------------------------------
# Combined closest-hit / any-hit
# ---------------------------------------------------------------------------

def intersect(scene: Scene, o, d, tmin, tmax, coherent: bool = False,
              budget_scale: float = 1.0, rounds: int = 1) -> Intersection:
    """Closest hit across all shape families; empty families are skipped.
    `coherent` marks camera and shadow launches, which take the cluster
    engine on a cluster scene (see `_engine`); `budget_scale` multiplies the
    epoch engine's budgets and `rounds` buys the cluster engine pair
    capacity."""
    n = o.shape[0]
    ovf = 0
    cands = []  # (t [N], attrs thunk) per non-empty family
    if scene.tris.count:
        t_tri, i_tri, beta, gamma, ovf = _closest_triangles(
            scene, o, d, tmin, tmax, coherent, budget_scale, rounds)
        cands.append((t_tri, lambda: triangle_attributes(
            scene, i_tri, beta, gamma, o, d, t_tri)))
    if scene.spheres.count:
        t_sph, i_sph = intersect_spheres(scene, o, d, tmin, tmax)
        cands.append((t_sph, lambda: sphere_attributes(
            scene, i_sph, o, d, t_sph)))
    if scene.disks.count:
        t_dsk, i_dsk = intersect_disks(scene, o, d, tmin, tmax)
        cands.append((t_dsk, lambda: disk_attributes(
            scene, i_dsk, o, d, t_dsk)))

    if not cands:  # no geometry at all: every ray misses
        z3 = torch.zeros((n, 3), dtype=torch.float32, device=o.device)
        no = torch.full((n,), -1, dtype=torch.int32, device=o.device)
        return Intersection(
            valid=torch.zeros((n,), dtype=torch.bool, device=o.device),
            t=torch.full((n,), BIG, device=o.device), p=z3, ng=z3, ns=z3,
            dpdu=z3, dpdv=z3,
            uv=torch.zeros((n, 2), dtype=torch.float32, device=o.device),
            mat=no, light=no, pair_overflow=ovf)

    ts = [c[0] for c in cands]
    attrs = [c[1]() for c in cands]
    t = ts[0]
    for tf in ts[1:]:
        t = torch.minimum(t, tf)
    valid = t < BIG
    # family select, the first family winning ties
    wins = [tf <= t for tf in ts[:-1]]

    def pick(k):
        out = attrs[-1][k]
        for f in range(len(cands) - 2, -1, -1):
            a = attrs[f][k]
            m = wins[f][:, None] if a.ndim == 2 else wins[f]
            out = torch.where(m, a, out)
        return out

    p, ng, ns, dpdu, dpdv, uv, mat, light = (pick(k) for k in range(8))
    return Intersection(
        valid=valid, t=torch.where(valid, t, BIG), p=p, ng=ng, ns=ns,
        dpdu=dpdu, dpdv=dpdv, uv=uv,
        mat=torch.where(valid, mat, -1), light=torch.where(valid, light, -1),
        pair_overflow=ovf)


def occluded_aux(scene: Scene, o, d, tmin, tmax, coherent: bool = False,
                 budget_scale: float = 1.0, rounds: int = 1):
    """Any hit within (tmin, tmax) — the shadow ray type (reference:
    raytracing.cu:143-147) → (occluded [N] bool, pair_overflow)."""
    occ = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    ovf = 0
    if scene.tris.count:
        hit_tri, ovf = _occluded_triangles(scene, o, d, tmin, tmax, coherent,
                                           budget_scale, rounds)
        occ = occ | hit_tri
    if scene.spheres.count:
        occ = occ | (intersect_spheres(scene, o, d, tmin, tmax)[0] < BIG)
    if scene.disks.count:
        occ = occ | (intersect_disks(scene, o, d, tmin, tmax)[0] < BIG)
    return occ, ovf


def occluded(scene: Scene, o, d, tmin, tmax, coherent: bool = False,
             rounds: int = 1) -> Tensor:
    """occluded_aux without the overflow count → occluded [N] bool."""
    return occluded_aux(scene, o, d, tmin, tmax, coherent, rounds=rounds)[0]


def warn_pair_overflow(overflow, what: str) -> None:
    """One RuntimeWarning when an accumulated pair_overflow is nonzero (a
    single device read: call it once per frame, not per launch)."""
    count = int(overflow)
    if count > 0:
        warnings.warn(f"{what}: pair budget overflow by {count} pairs — "
                      "intersections were dropped; raise "
                      "intersect_budget_scale (epoch engine) or "
                      "intersect_rounds (cluster engine)", RuntimeWarning)
