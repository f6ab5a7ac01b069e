"""Shared render passes: the camera pass with specular chains, and direct
lighting with shadow rays (port of raytrace_tpu/renderers/common.py), plus
the record-and-replay helpers that make the camera pass and the photon walk
differentiable in kd and the light intensities.

The JAX camera pass has two forms, chosen by `compact_queue_size`: a
full-batch loop that re-intersects every lane each bounce (dead lanes get
an empty t-window), and a compacted one that runs bounce 0 full-width and
then only the specular survivors. Each lane's outcome is a pure function of
its own state, so both forms give the same records; the port keeps the
choice and, being eager, compacts to the exact live set each bounce.

Record and replay (JAX `camera_pass` and `trace_photons` with
config.differentiable): hit geometry takes no gradient, so the only
differentiable content of a record is a product of parameter rows. The
walks run in their fast form under `torch.no_grad()`, recording the chain
of material ids whose factor contains kd, and `replay` rebuilds the value
with the gradient of value·N/sg(N), N = Π kd[m_j] (⊙ Le[light] for a
photon). The walks never run with differentiable=True, so JAX's
fixed-trip `bounded_loop` branch (and with it `remat_walks`) has nothing to
do in a render; the port accepts `remat_walks` and ignores it, as JAX's
render path does.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import Tensor

from raytrace_tpu_torch.core import vec
from raytrace_tpu_torch.core.config import RenderConfig
from raytrace_tpu_torch.core.samples import SampleLayout
from raytrace_tpu_torch.ops import intersect as isect_ops
from raytrace_tpu_torch.scene.scene import Scene
from raytrace_tpu_torch.shading import light as light_ops
from raytrace_tpu_torch.shading import material as mat_ops

BIG = isect_ops.BIG


@dataclasses.dataclass(frozen=True)
class CameraRecords:
    """Per-pixel-sample hit records (reference: RayTracingRecord,
    photonmapping.h:7-24). status: 0 diffuse hit, 1 miss, 2 specular chain
    past the cap. atten is the specular-chain throughput; footprint the
    pixel footprint radius at the first hit (0 without differentials)."""
    status: Tensor  # [N] int32
    p: Tensor  # [N, 3]
    ns: Tensor  # [N, 3]
    ng: Tensor  # [N, 3]
    dpdu: Tensor  # [N, 3]
    dpdv: Tensor  # [N, 3]
    direction: Tensor  # [N, 3] incoming ray direction at the hit
    mat: Tensor  # [N] int32
    light: Tensor  # [N] int32
    atten: Tensor  # [N, 3]
    footprint: Tensor  # [N]
    uv: Tensor  # [N, 2]

    @property
    def hit(self) -> Tensor:
        return self.status == 0


def compact_queue_size(config: RenderConfig, n: int) -> int:
    """Width of the compacted-survivor queue (0 = full-batch walks)."""
    if not config.wavefront_compact or config.differentiable:
        return 0
    k = config.compact_queue or max(8192, n // 8)
    return 0 if k >= n else k


# config fields that select code paths the port does not have yet → where
# they come in (ROADMAP Queue A items; the hash-grid gather is not ported)
_UNPORTED = {
    "use_bvh": "BVH/cluster/epoch intersection, Queue A item 12",
    "intersect_rounds": "BVH/cluster/epoch intersection, Queue A item 12",
    "intersect_budget_scale": "BVH/cluster/epoch intersection, Queue A item 12",
    "grid_max_photons_per_cell": "the budgeted hash-grid gather, which the "
                                 "port replaces by the exact row-span gather",
}
_DEFAULTS = RenderConfig()


def require_forward(config: RenderConfig, what: str) -> None:
    """Refuse a config that sets a field of a path the port does not have
    yet, rather than ignore it."""
    for field, item in _UNPORTED.items():
        value = getattr(config, field)
        if value != getattr(_DEFAULTS, field):
            raise NotImplementedError(
                f"{what}: {field}={value!r} selects a path that is not "
                f"ported ({item})")


def chain_product(kd: Tensor, chain: Tensor, n0: Tensor) -> Tensor:
    """n0 ⊙ Π_j kd[chain[:, j]] over a recorded chain of material ids
    [rows, columns] (−1: no factor), multiplied in column order."""
    n_prod = n0
    for j in range(chain.shape[1]):
        m = chain[:, j]
        n_prod = n_prod * torch.where(
            (m >= 0)[:, None], vec.take_rows(kd, torch.clamp(m, min=0)), 1.0)
    return n_prod


def replay(value: Tensor, n_prod: Tensor) -> Tensor:
    """value with the gradient of value·N/sg(N), and 0 gradient where
    sg(N) = 0 (JAX's sg(value)·N/sg(N)). The primal is `value` itself, bit
    for bit: N − sg(N) is exactly 0, so the differentiable render equals
    the forward render."""
    value = value.detach()
    n_sg = n_prod.detach()
    ratio = torch.where(n_sg != 0.0,
                        value / torch.where(n_sg == 0.0, 1.0, n_sg), 0.0)
    return value + (n_prod - n_sg) * ratio


def camera_pass(scene: Scene, o: Tensor, d: Tensor, config: RenderConfig,
                rays=None) -> CameraRecords:
    """Trace camera rays, following specular chains up to the cap
    (reference: raytracing.cu:87-128). rays: the RayDifferentials of the
    first segment; when given, the pixel footprint is recorded at the
    first hit. With config.differentiable, atten carries the gradient of
    its mirror (kd) factors by record and replay."""
    require_forward(config, "camera_pass")
    if not config.differentiable:
        return _camera_walk(scene, o, d, config, rays, record=False)[0]
    with torch.no_grad():
        rec, chain = _camera_walk(
            scene, o, d, dataclasses.replace(config, differentiable=False),
            rays, record=True)
    n_prod = chain_product(scene.materials.kd, chain,
                           torch.ones_like(rec.atten))
    return dataclasses.replace(rec, atten=replay(rec.atten, n_prod))


def _camera_walk(scene: Scene, o: Tensor, d: Tensor, config: RenderConfig,
                 rays, record: bool):
    """The camera pass → (records, chain): with `record`, chain [N,
    max_specular_depth + 1] holds at column b the material of bounce b where
    that bounce's throughput is its kd row (mirror; glass throughput is
    ones, mat_ops.kd_in_specular), else −1; None without."""
    n = o.shape[0]
    dev = o.device
    compact = compact_queue_size(config, n) > 0
    eps = config.scene_epsilon
    z = lambda *shape: torch.zeros((n, *shape), dtype=torch.float32,
                                   device=dev)
    # record buffers, updated in place (each is its own allocation)
    rec = dict(
        status=torch.ones((n,), dtype=torch.int32, device=dev),
        p=z(3), ns=z(3), ng=z(3), dpdu=z(3), dpdv=z(3),
        direction=d.clone(),
        mat=torch.full((n,), -1, dtype=torch.int32, device=dev),
        light=torch.full((n,), -1, dtype=torch.int32, device=dev),
        uv=z(2),
    )
    footprint = z()
    atten = torch.ones((n, 3), dtype=torch.float32, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    o, d = o.clone(), d.clone()
    all_lanes = torch.arange(n, device=dev)
    chain = (torch.full((n, config.max_specular_depth + 1), -1,
                        dtype=torch.int32, device=dev) if record else None)

    for depth in range(config.max_specular_depth + 1):
        if depth > 0 and not bool(active.any()):
            break
        lanes = (active.nonzero()[:, 0] if compact and depth > 0
                 else all_lanes)
        act = active[lanes]
        ol, dl = o[lanes], d[lanes]
        hit = isect_ops.intersect(
            scene, ol, dl, torch.full((lanes.shape[0],), eps, device=dev),
            torch.where(act, BIG, 0.0))
        spec = mat_ops.is_specular(scene.materials, hit.mat)
        spec_hit = act & hit.valid & spec
        diff_hit = act & hit.valid & ~spec
        missed = act & ~hit.valid

        if depth == 0 and rays is not None:
            p_rx = rays.rx_o + rays.rx_d * hit.t[:, None]
            p_ry = rays.ry_o + rays.ry_d * hit.t[:, None]
            fp = 0.5 * (vec.length(p_rx - hit.p) + vec.length(p_ry - hit.p))
            footprint = torch.where(hit.valid, fp, 0.0)

        rec["status"][lanes] = torch.where(diff_hit, 0, torch.where(
            missed, 1, rec["status"][lanes]))
        for name, value in (("p", hit.p), ("ns", hit.ns), ("ng", hit.ng),
                            ("dpdu", hit.dpdu), ("dpdv", hit.dpdv),
                            ("direction", dl), ("mat", hit.mat),
                            ("light", hit.light), ("uv", hit.uv)):
            msk = diff_hit[:, None] if value.ndim == 2 else diff_hit
            rec[name][lanes] = torch.where(msk, value, rec[name][lanes])

        thr, wi = mat_ops.specular(scene.materials, hit.mat, hit.ns,
                                   hit.dpdu, -dl)
        if record:
            rec_m = spec_hit & mat_ops.kd_in_specular(scene.materials,
                                                      hit.mat)
            chain[lanes, depth] = torch.where(
                rec_m, hit.mat.to(torch.int32), chain[lanes, depth])
        s3 = spec_hit[:, None]
        o[lanes] = torch.where(s3, hit.p, ol)
        d[lanes] = torch.where(s3, wi, dl)
        atten[lanes] = torch.where(s3, atten[lanes] * thr, atten[lanes])
        if compact and depth == 0:
            # the compacted JAX pass seeds its queue records with the
            # bounced direction of each specular survivor
            rec["direction"] = torch.where(s3, wi, rec["direction"])
        active[lanes] = spec_hit

    # rays still active past the cap → exception flag (raytracing.cu:98-101)
    rec["status"] = torch.where(active, 2, rec["status"])
    return CameraRecords(atten=atten, footprint=footprint, **rec), chain


def static_light_samples(scene: Scene, config: RenderConfig):
    """Per-light sample counts, read on the host."""
    return tuple(int(min(x, config.max_light_samples))
                 for x in scene.lights.n_samples.tolist())


def direct_lighting(scene: Scene, rec: CameraRecords, key: Tensor,
                    config: RenderConfig, light_samples: tuple[int, ...],
                    include_emitted: bool = True,
                    sample_ids: Tensor | None = None) -> Tensor:
    """Direct lighting with shadow rays at the recorded hit points
    (reference: raytracing.cu:49-84): L = lightL + Σ_lights Σ_s
    |n_s·wi|·f·li / (pdf·nSamples), shadow rays over [eps, 1-eps] of the
    unnormalized uwi. Light-sample uniforms are threefry(key, request,
    global sample id), as in the JAX package."""
    n = rec.p.shape[0]
    dev = rec.p.device
    hit = rec.hit
    wo = vec.normalize(-rec.direction)
    L = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    if include_emitted:
        L = L + light_ops.light_L(scene.lights, rec.light, -rec.direction)
    if sample_ids is None:
        sample_ids = torch.arange(n, dtype=torch.int64, device=dev)
    layout = SampleLayout()
    offsets = [layout.add_2d(ns_i) for ns_i in light_samples]
    u2d = layout.materialize_2d(key, sample_ids)
    eps = config.shadow_epsilon
    tmin = torch.full((n,), eps, dtype=torch.float32, device=dev)
    tmax = torch.full((n,), 1.0 - eps, dtype=torch.float32, device=dev)
    for i, ns_i in enumerate(light_samples):
        for s in range(ns_i):
            li, uwi, pdf = light_ops.sample_L_illum(
                scene.lights, i, rec.p, u2d[:, offsets[i] + s])
            shadowed = isect_ops.occluded(scene, rec.p, uwi, tmin, tmax)
            wi = vec.normalize(uwi)
            fr = mat_ops.f(scene.materials, rec.mat, wo, wi, uv=rec.uv)
            cos = vec.absdot(rec.ns, wi)
            good = (hit & ~shadowed & (pdf > 0.0)
                    & (vec.length_squared(li) > 0.0))
            contrib = cos[:, None] * fr * li * (
                (1.0 / ns_i) / torch.where(pdf == 0.0, 1.0, pdf))[:, None]
            L = L + torch.where(good[:, None], contrib, 0.0)
    return torch.where(hit[:, None], L, 0.0)
