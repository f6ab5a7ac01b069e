"""Progressive photon-mapping renderer (port of
raytrace_tpu/renderers/photon.py: `trace_photons`, the photon walk,
`gathering_pass`, `final_gathering`, `render_photon` and the wave-by-wave
`render_photon_progressive` with checkpoint/resume), forward and, with
config.differentiable, record-and-replay differentiable in kd and the light
intensities (renderers/common.py `replay`).

  1. camera pass     → renderers/common.camera_pass
  2. photon tracing  → trace_photons: permuted-Halton emission, threefry
                       bounce uniforms, per-bounce Russian roulette
  3. gathering       → gathering_pass: progressive radius/flux update over
                       the dense small-map gather (kernel K4) for forward
                       waves under 2^14 slots, else the row-span gather
                       (kernel K2)
  4. final gather    → final_gathering: L = DL + flux/(π r² N_emitted)

Photon slots are disjoint per path (pm_index = path·max_depth,
photontracing.cu:82): a [paths·max_depth] photon map with a validity mask.
Every draw is keyed exactly as in the JAX package, so one key gives the same
photon map up to float rounding. The walk keeps the JAX package's two forms
(full batch, or full-width warm steps then only the survivors), which give
the same per-path results.
"""
from __future__ import annotations

import dataclasses
import os
import warnings

import torch
from torch import Tensor

from raytrace_tpu_torch.core import prng, sampling, spectrum, vec
from raytrace_tpu_torch.core.config import RenderConfig
from raytrace_tpu_torch.ops import intersect as isect_ops
from raytrace_tpu_torch.ops.dense_gather import (compact_photons,
                                                 gather_radius_dense_tiles)
from raytrace_tpu_torch.ops.photon_grid import PhotonMap, gather_radius_dense
from raytrace_tpu_torch.ops.rowspan_gather import gather_radius_rowspan
from raytrace_tpu_torch.renderers import common
from raytrace_tpu_torch.scene.camera import (PerspectiveCamera,
                                             generate_rays, pixel_samples)
from raytrace_tpu_torch.scene.scene import Scene
from raytrace_tpu_torch.shading import light as light_ops
from raytrace_tpu_torch.shading import material as mat_ops
from raytrace_tpu_torch.utils import checkpoint as ckpt
from raytrace_tpu_torch.utils import film, metrics

BIG = isect_ops.BIG
_U32 = 0xFFFFFFFF
DENSE_GATHER_SLOTS = 1 << 14  # forward maps below this take kernel K4


@dataclasses.dataclass(frozen=True)
class ProgressiveState:
    """Per-pixel-sample PPM statistics (reference: photonmapping.h:16-19).
    emitted: photon paths of the waves each pixel took part in (a wave
    whose gather skipped the pixel's tile is excluded)."""
    radius2: Tensor  # [N]
    photon_count: Tensor  # [N] float (α-weighted count)
    flux: Tensor  # [N, 3]
    emitted: Tensor  # [N] float


def initial_radius2(rec: common.CameraRecords, config: RenderConfig):
    """Per-pixel starting radius²: the global constant (raytracing.cu:123),
    or with footprint_radius_scale > 0 the SPPM footprint radius, clamped."""
    base = torch.full(rec.footprint.shape, config.initial_radius2,
                      dtype=torch.float32, device=rec.footprint.device)
    if config.footprint_radius_scale <= 0.0:
        return base
    fp = config.footprint_radius_scale * rec.footprint
    r2 = torch.clamp(fp * fp, config.min_radius2, config.initial_radius2)
    return torch.where(rec.footprint > 0.0, r2, base)


def gather_cell_size(rec: common.CameraRecords, state: ProgressiveState):
    """Grid cell edge for the gather: the 90th-percentile live radius."""
    live = torch.where(rec.hit, state.radius2, float("nan"))
    q90 = torch.nanquantile(live, 0.9)
    q90 = torch.where(torch.isnan(q90), 1.0, q90)  # no hits at all
    return torch.sqrt(torch.clamp(q90, min=1e-12))


def _bounce_uniforms(k_bounce: Tensor, gids: Tensor, n_int: Tensor):
    """3 uniforms per lane: threefry(fold_in(fold_in(k, path id), n_int)) —
    a pure function of (pass key, global path id, n_int)."""
    return prng.folded_uniform(k_bounce, (gids, n_int), (3,))


def _photon_step(scene: Scene, config: RenderConfig, o, d, alpha, n_int,
                 act, u) -> dict:
    """One photon-walk step for a batch of lanes: intersect, classify,
    deposit, continue (reference semantics: photontracing.cu:113-185)."""
    width = o.shape[0]
    max_depth = config.max_photon_depth
    hit = isect_ops.intersect(
        scene, o, d,
        torch.full((width,), config.scene_epsilon, device=o.device),
        torch.where(act, BIG, 0.0))
    alive = act & hit.valid  # miss → photon dies (photontracing.cu:193)
    spec = mat_ops.is_specular(scene.materials, hit.mat)
    spec_hit = alive & spec
    diff_hit = alive & ~spec

    # specular bounce (photontracing.cu:113-134)
    thr, wi_s = mat_ops.specular(scene.materials, hit.mat, hit.ns, hit.dpdu,
                                 -d)
    # diffuse: deposit if bounced at least once (photontracing.cu:141-151)
    deposit = diff_hit & (n_int >= 1)
    slot = torch.clamp(n_int - 1, 0, max_depth - 1)
    # diffuse continuation (photontracing.cu:153-184)
    cont = diff_hit & (n_int < max_depth)
    fr, wi_d, pdf_b = mat_ops.sample_f(
        scene.materials, hit.mat, hit.ns, hit.dpdu, -d, u[:, 0], u[:, 1],
        uv=hit.uv)
    cont = cont & ~spectrum.is_black(fr) & (pdf_b > 0.0)
    anew = (alpha * fr
            * vec.absdot(wi_d, vec.normalize(hit.ns))[:, None]
            / torch.where(pdf_b == 0.0, 1.0, pdf_b)[:, None])
    if config.russian_roulette:
        # the reference's commented-out roulette (photontracing.cu:173-178)
        y_old = spectrum.luminance(alpha)
        y_new = spectrum.luminance(anew)
        p_cont = torch.clamp(
            y_new / torch.where(y_old == 0.0, 1.0, y_old), max=1.0)
        cont = cont & (u[:, 2] <= p_cont) & (p_cont > 0.0)
        anew = anew / torch.where(p_cont == 0.0, 1.0, p_cont)[:, None]

    next_alive = spec_hit | cont
    s3, c3 = spec_hit[:, None], cont[:, None]
    o2 = torch.where(next_alive[:, None], hit.p, o)
    d2 = torch.where(s3, wi_s, torch.where(c3, wi_d, d))
    alpha2 = torch.where(s3, alpha * thr, torch.where(c3, anew, alpha))
    # nIntersections: specular bumps 0→1 only (photontracing.cu:126-129);
    # a diffuse continuation increments (photontracing.cu:182)
    n_int2 = torch.where(spec_hit & (n_int == 0), 1,
                         torch.where(cont, n_int + 1, n_int))
    # a specular path whose throughput went black can never deposit again
    next_alive = next_alive & ~spectrum.is_black(alpha2)
    # record and replay: a bounce joins the path's chain iff its alpha
    # factor contains kd — diffuse continuations (f = kd/π) and mirror
    # bounces (thr = kd), never glass (thr = 1)
    append = next_alive & (cont | (spec_hit & mat_ops.kd_in_specular(
        scene.materials, hit.mat)))
    return dict(deposit=deposit, slot=slot, dep_p=hit.p, dep_alpha=alpha,
                dep_wi=-d, o=o2, d=d2, alpha=alpha2, n_int=n_int2,
                alive=next_alive, append=append, append_mat=hit.mat)


def trace_photons(scene: Scene, config: RenderConfig, key: Tensor,
                  pass_idx: int, light_index: int | None = None,
                  path_offset: int = 0):
    """One photon wave: `photon_paths` light paths, ≤ max_photon_depth
    diffuse deposits each (reference: photontracing.cu:80-185). With
    several lights, paths are striped over the light table by path id
    (uniform pick, Le scaled by the light count); `light_index` instead
    shoots every path from that light, Le unscaled.

    Path ids are global: path i of the wave has id path_offset + i (wrapped
    to 32 bits, as in JAX), and its Halton point, light and bounce uniforms
    are functions of that id alone. So ranks that trace disjoint slices of
    the id space (parallel/sharded.py) give, concatenated, the photons of
    the whole wave.

    With config.differentiable, alpha carries the gradient of
    Le[light] ⊙ Π kd[m_j] over each deposit's recorded chain (record and
    replay); Russian roulette stays on, its survival and 1/P reweight
    inside the detached walk (JAX's detached-sampling estimator)."""
    common.require_forward(config, "trace_photons")
    if not config.differentiable:
        with metrics.span("rt.frame.walk"):
            pm, _, _ = _photon_walk(scene, config, key, pass_idx,
                                    light_index, path_offset, record=False)
    else:
        with torch.no_grad(), metrics.span("rt.frame.walk"):
            pm, chain, light = _photon_walk(
                scene, dataclasses.replace(config, differentiable=False), key,
                pass_idx, light_index, path_offset, record=True)
        n_prod = common.chain_product(
            scene.materials.kd, chain, vec.take_rows(scene.lights.intensity,
                                                     light))
        pm = dataclasses.replace(pm, alpha=common.replay(pm.alpha, n_prod))
    return pm


def _path_lights(scene: Scene, gids: Tensor, light_index: int | None):
    """(light of each path, Le scale): the stripe gids % n_lights with
    scale n_lights, or `light_index` (0 with one light) with scale 1."""
    n_lights = scene.lights.count
    if light_index is None and n_lights > 1:
        return gids % n_lights, float(n_lights)
    return torch.full_like(gids, light_index or 0), 1.0


def emission(scene: Scene, config: RenderConfig, key: Tensor,
             pass_idx: int, light_index: int | None = None,
             path_offset: int = 0) -> dict:
    """The wave's emission (photontracing.cu:83-97): permuted-Halton light
    samples → dict of gids (global path ids), light (each path's light), o,
    d, alpha, alive and the bounce key; the rays of the walk's first
    launch."""
    dev = key.device
    n_paths = config.photon_paths
    keys = prng.split(prng.fold_in(key, pass_idx))
    k_perm, k_bounce = keys[0], keys[1]
    perms = sampling.halton_permutations(k_perm)
    stride = config.max_photon_depth if config.halton_stride_by_depth else 1
    gids = (torch.arange(n_paths, dtype=torch.int64, device=dev)
            + path_offset) & _U32
    smp = sampling.halton_sample_4d((gids * stride) & _U32, perms)
    i_light, light_scale = _path_lights(scene, gids, light_index)
    le, o, d, ns_l, pdf = light_ops.sample_Le(
        scene.lights, i_light, smp[:, 0], smp[:, 1], smp[:, 2], smp[:, 3])
    le = le * light_scale
    alpha = (vec.absdot(ns_l, d)[:, None] * le
             / torch.where(pdf == 0.0, 1.0, pdf)[:, None])
    alive = (pdf > 0.0) & ~spectrum.is_black(le)
    return dict(gids=gids, light=i_light, o=o, d=d, alpha=alpha, alive=alive,
                k_bounce=k_bounce)


def _photon_walk(scene: Scene, config: RenderConfig, key: Tensor,
                 pass_idx: int, light_index: int | None, path_offset: int,
                 record: bool):
    """The photon walk → (PhotonMap, chain, light): with
    `record`, chain [slots, max_photon_bounces] holds at column s the
    material a slot's path appended at step s before the deposit (−1:
    none), and light [slots] the light each slot's path left; both None
    without."""
    dev = key.device
    n_paths = config.photon_paths
    max_depth = config.max_photon_depth
    em = emission(scene, config, key, pass_idx, light_index, path_offset)
    gids, o, d, alpha, alive = (em[k] for k in ("gids", "o", "d", "alpha",
                                                "alive"))
    k_bounce = em["k_bounce"]

    ph_p = torch.zeros((n_paths, max_depth, 3), dtype=torch.float32,
                       device=dev)
    ph_alpha = torch.zeros_like(ph_p)
    ph_wi = torch.zeros_like(ph_p)
    ph_valid = torch.zeros((n_paths, max_depth), dtype=torch.bool,
                           device=dev)
    n_int = torch.zeros((n_paths,), dtype=torch.int32, device=dev)
    all_lanes = torch.arange(n_paths, device=dev)
    n_steps = config.max_photon_bounces
    if record:
        chain = torch.full((n_paths, n_steps), -1, dtype=torch.int32,
                           device=dev)
        ph_chain = torch.full((n_paths, max_depth, n_steps), -1,
                              dtype=torch.int32, device=dev)
    # full-width steps before the walk narrows to its survivors (JAX:
    # step 0 plus the warm steps of _photon_walk_compact; all of them
    # when compaction is off)
    if common.compact_queue_size(config, n_paths):
        warm = config.compact_warm_steps or (3 if n_paths < (1 << 21) else 1)
        full_steps = max(1, min(warm, n_steps - 1))
    else:
        full_steps = n_steps
    for it in range(n_steps):
        with metrics.span("rt.frame.walk_step"):
            if it > 0:
                with metrics.sync("walk_alive"):
                    any_alive = bool(alive.any())
                if not any_alive:
                    break
            if it < full_steps:
                lanes = all_lanes
            else:
                with metrics.sync("walk_lanes"):
                    lanes = alive.nonzero()[:, 0]
            u = _bounce_uniforms(k_bounce, gids[lanes], n_int[lanes])
            out = _photon_step(scene, config, o[lanes], d[lanes],
                               alpha[lanes], n_int[lanes], alive[lanes], u)
            dep = out["deposit"]
            with metrics.sync("deposit_rows"):
                rows = lanes[dep]
            with metrics.sync("deposit_slot"):
                slot = out["slot"][dep].long()
            with metrics.sync("deposit_p"):
                ph_p[rows, slot] = out["dep_p"][dep]
            with metrics.sync("deposit_alpha"):
                ph_alpha[rows, slot] = out["dep_alpha"][dep]
            with metrics.sync("deposit_wi"):
                ph_wi[rows, slot] = out["dep_wi"][dep]
            with metrics.sync("deposit_valid"):  # True copied to the card
                ph_valid[rows, slot] = True
            if record:
                # deposit first (its alpha excludes this surface), then
                # append
                ph_chain[rows, slot] = chain[rows]
                app = out["append"]
                chain[lanes[app], it] = out["append_mat"][app].to(
                    torch.int32)
            o[lanes], d[lanes], alpha[lanes] = (out["o"], out["d"],
                                                out["alpha"])
            n_int[lanes], alive[lanes] = out["n_int"], out["alive"]
    n_slots = n_paths * max_depth
    pm = PhotonMap(p=ph_p.reshape(n_slots, 3),
                   alpha=ph_alpha.reshape(n_slots, 3),
                   wi=ph_wi.reshape(n_slots, 3),
                   valid=ph_valid.reshape(n_slots))
    if not record:
        return pm, None, None
    light = torch.repeat_interleave(em["light"], max_depth)
    return pm, ph_chain.reshape(n_slots, n_steps), light


def gather_capacity(config: RenderConfig, n_slots: int) -> tuple[int, int]:
    """(rounds, job_budget) of the row-span gather: config knobs, 0 = auto
    (rounds scale with the map, clamped to [4, 16]; 2^17 jobs each)."""
    rounds = config.gather_rounds or max(4, min(16, n_slots >> 18))
    return rounds, config.gather_job_budget or (1 << 17)


def gathering_pass(scene: Scene, rec: common.CameraRecords,
                   state: ProgressiveState, photons: PhotonMap,
                   config: RenderConfig):
    """Progressive radius/flux update (reference: gathering.cu:104-126).
    The radius search takes the first route that applies (JAX
    renderers/photon.py `gathering_pass`):
      - config.exact_gather: the exact all-pairs oracle the JAX package
        also offers;
      - a forward wave of fewer than 2^14 photon slots: the map compacted
        to its valid prefix and the dense small-map gather, kernel K4;
      - otherwise the row-span gather, kernel K2.
    The exact routes cover every pixel. Row-span job-budget overflow is
    unbiased: a skipped tile returns L = 0, M = 0 and its pixels leave this
    wave out of their emitted-path normalization (raise gather_rounds or
    gather_job_budget to remove it).

    The row-span route stays at every map size under config.differentiable:
    its backward is kernel K3. (JAX takes an all-pairs gather for
    differentiable maps under 2^15 slots only because its CPU fallback was
    a truncating hash grid; the row-span gather is exact while overflow is
    0, so the numbers are the same.)"""
    common.require_forward(config, "gathering_pass")
    with metrics.span("rt.gather"):
        wo = vec.normalize(-rec.direction)
        kd_over_pi = mat_ops.f(scene.materials, rec.mat, wo, wo, uv=rec.uv)
        n_slots = photons.p.shape[0]
        n_valid = photons.valid.sum().to(torch.int32)
        if config.exact_gather:
            idl, m = gather_radius_dense(photons, rec.p, state.radius2,
                                         rec.ns, kd_over_pi)
            overflow = torch.zeros((), dtype=torch.int64, device=m.device)
            covered = torch.ones_like(rec.hit)
        elif not config.differentiable and n_slots < DENSE_GATHER_SLOTS:
            # a miss's M is masked below, so its radius may be 0 here; its
            # starting radius (initial_radius2, at p = 0) would widen K4's
            # pre-cull box for its warp to most of the scene
            pp, pa, pw, pv, n_valid = compact_photons(photons)
            idl, m = gather_radius_dense_tiles(
                pp, pa, pw, pv, n_valid, rec.p,
                torch.where(rec.hit, state.radius2, 0.0), rec.ns, kd_over_pi)
            overflow = torch.zeros((), dtype=torch.int64, device=m.device)
            covered = torch.ones_like(rec.hit)
        else:
            rounds, job_budget = gather_capacity(config, n_slots)
            idl, m, overflow, covered = gather_radius_rowspan(
                photons.p, photons.alpha, photons.wi, photons.valid,
                gather_cell_size(rec, state), rec.p,
                torch.where(rec.hit, state.radius2, 0.0), rec.ns, kd_over_pi,
                r_max=config.gather_r_max, rounds=rounds,
                job_budget=job_budget)
        with metrics.sync("gather_overflow"):
            n_over = int(overflow)
        if n_over > 0:
            warnings.warn(
                f"gather job budget overflow by {n_over} jobs — affected "
                "pixel tiles skip this wave (excluded from their "
                "normalization); raise gather_rounds", RuntimeWarning)
        info = dict(valid_photons=n_valid,
                    max_cell_occupancy=-1,  # -1: exact path, no cell budget
                    gather_overflow=overflow)

        m = torch.where(rec.hit, m, 0)
        mf = m.to(torch.float32)
        new_count = state.photon_count + config.ppm_alpha * mf
        denom = state.photon_count + mf
        ratio = new_count / torch.where(denom == 0.0, 1.0, denom)
        upd = m > 0
        paths_wave = float(n_slots // config.max_photon_depth)
        state = ProgressiveState(
            radius2=torch.where(upd, state.radius2 * ratio, state.radius2),
            photon_count=torch.where(upd, new_count, state.photon_count),
            flux=torch.where(upd[:, None],
                             (state.flux + idl) * ratio[:, None], state.flux),
            emitted=state.emitted + torch.where(covered, paths_wave, 0.0),
        )
        return state, info


def final_gathering(rec: common.CameraRecords, direct: Tensor,
                    state: ProgressiveState) -> Tensor:
    """L = atten·(DL + flux/(π r² N_emitted)) per pixel sample (reference:
    gathering.cu:129-146), each pixel normalized by the paths of the waves
    it took part in."""
    denom = state.radius2 * torch.clamp(state.emitted, min=1.0)
    have = (state.photon_count != 0.0) & (state.emitted > 0.0)
    idl = torch.where(have[:, None],
                      state.flux * sampling.INV_PI / denom[:, None], 0.0)
    L = rec.atten * (direct + idl)
    return torch.where(rec.hit[:, None], L, 0.0)


def render_photon(scene: Scene, camera: PerspectiveCamera,
                  config: RenderConfig, key: Tensor, jitter: bool = True,
                  return_aux: bool = False):
    """Full progressive photon-mapping render → [H, W, 3] image; with
    return_aux also a dict of the frame's counters (valid_photons,
    gather_overflow, pair_overflow, mean radius² and photon count).

    pair_overflow is the int 0 here, in render_photon_progressive and in
    parallel/sharded.py: the intersection engines run every pair, and the
    key stays because JAX's aux has it and callers read it."""
    with metrics.span("rt.frame"):
        img, aux = _render_photon(scene, camera, config, key,
                                  common.static_light_samples(scene, config),
                                  jitter)
    return (img, aux) if return_aux else img


def _ppm_setup(scene: Scene, camera: PerspectiveCamera, config: RenderConfig,
               key: Tensor, light_samples: tuple[int, ...], jitter: bool):
    """Deterministic per-render setup → (pixel samples, camera records,
    direct light, zeroed PPM state, photon key). Recomputed, not
    checkpointed, on resume: it is a pure function of (key, config)."""
    keys = prng.split(key, 3)
    k_pix, k_light, k_photon = keys[0], keys[1], keys[2]
    xy, lens = pixel_samples(k_pix, config.width, config.height, config.spp,
                             jitter=jitter)
    rays = generate_rays(camera, xy, lens, config.spp)
    n = rays.o.shape[0]
    rec = common.camera_pass(scene, rays.o, rays.d, config, rays=rays)
    direct = common.direct_lighting(scene, rec, k_light, config,
                                    light_samples, include_emitted=True)
    zeros = lambda *s: torch.zeros((n, *s), dtype=torch.float32,
                                   device=key.device)
    state = ProgressiveState(radius2=initial_radius2(rec, config),
                             photon_count=zeros(), flux=zeros(3),
                             emitted=zeros())
    return xy, rec, direct, state, k_photon


def _ppm_wave(scene: Scene, rec: common.CameraRecords,
              state: ProgressiveState, k_photon: Tensor, pass_idx: int,
              config: RenderConfig):
    """One progressive photon wave: trace + gather + radius/flux update."""
    photons = trace_photons(scene, config, k_photon, pass_idx)
    return gathering_pass(scene, rec, state, photons, config)


def _render_photon(scene: Scene, camera: PerspectiveCamera,
                   config: RenderConfig, key: Tensor,
                   light_samples: tuple[int, ...], jitter: bool):
    """render_photon with the per-light sample counts given → (image,
    aux dict)."""
    xy, rec, direct, state, k_photon = _ppm_setup(
        scene, camera, config, key, light_samples, jitter)
    valid_photons = 0
    gather_ovf = 0
    for p in range(config.photon_passes):
        state, info = _ppm_wave(scene, rec, state, k_photon, p, config)
        valid_photons = valid_photons + info["valid_photons"]
        gather_ovf = gather_ovf + info["gather_overflow"]
    with metrics.span("rt.frame.final"):
        L = final_gathering(rec, direct, state)
        img = film.splat(xy, L, config.width, config.height,
                         config.pixel_filter, config.filter_radius)
    aux = dict(
        valid_photons=valid_photons,
        max_cell_occupancy=-1,
        gather_overflow=gather_ovf,
        pair_overflow=0,
        mean_radius2=torch.mean(torch.where(rec.hit, state.radius2, 0.0)),
        mean_photon_count=torch.mean(state.photon_count),
    )
    return img, aux


def render_photon_progressive(scene: Scene, camera: PerspectiveCamera,
                              config: RenderConfig, key: Tensor,
                              jitter: bool = True,
                              checkpoint_path: str | None = None,
                              save_every: int = 1, verbose: bool = False,
                              return_aux: bool = False):
    """Wave-by-wave progressive render with optional checkpoint/resume.

    If checkpoint_path exists, rendering resumes from the stored wave;
    otherwise the state is written every `save_every` waves and after the
    last one (utils/checkpoint.py, the JAX package's file format). Waves are
    pure functions of (key, pass index), so resumed == uninterrupted. With
    verbose, one `log_pass` line per wave (utils/metrics.py).

    Returns (image [H, W, 3], ProgressiveState); with return_aux, a third
    dict: gather_overflow summed over the executed waves, pair_overflow (0,
    see `render_photon`), and wave_s, each executed wave's wall time in
    seconds, device work included."""
    light_samples = common.static_light_samples(scene, config)
    xy, rec, direct, state, k_photon = _ppm_setup(
        scene, camera, config, key, light_samples, jitter)
    gather_ovf = 0
    wave_s = []
    start = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        state, start, _, _ = ckpt.load_progressive(checkpoint_path,
                                                   key.device)
    for p in range(start, config.photon_passes):
        with metrics.Throughput() as tp:
            state, info = _ppm_wave(scene, rec, state, k_photon, p, config)
            if state.flux.is_cuda:
                torch.cuda.synchronize(state.flux.device)
        wave_s.append(tp.seconds)
        gather_ovf = gather_ovf + info["gather_overflow"]
        if verbose:
            metrics.log_pass(
                "photon_wave", wave=p,
                valid_photons=int(info["valid_photons"]),
                photons_per_s=f"{tp.rate(config.photon_paths):.3e}",
                mean_radius2=float(torch.mean(
                    torch.where(rec.hit, state.radius2, 0.0))))
        done = p + 1
        if checkpoint_path and save_every and (
                done % save_every == 0 or done == config.photon_passes):
            ckpt.save_progressive(
                checkpoint_path, state, done, key,
                emitted_photons=float(config.photon_paths) * done)
    L = final_gathering(rec, direct, state)
    img = film.splat(xy, L, config.width, config.height, config.pixel_filter,
                     config.filter_radius)
    if return_aux:
        aux = dict(pair_overflow=0, gather_overflow=gather_ovf,
                   wave_s=wave_s)
        return img, state, aux
    return img, state
