"""Smoke run of the PyTorch/CUDA port (raytrace_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                   # the whole check, a few minutes
    python3 chip_smoke.py --profile FILE    # also torch.profiler tables of a
                                            # frame, a gradient step, a
                                            # preview render and a simple
                                            # frame, written to FILE*

Phases, one JSON result line each:
  1. device     the card's name and power limit; raises without CUDA
  2. build      nvcc builds kernels K1-K5 from raytrace_tpu_torch/csrc, one
                nvcc process per source, all at once
  3. k1         K1 (closest hit) against its plain PyTorch version on
                262,144 random rays: the Cornell triangles and a
                4,096-triangle soup; hit flips are bounded
  4. k2         K2 (row-span gather) against its plain version on the
                gather inputs of the full-size frame
  5. k3         K3 (the gather's backward in the photon flux) against its
                plain version on the same inputs and a random cotangent
  6. k4         K4 (dense small-map gather) against its plain version on the
                gather inputs of the preview's first wave (2,048 paths)
  7. k5         K5 (Morton-span gather) against its plain version on the
                full-size frame's queries and a 2^16-path wave, the cell
                the largest live radius
  8. reference  a 32×32 frame on the card (kernels) against the same frame
                on the CPU (plain versions)
  9. main       render_photon on the 512×512 glass Cornell box with 262,144
                photon paths (bench.py's headline settings): a warm-up,
                then the median of 5 frames, with K1's and K2's launch
                counts over those frames
 10. grad_reference  loss_and_grad of a 32×32 frame on the card against the
                same on the CPU
 11. grad       loss_and_grad at bench.py's run_grad settings (the headline
                frame with differentiable=True, zero target, no jitter): a
                warm-up, then the median of 5 steps, with K1's, K2's and
                K3's launch counts over those steps
 12. train      3 Adam steps of fit at the same settings, from a 1.8×
                over-bright emitter against the frame rendered at the true
                parameters
 13. preview    render_photon_progressive on the same box with 2,048 paths ×
                16 waves (2^13-slot maps, so every wave takes K4): K4 and K2
                launch counts, the median wave; then 8 waves with a
                checkpoint, resumed to 16, against the uninterrupted render
 14. progressive  render_photon_progressive at bench.py run_multiwave's
                settings (262,144 paths × 8 waves, the row-span route): the
                steady wave median and the radius trace
 15. simple     render_simple on the 256×256 sphere and plane (BASELINE
                config[0]): a warm-up, then the median of 5 frames; and a
                32×32 frame on the card against the CPU's
Then the kernel table as one JSON line, the card line from nvidia-smi, and
last {"ok": true, "device": {...}}. Any failed check raises, so the script
exits non-zero and prints no final line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import os
import re
import statistics
import subprocess
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import raytrace_tpu_torch
from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.core.config import RenderConfig
from raytrace_tpu_torch.diff import optim
from raytrace_tpu_torch.diff import render as diff
from raytrace_tpu_torch.ops import cuda_lib
from raytrace_tpu_torch.ops import dense_gather as dg
from raytrace_tpu_torch.ops import grid_gather as gg
from raytrace_tpu_torch.ops import rowspan_gather as rg
from raytrace_tpu_torch.ops import tri_intersect as ti
from raytrace_tpu_torch.renderers import common, photon, simple
from raytrace_tpu_torch.scene import presets
from raytrace_tpu_torch.scene.camera import generate_rays, pixel_samples
from raytrace_tpu_torch.scene.scene import GLASS

SIZE = 512
# bench.py:78-85, the frame users render through render_photon
BENCH = dict(width=SIZE, height=SIZE, spp=1, scene_epsilon=1e-3,
             photon_paths=1 << 18, photon_passes=1, max_photon_bounces=8,
             footprint_radius_scale=8.0)
# the preview: 2,048 paths a wave, 8,192 slots, under the 2^14 threshold of
# the dense gather K4
PREVIEW = dict(BENCH, photon_paths=1 << 11, photon_passes=16)
# bench.py run_multiwave: the headline frame over 8 waves
MULTIWAVE = dict(BENCH, photon_passes=8)
# bench.py run_scaling's map (bench.py:447): 2^16 paths, 262,144 slots
K5_PATHS = 1 << 16
# BASELINE config[0] as examples/render_sphere_plane.py renders it
SIMPLE = dict(width=256, height=256, spp=4, scene_epsilon=1e-3)
N_RAYS = 1 << 18
BIG = 1e30
# the card's published peaks (H100 SXM data sheet, dense, at 700 W): fp32
# outside the tensor cores, and device memory
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# fp32 operations per pair, counted from the kernels' sources. K1's
# Möller–Trumbore test: pvec 9, det 5, inverse 2, tvec 3, beta 6, qvec 9,
# gamma 6, t 6, the bounds and the running best 7. The gathers' (K2-K5)
# radius test: 3 differences, 3 products, 2 sums, 2 compares; and for a
# pair inside the radius its weight |n_s·wi| (3 products, 2 sums, abs),
# 3 products and 3 sums into S (K3: into dalpha) and the count
K1_PAIR_OPS = 53
GATHER_TEST_OPS = 10
GATHER_HIT_OPS = 13
# K1 runs with --fmad=false, so it rounds like the plain version; allow a
# 1e-4 share of rays to flip between hit/miss or triangle anyway, and on the
# rays that agree t within 1e-5 of the largest t, β and γ within 1e-5
K1_FLIP_FRAC = 1e-4
K1_RTOL = 1e-5
# K2 forms each term |n_s·wi|·α exactly as the plain version does and only
# sums in another order. A sum of M nonzero terms rounds at most M - 1
# additions, each by 2^-24 of at most the total, so per query the two sides
# differ by at most 2·M·2^-24 of its flux; counts M are exact.
K2_ULP = 2.0 ** -24
# K3 forms each term |n_s·wi|·cot exactly as the plain version does (built
# with --fmad=false) and only sums in another order; with a nonnegative
# cotangent every term is ≥ 0, so per photon the two sides differ by at most
# 2·K·2^-24 of its dα, K its term count; term counts are exact
K3_ULP = 2.0 ** -24
# card (kernels) vs CPU (plain versions) at 32×32: transcendentals differ
# by ulps between the two, which can move a few photon paths
REF_REL_L1, REF_OFF_FRAC = 1e-3, 0.02
# the resumed preview render against the uninterrupted one: the state is
# equal bit for bit, the image only up to the film's scatter-add, whose
# atomics add each pixel's samples in run-dependent order
RESUME_IMG_REL_L1 = 1e-6
# the same for loss_and_grad, whose gradients are also summed in another
# order on the card: the backward of the kd and intensity lookups
# (vec.take_rows, one-hot products) is a matrix product over 2^10-2^20 rows
# that cuBLAS sums in its own blocked order
GRAD_REL = 1e-3


def emit(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn over iters launches, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(ops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of `ops` fp32
    operations at the fp32 peak and `nbytes` (each input read once, each
    output written once) at the memory peak."""
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def gather_ops(pair_tests: int, hits: float) -> float:
    return GATHER_TEST_OPS * pair_tests + GATHER_HIT_OPS * hits


def flux_check(what: str, got, want) -> tuple[float, float]:
    """Counts M (row 3) equal and every query's flux S (rows 0-2) within
    2·M·2^-24 of the plain version's (see K2_ULP) → (largest error, largest
    error in M·2^-24·S units)."""
    if not torch.equal(got[3], want[3]):
        raise AssertionError(f"{what}: photon counts M differ from the "
                             "plain version")
    diff = (got[:3] - want[:3]).abs()
    unit = K2_ULP * want[3] * want[:3].abs()
    if bool((diff > 2.0 * unit).any()):
        worst = int(torch.argmax((diff - 2.0 * unit).amax(0)))
        raise AssertionError(
            f"{what}: flux of query {worst} differs by "
            f"{diff[:, worst].tolist()} (want {want[:3, worst].tolist()}, "
            f"M {float(want[3, worst])})")
    return float(diff.max()), float((diff / unit.clamp(min=1e-30)).max())


def phase_build() -> None:
    def timed(name):
        t1 = time.perf_counter()
        cuda_lib.build(name)
        return time.perf_counter() - t1

    t0 = time.perf_counter()
    names = ("tri_intersect", "rowspan_gather", "rowspan_gather_bwd",
             "dense_gather", "grid_gather")
    with ThreadPoolExecutor(len(names)) as pool:
        secs = dict(zip(names, pool.map(timed, names)))
    emit("build", seconds=secs, total_s=time.perf_counter() - t0)


def _k1_case(label, o, d, v0, v1, v2, iters):
    n = o.shape[0]
    tmin = torch.full((n,), 1e-3, device=o.device)
    tmax = torch.full((n,), BIG, device=o.device)
    args = (o, d, tmin, tmax, v0, v1, v2)
    got = ti.closest_hit(*args)
    want = ti.closest_hit_plain(*args)
    torch.cuda.synchronize()
    hit_k, hit_p = got[0] < BIG, want[0] < BIG
    agree = (hit_k == hit_p) & (~hit_k | (got[1] == want[1]))
    flips = int((~agree).sum())
    both = agree & hit_k
    err_t = float((got[0][both] - want[0][both]).abs().max())
    err_bg = max(float((got[k][both] - want[k][both]).abs().max())
                 for k in (2, 3))
    if flips > K1_FLIP_FRAC * n:
        raise AssertionError(f"K1 {label}: {flips} of {n} rays flip")
    t_scale = float(want[0][both].abs().max())
    if err_t > K1_RTOL * t_scale or err_bg > K1_RTOL:
        raise AssertionError(f"K1 {label}: t differs by {err_t} (max t "
                             f"{t_scale}), beta/gamma by {err_bg}")
    err = max(err_t, err_bg)
    ms = cuda_ms(lambda: ti.closest_hit(*args), iters)
    plain_ms = cuda_ms(lambda: ti.closest_hit_plain(*args), max(1, iters // 10))
    t = v0.shape[0]
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
               **bound(n * t * K1_PAIR_OPS, n * (8 + 4) * 4 + t * 9 * 4),
               library_ms=None)
    emit("k1", case=label, rays=n, triangles=t, hits=int(hit_k.sum()),
         flips=flips, **row)
    return row


def phase_k1(dev, scene):
    g = torch.Generator(device=dev).manual_seed(1)
    rnd = lambda *s: torch.rand(*s, device=dev, generator=g)
    # rays from inside the box, every direction
    o = rnd(N_RAYS, 3) * torch.tensor([2.0, 2.0, 2.0], device=dev) \
        - torch.tensor([1.0, 0.0, 0.0], device=dev)
    d = torch.nn.functional.normalize(torch.randn(N_RAYS, 3, device=dev,
                                                  generator=g), dim=1)
    tris = scene.tris
    res = _k1_case("cornell", o.contiguous(), d.contiguous(), tris.v0,
                   tris.v1, tris.v2, iters=50)
    # 4,096-triangle soup in [-1, 1]^3
    t = 4096
    v0 = rnd(t, 3) * 2 - 1
    v1 = v0 + 0.15 * torch.randn(t, 3, device=dev, generator=g)
    v2 = v0 + 0.15 * torch.randn(t, 3, device=dev, generator=g)
    o2 = rnd(N_RAYS, 3) * 3 - 1.5
    _k1_case("soup4096", o2.contiguous(), d, v0.contiguous(),
             v1.contiguous(), v2.contiguous(), iters=10)
    return res  # the main path's shape: camera-size batch, 10 triangles


def headline_records(dev, scene, cam, cfg):
    """Camera records and starting radii² of the full-size frame (key 0),
    and the key of its photon waves."""
    keys = prng.split(prng.PRNGKey(0, dev), 3)
    xy, lens = pixel_samples(keys[0], cfg.width, cfg.height, cfg.spp)
    rays = generate_rays(cam, xy, lens, cfg.spp)
    rec = common.camera_pass(scene, rays.o, rays.d, cfg, rays=rays)
    return rec, photon.initial_radius2(rec, cfg), keys[2]


def gather_jobs(scene, cfg, rec, r2, k_photon):
    """The gather inputs of the full-size frame (first wave) → (rowspan_jobs
    dict, queries, valid photons)."""
    photons = photon.trace_photons(scene, cfg, k_photon, 0)
    state = photon.ProgressiveState(
        radius2=r2, photon_count=torch.zeros_like(r2),
        flux=torch.zeros_like(rec.p), emitted=torch.zeros_like(r2))
    rounds, budget = photon.gather_capacity(cfg, photons.p.shape[0])
    jobs = rg.rowspan_jobs(
        photons.p, photons.wi, photons.alpha, photons.valid,
        photon.gather_cell_size(rec, state), rec.p,
        torch.where(rec.hit, r2, 0.0), rec.ns, r_max=cfg.gather_r_max,
        rounds=rounds, job_budget=budget)
    return jobs, int(rec.p.shape[0]), int(photons.valid.sum())


def phase_k2(jobs, queries, photons):
    """K2 on the gather inputs of the full-size frame."""
    args = [jobs[k] for k in ("pid", "tile_begin", "tile_end", "n_chunks",
                              "qpT", "qr2", "qnsT", "pdata")]
    got = rg.rowspan_S(*args)
    want = rg.rowspan_S_plain(*args)
    torch.cuda.synchronize()
    err, ulps = flux_check("K2", got, want)
    ms = cuda_ms(lambda: rg.rowspan_S(*args), 20)
    plain_ms = cuda_ms(lambda: rg.rowspan_S_plain(*args), 2)
    n_jobs = int(jobs["n_valid"])  # the jobs the kernel runs
    pairs = n_jobs * rg.TILE_Q * jobs["pdata"].shape[2]
    nq = jobs["qr2"].shape[0]
    slots = jobs["n_chunks"] * jobs["pdata"].shape[2]
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
               **bound(gather_ops(pairs, float(want[3].sum())),
                       nq * (7 + 4) * 4 + slots * 10 * 4 + n_jobs * 4
                       + len(jobs["tile_begin"]) * 8),
               library_ms=None)
    emit("k2", queries=queries, tiles=len(jobs["tile_begin"]),
         chunks=jobs["n_chunks"], jobs=int(jobs["n_jobs"]),
         overflow=int(jobs["overflow"]), photons=photons, pair_tests=pairs,
         max_flux=float(want[:3].abs().max()), max_err_over_M_ulp=ulps,
         **row)
    return row


def phase_k3(dev, jobs):
    """K3 on the same inputs, re-sorted chunk-major, with a nonnegative
    cotangent from its own generator."""
    n_tiles = jobs["tile_begin"].shape[0]
    pid, begin, end = rg.chunk_major(jobs["pid"], jobs["n_valid"],
                                     jobs["n_chunks"], n_tiles)
    g = torch.Generator(device=dev).manual_seed(3)
    cotT = torch.rand(jobs["qpT"].shape, device=dev, generator=g)
    args = (pid, begin, end, n_tiles, jobs["qpT"], jobs["qr2"], jobs["qnsT"],
            cotT, jobs["pdata"])
    got = rg.rowspan_S_bwd(*args)
    want = rg.rowspan_S_bwd_plain(*args)
    torch.cuda.synchronize()
    terms = want[:, 3:4]
    if not torch.equal(got[:, 3], want[:, 3]):
        raise AssertionError("K3: photon term counts differ from the plain "
                             "version")
    empty = begin == end
    if bool(got[empty].any()):
        raise AssertionError("K3: a chunk without jobs is not exactly 0")
    delta = (got[:, :3] - want[:, :3]).abs()
    unit = K3_ULP * terms * want[:, :3]
    if bool((delta > 2.0 * unit).any()):
        c, r, k = torch.nonzero(delta > 2.0 * unit)[0].tolist()
        raise AssertionError(
            f"K3: dalpha of chunk {c} photon {k} row {r} differs by "
            f"{float(delta[c, r, k])} (want {float(want[c, r, k])}, "
            f"{float(terms[c, 0, k])} terms)")
    err = float(delta.max())
    ulps = float((delta / unit.clamp(min=1e-30)).max())
    ms = cuda_ms(lambda: rg.rowspan_S_bwd(*args), 20)
    plain_ms = cuda_ms(lambda: rg.rowspan_S_bwd_plain(*args), 2)
    n_jobs = int(jobs["n_valid"])
    chunk = jobs["pdata"].shape[2]
    nq = jobs["qr2"].shape[0]
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
               **bound(gather_ops(n_jobs * rg.TILE_Q * chunk,
                                  float(want[:, 3].sum())),
                       nq * (7 + 3) * 4 + jobs["n_chunks"] * chunk * (7 + 4)
                       * 4 + n_jobs * 4 + jobs["n_chunks"] * 8),
               library_ms=None)
    emit("k3", jobs=n_jobs,
         chunks=jobs["n_chunks"], chunks_without_jobs=int(empty.sum()),
         terms=float(want[:, 3].sum()),
         max_dalpha=float(want[:, :3].max()), max_err_over_K_ulp=ulps, **row)
    return row


def phase_k4(dev, scene, cfg, rec, r2, k_photon):
    """K4 on the gather inputs of the preview's first wave: the full-size
    frame's queries with their unmasked starting radii (as the renderer
    passes them) against a compacted 2,048-path map."""
    pcfg = RenderConfig(**PREVIEW)
    photons = photon.trace_photons(scene, pcfg, k_photon, 0)
    pp, pa, pw, pv, n_valid = dg.compact_photons(photons)
    args = (rec.p.contiguous(), r2.contiguous(), rec.ns.contiguous(), pp, pa,
            pw, pv, n_valid)
    got = dg.dense_S(*args)
    want = dg.dense_S_plain(*args)
    torch.cuda.synchronize()
    err, ulps = flux_check("K4", got, want)
    ms = cuda_ms(lambda: dg.dense_S(*args), 20)
    plain_ms = cuda_ms(lambda: dg.dense_S_plain(*args), 2)
    n, nv = rec.p.shape[0], int(n_valid)
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
               **bound(gather_ops(n * nv, float(want[3].sum())),
                       n * (7 + 4) * 4 + nv * (9 * 4 + 1) + 4),
               library_ms=None)
    emit("k4", queries=n, slots=photons.p.shape[0], n_valid=nv,
         pair_tests=n * nv, max_flux=float(want[:3].abs().max()),
         max_err_over_M_ulp=ulps, **row)
    return row


def phase_k5(scene, cfg, rec, r2, k_photon):
    """K5 on the full-size frame's live queries against a 2^16-path wave,
    with the cell the largest live radius (JAX's contract)."""
    photons = photon.trace_photons(
        scene, dataclasses.replace(cfg, photon_paths=K5_PATHS), k_photon, 0)
    live_r2 = torch.where(rec.hit, r2, 0.0)
    cell = float(torch.sqrt(live_r2.max()))
    sp = gg.grid_spans(photons.p, photons.alpha, photons.wi, photons.valid,
                       cell, rec.p, live_r2, rec.ns)
    args = [sp[k] for k in ("lo_chunk", "nc", "qpT", "qr2", "qnsT", "pdata")]
    got = gg.grid_S(*args)
    want = gg.grid_S_plain(*args)
    torch.cuda.synchronize()
    err, ulps = flux_check("K5", got, want)
    ms = cuda_ms(lambda: gg.grid_S(*args), 5)
    plain_ms = cuda_ms(lambda: gg.grid_S_plain(*args), 1)
    nc = sp["nc"].to(torch.float64)
    n_chunks, _, chunk = sp["pdata"].shape
    nq = sp["qr2"].shape[0]
    pairs = int(nc.sum()) * gg.TILE_Q * chunk
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
               **bound(gather_ops(pairs, float(want[3].sum())),
                       nq * (7 + 4) * 4 + n_chunks * chunk * gg.ROWS * 4
                       + len(nc) * 8),
               library_ms=None)
    # no renderer calls K5 (as in JAX): its path is the public entry point,
    # driven once with the launch count reset around it
    kd = torch.full_like(rec.p, 0.25)
    gg.grid_S.launches = 0
    L, m = gg.gather_radius_grid(photons.p, photons.alpha, photons.wi,
                                 photons.valid, cell, rec.p, live_r2, rec.ns,
                                 kd)
    launches = gg.grid_S.launches
    unsort = torch.argsort(sp["qorder"])
    if not (launches == 1 and torch.equal(
            m, want[3, :rec.p.shape[0]][unsort].to(torch.int32))):
        raise AssertionError(f"K5: gather_radius_grid made {launches} "
                             "launches or counts other than the checked "
                             "ones")
    emit("k5", queries=rec.p.shape[0], slots=photons.p.shape[0],
         n_valid=int(photons.valid.sum()), cell=cell, tiles=len(nc),
         chunks=n_chunks, span_chunks_mean=float(nc.mean()),
         span_chunks_max=int(nc.max()), pair_tests=pairs,
         max_flux=float(want[:3].abs().max()), max_err_over_M_ulp=ulps,
         launches=launches, **row)
    return row, launches


def phase_reference(dev):
    """32×32 frame: kernels on the card vs plain versions on the CPU."""
    cfg = RenderConfig(**dict(BENCH, width=32, height=32,
                              photon_paths=1 << 12))
    imgs = []
    for device in (dev, "cpu"):
        scene, cam = presets.cornell_box(device, 32, ball="glass")
        imgs.append(photon.render_photon(scene, cam, cfg,
                                         prng.PRNGKey(0, device)).cpu())
    gpu, cpu = imgs
    rel_l1 = float((gpu - cpu).abs().sum() / cpu.abs().sum())
    off = float(((gpu - cpu).abs().amax(-1)
                 > 1e-3 * cpu.amax(-1).clamp(min=1.0)).float().mean())
    if not (torch.isfinite(gpu).all() and rel_l1 <= REF_REL_L1
            and off <= REF_OFF_FRAC):
        raise AssertionError(f"32x32 frame: rel L1 {rel_l1}, {off} of the "
                             "pixels off against the CPU reference")
    emit("reference", size=32, rel_l1=rel_l1, off_pixel_frac=off)


def phase_main(dev, scene, cam, cfg, frames=5):
    img = photon.render_photon(scene, cam, cfg, prng.PRNGKey(0, dev))
    torch.cuda.synchronize()  # warm-up: kernels loaded, allocator primed
    ti.closest_hit.launches = 0
    rg.rowspan_S.launches = 0
    times = []
    for i in range(frames):
        t0 = time.perf_counter()
        img, aux = photon.render_photon(scene, cam, cfg,
                                        prng.PRNGKey(i + 1, dev),
                                        return_aux=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {"k1": ti.closest_hit.launches, "k2": rg.rowspan_S.launches}
    valid = int(aux["valid_photons"])
    if img.shape != (SIZE, SIZE, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError("main path: image not finite or mis-shaped")
    if not float(img.mean()) > 0.0 or valid <= 0:
        raise AssertionError("main path: black image or no valid photons")
    if min(launches.values()) <= 0:
        raise AssertionError(f"main path skipped a kernel: {launches}")
    frame_s = statistics.median(times)
    emit("main", size=SIZE, photon_paths=cfg.photon_paths, frames=frames,
         frame_s=times, frame_s_median=frame_s,
         rays_per_s=SIZE * SIZE * cfg.spp / frame_s,
         photons_per_s=cfg.photon_paths / frame_s,
         valid_photons=valid, gather_overflow=int(aux["gather_overflow"]),
         pair_overflow=int(aux["pair_overflow"]),
         mean_radius2=float(aux["mean_radius2"]),
         image_mean=float(img.mean()), launches=launches)
    return launches, frame_s


def grad_config(cfg: RenderConfig) -> RenderConfig:
    """bench.py run_grad's settings: the headline frame, differentiable."""
    return dataclasses.replace(cfg, differentiable=True)


def phase_grad_reference(dev):
    """loss_and_grad of a 32×32 frame: kernels on the card vs plain
    versions on the CPU."""
    cfg = grad_config(RenderConfig(**dict(BENCH, width=32, height=32,
                                          photon_paths=1 << 12)))
    out = []
    for device in (dev, "cpu"):
        scene, cam = presets.cornell_box(device, 32, ball="glass")
        loss, g = diff.loss_and_grad(
            diff.extract_params(scene), torch.zeros((32, 32, 3),
                                                    device=device),
            scene, cam, cfg, prng.PRNGKey(0, device),
            common.static_light_samples(scene, cfg), jitter=False)
        out.append((float(loss), g.kd.cpu(), g.intensity.cpu()))
    (l_gpu, kd_gpu, in_gpu), (l_cpu, kd_cpu, in_cpu) = out
    rel = lambda a, b: float((a - b).abs().sum() / b.abs().sum())
    loss_rel = abs(l_gpu - l_cpu) / l_cpu
    kd_rel, in_rel = rel(kd_gpu, kd_cpu), rel(in_gpu, in_cpu)
    if not (torch.isfinite(kd_gpu).all() and torch.isfinite(in_gpu).all()
            and max(loss_rel, kd_rel, in_rel) <= GRAD_REL):
        raise AssertionError(f"32x32 loss_and_grad: loss {loss_rel}, kd "
                             f"{kd_rel}, intensity {in_rel} relative off "
                             "the CPU reference")
    emit("grad_reference", size=32, loss_rel=loss_rel, kd_rel_l1=kd_rel,
         intensity_rel_l1=in_rel)


def phase_grad(dev, scene, cam, cfg, steps=5):
    """loss_and_grad at the headline: a warm-up, then `steps` timed steps
    with keys folded from key 0 as bench.py run_grad does."""
    gcfg = grad_config(cfg)
    ls = common.static_light_samples(scene, gcfg)
    params = diff.extract_params(scene)
    target = torch.zeros((SIZE, SIZE, 3), device=dev)
    key = prng.PRNGKey(0, dev)
    diff.loss_and_grad(params, target, scene, cam, gcfg, key, ls, False)
    torch.cuda.synchronize()
    ti.closest_hit.launches = 0
    rg.rowspan_S.launches = 0
    rg.rowspan_S_bwd.launches = 0
    times = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i in range(steps):
            t0 = time.perf_counter()
            loss, g = diff.loss_and_grad(params, target, scene, cam, gcfg,
                                         prng.fold_in(key, i + 1), ls, False)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    launches = {"k1": ti.closest_hit.launches, "k2": rg.rowspan_S.launches,
                "k3": rg.rowspan_S_bwd.launches}
    overflows = [str(w.message) for w in caught if "overflow" in
                 str(w.message)]
    glass = scene.materials.mtype == GLASS
    if min(launches.values()) <= 0:
        raise AssertionError(f"grad path skipped a kernel: {launches}")
    if not (torch.isfinite(g.kd).all() and torch.isfinite(g.intensity).all()
            and float(g.kd.abs().sum()) > 0.0):
        raise AssertionError("grad path: gradients not finite, or kd's zero")
    if bool(g.kd[glass].any()):
        raise AssertionError(f"grad path: glass kd gradient {g.kd[glass]}")
    if overflows:
        raise AssertionError(f"grad path: gather overflow: {overflows}")
    step_s = statistics.median(times)
    emit("grad", size=SIZE, photon_paths=gcfg.photon_paths, steps=steps,
         step_s=times, step_s_median=step_s,
         grad_rays_per_s=SIZE * SIZE / step_s,
         grad_photons_per_s=gcfg.photon_paths / step_s,
         gather_overflow=0, loss=float(loss),
         grad_kd_abs_sum=float(g.kd.abs().sum()),
         grad_intensity=g.intensity.tolist(), launches=launches)
    return launches, step_s


def phase_train(dev, scene, cam, cfg, steps=3):
    """fit from a 1.8× over-bright emitter against the frame rendered at
    the true parameters with the same key."""
    gcfg = grad_config(cfg)
    ls = common.static_light_samples(scene, gcfg)
    true = diff.extract_params(scene)
    key = prng.PRNGKey(0, dev)
    with torch.no_grad():
        target = diff.render_image_from_params(true, scene, cam, gcfg, key,
                                               ls, jitter=False)
    start = dataclasses.replace(true, intensity=true.intensity * 1.8)
    times = []
    for n in (1, steps):  # a one-step warm-up: first-use costs excluded
        t0 = time.perf_counter()
        got, losses = optim.fit(start, target, scene, cam, gcfg, key,
                                steps=n, lr=0.1, light_samples=ls)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    train_s = times[-1]
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"train: loss did not fall: {losses}")
    emit("train", steps=steps, losses=losses, warmup_s=times[0],
         s_per_step=train_s / steps,
         intensity=got.intensity.tolist(),
         true_intensity=true.intensity.tolist())


def phase_preview(dev, scene, cam):
    """render_photon_progressive with 2,048 paths × 16 waves: every wave
    through K4 and none through K2; then 8 waves with a checkpoint, resumed
    to 16, against the uninterrupted render."""
    cfg = RenderConfig(**PREVIEW)
    key = prng.PRNGKey(0, dev)
    dg.dense_S.launches = 0
    rg.rowspan_S.launches = 0
    t0 = time.perf_counter()
    img, state, aux = photon.render_photon_progressive(scene, cam, cfg, key,
                                                       return_aux=True)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    launches = {"k4": dg.dense_S.launches, "k2": rg.rowspan_S.launches}
    if launches != {"k4": cfg.photon_passes, "k2": 0}:
        raise AssertionError(f"preview: launches {launches}, expected one "
                             "K4 launch per wave and no K2")
    if not (bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0):
        raise AssertionError("preview: image not finite or black")
    if int(aux["gather_overflow"]) or aux["pair_overflow"]:
        raise AssertionError(f"preview: overflow {aux}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ppm.ckpt")
        photon.render_photon_progressive(
            scene, cam, dataclasses.replace(cfg, photon_passes=8), key,
            checkpoint_path=path)
        img_res, state_res, aux_res = photon.render_photon_progressive(
            scene, cam, cfg, key, checkpoint_path=path, return_aux=True)
    unequal = [f.name for f in dataclasses.fields(state)
               if not torch.equal(getattr(state, f.name),
                                  getattr(state_res, f.name))]
    rel_l1 = float((img_res - img).abs().sum() / img.abs().sum())
    if unequal or len(aux_res["wave_s"]) != 8 or rel_l1 > RESUME_IMG_REL_L1:
        raise AssertionError(f"preview: resumed state differs in {unequal}, "
                             f"{len(aux_res['wave_s'])} waves resumed, image "
                             f"rel L1 {rel_l1}")
    wave_s = aux["wave_s"]
    emit("preview", size=SIZE, photon_paths=cfg.photon_paths,
         waves=cfg.photon_passes, render_s=render_s, wave_s=wave_s,
         wave_s_median_2_16=statistics.median(wave_s[1:]),
         photons_per_s=cfg.photon_paths / statistics.median(wave_s[1:]),
         launches=launches, resume_state_equal=True,
         resume_image_rel_l1=rel_l1, image_mean=float(img.mean()))
    return launches, render_s


class _WaveLog(logging.Handler):
    """Collects the mean radius² of each `log_pass` wave line."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.radius2 = []

    def emit(self, record):
        found = re.search(r"mean_radius2=(\S+)", record.getMessage())
        if found:
            self.radius2.append(float(found.group(1)))


def phase_progressive(dev, scene, cam):
    """render_photon_progressive at bench.py run_multiwave's settings: the
    steady wave median (waves 2-8), photons/s and the radius trace."""
    cfg = RenderConfig(**MULTIWAVE)
    rg.rowspan_S.launches = 0
    log = _WaveLog()
    logger = logging.getLogger("raytrace_tpu_torch")
    logger.addHandler(log)
    logger.setLevel(logging.INFO)
    try:
        img, state, aux = photon.render_photon_progressive(
            scene, cam, cfg, prng.PRNGKey(0, dev), verbose=True,
            return_aux=True)
    finally:
        logger.removeHandler(log)
    k2 = rg.rowspan_S.launches
    if k2 <= 0:
        raise AssertionError("progressive: K2 was not launched")
    if int(aux["gather_overflow"]) or aux["pair_overflow"]:
        raise AssertionError(f"progressive: overflow {aux}")
    if not (bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0):
        raise AssertionError("progressive: image not finite or black")
    if len(log.radius2) != cfg.photon_passes:
        raise AssertionError(f"progressive: {len(log.radius2)} wave lines")
    steady = statistics.median(aux["wave_s"][1:])
    emit("progressive", size=SIZE, photon_paths=cfg.photon_paths,
         waves=cfg.photon_passes, wave_s=aux["wave_s"],
         wave_s_median_2_8=steady, photons_per_s=cfg.photon_paths / steady,
         mean_radius2_trace=log.radius2, gather_overflow=0, pair_overflow=0,
         launches={"k2": k2}, image_mean=float(img.mean()))


def phase_simple(dev, frames=5):
    """render_simple on the 256×256 sphere and plane, and a 32×32 frame on
    the card against the CPU's."""
    cfg = RenderConfig(**SIMPLE)
    scene, cam = presets.sphere_plane(dev, SIMPLE["width"])
    simple.render_simple(scene, cam, cfg, prng.PRNGKey(0, dev))
    torch.cuda.synchronize()
    ti.closest_hit.launches = 0
    times = []
    for i in range(frames):
        t0 = time.perf_counter()
        img = simple.render_simple(scene, cam, cfg, prng.PRNGKey(i + 1, dev))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    k1 = ti.closest_hit.launches
    if k1 <= 0:
        raise AssertionError("simple: K1 was not launched")
    if not (bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0):
        raise AssertionError("simple: image not finite or black")
    small = dataclasses.replace(cfg, width=32, height=32)
    imgs = []
    for device in (dev, "cpu"):
        sc, cm = presets.sphere_plane(device, 32)
        imgs.append(simple.render_simple(sc, cm, small,
                                         prng.PRNGKey(0, device)).cpu())
    gpu, cpu = imgs
    rel_l1 = float((gpu - cpu).abs().sum() / cpu.abs().sum())
    off = float(((gpu - cpu).abs().amax(-1)
                 > 1e-3 * cpu.amax(-1).clamp(min=1.0)).float().mean())
    if rel_l1 > REF_REL_L1 or off > REF_OFF_FRAC:
        raise AssertionError(f"simple 32x32: rel L1 {rel_l1}, {off} of the "
                             "pixels off against the CPU")
    frame_s = statistics.median(times)
    emit("simple", size=SIMPLE["width"], spp=cfg.spp, frames=frames,
         frame_s=times, frame_s_median=frame_s,
         rays_per_s=SIMPLE["width"] * SIMPLE["height"] * cfg.spp / frame_s,
         launches={"k1": k1}, image_mean=float(img.mean()),
         reference_rel_l1=rel_l1, reference_off_pixel_frac=off)
    return scene, cam, frame_s


def profile_step(phase: str, fn, wall_s: float, path: str) -> None:
    """fn() once under torch.profiler: device time by kernel, written to
    `path`, and the device's busy share of wall_s, the unprofiled median of
    the same step (the profiler's own overhead inflates its wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    busy_s = sum(e.device_time_total for e in prof.events()
                 if e.device_type == DeviceType.CUDA) / 1e6
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=60))
    emit(phase, device_busy_s=busy_s, wall_s=wall_s,
         device_idle_frac=1.0 - busy_s / wall_s)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="FILE",
                    help="write per-kernel device-time tables of one frame "
                         "(FILE), one gradient step (FILE.grad), one "
                         "16-wave preview render (FILE.preview) and one "
                         "simple frame (FILE.simple)")
    args = ap.parse_args()
    # the kernels must be built from this checkout's sources, not from a
    # copy of the package installed elsewhere
    pkg_root = Path(raytrace_tpu_torch.__file__).resolve().parent.parent
    if pkg_root != Path(__file__).resolve().parent:
        raise RuntimeError(f"raytrace_tpu_torch was imported from {pkg_root}, "
                           "not from the checkout that holds chip_smoke.py")
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    emit("device", nvidia_smi=card, name=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda)

    phase_build()
    cfg = RenderConfig(**BENCH)
    scene, cam = presets.cornell_box(dev, SIZE, ball="glass")
    k1 = phase_k1(dev, scene)
    rec, r2, k_photon = headline_records(dev, scene, cam, cfg)
    jobs, queries, photons = gather_jobs(scene, cfg, rec, r2, k_photon)
    k2 = phase_k2(jobs, queries, photons)
    k3 = phase_k3(dev, jobs)
    del jobs
    k4 = phase_k4(dev, scene, cfg, rec, r2, k_photon)
    k5, k5_launches = phase_k5(scene, cfg, rec, r2, k_photon)
    del rec, r2
    phase_reference(dev)
    launches, frame_s = phase_main(dev, scene, cam, cfg)
    phase_grad_reference(dev)
    grad_launches, step_s = phase_grad(dev, scene, cam, cfg)
    phase_train(dev, scene, cam, cfg)
    preview_launches, preview_s = phase_preview(dev, scene, cam)
    phase_progressive(dev, scene, cam)
    sp_scene, sp_cam, simple_s = phase_simple(dev)
    if args.profile:
        profile_step("profile", lambda: photon.render_photon(
            scene, cam, cfg, prng.PRNGKey(9, dev)), frame_s, args.profile)
        gcfg = grad_config(cfg)
        profile_step("profile_grad", lambda: diff.loss_and_grad(
            diff.extract_params(scene), torch.zeros((SIZE, SIZE, 3),
                                                    device=dev),
            scene, cam, gcfg, prng.PRNGKey(9, dev),
            common.static_light_samples(scene, gcfg), False), step_s,
            args.profile + ".grad")
        profile_step(
            "profile_preview", lambda: photon.render_photon_progressive(
                scene, cam, RenderConfig(**PREVIEW), prng.PRNGKey(9, dev)),
            preview_s, args.profile + ".preview")
        profile_step("profile_simple", lambda: simple.render_simple(
            sp_scene, sp_cam, RenderConfig(**SIMPLE), prng.PRNGKey(9, dev)),
            simple_s, args.profile + ".simple")

    # launches: K1 and K2 over the forward frames of phase main, K3 over
    # the gradient steps of phase grad, K4 over the 16-wave preview render;
    # no renderer calls K5 (as in JAX), so its count is phase k5's call of
    # gather_radius_grid
    rows = [("tri_closest", "raytrace_tpu_torch/csrc/tri_intersect.cu",
             "raytrace_tpu/ops/pallas_intersect.py:42", "main",
             launches["k1"], k1),
            ("rowspan_gather", "raytrace_tpu_torch/csrc/rowspan_gather.cu",
             "raytrace_tpu/ops/pallas_gather.py:393", "main",
             launches["k2"], k2),
            ("rowspan_gather_bwd",
             "raytrace_tpu_torch/csrc/rowspan_gather_bwd.cu",
             "raytrace_tpu/ops/pallas_gather.py:432", "grad",
             grad_launches["k3"], k3),
            ("dense_gather", "raytrace_tpu_torch/csrc/dense_gather.cu",
             "raytrace_tpu/ops/pallas_gather.py:33", "preview",
             preview_launches["k4"], k4),
            ("grid_gather", "raytrace_tpu_torch/csrc/grid_gather.cu",
             "raytrace_tpu/ops/pallas_gather.py:185",
             "none, as in JAX (gather_radius_grid in phase k5)", k5_launches,
             k5)]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "path": path, "launches": n, **row}
        for name, src, rep, path, n, row in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
