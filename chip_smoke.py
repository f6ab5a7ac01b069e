"""Smoke run of the PyTorch/CUDA port (raytrace_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                   # the whole check, a few minutes
    python3 chip_smoke.py --profile FILE    # also torch.profiler tables of a
                                            # frame, a gradient step, a
                                            # preview render, a simple
                                            # frame and a large frame,
                                            # written to FILE*

Phases, one JSON result line each:
  1. device     the card's name and power limit; raises without CUDA
  2. build      nvcc builds kernels K1-K9 from
                raytrace_tpu_torch/csrc, and g++ the host BVH builder, one
                compiler process per source, all at once
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
The large-scene path (BASELINE config[4], 4,194,304 triangles):
 16. build_large  host time of triangle_field(1 << 22, 512): the SAH build,
                the cluster set and the upload; node and cluster counts
 17. k8, k9     K8 (epoch cull) and K9 (subtile Möller–Trumbore) against
                their plain versions on the frame's own launches, captured
                from the epoch engine, a row per epoch: the camera launch
                (262,144 rays) in full and the photon emission launch
                (4,194,304 rays) on 2,048 tiles spread over it and on its
                first 65,536 jobs; mask bytes, t and idx equal; the tests
                left after K8's exact pre-cull and the warps that skip, the
                (job, triangle) pairs past K9's gate, and a bound on that
                work beside the bound on all tests; K9 also on the camera
                list shifted by one job and shuffled, K8 also on the
                adversarial inputs of tests/test_torch_epoch_precull.py
 18. engine     the epoch engine against the BVH traversal on the camera
                launch: t within 1e-5, idx differences counted, overflow 0
 19. k6, k7     K6 (tile cull) and K7 (pair Möller–Trumbore) against their
                plain versions on every call of one run_triangle_field frame
                (its camera and shadow launches, captured from the cluster
                engine): K6's mask in full, K7's (t, idx) on the pairs of
                the first 256 tiles; equal
 20. cluster_engine  the cluster engine against the epoch engine on the same
                two launches: overflow 0, flips and t bounded, idx
                differences counted, each engine timed per launch
 21. large_simple  render_simple at bench.py run_triangle_field's settings
                (512², 1 spp) on the same scene: a warm-up and 3 frames,
                every launch coherent, so K6 and K7 and no K8 or K9
 22. large      render_photon at bench.py run_combined's settings (2^22
                paths, 16.8M slots): a 32×32 triangle_field(2048) frame on
                the card against the CPU's, a warm-up and 2 frames with K6,
                K7, K8, K9 and K2 launch counts, and one profiled frame
                (device busy share, K6-K9 and K2 device ms)
Then the kernel table as one JSON line, the card line from nvidia-smi, and
last {"ok": true, "device": {...}}. Any failed check raises, so the script
exits non-zero and prints no final line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
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
from raytrace_tpu_torch.ops import bvh as bvh_ops
from raytrace_tpu_torch.ops import cluster_intersect as ci
from raytrace_tpu_torch.ops import cluster_kernels as ck
from raytrace_tpu_torch.ops import cuda_lib
from raytrace_tpu_torch.ops import dense_gather as dg
from raytrace_tpu_torch.ops import epoch_intersect as ei
from raytrace_tpu_torch.ops import epoch_kernels as ek
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
# BASELINE config[4] as bench.py run_combined renders it (bench.py:237-262):
# triangle_field(1 << 22, 512), 2^22 paths × 4 deposits = 16.8M slots
LARGE_TRIS = 1 << 22
LARGE = dict(BENCH, photon_paths=1 << 22, initial_radius2=0.04)
# bench.py run_triangle_field's settings (bench.py:377-390), on that scene
LARGE_SIMPLE = dict(width=SIZE, height=SIZE, spp=1, scene_epsilon=1e-3)
# the emission launch's kernels are held against their plain versions on
# tiles spread over the launch (K8) and on its first jobs (K9): the whole
# takes the plain versions tens of seconds
EMISSION_CHECK_TILES = 2048
EMISSION_CHECK_JOBS = 1 << 16
# K9 on a shuffled slice of the camera launch's job list
K9_SHUFFLED_JOBS = 1 << 13
# K7 is held against its plain version on the pairs of this many tiles of
# a launch, spread evenly: all of a config[4] launch's ~1e10 tests take
# the plain version seconds
K7_CHECK_TILES = 256
# the epoch engine against the BVH traversal: both exact, the same
# arithmetic per triangle; t within 1e-5 relative where both hit, at most a
# 1e-4 share of the rays hit on one side only
ENGINE_RTOL, ENGINE_FLIP_FRAC = 1e-5, 1e-4
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
# K8's ray-box test (csrc/epoch_cull.cu): 6 differences, 6 products, 3 min
# and 3 max per slab, 2 max and 2 min across the slabs, the clamp to tmin,
# 5 compares and 4 ands; K9's ray-triangle test is K1's. K6's ray-box test
# (csrc/cluster_cull.cu) is K8's without the clamp and the window: 6
# differences, 6 products, 6 + 4 min/max, 3 compares, 2 ands; K7's
# ray-triangle test is K1's
K8_TEST_OPS = 32
K9_PAIR_OPS = K1_PAIR_OPS
# what K9's function needs of that test: pvec, det, inverse, tvec, beta and
# the bounds and running best (32) for every test of a job with a live lane;
# qvec, gamma and t (21) only for a (job, triangle) where a live lane has
# det != 0 and 0 <= beta <= 1, since a hit needs both
K9_GATE_OPS = 9 + 5 + 2 + 3 + 6 + 7
K9_TAIL_OPS = K9_PAIR_OPS - K9_GATE_OPS
# elements per step of that count, as the plain version steps
K9_GATE_STEP = 1 << 25
K6_TEST_OPS = 27
K7_PAIR_OPS = K1_PAIR_OPS
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

    def timed_host(name):
        t1 = time.perf_counter()
        cuda_lib.build_host(name)
        return time.perf_counter() - t1

    t0 = time.perf_counter()
    names = ("tri_intersect", "rowspan_gather", "rowspan_gather_bwd",
             "dense_gather", "grid_gather", "cluster_cull", "cluster_pair",
             "epoch_cull", "epoch_mt")
    with ThreadPoolExecutor(len(names) + 1) as pool:
        host = pool.submit(timed_host, "bvh_builder")
        secs = dict(zip(names, pool.map(timed, names)))
        secs["bvh_builder"] = host.result()
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


class _BuildLog(logging.Handler):
    """Collects the fields of the builder's `scene_build` line."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.fields = {}

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("pass=scene_build "):
            self.fields = dict(kv.split("=", 1) for kv in msg.split()[1:])


def phase_build_large(dev):
    """triangle_field(1 << 22, 512) on the card: host seconds of the whole
    build and of its SAH build, cluster set and upload (the builder's
    scene_build line)."""
    log = _BuildLog()
    logger = logging.getLogger("raytrace_tpu_torch")
    logger.addHandler(log)
    logger.setLevel(logging.INFO)
    try:
        t0 = time.perf_counter()
        scene, cam = presets.triangle_field(dev, LARGE_TRIS, SIZE)
        total_s = time.perf_counter() - t0
    finally:
        logger.removeHandler(log)
    f = log.fields
    if int(f["triangles"]) != LARGE_TRIS or scene.clusters is None:
        raise AssertionError(f"build_large: {f}")
    emit("build_large", triangles=LARGE_TRIS, nodes=int(f["nodes"]),
         clusters=int(f["clusters"]),
         cluster_size=int(scene.clusters.tv.shape[2]),
         bvh_max_depth=scene.bvh.max_depth, total_s=total_s,
         bvh_s=float(f["bvh_s"]), clusters_s=float(f["clusters_s"]),
         upload_s=float(f["upload_s"]))
    return scene, cam


@contextlib.contextmanager
def recording(module, name):
    """Swap the function module.<name> (a kernel wrapper or an engine) for
    one that keeps each call's (positional arguments, keyword arguments) in
    the list yielded; a wrapper's launch count carries over."""
    orig = getattr(module, name)
    calls = []

    def rec(*args, **kw):
        calls.append((args, kw))
        return orig(*args, **kw)

    rec.launches = getattr(orig, "launches", 0)
    setattr(module, name, rec)
    try:
        yield calls
    finally:
        if hasattr(orig, "launches"):
            orig.launches = rec.launches
        setattr(module, name, orig)


def large_launches(dev, scene, cam, cfg):
    """The large frame's first camera launch and its photon emission launch
    as render_photon casts them with key 0 → [(name, o, d, tmin, tmax)]."""
    keys = prng.split(prng.PRNGKey(0, dev), 3)
    xy, lens = pixel_samples(keys[0], cfg.width, cfg.height, cfg.spp)
    rays = generate_rays(cam, xy, lens, cfg.spp)
    em = photon.emission(scene, cfg, keys[2], 0)
    full = lambda x, v: torch.full((x.shape[0],), v, device=dev)
    return [("camera", rays.o, rays.d, full(rays.o, cfg.scene_epsilon),
             full(rays.o, BIG)),
            ("emission", em["o"], em["d"], full(em["o"], cfg.scene_epsilon),
             torch.where(em["alive"], BIG, 0.0))]


def spread(n: int, k: int | None, dev) -> torch.Tensor:
    """k indices spread evenly over range(n) (all n when k is None)."""
    if k is None or k >= n:
        return torch.arange(n, device=dev)
    return torch.arange(k, device=dev) * n // k


def _k8_case(label, epoch, args, tiles, iters):
    """K8 on one captured call against the plain version on `tiles` tiles
    spread evenly over the launch (all of them when None): the sort can
    put a photon launch's sky-bound rays, which the pre-cull skips, on
    whole runs of tiles. Counts the tests left after the exact pre-cull
    (`precull_plain` on the launch's own inputs: every padding cluster,
    and every real cluster for the live subtiles with a ray that may hit)
    and bounds the kernel on them and on all tests of the live tiles."""
    o, inv, tmin, tbest, w0, w1, cmin, cmax, n_live, box, n_real = args
    got = ek.cull_bits(*args)
    n_tiles = got.shape[1]
    sel = spread(n_tiles, tiles, o.device)
    rays = (sel[:, None] * ek.TILE
            + torch.arange(ek.TILE, device=o.device)).reshape(-1)
    live = int(n_live)
    # liveness is a prefix, so the live tiles of sel are a prefix of it
    live_sel = int((sel * ek.TILE < live).sum())
    part = ([a[rays] for a in args[:6]]
            + [cmin, cmax, torch.tensor([live_sel * ek.TILE],
                                        dtype=torch.int32, device=o.device)])
    want = ek.cull_bits_plain(*part)
    torch.cuda.synchronize()
    bad = int((got[:, sel] != want).sum())
    if bad:
        raise AssertionError(f"K8 {label} epoch {epoch}: {bad} mask bytes "
                             "differ from the plain version")
    ms = cuda_ms(lambda: ek.cull_bits(*args), iters)
    plain_ms = cuda_ms(lambda: ek.cull_bits_plain(*part), 1)
    n_clusters = cmin.shape[0]
    live_tiles = -(-live // ek.TILE)
    live_rays = live_tiles * ek.TILE
    may = ek.precull_plain(o, inv, tmin, tbest, w0, w1, box)[:live_rays]
    sub_may = int(may.reshape(-1, ek.SUB).any(1).sum())
    tests = live_rays * n_clusters
    precull_tests = ek.SUB * (live_rays // ek.SUB * (n_clusters - n_real)
                              + sub_may * n_real)
    warp_skip = ~may.reshape(-1, ek.CULL_WARP_RAYS).any(1)
    sel_live = sel[:live_sel]
    warps_per_tile = ek.TILE // ek.CULL_WARP_RAYS
    checked = (sel_live[:, None] * warps_per_tile
               + torch.arange(warps_per_tile, device=o.device)).reshape(-1)
    nbytes = o.shape[0] * 10 * 4 + n_clusters * (6 * 4 + n_tiles) + 4
    full = bound(K8_TEST_OPS * tests, nbytes)
    row = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
               **bound(K8_TEST_OPS * precull_tests, nbytes),
               bound_all_tests_ms=full["bound_ms"], library_ms=None)
    emit("k8", launch=label, epoch=epoch, rays=o.shape[0], tiles=n_tiles,
         live_tiles=live_tiles, clusters=n_clusters, real_clusters=n_real,
         tests=tests, tests_after_precull=precull_tests,
         subtiles_may_hit=sub_may, warps=warp_skip.numel(),
         warps_skipped=int(warp_skip.sum()), checked_tiles=sel.numel(),
         checked_warps=checked.numel(),
         checked_warps_skipped=int(warp_skip[checked].sum()),
         set_bytes=int((got != 0).sum()),
         plain_on_checked_tiles=sel.numel() < n_tiles, **row)
    return row


def _k9_gate_pairs(args) -> int:
    """(job, triangle) pairs of one K9 call where a live lane (tmin < tmax)
    has det != 0 and 0 <= beta <= 1: the plain version's first half of the
    test, its operations in its order, on the call's own inputs."""
    job_cluster, job_subtile, o, d, tmin, tmax, tv = args
    n_jobs, s = job_cluster.shape[0], tv.shape[2]
    lanes = torch.arange(ek.SUB, device=o.device)
    live = tmin < tmax
    count = torch.zeros((), dtype=torch.int64, device=o.device)
    step = max(1, K9_GATE_STEP // (ek.SUB * s))
    for j0 in range(0, n_jobs, step):
        cl = job_cluster[j0:j0 + step].long()
        ray = job_subtile[j0:j0 + step].long()[:, None] * ek.SUB + lanes
        r = lambda a: a[ray][..., None]  # [Jc, 32, 1]
        v = [x[:, None, :] for x in tv[cl].unbind(1)]  # each [Jc, 1, S]
        e1x, e1y, e1z = v[3] - v[0], v[4] - v[1], v[5] - v[2]
        e2x, e2y, e2z = v[6] - v[0], v[7] - v[1], v[8] - v[2]
        dx, dy, dz = r(d[:, 0]), r(d[:, 1]), r(d[:, 2])
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        inv_det = torch.where(det != 0.0,
                              1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
        beta = (((r(o[:, 0]) - v[0]) * px + (r(o[:, 1]) - v[1]) * py
                 + (r(o[:, 2]) - v[2]) * pz) * inv_det)
        gate = (det != 0.0) & (beta >= 0.0) & (beta <= 1.0) & r(live)
        count += gate.any(1).sum()
    return int(count)


def _k9_case(label, epoch, args, jobs, iters, order="engine"):
    """K9 on one captured call against the plain version on its first
    `jobs` jobs (all of them when None). Bounds the kernel on all tests and
    on the work its function needs on this call's data: the first half of
    every test of a job with a live lane, the second half only where a
    live lane passes the gate (`_k9_gate_pairs`)."""
    job_cluster, job_subtile, o, d, tmin, tmax, tv = args
    t_got, i_got = ek.mt_jobs(*args)
    n_jobs = job_cluster.shape[0]
    jobs = n_jobs if jobs is None else min(jobs, n_jobs)
    part = (job_cluster[:jobs], job_subtile[:jobs]) + args[2:]
    t_want, i_want = ek.mt_jobs_plain(*part)
    torch.cuda.synchronize()
    if not (torch.equal(t_got[:jobs], t_want)
            and torch.equal(i_got[:jobs], i_want)):
        bad = int(((t_got[:jobs] != t_want) | (i_got[:jobs] != i_want)).sum())
        raise AssertionError(f"K9 {label} epoch {epoch} ({order} jobs): "
                             f"(t, idx) of {bad} rows differ from the plain "
                             "version")
    ms = cuda_ms(lambda: ek.mt_jobs(*args), iters)
    plain_ms = cuda_ms(lambda: ek.mt_jobs_plain(*part), 1)
    s = tv.shape[2]
    pairs = n_jobs * ek.SUB * s
    ray = (job_subtile.long()[:, None] * ek.SUB
           + torch.arange(ek.SUB, device=o.device))
    live_jobs = int((tmin[ray] < tmax[ray]).any(1).sum())
    gate_pairs = _k9_gate_pairs(args)
    gate_tests, tail_tests = live_jobs * ek.SUB * s, gate_pairs * ek.SUB
    nbytes = (n_jobs * 8 + o.shape[0] * 8 * 4 + tv.numel() * 4
              + n_jobs * ek.SUB * 8)
    full = bound(K9_PAIR_OPS * pairs, nbytes)
    row = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
               **bound(K9_GATE_OPS * gate_tests + K9_TAIL_OPS * tail_tests,
                       nbytes),
               bound_all_tests_ms=full["bound_ms"], library_ms=None)
    emit("k9", launch=label, epoch=epoch, order=order, jobs=n_jobs,
         live_jobs=live_jobs, triangles_per_job=s, pair_tests=pairs,
         gate_tests=gate_tests, gate_pairs=gate_pairs,
         tail_tests=tail_tests, tail_share=tail_tests / max(gate_tests, 1),
         hits=int((t_got < BIG).sum()), checked_jobs=jobs,
         plain_on_checked_jobs=jobs < n_jobs, **row)
    return row


def _k9_unaligned(args):
    """K9 on job lists the engine never builds, against the plain version
    in full: the captured list shifted by one job (every group of four
    straddles two runs where a cluster's run ends) and a shuffled slice of
    it (groups name several clusters)."""
    job_cluster, job_subtile = args[:2]
    n = job_cluster.shape[0]
    g = torch.Generator(device=job_cluster.device).manual_seed(7)
    perm = torch.randperm(n, generator=g, device=job_cluster.device)
    perm = perm[:K9_SHUFFLED_JOBS]
    for order, sel in (("shifted", slice(1, None)), ("shuffled", perm)):
        _k9_case("camera", 0, (job_cluster[sel].contiguous(),
                               job_subtile[sel].contiguous()) + args[2:],
                 None, 3, order)


def _k8_adversarial(dev):
    """K8 on the card, with its pre-cull, against the plain version on the
    CPU, byte for byte, on the inputs tests/test_torch_epoch_precull.py
    builds: NaN and infinite origins, zero and denormal directions, origins
    on face planes, grazing rays, epochs 0 and 1, 96 real and 32 padding
    clusters. The rays are grouped as the pre-cull sees them (dropped, kept
    only for a NaN in the scene-box test, kept) so that whole warps skip
    and whole warps stand on the NaN rule alone. Each case runs three ways:
    all rays live; 83 clusters taken as real (the boundary inside a 32-box
    word) with a dead tail; and 7 tiles (the unaligned byte stores) with a
    dead tail. One row per case and way: the warps (128 rays of a live
    tile) that skip, and those kept by NaN alone that hit a real cluster."""
    path = Path(__file__).resolve().parent / "tests" / \
        "test_torch_epoch_precull.py"
    spec = importlib.util.spec_from_file_location("precull_cases", path)
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    skipped_total = nan_hit_total = 0
    warp = lambda x: x.reshape(-1, ek.CULL_WARP_RAYS).any(1)
    for name in cases.CASES:
        *arrays, n_real = cases._case(name)
        *rays, cmin, cmax, _ = cases._tensors(*arrays, n_real)
        n = rays[0].shape[0]
        for real, n_rays, live in ((n_real, n, n), (83, n, n - 300),
                                   (n_real, n - ek.TILE, n - ek.TILE - 100)):
            box = torch.stack([cmin[:real].amin(0), cmax[:real].amax(0)])
            may = ek.precull_plain(*rays, box)
            nan = torch.isnan(ek._slab(rays[0], rays[1], box[:1],
                                       box[1:])[0][:, 0])
            key = torch.where(may, torch.where(nan, 1, 2), 0)
            order = torch.argsort(key, stable=True)[:n_rays]
            host = [a[order] for a in rays] + [cmin, cmax]
            n_live = torch.tensor([live], dtype=torch.int32)
            want = ek.cull_bits_plain(*host, n_live)
            got = ek.cull_bits(*[a.to(dev) for a in host], n_live.to(dev),
                               box.to(dev), real).cpu()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"K8 {name} ({real} real clusters, {n_rays} rays, "
                    f"{live} live): {int((got != want).sum())} mask bytes "
                    "differ from the plain version")
            live_rays = -(-live // ek.TILE) * ek.TILE
            may, key = may[order][:live_rays], key[order][:live_rays]
            hits = ek._cull_hits(*host[:6], cmin[:real], cmax[:real]).any(1)
            skipped = int((~warp(may)).sum())
            nan_hit = int((warp(key == 1) & ~warp(key == 2)
                           & warp(hits[:live_rays])).sum())
            skipped_total += skipped
            nan_hit_total += nan_hit
            emit("k8_adversarial", case=name, real_clusters=real,
                 rays=n_rays, live=live, warps=may.numel()
                 // ek.CULL_WARP_RAYS, warps_skipped=skipped,
                 nan_only_warps_hitting=nan_hit,
                 set_bytes=int((want != 0).sum()), equal=True)
    if not (skipped_total and nan_hit_total):
        raise AssertionError(f"K8 adversarial cases: {skipped_total} warps "
                             f"skipped, {nan_hit_total} kept by NaN alone "
                             "hit")


def phase_k8_k9(launches, scene):
    """The epoch engine on the frame's camera and emission launches, with
    every K8 and K9 call captured and held against the plain version, one
    row per epoch; K9 also on unaligned job lists; K8 also on adversarial
    inputs → (K8 row, K9 row, camera launch result) for the kernel table:
    the camera launch's first epoch, checked in full."""
    _k8_adversarial(launches[0][1].device)
    rows, camera = {}, None
    for label, o, d, tmin, tmax in launches:
        with recording(ek, "cull_bits") as k8_calls, \
                recording(ek, "mt_jobs") as k9_calls:
            res = ei.intersect_epochs(scene.clusters, o, d, tmin, tmax)
        if int(res[3]):
            raise AssertionError(f"{label} launch: pair overflow "
                                 f"{int(res[3])}")
        if not (k8_calls and k9_calls):
            raise AssertionError(f"{label} launch: K8 called "
                                 f"{len(k8_calls)}, K9 {len(k9_calls)} times")
        full = label == "camera"
        for e, (args, _) in enumerate(k8_calls):
            row = _k8_case(label, e, args,
                           None if full else EMISSION_CHECK_TILES,
                           10 if full else 3)
            rows.setdefault(("k8", label), row)
        for e, (args, _) in enumerate(k9_calls):
            row = _k9_case(label, e, args,
                           None if full else EMISSION_CHECK_JOBS,
                           10 if full else 3)
            rows.setdefault(("k9", label), row)
        if full:
            _k9_unaligned(k9_calls[0][0])
            camera = (o, d, tmin, tmax, res)
        del k8_calls, k9_calls
    return rows[("k8", "camera")], rows[("k9", "camera")], camera


def phase_engine(scene, camera):
    """The epoch engine's camera launch against the BVH traversal."""
    o, d, tmin, tmax, (t_e, i_e, n_sp, ovf) = camera
    t0 = time.perf_counter()
    t_b, i_b = bvh_ops._traverse(scene.bvh, scene.tris, o, d, tmin, tmax,
                                 any_hit=False)
    torch.cuda.synchronize()
    traverse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ei.intersect_epochs(scene.clusters, o, d, tmin, tmax)
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    hit_e, hit_b = t_e < BIG, t_b < BIG
    flips = int((hit_e != hit_b).sum())
    both = hit_e & hit_b
    rel = float(((t_e - t_b).abs() / t_b.abs().clamp(min=1e-30))[both].max())
    idx_differ = int((both & (i_e != i_b)).sum())
    if (int(ovf) or flips > ENGINE_FLIP_FRAC * o.shape[0]
            or rel > ENGINE_RTOL):
        raise AssertionError(f"engine: overflow {int(ovf)}, {flips} flips, "
                             f"t off by {rel} relative")
    emit("engine", rays=o.shape[0], hits=int(both.sum()), flips=flips,
         max_t_rel_err=rel, idx_differ=idx_differ, n_subpairs=int(n_sp),
         pair_overflow=0, engine_s=engine_s, bvh_traverse_s=traverse_s)


def _k6_case(label, args, iters):
    """K6 on one captured call against the plain version, in full →
    (row, mask with the seed column set)."""
    o, d, tmin, tmax, cmin, cmax, tile_rays = args
    got = ck.cull_tiles(*args)
    want = ck.cull_tiles_plain(*args)
    torch.cuda.synchronize()
    bad = int((got != want).sum())
    if bad:
        raise AssertionError(f"K6 {label}: {bad} mask bytes differ from the "
                             "plain version")
    ms = cuda_ms(lambda: ck.cull_tiles(*args), iters)
    plain_ms = cuda_ms(lambda: ck.cull_tiles_plain(*args), 1)
    n_tiles, n_clusters = got.shape
    tests = o.shape[0] * n_clusters
    row = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
               **bound(K6_TEST_OPS * tests,
                       o.shape[0] * 8 * 4 + n_clusters * 6 * 4
                       + n_tiles * n_clusters), library_ms=None)
    got[:, 0] = 1  # the engine's seed pairs
    emit("k6", launch=label, rays=o.shape[0], tile_rays=tile_rays,
         tiles=n_tiles, clusters=n_clusters, tests=tests,
         set_bytes=int((want != 0).sum()), **row)
    return row, got


def _k7_case(label, args, mask, capacity, iters):
    """K7 on one captured call against the plain version on the pairs of
    K7_CHECK_TILES tiles spread evenly over the launch (its first tiles
    can be all sky); n_pairs and overflow from the launch's mask (seeds
    set) and the engine's capacity."""
    pair_cluster, begin, end, o, d, tmin, tmax, tv = args
    t_got, i_got = ck.pair_hits(*args)
    n_tiles = begin.shape[0]
    tile_rays = o.shape[0] // n_tiles
    sel = spread(n_tiles, K7_CHECK_TILES, o.device)
    rays = (sel[:, None] * tile_rays
            + torch.arange(tile_rays, device=o.device)).reshape(-1)
    part = (pair_cluster, begin[sel], end[sel], o[rays], d[rays], tmin[rays],
            tmax[rays], tv)
    t_want, i_want = ck.pair_hits_plain(*part)
    torch.cuda.synchronize()
    if not (torch.equal(t_got[rays], t_want)
            and torch.equal(i_got[rays], i_want)):
        bad = int(((t_got[rays] != t_want) | (i_got[rays] != i_want)).sum())
        raise AssertionError(f"K7 {label}: (t, idx) of {bad} rays differ "
                             "from the plain version")
    n_pairs = int(mask.count_nonzero())
    overflow = max(n_pairs - capacity, 0)
    if overflow:
        raise AssertionError(f"K7 {label}: pair overflow {overflow}")
    ms = cuda_ms(lambda: ck.pair_hits(*args), iters)
    plain_ms = cuda_ms(lambda: ck.pair_hits_plain(*part), 1)
    kept = int((end - begin).sum())  # the pairs run: real clusters only
    s = tv.shape[2]
    tests = kept * tile_rays * s
    row = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
               **bound(K7_PAIR_OPS * tests,
                       pair_cluster.shape[0] * 4 + n_tiles * 8
                       + o.shape[0] * 8 * 4 + tv.numel() * 4
                       + o.shape[0] * 8), library_ms=None)
    emit("k7", launch=label, rays=o.shape[0], tiles=n_tiles,
         clusters=tv.shape[0], kept_pairs=kept, n_pairs=n_pairs,
         overflow=overflow, pair_tests=tests, triangles_per_pair=s,
         hits=int((t_got < BIG).sum()), checked_tiles=sel.shape[0],
         checked_pairs=int((end[sel] - begin[sel]).sum()), **row)
    return row


def phase_k6_k7(dev, scene, cam):
    """One run_triangle_field frame with every K6, K7 and cluster-engine
    call captured; each kernel call held against its plain version → (K6
    row, K7 row, the launches [(label, o, d, tmin, tmax, kwargs)]) for the
    kernel table: the camera launch's."""
    cfg = RenderConfig(**LARGE_SIMPLE)
    with warnings.catch_warnings(record=True) as caught, \
            recording(ci, "intersect_clusters") as launches, \
            recording(ck, "cull_tiles") as k6_calls, \
            recording(ck, "pair_hits") as k7_calls:
        warnings.simplefilter("always")
        simple.render_simple(scene, cam, cfg, prng.PRNGKey(0, dev))
        torch.cuda.synchronize()
    overflows = [str(w.message) for w in caught
                 if "overflow" in str(w.message)]
    labels = ["camera", "shadow"]
    if overflows or not (len(launches) == len(k6_calls) == len(k7_calls)
                         == len(labels)):
        raise AssertionError(f"k6/k7: {len(launches)} launches, "
                             f"{len(k6_calls)} K6, {len(k7_calls)} K7 "
                             f"calls; {overflows}")
    rows = []
    for label, (args, kw), (k6_args, _), (k7_args, _) in zip(
            labels, launches, k6_calls, k7_calls):
        k6, mask = _k6_case(label, k6_args, 10)
        capacity = kw.get("pair_budget", 1 << 17) * kw.get("rounds", 1)
        k7 = _k7_case(label, k7_args, mask, capacity, 3)
        rows.append((k6, k7))
        del mask
    del k6_calls, k7_calls
    return rows[0][0], rows[0][1], [(label,) + tuple(args[1:5]) + (kw,)
                                    for label, (args, kw) in zip(labels,
                                                                 launches)]


def phase_cluster_engine(scene, launches):
    """The cluster engine against the epoch engine on the captured camera
    and shadow launches, each engine timed per launch (CUDA events around
    the whole engine call, host syncs included)."""
    for label, o, d, tmin, tmax, kw in launches:
        t_c, i_c, n_pairs, ovf_c = ci.intersect_clusters(
            scene.clusters, o, d, tmin, tmax, **kw)
        t_e, i_e, n_sp, ovf_e = ei.intersect_epochs(scene.clusters, o, d,
                                                    tmin, tmax)
        torch.cuda.synchronize()
        hit_c, hit_e = t_c < BIG, t_e < BIG
        flips = int((hit_c != hit_e).sum())
        both = hit_c & hit_e
        rel = float(((t_c - t_e).abs() / t_e.abs().clamp(min=1e-30))[both]
                    .max()) if bool(both.any()) else 0.0
        idx_differ = int((both & (i_c != i_e) & (t_c == t_e)).sum())
        if (int(ovf_c) or int(ovf_e) or flips > ENGINE_FLIP_FRAC * o.shape[0]
                or rel > ENGINE_RTOL):
            raise AssertionError(
                f"cluster_engine {label}: overflow {int(ovf_c)} / "
                f"{int(ovf_e)}, {flips} flips, t off by {rel} relative")
        cluster_ms = cuda_ms(lambda: ci.intersect_clusters(
            scene.clusters, o, d, tmin, tmax, **kw), 3)
        epoch_ms = cuda_ms(lambda: ei.intersect_epochs(
            scene.clusters, o, d, tmin, tmax), 3)
        emit("cluster_engine", launch=label, rays=o.shape[0],
             rounds=kw["rounds"], hits=int(hit_c.sum()), flips=flips,
             max_t_rel_err=rel, idx_differ_at_equal_t=idx_differ,
             n_pairs=int(n_pairs), epoch_subpairs=int(n_sp),
             pair_overflow=0, cluster_ms=cluster_ms, epoch_ms=epoch_ms,
             faster="cluster" if cluster_ms < epoch_ms else "epoch")


def _kernel_counts():
    return {"k6": ck.cull_tiles.launches, "k7": ck.pair_hits.launches,
            "k8": ek.cull_bits.launches, "k9": ek.mt_jobs.launches,
            "k2": rg.rowspan_S.launches}


def _reset_kernel_counts():
    for fn in (ck.cull_tiles, ck.pair_hits, ek.cull_bits, ek.mt_jobs,
               rg.rowspan_S):
        fn.launches = 0


def phase_large_simple(dev, scene, cam, frames=3):
    """render_simple at run_triangle_field's settings on the 4M scene →
    launch counts over the timed frames."""
    cfg = RenderConfig(**LARGE_SIMPLE)
    simple.render_simple(scene, cam, cfg, prng.PRNGKey(0, dev))
    torch.cuda.synchronize()
    _reset_kernel_counts()
    times = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i in range(frames):
            t0 = time.perf_counter()
            img = simple.render_simple(scene, cam, cfg,
                                       prng.PRNGKey(i + 1, dev))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    counts = _kernel_counts()
    overflows = [str(w.message) for w in caught
                 if "overflow" in str(w.message)]
    if overflows:
        raise AssertionError(f"large_simple: {overflows}")
    # every launch of the frame is coherent: the cluster engine takes them
    # all, the epoch engine none
    if (min(counts["k6"], counts["k7"]) <= 0
            or max(counts["k8"], counts["k9"]) != 0):
        raise AssertionError(f"large_simple: launches {counts}, expected K6 "
                             "and K7 and no K8 or K9")
    if not (bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0):
        raise AssertionError("large_simple: image not finite or black")
    frame_s = statistics.median(times)
    emit("large_simple", size=SIZE, spp=cfg.spp, triangles=LARGE_TRIS,
         frames=frames, frame_s=times, frame_s_median=frame_s,
         rays_per_s=SIZE * SIZE * cfg.spp / frame_s,
         launches_per_frame={k: v / frames for k, v in counts.items()
                             if k != "k2"},
         image_mean=float(img.mean()))
    return counts


def phase_large_reference(dev):
    """A 32×32 run_combined frame of triangle_field(2048): kernels on the
    card against plain versions on the CPU."""
    cfg = RenderConfig(**dict(LARGE, width=32, height=32,
                              photon_paths=1 << 14))
    imgs = []
    for device in (dev, "cpu"):
        scene, cam = presets.triangle_field(device, 2048, 32)
        img, aux = photon.render_photon(scene, cam, cfg,
                                        prng.PRNGKey(0, device),
                                        return_aux=True)
        if int(aux["pair_overflow"]) or int(aux["gather_overflow"]):
            raise AssertionError(f"32x32 triangle_field on {device}: {aux}")
        imgs.append(img.cpu())
    gpu, cpu = imgs
    rel_l1 = float((gpu - cpu).abs().sum() / cpu.abs().sum())
    if not (torch.isfinite(gpu).all() and rel_l1 <= REF_REL_L1):
        raise AssertionError(f"32x32 triangle_field frame: rel L1 {rel_l1} "
                             "against the CPU")
    return rel_l1


def phase_large(dev, scene, cam, profile_path=None, frames=2):
    """render_photon at run_combined's settings: the card-vs-CPU check at
    32×32, a warm-up, `frames` timed frames, and one profiled frame (its
    table written to profile_path when given)."""
    ref_rel_l1 = phase_large_reference(dev)
    cfg = RenderConfig(**LARGE)
    photon.render_photon(scene, cam, cfg, prng.PRNGKey(0, dev))
    torch.cuda.synchronize()
    _reset_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(frames):
        t0 = time.perf_counter()
        img, aux = photon.render_photon(scene, cam, cfg,
                                        prng.PRNGKey(i + 1, dev),
                                        return_aux=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = _kernel_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    valid = int(aux["valid_photons"])
    overflow = {k: int(aux[k]) for k in ("gather_overflow", "pair_overflow")}
    if min(counts.values()) <= 0:
        raise AssertionError(f"large path skipped a kernel: {counts}")
    if any(overflow.values()):
        raise AssertionError(f"large path: overflow {overflow}")
    if img.shape != (SIZE, SIZE, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError("large path: image not finite or mis-shaped")
    if not float(img.mean()) > 0.0 or valid <= 0:
        raise AssertionError("large path: black image or no valid photons")
    frame_s = statistics.median(times)
    busy_s, by_kernel, table = profiled(lambda: photon.render_photon(
        scene, cam, cfg, prng.PRNGKey(9, dev)))
    if profile_path:
        with open(profile_path, "w") as f:
            f.write(table)
    kernel_ms = {k: by_kernel.get(name, 0.0) for k, name in (
        ("k6", "cluster_cull_kernel"), ("k7", "cluster_pair_kernel"),
        ("k8", "epoch_cull_kernel"), ("k9", "epoch_mt_kernel"),
        ("k2", "rowspan_kernel"))}
    emit("large", size=SIZE, triangles=LARGE_TRIS,
         photon_paths=cfg.photon_paths,
         slots=cfg.photon_paths * cfg.max_photon_depth, frames=frames,
         frame_s=times, frame_s_median=frame_s,
         rays_per_s=SIZE * SIZE * cfg.spp / frame_s,
         photons_per_s=cfg.photon_paths / frame_s, valid_photons=valid,
         **overflow, image_mean=float(img.mean()), peak_memory_gb=peak_gb,
         launches_per_frame={k: v / frames for k, v in counts.items()},
         profiled_frame=dict(device_busy_s=busy_s,
                             device_busy_frac=busy_s / frame_s,
                             kernel_ms=kernel_ms),
         reference_rel_l1=ref_rel_l1)
    return counts, frame_s


def profiled(fn):
    """fn() once under torch.profiler → (device busy seconds, device ms by
    kernel name, the key_averages table)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    by_kernel = {}  # by the kernel's name without its argument list
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.split("(")[0]
            by_kernel[name] = by_kernel.get(name, 0.0) + e.device_time_total
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=60)
    return (sum(by_kernel.values()) / 1e6,
            {k: v / 1e3 for k, v in by_kernel.items()}, table)


def profile_step(phase: str, fn, wall_s: float, path: str) -> None:
    """fn() once under torch.profiler: device time by kernel, written to
    `path`, and the device's busy share of wall_s, the unprofiled median of
    the same step (the profiler's own overhead inflates its wall time)."""
    busy_s, _, table = profiled(fn)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(table)
    emit(phase, device_busy_s=busy_s, wall_s=wall_s,
         device_idle_frac=1.0 - busy_s / wall_s)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="FILE",
                    help="write per-kernel device-time tables of one frame "
                         "(FILE), one gradient step (FILE.grad), one "
                         "16-wave preview render (FILE.preview), one "
                         "simple frame (FILE.simple) and one large frame "
                         "(FILE.large)")
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

    # the large-scene path: BASELINE config[4]
    del scene, sp_scene
    lscene, lcam = phase_build_large(dev)
    lcfg = RenderConfig(**LARGE)
    k8, k9, camera = phase_k8_k9(large_launches(dev, lscene, lcam, lcfg),
                                 lscene)
    phase_engine(lscene, camera)
    del camera
    k6, k7, coherent = phase_k6_k7(dev, lscene, lcam)
    phase_cluster_engine(lscene, coherent)
    del coherent
    simple_counts = phase_large_simple(dev, lscene, lcam)
    large_counts, _ = phase_large(
        dev, lscene, lcam, args.profile and args.profile + ".large")

    # launches: K1 and K2 over the forward frames of phase main, K3 over
    # the gradient steps of phase grad, K4 over the 16-wave preview render,
    # K6 and K7 over the frames of phase large_simple, K8 and K9 over the
    # frames of phase large; no renderer calls K5 (as in JAX), so its count
    # is phase k5's call of gather_radius_grid
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
             k5),
            ("cluster_cull", "raytrace_tpu_torch/csrc/cluster_cull.cu",
             "raytrace_tpu/ops/cluster_intersect.py:115", "large_simple",
             simple_counts["k6"], k6),
            ("cluster_pair", "raytrace_tpu_torch/csrc/cluster_pair.cu",
             "raytrace_tpu/ops/cluster_intersect.py:180", "large_simple",
             simple_counts["k7"], k7),
            ("epoch_cull", "raytrace_tpu_torch/csrc/epoch_cull.cu",
             "raytrace_tpu/ops/epoch_intersect.py:70", "large",
             large_counts["k8"], k8),
            ("epoch_mt", "raytrace_tpu_torch/csrc/epoch_mt.cu",
             "raytrace_tpu/ops/epoch_intersect.py:184", "large",
             large_counts["k9"], k9)]
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
