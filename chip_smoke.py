"""Smoke run of the PyTorch/CUDA port (raytrace_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                   # the whole check, a few minutes
    python3 chip_smoke.py --profile FILE    # also torch.profiler tables of a
                                            # frame, a gradient step, a
                                            # preview render, a simple
                                            # frame, a large simple frame
                                            # and a large frame, written
                                            # to FILE*
    python3 chip_smoke.py --parent DIR      # also K1, K4 and K5 of the
                                            # checkout at DIR, held against
                                            # this tree's (K1, K4 bit for
                                            # bit; K5 M equal, S within its
                                            # rounding bound) and timed in
                                            # turns with them

Phases, one JSON result line each:
  1. device     the card's name and power limit; raises without CUDA
  2. build      nvcc builds kernels K1-K9 and the draws' kernel
                (threefry) from
                raytrace_tpu_torch/csrc and g++ the host BVH builder, one
                compiler process per library, all at once
  3. k1         K1 (closest hit) against its plain PyTorch version on
                262,144 random rays: the Cornell triangles, a
                4,096-triangle soup and a 511-triangle one (the top of
                K1's range); hit flips bounded, equality bit for bit
                counted, two launches equal; the kernel's device time (the
                profiler's kernel records) beside the host's call time
                (CUDA events over back-to-back wrapper calls), the host µs
                of one intersect_triangles and one occluded_triangles call
                on the Cornell triangles, the tests past the β gate and
                both bounds; SASS instructions per test and registers
                (k1_sass)
  4. k2         K2 (row-span gather) against its plain version on the
                gather inputs of the full-size frame: the tiles' job counts
                (busy, p50, p99, max), J and the work items and their
                scratch slots, two launches equal bit for bit
  5. k3         K3 (the gather's backward in the photon flux) against its
                plain version on the same inputs and a random cotangent:
                the chunks' job counts (busy, p50, p99, max), J and the
                work items and their scratch slots, two launches equal bit
                for bit
  6. k4         K4 (dense small-map gather) against its plain version on the
                gather inputs of the preview's first wave (2,048 paths),
                a miss's radius 0 as the renderer passes it: M equal, S
                within its rounding bound and equal bit for bit to the
                sums in photon index order, two launches equal; the pair
                tests left after the exact pre-cull and their share, also
                with the misses' starting radii, and the warps holding a
                miss; device time and host call time; both bounds; SASS
                and registers (k4_sass). M equal and S bit for bit also
                with the misses' starting radii (wide warp boxes) and on
                the adversarial inputs of
                tests/test_torch_dense_precull.py (k4_adversarial)
  7. k5         K5 (Morton-span gather) against its plain version on the
                full-size frame's queries and a 2^16-path wave, the cell
                the largest live radius: M equal, S within its rounding
                bound and equal bit for bit to the sums in item and photon
                index order, two launches equal; the spans' spread (p50,
                p99, max), J, the work items and their scratch slots and
                bytes; the pair tests left after the exact pre-cull and
                their share, the photons each warp keeps (spread), the
                chunks staged against the chunks in the spans (these
                counts from the cull's plain form on the card's inputs);
                the kernel's device time and a whole grid_S call's (every
                device record: the kernel and its prep), both from the
                profiler, and host call time; both bounds; the
                same checks on the adversarial inputs of
                tests/test_torch_grid_precull.py (k5_adversarial); SASS
                and registers (k5_sass)
  8. reference  a 32×32 frame on the card (kernels) against the same frame
                on the CPU (plain versions)
  9. main       render_photon on the 512×512 glass Cornell box with 262,144
                photon paths (bench.py's headline settings): a warm-up
                whose K1 calls are counted by route (closest hit with its
                re-intersection, any-hit without), then the median of 5
                frames, with K1's and K2's launch counts over those
                frames, and one profiled frame's device busy time and
                device operations
 10. grad_reference  loss_and_grad of a 32×32 frame on the card against the
                same on the CPU
 11. grad       loss_and_grad at bench.py's run_grad settings (the headline
                frame with differentiable=True, zero target, no jitter): a
                warm-up, then the median of 5 steps, with K1's, K2's and
                K3's launch counts over those steps
 12. train      3 Adam steps of fit at the same settings, from a 1.8×
                over-bright emitter against the frame rendered at the true
                parameters
Multi-device rendering (raytrace_tpu_torch/parallel/), on torch.distributed:
NCCL refuses two ranks on one card, so with one card NCCL runs
world 1 in this process and two processes share the card over gloo; no
scaling is measured
 13. sharded_reference  at 32×32, render_photon_sharded and
                train_step_sharded on world 1 over NCCL against the same
                calls on the CPU on world 1 over gloo: the frame within
                1e-3 relative L1, the loss within 1e-4 and the new kd and
                intensity within 5e-3 relative
 14. sharded    render_photon_sharded at the headline on world 1 over NCCL:
                a warm-up, then 5 frames in turns with render_photon's;
                finite, not black, overflow 0, K1's and K2's launches per
                frame equal to phase main's; then the headline over 8
                waves, wave p's photon map gathered on NCCL's stream
                while wave p-1 is gathered, with the device time between
                gather passes (CUDA events); one profiled frame's device
                busy time; then 5 render_photon frames with no process
                group alive
 15. sharded_train  train_step_sharded at the headline, differentiable:
                a warm-up and 3 steps in turns with loss_and_grad, beside
                phase grad's median; loss and parameters finite, the glass
                row of kd unchanged (its gradient 0), one K3 launch a step
 16. sharded_2proc  two processes on the card over gloo (its CUDA
                all_gather, async all_gather, all_reduce and barrier
                checked first) at bench.py run_scaling's settings (256²,
                1 spp, 2^16 paths, 8 bounces, glass ball): the frame within
                rtol 5e-4 and atol 5e-5 of world 1's over NCCL; one 64×64
                train step against world 1's
 17. scaling    scaling_report at run_scaling's settings on world 1 over
                NCCL: rays/s at the one count, no efficiency
 18. preview    render_photon_progressive on the same box with 2,048 paths ×
                16 waves (2^13-slot maps, so every wave takes K4): K4 and K2
                launch counts, the median wave; then 8 waves with a
                checkpoint, resumed to 16, against the uninterrupted render
 19. progressive  render_photon_progressive at bench.py run_multiwave's
                settings (262,144 paths × 8 waves, the row-span route): the
                steady wave median and the radius trace
 20. simple     render_simple on the 256×256 sphere and plane (BASELINE
                config[0]): a warm-up, then the median of 5 frames; and a
                32×32 frame on the card against the CPU's
The front end (pbrt files and the raytrace-tpu-torch CLI):
 21. pbrt       examples/cornell.pbrt with a 512×512 Film through load_pbrt
                on the card: every array of the scene and camera against
                presets.cornell_box (ints equal, floats within 1e-6); the
                parse's host seconds
 22. cli        cli.main in this process on that file at the headline's
                paths: the PFM it writes against render_photon on the
                parsed scene (bit for bit, or within the spread of 4
                direct renders, which the line reports) and within 1e-3
                relative L1 of the preset's frame; K1 and K2 launches over
                the call; its printed time and rate beside the direct
                render's median of 3; --passes 2 with a checkpoint resumed
                to 4 against 4 in one call; --renderer simple (K1); and
                examples/render_pbrt_torch.py as a subprocess
 23. pbrt_large  triangle_field(1 << 16, 512) written as a pbrt file
                (floats by repr), parsed on the card: host seconds and
                tokens/s of the parse apart from the SAH, cluster and
                upload seconds; the scene's tensors equal to the preset's,
                the camera within 1e-6; rendered by cli.main at the
                headline's paths: K6-K9 and K2 launches, overflow 0, the
                frame against render_photon on the parsed scene and the
                preset's frame as in phase cli
Edge gradients (raytrace_tpu_torch/diff/edges.py), on the scenes of
tests/test_edges.py and tests/test_penumbra.py (tests/torch_edge_scenes.py):
 24. edges_reference  the CPU twin tests' 32×32 calls on the card against
                the same calls on the CPU: shadow_boundary_image_grad (quad
                with rigid and per-endpoint velocities, cube with its
                silhouette mask, in-view cube with its box),
                primary_boundary_image_grad, area_shadow_boundary_image_grad
                and joint_loss_and_grad; each within the CPU tests' bounds
                plus what two card runs of it differ by
 25. edges      at 512×512: each estimator against central differences of
                render_simple (spp 16) under a fixed random weighting — the
                quad out of view (256 samples an edge, within 0.25), the
                in-view cube's shadow plus primary terms (within 0.25, and
                closer than the shadow term alone), the penumbra (16 light
                points, within 0.3), one joint_loss_and_grad step under the
                disk light (θ-gradient against FD of its loss, within 0.3)
                and the quad estimator against FD of render_photon at
                262,144 paths (within 0.35, K2); per estimator the median of
                5 calls, K1's calls by route and launches per call, and the
                largest difference between two runs
 26. edges_large  a closed 5,120-triangle icosphere as the quad scene's
                occluder: shadow_boundary_image_grad over its 7,680 edges
                with the light's silhouette mask, 64 samples an edge,
                through the epoch engine (K8, K9) on the scene with
                clusters and through K1 on the same mesh built without them,
                the two within the CPU tests' bounds plus their run-to-run
                differences; the median of 3 calls, K1 and K6-K9 launches
                per call, peak memory; one translation_loss_and_grad (its
                render on K6, K7; its estimator on K8, K9)
The large-scene path (BASELINE config[4], 4,194,304 triangles):
 27. build_large  host time of triangle_field(1 << 22, 512): the SAH build,
                the cluster set and the upload; node and cluster counts
 28. k8, k9     K8 (epoch cull) and K9 (subtile Möller–Trumbore) against
                their plain versions on the frame's own launches, captured
                from the epoch engine, a row per epoch: the camera launch
                (262,144 rays) in full and the photon emission launch
                (4,194,304 rays) on 2,048 tiles spread over it and on its
                first 65,536 jobs; mask bytes, t and idx equal; the tests
                left after K8's exact pre-culls on the scene box and on its
                group hulls (`cull_tests_plain`) and the warps that skip, the
                (job, triangle) pairs past K9's gate, and a bound on that
                work beside the bound on all tests; K9 also on the camera
                list shifted by one job and shuffled, K8 also on the
                adversarial inputs of tests/test_torch_epoch_precull.py
 29. engine     the epoch engine against the BVH traversal on the camera
                launch: t within 1e-5, idx differences counted, overflow 0
 30. k6, k7     K6 (tile cull) and K7 (pair Möller–Trumbore) against their
                plain versions on every call of one run_triangle_field frame
                (its camera and shadow launches, captured from the cluster
                engine): K6's mask in full, with the tiles its exact
                pre-cull skips, K7's (t, idx) on the pairs of 256 tiles
                spread over the launch; equal. K6 also on the adversarial
                inputs of tests/test_torch_cluster_precull.py at 128 and
                256 rays a tile (k6_adversarial), its SASS instructions per
                test and registers (k6_sass). K7 also on
                adversarial tiles at 128 and 256 rays a tile (k7_adversarial:
                pairs over several work items, a tie across an item
                boundary, warps failing the beta gate, empty windows, a
                tile without pairs), its SASS instructions per test and
                registers (k7_sass), each launch's pairs per tile and work
                items, and a bound on the work its function needs beside the
                bound on all tests
 31. cluster_engine  the cluster engine against the epoch engine on the same
                two launches: overflow 0, flips and t bounded, idx
                differences counted, each engine timed per launch
 32. large_simple  render_simple at bench.py run_triangle_field's settings
                (512², 1 spp) on the same scene: a warm-up and 3 frames,
                every launch coherent, so K6 and K7 and no K8 or K9
 33. threefry   the draws' kernel (csrc/threefry.cu) against core/prng.py's
                eager threefry ops on the same arguments, bit for bit:
                every fold_in, split, random_bits, uniform and
                folded_uniform of one run_combined frame, then each of
                them called at that frame's lane counts (the walk's bounce
                lanes with two folds and three uniforms, the camera's
                pixels), batched keys and int, int64 and int32 data among
                them; one launch a draw
 34. large      render_photon at bench.py run_combined's settings (2^22
                paths, 16.8M slots): a 32×32 triangle_field(2048) frame on
                the card against the CPU's, the warm-up frame's K2 launch
                held against its plain version (a k2 line, launch large,
                with its job spread, pair tests and bound), 2 frames with K6,
                K7, K8, K9, K2 and the draws' kernel's launch counts, and one
                profiled frame (device busy share, K6-K9, K2 and the draws'
                kernel's device ms)
 35. bench      the harness (raytrace_tpu_torch/bench.py, which holds the
                settings above) on the same scene: its combined_multiwave
                cell in process, config[4] over 4 waves with a checkpoint
                after wave 2 and the resume probe (the re-run wave's state
                equal to the kept one by torch.equal on all four fields),
                radius² trace non-increasing, overflow 0, with the K2 and
                K6-K9 launches of the cell; then `python -m
                raytrace_tpu_torch.bench --cell headline --reps 3` as a
                subprocess (bench_headline), its last line parsed; any
                failed check of either is fatal
Then the kernel table as one JSON line (each kernel's launches on its main
path and, for K1, K2 and K3, on the sharded paths too, each counted from 0
over its own run), the card line from nvidia-smi, and last {"ok": true,
"device": {...}}. Any failed check raises, so the script
exits non-zero and prints no final line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import io
import json
import logging
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

import raytrace_tpu_torch
from raytrace_tpu_torch import bench, cli, load_pbrt
from raytrace_tpu_torch.bench import (BENCH, LARGE, LARGE_SIMPLE,
                                      LARGE_TRIS, MULTIWAVE, SCALING, SIZE,
                                      nvidia_smi)
from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.core.config import RenderConfig
from raytrace_tpu_torch.diff import edges, optim
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
from raytrace_tpu_torch.ops.work_items import work_items
from raytrace_tpu_torch.parallel import launch, multihost, sharded
from raytrace_tpu_torch.renderers import common, photon, simple
from raytrace_tpu_torch.scene import presets
from raytrace_tpu_torch.scene.camera import generate_rays, pixel_samples
from raytrace_tpu_torch.scene import pbrt
from raytrace_tpu_torch.scene.scene import GLASS
from raytrace_tpu_torch.utils import checkpoint as ckpt
from raytrace_tpu_torch.utils import image, sass
from raytrace_tpu_torch.utils.timing import (call_device_ms, cuda_ms,
                                             device_records,
                                             kernel_device_ms)

# the harness's cell table holds bench.py's settings: BENCH (the headline,
# bench.py:78-85), MULTIWAVE (run_multiwave: 8 waves), SCALING (run_scaling,
# bench.py:443-448: the sharded frame of phases sharded_2proc and
# scaling), LARGE and LARGE_TRIS (run_combined, bench.py:237-262:
# triangle_field(1 << 22, 512), 2^22 paths × 4 deposits = 16.8M slots) and
# LARGE_SIMPLE (run_triangle_field, bench.py:377-390, on that scene)
# the preview: 2,048 paths a wave, 8,192 slots, under the 2^14 threshold of
# the dense gather K4
PREVIEW = dict(BENCH, photon_paths=1 << 11, photon_passes=16)
# bench.py run_scaling's map (bench.py:447): 2^16 paths, 262,144 slots
K5_PATHS = 1 << 16
# the front end: examples/cornell.pbrt at the headline's width, parsed and
# held against presets.cornell_box (floats to 1e-6, as tests/test_pbrt.py
# holds them), and config[4]'s scene at 1/64 of its triangles written as a
# pbrt file (the parser is pure Python on the host, as in JAX)
CORNELL_PBRT = Path(__file__).resolve().parent / "examples" / "cornell.pbrt"
PBRT_ATOL = 1e-6
PBRT_LARGE_TRIS = 1 << 16
# edge gradients: the scenes of tests/test_edges.py and tests/test_penumbra.py
# at the headline's width, their FD renders at 16 samples a pixel; the quad
# cases of the 32×32 card-vs-CPU check at θ = 0.03, as the CPU twin tests
# take them (at θ = 0 a shadow edge lies on a pixel boundary); the GI check
# at the headline's photon paths; the icosphere's edges sampled 64 times
EDGE_SPP = 16
EDGE_REF_THETA = 0.03
EDGE_GI_PATHS = 1 << 18
EDGE_LARGE_K = 64
# the sharded train step at 64×64
SHARDED_TRAIN_SIZE = 64
# N ranks against one: the JAX package's own bounds (tests/test_sharded.py)
SHARD_RTOL, SHARD_ATOL = 5e-4, 5e-5
TRAIN_LOSS_RTOL, TRAIN_PARAM_RTOL = 1e-4, 5e-3
TRAIN_KD_ATOL, TRAIN_INTENSITY_ATOL = 1e-5, 1e-4
# train_step_sharded's default step size
SHARDED_LR = 0.05
# BASELINE config[0] as examples/render_sphere_plane.py renders it
SIMPLE = dict(width=256, height=256, spp=4, scene_epsilon=1e-3)
N_RAYS = 1 << 18
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
# K7's test and gate are K9's; its warps hold 32 rays in each of two slots,
# so the second half is needed for a (pair, 32-ray group, triangle) where a
# live lane passes
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


# the draws of core/prng.py that phase threefry holds against the eager
# ops; its frame's key and inputs take a seed past 32 bits
DRAWS = ("fold_in", "split", "random_bits", "uniform", "folded_uniform")
THREEFRY_SEED = 2**32 + 0x9E3779B9


def emit(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


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
             "epoch_cull", "epoch_mt", "threefry")
    with ThreadPoolExecutor(len(names) + 1) as pool:
        host = pool.submit(timed_host, "bvh_builder")
        secs = dict(zip(names, pool.map(timed, names)))
        secs["bvh_builder"] = host.result()
    emit("build", seconds=secs, total_s=time.perf_counter() - t0)


def host_us(fn, iters: int) -> float:
    """Host microseconds per call of fn: iters calls after a warm-up, one
    synchronize at the end."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / iters


def in_turns(mine, parent, measure) -> dict:
    """measure(fn) of this tree's fn, and of the parent's when given, in
    turns (parent, this, this, parent) → {"": [this ×2], "parent_": [...]}."""
    if parent is None:
        return {"": [measure(mine), measure(mine)]}
    p1, m1, m2, p2 = (measure(parent), measure(mine), measure(mine),
                      measure(parent))
    return {"": [m1, m2], "parent_": [p1, p2]}


def load_parent(root: Path) -> dict:
    """K1's, K4's and K5's wrapper modules of the checkout at `root`, each
    bound to that checkout's cuda_lib, which builds its sources into its
    own _build/ → {"tri_intersect": module, "dense_gather": module,
    "grid_gather": module, "cuda_lib": module}. `root` must lie inside
    this checkout (as _archive/ does, which .gitignore lists), so that the
    build writes nowhere else."""
    here = Path(__file__).resolve().parent
    root = root.resolve()
    if not root.is_relative_to(here):
        raise SystemExit(f"--parent {root}: not a directory inside {here}")

    def module(name):
        spec = importlib.util.spec_from_file_location(
            f"parent_{name}", root / "raytrace_tpu_torch" / "ops" /
            f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    lib = module("cuda_lib")
    mods = {"cuda_lib": lib}
    for name in ("tri_intersect", "dense_gather", "grid_gather"):
        mods[name] = module(name)
        mods[name].cuda_lib = lib
    return mods


def _k1_gate(o, d, tmin, tmax, v0, v1, v2) -> tuple[int, int]:
    """(tests of live 32-ray groups, (32-ray group, triangle) pairs past
    the gate) of one K1 launch: a warp's slot holds 32 consecutive rays
    (`_gate_groups` with the triangles as one row)."""
    n, t = o.shape[0], v0.shape[0]
    live = tmin < tmax
    ray = torch.arange(n, device=o.device).view(-1, 32)
    tv = torch.cat([v0.T, v1.T, v2.T])[None]  # [1, 9, T]
    cl = torch.zeros(ray.shape[0], dtype=torch.int64, device=o.device)
    gate_tests = int(live.view(-1, 32).any(1).sum()) * 32 * t
    return gate_tests, _gate_groups(cl, ray, o, d, live, tv)


def _k1_case(label, o, d, v0, v1, v2, iters, parent=None, tris=None):
    """K1 on one batch against its plain version (flips bounded, and counted
    bit for bit) and the parent's kernel when given (equal bit for bit);
    device time by the profiler and host call time by CUDA events over
    back-to-back wrapper calls, each in turns with the parent's; `tris`
    (the scene's Triangles) adds the host µs of one intersect_triangles
    and one occluded_triangles call → the kernel-table row."""
    n = o.shape[0]
    tmin = torch.full((n,), 1e-3, device=o.device)
    tmax = torch.full((n,), BIG, device=o.device)
    args = (o, d, tmin, tmax, v0, v1, v2)
    got = ti.closest_hit(*args)
    again = ti.closest_hit(*args)
    want = ti.closest_hit_plain(*args)
    torch.cuda.synchronize()
    bits = lambda a: (a[0].view(torch.int32), a[1])
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(bits(a),
                                                              bits(b)))
    if not same(got, again):
        raise AssertionError(f"K1 {label}: two launches differ")
    hit_k, hit_p = got[0] < BIG, want[0] < BIG
    agree = (hit_k == hit_p) & (~hit_k | (got[1] == want[1]))
    flips = int((~agree).sum())
    both = agree & hit_k
    err = float((got[0][both] - want[0][both]).abs().max())
    if flips > K1_FLIP_FRAC * n:
        raise AssertionError(f"K1 {label}: {flips} of {n} rays flip")
    t_scale = float(want[0][both].abs().max())
    if err > K1_RTOL * t_scale:
        raise AssertionError(f"K1 {label}: t differs by {err} (max t "
                             f"{t_scale})")
    extra = {}
    pti = None if parent is None else parent["tri_intersect"]
    if pti is not None:
        old = pti.closest_hit(*args)[:2]
        torch.cuda.synchronize()
        if not same(got, old):
            raise AssertionError(f"K1 {label}: (t, idx) differ from the "
                                 "parent kernel's")
        extra["equal_to_parent_bit_for_bit"] = True
    for key, ms in in_turns(
            lambda: ti.closest_hit(*args),
            None if pti is None else lambda: pti.closest_hit(*args),
            lambda fn: kernel_device_ms(fn, "tri_closest_kernel",
                                        iters)).items():
        extra[f"{key}device_ms_runs"] = ms
    for key, ms in in_turns(
            lambda: ti.closest_hit(*args),
            None if pti is None else lambda: pti.closest_hit(*args),
            lambda fn: cuda_ms(fn, iters)).items():
        extra[f"{key}host_call_ms_runs"] = ms
    if tris is not None:
        for name in ("intersect_triangles", "occluded_triangles"):
            # the parent's any-hit was its intersect_triangles
            theirs = (None if pti is None or not hasattr(pti, name) else
                      lambda: getattr(pti, name)(tris, *args[:4]))
            for key, us in in_turns(
                    lambda: getattr(ti, name)(tris, *args[:4]), theirs,
                    lambda fn: host_us(fn, 200)).items():
                extra[f"{key}host_us_{name}_runs"] = us
    plain_ms = cuda_ms(lambda: ti.closest_hit_plain(*args), max(1, iters // 10))
    t = v0.shape[0]
    gate_tests, tail = _k1_gate(*args)
    nbytes = n * (8 + 2) * 4 + t * 9 * 4
    full = bound(n * t * K1_PAIR_OPS, nbytes)
    row = dict(max_abs_err=err, ms=statistics.median(extra["device_ms_runs"]),
               host_call_ms=statistics.median(extra["host_call_ms_runs"]),
               plain_ms=plain_ms,
               **bound(K9_GATE_OPS * gate_tests + K9_TAIL_OPS * tail * 32,
                       nbytes),
               bound_all_tests_ms=full["bound_ms"], library_ms=None)
    emit("k1", case=label, rays=n, triangles=t, hits=int(hit_k.sum()),
         flips=flips, equal_to_plain_bit_for_bit=same(got, want),
         repeats_bit_for_bit=True, gate_tests=gate_tests,
         tail_tests=tail * 32, **extra, **row)
    return row


def phase_k1(dev, scene, parent=None):
    """K1 on 262,144 random rays from inside the box against the Cornell
    triangles, a 4,096-triangle soup and a 511-triangle one (the builder's
    BVH threshold − 1, the top of K1's range); its SASS instructions per
    test and registers, and the parent's → the Cornell row."""
    g = torch.Generator(device=dev).manual_seed(1)
    rnd = lambda *s: torch.rand(*s, device=dev, generator=g)
    # rays from inside the box, every direction
    o = rnd(N_RAYS, 3) * torch.tensor([2.0, 2.0, 2.0], device=dev) \
        - torch.tensor([1.0, 0.0, 0.0], device=dev)
    d = torch.nn.functional.normalize(torch.randn(N_RAYS, 3, device=dev,
                                                  generator=g), dim=1)
    tris = scene.tris
    res = _k1_case("cornell", o.contiguous(), d.contiguous(), tris.v0,
                   tris.v1, tris.v2, iters=50, parent=parent, tris=tris)
    # triangle soups in [-1, 1]^3; the 511-triangle one drawn after the
    # 4,096-triangle one, so that the latter's inputs stay as they were
    o2 = None
    for t, iters in ((4096, 10), (511, 10)):
        v0 = rnd(t, 3) * 2 - 1
        v1 = v0 + 0.15 * torch.randn(t, 3, device=dev, generator=g)
        v2 = v0 + 0.15 * torch.randn(t, 3, device=dev, generator=g)
        if o2 is None:
            o2 = (rnd(N_RAYS, 3) * 3 - 1.5).contiguous()
        _k1_case(f"soup{t}", o2, d, v0.contiguous(), v1.contiguous(),
                 v2.contiguous(), iters=iters, parent=parent)
    emit("k1_sass", **sass.report("tri_intersect"))
    if parent is not None:
        emit("k1_sass", parent=True, **sass.report(
            "tri_intersect", parent["cuda_lib"].build("tri_intersect")))
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


def _k2_case(label, args, iters, **extra) -> dict:
    """K2 on one job list against the plain version: M equal, S within
    2·M·2^-24·S, two launches equal bit for bit; timed; one "k2" line with
    the tiles' job spread, J, the work items and their scratch, and
    `extra` → the kernel-table row."""
    pid, begin, end, n_chunks, qpT, qr2, qnsT, pdata = args
    got = rg.rowspan_S(*args)
    again = rg.rowspan_S(*args)
    want = rg.rowspan_S_plain(*args)
    torch.cuda.synchronize()
    err, ulps = flux_check(f"K2 {label}", got, want)
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise AssertionError(f"K2 {label}: two launches on the same inputs "
                             "differ")
    ms = cuda_ms(lambda: rg.rowspan_S(*args), iters)
    plain_ms = cuda_ms(lambda: rg.rowspan_S_plain(*args), 1)
    lengths = (end - begin).long().clamp(min=0)
    n_jobs = int(lengths.sum())  # the jobs the kernel runs
    chunk = pdata.shape[2]
    pairs = n_jobs * rg.TILE_Q * chunk
    nq, n_tiles = qr2.shape[0], begin.shape[0]
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
               **bound(gather_ops(pairs, float(want[3].sum())),
                       nq * (7 + 4) * 4 + n_chunks * chunk * 10 * 4
                       + n_jobs * 4 + n_tiles * 8),
               library_ms=None)
    item_jobs = cuda_lib.load("rowspan_gather",
                              rg._SIGNATURES).rowspan_gather_item_jobs()
    slots = n_tiles + pid.shape[0] // item_jobs  # as the wrapper
    emit("k2", launch=label, **extra, tiles=n_tiles, chunks=n_chunks,
         jobs=n_jobs,
         tile_jobs=spread_stats(lengths), item_jobs=item_jobs,
         items=_items(begin, end, item_jobs), slots=slots,
         scratch_bytes=slots * 4 * rg.TILE_Q * 4, pair_tests=pairs,
         max_flux=float(want[:3].abs().max()), max_err_over_M_ulp=ulps,
         repeats_bit_for_bit=True, **row)
    return row


def phase_k2(jobs, queries, photons):
    """K2 on the gather inputs of the full-size frame."""
    args = [jobs[k] for k in ("pid", "tile_begin", "tile_end", "n_chunks",
                              "qpT", "qr2", "qnsT", "pdata")]
    return _k2_case("headline", args, 20, queries=queries, photons=photons,
                    listed_jobs=int(jobs["n_jobs"]),
                    overflow=int(jobs["overflow"]))


def spread_stats(lengths) -> dict:
    """How uneven a kernel's ranges are: the owners with work and the
    mean, p50, p90, p99 and max of their lengths."""
    busy = lengths[lengths > 0].double()
    if busy.numel() == 0:
        return dict(busy=0)
    q = torch.quantile(busy, torch.tensor([0.5, 0.9, 0.99],
                                          dtype=torch.float64,
                                          device=busy.device)).tolist()
    return dict(busy=busy.numel(), mean=float(busy.mean()), p50=q[0],
                p90=q[1], p99=q[2], max=int(busy.max()))


def phase_k3(dev, jobs):
    """K3 on the same inputs, re-sorted chunk-major, with a nonnegative
    cotangent from its own generator: checked, launched twice and compared
    bit for bit, timed."""
    n_tiles = jobs["tile_begin"].shape[0]
    pid, begin, end = rg.chunk_major(jobs["pid"], jobs["n_valid"],
                                     jobs["n_chunks"], n_tiles)
    g = torch.Generator(device=dev).manual_seed(3)
    cotT = torch.rand(jobs["qpT"].shape, device=dev, generator=g)
    args = (pid, begin, end, n_tiles, jobs["qpT"], jobs["qr2"], jobs["qnsT"],
            cotT, jobs["pdata"])
    got = rg.rowspan_S_bwd(*args)
    again = rg.rowspan_S_bwd(*args)
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
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise AssertionError("K3: two launches on the same inputs differ")
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
    lib = cuda_lib.load("rowspan_gather_bwd", rg._BWD_SIGNATURES)
    item_jobs = lib.rowspan_gather_bwd_item_jobs()
    slots = jobs["n_chunks"] + pid.shape[0] // item_jobs  # as the wrapper
    emit("k3", jobs=n_jobs,
         chunks=jobs["n_chunks"], chunks_without_jobs=int(empty.sum()),
         chunk_jobs=spread_stats(end - begin), item_jobs=item_jobs,
         items=_items(begin, end, item_jobs), slots=slots,
         scratch_bytes=slots * 4 * chunk * 4,
         repeats_bit_for_bit=True, terms=float(want[:, 3].sum()),
         max_dalpha=float(want[:, :3].max()), max_err_over_K_ulp=ulps, **row)
    return row


def _items(begin, end, size) -> int:
    """Work items of at most `size` over the ranges [begin, end)."""
    return int(work_items(begin, end, size, 0)[4].sum())


def ordered_S(q_p, radius2, q_ns, photons_p, photons_alpha, photons_wi,
              photons_valid, n_valid):
    """K4's function with each query's sums taken as K4 takes them: one add
    per counted photon, in photon index order (the order of the parent
    kernel, which tested every pair, and of the pre-culled one, whose
    skipped pairs add nothing) → [4, N], for an equality bit for bit."""
    out = torch.zeros((4, q_p.shape[0]), dtype=torch.float32,
                      device=q_p.device)
    for k in range(int(n_valid)):
        dx = q_p[:, 0] - photons_p[k, 0]
        dy = q_p[:, 1] - photons_p[k, 1]
        dz = q_p[:, 2] - photons_p[k, 2]
        ok = ((dx * dx + dy * dy + dz * dz) < radius2) & photons_valid[k]
        w = torch.abs(q_ns[:, 0] * photons_wi[k, 0]
                      + q_ns[:, 1] * photons_wi[k, 1]
                      + q_ns[:, 2] * photons_wi[k, 2])
        for c in range(3):
            out[c] = torch.where(ok, out[c] + w * photons_alpha[k, c],
                                 out[c])
        out[3] = torch.where(ok, out[3] + 1.0, out[3])
    return out


def precull_counts(q_p, radius2, pp, pv, n_valid, hit) -> dict:
    """The pair tests K4's pre-cull leaves (`precull_plain`), their share,
    and the warps that hold a miss with their share of those tests."""
    keep = dg.precull_plain(q_p, radius2, pp, pv, n_valid)
    n = q_p.shape[0]
    size = torch.full((keep.shape[0],), dg.GROUP, device=q_p.device)
    size[-1] = n - dg.GROUP * (keep.shape[0] - 1)
    tests = keep.sum(1) * size
    miss = torch.nn.functional.pad(~hit, (0, -n % dg.GROUP)).view(
        -1, dg.GROUP).any(1)
    left = int(tests.sum())
    return dict(tests_after_precull=left,
                tests_after_precull_share=left / (n * int(n_valid)),
                warps=keep.shape[0], warps_with_a_miss=int(miss.sum()),
                miss_warps_share_of_tests=int(tests[miss].sum())
                / max(left, 1))


def _k4_exact(what: str, args) -> torch.Tensor:
    """K4 on args: counts M equal to the plain version's and the output
    equal bit for bit to `ordered_S`, the sums in photon index order → the
    plain version's output."""
    got = dg.dense_S(*args)
    want = dg.dense_S_plain(*args)
    ordered = ordered_S(*args)
    torch.cuda.synchronize()
    if not torch.equal(got[3], want[3]):
        raise AssertionError(f"K4 {what}: photon counts M differ from the "
                             "plain version")
    if not torch.equal(got.view(torch.int32), ordered.view(torch.int32)):
        raise AssertionError(f"K4 {what}: S or M differ bit for bit from "
                             "the sums in photon index order")
    return want


def _k4_adversarial(dev) -> None:
    """K4, with its pre-cull, on the inputs tests/test_torch_dense_precull.py
    builds: photons one ulp inside and outside the queries' reach, dist²
    exactly r², NaN and infinite photon and query positions, NaN, zero and
    negative r², invalid photons, 45 queries (not a multiple of a warp),
    one 4.0 radius among small ones, and a random patch with two chunks of
    photons. One row per case: the pairs the cull leaves and those that
    count."""
    path = Path(__file__).resolve().parent / "tests" / \
        "test_torch_dense_precull.py"
    spec = importlib.util.spec_from_file_location("k4_cases", path)
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    for name in cases.CASES:
        args = cases.inputs(name, dev)
        want = _k4_exact(name, args)
        q, r2, _, p, _, _, valid, n_valid = args
        keep = dg.precull_plain(q, r2, p, valid, n_valid)
        emit("k4_adversarial", case=name, queries=q.shape[0],
             photons=p.shape[0], pair_tests=q.shape[0] * p.shape[0],
             tests_after_precull=int(keep.sum()) * dg.GROUP,
             pairs_counted=float(want[3].sum()), counts_equal_to_plain=True,
             equal_to_ordered_bit_for_bit=True)


def phase_k4(dev, scene, cfg, rec, r2, k_photon, parent=None):
    """K4 on the gather inputs of the preview's first wave: the full-size
    frame's queries with their starting radii, a miss's 0 (as the renderer
    passes them), against a compacted 2,048-path map. Counts M equal to the
    plain version's, S within its rounding bound, and S equal bit for bit
    to `ordered_S` (the kernel's order) and to the parent kernel's when
    given; the same with the misses' starting radii (wide warp boxes), and
    on the adversarial cases of tests/test_torch_dense_precull.py
    (k4_adversarial rows); the pair tests left after the exact pre-cull,
    with and without the misses' radii; both bounds; SASS and
    registers."""
    pcfg = RenderConfig(**PREVIEW)
    photons = photon.trace_photons(scene, pcfg, k_photon, 0)
    pp, pa, pw, pv, n_valid = dg.compact_photons(photons)
    unmasked_args = (rec.p.contiguous(), r2.contiguous(),
                     rec.ns.contiguous(), pp, pa, pw, pv, n_valid)
    _k4_exact("with the misses' starting radii", unmasked_args)
    unmasked = dict(precull_counts(rec.p, r2, pp, pv, n_valid, rec.hit),
                    counts_equal_to_plain=True,
                    equal_to_ordered_bit_for_bit=True)
    _k4_adversarial(dev)
    live_r2 = torch.where(rec.hit, r2, 0.0).contiguous()
    args = (rec.p.contiguous(), live_r2, rec.ns.contiguous(), pp, pa, pw,
            pv, n_valid)
    got = dg.dense_S(*args)
    again = dg.dense_S(*args)
    want = dg.dense_S_plain(*args)
    ordered = ordered_S(*args)
    torch.cuda.synchronize()
    err, ulps = flux_check("K4", got, want)
    bits = lambda a: a.view(torch.int32)
    if not torch.equal(bits(got), bits(again)):
        raise AssertionError("K4: two launches on the same inputs differ")
    if not torch.equal(bits(got), bits(ordered)):
        raise AssertionError("K4: S or M differ bit for bit from the sums "
                             "in photon index order")
    extra = {}
    pdg = None if parent is None else parent["dense_gather"]
    if pdg is not None:
        if not torch.equal(bits(got), bits(pdg.dense_S(*args))):
            raise AssertionError("K4: output differs from the parent "
                                 "kernel's")
        extra["equal_to_parent_bit_for_bit"] = True
    for what, measure in (
            ("device_ms", lambda fn: kernel_device_ms(
                fn, "dense_gather_kernel", 20)),
            ("host_call_ms", lambda fn: cuda_ms(fn, 20))):
        for key, ms in in_turns(
                lambda: dg.dense_S(*args),
                None if pdg is None else lambda: pdg.dense_S(*args),
                measure).items():
            extra[f"{key}{what}_runs"] = ms
    plain_ms = cuda_ms(lambda: dg.dense_S_plain(*args), 2)
    counts = precull_counts(*args[:2], pp, pv, n_valid, rec.hit)
    n, nv = rec.p.shape[0], int(n_valid)
    hits = float(want[3].sum())
    nbytes = n * (7 + 4) * 4 + nv * (9 * 4 + 1) + 4
    full = bound(gather_ops(n * nv, hits), nbytes)
    row = dict(max_abs_err=err, ms=statistics.median(extra["device_ms_runs"]),
               host_call_ms=statistics.median(extra["host_call_ms_runs"]),
               plain_ms=plain_ms,
               **bound(gather_ops(counts["tests_after_precull"], hits),
                       nbytes),
               bound_all_tests_ms=full["bound_ms"], library_ms=None)
    emit("k4", queries=n, slots=photons.p.shape[0], n_valid=nv,
         pair_tests=n * nv, pairs_counted=hits, **counts,
         unmasked_radii=unmasked, max_flux=float(want[:3].abs().max()),
         max_err_over_M_ulp=ulps, repeats_bit_for_bit=True,
         equal_to_ordered_bit_for_bit=True, **extra, **row)
    emit("k4_sass", **sass.report("dense_gather"))
    if parent is not None:
        emit("k4_sass", parent=True, **sass.report(
            "dense_gather", parent["cuda_lib"].build("dense_gather")))
    return row


def ordered_grid_S(lo_chunk, nc, qpT, qr2, qnsT, pdata, item_chunks):
    """K5's function with each query's sums taken as K5 takes them: per work
    item of at most item_chunks chunks one add per counted photon in
    (chunk, photon) order (the order of a test of every pair; the culled
    pairs add nothing), the items' partials added in item order → [4, NQ],
    for an equality bit for bit."""
    n_tiles, (n_chunks, _, chunk) = lo_chunk.shape[0], pdata.shape
    slots = n_tiles + int(nc.sum()) // item_chunks
    owner, lo, hi, first, count = work_items(lo_chunk, lo_chunk + nc,
                                             item_chunks, slots)
    n_items = int(count.sum())  # the items are the first slots
    owner, lo, hi = (x[:n_items].long() for x in (owner, lo, hi))
    qi = owner[:, None] * gg.TILE_Q + torch.arange(gg.TILE_Q,
                                                  device=qpT.device)
    qx, qy, qz, nx, ny, nz = (a[qi] for a in (*qpT, *qnsT))
    r2 = qr2[qi]
    acc = torch.zeros((4, n_items, gg.TILE_Q), device=qpT.device)
    steps = int((hi - lo).max()) * chunk if n_items else 0
    for s in range(steps):
        c = lo + s // chunk
        ph = pdata[c.clamp(max=n_chunks - 1), :, s % chunk]  # [items, 10]
        col = lambda row: ph[:, row, None]
        dx, dy, dz = qx - col(0), qy - col(1), qz - col(2)
        ok = (((dx * dx + dy * dy + dz * dz) < r2) & (col(6) > 0.0)
              & (c < hi)[:, None])
        w = torch.abs(nx * col(3) + ny * col(4) + nz * col(5))
        for ch in range(3):
            acc[ch] = torch.where(ok, acc[ch] + w * col(7 + ch), acc[ch])
        acc[3] = torch.where(ok, acc[3] + 1.0, acc[3])
    out = torch.zeros((4, n_tiles, gg.TILE_Q), device=qpT.device)
    for m in range(int(count.max()) if n_tiles else 0):
        has = count > m
        out[:, has] += acc[:, (first[has] + m).long()]
    return out.reshape(4, n_tiles * gg.TILE_Q)


def k5_counts(lo_chunk, nc, qpT, qr2, qnsT, pdata) -> dict:
    """What the plain form of K5's culls (`precull_plain`) leaves of a
    launch, computed by PyTorch on its inputs and not read from the
    kernel (whose output does not depend on the cull): the pair tests of
    the spans and those left after the photon cull with their share,
    the photons each warp keeps over its tile's span (their spread: a
    warp tests them one after another), the chunks in the spans, those a
    block stages (some warp of the tile reaches them) and the (warp,
    chunk) scans, and the chunks some span touches (read from memory at
    least once)."""
    cull = gg.precull_plain(lo_chunk, nc, qpT, qr2, pdata)
    jobs, chunk = cull["tile"].shape[0], pdata.shape[2]
    per_warp = torch.zeros((lo_chunk.shape[0], gg.WARPS), dtype=torch.int64,
                           device=qpT.device)
    per_warp.index_add_(0, cull["tile"], cull["keep"].sum(2))
    pairs = jobs * gg.TILE_Q * chunk
    left = int(cull["keep"].sum()) * gg.GROUP
    return dict(pair_tests=pairs, tests_after_precull=left,
                tests_after_precull_share=left / max(pairs, 1),
                warp_survivors=spread_stats(per_warp.flatten()),
                chunks_in_spans=jobs,
                chunks_staged=int(cull["reach"].any(1).sum()),
                warp_chunk_scans=int(cull["reach"].sum()),
                warp_chunk_pairs=jobs * gg.WARPS,
                chunks_touched=int(torch.unique(cull["chunk"]).numel()))


def _k5_item_chunks() -> int:
    return cuda_lib.load("grid_gather",
                         gg._SIGNATURES).grid_gather_item_chunks()


def _k5_exact(what: str, args) -> tuple:
    """K5 on args: counts M equal to the plain version's, S within its
    rounding bound, and the output equal bit for bit to `ordered_grid_S`
    and to a second launch → (the kernel's output, the plain version's,
    max abs error, max error in M·2^-24·S units)."""
    got = gg.grid_S(*args)
    again = gg.grid_S(*args)
    want = gg.grid_S_plain(*args)
    ordered = ordered_grid_S(*args, _k5_item_chunks())
    torch.cuda.synchronize()
    err, ulps = flux_check(f"K5 {what}", got, want)
    bits = lambda a: a.view(torch.int32)
    if not torch.equal(bits(got), bits(again)):
        raise AssertionError(f"K5 {what}: two launches on the same inputs "
                             "differ")
    if not torch.equal(bits(got), bits(ordered)):
        raise AssertionError(f"K5 {what}: S or M differ bit for bit from "
                             "the sums in item and photon index order")
    return got, want, err, ulps


def _k5_adversarial(dev) -> None:
    """K5 on the inputs tests/test_torch_grid_precull.py builds: K4's
    adversarial cases in 128-query tiles over chunks of 32 photons (spans
    of several work items), a span straddling a Morton octant boundary, an
    empty chunk inside the spans and a tile with an empty span. One row per
    case: the pairs the culls leave and those that count."""
    path = Path(__file__).resolve().parent / "tests" / \
        "test_torch_grid_precull.py"
    spec = importlib.util.spec_from_file_location("k5_cases", path)
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    for name in cases.CASES:
        args = cases.inputs(name, dev)
        want = _k5_exact(name, args)[1]
        lo, nc = args[:2]
        emit("k5_adversarial", case=name, tiles=lo.shape[0],
             chunks=args[5].shape[0], chunk=args[5].shape[2],
             items=_items(lo, lo + nc, _k5_item_chunks()),
             **k5_counts(*args), pairs_counted=float(want[3].sum()),
             counts_equal_to_plain=True, equal_to_ordered_bit_for_bit=True,
             repeats_bit_for_bit=True)


def phase_k5(scene, cfg, rec, r2, k_photon, parent=None):
    """K5 on the full-size frame's live queries against a 2^16-path wave,
    with the cell the largest live radius (JAX's contract): M equal to the
    plain version's, S within its rounding bound and equal bit for bit to
    `ordered_grid_S` (the kernel's order), two launches equal, and the
    parent's kernel within the same bound when given; the spans' spread,
    J, the work items and their scratch; the pair tests left after the
    exact pre-cull, the chunks staged (the plain cull's counts on these
    inputs); the kernel's device time (the profiler's kernel records), a
    whole call's (every device record of grid_S: the kernel and its prep)
    and host call time (CUDA events), in turns with the parent's; both
    bounds; the adversarial cases (k5_adversarial); SASS and registers
    (k5_sass)."""
    photons = photon.trace_photons(
        scene, dataclasses.replace(cfg, photon_paths=K5_PATHS), k_photon, 0)
    live_r2 = torch.where(rec.hit, r2, 0.0)
    cell = float(torch.sqrt(live_r2.max()))
    sp = gg.grid_spans(photons.p, photons.alpha, photons.wi, photons.valid,
                       cell, rec.p, live_r2, rec.ns)
    args = [sp[k] for k in ("lo_chunk", "nc", "qpT", "qr2", "qnsT", "pdata")]
    got, want, err, ulps = _k5_exact("headline", args)
    extra = {}
    pgg = None if parent is None else parent["grid_gather"]
    if pgg is not None:
        theirs = pgg.grid_S(*args)
        torch.cuda.synchronize()
        extra["parent_max_abs_diff"] = flux_check("K5 against the parent "
                                                  "kernel", theirs, got)[0]
    # the kernel alone, every device record of a grid_S call (the kernel,
    # the boxes and work items it needs, the zero-fills, the read of Σ nc)
    # and the host's call rate
    for what, measure in (
            ("device_ms", lambda fn: kernel_device_ms(
                fn, "grid_gather_kernel", 20)),
            ("call_device_ms", lambda fn: call_device_ms(
                fn, "grid_gather_kernel", 20)[0]),
            ("host_call_ms", lambda fn: cuda_ms(fn, 20))):
        for key, ms in in_turns(
                lambda: gg.grid_S(*args),
                None if pgg is None else lambda: pgg.grid_S(*args),
                measure).items():
            extra[f"{key}{what}_runs"] = ms
    extra["call_device_records"] = call_device_ms(
        lambda: gg.grid_S(*args), "grid_gather_kernel", 20)[1]
    plain_ms = cuda_ms(lambda: gg.grid_S_plain(*args), 1)
    counts = k5_counts(*args)
    lo, nc = args[:2]
    n_chunks, _, chunk = sp["pdata"].shape
    nq, n_tiles = sp["qr2"].shape[0], lo.shape[0]
    hits = float(want[3].sum())
    # each query read once (7 floats in, 4 out), each chunk some span
    # touches once (10 rows), each span (8 bytes)
    nbytes = (nq * (7 + 4) * 4 + counts["chunks_touched"] * chunk * 10 * 4
              + n_tiles * 8)
    full = bound(gather_ops(counts["pair_tests"], hits), nbytes)
    row = dict(max_abs_err=err, ms=statistics.median(extra["device_ms_runs"]),
               host_call_ms=statistics.median(extra["host_call_ms_runs"]),
               plain_ms=plain_ms,
               **bound(gather_ops(counts["tests_after_precull"], hits),
                       nbytes),
               bound_all_tests_ms=full["bound_ms"], library_ms=None)
    item_chunks = _k5_item_chunks()
    slots = n_tiles + int(nc.sum()) // item_chunks  # as the wrapper
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
         n_valid=int(photons.valid.sum()), cell=cell, tiles=n_tiles,
         chunks=n_chunks, span_chunks=spread_stats(nc.long()),
         item_chunks=item_chunks, items=_items(lo, lo + nc, item_chunks),
         work_slots=slots, scratch_bytes=slots * 4 * gg.TILE_Q * 4,
         **counts, pairs_counted=hits,
         max_flux=float(want[:3].abs().max()), max_err_over_M_ulp=ulps,
         repeats_bit_for_bit=True, equal_to_ordered_bit_for_bit=True,
         launches=launches, **extra, **row)
    _k5_adversarial(got.device)
    emit("k5_sass", **sass.report("grid_gather"))
    if parent is not None:
        emit("k5_sass", parent=True, **sass.report(
            "grid_gather", parent["cuda_lib"].build("grid_gather")))
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
    """The headline frame: a warm-up whose K1 calls are counted by route
    (closest hit, re-intersected, and any-hit, not), the median of
    `frames` frames with K1's and K2's launches, and one profiled frame's
    device busy time and device operations."""
    with recording(ti, "intersect_triangles") as closest, \
            recording(ti, "occluded_triangles") as any_hit, \
            recording(ti, "reintersect_winner") as reintersected:
        img = photon.render_photon(scene, cam, cfg, prng.PRNGKey(0, dev))
        torch.cuda.synchronize()  # warm-up: kernels loaded, allocator primed
    k1_calls = dict(closest=len(closest), any_hit=len(any_hit),
                    reintersections=len(reintersected))
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
    busy_s, _, _, device_ops = profiled(lambda: photon.render_photon(
        scene, cam, cfg, prng.PRNGKey(frames + 1, dev)))
    emit("main", size=SIZE, photon_paths=cfg.photon_paths, frames=frames,
         k1_calls_per_frame=k1_calls, profiled_frame=dict(
             device_busy_s=busy_s, device_ops=device_ops),
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


@contextlib.contextmanager
def world_of_one(backend: str):
    """A process group of this process alone (file:// rendezvous),
    destroyed on leaving."""
    device = (torch.device("cuda", torch.cuda.current_device())
              if backend == "nccl" else None)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                                world_size=1, rank=0, device_id=device)
        try:
            yield
        finally:
            dist.destroy_process_group()


def _rel_l1(a, b) -> float:
    return float((a - b).abs().sum() / b.abs().sum())


def _train_check(what: str, got: tuple, want: tuple) -> dict:
    """(loss, kd, intensity) against another run's within the CPU tests'
    bounds (tests/test_torch_sharded.py) → the relative errors."""
    loss_rel = abs(got[0] - want[0]) / abs(want[0])
    ok = (math.isfinite(got[0]) and loss_rel <= TRAIN_LOSS_RTOL
          and torch.allclose(got[1], want[1], rtol=TRAIN_PARAM_RTOL,
                             atol=TRAIN_KD_ATOL)
          and torch.allclose(got[2], want[2], rtol=TRAIN_PARAM_RTOL,
                             atol=TRAIN_INTENSITY_ATOL))
    out = dict(loss_rel=loss_rel, kd_rel_l1=_rel_l1(got[1], want[1]),
               intensity_rel_l1=_rel_l1(got[2], want[2]))
    if not ok:
        raise AssertionError(f"{what}: train step off: {out}")
    return out


def phase_sharded_reference(dev):
    """render_photon_sharded and train_step_sharded at 32×32: world 1 over
    NCCL on the card against world 1 over gloo on the CPU."""
    cfg = RenderConfig(**dict(BENCH, width=32, height=32,
                              photon_paths=1 << 12))
    out = []
    for device, backend in ((dev, "nccl"), (torch.device("cpu"), "gloo")):
        with world_of_one(backend):
            mesh = sharded.make_mesh(device.type)
            scene, cam = presets.cornell_box(device, 32, ball="glass")
            key = prng.PRNGKey(0, device)
            img = sharded.render_photon_sharded(scene, cam, cfg, key, mesh)
            loss, new = sharded.train_step_sharded(
                diff.extract_params(scene),
                torch.zeros((32, 32, 3), device=device), scene, cam,
                grad_config(cfg), key, mesh)
        out.append((img.cpu(), float(loss), new.kd.cpu(),
                    new.intensity.cpu()))
    (gpu, *g_train), (cpu, *c_train) = out
    rel_l1 = _rel_l1(gpu, cpu)
    off = float(((gpu - cpu).abs().amax(-1)
                 > 1e-3 * cpu.amax(-1).clamp(min=1.0)).float().mean())
    if not (torch.isfinite(gpu).all() and rel_l1 <= REF_REL_L1
            and off <= REF_OFF_FRAC):
        raise AssertionError(f"sharded 32x32 frame: rel L1 {rel_l1}, {off} "
                             "of the pixels off against the CPU")
    train = _train_check("sharded_reference", tuple(g_train), tuple(c_train))
    emit("sharded_reference", size=32, world=1, backends=["nccl", "gloo"],
         rel_l1=rel_l1, off_pixel_frac=off, train=train)


@contextlib.contextmanager
def wave_events(module, name):
    """Record a CUDA event on the current stream at each call of
    module.<name> (no synchronize) → the list of events."""
    orig = getattr(module, name)
    events = []

    def timed(*args, **kw):
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        return orig(*args, **kw)

    setattr(module, name, timed)
    try:
        yield events
    finally:
        setattr(module, name, orig)


def phase_sharded(dev, scene, cam, cfg, main_launches, main_frames,
                  frames=5):
    """render_photon_sharded at the headline on world 1 over NCCL: frames in
    turns with render_photon's, launches against phase main's, the 8-wave
    headline with the device time between gather passes, one profiled
    frame; then render_photon's frames with no process group alive."""
    with world_of_one("nccl"):
        mesh = sharded.make_mesh("cuda")
        sharded.render_photon_sharded(scene, cam, cfg, prng.PRNGKey(0, dev),
                                      mesh)
        torch.cuda.synchronize()
        times, plain, auxes = [], [], []
        launches = {"k1": 0, "k2": 0}
        for i in range(frames):
            ti.closest_hit.launches = 0
            rg.rowspan_S.launches = 0
            t0 = time.perf_counter()
            img, aux = sharded.render_photon_sharded(
                scene, cam, cfg, prng.PRNGKey(i + 1, dev), mesh,
                return_aux=True)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            launches["k1"] += ti.closest_hit.launches
            launches["k2"] += rg.rowspan_S.launches
            auxes.append(aux)
            t0 = time.perf_counter()
            photon.render_photon(scene, cam, cfg, prng.PRNGKey(i + 1, dev))
            torch.cuda.synchronize()
            plain.append(time.perf_counter() - t0)
        mcfg = RenderConfig(**MULTIWAVE)
        rg.rowspan_S.launches = 0
        with wave_events(photon, "gathering_pass") as events:
            t0 = time.perf_counter()
            mimg, maux = sharded.render_photon_sharded(
                scene, cam, mcfg, prng.PRNGKey(0, dev), mesh,
                return_aux=True)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            torch.cuda.synchronize()
            multi_s = time.perf_counter() - t0
        multi_k2 = rg.rowspan_S.launches
        busy_s, _, _, device_ops = profiled(
            lambda: sharded.render_photon_sharded(
                scene, cam, cfg, prng.PRNGKey(frames + 1, dev), mesh))
    # render_photon again with no process group alive: NCCL's threads gone
    alone = []
    for i in range(frames):
        t0 = time.perf_counter()
        photon.render_photon(scene, cam, cfg, prng.PRNGKey(i + 1, dev))
        torch.cuda.synchronize()
        alone.append(time.perf_counter() - t0)
    per_frame = {k: v / frames for k, v in launches.items()}
    for what, im, ax in (("sharded", img, auxes), ("sharded 8 waves", mimg,
                                                    [maux])):
        if im.shape != (SIZE, SIZE, 3) or not bool(torch.isfinite(im).all()):
            raise AssertionError(f"{what}: image not finite or mis-shaped")
        if not float(im.mean()) > 0.0:
            raise AssertionError(f"{what}: black image")
        for a in ax:
            if a["gather_overflow"] or a["pair_overflow"] or \
                    a["valid_photons"] <= 0:
                raise AssertionError(f"{what}: counters {a}")
    main_per_frame = {k: main_launches[k] / main_frames for k in launches}
    if per_frame != main_per_frame:
        raise AssertionError(f"sharded: launches a frame {per_frame}, phase "
                             f"main's {main_per_frame}")
    if multi_k2 != mcfg.photon_passes:
        raise AssertionError(f"sharded 8 waves: {multi_k2} K2 launches")
    wave_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:] + [end])]
    frame_s = statistics.median(times)
    emit("sharded", size=SIZE, world=1, backend="nccl",
         photon_paths=cfg.photon_paths, frames=frames, frame_s=times,
         frame_s_median=frame_s, render_photon_frame_s=plain,
         render_photon_frame_s_median=statistics.median(plain),
         render_photon_no_group_frame_s=alone,
         render_photon_no_group_frame_s_median=statistics.median(alone),
         profiled_frame=dict(device_busy_s=busy_s, device_ops=device_ops,
                             device_idle_frac=1.0 - busy_s / frame_s),
         rays_per_s=SIZE * SIZE * cfg.spp / frame_s,
         launches=launches, launches_per_frame=per_frame,
         gather_overflow=0, pair_overflow=0,
         valid_photons=auxes[-1]["valid_photons"],
         image_mean=float(img.mean()),
         multiwave=dict(waves=mcfg.photon_passes, wall_s=multi_s,
                        gather_pass_to_next_ms=wave_ms, k2_launches=multi_k2,
                        valid_photons=maux["valid_photons"],
                        image_mean=float(mimg.mean())))
    return launches


def phase_sharded_train(dev, scene, cam, cfg, grad_step_s, steps=3):
    """train_step_sharded at the headline on world 1 over NCCL: a warm-up,
    then `steps` steps with keys folded from key 0 in turns with
    loss_and_grad's, beside phase grad's median."""
    gcfg = grad_config(cfg)
    params = diff.extract_params(scene)
    target = torch.zeros((SIZE, SIZE, 3), device=dev)
    key = prng.PRNGKey(0, dev)
    times, plain = [], []
    with world_of_one("nccl"), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mesh = sharded.make_mesh("cuda")
        sharded.train_step_sharded(params, target, scene, cam, gcfg, key,
                                   mesh, lr=SHARDED_LR)
        torch.cuda.synchronize()
        launches = {"k1": 0, "k2": 0, "k3": 0}
        ls = common.static_light_samples(scene, gcfg)
        for i in range(steps):
            ti.closest_hit.launches = 0
            rg.rowspan_S.launches = 0
            rg.rowspan_S_bwd.launches = 0
            t0 = time.perf_counter()
            loss, new = sharded.train_step_sharded(
                params, target, scene, cam, gcfg, prng.fold_in(key, i + 1),
                mesh, lr=SHARDED_LR)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            launches["k1"] += ti.closest_hit.launches
            launches["k2"] += rg.rowspan_S.launches
            launches["k3"] += rg.rowspan_S_bwd.launches
            t0 = time.perf_counter()
            diff.loss_and_grad(params, target, scene, cam, gcfg,
                               prng.fold_in(key, i + 1), ls, False)
            torch.cuda.synchronize()
            plain.append(time.perf_counter() - t0)
    overflows = [str(w.message) for w in caught
                 if "overflow" in str(w.message)]
    g_kd = (params.kd - new.kd) / SHARDED_LR
    g_int = (params.intensity - new.intensity) / SHARDED_LR
    glass = scene.materials.mtype == GLASS
    if launches["k3"] != steps or min(launches.values()) <= 0:
        raise AssertionError(f"sharded_train: launches {launches}")
    if not (math.isfinite(float(loss)) and torch.isfinite(g_kd).all()
            and torch.isfinite(g_int).all()
            and float(g_kd.abs().sum()) > 0.0):
        raise AssertionError("sharded_train: loss or gradients not finite, "
                             "or kd's zero")
    if not torch.equal(new.kd[glass], params.kd[glass]):
        raise AssertionError(f"sharded_train: glass kd moved {g_kd[glass]}")
    if overflows:
        raise AssertionError(f"sharded_train: overflow: {overflows}")
    step_s = statistics.median(times)
    emit("sharded_train", size=SIZE, world=1, backend="nccl", steps=steps,
         step_s=times, step_s_median=step_s,
         loss_and_grad_step_s=plain,
         loss_and_grad_step_s_median=statistics.median(plain),
         grad_step_s_median=grad_step_s,
         loss=float(loss), grad_kd_abs_sum=float(g_kd.abs().sum()),
         grad_intensity=g_int.tolist(), launches=launches)
    return launches


def gloo_cuda_collectives(dev) -> dict:
    """The collectives the sharded path runs, on CUDA tensors over the
    default (gloo) group, each checked for its result → {name: True}.
    A collective gloo lacks for CUDA tensors raises, naming it."""
    world, rank = dist.get_world_size(), dist.get_rank()
    x = torch.full((5,), float(rank + 1), device=dev)
    want = torch.cat([torch.full((5,), float(r + 1), device=dev)
                      for r in range(world)])

    def all_gather():
        out = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(out, x)
        return torch.equal(torch.cat(out), want)

    def all_gather_async():
        out = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(out, x, async_op=True).wait()
        return torch.equal(torch.cat(out), want)

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return bool((y == world * (world + 1) / 2).all())

    def barrier():
        dist.barrier()
        return True

    found = {}
    for fn in (all_gather, all_gather_async, all_reduce, barrier):
        try:
            found[fn.__name__] = fn()
        except RuntimeError as e:
            raise AssertionError(f"gloo lacks {fn.__name__} for CUDA "
                                 f"tensors: {e}") from e
        if not found[fn.__name__]:
            raise AssertionError(f"gloo {fn.__name__} on CUDA tensors gave a "
                                 "wrong result")
    return found


def _sharded_runs(dev, mesh) -> dict:
    """The frame at run_scaling's settings (its second call timed) and a
    64×64 train step, on `mesh`."""
    scene, cam = presets.cornell_box(dev, SCALING["width"], ball="glass")
    cfg = RenderConfig(**SCALING)
    key = prng.PRNGKey(0, dev)
    sharded.render_photon_sharded(scene, cam, cfg, key, mesh)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    img, aux = sharded.render_photon_sharded(scene, cam, cfg, key, mesh,
                                             return_aux=True)
    torch.cuda.synchronize(dev)
    frame_s = time.perf_counter() - t0
    t = SHARDED_TRAIN_SIZE
    tscene, tcam = presets.cornell_box(dev, t, ball="glass")
    loss, new = sharded.train_step_sharded(
        diff.extract_params(tscene), torch.zeros((t, t, 3), device=dev),
        tscene, tcam, grad_config(RenderConfig(**dict(SCALING, width=t,
                                                      height=t))),
        key, mesh, lr=SHARDED_LR)
    return dict(img=img.cpu(), aux=aux, frame_s=frame_s,
                train=(float(loss), new.kd.cpu(), new.intensity.cpu()))


def _gloo_rank_on_card(rank: int, store: str, device: str) -> dict:
    """One of two processes on `device` (card 0) in a gloo group (NCCL
    refuses two ranks on one device): the collectives checked, then
    _sharded_runs."""
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=2, rank=rank)
    try:
        collectives = gloo_cuda_collectives(dev)
        out = _sharded_runs(dev, sharded.make_mesh(dev.type))
        loss, kd, intensity = out.pop("train")
        return dict(out, collectives=collectives, loss=loss, kd=kd,
                    intensity=intensity)
    finally:
        dist.destroy_process_group()


def phase_sharded_2proc(dev):
    """Two processes on the one card over gloo against world 1 over NCCL in
    this process, at run_scaling's settings and a 64×64 train step."""
    with world_of_one("nccl"):
        one = _sharded_runs(dev, sharded.make_mesh("cuda"))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = launch.spawn(_gloo_rank_on_card, 2,
                             (os.path.join(tmp, "store"), str(dev)),
                             threads=2)
    spawn_s = time.perf_counter() - t0
    for r, got in enumerate(ranks):
        if not torch.allclose(got["img"], one["img"], rtol=SHARD_RTOL,
                              atol=SHARD_ATOL):
            diff_max = float((got["img"] - one["img"]).abs().max())
            raise AssertionError(f"sharded_2proc: rank {r}'s frame off world "
                                 f"1's by up to {diff_max}")
        if got["aux"]["gather_overflow"] or got["aux"]["pair_overflow"]:
            raise AssertionError(f"sharded_2proc: counters {got['aux']}")
    train = _train_check("sharded_2proc", (ranks[0]["loss"], ranks[0]["kd"],
                                           ranks[0]["intensity"]),
                         one["train"])
    emit("sharded_2proc", size=SCALING["width"], world=2, backend="gloo",
         collectives=ranks[0]["collectives"],
         frame_max_abs=max(float((g["img"] - one["img"]).abs().max())
                           for g in ranks),
         frame_s=[g["frame_s"] for g in ranks], world1_frame_s=one["frame_s"],
         world1_backend="nccl", spawn_and_run_s=spawn_s,
         valid_photons=ranks[0]["aux"]["valid_photons"],
         train_size=SHARDED_TRAIN_SIZE, train=train,
         image_mean=float(one["img"].mean()))


def phase_scaling(dev):
    """scaling_report at run_scaling's settings on world 1 over NCCL: the
    rays/s of the one count this card can run; no efficiency."""
    scene, cam = presets.cornell_box(dev, SCALING["width"], ball="glass")
    with world_of_one("nccl"):
        rep = multihost.scaling_report(scene, cam, RenderConfig(**SCALING),
                                       prng.PRNGKey(0, dev))
    if set(rep) != {1} or not rep[1] > 0:
        raise AssertionError(f"scaling: report {rep}")
    emit("scaling", size=SCALING["width"], photon_paths=SCALING[
        "photon_paths"], counts=[1], rays_per_s={"1": rep[1]},
         efficiency=None, card_count=torch.cuda.device_count())


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


def tree_diff(got, want, path: str = "") -> dict:
    """Two port dataclasses (a scene or a camera), field by field →
    {field: largest absolute difference} over the float fields. An int or
    bool field that differs, a shape, a dtype, a device or a None on one
    side only raises."""
    out = {}
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        name = f"{path}.{f.name}"
        if dataclasses.is_dataclass(a):
            out.update(tree_diff(a, b, name))
        elif a is None or b is None:
            if a is not None or b is not None:
                raise AssertionError(f"{name}: None on one side only")
        elif isinstance(a, torch.Tensor):
            if (a.shape, a.dtype, a.device) != (b.shape, b.dtype, b.device):
                raise AssertionError(f"{name}: {a.shape} {a.dtype} {a.device} "
                                     f"against {b.shape} {b.dtype} {b.device}")
            if not a.is_floating_point():
                if not torch.equal(a, b):
                    raise AssertionError(f"{name}: values differ")
            else:  # equal infinities (padding boxes) count as 0
                d = torch.where(a == b, 0.0, (a - b).abs())
                out[name] = float(d.max()) if d.numel() else 0.0
        elif isinstance(a, float):
            out[name] = abs(a - b)
        elif a != b:
            raise AssertionError(f"{name}: {a} against {b}")
    return out


def cornell_pbrt(tmp: str) -> str:
    """examples/cornell.pbrt with its Film at SIZE×SIZE, written into tmp."""
    text = CORNELL_PBRT.read_text()
    film = '"integer xresolution" [128] "integer yresolution" [128]'
    if film not in text:
        raise AssertionError(f"{CORNELL_PBRT} has no 128×128 Film line")
    path = os.path.join(tmp, f"cornell{SIZE}.pbrt")
    with open(path, "w") as f:
        f.write(text.replace(film, film.replace("128", str(SIZE))))
    return path


def phase_pbrt(dev, card, tmp):
    """examples/cornell.pbrt at SIZE×SIZE through load_pbrt on the card:
    every array of the scene and camera against presets.cornell_box (ints
    equal, floats within 1e-6), and the parse's host seconds → the file's
    path."""
    path = cornell_pbrt(tmp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    parsed = load_pbrt(path, dev)
    torch.cuda.synchronize()
    parse_s = time.perf_counter() - t0
    scene, cam = presets.cornell_box(dev, SIZE, ball="glass")
    opts = (parsed.width, parsed.height, parsed.spp, parsed.renderer,
            parsed.pixel_filter)
    if opts != (SIZE, SIZE, 1, "photonmapping", "box"):
        raise AssertionError(f"pbrt: film and options {opts}")
    diffs = {**tree_diff(parsed.scene, scene, "scene"),
             **tree_diff(parsed.camera, cam, "camera")}
    worst = max(diffs, key=diffs.get)
    if not diffs[worst] <= PBRT_ATOL:
        raise AssertionError(f"pbrt: {worst} differs by {diffs[worst]}")
    emit("pbrt", nvidia_smi=card, file=os.path.basename(path), size=SIZE,
         parse_s=parse_s, float_fields=len(diffs),
         max_abs_diff=diffs[worst], worst_field=worst, ints_equal=True)
    return path


def run_cli(argv: list) -> tuple[str, float]:
    """cli.main(argv) in this process, overflow warnings refused → (what it
    printed, host seconds)."""
    buf = io.StringIO()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        wall_s = time.perf_counter() - t0
    overflows = [str(w.message) for w in caught
                 if "overflow" in str(w.message)]
    if overflows:
        raise AssertionError(f"CLI {argv}: {overflows}")
    return buf.getvalue(), wall_s


def cli_printed(out: str) -> dict:
    """The CLI's printed render time and rates."""
    m = re.search(r"rendered in (\S+)s\s+\((\S+) Mrays/s, (\S+) Mphotons/s\)",
                  out)
    if m is None:
        raise AssertionError(f"the CLI printed no render line: {out!r}")
    return dict(render_s=float(m[1]), mrays_per_s=float(m[2]),
                mphotons_per_s=float(m[3]))


def read_image(path: str, dev) -> torch.Tensor:
    return torch.from_numpy(image.read_pfm(path)).to(dev)


def direct_frames(scene, cam, cfg, key, n: int = 4):
    """render_photon n times with one key: a warm-up and n - 1 timed frames
    → (the first image, the frames' largest max-abs difference from it,
    the timed frames' seconds, the first frame's aux)."""
    imgs, times, auxes = [], [], []
    for _ in range(n):
        t0 = time.perf_counter()
        img, aux = photon.render_photon(scene, cam, cfg, key,
                                        return_aux=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        imgs.append(img)
        auxes.append(aux)
    spread = max(float((img - imgs[0]).abs().max()) for img in imgs[1:])
    return imgs[0], spread, times[1:], auxes[0]


def frame_check(what: str, img, ref) -> float:
    """img finite and not black, within the §2 frame bound (relative L1
    REF_REL_L1) of ref → that relative L1."""
    rel_l1 = float((img - ref).abs().sum() / ref.abs().sum())
    if not (bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0
            and rel_l1 <= REF_REL_L1):
        raise AssertionError(f"{what}: rel L1 {rel_l1} against the preset's "
                             f"frame, mean {float(img.mean())}")
    return rel_l1


def phase_cli(dev, card, path, tmp):
    """raytrace-tpu-torch in this process on the SIZE×SIZE Cornell file at
    the headline's paths: its frame against render_photon on the parsed
    scene (bit for bit, or within the spread of the direct renders) and
    against the preset's frame; K1 and K2 launches over the call; its
    printed time beside the direct render's; a checkpointed run resumed;
    the simple renderer; examples/render_pbrt_torch.py as a subprocess."""
    paths = BENCH["photon_paths"]
    flags = ["--photon-paths", str(paths), "--footprint-radius-scale", "8",
             "--seed", "0"]
    cfg = RenderConfig(width=SIZE, height=SIZE, spp=1, scene_epsilon=1e-3,
                       photon_paths=paths, seed=0, footprint_radius_scale=8.0)
    key = prng.PRNGKey(0, dev)
    parsed = load_pbrt(path, dev)
    direct, spread, direct_s, aux = direct_frames(parsed.scene,
                                                  parsed.camera, cfg, key)
    if int(aux["gather_overflow"]) or aux["pair_overflow"]:
        raise AssertionError(f"cli: direct render overflow {aux}")
    ti.closest_hit.launches = 0
    rg.rowspan_S.launches = 0
    out, cli_wall_s = run_cli([path, *flags, "-o", f"{tmp}/cli.pfm"])
    launches = {"k1": ti.closest_hit.launches, "k2": rg.rowspan_S.launches}
    if min(launches.values()) <= 0:
        raise AssertionError(f"cli: a kernel was not launched: {launches}")
    got = read_image(f"{tmp}/cli.pfm", dev)
    cli_diff = float((got - direct).abs().max())
    if got.shape != (SIZE, SIZE, 3) or not cli_diff <= spread:
        raise AssertionError(f"cli: frame differs from render_photon by "
                             f"{cli_diff} (direct renders: {spread})")
    scene, cam = presets.cornell_box(dev, SIZE, ball="glass")
    preset_rel = frame_check("cli", got, photon.render_photon(scene, cam,
                                                              cfg, key))
    # a checkpointed run of 2 waves resumed to 4 against 4 in one call
    ck = f"{tmp}/cli.ckpt"
    run_cli([path, *flags, "--passes", "2", "--checkpoint", ck, "-o",
             f"{tmp}/half.pfm"])
    run_cli([path, *flags, "--passes", "4", "--checkpoint", ck, "-o",
             f"{tmp}/resumed.pfm"])
    run_cli([path, *flags, "--passes", "4", "-o", f"{tmp}/whole.pfm"])
    resumed = read_image(f"{tmp}/resumed.pfm", dev)
    whole = read_image(f"{tmp}/whole.pfm", dev)
    resume_diff = float((resumed - whole).abs().max())
    waves_done = ckpt.load_progressive(ck, dev)[1]
    if not resume_diff <= spread or waves_done != 4:
        raise AssertionError(f"cli: resumed frame differs by {resume_diff} "
                             f"(direct renders: {spread}), {waves_done} "
                             "waves in the checkpoint")
    frame_check("cli resumed", resumed, whole)
    ti.closest_hit.launches = 0
    run_cli([path, *flags, "--renderer", "simple", "-o", f"{tmp}/simple.pfm"])
    simple_k1 = ti.closest_hit.launches
    simple_img = read_image(f"{tmp}/simple.pfm", dev)
    if simple_k1 <= 0 or not (bool(torch.isfinite(simple_img).all())
                              and float(simple_img.mean()) > 0.0):
        raise AssertionError(f"cli --renderer simple: K1 {simple_k1}, image "
                             f"mean {float(simple_img.mean())}")
    png = f"{tmp}/example.png"
    proc = subprocess.run(
        [sys.executable, "examples/render_pbrt_torch.py",
         "examples/cornell.pbrt", "-o", png],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=600)
    if proc.returncode != 0 or not os.path.getsize(png):
        raise AssertionError(f"examples/render_pbrt_torch.py exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    direct_median = statistics.median(direct_s)
    emit("cli", nvidia_smi=card, size=SIZE, photon_paths=paths,
         launches=launches, cli_printed=cli_printed(out),
         cli_wall_s=cli_wall_s, direct_s=direct_s,
         direct_median_s=direct_median,
         direct_rays_per_s=SIZE * SIZE / direct_median,
         direct_photons_per_s=paths / direct_median,
         direct_spread_max_abs=spread, cli_max_abs_diff=cli_diff,
         bit_for_bit=cli_diff == 0.0, preset_rel_l1=preset_rel,
         resume_max_abs_diff=resume_diff, resume_bit_for_bit=resume_diff == 0.0,
         simple_launches={"k1": simple_k1},
         example_png_bytes=os.path.getsize(png),
         image_mean=float(got.mean()))


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
    scene_build line) → (scene, camera, build seconds)."""
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
    return scene, cam, total_s


def pbrt_mesh_text(verts, idx) -> str:
    """triangle_field's scene as pbrt-v2 text, every float64 vertex printed
    with repr so that it reads back exactly."""
    floats = " ".join(repr(float(x)) for x in verts.ravel())
    ints = " ".join(map(str, idx.ravel().tolist()))
    return "\n".join([
        "LookAt 0 -14 9  0 0 0  0 0 1",
        'Camera "perspective" "float fov" [55]',
        f'Film "image" "integer xresolution" [{SIZE}] '
        f'"integer yresolution" [{SIZE}]',
        "WorldBegin",
        'Material "matte" "rgb Kd" [0.55 0.55 0.6]',
        f'Shape "trianglemesh" "integer indices" [{ints}]',
        f'  "point P" [{floats}]',
        'LightSource "point" "rgb I" [500 500 500] "point from" [0 0 14]',
        "WorldEnd", ""])


def phase_pbrt_large(dev, card, tmp):
    """triangle_field(1 << 16, SIZE) written as a pbrt file, parsed on the
    card (host seconds and tokens/s of the parse, apart from the builder's
    SAH, cluster and upload seconds) and held against the preset: scene
    tensors equal, camera within 1e-6. Then rendered through the CLI at the
    headline's paths: K6-K9 and K2 launches, overflow 0, the frame against
    render_photon on the parsed scene and the preset's frame."""
    verts, idx = presets.terrain_mesh(PBRT_LARGE_TRIS)
    path = f"{tmp}/triangle_field.pbrt"
    text = pbrt_mesh_text(verts, idx)
    with open(path, "w") as f:
        f.write(text)
    tokens = sum(1 for _ in pbrt._tokenize(text))
    log = _BuildLog()
    logger = logging.getLogger("raytrace_tpu_torch")
    logger.addHandler(log)
    logger.setLevel(logging.INFO)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parsed = load_pbrt(path, dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        logger.removeHandler(log)
    f = log.fields
    build_s = float(f["bvh_s"]) + float(f["clusters_s"]) + float(f["upload_s"])
    parse_s = load_s - build_s
    scene, cam = presets.triangle_field(dev, PBRT_LARGE_TRIS, SIZE)
    if parsed.scene.clusters is None or int(f["triangles"]) != (
            PBRT_LARGE_TRIS):
        raise AssertionError(f"pbrt_large: no cluster set, or {f}")
    scene_diff = tree_diff(parsed.scene, scene, "scene")
    unequal = [k for k, v in scene_diff.items() if v != 0.0]
    cam_diff = tree_diff(parsed.camera, cam, "camera")
    cam_worst = max(cam_diff.values())
    if unequal or not cam_worst <= PBRT_ATOL:
        raise AssertionError(f"pbrt_large: scene fields {unequal} differ, "
                             f"camera by {cam_worst}")
    paths = BENCH["photon_paths"]
    flags = ["--photon-paths", str(paths), "--footprint-radius-scale", "8",
             "--seed", "0"]
    cfg = RenderConfig(width=SIZE, height=SIZE, spp=1, scene_epsilon=1e-3,
                       photon_paths=paths, seed=0, footprint_radius_scale=8.0)
    key = prng.PRNGKey(0, dev)
    direct, spread, direct_s, aux = direct_frames(parsed.scene,
                                                  parsed.camera, cfg, key)
    if int(aux["gather_overflow"]) or aux["pair_overflow"]:
        raise AssertionError(f"pbrt_large: overflow {aux}")
    _reset_kernel_counts()
    out, cli_wall_s = run_cli([path, *flags, "-o", f"{tmp}/large.pfm"])
    counts = _kernel_counts()
    if min(counts.values()) <= 0:
        raise AssertionError(f"pbrt_large: a kernel was not launched: "
                             f"{counts}")
    got = read_image(f"{tmp}/large.pfm", dev)
    cli_diff = float((got - direct).abs().max())
    if not cli_diff <= spread:
        raise AssertionError(f"pbrt_large: frame differs from render_photon "
                             f"by {cli_diff} (direct renders: {spread})")
    preset_rel = frame_check("pbrt_large", got, photon.render_photon(
        scene, cam, cfg, key))
    direct_median = statistics.median(direct_s)
    emit("pbrt_large", nvidia_smi=card, triangles=PBRT_LARGE_TRIS,
         vertices=int(verts.shape[0]), file_bytes=len(text), tokens=tokens,
         load_s=load_s, parse_s=parse_s, build_s=build_s,
         tokens_per_s=tokens / parse_s, camera_max_abs_diff=cam_worst,
         scene_bit_for_bit=True, launches=counts,
         pair_overflow=int(aux["pair_overflow"]),
         gather_overflow=int(aux["gather_overflow"]),
         cli_printed=cli_printed(out), cli_wall_s=cli_wall_s,
         direct_s=direct_s, direct_median_s=direct_median,
         direct_spread_max_abs=spread, cli_max_abs_diff=cli_diff,
         bit_for_bit=cli_diff == 0.0, preset_rel_l1=preset_rel,
         image_mean=float(got.mean()))


# ---------------------------------------------------------------------------
# Edge gradients (raytrace_tpu_torch/diff/edges.py)
# ---------------------------------------------------------------------------

def edge_scenes():
    """tests/torch_edge_scenes.py: the scenes of the edge-gradient tests on
    the port's builder, an icosphere, and the bound `dimg_check` the CPU
    tests hold the port to (numpy and the port only)."""
    path = Path(__file__).resolve().parent / "tests" / "torch_edge_scenes.py"
    spec = importlib.util.spec_from_file_location("edge_scenes", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _tensor(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)


def _edge_reference_calls(es, size=32):
    """The 32×32 calls of tests/test_torch_edges.py and
    tests/test_torch_penumbra.py → {name: fn(device) → dimg}."""
    theta = EDGE_REF_THETA
    cfg = RenderConfig(width=size, height=size, spp=1, scene_epsilon=1e-3)
    pcfg = dataclasses.replace(cfg, max_light_samples=es.N_LIGHT)
    vel_ends = np.random.default_rng(7).normal(size=(4, 2, 3)).astype(
        np.float32)

    def quad(vel):
        def call(device):
            e0, e1 = edges.quad_boundary_edges(
                _tensor(es.occ_corners(theta), device))
            return edges.shadow_boundary_image_grad(
                es.quad_scene(device, theta), es.camera(device, size), cfg,
                e0, e1, vel, samples_per_edge=64)
        return call

    def cube(in_view):
        def call(device):
            scene, v, f = (es.in_view_cube_scene(device, 0.0) if in_view
                           else es.cube_scene(device, theta))
            verts = _tensor(v, device)
            e0, e1, mask = edges.silhouette_edges(verts, f,
                                                  scene.lights.o[0])
            aabb = ((verts.amin(0), verts.amax(0)) if in_view else None)
            return edges.shadow_boundary_image_grad(
                scene, es.camera(device, size), cfg, e0, e1, es.X,
                samples_per_edge=64, edge_mask=mask, occluder_aabb=aabb)
        return call

    def primary(device):
        scene, v, f = es.in_view_cube_scene(device, 0.0)
        cam = es.camera(device, size)
        e0, e1, mask, fn = edges.silhouette_edges_full(
            _tensor(v, device), f, cam.camera_to_world[:, 3])
        return edges.primary_boundary_image_grad(
            scene, cam, cfg, e0, e1, es.X, samples_per_edge=64,
            edge_mask=mask, front_normal=fn, front_mat=1)

    def area(device):
        verts = es.penumbra_base_verts() + theta * es.X
        return edges.area_shadow_boundary_image_grad(
            es.penumbra_scene(device, verts), es.camera(device, size), pcfg,
            verts, es.QUAD_FACES, es.X, samples_per_edge=64,
            n_light_samples=es.N_LIGHT)

    return {"shadow_quad": quad(es.X), "shadow_quad_per_endpoint":
            quad(vel_ends), "shadow_cube_mask": cube(False),
            "shadow_in_view_aabb": cube(True),
            "primary_front_normal": primary, "area": area}


def _joint_reference_call(es, device, size=32):
    """tests/test_torch_penumbra.py's joint_loss_and_grad under the disk
    light → (loss, g kd, g intensity, g_theta, image) as numpy."""
    target = _tensor(np.random.default_rng(4).uniform(
        0.0, 0.3, (size, size, 3)), device)
    build = es.penumbra_builder(device)
    base = es.penumbra_base_verts()
    s0 = build(_tensor(base, device))
    params = diff.SceneParams(kd=s0.materials.kd,
                              intensity=s0.lights.intensity)
    cfg = RenderConfig(width=size, height=size, spp=4, scene_epsilon=1e-3,
                       max_light_samples=es.N_LIGHT)
    loss, g, g_theta, img = edges.joint_loss_and_grad(
        params, EDGE_REF_THETA, es.X, base, es.QUAD_FACES, build,
        es.camera(device, size), cfg, target, prng.PRNGKey(23, device),
        samples_per_edge=64, n_light_samples=8)
    return tuple(_host(x) for x in (loss, g.kd, g.intensity, g_theta, img))


def phase_edges_reference(dev, card, es):
    """The CPU twin tests' 32×32 edge-gradient calls on the card against the
    same calls on the CPU: each within the CPU tests' bounds plus what two
    card runs of it differ by."""
    rows = {}
    for name, call in _edge_reference_calls(es).items():
        a, b = _host(call(dev)), _host(call(dev))
        rows[name] = dict(es.dimg_check(a, _host(call("cpu")),
                                        spread=np.abs(a - b)),
                          run_to_run_max_abs=float(np.abs(a - b).max()))
    a, b = (_joint_reference_call(es, dev), _joint_reference_call(es, dev))
    want = _joint_reference_call(es, "cpu")
    joint = {}
    for name, x, y, w in zip(("loss", "g_kd", "g_intensity", "g_theta",
                              "image"), a, b, want):
        # as the CPU tests hold them: the image to relative L1, a gradient
        # array to rtol and atol of its largest entry, a scalar to rtol
        spread = np.abs(x - y)
        err = np.abs(x - w)
        if name == "image":
            ok = err.sum() <= es.REL_L1 * np.abs(w).sum() + spread.sum()
        else:
            atol = np.abs(w).max() if w.ndim else 0.0
            ok = bool((err <= es.SCALAR_REL * (np.abs(w) + atol)
                       + spread).all())
        if not (ok and np.isfinite(x).all()):
            raise AssertionError(f"edges_reference joint {name}: card "
                                 f"{x} against the CPU's {w}")
        joint[name] = dict(max_abs_err=float(err.max()),
                           run_to_run_max_abs=float(spread.max()))
    emit("edges_reference", nvidia_smi=card, size=32, calls=rows,
         joint=joint)


def _timed_calls(fn, calls: int):
    """fn() `calls` times on the host clock, each around work that ends in
    torch.cuda.synchronize() → (seconds, results)."""
    times, outs = [], []
    for _ in range(calls):
        t0 = time.perf_counter()
        outs.append(fn())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times, outs


@contextlib.contextmanager
def k1_routes():
    """K1's calls by route as phase main counts them (closest hit, any-hit)
    and its launches, over the block → the dict yielded, filled on exit."""
    counts = {}
    ti.closest_hit.launches = 0
    with recording(ti, "intersect_triangles") as closest, \
            recording(ti, "occluded_triangles") as any_hit:
        yield counts
        torch.cuda.synchronize()
    counts.update(closest=len(closest), any_hit=len(any_hit),
                  launches=ti.closest_hit.launches)


def _estimator(fn, calls: int = 5):
    """One call with K1's calls counted by route, then `calls` timed calls
    → (the first timed result, its row: seconds, their median, K1 per call,
    the largest difference between two runs)."""
    with k1_routes() as k1:
        fn()
    times, outs = _timed_calls(fn, calls)
    return outs[0], dict(s=times, s_median=statistics.median(times),
                         k1_per_call=k1, run_to_run_max_abs=float(
                             (outs[0] - outs[1]).abs().max()))


def _fd_check(what: str, fd: float, ad: float, bound: float) -> dict:
    """tests/test_edges.py's check: the loss moves, the estimator has FD's
    sign, |fd − ad| ≤ bound·max(|fd|, |ad|)."""
    err = abs(fd - ad) / max(abs(fd), abs(ad))
    if not (abs(fd) > 1e-5 and np.sign(fd) == np.sign(ad)
            and err <= bound):
        raise AssertionError(f"edges {what}: FD {fd} against the "
                             f"estimator's {ad} (bound {bound})")
    return dict(fd=fd, ad=ad, rel_err=err, bound=bound)


def phase_edges(dev, card, es, size=SIZE):
    """The scenes of tests/test_edges.py and tests/test_penumbra.py at the
    headline's width: each estimator against central differences of the
    render, timed (median of 5 calls, K1 by route per call, run-to-run
    difference); a joint_loss_and_grad step (median of 3); and the GI check
    through render_photon (K2)."""
    cam = es.camera(dev, size)
    w3, w5 = (_tensor(es.weights(size, s), dev) for s in (3, 5))
    cfg = RenderConfig(width=size, height=size, spp=EDGE_SPP,
                       scene_epsilon=1e-3)
    pcfg = dataclasses.replace(cfg, max_light_samples=es.N_LIGHT)
    key, pkey = prng.PRNGKey(17, dev), prng.PRNGKey(23, dev)
    central = lambda loss_at, h: (loss_at(h) - loss_at(-h)) / (2 * h)
    weighted = lambda img, w: float(torch.mean(img * w))
    render = lambda scene, c=cfg, k=key: simple.render_simple(
        scene, cam, c, k, jitter=True)
    rows, fd = {}, {}

    # the quad out of view, point light
    scene = es.quad_scene(dev, 0.0)
    e0, e1 = edges.quad_boundary_edges(_tensor(es.occ_corners(0.0), dev))
    d_quad, rows["shadow_quad"] = _estimator(
        lambda: edges.shadow_boundary_image_grad(
            scene, cam, cfg, e0, e1, es.X, samples_per_edge=256))
    fd["quad"] = _fd_check("quad", central(
        lambda th: weighted(render(es.quad_scene(dev, th)), w3), 0.06),
        weighted(d_quad, w3), 0.25)

    # the cube in view: shadow term plus primary term
    scene, v, f = es.in_view_cube_scene(dev, 0.0)
    verts = _tensor(v, dev)
    aabb = (verts.amin(0), verts.amax(0))
    e0, e1, mask = edges.silhouette_edges(verts, f, scene.lights.o[0])
    d_shadow, rows["shadow_in_view"] = _estimator(
        lambda: edges.shadow_boundary_image_grad(
            scene, cam, cfg, e0, e1, es.X, samples_per_edge=256,
            edge_mask=mask, occluder_aabb=aabb))
    e0, e1, mask, fn = edges.silhouette_edges_full(
        verts, f, cam.camera_to_world[:, 3])
    d_prim, rows["primary"] = _estimator(
        lambda: edges.primary_boundary_image_grad(
            scene, cam, cfg, e0, e1, es.X, samples_per_edge=256,
            edge_mask=mask, front_normal=fn, front_mat=1))
    fd_cube = central(lambda th: weighted(
        render(es.in_view_cube_scene(dev, th)[0]), w5), 0.05)
    ad_shadow = weighted(d_shadow, w5)
    fd["in_view_cube"] = _fd_check("in_view_cube", fd_cube,
                                   weighted(d_shadow + d_prim, w5), 0.25)
    fd["in_view_cube"]["ad_shadow_only"] = ad_shadow
    if not abs(fd_cube - fd["in_view_cube"]["ad"]) < abs(fd_cube
                                                          - ad_shadow):
        raise AssertionError(f"edges in_view_cube: the primary term does "
                             f"not help: {fd['in_view_cube']}")

    # the penumbra under the disk light
    base = es.penumbra_base_verts()
    scene = es.penumbra_scene(dev, base)
    d_pen, rows["area"] = _estimator(
        lambda: edges.area_shadow_boundary_image_grad(
            scene, cam, pcfg, base, es.QUAD_FACES, es.X,
            samples_per_edge=128, n_light_samples=es.N_LIGHT))
    fd["penumbra"] = _fd_check("penumbra", central(
        lambda th: weighted(render(es.penumbra_scene(dev, base + th * es.X),
                                   pcfg, pkey), w5), 0.08),
        weighted(d_pen, w5), 0.3)

    # one joint_loss_and_grad step under the disk light
    target = render(es.penumbra_scene(dev, base + 0.3 * es.X), pcfg, pkey)
    params = diff.SceneParams(kd=scene.materials.kd,
                              intensity=scene.lights.intensity)
    joint = lambda th: edges.joint_loss_and_grad(
        params, th, es.X, base, es.QUAD_FACES, es.penumbra_builder(dev),
        cam, pcfg, target, pkey, samples_per_edge=128,
        n_light_samples=es.N_LIGHT, jitter=True)
    with k1_routes() as k1:
        joint(0.0)
    times, outs = _timed_calls(lambda: joint(0.0), 3)
    _, g_params, g_theta, _ = outs[0]
    fd["joint"] = _fd_check("joint", central(
        lambda th: float(joint(th)[0]), 0.08), float(g_theta), 0.3)
    if not (bool(torch.isfinite(g_params.kd).all())
            and bool(torch.isfinite(g_params.intensity).all())
            and float(g_params.kd.abs().sum()) > 0.0):
        raise AssertionError(f"edges joint: g_params {g_params}")
    rows["joint"] = dict(s=times, s_median=statistics.median(times),
                         k1_per_call=k1, run_to_run_max_abs=float(
                             (outs[0][2] - outs[1][2]).abs()))

    # GI: FD of render_photon against the direct-only quad estimator
    gcfg = RenderConfig(width=size, height=size, spp=EDGE_SPP,
                        scene_epsilon=1e-3, photon_paths=EDGE_GI_PATHS,
                        max_photon_depth=4, max_photon_bounces=8,
                        initial_radius2=0.25)
    rg.rowspan_S.launches = 0
    overflow = []

    def gi_loss(th):
        img, aux = photon.render_photon(es.quad_scene(dev, th), cam, gcfg,
                                        key, jitter=True, return_aux=True)
        overflow.append(int(aux["gather_overflow"]))
        return weighted(img, w3)

    fd["gi"] = _fd_check("gi", central(gi_loss, 0.08), weighted(d_quad, w3),
                         0.35)
    k2 = rg.rowspan_S.launches
    if k2 < 2 or any(overflow):
        raise AssertionError(f"edges gi: {k2} K2 launches, gather "
                             f"overflow {overflow}")
    fd["gi"].update(photon_paths=EDGE_GI_PATHS, k2_launches=k2)
    emit("edges", nvidia_smi=card, size=size, spp=EDGE_SPP, fd=fd,
         estimators=rows)


def phase_edges_large(dev, card, es, size=SIZE, subdivisions=4):
    """A closed icosphere of 20·4^subdivisions triangles as the occluder of
    the quad scene: shadow_boundary_image_grad over all its edges with the
    light's silhouette mask, through the epoch engine (K8, K9) on the
    scene with clusters, held against the same call on the scene built
    without them (K1 over every triangle); then one
    translation_loss_and_grad, whose render takes the cluster engine (K6,
    K7)."""
    v, f = es.icosphere(subdivisions, 0.5, (1.7, 0.0, 3.0))
    scene = es.occluder_scene(dev, v, f)
    flat = es.occluder_scene(dev, v, f, use_bvh=False)
    if scene.clusters is None or flat.clusters is not None:
        raise AssertionError("edges_large: the scenes' routes are not "
                             "clusters and dense")
    cam = es.camera(dev, size)
    cfg = RenderConfig(width=size, height=size, spp=1, scene_epsilon=1e-3)
    verts = _tensor(v, dev)
    e0, e1, mask = edges.silhouette_edges(verts, f, scene.lights.o[0])
    silhouette = int(mask.sum())
    call = lambda s: edges.shadow_boundary_image_grad(
        s, cam, cfg, e0, e1, es.X, samples_per_edge=EDGE_LARGE_K,
        edge_mask=mask)
    runs = {}
    for name, s in (("clusters", scene), ("dense", flat)):
        call(s)
        torch.cuda.synchronize()
        _reset_kernel_counts()
        ti.closest_hit.launches = 0
        torch.cuda.reset_peak_memory_stats()
        times, outs = _timed_calls(lambda: call(s), 3)
        counts = dict(_kernel_counts(), k1=ti.closest_hit.launches)
        counts.pop("k2")
        runs[name] = dict(s=times, s_median=statistics.median(times),
                          launches_per_call={k: c / 3 for k, c in
                                             counts.items()},
                          peak_bytes=torch.cuda.max_memory_allocated(),
                          out=outs)
    c, d = runs["clusters"], runs["dense"]
    lc, ld = c["launches_per_call"], d["launches_per_call"]
    if (min(lc["k8"], lc["k9"]) <= 0 or lc["k6"] + lc["k7"] + lc["k1"]
            or ld["k1"] <= 0 or ld["k6"] + ld["k7"] + ld["k8"] + ld["k9"]):
        raise AssertionError(f"edges_large: launches {lc} (clusters), "
                             f"{ld} (dense)")
    spread = sum((r["out"][0] - r["out"][1]).abs() for r in (c, d))
    check = es.dimg_check(_host(c["out"][0]), _host(d["out"][0]),
                          spread=_host(spread))
    for r in (c, d):
        r["run_to_run_max_abs"] = float(
            (r["out"][0] - r["out"][1]).abs().max())
        del r["out"]

    # one translation_loss_and_grad step against a target at θ = 0.1
    build = es.mesh_builder(dev, f)
    key = prng.PRNGKey(17, dev)
    target = simple.render_simple(build(verts + 0.1 * _tensor(es.X, dev)),
                                  cam, cfg, key)
    _reset_kernel_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        loss, g, img = edges.translation_loss_and_grad(
            0.0, es.X, v, f, build, cam, cfg, target, key,
            samples_per_edge=EDGE_LARGE_K)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    step = _kernel_counts()
    overflows = [str(w.message) for w in caught
                 if "overflow" in str(w.message)]
    if (overflows or min(step["k6"], step["k7"], step["k8"], step["k9"]) <= 0
            or not math.isfinite(float(g)) or float(g) == 0.0):
        raise AssertionError(f"edges_large translation step: launches "
                             f"{step}, dloss {float(g)}, {overflows}")
    emit("edges_large", nvidia_smi=card, size=size,
         triangles=int(scene.tris.v0.shape[0]), occluder_triangles=len(f),
         edges=int(e0.shape[0]), silhouette_edges=silhouette,
         samples_per_edge=EDGE_LARGE_K,
         rays_per_launch=int(e0.shape[0]) * EDGE_LARGE_K,
         clusters=c, dense=d, against_dense=check,
         translation_step=dict(s=step_s, launches=step,
                               loss=float(loss), dloss=float(g)))


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
    whole runs of tiles. Counts the tests left after the exact scene-box
    pre-cull (`precull_plain` on the launch's own inputs: every padding
    cluster, and every real cluster for the live subtiles with a ray that
    may hit) and after the group hulls (`cull_tests_plain`, the kernel's
    counter) and bounds the kernel on each and on all tests of the live
    tiles."""
    (o, inv, tmin, tbest, w0, w1, cmin, cmax, n_live, box, n_real, gmin,
     gmax) = args
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
    ran, asked = ek.cull_tests_plain(*args)
    group_tests = ek.CULL_WARP_RAYS * ran + ek.TILE * live_tiles * (
        n_clusters - n_real)
    row = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
               **bound(K8_TEST_OPS * group_tests, nbytes),
               bound_all_tests_ms=full["bound_ms"],
               bound_scene_box_ms=bound(K8_TEST_OPS * precull_tests,
                                        nbytes)["bound_ms"], library_ms=None)
    emit("k8", launch=label, epoch=epoch, rays=o.shape[0], tiles=n_tiles,
         live_tiles=live_tiles, clusters=n_clusters, real_clusters=n_real,
         groups=gmin.shape[0], tests=tests, tests_after_precull=precull_tests,
         tests_after_groups=group_tests, tested_share=100.0 * ran / asked,
         subtiles_may_hit=sub_may, warps=warp_skip.numel(),
         warps_skipped=int(warp_skip.sum()), checked_tiles=sel.numel(),
         checked_warps=checked.numel(),
         checked_warps_skipped=int(warp_skip[checked].sum()),
         set_bytes=int((got != 0).sum()),
         plain_on_checked_tiles=sel.numel() < n_tiles, **row)
    return row


def _gate_groups(cl, ray, o, d, live, tv) -> int:
    """(row, 32-ray group, triangle) triples where a live lane (`live`, the
    kernel's window test) has det != 0 and 0 <= beta <= 1: the plain
    version's first half of the test, its operations in its order, for rows
    of clusters cl [R] and rays ray [R, 32·G] (K9: a job's 32 rays; K7: a
    pair's tile)."""
    count = torch.zeros((), dtype=torch.int64, device=o.device)
    s = tv.shape[2]
    step = max(1, K9_GATE_STEP // (ray.shape[1] * s))
    for j0 in range(0, cl.shape[0], step):
        rr = ray[j0:j0 + step]
        r = lambda a: a[rr][..., None]  # [Rc, L, 1]
        v = [x[:, None, :] for x in tv[cl[j0:j0 + step].long()].unbind(1)]
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
        count += gate.reshape(gate.shape[0], -1, 32, s).any(2).sum()
    return int(count)


def _k9_gate_pairs(args) -> int:
    """(job, triangle) pairs of one K9 call where a live lane has det != 0
    and 0 <= beta <= 1 (`_gate_groups` on the call's own inputs)."""
    job_cluster, job_subtile, o, d, tmin, tmax, tv = args
    ray = (job_subtile.long()[:, None] * ek.SUB
           + torch.arange(ek.SUB, device=o.device))
    return _gate_groups(job_cluster, ray, o, d, tmin < tmax, tv)


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
            hulls = ek.group_hulls(cmin.to(dev), cmax.to(dev), real)
            got = ek.cull_bits(*[a.to(dev) for a in host], n_live.to(dev),
                               box.to(dev), real, *hulls).cpu()
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
    o, d, tmin, tmax, (t_e, i_e) = camera
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
    if flips > ENGINE_FLIP_FRAC * o.shape[0] or rel > ENGINE_RTOL:
        raise AssertionError(f"engine: {flips} flips, t off by {rel} "
                             "relative")
    emit("engine", rays=o.shape[0], hits=int(both.sum()), flips=flips,
         max_t_rel_err=rel, idx_differ=idx_differ, engine_s=engine_s,
         bvh_traverse_s=traverse_s)


def _k6_case(label, args, iters):
    """K6 on one captured call against the plain version, in full →
    (row, mask with the seed column set). Counts the tests left after the
    exact pre-cull (`precull_plain` on the launch's own rays: every padding
    cluster, and every real cluster for the tiles with a ray that may hit)
    and bounds the kernel on them and on all tests."""
    o, d, tmin, tmax, cmin, cmax, tile_rays, n_real = args
    got = ck.cull_tiles(*args)
    want = ck.cull_tiles_plain(*args[:7])
    torch.cuda.synchronize()
    bad = int((got != want).sum())
    if bad:
        raise AssertionError(f"K6 {label}: {bad} mask bytes differ from the "
                             "plain version")
    ms = cuda_ms(lambda: ck.cull_tiles(*args), iters)
    plain_ms = cuda_ms(lambda: ck.cull_tiles_plain(*args[:7]), 1)
    n_tiles, n_clusters = got.shape
    tests = o.shape[0] * n_clusters
    box = torch.stack([cmin[:n_real].amin(0), cmax[:n_real].amax(0)])
    may = ck.precull_plain(o, d, tmin, tmax, box).reshape(n_tiles, -1).any(1)
    tiles_may = int(may.sum())
    precull_tests = tile_rays * (n_tiles * (n_clusters - n_real)
                                 + tiles_may * n_real)
    nbytes = o.shape[0] * 8 * 4 + n_clusters * 6 * 4 + n_tiles * n_clusters
    full = bound(K6_TEST_OPS * tests, nbytes)
    row = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
               **bound(K6_TEST_OPS * precull_tests, nbytes),
               bound_all_tests_ms=full["bound_ms"], library_ms=None)
    got[:, 0] = 1  # the engine's seed pairs
    emit("k6", launch=label, rays=o.shape[0], tile_rays=tile_rays,
         tiles=n_tiles, clusters=n_clusters, real_clusters=n_real,
         tests=tests, tests_after_precull=precull_tests,
         tiles_skipped=n_tiles - tiles_may,
         tiles_skipped_frac=(n_tiles - tiles_may) / n_tiles,
         set_bytes=int((want != 0).sum()), **row)
    return row, got


def _k6_adversarial(dev, tile_rays):
    """K6 on the card, with its pre-cull, against the plain version on the
    CPU, byte for byte, on the inputs tests/test_torch_cluster_precull.py
    builds: NaN and infinite origins, zero and denormal directions, origins
    on face planes, grazing rays, padded rays, empty t-windows, an
    unbounded cluster, padding clusters, and cluster counts (119, 1,137)
    that are not a multiple of the 32-box word or of a block's 1,024. The
    rays are grouped as the pre-cull sees them (dropped, kept only for a
    NaN in the scene-box test, kept) so that whole tiles skip and whole
    tiles stand on the NaN rule alone. Each case runs twice: all its real
    clusters behind the box; and 83 (the boundary inside a 32-box word)
    with three tiles fewer (a block of dead warps). One row per case and
    way: the tiles that skip, and those kept by NaN alone that hit a real
    cluster."""
    path = Path(__file__).resolve().parent / "tests" / \
        "test_torch_cluster_precull.py"
    spec = importlib.util.spec_from_file_location("k6_cases", path)
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    skipped_total = nan_hit_total = 0
    tile = lambda x: x.reshape(-1, tile_rays).any(1)
    for name in cases.CASES:
        o, d, tmin, tmax, cmin, cmax, _, n_real = cases._tensors(name)
        n = o.shape[0]
        for real, n_rays in ((n_real, n), (83, n - 3 * tile_rays)):
            box = torch.stack([cmin[:real].amin(0), cmax[:real].amax(0)])
            may = ck.precull_plain(o, d, tmin, tmax, box)
            inv = 1.0 / torch.where(d == 0.0, 1e-30, d)
            nan = (torch.isnan((box[0] - o) * inv).any(1)
                   | torch.isnan((box[1] - o) * inv).any(1))
            key = torch.where(may, torch.where(nan, 1, 2), 0)
            order = torch.argsort(key, stable=True)[:n_rays]
            host = [a[order] for a in (o, d, tmin, tmax)] + [cmin, cmax]
            want = ck.cull_tiles_plain(*host, tile_rays)
            got = ck.cull_tiles(*[a.to(dev) for a in host], tile_rays,
                                real).cpu()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"K6 {name} ({tile_rays} rays a tile, {real} real "
                    f"clusters, {n_rays} rays): "
                    f"{int((got != want).sum())} mask bytes differ from the "
                    "plain version")
            hits = ck.cull_tiles_plain(*host, 1)[:, :real].any(1)
            may, key = may[order], key[order]
            skipped = int((~tile(may)).sum())
            nan_hit = int((tile(key == 1) & ~tile(key == 2)
                           & tile(hits)).sum())
            skipped_total += skipped
            nan_hit_total += nan_hit
            emit("k6_adversarial", case=name, tile_rays=tile_rays,
                 clusters=cmin.shape[0], real_clusters=real, rays=n_rays,
                 tiles=want.shape[0], tiles_skipped=skipped,
                 nan_only_tiles_hitting=nan_hit,
                 set_bytes=int((want != 0).sum()), equal=True)
    if not (skipped_total and nan_hit_total):
        raise AssertionError(f"K6 adversarial cases ({tile_rays} rays a "
                             f"tile): {skipped_total} tiles skipped, "
                             f"{nan_hit_total} kept by NaN alone hit")


def _k7_item_pairs() -> int:
    return cuda_lib.load("cluster_pair",
                         ck._PAIR_SIGNATURES).cluster_pair_item_pairs()


def _k7_gate(args) -> tuple[int, int]:
    """(tests of live 32-ray groups, (pair, 32-ray group, triangle) triples
    past the gate) of one K7 call: what its function needs, the first half
    of every test of a group with a live ray and the second half only past
    the gate (`_gate_groups` on every pair of the call)."""
    pair_cluster, begin, end, o, d, tmin, tmax, tv = args
    n_tiles = begin.shape[0]
    tile_rays = o.shape[0] // n_tiles
    counts = (end - begin).long().clamp(min=0)
    total = int(counts.sum())
    tiles = torch.repeat_interleave(torch.arange(n_tiles, device=o.device),
                                    counts, output_size=total)
    pairs = (begin.long()[tiles] + torch.arange(total, device=o.device)
             - (torch.cumsum(counts, 0) - counts)[tiles])
    live = tmin < torch.minimum(tmax, torch.tensor(BIG, device=o.device))
    live_groups = live.reshape(n_tiles, -1, 32).any(2).sum(1)
    gate_tests = int(live_groups[tiles].sum()) * 32 * tv.shape[2]
    ray = tiles[:, None] * tile_rays + torch.arange(tile_rays,
                                                    device=o.device)
    return gate_tests, _gate_groups(pair_cluster[pairs], ray, o, d, live, tv)


def _k7_case(label, args, mask, iters):
    """K7 on one captured call against the plain version on the pairs of
    K7_CHECK_TILES tiles spread evenly over the launch (its first tiles
    can be all sky); n_pairs from the launch's mask (seeds set). Bounds
    the kernel on all tests and on the work its function needs
    (`_k7_gate`)."""
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
    ms = cuda_ms(lambda: ck.pair_hits(*args), iters)
    plain_ms = cuda_ms(lambda: ck.pair_hits_plain(*part), 1)
    kept = int((end - begin).sum())  # the pairs run: real clusters only
    s = tv.shape[2]
    tests = kept * tile_rays * s
    gate_tests, gate_groups = _k7_gate(args)
    tail_tests = gate_groups * 32
    nbytes = (pair_cluster.shape[0] * 4 + n_tiles * 8 + o.shape[0] * 8 * 4
              + tv.numel() * 4 + o.shape[0] * 8)
    full = bound(K7_PAIR_OPS * tests, nbytes)
    row = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
               **bound(K9_GATE_OPS * gate_tests + K9_TAIL_OPS * tail_tests,
                       nbytes),
               bound_all_tests_ms=full["bound_ms"], library_ms=None)
    item_pairs = _k7_item_pairs()
    emit("k7", launch=label, rays=o.shape[0], tiles=n_tiles,
         clusters=tv.shape[0], kept_pairs=kept, n_pairs=n_pairs,
         tile_pairs=spread_stats(end - begin),
         item_pairs=item_pairs, items=_items(begin, end, item_pairs),
         pair_tests=tests, gate_tests=gate_tests, gate_groups=gate_groups,
         tail_tests=tail_tests, tail_share=tail_tests / max(gate_tests, 1),
         triangles_per_pair=s, hits=int((t_got < BIG).sum()),
         checked_tiles=sel.shape[0],
         checked_pairs=int((end[sel] - begin[sel]).sum()), **row)
    return row


def _k7_adversarial(dev, tile_rays):
    """K7 on the card against the plain version on the CPU, equal bit for
    bit, on six tiles built to reach each of its paths: right triangles
    with legs along +x and ±y (so beta is the ray's x offset over the x
    leg), S = 61 (halves of 31 and 30), clusters of random ones at z in
    [0, 1] and, in clusters P − 1 and P (either side of the first item
    boundary of a tile that starts at cluster 0), one large triangle at
    z = 2 at indices 7 and 3. Tile 0: 2P + 5 pairs (three items), half its
    rays on the tied triangle; tile 1: rays at x < −40, where beta < 0 for
    every triangle and lane; tile 2: P + 2 pairs, rays with empty windows
    (tmax 0, NaN, tmax < tmin), all but one ray of the second warp's; tile
    3: no pair; tile 4: one pair; tile 5: P pairs (one full item)."""
    p = _k7_item_pairs()
    s, n_clusters = 61, 2 * p + 8
    rng = np.random.default_rng(17)
    v0 = np.stack([rng.uniform(0, 4, (n_clusters, s)),
                   rng.uniform(0, 4, (n_clusters, s)),
                   rng.uniform(0, 1, (n_clusters, s))])
    w = rng.uniform(0.2, 0.6, (n_clusters, s))
    h = rng.uniform(0.2, 0.6, (n_clusters, s)) * rng.choice([-1, 1], w.shape)
    v1, v2 = v0.copy(), v0.copy()
    v1[0] += w
    v2[1] += h
    for c, k in ((p - 1, 7), (p, 3)):
        v0[:, c, k], v1[:, c, k], v2[:, c, k] = (0, 0, 2), (4, 0, 2), (0, 4, 2)
    tv = torch.tensor(np.concatenate([v0, v1, v2]).transpose(1, 0, 2),
                      dtype=torch.float32).contiguous()  # [C, 9, S]
    n = 6 * tile_rays
    o = np.stack([rng.uniform(0, 4, n), rng.uniform(0, 4, n),
                  np.full(n, 5.0)], 1)
    d = np.stack([rng.normal(0, 0.2, n), rng.normal(0, 0.2, n),
                  np.full(n, -1.0)], 1)
    tmin, tmax = np.full(n, 1e-3), np.full(n, BIG)
    half = tile_rays // 2
    o[:half, :2] = rng.uniform(0.2, 1.5, (half, 2))  # tile 0: the tie
    d[:half] = (0, 0, -1)
    o[tile_rays:2 * tile_rays, 0] = rng.uniform(-50, -40, tile_rays)
    d[tile_rays:2 * tile_rays, :2] = 0
    t2 = 2 * tile_rays  # tile 2: its first warp's windows are empty
    tmax[t2:t2 + 64] = 0.0
    tmax[t2 + 64:t2 + 96] = np.nan
    tmin[t2 + 96:t2 + 127], tmax[t2 + 96:t2 + 127] = 5.0, 4.0
    o[t2 + 127], d[t2 + 127] = (1, 1, 5), (0, 0, -1)  # on the tie
    ranges = [range(2 * p + 5), range(p + 1), range(p + 2), range(0),
              range(1), range(p)]
    pairs = torch.tensor([c for r in ranges for c in r], dtype=torch.int32)
    lengths = torch.tensor([len(r) for r in ranges])
    end = torch.cumsum(lengths, 0).to(torch.int32)
    begin = (end - lengths).to(torch.int32)
    host = [pairs, begin, end] + [torch.tensor(x, dtype=torch.float32)
                                  for x in (o, d, tmin, tmax)] + [tv]
    want = ck.pair_hits_plain(*host)
    got = [x.cpu() for x in ck.pair_hits(*[x.to(dev) for x in host])]
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        bad = int(((got[0] != want[0]) | (got[1] != want[1])).sum())
        raise AssertionError(f"K7 adversarial ({tile_rays} rays a tile): "
                             f"(t, idx) of {bad} rays differ from the plain "
                             "version")
    t_w, i_w = want
    tile = lambda k: slice(k * tile_rays, (k + 1) * tile_rays)
    tied = i_w[:half] == (p - 1) * s + 7
    dead = (t_w[t2:t2 + 127] == BIG).all() and bool(t_w[t2 + 127] < BIG)
    if not (tied.all() and (t_w[tile(1)] == BIG).all() and dead
            and (t_w[tile(3)] == BIG).all() and (i_w[tile(3)] == 0).all()):
        raise AssertionError(f"K7 adversarial ({tile_rays} rays a tile): "
                             "the cases do not reach their paths")
    emit("k7_adversarial", tile_rays=tile_rays, triangles_per_cluster=s,
         item_pairs=p, tile_pairs=lengths.tolist(),
         items=_items(begin, end, p), tied_rays=int(tied.sum()),
         hits=int((t_w < BIG).sum()), equal=True)


def phase_k6_k7(dev, scene, cam):
    """One run_triangle_field frame with every K6, K7 and cluster-engine
    call captured; each kernel call held against its plain version → (K6
    row, K7 row, the launches [(label, o, d, tmin, tmax, kwargs)]) for the
    kernel table: the camera launch's. K6 and K7 also on adversarial
    inputs, and their SASS instructions per test and registers."""
    for tile_rays in (128, 256):
        _k6_adversarial(dev, tile_rays)
        _k7_adversarial(dev, tile_rays)
    emit("k6_sass", **sass.report("cluster_cull"))
    emit("k7_sass", **sass.report("cluster_pair"))
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
        k7 = _k7_case(label, k7_args, mask, 3)
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
        t_c, i_c = ci.intersect_clusters(scene.clusters, o, d, tmin, tmax,
                                         **kw)
        t_e, i_e = ei.intersect_epochs(scene.clusters, o, d, tmin, tmax)
        torch.cuda.synchronize()
        hit_c, hit_e = t_c < BIG, t_e < BIG
        flips = int((hit_c != hit_e).sum())
        both = hit_c & hit_e
        rel = float(((t_c - t_e).abs() / t_e.abs().clamp(min=1e-30))[both]
                    .max()) if bool(both.any()) else 0.0
        idx_differ = int((both & (i_c != i_e) & (t_c == t_e)).sum())
        if flips > ENGINE_FLIP_FRAC * o.shape[0] or rel > ENGINE_RTOL:
            raise AssertionError(f"cluster_engine {label}: {flips} flips, "
                                 f"t off by {rel} relative")
        cluster_ms = cuda_ms(lambda: ci.intersect_clusters(
            scene.clusters, o, d, tmin, tmax, **kw), 3)
        epoch_ms = cuda_ms(lambda: ei.intersect_epochs(
            scene.clusters, o, d, tmin, tmax), 3)
        emit("cluster_engine", launch=label, rays=o.shape[0],
             hits=int(hit_c.sum()), flips=flips,
             max_t_rel_err=rel, idx_differ_at_equal_t=idx_differ,
             cluster_ms=cluster_ms, epoch_ms=epoch_ms,
             faster="cluster" if cluster_ms < epoch_ms else "epoch")


def _kernel_counts():
    return {"k6": ck.cull_tiles.launches, "k7": ck.pair_hits.launches,
            "k8": ek.cull_bits.launches, "k9": ek.mt_jobs.launches,
            "k2": rg.rowspan_S.launches,
            "threefry": prng.kernel_draw.launches}


def _reset_kernel_counts():
    for fn in (ck.cull_tiles, ck.pair_hits, ek.cull_bits, ek.mt_jobs,
               rg.rowspan_S, prng.kernel_draw):
        fn.launches = 0


def phase_large_simple(dev, scene, cam, frames=3):
    """render_simple at run_triangle_field's settings on the 4M scene →
    (launch counts over the timed frames, the median frame's seconds)."""
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
    return counts, frame_s


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


@contextlib.contextmanager
def eager_draws():
    """Draws of card keys through core/prng.py's eager threefry ops in
    place of the draws' kernel."""
    real = prng._on_card
    prng._on_card = lambda key: False
    try:
        yield
    finally:
        prng._on_card = real


@contextlib.contextmanager
def checked_draws():
    """Swap core/prng.py's draws (DRAWS) for ones that hold each outermost
    call, made through the kernel, against the eager ops on the same
    arguments: shape, dtype and values equal bit for bit, one launch a
    non-empty draw (and one more a fold past the kernel's two). Yields
    {draw: {calls, launches, shapes}}, the shapes those of the outputs."""
    real = {name: getattr(prng, name) for name in DRAWS}
    seen = {name: dict(calls=0, launches=0, shapes=set()) for name in DRAWS}
    inside = [False]

    def checked(name):
        def draw(*args):
            if inside[0]:  # a draw inside a checked one: checked with it
                return real[name](*args)
            inside[0] = True
            try:
                before = prng.kernel_draw.launches
                got = real[name](*args)
                launches = prng.kernel_draw.launches - before
                with eager_draws():
                    want = real[name](*args)
            finally:
                inside[0] = False
            if not (got.shape == want.shape and got.dtype == want.dtype
                    and torch.equal(got, want)):
                raise AssertionError(
                    f"threefry: {name} to {tuple(got.shape)} differs from "
                    "the eager ops on the same arguments")
            folds = len(args[1]) if name == "folded_uniform" else 0
            if launches != (1 + max(0, folds - 2) if got.numel() else 0):
                raise AssertionError(f"threefry: {name} to "
                                     f"{tuple(got.shape)} made {launches} "
                                     "kernel launches")
            row = seen[name]
            row["calls"] += 1
            row["launches"] += launches
            row["shapes"].add(tuple(got.shape))
            return got
        return draw

    for name in DRAWS:
        setattr(prng, name, checked(name))
    try:
        yield seen
    finally:
        for name, fn in real.items():
            setattr(prng, name, fn)


def _draw_rows(seen) -> dict:
    return {name: dict(row, shapes=sorted(map(list, row["shapes"])))
            for name, row in seen.items()}


def phase_threefry(dev, scene, cam):
    """The draws' kernel against the eager ops at the shapes of the main
    path: every draw of one run_combined frame, then each of DRAWS called
    at the frame's lane counts (the walk's bounce lanes and the camera's
    pixels), all through checked_draws → the kernel table's row."""
    cfg = RenderConfig(**LARGE)
    with checked_draws() as frame:
        img = photon.render_photon(scene, cam, cfg,
                                   prng.PRNGKey(THREEFRY_SEED, dev))
        torch.cuda.synchronize()
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("threefry: the checked frame is not finite")
    if not frame["folded_uniform"]["calls"]:
        raise AssertionError("threefry: the frame made no fused draw")
    lanes = max(s[0] for s in frame["folded_uniform"]["shapes"])
    pixels = SIZE * SIZE * cfg.spp
    g = torch.Generator(device=dev).manual_seed(THREEFRY_SEED)
    ids = torch.randint(-2**40, 2**40, (lanes,), generator=g, device=dev)
    depth = torch.randint(0, cfg.max_photon_depth + 1, (lanes,), generator=g,
                          device=dev, dtype=torch.int32)
    key = prng.PRNGKey(THREEFRY_SEED, dev)
    with checked_draws() as direct:
        keys = prng.fold_in(key, ids)
        cam_keys = prng.fold_in(key, ids[:pixels].to(torch.int32))
        prng.fold_in(key, THREEFRY_SEED)
        prng.fold_in(keys, 3)
        prng.fold_in(keys, depth)
        prng.split(key, 3)
        prng.split(keys[0])
        prng.random_bits(key, (lanes,))
        prng.random_bits(cam_keys, (2,))
        prng.uniform(key, (pixels, 2))
        prng.uniform(keys, (3,))
        prng.folded_uniform(key, (ids, depth), (3,))
        prng.folded_uniform(key, (ids[:pixels],), (2,))
        prng.folded_uniform(keys[7], (ids[:pixels], 5, depth[:pixels]), ())
    missing = [name for name in DRAWS if not direct[name]["calls"]]
    if missing:
        raise AssertionError(f"threefry: {missing} not called")
    row = dict(frame=_draw_rows(frame), direct=_draw_rows(direct),
               bounce_lanes=lanes, camera_lanes=pixels)
    emit("threefry", **row)
    return row


def phase_large(dev, scene, cam, profile_path=None, frames=2):
    """render_photon at run_combined's settings: the card-vs-CPU check at
    32×32, a warm-up whose K2 call is captured and held against the plain
    version (a "k2" line, launch "large"), `frames` timed frames, and one
    profiled frame (its table written to profile_path when given) →
    (launch counts, median frame seconds)."""
    ref_rel_l1 = phase_large_reference(dev)
    cfg = RenderConfig(**LARGE)
    with recording(rg, "rowspan_S") as k2_calls:
        photon.render_photon(scene, cam, cfg, prng.PRNGKey(0, dev))
        torch.cuda.synchronize()
    if len(k2_calls) != 1:
        raise AssertionError(f"large: {len(k2_calls)} K2 calls a frame")
    _k2_case("large", list(k2_calls[0][0]), 5)
    del k2_calls
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
    busy_s, by_kernel, table, _ = profiled(lambda: photon.render_photon(
        scene, cam, cfg, prng.PRNGKey(9, dev)))
    if profile_path:
        with open(profile_path, "w") as f:
            f.write(table)
    kernel_ms = {k: by_kernel.get(name, 0.0) for k, name in (
        ("k6", "cluster_cull_kernel"), ("k7", "cluster_pair_kernel"),
        ("k8", "epoch_cull_kernel"), ("k9", "epoch_mt_kernel"),
        ("k2", "rowspan_kernel"), ("threefry", "threefry_kernel"))}
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


def phase_bench(dev, scene, cam, build_s):
    """The harness's combined_multiwave cell in process on phase large's
    scene, with the K2 and K6-K9 launches of the whole cell (set-up, 4
    waves, the resumed wave and the profiled one); then its headline cell
    as `python -m raytrace_tpu_torch.bench` in a subprocess."""
    run = bench.Run(dev)
    run.scenes["large", SIZE] = (scene, cam, build_s)
    _reset_kernel_counts()
    rep = bench.run_cell(run, "combined_multiwave")
    counts = _kernel_counts()
    emit("bench", cell="combined_multiwave", triangles=LARGE_TRIS,
         slots=LARGE["photon_paths"] * RenderConfig().max_photon_depth,
         metrics=rep.metrics, checks=rep.checks, launches=counts)
    failed = [k for k, ok in rep.checks.items() if not ok]
    if failed:
        raise AssertionError(f"bench: combined_multiwave failed {failed}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"bench: combined_multiwave launches {counts}")
    del run, rep
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "raytrace_tpu_torch.bench", "--cell",
         "headline", "--reps", "3"], cwd=Path(__file__).resolve().parent,
        capture_output=True, text=True, timeout=600)
    wall_s = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"bench: the headline cell exited "
                             f"{out.returncode}:\n{out.stderr[-4000:]}")
    last = json.loads(out.stdout.splitlines()[-1])
    m = last["cells"]["headline"]["metrics"]
    if not last["ok"] or m["frame_time_s"]["n"] != 3:
        raise AssertionError(f"bench: the headline cell's last line {last}")
    emit("bench_headline", wall_s=wall_s, device=last["device"],
         checks=last["checks"], **{k: m[k] for k in (
             "camera_rays_per_sec_full_ppm_pipeline", "frame_time_s",
             "first_call_s", "kernel_build_s", "device_busy_s",
             "device_idle_frac", "peak_memory_gb", "launches")})


def profiled(fn):
    """fn() once under torch.profiler → (device busy seconds, device ms by
    kernel name, the key_averages table, the count of device
    operations)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    records = device_records(prof)
    by_kernel = {}  # by the kernel's name without its argument list
    for name, us in records:
        by_kernel[name] = by_kernel.get(name, 0.0) + us
    ops = len(records)
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=60)
    return (sum(by_kernel.values()) / 1e6,
            {k: v / 1e3 for k, v in by_kernel.items()}, table, ops)


def profile_step(phase: str, fn, wall_s: float, path: str) -> None:
    """fn() once under torch.profiler: device time by kernel, written to
    `path`, and the device's busy share of wall_s, the unprofiled median of
    the same step (the profiler's own overhead inflates its wall time)."""
    busy_s, _, table, _ = profiled(fn)
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
                         "simple frame (FILE.simple), one large simple "
                         "frame (FILE.large_simple) and one large frame "
                         "(FILE.large)")
    ap.add_argument("--parent", metavar="DIR", type=Path,
                    help="a checkout of the parent tree: its K1, K4 and K5 "
                         "are built from DIR, held against this tree's (K1 "
                         "and K4 bit for bit, K5 within its rounding "
                         "bound), and timed in turns with them, SASS too")
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
    parent = None if args.parent is None else load_parent(args.parent)
    cfg = RenderConfig(**BENCH)
    scene, cam = presets.cornell_box(dev, SIZE, ball="glass")
    k1 = phase_k1(dev, scene, parent)
    rec, r2, k_photon = headline_records(dev, scene, cam, cfg)
    jobs, queries, photons = gather_jobs(scene, cfg, rec, r2, k_photon)
    k2 = phase_k2(jobs, queries, photons)
    k3 = phase_k3(dev, jobs)
    del jobs
    k4 = phase_k4(dev, scene, cfg, rec, r2, k_photon, parent)
    k5, k5_launches = phase_k5(scene, cfg, rec, r2, k_photon, parent)
    del rec, r2
    phase_reference(dev)
    launches, frame_s = phase_main(dev, scene, cam, cfg)
    phase_grad_reference(dev)
    grad_launches, step_s = phase_grad(dev, scene, cam, cfg)
    phase_train(dev, scene, cam, cfg)
    # multi-device rendering: world 1 over NCCL, two processes over gloo
    phase_sharded_reference(dev)
    sharded_launches = phase_sharded(dev, scene, cam, cfg, launches, 5)
    sharded_train_launches = phase_sharded_train(dev, scene, cam, cfg,
                                                 step_s)
    phase_sharded_2proc(dev)
    phase_scaling(dev)
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

    # the front end: pbrt files and the CLI
    del scene, sp_scene
    with tempfile.TemporaryDirectory() as tmp:
        path = phase_pbrt(dev, card, tmp)
        phase_cli(dev, card, path, tmp)
        phase_pbrt_large(dev, card, tmp)

    # edge gradients: card against CPU, the headline width, a large occluder
    es = edge_scenes()
    phase_edges_reference(dev, card, es)
    phase_edges(dev, card, es)
    phase_edges_large(dev, card, es)
    torch.cuda.empty_cache()

    # the large-scene path: BASELINE config[4]
    lscene, lcam, lbuild_s = phase_build_large(dev)
    lcfg = RenderConfig(**LARGE)
    k8, k9, camera = phase_k8_k9(large_launches(dev, lscene, lcam, lcfg),
                                 lscene)
    phase_engine(lscene, camera)
    del camera
    k6, k7, coherent = phase_k6_k7(dev, lscene, lcam)
    phase_cluster_engine(lscene, coherent)
    del coherent
    simple_counts, large_simple_s = phase_large_simple(dev, lscene, lcam)
    if args.profile:
        profile_step("profile_large_simple", lambda: simple.render_simple(
            lscene, lcam, RenderConfig(**LARGE_SIMPLE), prng.PRNGKey(9, dev)),
            large_simple_s, args.profile + ".large_simple")
    threefry = phase_threefry(dev, lscene, lcam)
    large_counts, _ = phase_large(
        dev, lscene, lcam, args.profile and args.profile + ".large")
    phase_bench(dev, lscene, lcam, lbuild_s)

    # launches: K1 and K2 over the forward frames of phase main, K3 over
    # the gradient steps of phase grad, K4 over the 16-wave preview render,
    # K6 and K7 over the frames of phase large_simple, K8, K9 and the draws'
    # kernel over the frames of phase large; no renderer calls K5 (as in
    # JAX), so its count is phase k5's call of gather_radius_grid
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
             large_counts["k9"], k9),
            ("threefry", "raytrace_tpu_torch/csrc/threefry.cu",
             "none (jax.random's threefry, which XLA fuses into its "
             "consumers)", "large", large_counts["threefry"], threefry)]
    # the multi-device paths launch K1 and K2 (phase sharded) and K3 (phase
    # sharded_train) as well, each counted from 0 over its own run
    also = {"tri_closest": {"sharded": sharded_launches["k1"]},
            "rowspan_gather": {"sharded": sharded_launches["k2"]},
            "rowspan_gather_bwd": {
                "sharded_train": sharded_train_launches["k3"]}}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "path": path, "launches": n,
         "launches_by_path": {path.split(" ")[0].rstrip(","): n,
                              **also.get(name, {})}, **row}
        for name, src, rep, path, n, row in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
