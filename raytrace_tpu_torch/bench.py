"""The port's benchmark harness: the cells of the JAX package's bench.py,
run on the card with bench.py's settings.

    python -m raytrace_tpu_torch.bench                  # every cell
    python -m raytrace_tpu_torch.bench --cell headline --reps 3
    python -m raytrace_tpu_torch.bench --cpu --size 16 --paths 256 \\
        --ntris 2048 --ranks 2                          # toy sizes, CPU

Cells, in bench.py's order (CELLS): headline (run_once), grad (run_grad),
multiwave (run_multiwave), combined (run_combined), combined_multiwave
(run_combined_multiwave: config[4] over 4 progressive waves, with a
checkpoint after wave 2 and a resume probe), triangle_field
(run_triangle_field at 2^22 triangles, as bench.py's main runs it),
scaling (run_scaling: multihost.scaling_report on one rank a card) and
scaling_cpu (the same frame on --ranks gloo ranks on the CPU).
combined, combined_multiwave and triangle_field share one scene, built
once per process.

Each cell builds its kernels first (kernel_build_s), makes one warm-up
call with key --seed (first_call_s: bench.py's compile_s), then times
call i = 1..reps with key --seed + i (grad folds i into key --seed, as
bench.py does); the waves of the multiwave cells are their samples, wave
1 their first call. A timing is the wall time of a call ending in
torch.cuda.synchronize(), reported as {median, min, max, n}. On the card
one more call runs under torch.profiler, apart from the timed ones:
device_busy_s, and device_idle_frac against the timed median. build_s is
the scene build of the scene the cell renders, peak_memory_gb
torch.cuda.max_memory_allocated over the cell, launches the kernel
launches of the timed calls (of the multi-wave cells: the set-up and the
waves) by kernel id, K1-K9 and prng (csrc/threefry.cu, every draw).

Metrics keep bench.py's key names for the same quantities, with
bench.py's *_compile_s as first_call_s and *_build_s as build_s;
scaling_cpu's *_cpu_virtual keys count gloo processes here, where
bench.py counted virtual XLA devices. Not carried over: bench.py's
round-1 TPU anchor (vs_baseline) and its ladder of fallback sizes.

One JSON line per cell as it finishes; the last line holds every cell's
metrics and units by name, a map of correctness checks, the seed and the
device (nvidia-smi's name and power limit, or "cpu"). After it prints,
the process exits 1 if any check failed. Without a card and without
--cpu it raises: it never falls back to the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import torch

from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.core.config import RenderConfig
from raytrace_tpu_torch.diff import render as diff_render
from raytrace_tpu_torch.ops import cluster_kernels as ck
from raytrace_tpu_torch.ops import cuda_lib
from raytrace_tpu_torch.ops import dense_gather as dg
from raytrace_tpu_torch.ops import epoch_kernels as ek
from raytrace_tpu_torch.ops import grid_gather as gg
from raytrace_tpu_torch.ops import rowspan_gather as rg
from raytrace_tpu_torch.ops import tri_intersect as ti
from raytrace_tpu_torch.parallel import launch, multihost, sharded
from raytrace_tpu_torch.renderers import common, photon, simple
from raytrace_tpu_torch.scene import presets
from raytrace_tpu_torch.scene.scene import GLASS
from raytrace_tpu_torch.utils import checkpoint as ckpt
from raytrace_tpu_torch.utils import film
from raytrace_tpu_torch.utils.timing import device_intervals, union_us

SIZE = 512
# bench.py run_once (bench.py:78-85): the headline frame
BENCH = dict(width=SIZE, height=SIZE, spp=1, scene_epsilon=1e-3,
             photon_paths=1 << 18, photon_passes=1, max_photon_bounces=8,
             footprint_radius_scale=8.0)
# run_grad (:199-203): the headline, differentiable
GRAD = dict(BENCH, differentiable=True)
# run_multiwave (:151-155): the headline frame over 8 waves
MULTIWAVE = dict(BENCH, photon_passes=8)
# run_combined (:237-262), BASELINE config[4]: triangle_field(2^22, 512),
# 2^22 paths × 4 deposits = 16.8M slots
LARGE_TRIS = 1 << 22
LARGE = dict(BENCH, photon_paths=1 << 22, initial_radius2=0.04)
# run_combined_multiwave (:317-320): config[4] over 4 waves
LARGE_MULTIWAVE = dict(LARGE, photon_passes=4)
# run_triangle_field (:377-390), on config[4]'s scene
LARGE_SIMPLE = dict(width=SIZE, height=SIZE, spp=1, scene_epsilon=1e-3)
# run_scaling (:443-448)
SCALING = dict(width=256, height=256, spp=1, scene_epsilon=1e-3,
               photon_paths=1 << 16, photon_passes=1, max_photon_bounces=8)
# run_scaling(force_cpu_mesh=True)'s 8 virtual devices, as gloo ranks
CPU_RANKS = 8

# kernel id → (its source in csrc/, the wrapper that counts its launches)
KERNELS = {"k1": ("tri_intersect", ti.closest_hit),
           "k2": ("rowspan_gather", rg.rowspan_S),
           "k3": ("rowspan_gather_bwd", rg.rowspan_S_bwd),
           "k4": ("dense_gather", dg.dense_S),
           "k5": ("grid_gather", gg.grid_S),
           "k6": ("cluster_cull", ck.cull_tiles),
           "k7": ("cluster_pair", ck.pair_hits),
           "k8": ("epoch_cull", ek.cull_bits),
           "k9": ("epoch_mt", ek.mt_jobs),
           "prng": ("threefry", prng.kernel_draw)}


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel id."""
    return {k: fn.launches for k, (_, fn) in KERNELS.items()}


def launches_since(before: dict) -> dict:
    """The launches since `before` (launch_counts()), of the kernels
    launched."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def build_kernels(ids, host: bool = False) -> float:
    """nvcc builds the kernels `ids` (and with host, g++ the BVH builder),
    one compiler process each, all at once → seconds."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(ids) + 1) as pool:
        jobs = [pool.submit(cuda_lib.build, KERNELS[k][0]) for k in ids]
        if host:
            jobs.append(pool.submit(cuda_lib.build_host, "bvh_builder"))
        for job in jobs:
            job.result()
    return time.perf_counter() - t0


def timing(times: list) -> dict:
    return dict(median=statistics.median(times), min=min(times),
                max=max(times), n=len(times))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _overflow_warnings(caught) -> int:
    """The gather overflow that RuntimeWarnings reported, summed ('...
    overflow by N ...')."""
    return sum(int(found.group(1)) for w in caught
               if (found := re.search(r"overflow by (\d+)", str(w.message))))


def cell_config(name: str, size: int | None = None,
                paths: int | None = None,
                passes: int | None = None) -> RenderConfig:
    """The RenderConfig of cell `name`: bench.py's settings, with the
    width, photon paths and (for the multi-wave cells) waves overridden
    where given."""
    s = dict(CELLS[name].settings)
    if size:
        s.update(width=size, height=size)
    if paths and "photon_paths" in s:
        s["photon_paths"] = paths
    if passes and s.get("photon_passes", 1) > 1:
        s["photon_passes"] = passes
    return RenderConfig(**s)


class Report:
    """One cell's metrics, their units and its correctness checks."""

    def __init__(self):
        self.metrics, self.units, self.checks = {}, {}, {}

    def put(self, name: str, value, unit: str = "") -> None:
        self.metrics[name] = value
        self.units[name] = unit

    def check(self, name: str, ok) -> None:
        self.checks[name] = bool(ok)

    def image(self, imgs) -> None:
        """Every image finite and not all zero."""
        self.check("image_finite",
                   all(bool(torch.isfinite(i).all()) for i in imgs))
        self.check("image_nonzero", all(bool(i.any()) for i in imgs))
        self.put("image_mean", float(imgs[-1].mean()))

    def overflow(self, gather: int, prefix: str = "") -> None:
        self.put(prefix + "gather_overflow", int(gather), "jobs")
        self.check("gather_overflow_zero", int(gather) == 0)

    def radius_trace(self, name: str, trace: list) -> None:
        self.put(name, trace)
        self.check("radius2_non_increasing",
                   all(b <= a for a, b in zip(trace, trace[1:])))


class Run:
    """One harness process: the device, the seed, the size overrides and
    the scenes built so far."""

    def __init__(self, device: torch.device, seed: int = 0, size=None,
                 paths=None, ntris=None, passes=None, reps=None,
                 ranks: int = CPU_RANKS):
        self.device, self.seed = device, seed
        self.size, self.paths, self.passes = size, paths, passes
        self.ntris, self.reps, self.ranks = ntris or LARGE_TRIS, reps, ranks
        self.scenes = {}

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def config(self, name: str) -> RenderConfig:
        return cell_config(name, self.size, self.paths, self.passes)

    def key(self, i: int = 0):
        return prng.PRNGKey(self.seed + i, self.device)

    def scene(self, kind: str, size: int):
        """(scene, camera, build seconds): the glass Cornell box
        ('cornell') or config[4]'s triangle_field ('large'), built once."""
        if (kind, size) not in self.scenes:
            t0 = time.perf_counter()
            if kind == "cornell":
                scene, cam = presets.cornell_box(self.device, size,
                                                 ball="glass")
            else:
                scene, cam = presets.triangle_field(self.device, self.ntris,
                                                    size)
            _sync(self.device)
            self.scenes[kind, size] = (scene, cam, time.perf_counter() - t0)
        return self.scenes[kind, size]

    def release(self, kinds) -> None:
        """Drop the scenes of the kinds not in `kinds`, and the cache of
        freed device memory."""
        for k in [k for k in self.scenes if k[0] not in kinds]:
            del self.scenes[k]
        if self.cuda:
            torch.cuda.empty_cache()

    def timed(self, call):
        """call() → (its result, wall seconds ending in a synchronize)."""
        t0 = time.perf_counter()
        out = call()
        _sync(self.device)
        return out, time.perf_counter() - t0

    def profiled(self, rep: Report, call, wall_s: float) -> None:
        """call() once under torch.profiler on the card: its device busy
        seconds and idle share of wall_s, the unprofiled median."""
        busy = device_busy_s(call)[0] if self.cuda else None
        put_busy(rep, busy, wall_s)


def put_busy(rep: Report, busy, wall_s: float) -> None:
    rep.put("device_busy_s", busy, "s")
    rep.put("device_idle_frac", None if busy is None else
            1.0 - busy / wall_s)


def device_busy_s(call) -> tuple[float, float]:
    """One call() under torch.profiler → (the card's busy seconds, the
    union of its device records' intervals, NCCL's apart; the union of
    NCCL's). A collective's kernel runs, spinning, until every rank has
    joined it, so its time is waiting as much as work."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    spans = {False: [], True: []}
    for name, start, end in device_intervals(prof):
        spans[name.startswith("nccl")].append((start, end))
    return union_us(spans[False]) / 1e6, union_us(spans[True]) / 1e6


def _setup(run: Run, rep: Report, name: str):
    """Cell `name`'s config and scene → (config, scene, camera)."""
    cfg = run.config(name)
    scene, cam, build_s = run.scene(CELLS[name].scene, cfg.width)
    rep.put("build_s", build_s, "s")
    return cfg, scene, cam


def _frames(run: Run, rep: Report, name: str, call):
    """call(i) as a warm-up (i = 0), timed (1..reps) and profiled →
    (the timed calls' results, their timing)."""
    _, first_s = run.timed(lambda: call(0))
    before = launch_counts()
    outs, times = [], []
    for i in range(1, (run.reps or CELLS[name].reps) + 1):
        out, s = run.timed(lambda: call(i))
        outs.append(out)
        times.append(s)
    t = timing(times)
    rep.put("first_call_s", first_s, "s")
    rep.put("launches", launches_since(before), "launches")
    run.profiled(rep, lambda: call(len(times) + 1), t["median"])
    return outs, t


def _frame_aux(rep: Report, outs, prefix: str = "") -> None:
    """Images and counters of render_photon's (image, aux) results."""
    rep.image([img for img, _ in outs])
    rep.put(prefix + "valid_photons", int(outs[-1][1]["valid_photons"]),
            "photons")
    rep.overflow(max(int(a["gather_overflow"]) for _, a in outs), prefix)


def run_headline(run: Run, rep: Report) -> None:
    cfg, scene, cam = _setup(run, rep, "headline")
    outs, t = _frames(run, rep, "headline", lambda i: photon.render_photon(
        scene, cam, cfg, run.key(i), return_aux=True))
    rep.put("camera_rays_per_sec_full_ppm_pipeline",
            cfg.n_pixel_samples / t["median"], "rays/s")
    rep.put("photons_per_sec",
            cfg.photon_paths * cfg.photon_passes / t["median"], "photons/s")
    rep.put("frame_time_s", t, "s")
    for k in ("width", "height", "spp"):
        rep.put(k, getattr(cfg, k))
    rep.put("photon_paths", cfg.photon_paths * cfg.photon_passes, "paths")
    _frame_aux(rep, outs)


def run_grad(run: Run, rep: Report) -> None:
    cfg, scene, cam = _setup(run, rep, "grad")
    ls = common.static_light_samples(scene, cfg)
    params = diff_render.extract_params(scene)
    target = torch.zeros((cfg.height, cfg.width, 3), device=run.device)
    key = run.key()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        outs, t = _frames(run, rep, "grad", lambda i: diff_render.loss_and_grad(
            params, target, scene, cam, cfg,
            key if i == 0 else prng.fold_in(key, i), ls, False))
    rep.put("grad_rays_per_s", cfg.n_pixel_samples / t["median"], "rays/s")
    rep.put("grad_photons_per_s", cfg.photon_paths / t["median"],
            "photons/s")
    rep.put("grad_frame_s", t, "s")
    loss, g = outs[-1]
    rep.put("loss", float(loss))
    rep.put("grad_kd_abs_sum", float(g.kd.abs().sum()))
    # the loss against a zero target: finite and > 0 iff the image is
    # finite and not all zero
    rep.check("loss_finite", all(bool(torch.isfinite(l)) for l, _ in outs))
    rep.check("loss_positive", all(float(l) > 0.0 for l, _ in outs))
    rep.check("grad_finite", all(bool(torch.isfinite(g.kd).all()) and
                                 bool(torch.isfinite(g.intensity).all())
                                 for _, g in outs))
    rep.check("grad_kd_nonzero", all(float(g.kd.abs().sum()) > 0.0
                                     for _, g in outs))
    glass = scene.materials.mtype == GLASS
    rep.check("glass_kd_zero", all(not bool(g.kd[glass].any())
                                   for _, g in outs))
    rep.overflow(_overflow_warnings(caught))


def _waves(run: Run, rep: Report, name: str, prefix: str,
           probe: bool = False) -> None:
    """bench.py's run_multiwave and run_combined_multiwave: _ppm_setup,
    then each wave timed, with the radius² trace; with probe, the state
    checkpointed after wave passes//2 - 1, kept after the next, and that
    wave re-run from the file."""
    cfg, scene, cam = _setup(run, rep, name)
    if cfg.photon_passes < 2:
        raise ValueError(f"{name}: needs 2 or more waves")
    ls = common.static_light_samples(scene, cfg)
    key = run.key()
    before = launch_counts()
    (xy, rec, direct, state, k_photon), setup_s = run.timed(
        lambda: photon._ppm_setup(scene, cam, cfg, key, ls, True))
    rep.put("setup_s", setup_s, "s")
    p_mid = cfg.photon_passes // 2 - 1
    radius, wave_s, infos, kept = [], [], [], None
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ppm.ckpt")
        for p in range(cfg.photon_passes):
            (state, info), s = run.timed(lambda: photon._ppm_wave(
                scene, rec, state, k_photon, p, cfg))
            wave_s.append(s)
            infos.append(info)
            radius.append(float(torch.mean(torch.where(rec.hit,
                                                       state.radius2, 0.0))))
            if probe and p == p_mid:
                ckpt.save_progressive(path, state, p + 1, key,
                                      emitted_photons=float(
                                          cfg.photon_paths) * (p + 1))
            elif probe and p == p_mid + 1:
                kept = state
        launches = launches_since(before)
        if probe:
            loaded, next_p, _, _ = ckpt.load_progressive(path, run.device)
            resumed, _ = photon._ppm_wave(scene, rec, loaded, k_photon,
                                          next_p, cfg)
            unequal = [f.name for f in dataclasses.fields(kept)
                       if not torch.equal(getattr(kept, f.name),
                                          getattr(resumed, f.name))]
            rep.put(prefix + "resume_ok", not unequal)
            rep.put("resume_unequal_fields", unequal)
            rep.put("resume_pass", next_p)
            rep.check("resume_ok", not unequal)
            del loaded, resumed, kept
    steady = timing(wave_s[1:])
    rep.put("first_call_s", wave_s[0], "s")
    rep.put("launches", launches, "launches")
    rep.put(prefix + "passes", cfg.photon_passes, "waves")
    rep.put(prefix + "photons_per_s", cfg.photon_paths / steady["median"],
            "photons/s")
    rep.put(prefix + "wave_s_median", steady, "s")
    rep.put(prefix + "wave_s", wave_s, "s")
    rep.radius_trace(prefix + ("radius2_trace" if probe
                               else "mean_radius2_trace"), radius)
    rep.put(prefix + "valid_photons", int(infos[-1]["valid_photons"]),
            "photons")
    rep.overflow(sum(int(i["gather_overflow"]) for i in infos), prefix)
    img = film.splat(xy, photon.final_gathering(rec, direct, state),
                     cfg.width, cfg.height, cfg.pixel_filter,
                     cfg.filter_radius)
    rep.image([img])
    run.profiled(rep, lambda: photon._ppm_wave(
        scene, rec, state, k_photon, cfg.photon_passes, cfg),
        steady["median"])


def run_multiwave(run: Run, rep: Report) -> None:
    _waves(run, rep, "multiwave", "ppm_multiwave_")


def run_combined(run: Run, rep: Report) -> None:
    p = "ppm_4mtri_16mphotons_"
    cfg, scene, cam = _setup(run, rep, "combined")
    outs, t = _frames(run, rep, "combined", lambda i: photon.render_photon(
        scene, cam, cfg, run.key(i), return_aux=True))
    rep.put(p + "rays_per_s", cfg.n_pixel_samples / t["median"], "rays/s")
    rep.put(p + "photons_per_s", cfg.photon_paths / t["median"],
            "photons/s")
    rep.put(p + "frame_s", t, "s")
    rep.put(p + "tris", int(scene.tris.count), "triangles")
    rep.put(p + "slots", cfg.photon_paths * cfg.max_photon_depth, "slots")
    _frame_aux(rep, outs, p)


def run_combined_multiwave(run: Run, rep: Report) -> None:
    _waves(run, rep, "combined_multiwave", "ppm_4mtri_16mphotons_multiwave_",
           probe=True)


def run_triangle_field(run: Run, rep: Report) -> None:
    p = "triangle_field_"
    cfg, scene, cam = _setup(run, rep, "triangle_field")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        outs, t = _frames(run, rep, "triangle_field",
                          lambda i: simple.render_simple(scene, cam, cfg,
                                                         run.key(i)))
    rep.put(p + "rays_per_s", cfg.n_pixel_samples / t["median"], "rays/s")
    rep.put(p + "frame_s", t, "s")
    rep.put(p + "tris", int(scene.tris.count), "triangles")
    rep.image(outs)
    rep.overflow(_overflow_warnings(caught))


def _scaling_rank(rank: int, world: int, device, settings: dict,
                  seed: int) -> dict:
    """One rank of the scaling cells: scaling_report at counts (1, world),
    then one sharded frame on every rank for the image checks, and on the
    card one more under the profiler."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    cfg = RenderConfig(**settings)
    scene, cam = presets.cornell_box(device, cfg.width, ball="glass")
    key = prng.PRNGKey(seed, device)
    before = launch_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        report = multihost.scaling_report(scene, cam, cfg, key,
                                          device_counts=sorted({1, world}))
    mesh = sharded.make_mesh(device.type)

    def frame():
        return sharded.render_photon_sharded(scene, cam, cfg, key, mesh)

    out = dict(report={str(k): v for k, v in report.items()},
               launches=launches_since(before),
               overflow=_overflow_warnings(caught), img=frame().cpu(),
               busy_s=None, collective_s=None, peak_memory_gb=None)
    if device.type == "cuda":
        out["busy_s"], out["collective_s"] = device_busy_s(frame)
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    return out


def _scaling(run: Run, rep: Report, name: str, device_type: str,
             world: int, suffix: str = "") -> None:
    cfg = run.config(name)
    t0 = time.perf_counter()
    ranks = launch.run_world(_scaling_rank, world, device_type,
                             (dataclasses.asdict(cfg), run.seed))
    rep.put("spawn_and_run_s", time.perf_counter() - t0, "s")
    report = ranks[0]["report"]
    rates = {k: v for k, v in report.items() if k != "efficiency"}
    rep.put(f"scaling_devices{suffix}", world, "ranks")
    rep.put(f"scaling_efficiency{suffix}", report.get("efficiency"))
    rep.put(f"scaling_rays_per_s{suffix}", rates, "rays/s")
    rep.put("backend", "nccl" if device_type == "cuda" else "gloo")
    rep.put("launches", ranks[0]["launches"], "launches")
    # rank 0's card over one sharded frame at the world size; its NCCL
    # kernels apart
    put_busy(rep, ranks[0]["busy_s"], cfg.n_pixel_samples / rates[str(world)])
    rep.put("device_collective_s", ranks[0]["collective_s"], "s")
    rep.put("peak_memory_gb", ranks[0]["peak_memory_gb"], "GB")
    rep.image([ranks[0]["img"]])
    rep.check("rays_per_s_positive", all(v > 0 for v in rates.values()))
    rep.check("efficiency_iff_counts",
              ("efficiency" in report) == (len(rates) > 1))
    rep.overflow(max(r["overflow"] for r in ranks))


def run_scaling(run: Run, rep: Report) -> None:
    """One rank a card (one on the CPU with --cpu), NCCL between cards:
    with one card the report has world 1 and no efficiency."""
    world = torch.cuda.device_count() if run.cuda else 1
    _scaling(run, rep, "scaling", run.device.type, world)


def run_scaling_cpu(run: Run, rep: Report) -> None:
    _scaling(run, rep, "scaling_cpu", "cpu", run.ranks, "_cpu_virtual")


@dataclasses.dataclass(frozen=True)
class Cell:
    settings: dict     # bench.py's RenderConfig fields
    reps: int | None   # timed calls (not the cells whose samples are
                       # waves, or scaling_report's 3 frames)
    scene: str         # 'cornell', 'large', or '' (built by the ranks)
    kernels: tuple     # the kernels its route launches on the card
    run: object        # run(Run, Report)


CELLS = {
    "headline": Cell(BENCH, 10, "cornell", ("k1", "k2", "prng"),
                     run_headline),
    "grad": Cell(GRAD, 5, "cornell", ("k1", "k2", "k3", "prng"), run_grad),
    "multiwave": Cell(MULTIWAVE, None, "cornell", ("k1", "k2", "prng"),
                      run_multiwave),
    "combined": Cell(LARGE, 3, "large",
                     ("k2", "k6", "k7", "k8", "k9", "prng"), run_combined),
    "combined_multiwave": Cell(LARGE_MULTIWAVE, None, "large",
                               ("k2", "k6", "k7", "k8", "k9", "prng"),
                               run_combined_multiwave),
    "triangle_field": Cell(LARGE_SIMPLE, 5, "large", ("k6", "k7", "prng"),
                           run_triangle_field),
    "scaling": Cell(SCALING, None, "", ("k1", "k2"), run_scaling),
    "scaling_cpu": Cell(SCALING, None, "", (), run_scaling_cpu),
}


def run_cell(run: Run, name: str) -> Report:
    """Cell `name` on `run`: its kernels built, its calls timed and
    checked; on the card every kernel of its route launched."""
    cell = CELLS[name]
    rep = Report()
    rep.put("kernel_build_s", build_kernels(
        cell.kernels, host=cell.scene == "large")
        if run.cuda and cell.kernels else None, "s")
    if run.cuda:
        torch.cuda.reset_peak_memory_stats()
    cell.run(run, rep)
    if "peak_memory_gb" not in rep.metrics:  # the scaling cells: rank 0's
        rep.put("peak_memory_gb", torch.cuda.max_memory_allocated() / 1e9
                if run.cuda else None, "GB")
    if run.cuda:
        rep.check("kernels_launched", all(
            rep.metrics["launches"].get(k, 0) > 0 for k in cell.kernels))
    return rep


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m raytrace_tpu_torch.bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--cell", choices=("all", *CELLS), default="all")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--ranks", type=int, default=CPU_RANKS,
                    help="gloo ranks of the scaling_cpu cell")
    sizes = ap.add_argument_group("sizes, for tests on the CPU")
    sizes.add_argument("--size", type=int, help="image width and height")
    sizes.add_argument("--paths", type=int, help="photon paths a wave")
    sizes.add_argument("--ntris", type=int,
                       help="triangles of the large scene")
    sizes.add_argument("--passes", type=int,
                       help="waves of the multi-wave cells")
    sizes.add_argument("--reps", type=int,
                       help="timed calls of the frame and step cells")
    return ap


def main(argv=None) -> int:
    """Run the cells → the exit status: 1 if a check failed, else 0."""
    args = build_parser().parse_args(argv)
    if args.cpu:
        device, where = torch.device("cpu"), "cpu"
    elif torch.cuda.is_available():
        device, where = torch.device("cuda", 0), nvidia_smi()
    else:
        raise RuntimeError("raytrace_tpu_torch.bench: no CUDA device; pass "
                           "--cpu to run on the CPU")
    run = Run(device, args.seed, args.size, args.paths, args.ntris,
              args.passes, args.reps, args.ranks)
    names = list(CELLS) if args.cell == "all" else [args.cell]
    cells, checks = {}, {}
    for i, name in enumerate(names):
        rep = run_cell(run, name)
        print(json.dumps({"cell": name, "metrics": rep.metrics,
                          "checks": rep.checks}), flush=True)
        cells[name] = dict(metrics=rep.metrics, units=rep.units)
        checks.update({f"{name}.{k}": v for k, v in rep.checks.items()})
        run.release({CELLS[n].scene for n in names[i + 1:]})
    ok = all(checks.values())
    print(json.dumps({"ok": ok, "seed": args.seed, "device": where,
                      "cells": cells, "checks": checks}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    # run as the module raytrace_tpu_torch.bench, so that spawned ranks
    # find _scaling_rank by its import path
    from raytrace_tpu_torch.bench import main as _main

    sys.exit(_main())
