"""Work-item sizes of K2, K3 and K7 on the card: each kernel rebuilt with
other values of its work-item constant, checked and timed on the inputs
`chip_smoke.py` gives it.

    python -m raytrace_tpu_torch.utils.sweep

J (`ITEM_JOBS`, csrc/rowspan_gather.cu and csrc/rowspan_gather_bwd.cu) runs
on the headline frame's gather jobs (the glass Cornell box at 512²,
262,144 paths, key 0: tile-major for K2; chunk-major with a uniform
cotangent of seed 3 for K3); P (`ITEM_PAIRS`, csrc/cluster_pair.cu) on the
camera and shadow launches of one render_simple frame of
triangle_field(1 << 22, 512). A value of 2^30 gives one item per tile or
chunk. Each variant goes through the port's own wrapper with its library
swapped in, is held against the plain version (K2: counts M equal and S
within 2·M·2^-24; K3: term counts equal and dα within 2·terms·2^-24; K7:
(t, idx) equal) and timed by CUDA events, one JSON line each. Needs nvcc
and a CUDA card.
"""
from __future__ import annotations

import contextlib
import json
import re
from concurrent.futures import ThreadPoolExecutor

import torch

from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.core.config import RenderConfig
from raytrace_tpu_torch.ops import cluster_kernels as ck
from raytrace_tpu_torch.ops import cuda_lib
from raytrace_tpu_torch.ops import rowspan_gather as rg
from raytrace_tpu_torch.renderers import common, photon, simple
from raytrace_tpu_torch.scene import presets
from raytrace_tpu_torch.scene.camera import generate_rays, pixel_samples
from raytrace_tpu_torch.utils.timing import cuda_ms

J_VALUES = (8, 16, 32, 64, 1 << 30)
P_VALUES = (4, 8, 16, 32, 64, 1 << 30)
# bench.py:78-85, the headline frame, as chip_smoke.py's BENCH
HEADLINE = dict(width=512, height=512, spp=1, scene_epsilon=1e-3,
                photon_paths=1 << 18, photon_passes=1, max_photon_bounces=8,
                footprint_radius_scale=8.0)


def with_define(source: str, define: str, value: int) -> str:
    """`source` with its one `#define <define> ...` line set to `value`."""
    text, n = re.subn(rf"^#define {define} \S+", f"#define {define} {value}",
                      source, flags=re.M)
    if n != 1:
        raise ValueError(f"{n} lines #define {define}, not one")
    return text


def variant(name: str, signatures: dict, define: str, value: int):
    """csrc/<name>.cu built with `#define <define> <value>` → the loaded
    library."""
    tag = f"{name}_{define}{value}"
    cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = cuda_lib.BUILD_DIR / f"{tag}.cu"
    src.write_text(with_define((cuda_lib.SRC_DIR / f"{name}.cu").read_text(),
                               define, value))
    path = cuda_lib._compile(tag, src, [cuda_lib.nvcc_path()],
                             cuda_lib.nvcc_flags(name))
    return cuda_lib.bind(path, signatures)


@contextlib.contextmanager
def swapped(name: str, lib):
    """The wrappers load `lib` for csrc/<name>.cu while inside."""
    old = cuda_lib._loaded.get(name)
    cuda_lib._loaded[name] = lib
    try:
        yield
    finally:
        if old is None:
            cuda_lib._loaded.pop(name)
        else:
            cuda_lib._loaded[name] = old


def headline_jobs(dev) -> dict:
    """The headline frame's tile-major gather jobs, as chip_smoke.py's
    headline_records and gather_jobs make them."""
    cfg = RenderConfig(**HEADLINE)
    scene, cam = presets.cornell_box(dev, 512, ball="glass")
    keys = prng.split(prng.PRNGKey(0, dev), 3)
    xy, lens = pixel_samples(keys[0], cfg.width, cfg.height, cfg.spp)
    rays = generate_rays(cam, xy, lens, cfg.spp)
    rec = common.camera_pass(scene, rays.o, rays.d, cfg, rays=rays)
    r2 = photon.initial_radius2(rec, cfg)
    photons = photon.trace_photons(scene, cfg, keys[2], 0)
    state = photon.ProgressiveState(
        radius2=r2, photon_count=torch.zeros_like(r2),
        flux=torch.zeros_like(rec.p), emitted=torch.zeros_like(r2))
    rounds, budget = photon.gather_capacity(cfg, photons.p.shape[0])
    return rg.rowspan_jobs(
        photons.p, photons.wi, photons.alpha, photons.valid,
        photon.gather_cell_size(rec, state), rec.p,
        torch.where(rec.hit, r2, 0.0), rec.ns, r_max=cfg.gather_r_max,
        rounds=rounds, job_budget=budget)


def k3_args(jobs, dev):
    """The headline jobs chunk-major and a cotangent, as chip_smoke.py's
    phase_k3 makes them."""
    n_tiles = jobs["tile_begin"].shape[0]
    pid, begin, end = rg.chunk_major(jobs["pid"], jobs["n_valid"],
                                     jobs["n_chunks"], n_tiles)
    g = torch.Generator(device=dev).manual_seed(3)
    cotT = torch.rand(jobs["qpT"].shape, device=dev, generator=g)
    return (pid, begin, end, n_tiles, jobs["qpT"], jobs["qr2"], jobs["qnsT"],
            cotT, jobs["pdata"])


def k7_calls(dev):
    """The (positional) arguments of each K7 call of one render_simple
    frame of triangle_field(1 << 22, 512): its camera and shadow launch."""
    scene, cam = presets.triangle_field(dev, 1 << 22, 512)
    calls, orig = [], ck.pair_hits

    def rec(*args):
        calls.append(args)
        return orig(*args)

    rec.launches = 0  # the wrapper counts its launches on ck.pair_hits
    ck.pair_hits = rec
    try:
        simple.render_simple(scene, cam, RenderConfig(
            width=512, height=512, spp=1, scene_epsilon=1e-3),
            prng.PRNGKey(0, dev))
    finally:
        ck.pair_hits = orig
    torch.cuda.synchronize()
    return dict(zip(("camera", "shadow"), calls, strict=True))


def sweep_k2(jobs, libs) -> None:
    args = [jobs[k] for k in ("pid", "tile_begin", "tile_end", "n_chunks",
                              "qpT", "qr2", "qnsT", "pdata")]
    want = rg.rowspan_S_plain(*args)
    bound = 2.0 * 2.0 ** -24 * want[3] * want[:3].abs()
    for j, lib in libs.items():
        with swapped("rowspan_gather", lib):
            got = rg.rowspan_S(*args)
            ok = (torch.equal(got[3], want[3]) and not bool(
                ((got[:3] - want[:3]).abs() > bound).any()))
            if not ok:
                raise AssertionError(f"K2 at J = {j} differs from the plain "
                                     "version")
            print(json.dumps(dict(kernel="K2", item_jobs=j, ms=cuda_ms(
                lambda: rg.rowspan_S(*args), 20))), flush=True)


def sweep_k3(jobs, dev, libs) -> None:
    args = k3_args(jobs, dev)
    want = rg.rowspan_S_bwd_plain(*args)
    bound = 2.0 * 2.0 ** -24 * want[:, 3:4] * want[:, :3]
    for j, lib in libs.items():
        with swapped("rowspan_gather_bwd", lib):
            got = rg.rowspan_S_bwd(*args)
            ok = (torch.equal(got[:, 3], want[:, 3]) and not bool(
                ((got[:, :3] - want[:, :3]).abs() > bound).any()))
            if not ok:
                raise AssertionError(f"K3 at J = {j} differs from the plain "
                                     "version")
            print(json.dumps(dict(kernel="K3", item_jobs=j, ms=cuda_ms(
                lambda: rg.rowspan_S_bwd(*args), 20))), flush=True)


def sweep_k7(dev, libs) -> None:
    for label, args in k7_calls(dev).items():
        want = ck.pair_hits_plain(*args)
        for p, lib in libs.items():
            with swapped("cluster_pair", lib):
                t, i = ck.pair_hits(*args)
                if not (torch.equal(t, want[0]) and torch.equal(i, want[1])):
                    raise AssertionError(f"K7 {label} at P = {p} differs "
                                         "from the plain version")
                print(json.dumps(dict(kernel="K7", launch=label,
                                      item_pairs=p, ms=cuda_ms(
                                          lambda: ck.pair_hits(*args), 5))),
                      flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("the sweep needs a CUDA device")
    dev = torch.device("cuda", 0)
    with ThreadPoolExecutor(2 * len(J_VALUES) + len(P_VALUES)) as pool:
        k2 = {j: pool.submit(variant, "rowspan_gather", rg._SIGNATURES,
                             "ITEM_JOBS", j) for j in J_VALUES}
        k3 = {j: pool.submit(variant, "rowspan_gather_bwd",
                             rg._BWD_SIGNATURES, "ITEM_JOBS", j)
              for j in J_VALUES}
        k7 = {p: pool.submit(variant, "cluster_pair", ck._PAIR_SIGNATURES,
                             "ITEM_PAIRS", p) for p in P_VALUES}
        k2 = {j: f.result() for j, f in k2.items()}
        k3 = {j: f.result() for j, f in k3.items()}
        k7 = {p: f.result() for p, f in k7.items()}
    jobs = headline_jobs(dev)
    sweep_k2(jobs, k2)
    sweep_k3(jobs, dev, k3)
    del jobs
    sweep_k7(dev, k7)


if __name__ == "__main__":
    main()
