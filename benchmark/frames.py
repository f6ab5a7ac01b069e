"""What the entries share: the keys of a run, the kernel build, the window
of back-to-back calls, the traced window, the per-layer readers, the
device line and the draw of the call and pixels a run checks."""
from __future__ import annotations

import gc
import statistics
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from benchmark import spec
from benchmark import trace as T

MASK = 0xFFFFFFFF


def word(seed: int, i: int) -> int:
    """The 32-bit key seed of call i of a run (i < 0: warm-up calls)."""
    return (seed * 2654435761 + i + 0x9E3779B9) & MASK


def build_kernels(names, host: bool) -> float:
    """nvcc (and for BVH scenes g++) builds of the program's kernels into
    its fixed build directory, all at once; a build that exists is only
    hashed → seconds."""
    from raytrace_tpu_torch.ops import cuda_lib

    t = time.perf_counter()
    with ThreadPoolExecutor(len(names) + 1) as pool:
        jobs = [pool.submit(cuda_lib.build, n) for n in names]
        if host:
            jobs.append(pool.submit(cuda_lib.build_host, "bvh_builder"))
        for j in jobs:
            j.result()
    return time.perf_counter() - t


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def window(call, seconds: float, dev):
    """Calls back to back until `seconds` have passed → (outputs, the wall
    time of each call, the window's wall time from the first call's start
    to the last one's end)."""
    outs, walls = [], []
    start = time.perf_counter()
    end = start
    while end - start < seconds:
        a = time.perf_counter()
        outs.append(call(len(outs)))
        sync(dev)
        end = time.perf_counter()
        walls.append(end - a)
    return outs, walls, end - start


def _profiled(call, n: int, dev, host: bool, counters=None):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] if host or dev.type != "cuda" else []
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    counters = counters if counters is not None else T.Counters()
    outs = []
    with T.count_layers(counters), profile(activities=acts) as prof:
        a = time.perf_counter()
        for i in range(n):
            outs.append(call(i))
        sync(dev)
        wall = time.perf_counter() - a
    return outs, T.collect(prof, wall, n, counters)


def traced(call, n: int, dev):
    """n calls profiled on the card alone (CUPTI's kernel records, without
    the host operations, whose recording slows the host by microseconds an
    operation), with the layer counters on, then one call more profiled with
    the host operations, which name the idle gaps → (outputs of the n calls,
    trace.Trace of them with the gaps named from the last call)."""
    outs, tr = _profiled(call, n, dev, host=dev.type != "cuda")
    _, named = _profiled(lambda i: call(n + i), 1, dev, host=True)
    tr.gap_source = named
    return outs, tr


def p90(values) -> float:
    return statistics.quantiles(values, n=10, method="inclusive")[-1]


def per_layer(cell, tr) -> dict:
    out = {}
    for m in cell.per_layer:
        v = spec.load_module("metrics", m["name"], cell.root).read(tr)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def device_info(cell, dev, peak: int, tr=None) -> dict:
    import torch

    d = dict(platform="gpu" if dev.type == "cuda" else "cpu",
             kind=torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu", count=cell.chips, memory_peak_bytes=int(peak))
    if tr is not None:
        d["busy_s"] = tr.busy_s()
        d["window_s"] = tr.window_s
    return d


def peak_bytes(dev) -> int:
    import torch

    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def free(dev):
    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def sample(seed: int, n_calls: int, n_pixels: int, n_check: int):
    """The call and the pixels a run checks, drawn from its seed."""
    rng = np.random.default_rng(seed & 0xFFFFFFFFFFFFFFFF)
    j = int(rng.integers(n_calls))
    pix = rng.choice(n_pixels, size=min(n_check, n_pixels), replace=False)
    return j, np.sort(pix)


def check_entry(name, value, limit, exact: bool = False) -> dict:
    ok = value == limit if exact and limit == 0 else value <= limit
    return {name: dict(value=value, limit=limit, ok=bool(ok))}
