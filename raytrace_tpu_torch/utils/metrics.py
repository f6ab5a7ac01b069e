"""Observability: structured per-pass logging, throughput counters and a
profiler hook (port of raytrace_tpu/utils/metrics.py).

  - `log_pass(...)`: one structured key=value line per render pass through
    the standard logging module;
  - `Throughput`: wall-clock counter → rays/s, photons/s;
  - `trace(log_dir)`: context manager around torch.profiler, writing a
    Chrome trace of the block (host and, on a GPU, device timelines);
  - `span(name)`, `sync(site)`: named ranges of the frame on the profiler's
    host timeline, on exactly while a torch.profiler records and one flag
    check otherwise;
  - `count(name, n)`: host counters (`COUNTERS`) of values the host
    already holds, added to under the same condition;
  - `device_counter(name, device)`: a counter on the card (in
    `DEVICE_COUNTERS`) that a kernel adds to under the same condition.

Span names start with the layer they belong to: `rt.frame.*` (the
renderer's passes), `rt.intersect.*` (the triangle casts and their
engines), `rt.gather*` (the radius gather) and `rt.sync.<site>`, which
wraps exactly one operation that makes the host wait for the card (a
`nonzero`, a boolean-mask index, an `int()`/`bool()`/`.tolist()` of a card
tensor, a copy of a host value to the card). A span launches nothing and
synchronizes nothing, so the frame's device work is the same with tracing
on or off.

JAX's `device_debug_print` (a print gated on one debug pixel inside jitted
code) has no counterpart: the port runs eagerly, so a masked tensor can be
printed where it is computed.
"""
from __future__ import annotations

import collections
import contextlib
import logging
import os
import time

import torch
import torch.autograd.profiler as _profiler

logger = logging.getLogger("raytrace_tpu_torch")


def log_pass(pass_name: str, **fields) -> None:
    """One structured line per pass: `pass=photon_wave wave=3 photons=...`"""
    kv = " ".join(f"{k}={v}" for k, v in fields.items())
    logger.info("pass=%s %s", pass_name, kv)


class Throughput:
    """Wall-clock throughput meter.

    with Throughput() as t: ...render...
    t.rate(n_rays) → rays/s

    The caller synchronizes the device inside the block: PyTorch returns
    before queued CUDA work is done."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        return False

    def rate(self, count: float) -> float:
        return count / max(self.seconds, 1e-12)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of a block → `log_dir/trace.json` (Chrome trace
    format, viewable in Perfetto); CUDA activity is recorded when a GPU is
    present."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


_OFF = contextlib.nullcontext()


def span(name: str):
    """Context manager: a range named `name` on the profiler's host
    timeline while a torch.profiler records (its host events then hold it,
    on the clock of the card's records, and `trace(log_dir)` writes it to
    the Chrome trace); otherwise one flag check and a shared no-op."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


def sync(site: str):
    """`span("rt.sync.<site>")`, placed around exactly one operation that
    makes the host wait for the card."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function("rt.sync." + site)


# name → total, added to by `count` while a profiler records (since the
# process started; clear it to start over): chain_lanes, the lanes the
# camera walk cast at depths ≥ 1, and chain_depths, those depths
COUNTERS: collections.Counter = collections.Counter()


def count(name: str, n: int) -> None:
    """COUNTERS[name] += n while a torch.profiler records; otherwise one
    flag check. `n` is a host int: a counter never reads the card."""
    if _profiler._is_profiler_enabled:
        COUNTERS[name] += n


# (name, device) → int64 tensor on the device that a kernel adds to while a
# torch.profiler records (since the kernel's first launch; zero it to start
# over): cull_tests, K8's box tests (ran, asked; ops/epoch_kernels.py
# `cull_bits`)
DEVICE_COUNTERS: dict = {}


def device_counter(name: str, device):
    """The card's counter DEVICE_COUNTERS[(name, device)] (int64 [2], made
    zero at the first call, whether or not a profiler records, so that its
    zeroing falls outside a traced window) while a torch.profiler records;
    otherwise None, for the kernel to count nothing. The program only hands
    it to kernels: a counter never reads the card."""
    key = (name, device)
    buf = DEVICE_COUNTERS.get(key)
    if buf is None:
        buf = DEVICE_COUNTERS[key] = torch.zeros(2, dtype=torch.int64,
                                                 device=device)
    return buf if _profiler._is_profiler_enabled else None
