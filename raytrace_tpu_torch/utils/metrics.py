"""Observability: structured per-pass logging, throughput counters and a
profiler hook (port of raytrace_tpu/utils/metrics.py).

  - `log_pass(...)`: one structured key=value line per render pass through
    the standard logging module;
  - `Throughput`: wall-clock counter → rays/s, photons/s;
  - `trace(log_dir)`: context manager around torch.profiler, writing a
    Chrome trace of the block (host and, on a GPU, device timelines).

JAX's `device_debug_print` (a print gated on one debug pixel inside jitted
code) has no counterpart: the port runs eagerly, so a masked tensor can be
printed where it is computed.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

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
