"""Unified sample-request layout (port of raytrace_tpu/core/samples.py —
the reference's CudaSample flattening, util/sampler/cudasample.{h,cpp}).

Each request's block is stratified over its own (sx, sy) grid and every
uniform is threefry(key, request-draw order, GLOBAL sample id), so the port
draws the very numbers the JAX package draws.
"""
from __future__ import annotations

import torch
from torch import Tensor

from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.utils import metrics


def strata_2d(n: int) -> tuple[int, int]:
    """Factor n into the squarest (sx, sy) power-of-two-ish grid."""
    sx, sy = n, 1
    while sx > sy and (sx & 1) == 0:
        sx //= 2
        sy *= 2
    return sx, sy


class SampleLayout:
    """Accumulates 1D/2D sample requests into linear offsets
    (reference: CudaSample::Add1D/Add2D, util/sampler/cudasample.cpp:2-25)."""

    def __init__(self):
        self._n1d: list[int] = []
        self._n2d: list[int] = []

    def add_1d(self, n: int) -> int:
        off = sum(self._n1d)
        self._n1d.append(int(n))
        return off

    def add_2d(self, n: int) -> int:
        off = sum(self._n2d)
        self._n2d.append(int(n))
        return off

    def materialize_2d(self, key: Tensor, sample_ids: Tensor) -> Tensor:
        """Stratified 2D arrays for every request → [N, Σ requests, 2]: one key
        split per (request, stratum), uniforms folded with the global id."""
        n = sample_ids.shape[0]
        cols = []
        for req_n in self._n2d:
            sx, sy = strata_2d(req_n)
            for s in range(req_n):
                keys = prng.split(key)
                key, sub = keys[0], keys[1]
                u = prng.folded_uniform(sub, (sample_ids,), (2,))
                with metrics.sync("stratum"):
                    k = torch.tensor([s % sx, s // sx], dtype=torch.float32,
                                     device=key.device)
                with metrics.sync("strata"):
                    dim = torch.tensor([sx, sy], dtype=torch.float32,
                                       device=key.device)
                cols.append((u + k) / dim)
        if not cols:
            return torch.zeros((n, 0, 2), dtype=torch.float32,
                               device=key.device)
        return torch.stack(cols, dim=1)

    def materialize_1d(self, key: Tensor, sample_ids: Tensor) -> Tensor:
        """Stratified 1D arrays for every request → [N, Σ requests]: one key
        split per (request, stratum), uniforms folded with the global id."""
        n = sample_ids.shape[0]
        cols = []
        for req_n in self._n1d:
            for s in range(req_n):
                keys = prng.split(key)
                key, sub = keys[0], keys[1]
                u = prng.folded_uniform(sub, (sample_ids,), ())
                cols.append((u + s) / req_n)
        if not cols:
            return torch.zeros((n, 0), dtype=torch.float32, device=key.device)
        return torch.stack(cols, dim=1)
