"""The card's peaks and the least time a layer's work needs, counted from
the layer's own inputs and outputs — never from a kernel's job list or
cull, so that the count is the same whatever implements the layer.

Least time = max(operations ÷ peak float32 rate, bytes ÷ peak bandwidth),
with each input byte read once and each output byte written once."""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

MT_OPS = 53        # one Möller–Trumbore ray-triangle test
PAIR_OPS = 10 + 13  # a gather pair: distance test, then |n·wi|·alpha summed


def least_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)


def intersect_work(rays: int, triangles: int, any_hit: bool):
    """(ops, bytes) of one ray cast against a triangle set: rays in (origin,
    direction, t range: 32 B), the triangles' vertices (36 B each), the
    answers out (t and index, 8 B; any-hit: a flag, 1 B); one test a ray,
    the winner's, which any method has to make."""
    out = 1 if any_hit else 8
    return MT_OPS * rays, rays * (32 + out) + triangles * 36


def gather_work(slots: int, queries: int, pairs: int):
    """(ops, bytes) of one radius gather: the photon map in (position,
    flux, direction, valid flag: 37 B a slot), the queries in (position,
    radius², normal, kd/π: 40 B), the sums and counts out (16 B); the
    pairs inside the radius (the counts summed) each cost PAIR_OPS."""
    return PAIR_OPS * pairs, slots * 37 + queries * (40 + 16)
