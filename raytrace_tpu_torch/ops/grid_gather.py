"""Morton-span photon gather — kernel K5, its plain version and the span prep
(port of raytrace_tpu/ops/pallas_gather.py `gather_radius_pallas_grid` and
its `_grid_kernel`).

Photons are sorted by the Morton key of their grid cell (invalid photons
last), queries too, so each 128-query tile is spatially coherent. With the
cell at least as large as every radius, a tile's neighbourhood box
[min(cell) − 1, max(cell) + 1] maps to one contiguous span of the sorted
photons (Morton keys are monotone in each coordinate), a conservative
superset found with two `searchsorted` calls; the kernel walks that span's
chunks. Spans over-cover near octant boundaries, so the cost grows with the
spans, not only with the photons in reach (the JAX note on this kernel).

As in the JAX package, no renderer calls `gather_radius_grid`: the row-span
gather (ops/rowspan_gather.py) is the designed successor of this kernel.

`grid_S` is the kernel's wrapper: CUDA tensors launch csrc/grid_gather.cu
(one block per query tile over its own chunk span) or raise; CPU tensors
take `grid_S_plain`.
"""
from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from raytrace_tpu_torch.ops import cuda_lib
from raytrace_tpu_torch.ops.photon_grid import morton3
from raytrace_tpu_torch.ops.rowspan_gather import (TILE_Q, _expand_ranges,
                                                   _pad0, tile_sums)

GRID_CHUNK = 512
ROWS = 10  # photon rows per chunk: px py pz wx wy wz valid ax ay az
_KEY_SENTINEL = 0xFFFFFFFF  # > any Morton key (30 bits): invalid photons


def grid_spans(photons_p, photons_alpha, photons_wi, photons_valid,
               cell_size, q_p, radius2, q_ns, chunk: int = GRID_CHUNK) -> dict:
    """The prep of gather_radius_pallas_grid: Morton-sorted photon chunks
    pdata [n_chunks, 10, chunk], Morton-sorted query tiles (qpT/qnsT
    [3, NQ], qr2 [NQ], padded queries with r² = 0) and each tile's chunk
    span [lo_chunk, lo_chunk + nc), int32, plus qorder to unsort."""
    photons_p, photons_alpha, photons_wi, photons_valid, q_p, radius2, q_ns = (
        x.detach() for x in (photons_p, photons_alpha, photons_wi,
                             photons_valid, q_p, radius2, q_ns))
    dev = q_p.device
    n, p = q_p.shape[0], photons_p.shape[0]
    cs = torch.as_tensor(cell_size, dtype=torch.float32, device=dev)
    big = 2 ** 30

    # ---- sort photons by Morton cell key (invalid → sentinel, sorts last)
    pv = photons_valid
    cell = torch.floor(photons_p / cs).to(torch.int64)
    origin = torch.where(pv[:, None], cell, big).min(dim=0).values
    origin = torch.where(origin == big, 0, origin)  # no valid photons
    pkey = torch.where(pv, morton3(torch.clamp(cell - origin, 0, 1023)),
                       _KEY_SENTINEL)
    order = torch.argsort(pkey, stable=True)
    pkey_s = pkey[order]
    packed = torch.cat([photons_p, photons_wi, pv.to(torch.float32)[:, None],
                        photons_alpha], dim=1)[order]
    packed = _pad0(packed, -p % chunk)
    n_chunks = packed.shape[0] // chunk
    pdata = packed.T.reshape(ROWS, n_chunks, chunk).transpose(0, 1)

    # ---- Morton-sort the queries for tile coherence
    qcell = torch.floor(q_p / cs).to(torch.int64) - origin
    key = lambda c: morton3(torch.clamp(c, 0, 1023))
    qorder = torch.argsort(key(qcell), stable=True)
    n_pad = -n % TILE_Q
    n_tiles = (n + n_pad) // TILE_Q
    pad_key = lambda k, fill: torch.cat([k[qorder], torch.full(
        (n_pad,), fill, dtype=k.dtype, device=dev)]).reshape(n_tiles, TILE_Q)

    # ---- per-tile photon chunk spans
    qlo_t = pad_key(key(qcell - 1), _KEY_SENTINEL).min(dim=1).values
    qhi_t = pad_key(key(qcell + 1), 0).max(dim=1).values
    lo_idx = torch.searchsorted(pkey_s, qlo_t)
    hi_idx = torch.searchsorted(pkey_s, qhi_t, right=True)
    lo_chunk = lo_idx // chunk
    nc = torch.clamp(-(-(hi_idx - lo_chunk * chunk) // chunk), min=0)
    i32 = lambda x: x.to(torch.int32).contiguous()
    return dict(lo_chunk=i32(lo_chunk), nc=i32(nc),
                qpT=_pad0(q_p[qorder], n_pad).T.contiguous(),
                qr2=_pad0(radius2[qorder], n_pad).contiguous(),
                qnsT=_pad0(q_ns[qorder], n_pad).T.contiguous(),
                pdata=pdata.contiguous(), qorder=qorder)


def grid_S_plain(lo_chunk, nc, qpT, qr2, qnsT, pdata) -> Tensor:
    """Plain PyTorch version of K5 → [4, n_tiles·128]: rows 0-2 the weighted
    flux S = Σ_{dist² < r², valid} |n_s·wi|·α over the photons of the tile's
    chunks [lo_chunk, lo_chunk + nc), row 3 the count M."""
    tile_of_job, chunk_of_job = _expand_ranges(lo_chunk, lo_chunk + nc)
    return tile_sums(tile_of_job, chunk_of_job, lo_chunk.shape[0], qpT, qr2,
                     qnsT, pdata, alpha_row=7)


_SIGNATURES = {"grid_gather": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
               + [ctypes.c_void_p] * 6}


def grid_S(lo_chunk, nc, qpT, qr2, qnsT, pdata) -> Tensor:
    """Kernel K5 over the tiles' chunk spans → [4, n_tiles·128] (see
    grid_S_plain).

    lo_chunk/nc [n_tiles] int32; qpT/qnsT [3, NQ], qr2 [NQ] f32 with
    NQ = n_tiles·128; pdata [n_chunks, 10, chunk] f32. CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if qpT.device.type == "cpu":
        return grid_S_plain(lo_chunk, nc, qpT, qr2, qnsT, pdata)
    n_tiles = lo_chunk.shape[0]
    nq = n_tiles * TILE_Q
    n_chunks, _, chunk = pdata.shape
    cuda_lib.check_inputs("grid_S", qpT.device, [
        (lo_chunk, torch.int32, (n_tiles,)), (nc, torch.int32, (n_tiles,)),
        (qpT, torch.float32, (3, nq)), (qr2, torch.float32, (nq,)),
        (qnsT, torch.float32, (3, nq)),
        (pdata, torch.float32, (n_chunks, ROWS, chunk))])
    if not 0 < chunk <= 1024:  # 10 staged rows must fit in 48 KB of smem
        raise ValueError(f"grid_S: chunk {chunk} outside (0, 1024]")
    lib = cuda_lib.load("grid_gather", _SIGNATURES)
    out = torch.empty((4, nq), dtype=torch.float32, device=qpT.device)
    ptr = cuda_lib.ptr
    err = lib.grid_gather(ptr(lo_chunk), ptr(nc), n_tiles, chunk,
                          ptr(qpT), ptr(qr2), ptr(qnsT), ptr(pdata), ptr(out),
                          cuda_lib.stream_ptr(qpT.device))
    cuda_lib.check(err, "grid_gather")
    grid_S.launches += 1
    return out


grid_S.launches = 0


def gather_radius_grid(photons_p, photons_alpha, photons_wi, photons_valid,
                       cell_size, q_p, radius2, q_ns, q_kd_over_pi,
                       chunk: int = GRID_CHUNK):
    """Exact radius search + photon shading over a Morton-sorted photon grid
    → (L [N, 3], M [N] int32), the contract of JAX
    `gather_radius_pallas_grid`: cell_size must be ≥ every radius (≥ the
    largest live one). radius2 = 0 disables a query. Forward only."""
    n = q_p.shape[0]
    sp = grid_spans(photons_p, photons_alpha, photons_wi, photons_valid,
                    cell_size, q_p, radius2, q_ns, chunk=chunk)
    out = grid_S(sp["lo_chunk"], sp["nc"], sp["qpT"], sp["qr2"], sp["qnsT"],
                 sp["pdata"])
    unsort = torch.empty_like(sp["qorder"])
    unsort[sp["qorder"]] = torch.arange(n, device=q_p.device)
    return (q_kd_over_pi * out[:3, :n].T[unsort],
            out[3, :n][unsort].to(torch.int32))
