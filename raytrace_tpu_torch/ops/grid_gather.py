"""Morton-span photon gather — kernel K5, its plain version and the span prep
(port of raytrace_tpu/ops/pallas_gather.py `gather_radius_pallas_grid` and
its `_grid_kernel`).

Photons are sorted by the Morton key of their grid cell (invalid photons
last), queries too, so each 128-query tile is spatially coherent. With the
cell at least as large as every radius, a tile's neighbourhood box
[min(cell) − 1, max(cell) + 1] maps to one contiguous span of the sorted
photons (Morton keys are monotone in each coordinate), a conservative
superset found with two `searchsorted` calls; the kernel walks that span's
chunks. Spans over-cover near octant boundaries (the JAX note on this
kernel): at phase k5's inputs 0.4% of a span's pairs count. So the kernel
drops pairs before the test, exactly: each warp of 32 queries skips the
chunks whose box (`chunk_boxes`) it cannot reach and the photons whose gap
to its query box exceeds its largest radius (`precull_plain`, the cull as a
predicate).

As in the JAX package, no renderer calls `gather_radius_grid`: the row-span
gather (ops/rowspan_gather.py) is the designed successor of this kernel.

`grid_S` is the kernel's wrapper: CUDA tensors launch csrc/grid_gather.cu
(each tile's span cut into work items of at most J chunks, one block per
item, the items summed per tile in a fixed order) or raise; CPU tensors
take `grid_S_plain`.
"""
from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from raytrace_tpu_torch.ops import cuda_lib
from raytrace_tpu_torch.ops.dense_gather import GROUP, gap2, group_box
from raytrace_tpu_torch.ops.photon_grid import morton3
from raytrace_tpu_torch.ops.rowspan_gather import (TILE_Q, _expand_ranges,
                                                   _pad0, tile_sums)
from raytrace_tpu_torch.ops.work_items import work_items

GRID_CHUNK = 512
ROWS = 10  # photon rows per chunk: px py pz wx wy wz valid ax ay az
_KEY_SENTINEL = 0xFFFFFFFF  # > any Morton key (30 bits): invalid photons
WARPS = TILE_Q // GROUP  # pre-cull boxes of a tile (csrc/grid_gather.cu)
_CULL_PER_STEP = 1 << 22  # plain pre-cull: (warp, photon) pairs per batch


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


def chunk_boxes(pdata) -> Tensor:
    """Each chunk's box over its valid photons → [n_chunks, 6] f32 (lo xyz,
    hi xyz). A NaN coordinate makes that axis NaN (the kernel then keeps
    the chunk on that axis); a chunk without a valid photon gets the
    inverted box (+inf, −inf), which no query reaches. Device ops only."""
    valid = pdata[:, 6:7, :] > 0.0
    p = pdata[:, :3, :]
    lo = torch.where(valid, p, float("inf")).amin(2)
    hi = torch.where(valid, p, float("-inf")).amax(2)
    return torch.cat([lo, hi], dim=1).contiguous()


def precull_plain(lo_chunk, nc, qpT, qr2, pdata) -> dict:
    """K5's pre-cull over the (tile, chunk) jobs of the spans, in tile order
    and chunk order → dict of tile, chunk [jobs] (the jobs), reach [jobs,
    WARPS] (the warp reaches the chunk's box) and keep [jobs, WARPS, chunk]
    (the photons the warp tests).

    A warp is GROUP consecutive queries of a tile, with K4's box and r2max
    (`dense_gather.group_box`; r2max 0: the warp keeps nothing). G of a
    photon, or of the chunk's box (`chunk_boxes`), to the warp's box is
    K4's (`dense_gather.gap2`), so dist² ≥ G for every query of the warp:
    a chunk or photon with G ≥ r2max, or an invalid photon, counts for
    none of them and is dropped; a NaN G is kept. A chunk's box holds each
    of its photons, so a warp keeps no photon of a chunk it does not
    reach."""
    tile, chunk_id = _expand_ranges(lo_chunk, lo_chunk + nc)
    n_tiles, chunk = lo_chunk.shape[0], pdata.shape[2]
    lo, hi, r2max = group_box(  # [n_tiles, WARPS, 3] ×2, [n_tiles, WARPS]
        qpT.view(3, n_tiles, WARPS, GROUP).permute(1, 2, 3, 0),
        qr2.view(n_tiles, WARPS, GROUP))
    box = chunk_boxes(pdata)
    reach, keep = [], []
    step = max(1, _CULL_PER_STEP // (WARPS * chunk))
    for j0 in range(0, tile.shape[0], step):
        t, c = tile[j0:j0 + step], chunk_id[j0:j0 + step]
        wlo, whi, rm = lo[t], hi[t], r2max[t]  # [B, WARPS, 3], [B, WARPS]
        b = box[c][:, None, :]  # [B, 1, 6]
        reach.append(~(gap2(b[..., :3], b[..., 3:], wlo, whi) >= rm)
                     & (rm > 0.0))
        ph = pdata[c][:, None, :3].transpose(2, 3)  # [B, 1, chunk, 3]
        g = gap2(ph, ph, wlo[:, :, None], whi[:, :, None])
        keep.append(~(g >= rm[..., None]) & (rm[..., None] > 0.0)
                    & (pdata[c, 6][:, None] > 0.0))
    empty = lambda *s: torch.zeros((0, *s), dtype=torch.bool,
                                   device=qpT.device)
    return dict(tile=tile, chunk=chunk_id,
                reach=torch.cat(reach) if reach else empty(WARPS),
                keep=torch.cat(keep) if keep else empty(WARPS, chunk))


_SIGNATURES = {"grid_gather_item_chunks": [],
               "grid_gather": [ctypes.c_void_p] * 3 + [ctypes.c_int]
               + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
               + [ctypes.c_void_p] * 8}


def grid_S(lo_chunk, nc, qpT, qr2, qnsT, pdata) -> Tensor:
    """Kernel K5 over the tiles' chunk spans → [4, n_tiles·128] (see
    grid_S_plain).

    lo_chunk/nc [n_tiles] int32, spans inside pdata; qpT/qnsT [3, NQ], qr2
    [NQ] f32 with NQ = n_tiles·128; pdata [n_chunks, 10, chunk] f32. CPU
    tensors take the plain version; CUDA tensors launch the kernel. The
    chunk boxes of its skip are computed here from pdata, so that they
    always hold its photons. The grid is one block per work item: the
    spans' total is read once on the host, since no bound known to the
    host keeps the scratch small (a tile's span may cover every chunk)."""
    if qpT.device.type == "cpu":
        return grid_S_plain(lo_chunk, nc, qpT, qr2, qnsT, pdata)
    n_tiles = lo_chunk.shape[0]
    nq = n_tiles * TILE_Q
    n_chunks, _, chunk = pdata.shape
    dev = qpT.device
    cuda_lib.check_inputs("grid_S", dev, [
        (lo_chunk, torch.int32, (n_tiles,)), (nc, torch.int32, (n_tiles,)),
        (qpT, torch.float32, (3, nq)), (qr2, torch.float32, (nq,)),
        (qnsT, torch.float32, (3, nq)),
        (pdata, torch.float32, (n_chunks, ROWS, chunk))])
    if not 0 < chunk <= 1024:  # the staged rows must fit in shared memory
        raise ValueError(f"grid_S: chunk {chunk} outside (0, 1024]")
    lib = cuda_lib.load("grid_gather", _SIGNATURES)
    item_chunks = lib.grid_gather_item_chunks()
    slots = n_tiles + int(nc.clamp(min=0).sum()) // item_chunks
    item_tile, lo, hi, first, count = work_items(lo_chunk, lo_chunk + nc,
                                                 item_chunks, slots)
    cbox = chunk_boxes(pdata)
    done = torch.zeros((n_tiles,), dtype=torch.int32, device=dev)
    partial = torch.empty((slots, 4, TILE_Q), dtype=torch.float32, device=dev)
    out = torch.zeros((4, nq), dtype=torch.float32, device=dev)
    p = cuda_lib.ptr
    err = lib.grid_gather(p(item_tile), p(lo), p(hi), slots, p(first),
                          p(count), p(done), n_tiles, chunk, p(qpT), p(qr2),
                          p(qnsT), p(pdata), p(cbox), p(partial), p(out),
                          cuda_lib.stream_ptr(dev))
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
