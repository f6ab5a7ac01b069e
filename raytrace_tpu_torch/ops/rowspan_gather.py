"""Row-span photon gather — kernel K2, its plain version, and the job-list prep
(port of the row-span part of raytrace_tpu/ops/pallas_gather.py:
`gather_radius_pallas_rowspan` and `_rowspan_kernel`).

The prep is the JAX prep in PyTorch ops: photons sorted by linear cell key
(cz<<20 | cy<<10 | cx), queries Morton-sorted into 128-query tiles, each
tile's neighbourhood box cut into ≤ r_max (z, y)-row spans, spans merged
into a tile-major (tile, chunk) job list. Capacity is job_budget·rounds
jobs; truncation cuts a suffix of the list, `overflow` counts the cut jobs
and tiles not scanned completely return L = 0, M = 0 with covered = False,
exactly as in the JAX function.

`rowspan_S` is the kernel's wrapper: CUDA tensors launch
csrc/rowspan_gather.cu (one block per work item of at most J jobs of one
tile, the items summed per tile in a fixed order) or raise; CPU tensors
take `rowspan_S_plain`, which batches jobs as
[B, 128, chunk] blocks and adds them into their tiles with `index_add_`.
The TPU kernel ran the list in `rounds` launches because its job ids had to
fit SMEM; one launch covers every round here, since S adds across rounds.

The gradient (port of `_rowspan_S`'s custom VJP and `_rowspan_bwd_kernel`,
kernel K3): S is linear in α with weights that depend only on geometry, so
`RowspanS.backward` runs the transposed sum dα_p = Σ_q w_qp·cot_q over the
same valid jobs, re-sorted chunk-major (`chunk_major`). `rowspan_S_bwd` is
K3's wrapper (csrc/rowspan_gather_bwd.cu, one block per work item of at most
J jobs of one chunk, the items summed per chunk in a fixed order) with
`rowspan_S_bwd_plain` beside it, exactly as for K2.
"""
from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from raytrace_tpu_torch.ops import cuda_lib
from raytrace_tpu_torch.ops.photon_grid import morton3
from raytrace_tpu_torch.ops.work_items import work_items
from raytrace_tpu_torch.utils import metrics

TILE_Q = 128
ROWSPAN_CHUNK = 512
R_MAX = 32
ROWS = 16  # photon rows per chunk: px py pz wx wy wz valid pad ax ay az pad×5
_KEY_SENTINEL = 0x40000000  # > any packed key (30 bits)
_PAIRS_PER_STEP = 1 << 22  # plain version: queries × photons per batch


def _expand_ranges(begin: Tensor, end: Tensor):
    """Per-owner job ranges [begin, end) → (owner of each job, job index),
    in owner order and, within an owner, in job order."""
    counts = torch.clamp(end - begin, min=0).long()
    owner = torch.repeat_interleave(
        torch.arange(begin.shape[0], device=begin.device), counts)
    first = torch.cumsum(counts, 0) - counts
    job = (begin.long()[owner]
           + torch.arange(owner.shape[0], device=begin.device)
           - first[owner])
    return owner, job


def _pair_weights(q, r2, ns, t, ph):
    """(ok, |n_s·wi|·ok) [B, 128, chunk] for B jobs: query tiles t [B] of
    q/ns [3, n_tiles, 128] and r2 [n_tiles, 128], photon chunks ph
    [B, rows, chunk] (rows 0-2 p, 3-5 wi, 6 valid). K2, K3 and K5 form the
    same pairs in the same way."""
    r = lambda a: a[:, :, None]  # [B, TQ] → [B, TQ, 1]
    c = lambda row: ph[:, row, None, :]  # → [B, 1, chunk]
    dx = r(q[0, t]) - c(0)
    dy = r(q[1, t]) - c(1)
    dz = r(q[2, t]) - c(2)
    dist2 = dx * dx + dy * dy + dz * dz
    ok = (dist2 < r(r2[t])) & (c(6) > 0.0)
    w = torch.abs(r(ns[0, t]) * c(3) + r(ns[1, t]) * c(4)
                  + r(ns[2, t]) * c(5))
    return ok, torch.where(ok, w, 0.0)


def rowspan_S_plain(pid, tile_begin, tile_end, n_chunks, qpT, qr2, qnsT,
                    pdata):
    """Plain PyTorch version of K2 → [4, n_tiles·128]: rows 0-2 the weighted
    flux S = Σ_{dist² < r², valid} |n_s·wi|·α over the tile's jobs
    [tile_begin, tile_end) of `pid`, row 3 the count M."""
    tile_of_job, job = _expand_ranges(tile_begin, tile_end)
    return tile_sums(tile_of_job, pid.long()[job] % n_chunks,
                     tile_begin.shape[0], qpT, qr2, qnsT, pdata, alpha_row=8)


def tile_sums(tile_of_job, chunk_of_job, n_tiles: int, qpT, qr2, qnsT, pdata,
              alpha_row: int) -> Tensor:
    """Σ over (tile, chunk) jobs → [4, n_tiles·128]: per query the weighted
    flux S (rows 0-2, from pdata rows alpha_row..alpha_row+2) and the count
    M (row 3) of the photons of its tile's jobs, job by job in order. The
    plain versions of K2 and K5."""
    chunk = pdata.shape[2]
    q = qpT.reshape(3, n_tiles, TILE_Q)
    ns = qnsT.reshape(3, n_tiles, TILE_Q)
    r2 = qr2.reshape(n_tiles, TILE_Q)
    out = torch.zeros((n_tiles, 4, TILE_Q), dtype=torch.float32,
                      device=qpT.device)
    batch = max(1, _PAIRS_PER_STEP // (TILE_Q * chunk))
    for b0 in range(0, tile_of_job.shape[0], batch):
        t = tile_of_job[b0:b0 + batch]
        ph = pdata[chunk_of_job[b0:b0 + batch]]  # [B, rows, chunk]
        ok, wm = _pair_weights(q, r2, ns, t, ph)
        c = lambda row: ph[:, row, None, :]
        s = torch.stack([torch.sum(wm * c(alpha_row), dim=2),
                         torch.sum(wm * c(alpha_row + 1), dim=2),
                         torch.sum(wm * c(alpha_row + 2), dim=2),
                         torch.sum(ok, dim=2, dtype=torch.float32)], dim=1)
        out.index_add_(0, t, s)
    return out.permute(1, 0, 2).reshape(4, n_tiles * TILE_Q)


_SIGNATURES = {"rowspan_gather_item_jobs": [],
               "rowspan_gather": [ctypes.c_void_p] * 4 + [ctypes.c_int]
               + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
               + [ctypes.c_void_p] * 7}


def rowspan_S(pid, tile_begin, tile_end, n_chunks, qpT, qr2, qnsT, pdata):
    """Kernel K2 over the job list → [4, n_tiles·128] (see rowspan_S_plain).

    pid [jobs] int32 (tile·n_chunks + chunk, tile-major); tile_begin/
    tile_end [n_tiles] int32 job ranges, disjoint within pid; qpT/qnsT
    [3, NQ], qr2 [NQ] f32; pdata [n_chunks, 16, chunk] f32. CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    if qpT.device.type == "cpu":
        return rowspan_S_plain(pid, tile_begin, tile_end, n_chunks, qpT, qr2,
                               qnsT, pdata)
    n_tiles = tile_begin.shape[0]
    nq = n_tiles * TILE_Q
    chunk = pdata.shape[2]
    cuda_lib.check_inputs("rowspan_S", qpT.device, [
        (pid, torch.int32, None), (tile_begin, torch.int32, (n_tiles,)),
        (tile_end, torch.int32, (n_tiles,)),
        (qpT, torch.float32, (3, nq)), (qr2, torch.float32, (nq,)),
        (qnsT, torch.float32, (3, nq)),
        (pdata, torch.float32, (n_chunks, ROWS, chunk))])
    if not 0 < chunk <= 1024:  # the staged rows must fit in 48 KB of smem
        raise ValueError(f"rowspan_S: chunk {chunk} outside (0, 1024]")
    lib = cuda_lib.load("rowspan_gather", _SIGNATURES)
    # each tile's jobs cut into work items of J jobs, one block per item,
    # on a grid sized without a host sync: the ranges are disjoint in pid
    item_jobs = lib.rowspan_gather_item_jobs()
    slots = n_tiles + pid.shape[0] // item_jobs
    item_tile, lo, hi, first, count = work_items(tile_begin, tile_end,
                                                 item_jobs, slots)
    dev = qpT.device
    done = torch.zeros((n_tiles,), dtype=torch.int32, device=dev)
    partial = torch.empty((slots, 4, TILE_Q), dtype=torch.float32, device=dev)
    out = torch.zeros((4, nq), dtype=torch.float32, device=dev)
    p = cuda_lib.ptr
    err = lib.rowspan_gather(
        p(pid), p(item_tile), p(lo), p(hi), slots, p(first), p(count),
        p(done), n_tiles, n_chunks, chunk, p(qpT), p(qr2), p(qnsT), p(pdata),
        p(partial), p(out), cuda_lib.stream_ptr(dev))
    cuda_lib.check(err, "rowspan_gather")
    rowspan_S.launches += 1
    return out


rowspan_S.launches = 0


def chunk_major(pid, n_valid, n_chunks: int, n_tiles: int):
    """K3's job order (JAX `_rowspan_S_bwd`): the first n_valid jobs of the
    tile-major list, stably re-sorted by (chunk, tile), and each chunk's
    range of them → (pid [jobs], chunk_begin, chunk_end [n_chunks]), int32.
    Fill jobs past n_valid (K2 never runs them) sort last and fall in no
    range; a chunk that no job touches gets an empty range."""
    p = pid.long()
    valid = torch.arange(p.shape[0], device=p.device) < n_valid
    chunk_id = p % n_chunks
    key = torch.where(valid, chunk_id * n_tiles + p // n_chunks,
                      n_chunks * n_tiles)
    order = torch.argsort(key, stable=True)
    counts = torch.zeros((n_chunks,), dtype=torch.int64, device=p.device)
    counts.index_add_(0, chunk_id, valid.long())
    chunk_end = torch.cumsum(counts, 0)
    i32 = lambda x: x.to(torch.int32).contiguous()
    return i32(pid[order]), i32(chunk_end - counts), i32(chunk_end)


def rowspan_S_bwd_plain(pid, chunk_begin, chunk_end, n_tiles, qpT, qr2, qnsT,
                        cotT, pdata):
    """Plain PyTorch version of K3 → [n_chunks, 4, chunk]: rows 0-2
    dα_p = Σ_{dist² < r², valid} |n_s·wi_p|·cot_q over the chunk's jobs
    [chunk_begin, chunk_end) of the chunk-major `pid`, row 3 the photon's
    term count. A chunk without jobs is 0."""
    n_chunks, _, chunk = pdata.shape
    chunk_of_job, job = _expand_ranges(chunk_begin, chunk_end)
    tile_of_job = pid.long()[job] // n_chunks

    q = qpT.reshape(3, n_tiles, TILE_Q)
    ns = qnsT.reshape(3, n_tiles, TILE_Q)
    r2 = qr2.reshape(n_tiles, TILE_Q)
    cot = cotT.reshape(3, n_tiles, TILE_Q)
    out = torch.zeros((n_chunks, 4, chunk), dtype=torch.float32,
                      device=qpT.device)
    batch = max(1, _PAIRS_PER_STEP // (TILE_Q * chunk))
    for b0 in range(0, chunk_of_job.shape[0], batch):
        t = tile_of_job[b0:b0 + batch]
        cid = chunk_of_job[b0:b0 + batch]
        ok, wm = _pair_weights(q, r2, ns, t, pdata[cid])
        r = lambda row: cot[row, t][:, :, None]  # [B, TQ, 1]
        d = torch.stack([torch.sum(wm * r(0), dim=1),
                         torch.sum(wm * r(1), dim=1),
                         torch.sum(wm * r(2), dim=1),
                         torch.sum(ok, dim=1, dtype=torch.float32)], dim=1)
        out.index_add_(0, cid, d)
    return out


_BWD_SIGNATURES = {"rowspan_gather_bwd_item_jobs": [],
                   "rowspan_gather_bwd": [ctypes.c_void_p] * 4 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 8}


def rowspan_S_bwd(pid, chunk_begin, chunk_end, n_tiles, qpT, qr2, qnsT, cotT,
                  pdata):
    """Kernel K3 over the chunk-major job list → [n_chunks, 4, chunk] (see
    rowspan_S_bwd_plain).

    pid [jobs] int32 from `chunk_major`; chunk_begin/chunk_end [n_chunks]
    int32; qpT/qnsT/cotT [3, NQ], qr2 [NQ] f32; pdata [n_chunks, 16, chunk]
    f32 (its alpha rows are not read). CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    if qpT.device.type == "cpu":
        return rowspan_S_bwd_plain(pid, chunk_begin, chunk_end, n_tiles, qpT,
                                   qr2, qnsT, cotT, pdata)
    n_chunks, _, chunk = pdata.shape
    nq = n_tiles * TILE_Q
    cuda_lib.check_inputs("rowspan_S_bwd", qpT.device, [
        (pid, torch.int32, None), (chunk_begin, torch.int32, (n_chunks,)),
        (chunk_end, torch.int32, (n_chunks,)),
        (qpT, torch.float32, (3, nq)), (qr2, torch.float32, (nq,)),
        (qnsT, torch.float32, (3, nq)), (cotT, torch.float32, (3, nq)),
        (pdata, torch.float32, (n_chunks, ROWS, chunk))])
    if not 0 < chunk <= 1024:  # one thread per photon of the chunk
        raise ValueError(f"rowspan_S_bwd: chunk {chunk} outside (0, 1024]")
    lib = cuda_lib.load("rowspan_gather_bwd", _BWD_SIGNATURES)
    # each chunk's jobs cut into work items of J jobs, one block per item,
    # on a grid sized without a host sync
    item_jobs = lib.rowspan_gather_bwd_item_jobs()
    slots = n_chunks + pid.shape[0] // item_jobs
    item_chunk, lo, hi, first, count = work_items(chunk_begin, chunk_end,
                                                  item_jobs, slots)
    dev = qpT.device
    done = torch.zeros((n_chunks,), dtype=torch.int32, device=dev)
    partial = torch.empty((slots, 4, chunk), dtype=torch.float32, device=dev)
    out = torch.zeros((n_chunks, 4, chunk), dtype=torch.float32, device=dev)
    p = cuda_lib.ptr
    err = lib.rowspan_gather_bwd(
        p(pid), p(item_chunk), p(lo), p(hi), slots, p(first), p(count),
        p(done), n_chunks, n_tiles, chunk, p(qpT), p(qr2), p(qnsT), p(cotT),
        p(pdata), p(partial), p(out), cuda_lib.stream_ptr(dev))
    cuda_lib.check(err, "rowspan_gather_bwd")
    rowspan_S_bwd.launches += 1
    return out


rowspan_S_bwd.launches = 0


class RowspanS(torch.autograd.Function):
    """S = K2 over the job list, differentiable in pdata's alpha rows (8-10)
    through K3 (JAX `_rowspan_S` and its custom VJP). The geometry rows and
    every other input get no gradient, as JAX stop-gradients them.

    JAX ran one VJP per round; one K3 launch covers every round here, since
    dα adds across rounds just as S does. Cotangents of tiles that were not
    scanned completely are already 0: the caller masks S with tile_ok."""

    @staticmethod
    def forward(ctx, pdata, pid, tile_begin, tile_end, n_chunks, qpT, qr2,
                qnsT, n_valid):
        ctx.save_for_backward(pdata, pid, qpT, qr2, qnsT, n_valid)
        ctx.n_chunks = n_chunks
        return rowspan_S(pid, tile_begin, tile_end, n_chunks, qpT, qr2, qnsT,
                         pdata)

    @staticmethod
    def backward(ctx, grad):
        pdata, pid, qpT, qr2, qnsT, n_valid = ctx.saved_tensors
        n_tiles = qpT.shape[1] // TILE_Q
        pid_cm, begin, end = chunk_major(pid, n_valid, ctx.n_chunks, n_tiles)
        dout = rowspan_S_bwd(pid_cm, begin, end, n_tiles, qpT, qr2, qnsT,
                             grad[:3].contiguous(), pdata)
        d_pdata = torch.zeros_like(pdata)
        d_pdata[:, 8:11] = dout[:, :3]
        return d_pdata, None, None, None, None, None, None, None, None


def _pack(z, y, x):
    return (z << 20) | (y << 10) | x


def _pad0(x: Tensor, n_pad: int) -> Tensor:
    """Append n_pad zero (False) rows along dim 0."""
    return torch.cat([x, torch.zeros((n_pad,) + tuple(x.shape[1:]),
                                     dtype=x.dtype, device=x.device)])


def rowspan_jobs(photons_p, photons_wi, photons_alpha, photons_valid,
                 cell_size, q_p, radius2, q_ns, chunk: int = ROWSPAN_CHUNK,
                 job_budget: int = 1 << 17, r_max: int = R_MAX,
                 rounds: int = 1) -> dict:
    """The prep of gather_radius_pallas_rowspan: sorted photon chunks, sorted
    query tiles and the capacity-cut tile-major job list, as a dict of
    tensors (the kernel's inputs plus what the caller needs to unsort and
    mask). Only the alpha rows of pdata carry autograd history: geometry,
    queries and radii go in detached, where JAX stop-gradients them."""
    photons_p, photons_wi, photons_valid, q_p, radius2, q_ns = (
        x.detach() for x in (photons_p, photons_wi, photons_valid, q_p,
                             radius2, q_ns))
    dev = q_p.device
    n, p = q_p.shape[0], photons_p.shape[0]
    cs = torch.as_tensor(cell_size, dtype=torch.float32, device=dev)
    big = 2 ** 30

    # ---- sort photons by linear cell key (invalid → sentinel, sorts last)
    pv = photons_valid
    cell = torch.floor(photons_p / cs).to(torch.int64)
    origin = torch.where(pv[:, None], cell, big).min(dim=0).values
    origin = torch.where(origin == big, 0, origin)  # no valid photons
    pcell = torch.clamp(cell - origin, 0, 1023)
    pkey = torch.where(pv, _pack(pcell[:, 2], pcell[:, 1], pcell[:, 0]),
                       _KEY_SENTINEL)
    order = torch.argsort(pkey, stable=True)
    pkey_s = pkey[order]
    zeros = lambda k: torch.zeros((p, k), dtype=torch.float32, device=dev)
    packed = torch.cat([photons_p, photons_wi, pv.to(torch.float32)[:, None],
                        zeros(1), photons_alpha, zeros(ROWS - 11)], dim=1)
    packed = _pad0(packed[order], -p % chunk)
    n_chunks = packed.shape[0] // chunk
    pdata = packed.T.reshape(ROWS, n_chunks, chunk).transpose(0, 1)

    # ---- Morton-sort queries into 128-query tiles
    live = radius2 > 0.0
    qcell = torch.clamp(torch.floor(q_p / cs).to(torch.int64) - origin,
                        0, 1023)
    qorder = torch.argsort(torch.where(live, morton3(qcell), 0xFFFFFFFF),
                           stable=True)
    n_pad = -n % TILE_Q
    qpT = _pad0(q_p[qorder], n_pad).T
    qnsT = _pad0(q_ns[qorder], n_pad).T
    r2_s = _pad0(radius2[qorder], n_pad)

    # ---- per-tile neighbourhood boxes over live queries, adaptive reach
    n_tiles = (n + n_pad) // TILE_Q
    qc_t = _pad0(qcell[qorder], n_pad).reshape(n_tiles, TILE_Q, 3)
    live_t = _pad0(live[qorder], n_pad).reshape(n_tiles, TILE_Q)
    r2_t = r2_s.reshape(n_tiles, TILE_Q).max(dim=1).values
    reach = torch.ceil(torch.sqrt(torch.clamp(r2_t, min=0.0)) / cs).to(
        torch.int64)[:, None]
    lt = live_t[..., None]
    blo = torch.clamp(torch.where(lt, qc_t, big).min(dim=1).values - reach,
                      0, 1023)
    bhi = torch.clamp(torch.where(lt, qc_t, -big).max(dim=1).values + reach,
                      0, 1023)
    any_live = live_t.any(dim=1)
    nz = bhi[:, 2] - blo[:, 2] + 1
    ny = bhi[:, 1] - blo[:, 1] + 1
    n_rows = nz * ny

    # rows r ∈ [0, r_max): one span per (z, y) box row if they fit, else
    # one per z-slab, else the whole box as one conservative span
    r_ids = torch.arange(r_max, device=dev)[None, :]
    fits_zy = (n_rows <= r_max)[:, None]
    fits_z = ~fits_zy & (nz <= r_max)[:, None]
    zr = blo[:, 2:3] + r_ids // ny[:, None]
    yr = blo[:, 1:2] + r_ids % ny[:, None]
    zs = blo[:, 2:3] + r_ids
    first_row = r_ids == 0
    klo = torch.where(fits_zy, _pack(zr, yr, blo[:, 0:1]), torch.where(
        fits_z, _pack(zs, blo[:, 1:2], blo[:, 0:1]), torch.where(
            first_row, _pack(blo[:, 2:3], blo[:, 1:2], blo[:, 0:1]), 0)))
    khi = torch.where(fits_zy, _pack(zr, yr, bhi[:, 0:1]) + 1, torch.where(
        fits_z, _pack(zs, bhi[:, 1:2], bhi[:, 0:1]) + 1, torch.where(
            first_row, _pack(bhi[:, 2:3], bhi[:, 1:2], bhi[:, 0:1]) + 1, 0)))
    valid_row = any_live[:, None] & torch.where(
        fits_zy, r_ids < n_rows[:, None],
        torch.where(fits_z, r_ids < nz[:, None], first_row))
    lo_e = torch.searchsorted(pkey_s, klo.reshape(-1)).reshape(n_tiles, r_max)
    hi_e = torch.searchsorted(pkey_s, khi.reshape(-1)).reshape(n_tiles, r_max)
    has = valid_row & (lo_e < hi_e)
    c_lo = torch.where(has, lo_e // chunk, 0)
    c_hi = torch.where(has, -(-hi_e // chunk), 0)  # exclusive

    # ---- job list by span-merge + run-expansion (a synthetic [0, 1) span
    # per tile keeps every tile visited, as in the JAX prep)
    n_spans = r_max + 1
    s_lo = torch.cat([torch.zeros((n_tiles, 1), dtype=torch.int64,
                                  device=dev), c_lo], dim=1)
    s_hi = torch.cat([torch.ones((n_tiles, 1), dtype=torch.int64,
                                 device=dev), c_hi], dim=1)
    s_lo, perm = torch.sort(s_lo, dim=1, stable=True)
    s_hi = torch.gather(s_hi, 1, perm)
    prev_hi = torch.cat([torch.zeros((n_tiles, 1), dtype=torch.int64,
                                     device=dev),
                         torch.cummax(s_hi, dim=1).values[:, :-1]], dim=1)
    clip_lo = torch.maximum(s_lo, prev_hi)
    lens = torch.clamp(s_hi - clip_lo, min=0).reshape(-1)
    offs = torch.cumsum(lens, 0)
    n_jobs = offs[-1]
    starts = offs - lens
    capacity = job_budget * rounds
    n_valid = torch.clamp(n_jobs, max=capacity)
    overflow = torch.clamp(n_jobs - capacity, min=0)
    flat_ids = torch.arange(n_tiles * n_spans, device=dev)
    marks = torch.zeros((capacity + 1,), dtype=torch.int64, device=dev)
    marks.scatter_reduce_(0, torch.where(lens > 0, starts, capacity).clamp(
        max=capacity), flat_ids + 1, reduce="amax")
    span_of_job = torch.clamp(torch.cummax(marks[:capacity], 0).values - 1,
                              0, n_tiles * n_spans - 1)
    pos_in_span = torch.arange(capacity, device=dev) - starts[span_of_job]
    chunk_of_job = torch.clamp(clip_lo.reshape(-1)[span_of_job] + pos_in_span,
                               max=n_chunks - 1)
    pid = (span_of_job // n_spans) * n_chunks + chunk_of_job
    spans = lambda x: x.reshape(n_tiles, n_spans)
    tile_begin = torch.clamp(spans(starts)[:, 0], max=n_valid)
    tile_end = torch.clamp(spans(offs)[:, -1], max=n_valid)

    # tiles before the last included job's tile were scanned completely; on
    # overflow that tile may be partial and later tiles were never visited
    tile_ids = torch.arange(n_tiles, device=dev)
    with metrics.sync("gather_last_tile"):  # a 0-dim index is read
        last_tile = pid[torch.clamp(n_valid, min=1) - 1] // n_chunks
    tile_ok = torch.where(overflow > 0, tile_ids < last_tile,
                          tile_ids <= last_tile)
    i32 = lambda x: x.to(torch.int32).contiguous()
    return dict(pid=i32(pid), tile_begin=i32(tile_begin),
                tile_end=i32(tile_end), n_chunks=n_chunks,
                qpT=qpT.contiguous(), qr2=r2_s.contiguous(),
                qnsT=qnsT.contiguous(), pdata=pdata.contiguous(),
                qorder=qorder, tile_ok=tile_ok, n_jobs=n_jobs,
                n_valid=n_valid, overflow=overflow)


def gather_radius_rowspan(photons_p, photons_alpha, photons_wi,
                          photons_valid, cell_size, q_p, radius2, q_ns,
                          q_kd_over_pi, chunk: int = ROWSPAN_CHUNK,
                          job_budget: int = 1 << 17, r_max: int = R_MAX,
                          rounds: int = 1):
    """Exact radius search + photon shading over the row-span job list →
    (L [N, 3], M [N] int32, overflow [] int64, covered [N] bool).

    radius2 = 0 disables a query. cell_size is a free tuning knob: tiles
    reach ceil(max_tile_radius / cell) cells, so results are exact for any
    cell size while overflow is 0. On overflow > 0 the queries of tiles not
    scanned completely return L = 0, M = 0 and covered = False.

    Differentiable in photons_alpha (through RowspanS, kernel K3) and in
    q_kd_over_pi (plain autograd: kd/π multiplies outside the kernel)."""
    n = q_p.shape[0]
    with metrics.span("rt.gather.jobs"):
        jobs = rowspan_jobs(photons_p, photons_wi, photons_alpha,
                            photons_valid, cell_size, q_p, radius2, q_ns,
                            chunk=chunk, job_budget=job_budget, r_max=r_max,
                            rounds=rounds)
    with metrics.span("rt.gather.kernel"):
        out = RowspanS.apply(jobs["pdata"], jobs["pid"], jobs["tile_begin"],
                             jobs["tile_end"], jobs["n_chunks"], jobs["qpT"],
                             jobs["qr2"], jobs["qnsT"], jobs["n_valid"])
    q_ok = torch.repeat_interleave(jobs["tile_ok"], TILE_Q)
    out = torch.where(q_ok[None, :], out, 0.0)
    unsort = torch.empty_like(jobs["qorder"])
    unsort[jobs["qorder"]] = torch.arange(n, device=q_p.device)
    S = out[:3, :n].T[unsort]
    m = out[3, :n][unsort].to(torch.int32)
    return q_kd_over_pi * S, m, jobs["overflow"], q_ok[:n][unsort]
