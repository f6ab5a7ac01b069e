"""The exact pre-cull of K5 (ops/grid_gather.py `precull_plain` and
`chunk_boxes`, which csrc/grid_gather.cu evaluates per warp before its pair
tests), on the CPU.

Each warp (32 consecutive queries of a 128-query tile) skips the chunks of
its tile's span whose valid-photon box it cannot reach and tests only the
photons whose gap to the box of its queries with r² > 0 is under their
largest r². A photon it drops must count for no query of the warp, whatever
the input: photons one ulp inside and outside a warp's reach, dist² exactly
r², NaN photon and query positions, NaN and zero r², invalid photons, a
query count that is not a multiple of 32, one large radius among small
ones (tests/test_torch_dense_precull.py's cases), a span straddling a
Morton octant boundary, an empty chunk inside a span and a tile with an
empty span. With the cull applied, `grid_S_plain` gives the same output
bit for bit. The spans are cut into K5's work items (`work_items`): tiles
heavier than J chunks, empty spans, items in order. chip_smoke.py holds
the kernel on these inputs (`inputs`, rows k5_adversarial).
"""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from raytrace_tpu_torch.ops import cuda_lib
from raytrace_tpu_torch.ops import grid_gather as gg
from raytrace_tpu_torch.ops.work_items import work_items

# K4's cases, loaded from the file beside this one (chip_smoke.py loads
# this file by its path, where another package may own the name `tests`)
_spec = importlib.util.spec_from_file_location(
    "k4_precull_cases",
    Path(__file__).with_name("test_torch_dense_precull.py"))
_k4 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_k4)
K4_CASES, k4_case, _counted = _k4.CASES, _k4._case, _k4._counted

F32 = np.float32
CHUNK = 32  # photons a chunk: spans of several chunks and work items
CASES = K4_CASES + ["octant_straddle", "empty_chunk", "empty_span"]


def _patch(rng, n, p):
    """n queries in a small patch with radii of a few pixels and p photons
    around it."""
    q = rng.uniform(-0.2, 0.2, (n, 3)).astype(F32)
    r2 = rng.uniform(0.0, 0.01, n).astype(F32)
    ph = rng.uniform(-0.5, 0.5, (p, 3)).astype(F32)
    return q, r2, ph, rng.random(p) < 0.9


def _pack(q, r2, ns, p, alpha, wi, valid):
    """K5's arguments with the queries in order in 128-query tiles (padding
    r² = 0) and the photons in order in chunks of CHUNK (padding invalid),
    every tile spanning every chunk."""
    n, n_p = len(q), len(p)
    nq, pp = -(-n // gg.TILE_Q) * gg.TILE_Q, -(-n_p // CHUNK) * CHUNK
    pad = lambda x, m: np.concatenate(
        [x, np.zeros((m - len(x),) + x.shape[1:], F32)]).astype(F32)
    rows = np.concatenate([pad(p, pp), pad(wi, pp),
                           pad(valid.astype(F32)[:, None], pp),
                           pad(alpha, pp)], axis=1)  # [pp, 10]
    pdata = rows.reshape(pp // CHUNK, CHUNK, 10).transpose(0, 2, 1)
    n_tiles, n_chunks = nq // gg.TILE_Q, pp // CHUNK
    i32 = lambda x: np.asarray(x, np.int32)
    return (i32(np.zeros(n_tiles)), i32(np.full(n_tiles, n_chunks)),
            pad(q, nq).T, pad(r2, nq), pad(ns, nq).T, pdata)


def _octant_straddle(rng):
    """Queries around the point where the first Morton bit of each axis
    flips (cell 8 of 16 at cell size 0.1), photons all over: grid_spans
    gives the tiles there spans of many chunks, most of them far away."""
    p = rng.uniform(0.0, 1.6, (1500, 3)).astype(F32)
    q = (F32(0.8) + rng.uniform(-0.12, 0.12, (256, 3))).astype(F32)
    r2 = rng.uniform(0.0, 0.01, 256).astype(F32)
    return q, r2, p, rng.random(len(p)) < 0.95


def inputs(name, device="cpu") -> tuple:
    """K5's arguments (lo_chunk, nc, qpT, qr2, qnsT, pdata) of one case,
    with normals and photon powers drawn from a seed."""
    rng = np.random.default_rng(200 + CASES.index(name))
    if name in K4_CASES:
        q, r2, p, valid = k4_case(name)
    elif name == "octant_straddle":
        q, r2, p, valid = _octant_straddle(rng)
    else:
        q, r2, p, valid = _patch(rng, 300, 600)
    ns = rng.standard_normal(q.shape).astype(F32)
    alpha = rng.uniform(0, 2, p.shape).astype(F32)
    wi = rng.standard_normal(p.shape).astype(F32)
    T = torch.from_numpy
    if name == "octant_straddle":
        sp = gg.grid_spans(T(p), T(alpha), T(wi), T(valid), 0.1, T(q),
                           T(r2), T(ns), chunk=CHUNK)
        args = [sp[k] for k in ("lo_chunk", "nc", "qpT", "qr2", "qnsT",
                                "pdata")]
    else:
        args = [T(np.ascontiguousarray(x)) for x in
                _pack(q, r2, ns, p, alpha, wi, valid)]
        if name == "empty_chunk":  # chunk 3: no valid photon
            args[5][3, 6] = 0.0
        elif name == "empty_span":
            args[1][1] = 0
    return tuple(a.to(device) for a in args)


def _item_chunks() -> int:
    """J, `#define ITEM_CHUNKS` in csrc/grid_gather.cu."""
    source = (cuda_lib.SRC_DIR / "grid_gather.cu").read_text()
    return int(re.search(r"^#define ITEM_CHUNKS (\d+)", source,
                         re.M).group(1))


@pytest.mark.parametrize("name", CASES)
def test_precull_never_drops_a_pair_that_counts(name):
    lo, nc, qpT, qr2, _, pdata = inputs(name)
    cull = gg.precull_plain(lo, nc, qpT, qr2, pdata)
    jobs = cull["tile"].shape[0]
    assert jobs == int(nc.sum())
    assert cull["keep"].shape == (jobs, gg.WARPS, pdata.shape[2])
    # a warp keeps no photon of a chunk it does not reach
    assert not (cull["keep"].any(2) & ~cull["reach"]).any()
    q, r2 = qpT.T.numpy(), qr2.numpy()
    kept_pairs = total_pairs = 0
    for j in range(jobs):
        t, c = int(cull["tile"][j]), int(cull["chunk"][j])
        qs = slice(t * gg.TILE_Q, (t + 1) * gg.TILE_Q)
        ph = pdata[c].numpy()
        counted = _counted(q[qs], r2[qs], ph[:3].T, ph[6] > 0)
        kept = cull["keep"][j].numpy().repeat(gg.GROUP, 0)
        assert not (counted & ~kept).any(), (t, c)
        kept_pairs += int(kept.sum())
        total_pairs += kept.size
    assert total_pairs > 0
    if name in ("octant_straddle", "random", "empty_chunk", "empty_span"):
        assert kept_pairs / total_pairs < 0.5  # the cull drops most pairs
    if name == "empty_chunk":
        assert not cull["reach"][cull["chunk"] == 3].any()


@pytest.mark.parametrize("name", CASES)
def test_plain_version_with_the_cull_equals_it_without(name):
    """Each warp with its photons past the cull only (the others marked
    invalid) gives the same sums as with all of them, bit for bit."""
    lo, nc, qpT, qr2, qnsT, pdata = inputs(name)
    cull = gg.precull_plain(lo, nc, qpT, qr2, pdata)
    bits = lambda x: x.view(torch.int32)
    counted = 0.0
    for t in range(lo.shape[0]):
        qs = slice(t * gg.TILE_Q, (t + 1) * gg.TILE_Q)
        tile = (lo[t:t + 1], nc[t:t + 1], qpT[:, qs].contiguous(), qr2[qs],
                qnsT[:, qs].contiguous())
        full = gg.grid_S_plain(*tile, pdata)
        counted += float(full[3].sum())
        mine = cull["tile"] == t
        for w in range(gg.WARPS):
            culled = pdata.clone()
            for c, keep in zip(cull["chunk"][mine].tolist(),
                               cull["keep"][mine, w]):
                culled[c, 6] = torch.where(keep, culled[c, 6], 0.0)
            ws = slice(w * gg.GROUP, (w + 1) * gg.GROUP)
            got = gg.grid_S_plain(*tile, culled)
            assert torch.equal(bits(got[:, ws]), bits(full[:, ws])), (t, w)
    assert counted > 0
    if name == "empty_span":
        assert not gg.grid_S_plain(lo, nc, qpT, qr2, qnsT, pdata)[
            :, gg.TILE_Q:2 * gg.TILE_Q].any()


def test_chunk_boxes():
    """A chunk's box spans its valid photons only; a NaN coordinate makes
    its axis NaN; a chunk without a valid photon is inverted."""
    pdata = torch.zeros((3, 10, 4))
    pdata[:, :3] = torch.arange(12.0).view(1, 3, 4) - 5.0
    pdata[0, 6] = torch.tensor([1.0, 0.0, 1.0, 0.0])
    pdata[1, 6] = 1.0
    pdata[1, 1, 2] = float("nan")
    box = gg.chunk_boxes(pdata)
    assert box[0].tolist() == [-5.0, -1.0, 3.0, -3.0, 1.0, 5.0]
    assert torch.isnan(box[1, [1, 4]]).all()
    assert box[1, [0, 2, 3, 5]].tolist() == [-5.0, 3.0, -2.0, 6.0]
    inf = float("inf")
    assert box[2].tolist() == [inf] * 3 + [-inf] * 3


@pytest.mark.parametrize("name", ["octant_straddle", "random",
                                  "empty_span"])
def test_work_items_cut_k5_spans(name):
    """K5's spans cut into items of at most J chunks: the tiles heavier
    than J chunks get several, a tile with an empty span none, each
    tile's items cover its span in chunk order, and n_tiles + Σ nc // J
    slots (the wrapper's grid) hold them all."""
    lo, nc = inputs(name)[:2]
    size = _item_chunks()
    slots = lo.shape[0] + int(nc.sum()) // size
    owner, ilo, ihi, first, count = (
        x.tolist() for x in work_items(lo, lo + nc, size, slots))
    assert sum(count) <= slots
    assert max(nc.tolist()) > size and max(count) > 1
    for t in range(lo.shape[0]):
        mine = range(first[t], first[t] + count[t])
        assert all(owner[k] == t for k in mine)
        covered = [c for k in mine for c in range(ilo[k], ihi[k])]
        assert covered == list(range(int(lo[t]), int(lo[t] + nc[t])))
        assert all(0 < ihi[k] - ilo[k] <= size for k in mine)
    if name == "empty_span":
        assert count[1] == 0
