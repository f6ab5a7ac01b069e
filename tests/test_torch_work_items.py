"""Work items (raytrace_tpu_torch/ops/work_items.py): the range split that
kernels K2, K3 and K7 run one block per item of, and K2's and K3's rule for
adding the items back together, on the CPU through the plain versions.
K7's rule (the smaller t, at equal t the lower index) is held in
tests/test_torch_cluster.py `test_pair_hits_plain_folds_pairs_in_any_grouping`.
The headline frame's job list, whose chunk 0 holds one job per query tile
and whose tiles' job ranges are far from even, is what made the split
necessary; a 256×256 frame with 2^16 paths shows the same shape. Also the
rewrite by which utils/sweep.py rebuilds the kernels at other sizes."""
import re

import numpy as np
import pytest
import torch

from tests.torch_port_util import t
from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.core.config import RenderConfig
from raytrace_tpu_torch.ops import cuda_lib
from raytrace_tpu_torch.ops import rowspan_gather as rg
from raytrace_tpu_torch.ops.work_items import work_items
from raytrace_tpu_torch.renderers import common, photon
from raytrace_tpu_torch.scene import presets
from raytrace_tpu_torch.scene.camera import generate_rays, pixel_samples
from raytrace_tpu_torch.utils import sweep

K3_ULP = 2.0 ** -24
K2_ULP = 2.0 ** -24

# (begin, end) per owner, item size: uneven ranges with empty ones between
# and at both ends; ranges of exactly one and several whole items; an owner
# whose range is inverted (end < begin, empty); one owner; no owner
RANGES = {
    "uneven": ([0, 0, 3, 3, 40, 41], [0, 3, 3, 40, 41, 41], 4),
    "whole_items": ([0, 8, 24], [8, 24, 24], 8),
    "size_one": ([0, 2, 2], [2, 2, 7], 1),
    "larger_than_all": ([5, 9], [9, 30], 64),
    "inverted": ([0, 6, 4], [6, 4, 9], 2),
    "one_owner": ([3], [100], 7),
    "no_owner": ([], [], 3),
}


@pytest.mark.parametrize("name", list(RANGES))
def test_work_items_cover_each_range_in_order(name):
    """Every index of each range falls in exactly one item of its owner, the
    items in owner order and in index order within an owner; no item is
    longer than the size or empty; an empty range has no item; the slots
    past the items are owner −1 with an empty range; and n_owners + total
    // size slots always hold every item."""
    begin, end, size = RANGES[name]
    b = torch.tensor(begin, dtype=torch.int32)
    e = torch.tensor(end, dtype=torch.int32)
    total = int(torch.clamp(e - b, min=0).sum())
    slots = len(begin) + total // size
    owner, lo, hi, first, count = (x.tolist() for x in
                                   work_items(b, e, size, slots + 3))
    n_items = sum(count)
    assert n_items <= slots
    assert owner[n_items:] == [-1] * (slots + 3 - n_items)
    assert lo[n_items:] == hi[n_items:] == [0] * (slots + 3 - n_items)
    assert owner[:n_items] == sorted(owner[:n_items])
    for o, (b0, e0) in enumerate(zip(begin, end)):
        mine = range(first[o], first[o] + count[o])
        assert [k for k in range(n_items) if owner[k] == o] == list(mine)
        covered = [j for k in mine for j in range(lo[k], hi[k])]
        assert covered == list(range(b0, max(b0, e0)))
        assert all(0 < hi[k] - lo[k] <= size for k in mine)
        assert (count[o] == 0) == (e0 <= b0)


def _headline_jobs(size=256, paths=1 << 16):
    """The gather job list of a size×size headline-shaped frame (the glass
    Cornell box at bench.py's settings, fewer paths) on the CPU, as
    chip_smoke.py builds the full-size one."""
    cfg = RenderConfig(width=size, height=size, spp=1, scene_epsilon=1e-3,
                       photon_paths=paths, max_photon_bounces=8,
                       footprint_radius_scale=8.0)
    scene, cam = presets.cornell_box("cpu", size, ball="glass")
    keys = prng.split(prng.PRNGKey(0, "cpu"), 3)
    xy, lens = pixel_samples(keys[0], size, size, 1)
    rays = generate_rays(cam, xy, lens, 1)
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


@pytest.fixture(scope="module")
def headline():
    jobs = _headline_jobs()
    n_tiles = jobs["tile_begin"].shape[0]
    pid, begin, end = rg.chunk_major(jobs["pid"], jobs["n_valid"],
                                     jobs["n_chunks"], n_tiles)
    return jobs, pid, begin, end


@pytest.fixture(scope="module")
def k3_whole(headline):
    """K3's inputs with a nonnegative cotangent, and the plain version over
    the whole chunk ranges."""
    jobs, pid, begin, end = headline
    rng = np.random.default_rng(11)
    cotT = t(rng.random(jobs["qpT"].shape).astype(np.float32))
    geo = (jobs["tile_begin"].shape[0], jobs["qpT"], jobs["qr2"],
           jobs["qnsT"], cotT, jobs["pdata"])
    return geo, rg.rowspan_S_bwd_plain(pid, begin, end, *geo)


@pytest.fixture(scope="module")
def k2_whole(headline):
    """K2's inputs and the plain version over the whole tile ranges."""
    jobs = headline[0]
    geo = (jobs["n_chunks"], jobs["qpT"], jobs["qr2"], jobs["qnsT"],
           jobs["pdata"])
    return geo, rg.rowspan_S_plain(jobs["pid"], jobs["tile_begin"],
                                   jobs["tile_end"], *geo)


def test_chunk_zero_holds_one_job_per_query_tile(headline):
    """The prep's synthetic [0, 1) span gives every query tile one job on
    chunk 0, so chunk 0's range is as long as there are tiles — the
    heaviest range of the list, which one block per chunk walked alone."""
    jobs, pid, begin, end = headline
    n_tiles, nc = jobs["tile_begin"].shape[0], jobs["n_chunks"]
    assert int(jobs["overflow"]) == 0
    lengths = (end - begin).long()
    assert int(lengths[0]) == n_tiles > 1
    tiles = pid[begin[0]:end[0]].long() // nc
    assert torch.equal(tiles, torch.arange(n_tiles))
    assert int(lengths[0]) == int(lengths.max())
    assert int(lengths[1:].max()) < n_tiles


@pytest.mark.parametrize("size", [1, 3, 5])
def test_k3_items_summed_in_order_equal_the_whole(headline, k3_whole, size):
    """rowspan_S_bwd_plain over each chunk's work items, the partials added
    in item order (K3's fixed-order sum), equals the plain version over the
    whole ranges: term counts exactly, dα within 2·2^-24·terms·|dα| (phase
    k3's bound, for a nonnegative cotangent); chunks without jobs are
    exactly 0."""
    _, pid, begin, end = headline
    geo, whole = k3_whole
    slots = begin.shape[0] + pid.shape[0] // size
    _, lo, hi, first, count = work_items(begin, end, size, slots)
    assert int(count.max()) > 1
    summed = torch.zeros_like(whole)
    for m in range(int(count.max())):  # the m-th item of every chunk
        has = count > m
        k = torch.where(has, first + m, 0).long()
        b_m = torch.where(has, lo[k], 0).to(torch.int32)
        e_m = torch.where(has, hi[k], 0).to(torch.int32)
        summed += rg.rowspan_S_bwd_plain(pid, b_m, e_m, *geo)
    terms = whole[:, 3:4]
    assert torch.equal(summed[:, 3], whole[:, 3]) and float(terms.sum()) > 0
    delta = (summed[:, :3] - whole[:, :3]).abs()
    assert bool((delta <= 2.0 * K3_ULP * terms * whole[:, :3]).all())
    assert not summed[begin == end].any()


def _define(name: str, define: str) -> int:
    """The value of `#define <define>` in csrc/<name>.cu."""
    source = (cuda_lib.SRC_DIR / f"{name}.cu").read_text()
    return int(re.search(rf"^#define {define} (\d+)", source, re.M).group(1))


def test_tile_job_ranges_are_uneven(headline):
    """K2's ranges: the tiles' job counts are far from even — the heaviest
    tile holds many times the mean and crosses several of K2's work items,
    so one block per tile would wait on it alone — while every tile holds
    at least its chunk-0 job."""
    jobs = headline[0]
    lengths = (jobs["tile_end"] - jobs["tile_begin"]).long()
    assert int(jobs["overflow"]) == 0 and int(lengths.min()) >= 1
    mean = float(lengths.float().mean())
    assert int(lengths.max()) >= 8 * mean
    item_jobs = _define("rowspan_gather", "ITEM_JOBS")
    assert -(-int(lengths.max()) // item_jobs) >= 3


@pytest.mark.parametrize("size", [1, 3, 5])
def test_k2_items_summed_in_order_equal_the_whole(headline, k2_whole, size):
    """rowspan_S_plain over each tile's work items, the partials added in
    item order (K2's fixed-order sum), equals the plain version over the
    whole ranges: counts M exactly, the flux S within 2·M·2^-24·S (phase
    k2's bound)."""
    jobs = headline[0]
    pid, begin, end = jobs["pid"], jobs["tile_begin"], jobs["tile_end"]
    geo, whole = k2_whole
    slots = begin.shape[0] + pid.shape[0] // size
    _, lo, hi, first, count = work_items(begin, end, size, slots)
    assert int(count.max()) > 1
    summed = torch.zeros_like(whole)
    for m in range(int(count.max())):  # the m-th item of every tile
        has = count > m
        k = torch.where(has, first + m, 0).long()
        b_m = torch.where(has, lo[k], 0).to(torch.int32)
        e_m = torch.where(has, hi[k], 0).to(torch.int32)
        summed += rg.rowspan_S_plain(pid, b_m, e_m, *geo)
    m_count = whole[3]
    assert torch.equal(summed[3], m_count) and float(m_count.sum()) > 0
    delta = (summed[:3] - whole[:3]).abs()
    assert bool((delta <= 2.0 * K2_ULP * m_count * whole[:3].abs()).all())


@pytest.mark.parametrize("name, define", [
    ("rowspan_gather", "ITEM_JOBS"), ("rowspan_gather_bwd", "ITEM_JOBS"),
    ("cluster_pair", "ITEM_PAIRS"), ("grid_gather", "ITEM_CHUNKS")])
def test_sweep_rewrites_the_one_work_item_constant(name, define):
    """utils/sweep.py rebuilds K2, K3, K5 and K7 with other work-item sizes
    by rewriting one `#define` line of the source, and nothing else."""
    source = (cuda_lib.SRC_DIR / f"{name}.cu").read_text()
    text = sweep.with_define(source, define, 1 << 30)
    assert f"#define {define} {1 << 30}\n" in text
    changed = [(a, b) for a, b in zip(source.splitlines(), text.splitlines())
               if a != b]
    assert len(changed) == 1 and len(text.splitlines()) == len(
        source.splitlines())
    with pytest.raises(ValueError, match="0 lines #define NOT_THERE"):
        sweep.with_define(source, "NOT_THERE", 1)
