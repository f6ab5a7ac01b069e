"""The port's spans (utils/metrics.py `span` and `sync`) and the benchmark's
readers of them (benchmark/spans.py and the five metrics that read it).

On the CPU: with no profiler recording a frame records nothing; under
torch.profiler every span of a toy triangle_field frame appears and nests
as its layer says; the readers put hand-built gaps down to the right
layers, and count every wait of the frame. On the card (marker `card`,
skipped without one; run with
`python -m pytest tests/test_torch_tracing.py -m card --noconftest`): every
synchronizing operation CUDA flags in a 2^18-triangle frame happens inside
an `rt.sync` span, the flags equal the runtime's waits in the frame (what
`host_syncs.frame` counts) and, site by site, those in the sync spans, and
the spans lie on the clock of the card's records."""
from __future__ import annotations

import bisect
import collections
import traceback
import warnings

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from benchmark import program, spans, spec
from benchmark import trace as T
from benchmark.entries import render_photon as RP
from benchmark.tests.bench_util import shrink
from raytrace_tpu_torch.utils import metrics

FRAME_SPANS = {"rt.frame", "rt.frame.camera", "rt.frame.direct",
               "rt.frame.walk", "rt.frame.walk_step", "rt.frame.final"}
INTERSECT_SPANS = {"rt.intersect.cast", "rt.intersect.epoch",
                   "rt.intersect.cluster", "rt.intersect.reintersect"}
GATHER_SPANS = {"rt.gather", "rt.gather.jobs", "rt.gather.kernel"}
# each span → the spans one of which holds it
PARENTS = {"rt.frame.camera": {"rt.frame"}, "rt.frame.direct": {"rt.frame"},
           "rt.frame.walk": {"rt.frame"},
           "rt.frame.walk_step": {"rt.frame.walk"},
           "rt.frame.final": {"rt.frame"},
           "rt.intersect.cast": {"rt.frame.camera", "rt.frame.direct",
                                 "rt.frame.walk_step"},
           "rt.intersect.epoch": {"rt.intersect.cast"},
           "rt.intersect.cluster": {"rt.intersect.cast"},
           "rt.intersect.reintersect": {"rt.intersect.cast"},
           "rt.gather": {"rt.frame"}, "rt.gather.jobs": {"rt.gather"},
           "rt.gather.kernel": {"rt.gather"},
           # the frame's own host read, before its first launch
           "rt.sync.light_samples": {"rt.frame"}}
READERS = ("host_syncs.frame", "sync_idle_ms.frame",
           "intersect_idle_ms.frame", "gather_idle_ms.frame",
           "frame_idle_ms.frame")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: runs on the H100")
    return torch.device("cuda:0")


@pytest.fixture
def toy_call():
    """Frame i of the field4m cell at the benchmark's toy sizes (2,048
    triangles: both intersection engines and the row-span gather)."""
    torch.set_num_threads(2)
    cell = spec.load_cell("field4m.frame")
    shrink(cell)
    _, call, _, _ = RP.setup(cell, 2**31 + 11, torch.device("cpu"))
    return call


def host_spans(prof) -> list:
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith("rt.")
            and e.device_type == DeviceType.CPU]


def inside(child, parent) -> bool:
    return parent[1] <= child[1] and child[2] <= parent[2]


def test_no_profiler_records_nothing(toy_call, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a range was made with no profiler recording")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert metrics.span("rt.frame") is metrics.sync("walk_lanes")
    toy_call(0)


def test_spans_appear_and_nest(toy_call):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        toy_call(0)
    got = host_spans(prof)
    names = {n for n, _, _ in got}
    assert FRAME_SPANS | INTERSECT_SPANS | GATHER_SPANS <= names
    assert any(n.startswith("rt.sync.") for n in names)
    by = collections.defaultdict(list)
    for s in got:
        by[s[0]].append(s)
    for s in got:
        if s[0] in PARENTS:
            assert any(inside(s, p) for name in PARENTS[s[0]]
                       for p in by[name]), s
    # each epoch lies in a cast that lies in a pass of the frame
    casts = [c for c in by["rt.intersect.cast"]
             if any(inside(c, f) for n in FRAME_SPANS - {"rt.frame"}
                    for f in by[n])]
    assert all(any(inside(e, c) for c in casts)
               for e in by["rt.intersect.epoch"])


def hand_trace(host, device, gap_source=None, units=1):
    return T.Trace(device=device, host=host, window_s=1.0, units=units,
                   counters=T.Counters(), gap_source=gap_source)


# device operations (µs) with three gaps: 10-20 (under a sync in an
# epoch), 50-60 (under a walk step alone), 110-130 (under no span); the
# profiler may put a span's range on the card's timeline too: not an
# operation. Two waits in the frame: one in the sync span, one in no sync
# span
DEVICE = [("k", 0, 10), ("k", 20, 50), ("k", 60, 110), ("k", 130, 140),
          ("rt.frame", 0, 100)]
HOST = [("rt.frame", 0, 100), ("rt.frame.walk_step", 1, 90),
        ("rt.intersect.cast", 2, 50), ("rt.intersect.epoch", 3, 40),
        ("rt.sync.epoch_pairs", 9, 19), ("cudaLaunchKernel", 8, 12),
        ("cudaStreamSynchronize", 10, 18), ("cudaStreamSynchronize", 60, 61)]


def read(name, tr):
    return spec.load_module("metrics", name).read(tr)


def test_readers_put_gaps_down_to_layers():
    tr = hand_trace(HOST, DEVICE)
    a = spans.attribute(tr)
    assert a["total"] == 10 + 10 + 20
    assert a["intersect"] == 10 and a["sync"] == 10
    assert a["frame"] == 10 and a["none"] == 20 and a["gather"] == 0
    assert (a["frame"] + a["intersect"] + a["gather"] + a["none"]
            == a["total"])
    assert read("intersect_idle_ms.frame", tr) == pytest.approx(0.010)
    assert read("sync_idle_ms.frame", tr) == pytest.approx(0.010)
    assert read("frame_idle_ms.frame", tr) == pytest.approx(0.010)
    assert read("gather_idle_ms.frame", tr) == 0.0
    assert read("host_syncs.frame", tr) == 2.0


@pytest.mark.parametrize("units", [1, 4])
def test_readers_per_frame_and_gather(units):
    host = [("rt.frame", 0, 200), ("rt.gather", 5, 150),
            ("rt.gather.kernel", 5, 30), ("rt.sync.gather_overflow", 40, 70),
            ("cudaStreamSynchronize", 41, 50),
            ("cudaStreamSynchronize", 55, 66)]
    device = [("k", 0, 10), ("k", 30, 45), ("k", 60, 80), ("k", 160, 170)]
    tr = hand_trace(host, device, units=units)
    # gaps 10-30 (in the kernel's span), 45-60 (in the sync) and 80-160:
    # each opens inside rt.gather, and counts whole where it opens
    assert read("gather_idle_ms.frame", tr) == pytest.approx(
        (20 + 15 + 80) / 1e3 / units)
    assert read("sync_idle_ms.frame", tr) == pytest.approx(15 / 1e3 / units)
    assert read("host_syncs.frame", tr) == 2 / units
    # of two spans that open at once the one that closes first is inner
    a = spans.attribute(hand_trace(
        [("rt.gather", 0, 100), ("rt.gather.kernel", 0, 20),
         ("rt.intersect.cast", 0, 15)], [("k", 0, 5), ("k", 8, 9)]))
    assert a["intersect"] == 3 and a["gather"] == 0


def test_readers_without_spans_read_nothing():
    plain = hand_trace([("cudaLaunchKernel", 8, 12)], DEVICE)
    for name in READERS:
        assert read(name, plain) is None
    # the window traced on the card alone: its gaps named by the frame
    # traced with host events
    named = hand_trace(HOST, DEVICE)
    tr = hand_trace([("cudaLaunchKernel", 8, 12)], DEVICE * 3,
                    gap_source=named, units=3)
    assert spans.source(tr) is named
    assert read("intersect_idle_ms.frame", tr) == pytest.approx(0.010)
    # host spans but no device operation (a CPU run): no idle to read
    cpu = hand_trace(HOST, [])
    assert read("host_syncs.frame", cpu) == 2.0
    assert read("sync_idle_ms.frame", cpu) is None


def test_device_counter_only_while_a_profiler_records():
    """metrics.device_counter: made zero at its first call with no profiler
    recording (so its zeroing falls outside any traced window) and None
    then; the same tensor while a profiler records."""
    dev = torch.device("cpu")
    key = ("test_counter", dev)
    metrics.DEVICE_COUNTERS.pop(key, None)
    try:
        assert metrics.device_counter("test_counter", dev) is None
        buf = metrics.DEVICE_COUNTERS[key]
        assert torch.equal(buf, torch.zeros(2, dtype=torch.int64))
        with profile(activities=[ProfilerActivity.CPU]):
            assert metrics.device_counter("test_counter", dev) is buf
        assert metrics.device_counter("test_counter", dev) is None
    finally:
        metrics.DEVICE_COUNTERS.pop(key, None)


def test_cull_tested_share_reads_the_counter(monkeypatch):
    """`cull_tested_share.frame`: the tests K8 ran ÷ those asked, over every
    device's `cull_tests` counter, in %; None without a K8 launch or
    without the counter (the parent's program)."""
    tr = hand_trace(HOST, DEVICE)
    monkeypatch.setattr(metrics, "DEVICE_COUNTERS", {})
    assert read("cull_tested_share.frame", tr) is None
    monkeypatch.setattr(metrics, "DEVICE_COUNTERS", {
        ("cull_tests", "a"): torch.tensor([30, 400]),
        ("cull_tests", "b"): torch.tensor([10, 100]),
        ("other", "a"): torch.tensor([7, 7])})
    assert read("cull_tested_share.frame", tr) == pytest.approx(8.0)
    monkeypatch.delattr(metrics, "DEVICE_COUNTERS")
    assert read("cull_tested_share.frame", tr) is None


def test_host_syncs_counts_every_wait_of_the_frame():
    """A wait counts whether or not a sync span names its site, and only
    inside the frame: the harness's own waits between frames do not."""
    host = [("rt.frame", 0, 100), ("rt.frame", 200, 300),
            ("rt.sync.walk_lanes", 10, 20), ("cudaStreamSynchronize", 11, 19),
            ("cudaStreamSynchronize", 50, 52),
            ("cudaDeviceSynchronize", 100, 110),
            ("cudaEventSynchronize", 250, 251), ("cudaMemcpyAsync", 260, 261)]
    tr = hand_trace(host, [("k", 0, 300)], units=2)
    assert spans.attribute(tr)["syncs"] == 3
    assert read("host_syncs.frame", tr) == 1.5
    # one more annotation does not move the count
    tr = hand_trace(host + [("rt.sync.extra", 49, 53)], [("k", 0, 300)],
                    units=2)
    assert read("host_syncs.frame", tr) == 1.5


@pytest.mark.card
def test_every_flagged_sync_is_in_a_sync_span(card):
    from raytrace_tpu_torch.core import prng
    from raytrace_tpu_torch.renderers import photon
    from raytrace_tpu_torch.scene import presets

    render = dict(spec.load_cell("field4m.frame").config["render"],
                  width=256, height=256, photon_paths=1 << 18)
    rcfg = program.render_config(render)
    scene, cam = presets.triangle_field(card, 1 << 18, 256)
    photon.render_photon(scene, cam, rcfg, prng.PRNGKey(1, card))  # builds
    key = prng.PRNGKey(2, card)
    torch.cuda.synchronize()
    flagged = []  # where the code was at each flag, in order
    MARK = "test.flagged_sync"

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            # a range of its own on the profiler's host timeline, which
            # the spans open at the flag hold
            with torch.profiler.record_function(MARK):
                pass
            flagged.append([f"{f.filename.split('/')[-1]}:{f.lineno}:{f.name}"
                            for f in traceback.extract_stack()[-8:-1]])

    old = warnings.showwarning
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    img, aux = photon.render_photon(scene, cam, rcfg, key,
                                                    return_aux=True)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
        finally:
            warnings.showwarning = old
    assert int(aux["pair_overflow"]) == 0 and bool(torch.isfinite(img).all())
    syncs = [s for s in host_spans(prof) if s[0].startswith("rt.sync.")]
    marks = sorted(e.time_range.start for e in prof.events()
                   if e.name == MARK and e.device_type == DeviceType.CPU)
    assert len(marks) == len(flagged)

    def site(s, e):
        """The innermost sync span holding [s, e], or None."""
        held = [x for x in syncs if x[1] <= s and e <= x[2]]
        return max(held, key=lambda x: x[1])[0] if held else None

    at_flag = [site(m, m) for m in marks]
    outside = collections.Counter(
        f"{n or '(none)'} {' <- '.join(at)}"
        for n, at in zip(at_flag, flagged) if n is None)
    assert not outside, outside
    # host_syncs: the runtime's waits in the frame, as many as CUDA flagged
    # and, site by site, those in the sync spans (bincount waits twice, for
    # its input's min and max; an operation on an empty input may not wait)
    tr = T.collect(prof, 1.0, 1, T.Counters())
    assert len(flagged) == spans.attribute(tr)["syncs"] > 0
    waits = collections.Counter(site(s, e) for n, s, e in tr.host
                                if n in spans.WAITS and site(s, e))
    assert waits == collections.Counter(at_flag)
    # the clock: a sync ends no earlier than 20 µs before the end of the
    # last device operation that started before it began
    dev = sorted((e.time_range.start, e.time_range.end)
                 for e in prof.events() if e.device_type == DeviceType.CUDA
                 and not e.name.startswith("rt."))
    assert dev
    starts = [s for s, _ in dev]
    slack = []
    for name, s, e in syncs:
        k = bisect.bisect_left(starts, s)
        if k:
            slack.append(e - dev[k - 1][1])
            assert slack[-1] >= -20, (name, s, e, dev[k - 1])
    print(f"flagged {len(flagged)} in {len(syncs)} sync spans, by site "
          f"{dict(waits)}; span end - device end: min {min(slack):.1f} µs")
