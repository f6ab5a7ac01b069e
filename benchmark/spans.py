"""The program's own spans in a traced window (raytrace_tpu_torch's
utils/metrics.py `span` and `sync`, host ranges named `rt.*` that exist
only while a profiler records): each idle gap of the card put down to the
spans open on the host when the gap opened, and the host's waits for the
card counted inside the `rt.frame` span, whether or not a `rt.sync.*` span
names their site. A program without such spans leaves nothing to read, and
the readers return None."""
from __future__ import annotations

PREFIX = "rt."
SYNC = "rt.sync."
FRAME = "rt.frame"
# the CUDA runtime calls in which the host waits for the card: every
# synchronizing operation of PyTorch ends in one (the profiler records them
# among the host's events when it traces the card)
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")
# a non-sync span's layer, by the prefix of its name
LAYERS = (("intersect", "rt.intersect"), ("gather", "rt.gather"),
          ("frame", "rt.frame"))


def source(tr):
    """The trace whose host events hold the spans: the window's own where
    it recorded host events with spans in them, else the frame traced
    with host events that names the gaps (trace.Trace.gap_source) → the
    Trace, or None where neither holds a span."""
    for t in (tr, tr.gap_source):
        if t is not None and any(n.startswith(PREFIX) for n, _, _ in t.host):
            return t
    return None


def layer(name: str):
    """The layer of a non-sync span, or None."""
    for key, prefix in LAYERS:
        if name == prefix or name.startswith(prefix + "."):
            return key
    return None


def gaps(src) -> list:
    """(start µs, length µs) of each idle stretch between the card's
    operations, as trace.Trace.gaps, leaving out the spans' own ranges
    that the profiler may also place on the card's timeline."""
    out, reach = [], None
    for s, e in sorted((s, e) for n, s, e in src.device
                       if not n.startswith(PREFIX)):
        if reach is not None and s > reach:
            out.append((reach, s - reach))
        reach = e if reach is None else max(reach, e)
    return out


def waits(src, spans) -> int:
    """The host's waits for the card inside the rt.frame spans: every one
    the runtime recorded, so that a sync the program does not annotate
    still counts."""
    frames = [(s, e) for s, e, n in spans if n == FRAME]
    return sum(1 for n, s, e in src.host if n in WAITS
               and any(a <= s and e <= b for a, b in frames))


def attribute(tr):
    """Idle µs of the host-traced frames by what the host was in when each
    gap opened → dict of frame, intersect and gather (the innermost open
    span that is not a sync, by layer), none (no rt.* span open, or one of
    no layer), sync (an rt.sync.* span open; these gaps count in a layer
    too), total (every gap), syncs (the host's waits inside rt.frame: an
    operation may wait twice, or not at all on an empty input) and units
    (frames);
    None where no trace holds a span."""
    src = source(tr)
    if src is None:
        return None
    spans = sorted((s, e, n) for n, s, e in src.host if n.startswith(PREFIX))
    out = dict(frame=0.0, intersect=0.0, gather=0.0, none=0.0, sync=0.0,
               total=0.0, units=src.units,
               syncs=waits(src, spans))
    live, i = [], 0
    for start, length in gaps(src):
        while i < len(spans) and spans[i][0] <= start:
            live.append(spans[i])
            i += 1
        live = [x for x in live if x[1] > start]
        out["total"] += length
        if any(n.startswith(SYNC) for _, _, n in live):
            out["sync"] += length
        named = [x for x in live if not x[2].startswith(SYNC)]
        # the innermost: the latest to open (of two that opened at once,
        # the one that closes first)
        inner = (max(named, key=lambda x: (x[0], -x[1]))[2] if named
                 else None)
        out[(inner and layer(inner)) or "none"] += length
    return out


def idle_ms(tr, key: str):
    """ms a frame of idle put down to `key` (a key of `attribute`), or
    None where no span or no device operation was recorded."""
    a = attribute(tr)
    src = source(tr)
    if a is None or not src.device:
        return None
    return a[key] / 1e3 / a["units"]
