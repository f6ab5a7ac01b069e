"""The traced window: torch.profiler over the cell's traced frames, with
counters taken at the program's layer boundaries (the ray casts and the
gathers), reduced to device intervals, busy time, kernel times by layer,
the heaviest device operations and the longest idle gaps."""
from __future__ import annotations

import contextlib
import dataclasses
import inspect

# the hand-written kernels by layer: their symbol names in
# raytrace_tpu_torch/csrc/*.cu
INTERSECT_KERNELS = ("tri_closest_kernel", "cluster_cull_kernel",
                     "cluster_cull_wide_kernel", "cluster_pair_kernel",
                     "epoch_cull_kernel", "epoch_mt_kernel")
GATHER_KERNELS = ("rowspan_kernel", "dense_gather_kernel")
GATHER_BWD_KERNELS = ("rowspan_bwd_kernel",)
OWN_KERNELS = INTERSECT_KERNELS + GATHER_KERNELS + GATHER_BWD_KERNELS + (
    "grid_gather_kernel",)
NCCL = "nccl"
# the radius gather's routes in renderers/photon.py (K2, K4, the exact one)
GATHER_ROUTES = ("gather_radius_rowspan", "gather_radius_dense_tiles",
                 "gather_radius_dense")


def base_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    argument list."""
    n = name[5:] if name.startswith("void ") else name
    return n.split("(")[0].split("<")[0].strip()


def short_name(name: str) -> str:
    """A device operation's name for the breakdown: without its return
    type and argument list, 64 characters at most."""
    n = name[5:] if name.startswith("void ") else name
    return n.split("(")[0].strip()[:64]


def is_kernel(name: str, kernels) -> bool:
    return base_name(name) in kernels


@dataclasses.dataclass
class Counters:
    """Work counted at the layer boundaries during the traced window."""
    casts: list = dataclasses.field(default_factory=list)    # (rays, tris, any_hit)
    gathers: list = dataclasses.field(default_factory=list)  # (slots, queries, m)


@contextlib.contextmanager
def count_layers(counters: Counters):
    """Wrap the program's triangle casts and each route of its radius
    gather so that each call records its sizes (host values; the gather's
    counts stay on the card until the window has closed). Arguments are
    read by name from the wrapped functions' signatures."""
    from raytrace_tpu_torch.ops import intersect as isect
    from raytrace_tpu_torch.renderers import photon

    closest, occl = isect._closest_triangles, isect._occluded_triangles
    routes = {n: getattr(photon, n) for n in GATHER_ROUTES}

    def cast(real, any_hit):
        sig = inspect.signature(real)

        def wrapped(*a, **k):
            arg = sig.bind(*a, **k).arguments
            counters.casts.append((arg["o"].shape[0], arg["scene"].tris.count,
                                   any_hit))
            return real(*a, **k)
        return wrapped

    def gather(real):
        sig = inspect.signature(real)

        def wrapped(*a, **k):
            arg = sig.bind(*a, **k).arguments
            slots = (arg["photons_p"] if "photons_p" in arg
                     else arg["photons"].p).shape[0]
            out = real(*a, **k)
            counters.gathers.append((slots, arg["q_p"].shape[0], out[1]))
            return out
        return wrapped

    isect._closest_triangles = cast(closest, False)
    isect._occluded_triangles = cast(occl, True)
    for n, real in routes.items():
        setattr(photon, n, gather(real))
    try:
        yield counters
    finally:
        isect._closest_triangles, isect._occluded_triangles = closest, occl
        for n, real in routes.items():
            setattr(photon, n, real)


@dataclasses.dataclass
class Trace:
    device: list   # (name, start µs, end µs) of each device operation
    host: list     # (name, start µs, end µs) of each host operation
    window_s: float
    units: int     # frames or steps in the window
    counters: Counters
    gap_source: "Trace" = None  # a trace with host operations to name gaps

    def kernel_s(self, kernels) -> float:
        return sum(e - s for n, s, e in self.device
                   if is_kernel(n, kernels)) / 1e6

    def busy_s(self, skip_nccl: bool = True) -> float:
        spans = [(s, e) for n, s, e in self.device
                 if not (skip_nccl and NCCL in n.lower())]
        return union_us(spans) / 1e6

    def idle_share(self):
        """% of the window with no operation on the card (NCCL's kernels,
        which spin while they wait, count as idle)."""
        if not self.device or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def ops_per_unit(self):
        return len(self.device) / self.units if self.device else None

    def kernel_ms_per_unit(self, kernels):
        s = self.kernel_s(kernels)
        return 1e3 * s / self.units if s > 0 else None

    def glue_ms_per_unit(self):
        if not self.device:
            return None
        s = sum(e - b for n, b, e in self.device
                if not is_kernel(n, OWN_KERNELS))
        return s / 1e3 / self.units

    def gaps(self):
        """(start µs, length µs) of each idle stretch between device
        operations."""
        out, reach = [], None
        for s, e in sorted((s, e) for _, s, e in self.device):
            if reach is not None and s > reach:
                out.append((reach, s - reach))
            reach = e if reach is None else max(reach, e)
        return out

    def breakdown(self, top: int = 10) -> dict:
        by = {}
        for n, s, e in self.device:
            k = short_name(n)
            by[k] = by.get(k, 0.0) + (e - s) / 1e6
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        src = self if self.host or self.gap_source is None else self.gap_source
        host = src.host
        gaps = sorted(src.gaps(), key=lambda g: -g[1])[:top]
        named = []
        for start, length in gaps:
            mid = start + length / 2
            inner = [h for h in host if h[1] <= mid <= h[2]]
            label = (min(inner, key=lambda h: h[2] - h[1])[0] if inner
                     else "_no_host_op_")
            named.append([label[:64], length / 1e6])
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}


def union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def collect(prof, window_s: float, units: int, counters: Counters) -> Trace:
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.events():
        rec = (e.name, e.time_range.start, e.time_range.end)
        (dev if e.device_type == DeviceType.CUDA else host).append(rec)
    return Trace(dev, host, window_s, units, counters)
