"""Device timings on a CUDA card, shared by chip_smoke.py and
`utils/sweep.py`: CUDA events around back-to-back calls, and the
profiler's kernel records, which time the card alone."""
from __future__ import annotations

import torch


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn over iters launches, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_records(prof) -> list[tuple[str, float]]:
    """(kernel name without its argument list, device µs) of each device
    operation a finished torch.profiler.profile recorded."""
    from torch.autograd import DeviceType

    return [(e.name.split("(")[0], e.device_time_total)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_intervals(prof) -> list[tuple[str, float, float]]:
    """(kernel name without its argument list, start µs, end µs) of each
    device operation a finished torch.profiler.profile recorded, on the
    card's clock."""
    from torch.autograd import DeviceType

    return [(e.name.split("(")[0], e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def union_us(spans) -> float:
    """The length of the union of (start, end) intervals: time the card
    was busy, counting overlapping operations (other streams) once."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def kernel_device_ms(fn, kernel: str, iters: int) -> float:
    """Mean device time of the kernel named `kernel` over iters calls of fn
    (one launch each), from the profiler's kernel records: the card's time
    alone, without the host's time between launches. The profiler may
    drop a record at the end of its window, so the mean is over the
    records it kept, at least half of the launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = [us for name, us in device_records(prof) if name == kernel]
    if not iters / 2 <= len(times) <= iters:
        raise AssertionError(f"profiler: {len(times)} records of {kernel} "
                             f"for {iters} launches")
    return sum(times) / len(times) / 1e3


def call_device_ms(fn, last: str, iters: int) -> tuple[float, float]:
    """Device time of one call of fn over every device record it makes (its
    kernels, the prep's small ops, copies), from the profiler → (ms a
    call, records a call). `last` names the call's last kernel: the
    records, in order of their start on the card, are cut into calls after
    each of its records, and the mean is over the calls that lie whole
    between the first and the last of them (the profiler may drop the
    records at the end of its window), at least half of the iters calls
    after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    recs = sorted((e.time_range.start, e.name.split("(")[0],
                   e.device_time_total)
                  for e in prof.events() if e.device_type == DeviceType.CUDA)
    ends = [k for k, (_, name, _) in enumerate(recs) if name == last]
    calls = len(ends) - 1
    if calls < iters / 2:
        raise AssertionError(f"profiler: {len(ends)} records of {last} for "
                             f"{iters} calls")
    whole = recs[ends[0] + 1:ends[-1] + 1]
    return sum(us for _, _, us in whole) / calls / 1e3, len(whole) / calls
