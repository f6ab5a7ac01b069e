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
