"""Lanes a frame that the camera walk cast at depths 1 and on (the program's
host counter `chain_lanes`, raytrace_tpu_torch/utils/metrics.py, which
counts while a profiler records): the counter over the traced window ÷ the
frames profiled in it (the card-only frames and the host-traced one).
None for a program without the counter."""


def read(tr):
    from raytrace_tpu_torch.utils import metrics

    counters = getattr(metrics, "COUNTERS", None)
    if counters is None:
        return None
    frames = tr.units + (tr.gap_source.units if tr.gap_source else 0)
    return counters.get("chain_lanes", 0) / frames
