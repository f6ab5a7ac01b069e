"""The host's waits for the card a frame: the CUDA runtime's synchronize
calls inside the rt.frame spans of the host-traced frames ÷ those frames
(the rt.sync.* spans name their sites, and do not decide the count)."""
from benchmark import spans


def read(tr):
    a = spans.attribute(tr)
    return None if a is None else a["syncs"] / a["units"]
