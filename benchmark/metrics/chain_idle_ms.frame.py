"""Idle ms a frame in gaps of the card that opened while an
rt.frame.camera.chain span was open (the camera walk's specular chains,
depths 1 and on), whatever span was innermost: the chain's own glue, its
host waits and its casts together. None where the host-traced frame holds
no such span."""
from benchmark import spans

CHAIN = "rt.frame.camera.chain"


def read(tr):
    src = spans.source(tr)
    if src is None or not src.device:
        return None
    chain = [(s, e) for n, s, e in src.host if n == CHAIN]
    if not chain:
        return None
    idle = sum(length for start, length in spans.gaps(src)
               if any(a <= start < b for a, b in chain))
    return idle / 1e3 / src.units
