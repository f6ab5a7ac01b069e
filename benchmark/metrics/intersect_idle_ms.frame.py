"""Idle ms a frame in gaps of the card that opened while the innermost open
rt.* span that is not a sync was rt.intersect.* (the casts and their
engines)."""
from benchmark import spans


def read(tr):
    return spans.idle_ms(tr, "intersect")
