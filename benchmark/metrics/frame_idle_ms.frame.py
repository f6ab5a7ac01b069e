"""Idle ms a frame in gaps of the card that opened while the innermost open
rt.* span that is not a sync was rt.frame* (the renderer's passes outside
the casts and the gather)."""
from benchmark import spans


def read(tr):
    return spans.idle_ms(tr, "frame")
