"""Idle ms a frame in gaps of the card that opened while the innermost open
rt.* span that is not a sync was rt.gather* (the radius gather, its job list
and K2)."""
from benchmark import spans


def read(tr):
    return spans.idle_ms(tr, "gather")
