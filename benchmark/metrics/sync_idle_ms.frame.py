"""Idle ms a frame in gaps of the card that opened while the host was inside
an rt.sync.* span: the queue ran dry under a host wait (such a gap also
counts in its layer)."""
from benchmark import spans


def read(tr):
    return spans.idle_ms(tr, "sync")
