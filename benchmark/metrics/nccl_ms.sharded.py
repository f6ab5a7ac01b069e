"""Device ms a frame of NCCL's kernels on rank 0 (the union of their
intervals): the all-gathers and the wait for the slowest rank."""
from benchmark import trace as T


def read(tr):
    spans = [(s, e) for n, s, e in tr.device if T.NCCL in n.lower()]
    return T.union_us(spans) / 1e3 / tr.units if spans else None
