"""Share of rank 0's traced window in which no operation ran on its card
(%); NCCL's kernels, which spin while they wait for the other ranks,
count as idle."""


def read(tr):
    return tr.idle_share()
