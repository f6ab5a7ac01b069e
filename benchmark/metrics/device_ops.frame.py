"""Device operations a frame: the profiler's device records ÷ frames."""


def read(tr):
    return tr.ops_per_unit()
