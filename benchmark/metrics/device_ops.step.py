"""Device operations a step: the profiler's device records ÷ steps."""


def read(tr):
    return tr.ops_per_unit()
