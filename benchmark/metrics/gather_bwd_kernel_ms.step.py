"""Device ms a step of the gather's backward kernel (K3)."""
from benchmark import trace as T


def read(tr):
    return tr.kernel_ms_per_unit(T.GATHER_BWD_KERNELS)
