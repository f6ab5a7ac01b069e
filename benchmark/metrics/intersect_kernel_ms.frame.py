"""Device ms a frame of the intersection kernels (K1, K6, K7, K8, K9)."""
from benchmark import trace as T


def read(tr):
    return tr.kernel_ms_per_unit(T.INTERSECT_KERNELS)
