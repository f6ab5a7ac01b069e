"""Device ms a frame of the forward gather kernels (K2; K4 on small maps)."""
from benchmark import trace as T


def read(tr):
    return tr.kernel_ms_per_unit(T.GATHER_KERNELS)
