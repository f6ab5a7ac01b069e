"""Device ms a frame of every operation that is not one of the program's
hand-written kernels: PyTorch's own kernels (camera pass, photon walk,
compactions, sorts) and copies."""


def read(tr):
    return tr.glue_ms_per_unit()
