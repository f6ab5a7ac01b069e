"""Device ms a frame of the draws' kernel (raytrace_tpu_torch/csrc/
threefry.cu): every key fold, split, bits and uniform of the frame on the
card, one launch each."""


def read(tr):
    return tr.kernel_ms_per_unit(("threefry_kernel",))
