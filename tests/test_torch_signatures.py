"""Each kernel's ctypes argtypes (the wrappers' *_SIGNATURES) against the C
entry point in its csrc/*.cu: the same number of parameters, a pointer
where the source takes `void*` and an int where it takes `int`. ctypes
does not check a call against the library, so a mismatch would pass a
value in the wrong slot on the card without an error."""
import ctypes
import re

import pytest

from raytrace_tpu_torch.ops import cluster_kernels, cuda_lib, dense_gather
from raytrace_tpu_torch.ops import epoch_kernels, grid_gather, rowspan_gather
from raytrace_tpu_torch.ops import tri_intersect

SIGNATURES = {
    "tri_intersect": tri_intersect._SIGNATURES,
    "rowspan_gather": rowspan_gather._SIGNATURES,
    "rowspan_gather_bwd": rowspan_gather._BWD_SIGNATURES,
    "dense_gather": dense_gather._SIGNATURES,
    "grid_gather": grid_gather._SIGNATURES,
    "cluster_cull": cluster_kernels._CULL_SIGNATURES,
    "cluster_pair": cluster_kernels._PAIR_SIGNATURES,
    "epoch_cull": epoch_kernels._CULL_SIGNATURES,
    "epoch_mt": epoch_kernels._MT_SIGNATURES,
}


def _entry_points(source: str) -> dict:
    """extern "C" functions of a source → their parameters' ctypes."""
    found = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                   source):
        kinds = []
        for p in filter(None, (x.strip() for x in params.split(","))):
            if "*" in p:
                kinds.append(ctypes.c_void_p)
            elif re.match(r"int \w+$", p):
                kinds.append(ctypes.c_int)
            else:
                raise AssertionError(f"{name}: parameter {p!r}")
        found[name] = kinds
    return found


@pytest.mark.parametrize("name", list(SIGNATURES))
def test_argtypes_match_the_entry_points(name):
    source = (cuda_lib.SRC_DIR / f"{name}.cu").read_text()
    assert _entry_points(source) == SIGNATURES[name]
