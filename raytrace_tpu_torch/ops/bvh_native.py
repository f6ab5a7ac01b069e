"""ctypes binding of the binned-SAH BVH builder (port of
raytrace_tpu/ops/bvh_native.py).

The port keeps its own copy of the C++ source, csrc/bvh_builder.cc, and
compiles it with g++ and the JAX package's flags on first use into
`raytrace_tpu_torch/_build/` (ops/cuda_lib.py `build_host`). Nothing is
compiled at import time.
"""
from __future__ import annotations

import ctypes

import numpy as np

from raytrace_tpu_torch.ops import cuda_lib

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(cuda_lib.build_host("bvh_builder")))
        p_f32 = ctypes.POINTER(ctypes.c_float)
        p_i32 = ctypes.POINTER(ctypes.c_int32)
        p_i64 = ctypes.POINTER(ctypes.c_int64)
        lib.build_bvh_sah.restype = ctypes.c_int64
        lib.build_bvh_sah.argtypes = [
            p_f32, p_f32, p_f32, ctypes.c_int64, ctypes.c_int32,
            p_f32, p_f32, p_i32, p_i32, p_i32, p_i32, p_i64, p_i32,
        ]
        _lib = lib
    return _lib


def build_bvh_sah(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                  leaf_size: int = 4) -> tuple[dict, np.ndarray]:
    """Binned-SAH build → (flat node arrays, primitive permutation); the
    contract of ops/bvh.build_bvh."""
    lib = _load()
    v0 = np.ascontiguousarray(v0, np.float32)
    v1 = np.ascontiguousarray(v1, np.float32)
    v2 = np.ascontiguousarray(v2, np.float32)
    n = v0.shape[0]
    max_nodes = max(1, 2 * n)
    bmin = np.empty((max_nodes, 3), np.float32)
    bmax = np.empty((max_nodes, 3), np.float32)
    right = np.zeros(max_nodes, np.int32)
    first = np.zeros(max_nodes, np.int32)
    count = np.zeros(max_nodes, np.int32)
    axis = np.zeros(max_nodes, np.int32)
    perm = np.empty(n, np.int64)
    max_depth = np.zeros(1, np.int32)

    c = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
    n_nodes = int(lib.build_bvh_sah(
        c(v0, ctypes.c_float), c(v1, ctypes.c_float), c(v2, ctypes.c_float),
        ctypes.c_int64(n), ctypes.c_int32(leaf_size),
        c(bmin, ctypes.c_float), c(bmax, ctypes.c_float),
        c(right, ctypes.c_int32), c(first, ctypes.c_int32),
        c(count, ctypes.c_int32), c(axis, ctypes.c_int32),
        c(perm, ctypes.c_int64), c(max_depth, ctypes.c_int32),
    ))
    arrays = dict(
        bmin=bmin[:n_nodes].copy(), bmax=bmax[:n_nodes].copy(),
        right=right[:n_nodes].copy(), first=first[:n_nodes].copy(),
        count=count[:n_nodes].copy(), axis=axis[:n_nodes].copy(),
        max_depth=int(max_depth[0]), leaf_size=int(leaf_size),
    )
    return arrays, perm
