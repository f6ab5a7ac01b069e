"""Build and load the port's native code: the CUDA C++ kernels
(csrc/*.cu, nvcc) and the host BVH builder (csrc/bvh_builder.cc, g++).

Each source is compiled on first use into a shared library with a plain C
interface — the kernels with `-gencode arch=compute_90a,code=sm_90a`
(Hopper) — and loaded with ctypes. Libraries land in
`raytrace_tpu_torch/_build/` (git-ignored), named by a hash of the source and
flags, so an edited source is rebuilt and concurrent first uses cannot load
a half-written file. `prefetch` starts a kernel's build on a thread of its
own, so that nvcc runs while the host does other work; `build` and `load`
then wait for it. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import Future
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# per-source flags: the hit tests (K1, K6-K9) and the gathers' (K2-K5)
# radius tests and weights must round every product and sum like their
# plain PyTorch versions, so nvcc may not contract a*b+c into an FMA there
EXTRA_FLAGS = {"tri_intersect": ("--fmad=false",),
               "rowspan_gather": ("--fmad=false",),
               "rowspan_gather_bwd": ("--fmad=false",),
               "dense_gather": ("--fmad=false",),
               "grid_gather": ("--fmad=false",),
               "cluster_cull": ("--fmad=false",),
               "cluster_pair": ("--fmad=false",),
               "epoch_cull": ("--fmad=false",),
               "epoch_mt": ("--fmad=false",)}
# the host builder: the JAX package's own flags (raytrace_tpu/ops/bvh_native.py)
HOST_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-march=native"]

_loaded: dict[str, ctypes.CDLL] = {}
# builds that prefetch started, by kernel name; guarded by _pending_lock
_pending: dict[str, Future] = {}
_pending_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): the CUDA kernels cannot "
                           "be built")
    return path


def _library(name: str, src: Path, flags: list) -> Path:
    """Where the library of `src` built with `flags` lies."""
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _compile(name: str, src: Path, compiler: list, flags: list) -> Path:
    """Compile `src` with `compiler` + `flags` unless a library of the same
    source and flags exists → path of the shared library."""
    out = _library(name, src, flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([*compiler, *flags, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{compiler[0]} failed on {src}:\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def nvcc_flags(name: str) -> list:
    """nvcc's flags for the kernel csrc/<name>.cu."""
    return ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler",
                         "-fPIC", *EXTRA_FLAGS.get(name, ())]


def _build_now(name: str) -> Path:
    return _compile(name, SRC_DIR / f"{name}.cu", [nvcc_path()],
                    nvcc_flags(name))


def build(name: str) -> Path:
    """Compile the kernel csrc/<name>.cu with nvcc (if needed) → path of
    the shared library. A build that `prefetch` started is waited for, not
    repeated; its failure raises here."""
    with _pending_lock:
        pending = _pending.get(name)
    if pending is not None:
        return pending.result()
    return _build_now(name)


def prefetch(*names: str) -> None:
    """Start the nvcc build of each kernel csrc/<name>.cu whose library is
    missing, each on a thread of its own, and return at once."""
    for name in names:
        with _pending_lock:
            if name in _pending or _library(
                    name, SRC_DIR / f"{name}.cu", nvcc_flags(name)).exists():
                continue
            pending = _pending[name] = Future()
        threading.Thread(target=_build_into, args=(name, pending),
                         name=f"nvcc-{name}", daemon=True).start()


def _build_into(name: str, pending: Future) -> None:
    try:
        pending.set_result(_build_now(name))
    except Exception as err:  # raised again by build(name)
        pending.set_exception(err)


def build_host(name: str) -> Path:
    """Compile the host source csrc/<name>.cc with $CXX (default g++), if
    needed → path of the shared library. Raises FileNotFoundError without
    the compiler, RuntimeError when it fails."""
    return _compile(name, SRC_DIR / f"{name}.cc",
                    [os.environ.get("CXX", "g++")], HOST_FLAGS)


def load(name: str, signatures: dict):
    """Build (if needed) and load csrc/<name>.cu; `signatures` maps each C
    entry point to its ctypes argtypes. Every entry point returns the
    cudaError_t of its launch as an int, apart from the constants' getters."""
    if name not in _loaded:
        _loaded[name] = bind(build(name), signatures)
    return _loaded[name]


def bind(path: Path, signatures: dict):
    """Load the shared library at `path` with each entry point of
    `signatures` typed (see load)."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def check_inputs(what: str, device, expect) -> None:
    """Raise unless every (tensor, dtype, shape or None) of `expect` lies on
    `device` with that dtype and shape and is contiguous."""
    for a, dtype, shape in expect:
        if a.device != device or a.dtype != dtype:
            raise ValueError(f"{what}: expected {dtype} on {device}, "
                             f"got {a.dtype} on {a.device}")
        if shape is not None and tuple(a.shape) != shape:
            raise ValueError(f"{what}: expected shape {shape}, got "
                             f"{tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
