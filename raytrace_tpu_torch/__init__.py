"""raytrace_tpu_torch — the PyTorch/CUDA port of `raytrace_tpu`.

Same layout as the JAX package, module for module (each module's docstring
names the JAX file it ports). Plain functions on tensors, dataclasses of
tensors in place of flax pytrees, an explicit `device` wherever a tensor is
created from nothing, and explicit threefry keys (core/prng.py) that draw
the same bits as `jax.random`.

The kernels of the photon-mapping frame and its gradient are hand-written
CUDA C++ for Hopper (csrc/), built with nvcc at first use and bound through
ctypes:
  ops/tri_intersect.py   dense Möller–Trumbore closest hit (K1)
  ops/rowspan_gather.py  row-span photon gather (K2) and its backward in
                         the photon flux (K3)
Each wrapper runs its plain PyTorch version for CPU tensors only; a CUDA
tensor launches the kernel or raises.

This package imports torch and numpy only — never jax or flax.
"""

__version__ = "0.1.0"
