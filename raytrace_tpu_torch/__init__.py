"""raytrace_tpu_torch — the PyTorch/CUDA port of `raytrace_tpu`.

Same layout as the JAX package, module for module (each module's docstring
names the JAX file it ports). Plain functions on tensors, dataclasses of
tensors in place of flax pytrees, an explicit `device` wherever a tensor is
created from nothing, and explicit threefry keys (core/prng.py) that draw
the same bits as `jax.random`.

Every kernel the JAX package wrote in Pallas is hand-written CUDA C++ for
Hopper (csrc/), built with nvcc at first use and bound through ctypes:
  ops/tri_intersect.py   dense Möller–Trumbore closest hit (K1)
  ops/rowspan_gather.py  row-span photon gather (K2) and its backward in
                         the photon flux (K3)
  ops/dense_gather.py    dense small-map photon gather (K4)
  ops/grid_gather.py     Morton-span photon gather (K5)
  ops/cluster_kernels.py the cluster engine's tile cull (K6) and pair
                         Möller–Trumbore (K7)
  ops/epoch_kernels.py   the epoch engine's subtile cull (K8) and subtile
                         Möller–Trumbore (K9)
Each wrapper runs its plain PyTorch version for CPU tensors only; a CUDA
tensor launches the kernel or raises.

The front end is JAX's: `load_pbrt(path, device)` / `loads_pbrt(text,
device)` parse a pbrt-v2 scene (scene/pbrt.py), `raytrace-tpu-torch`
(cli.py) renders one to PNG, PFM or EXR (utils/image.py).

This package imports torch and numpy only — never jax or flax.
"""

__version__ = "0.1.0"

from raytrace_tpu_torch.scene.pbrt import load_pbrt, loads_pbrt  # noqa: E402,F401
