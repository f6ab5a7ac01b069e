"""Shared helpers for the parity tests of the PyTorch port against the JAX
package: same inputs through both, compared on the CPU."""
import jax
import numpy as np
import torch

from raytrace_tpu_torch import interop

# the suite runs several pytest workers at once; keep each one's torch
# intra-op pool small
torch.set_num_threads(2)


def np_tree(tree):
    """A JAX pytree with every leaf as a numpy array."""
    return jax.tree_util.tree_map(np.asarray, tree)


def port_scene(jax_scene):
    return interop.scene_from_numpy(np_tree(jax_scene), "cpu")


def t(x, dtype=None):
    """numpy/JAX array → CPU torch tensor."""
    return torch.as_tensor(np.array(x), dtype=dtype)


def n(x):
    """torch tensor or JAX array → numpy."""
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_t_close(got, want, share=0.01):
    """Hit distances of the two packages: XLA's CPU backend contracts
    a·b + c into fused multiply-adds where PyTorch's CPU kernels round each
    step, and t = (e2·q)/det cancels, so a few rays differ by more than
    ulps. t within rtol 1e-6 on all but `share` of the rays, and within
    2e-5 (the tolerance of the JAX package's own tests) on all."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=2e-5)
    loose = ~np.isclose(got, want, rtol=1e-6, atol=0.0)
    assert loose.sum() <= share * got.size, (
        f"{loose.sum()} of {got.size} beyond 1e-6")
