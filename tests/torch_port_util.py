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
