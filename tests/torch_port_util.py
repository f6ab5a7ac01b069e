"""Shared helpers for the parity tests of the PyTorch port against the JAX
package: same inputs through both, compared on the CPU."""
import jax
import numpy as np
import torch

from raytrace_tpu_torch import interop
from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.renderers import common
from raytrace_tpu_torch.scene.camera import generate_rays, pixel_samples

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


def corner_edge_pixels(scene, camera, config, tol=1e-5):
    """[H, W] mask of the pixels of the Cornell box whose centre's camera
    ray hits a corner edge of the box: two of its planes (side walls
    x = ±1, floor z = 0, ceiling z = 2, back wall y = 2) within `tol`.
    With jitter off, the centres on the image's diagonals look exactly
    along those edges, and XLA's and PyTorch's arithmetic may pick
    different walls there."""
    h, w = camera.height, camera.width
    xy, lens = pixel_samples(prng.PRNGKey(0, "cpu"), w, h, 1, jitter=False)
    rays = generate_rays(camera, xy, lens, 1)
    rec = common.camera_pass(scene, rays.o, rays.d, config, rays=rays)
    p = rec.p
    planes = torch.stack([(p[:, 0].abs() - 1).abs(), p[:, 2].abs(),
                          (p[:, 2] - 2).abs(), (p[:, 1] - 2).abs()], 1)
    return n(rec.hit & ((planes < tol).sum(1) >= 2)).reshape(h, w)


def assert_frames_close(got, want, edge, rtol=5e-4, atol=5e-5):
    """Two frames of the box (spp 1, jitter off) within rtol and atol (the
    JAX package's bound for its sharded renders) on every pixel off the
    corner edges, and on at least half of the pixels on them (`edge`,
    corner_edge_pixels): the edge flips are counted, not covered by a
    wider bound."""
    got, want = n(got), n(want)
    assert got.shape == want.shape == edge.shape + (3,)
    assert np.isfinite(got).all() and want.mean() > 0.01
    off = ~np.isclose(got, want, rtol=rtol, atol=atol).all(-1)
    assert not (off & ~edge).any(), (
        f"{(off & ~edge).sum()} pixels off the corner edges beyond rtol "
        f"{rtol}, atol {atol}: largest difference "
        f"{np.abs(got - want)[~edge].max()}")
    assert (off & edge).sum() <= edge.sum() // 2, (
        f"{(off & edge).sum()} of {edge.sum()} corner-edge pixels flipped")
