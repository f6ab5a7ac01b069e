"""The port's threefry (raytrace_tpu_torch/core/prng.py) draws the very bits
`jax.random` draws: every comparison here is exact equality."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import n, t
from raytrace_tpu.core import samples as j_samples
from raytrace_tpu.core import sampling as j_sampling
from raytrace_tpu.renderers import photon as j_photon
from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.core import samples as p_samples
from raytrace_tpu_torch.core import sampling as p_sampling
from raytrace_tpu_torch.renderers import photon as p_photon

SEEDS = [0, 7, 2**31 - 1]


def _keys(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed, "cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    jk, pk = _keys(seed)
    np.testing.assert_array_equal(n(jk), n(pk))


@pytest.mark.parametrize("seed", [2**32 + 5, (7 << 32) | 0xDEADBEEF, -1])
def test_prng_key_of_seeds_outside_uint32(seed):
    """JAX takes the seed's low 32 bits (64-bit types are off)."""
    jk, pk = _keys(seed)
    np.testing.assert_array_equal(n(jk), n(pk))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3])
def test_split(seed, num):
    jk, pk = _keys(seed)
    np.testing.assert_array_equal(n(jax.random.split(jk, num)),
                                  n(prng.split(pk, num)))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_vmapped_over_uint32_ids(seed):
    jk, pk = _keys(seed)
    ids = np.random.default_rng(seed).integers(0, 2**32, 64, dtype=np.uint32)
    want = jax.vmap(lambda g: jax.random.fold_in(jk, g))(jnp.asarray(ids))
    got = prng.fold_in(pk, t(ids.astype(np.int64)))
    np.testing.assert_array_equal(n(want), n(got))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(37, 2), (3,), ()])
def test_uniform(seed, shape):
    jk, pk = _keys(seed)
    want = jax.random.uniform(jk, shape, dtype=jnp.float32)
    np.testing.assert_array_equal(n(want), n(prng.uniform(pk, shape)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("base", [2, 3, 5, 7, 11])
def test_permutation_at_halton_bases(seed, base):
    jk, pk = _keys(seed)
    want = jax.random.permutation(jk, jnp.arange(base, dtype=jnp.int32))
    np.testing.assert_array_equal(n(want), n(prng.permutation(pk, base)))


@pytest.mark.parametrize("seed", SEEDS)
def test_halton_samples(seed):
    jk, pk = _keys(seed)
    jperms = j_sampling.halton_permutations(jk)
    pperms = p_sampling.halton_permutations(pk)
    for a, b in zip(jperms, pperms):
        np.testing.assert_array_equal(n(a), n(b))
    idx = np.arange(0, 4000, 3, dtype=np.uint32)
    np.testing.assert_array_equal(
        n(j_sampling.halton_sample_4d(jnp.asarray(idx), jperms)),
        n(p_sampling.halton_sample_4d(t(idx.astype(np.int64)), pperms)))


@pytest.mark.parametrize("seed", SEEDS)
def test_batched_key_draws(seed):
    """The photon walk's per-lane bounce uniforms and the direct-lighting
    sample layout: vmapped fold_in/uniform chains."""
    jk, pk = _keys(seed)
    rng = np.random.default_rng(seed)
    gids = rng.integers(0, 2**20, 50).astype(np.uint32)
    n_int = rng.integers(0, 5, 50).astype(np.int32)
    np.testing.assert_array_equal(
        n(j_photon._bounce_uniforms(jk, jnp.asarray(gids),
                                    jnp.asarray(n_int))),
        n(p_photon._bounce_uniforms(pk, t(gids.astype(np.int64)),
                                    t(n_int))))
    jl, pl = j_samples.SampleLayout(), p_samples.SampleLayout()
    for req in (1, 4, 2):
        assert jl.add_2d(req) == pl.add_2d(req)
    ids = np.arange(40, dtype=np.uint32)
    np.testing.assert_array_equal(
        n(jl.materialize_2d(jk, jnp.asarray(ids))),
        n(pl.materialize_2d(pk, t(ids.astype(np.int64)))))


@pytest.mark.parametrize("seed", SEEDS)
def test_stratified_2d(seed):
    jk, pk = _keys(seed)
    np.testing.assert_array_equal(n(j_sampling.stratified_2d(jk, 4, 3)),
                                  n(p_sampling.stratified_2d(pk, 4, 3)))
