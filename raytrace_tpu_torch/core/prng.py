"""Threefry2x32 keys and draws, bit for bit the same as `jax.random`.

Ports the calls the JAX package makes to `jax.random` (core/samples.py,
core/sampling.py, scene/camera.py, renderers/photon.py) with
`jax_threefry_partitionable=True`, the jax 0.9 default: one key gives the
same uniforms and permutations in both packages, so the port can be held
against the reference ray by ray.

A key is an int64 tensor `[..., 2]` holding two uint32 words (int64 so that
every op is defined on CPU and CUDA alike; values stay in [0, 2^32)). Leading
dimensions batch keys, which stands in for `jax.vmap` over keys.
"""
from __future__ import annotations

import math

import torch
from torch import Tensor

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: Tensor, r: int) -> Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: Tensor, k2: Tensor, x1: Tensor, x2: Tensor):
    """The Threefry-2x32 hash, 20 rounds (jax/_src/prng.py
    `_threefry2x32_lowering`). All arguments broadcast; returns (y1, y2)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def PRNGKey(seed: int, device) -> Tensor:
    """`jax.random.PRNGKey(seed)` as the JAX package runs it, with 64-bit
    types off: the seed is a 32-bit integer, so the key is (0, the seed's
    low 32 bits), for large and negative seeds too."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def fold_in(key: Tensor, data) -> Tensor:
    """`jax.random.fold_in`, vectorized: `data` may be an int or an integer
    tensor; key `[..., 2]` and data broadcast (this replaces a vmap of
    fold_in over uint32 ids)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def split(key: Tensor, num: int = 2) -> Tensor:
    """`jax.random.split` of one key → `[num, 2]` (the foldlike split:
    key i is threefry(key, (0, i)))."""
    return fold_in(key, torch.arange(num, dtype=torch.int64,
                                     device=key.device))


def random_bits(key: Tensor, shape: tuple[int, ...]) -> Tensor:
    """32-bit `jax.random.bits` for key(s) `[..., 2]` → `[..., *shape]`."""
    shape = tuple(shape)
    count = torch.arange(math.prod(shape), dtype=torch.int64,
                         device=key.device).reshape(shape)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,) * len(shape))
    k2 = key[..., 1].reshape(lead + (1,) * len(shape))
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(count), count)
    return y1 ^ y2


def uniform(key: Tensor, shape: tuple[int, ...] = ()) -> Tensor:
    """float32 `jax.random.uniform(key, shape)` in [0, 1): the top 23 bits
    become the mantissa of a float in [1, 2), minus one."""
    bits = random_bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def permutation(key: Tensor, n: int) -> Tensor:
    """`jax.random.permutation(key, n)`: the sort-based shuffle of
    jax/_src/random.py `_shuffle` (fresh 32-bit sort keys per round)."""
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(_MASK)))
    for _ in range(rounds):
        keys = split(key)
        key, sub = keys[0], keys[1]
        order = torch.argsort(random_bits(sub, (n,)), stable=True)
        x = x[order]
    return x
