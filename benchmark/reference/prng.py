"""Threefry-2x32 keys and uniforms, as `jax.random` defines them with
`jax_threefry_partitionable=True` (the key schedule both the program and
this reference draw their samples from).

A key is an int64 tensor `[..., 2]` of two uint32 words."""
from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry(k1, k2, x1, x2):
    """20 rounds of Threefry-2x32; arguments broadcast."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def key(seed: int, device) -> torch.Tensor:
    """PRNGKey(seed) with 32-bit seeds: (0, low 32 bits of the seed)."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def fold_in(k, data):
    d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & MASK
    y1, y2 = threefry(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def split(k, num: int = 2):
    return fold_in(k, torch.arange(num, dtype=torch.int64, device=k.device))


def bits_at(k, counts):
    """The 32-bit draws number `counts` of key(s) k `[..., 2]` (k's leading
    dims broadcast against counts)."""
    y1, y2 = threefry(k[..., 0], k[..., 1], torch.zeros_like(counts), counts)
    return y1 ^ y2


def to_uniform(bits):
    """float32 in [0, 1) from the top 23 bits."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def permutation(k, n: int):
    """The sort-based shuffle of arange(n)."""
    x = torch.arange(n, dtype=torch.int64, device=k.device)
    for _ in range(int(math.ceil(3 * math.log(max(1, n)) / math.log(MASK)))):
        k, sub = split(k)
        cnt = torch.arange(n, dtype=torch.int64, device=k.device)
        x = x[torch.argsort(bits_at(sub, cnt), stable=True)]
    return x
