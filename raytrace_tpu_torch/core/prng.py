"""Threefry2x32 keys and draws, bit for bit the same as `jax.random`.

Ports the calls the JAX package makes to `jax.random` (core/samples.py,
core/sampling.py, scene/camera.py, renderers/photon.py) with
`jax_threefry_partitionable=True`, the jax 0.9 default: one key gives the
same uniforms and permutations in both packages, so the port can be held
against the reference ray by ray.

A key is an int64 tensor `[..., 2]` holding two uint32 words (int64 so that
every op is defined on CPU and CUDA alike; values stay in [0, 2^32)). Leading
dimensions batch keys, which stands in for `jax.vmap` over keys.

Keys on a CUDA card draw through one kernel launch a call
(csrc/threefry.cu, `kernel_draw`); keys on any other device run the hash as
the eager int64 ops of `threefry2x32`, which the card's tests hold the
kernel to bit for bit. `folded_uniform` fuses folds and a draw into one
launch.
"""
from __future__ import annotations

import ctypes
import math
import operator

import torch
from torch import Tensor

from raytrace_tpu_torch.ops import cuda_lib
from raytrace_tpu_torch.utils import metrics

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
    with metrics.sync("prng_key"):
        return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                            device=device)


def _on_card(key: Tensor) -> bool:
    """Whether draws of `key` take the kernel: on a CUDA card they do."""
    return key.is_cuda


# csrc/threefry.cu: a data word's kind and the output's
_DATA_VALUE, _DATA_LANE, _DATA_I64, _DATA_I32 = range(4)
_OUT_KEYS, _OUT_BITS, _OUT_FLOATS = range(3)
_MAX_FOLDS = 2
_SIGNATURES = {"threefry_draw": (
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint] * 2
    + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
       ctypes.c_void_p])}


def _stride(x: Tensor, shape: tuple, one: int) -> tuple[Tensor, int]:
    """`x` as the kernel reads it against lanes of `shape`: one value (`one`
    elements) for every lane → stride 0, else one a lane, expanded to
    `shape` only where it broadcasts → stride 1."""
    if x.numel() == one:
        return x.contiguous(), 0
    if tuple(x.shape) != shape:
        x = x.expand(shape)
    return x.contiguous(), 1


def _broadcast(*shapes) -> tuple:
    """The broadcast of `shapes`, as NumPy's (torch.broadcast_shapes costs
    seconds at its first call and ~60 µs at each one after)."""
    n = max(map(len, shapes))
    out = []
    for dims in zip(*((1,) * (n - len(s)) + tuple(s) for s in shapes)):
        sizes = set(dims) - {1}
        if len(sizes) > 1:
            raise ValueError(f"shapes {shapes} do not broadcast")
        out.append(sizes.pop() if sizes else 1)
    return tuple(out)


def kernel_draw(key: Tensor, data, out_kind: int, shape=()) -> Tensor:
    """One launch of csrc/threefry.cu: fold each of `data` (at most two ints,
    integer tensors or `range(n)`s, the last a split's lane index) into
    key(s) `[..., 2]`, broadcast against their leading dimensions, then write
    the keys → `[*lead, 2]`, or the bits or uniforms of counters
    0..prod(shape)-1 of each → `[*lead, *shape]`."""
    dev = key.device
    if key.dtype != torch.int64 or len(data) > _MAX_FOLDS:
        raise ValueError(f"kernel_draw: {key.dtype} keys, {len(data)} folds")
    words, shapes = [], [key.shape[:-1]]
    for d in data:
        if isinstance(d, range):
            if d.start != 0 or d.step != 1:
                raise ValueError(f"kernel_draw: {d} is not a lane index")
            words.append((None, _DATA_LANE, 0))
            shapes.append((len(d),))
        elif isinstance(d, Tensor):
            d = torch.as_tensor(d, device=dev)
            if d.dtype not in (torch.int64, torch.int32):
                d = d.to(torch.int64)
            words.append((d, _DATA_I64 if d.dtype == torch.int64
                          else _DATA_I32, 0))
            shapes.append(d.shape)
        else:  # a launch argument: the host copies nothing to the card
            words.append((None, _DATA_VALUE, operator.index(d) & _MASK))
    lead = _broadcast(*shapes)
    if any(w[1] == _DATA_LANE for w in words) and len(lead) != 1:
        raise ValueError("kernel_draw: a lane index needs one key or one "
                         "leading dimension")
    lanes = math.prod(lead)
    if out_kind == _OUT_KEYS:
        shape, count = (2,), 0
    else:
        shape, count = tuple(shape), math.prod(shape)
    out = torch.empty(lead + shape, device=dev, dtype=(
        torch.float32 if out_kind == _OUT_FLOATS else torch.int64))
    if out.numel() == 0:
        return out
    keys, key_stride = _stride(key, lead + (2,), 2)
    held, args = [], []  # held: the words' tensors, alive until the launch
    for t, kind, value in words + [(None, _DATA_VALUE, 0)] * (
            _MAX_FOLDS - len(words)):
        if t is None:
            args += [None, kind, 0, value]
        else:
            t, stride = _stride(t, lead, 1)
            held.append(t)
            args += [cuda_lib.ptr(t), kind, stride, 0]
    lib = cuda_lib.load("threefry", _SIGNATURES)
    err = lib.threefry_draw(cuda_lib.ptr(keys), key_stride, len(words),
                            *args, lanes, count, out_kind, cuda_lib.ptr(out),
                            cuda_lib.stream_ptr(dev))
    cuda_lib.check(err, "threefry_draw")
    kernel_draw.launches += 1
    return out


kernel_draw.launches = 0


def prefetch(device) -> None:
    """On a CUDA `device`, start the nvcc build of the draws' kernel and
    return at once, so that it compiles while the caller does host work
    (the scene build); on any other device, build nothing."""
    if torch.device(device).type == "cuda":
        cuda_lib.prefetch("threefry")


def fold_in(key: Tensor, data) -> Tensor:
    """`jax.random.fold_in`, vectorized: `data` may be an int or an integer
    tensor; key `[..., 2]` and data broadcast (this replaces a vmap of
    fold_in over uint32 ids)."""
    if _on_card(key):
        return kernel_draw(key, (data,), _OUT_KEYS)
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def split(key: Tensor, num: int = 2) -> Tensor:
    """`jax.random.split` of one key → `[num, 2]` (the foldlike split:
    key i is threefry(key, (0, i)))."""
    if _on_card(key) and key.dim() == 1:
        return kernel_draw(key, (range(num),), _OUT_KEYS)
    return fold_in(key, torch.arange(num, dtype=torch.int64,
                                     device=key.device))


def random_bits(key: Tensor, shape: tuple[int, ...]) -> Tensor:
    """32-bit `jax.random.bits` for key(s) `[..., 2]` → `[..., *shape]`."""
    shape = tuple(shape)
    if _on_card(key):
        return kernel_draw(key, (), _OUT_BITS, shape)
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
    if _on_card(key):
        return kernel_draw(key, (), _OUT_FLOATS, shape)
    bits = random_bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def folded_uniform(key: Tensor, data, shape: tuple[int, ...] = ()) -> Tensor:
    """`uniform(fold_in(...fold_in(key, data[0])..., data[-1]), shape)`: on
    the card the last two folds and the draw are one launch, with no key in
    memory between them."""
    data = tuple(data)
    if _on_card(key):
        for d in data[:-_MAX_FOLDS]:
            key = fold_in(key, d)
        return kernel_draw(key, data[-_MAX_FOLDS:], _OUT_FLOATS, shape)
    for d in data:
        key = fold_in(key, d)
    return uniform(key, shape)


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
