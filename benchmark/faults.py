"""Faults planted in the program underneath a frame run, to show that the
check catches them (tests/test_bench_yardstick.py at toy size,
control.py at the cells' own sizes). Each is a context manager that
patches one function of raytrace_tpu_torch and restores it."""
from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def _patched(module, name, make):
    real = getattr(module, name)
    # the fake keeps the real one's signature (trace.count_layers binds by it)
    setattr(module, name, functools.update_wrapper(make(real), real))
    try:
        yield
    finally:
        setattr(module, name, real)


def state_unchanged():
    """The progressive update returns its state unchanged."""
    from raytrace_tpu_torch.renderers import photon

    def make(real):
        def same(scene, rec, state, photons, config):
            return state, real(scene, rec, state, photons, config)[1]
        return same
    return _patched(photon, "gathering_pass", make)


def half_left_out():
    """The gather sees only the first half of the photon map's slots."""
    from raytrace_tpu_torch.renderers import photon

    def make(real):
        def half(pp, pa, pw, pv, *a, **k):
            keep = torch.arange(pv.shape[0], device=pv.device) < pv.shape[0] // 2
            return real(pp, pa, pw, pv & keep, *a, **k)
        return half
    return _patched(photon, "gather_radius_rowspan", make)


def answer_altered():
    """Every seventh pixel sample's radiance comes out 5% high."""
    from raytrace_tpu_torch.renderers import photon

    def make(real):
        def altered(rec, direct, state):
            L = real(rec, direct, state)
            i = torch.arange(L.shape[0], device=L.device)
            return L * torch.where(i % 7 == 3, 1.05, 1.0)[:, None]
        return altered
    return _patched(photon, "final_gathering", make)


def exchange_left_out():
    """The all-gathers between ranks exchange nothing: each rank gets its
    own rows in every rank's place."""
    import torch.distributed as dist

    from raytrace_tpu_torch.parallel import sharded

    class _Done:
        def wait(self):
            return None

    def make(real):
        def local(x, group, async_op=False):
            out = [x.clone() for _ in range(dist.get_world_size(group))]
            return out, (_Done() if async_op else None)
        return local
    return _patched(sharded, "_all_gather", make)


@contextlib.contextmanager
def jax_loaded():
    """A module named `jax` in sys.modules, as an import of JAX leaves."""
    import sys
    import types

    sys.modules["jax"] = types.ModuleType("jax")
    try:
        yield
    finally:
        del sys.modules["jax"]


@contextlib.contextmanager
def planted(name):
    """The fault `name` (None: none) for the duration."""
    every = {**FAULTS, **SHARDED_FAULTS, "jax_loaded": jax_loaded}
    with (every[name]() if name else contextlib.nullcontext()):
        yield


FAULTS = {"state_unchanged": state_unchanged, "half_left_out": half_left_out,
          "answer_altered": answer_altered}
SHARDED_FAULTS = {"exchange_left_out": exchange_left_out}
