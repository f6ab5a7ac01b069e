"""Checkpoint/resume for progressive photon mapping (port of
raytrace_tpu/utils/checkpoint.py).

A wave boundary is a clean checkpoint: the per-pixel PPM statistics
(ProgressiveState) + the next pass index + the render key. Photon waves are
pure functions of (key, pass index), so a resumed render equals an
uninterrupted one.

The file is the JAX package's `.npz`, key for key and with the same
`_FORMAT_VERSION`, so checkpoints cross between the two packages in both
directions. The key is stored in JAX's layout, uint32 [2] (hi, lo); the
port's key is the same two words as int64 (core/prng.py).
"""
from __future__ import annotations

import os

import numpy as np
import torch

_FORMAT_VERSION = 1


def save_progressive(path: str, state, next_pass: int, key,
                     emitted_photons: float = 0.0) -> None:
    """Write a PPM wave checkpoint atomically (tmp + rename)."""
    tmp = path + ".tmp"
    host = lambda x: x.detach().cpu().numpy()
    np.savez(
        tmp,
        version=np.int32(_FORMAT_VERSION),
        radius2=host(state.radius2),
        photon_count=host(state.photon_count),
        flux=host(state.flux),
        next_pass=np.int32(next_pass),
        key=host(key).astype(np.uint32),
        emitted_photons=np.float64(emitted_photons),
        emitted=host(state.emitted),
    )
    # np.savez appends .npz to the filename it's given
    os.replace(tmp + ".npz", path)


def load_progressive(path: str, device):
    """Read a checkpoint → (ProgressiveState on `device`, next_pass, key,
    emitted_photons). key is the saved key as a port key (int64 [2] on the
    CPU): callers compare it against their own to catch a resume with
    another key.

    A file without per-pixel `emitted` (a JAX state that did not track it)
    gets emitted = emitted_photons for every pixel: the paths of every wave
    so far, which is what JAX normalizes such a state by."""
    from raytrace_tpu_torch.renderers.photon import ProgressiveState

    with np.load(path) as z:
        if int(z["version"]) != _FORMAT_VERSION:
            raise ValueError(f"unknown checkpoint version {int(z['version'])}")
        dev = lambda name: torch.as_tensor(z[name], device=device)
        emitted_photons = float(z["emitted_photons"])
        radius2 = dev("radius2")
        emitted = (dev("emitted") if "emitted" in z.files else
                   torch.full_like(radius2, emitted_photons))
        state = ProgressiveState(radius2=radius2,
                                 photon_count=dev("photon_count"),
                                 flux=dev("flux"), emitted=emitted)
        key = torch.as_tensor(z["key"].astype(np.int64))
        return state, int(z["next_pass"]), key, emitted_photons
