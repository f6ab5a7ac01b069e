"""Photon map storage, Morton keys and the exact all-pairs gather (port of the
parts of raytrace_tpu/ops/photon_grid.py the forward frame uses; the
budgeted hash-grid gather, a CPU fallback that truncates, is not ported —
the port gathers through ops/rowspan_gather.py on every device)."""
from __future__ import annotations

import dataclasses

import torch
from torch import Tensor


@dataclasses.dataclass(frozen=True)
class PhotonMap:
    """Flat photon storage (reference: CudaPhoton, photonmapping.h:32-40)
    with an explicit validity mask."""
    p: Tensor  # [P, 3] position
    alpha: Tensor  # [P, 3] flux
    wi: Tensor  # [P, 3] incident direction
    valid: Tensor  # [P] bool


def gather_radius_dense(photons: PhotonMap, q_p: Tensor, radius2: Tensor,
                        q_ns: Tensor, q_kd_over_pi: Tensor,
                        chunk: int = 2048):
    """EXACT all-pairs radius search + photon shading, streamed over photon
    chunks → (L [N, 3], M [N] int32): L = kd/π · Σ_{dist² < r², valid}
    |n_s·wi|·α. The correctness oracle for the rowspan gather."""
    n = q_p.shape[0]
    acc = torch.zeros((n, 3), dtype=torch.float32, device=q_p.device)
    m = torch.zeros((n,), dtype=torch.int32, device=q_p.device)
    for c0 in range(0, photons.p.shape[0], chunk):
        cp = photons.p[c0:c0 + chunk]
        d2 = torch.sum((q_p[:, None, :] - cp[None, :, :]) ** 2, dim=-1)
        ok = (d2 < radius2[:, None]) & photons.valid[None, c0:c0 + chunk]
        w = torch.abs(q_ns @ photons.wi[c0:c0 + chunk].T)
        wm = torch.where(ok, w, 0.0)
        acc = acc + wm @ photons.alpha[c0:c0 + chunk]
        m = m + ok.sum(dim=1, dtype=torch.int32)
    return q_kd_over_pi * acc, m


def _expand_bits10(v: Tensor) -> Tensor:
    """Spread the low 10 bits of v so consecutive bits land 3 apart."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton3(cell: Tensor) -> Tensor:
    """[..., 3] integer cell coords in [0, 1024) → int64 z-order key < 2^30."""
    c = cell.to(torch.int64)
    return ((_expand_bits10(c[..., 0]) << 2)
            | (_expand_bits10(c[..., 1]) << 1)
            | _expand_bits10(c[..., 2]))
