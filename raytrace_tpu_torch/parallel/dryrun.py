"""A multi-rank dry run of the sharded train step (port of
`__graft_entry__.py` `dryrun_multichip`): one train_step_sharded on a
16×16 Cornell box over n spawned ranks, asserting a finite loss.

    python -m raytrace_tpu_torch.parallel.dryrun 4 --cpu
"""
from __future__ import annotations

import argparse
import math

import torch
from torch.distributed.device_mesh import DeviceMesh

from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.core.config import RenderConfig
from raytrace_tpu_torch.diff.render import extract_params
from raytrace_tpu_torch.parallel import launch, sharded
from raytrace_tpu_torch.scene import presets

SIZE = 16


def _dryrun_rank(rank: int, world: int, device: torch.device) -> float:
    if world > 1 and world % 2 == 0:
        # the hierarchical ('hosts', 'chips') mesh: the two-hop photon
        # gather and pixel blocks over both axes, as on several hosts
        mesh = DeviceMesh(device.type,
                          torch.arange(world, dtype=torch.int).reshape(
                              2, world // 2),
                          mesh_dim_names=("hosts", "chips"))
    else:
        mesh = sharded.make_mesh(device.type)
    scene, camera = presets.cornell_box(device, SIZE)
    config = RenderConfig(width=SIZE, height=SIZE, spp=max(1, world),
                          scene_epsilon=1e-3, photon_paths=64 * world,
                          photon_passes=1, max_photon_bounces=4,
                          differentiable=True)
    loss, _ = sharded.train_step_sharded(
        extract_params(scene), torch.zeros((SIZE, SIZE, 3), device=device),
        scene, camera, config, prng.PRNGKey(0, device), mesh)
    return float(loss)


def dryrun_multichip(n_devices: int, device_type: str = "cuda") -> None:
    """One sharded train step over n_devices ranks: gloo processes on the
    CPU (device_type='cpu') or NCCL on n_devices cards; raises on a
    non-finite loss or a failed rank."""
    losses = launch.run_world(_dryrun_rank, n_devices, device_type)
    for rank, loss in enumerate(losses):
        if not math.isfinite(loss):
            raise AssertionError(f"non-finite loss {loss} on rank {rank}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU instead of one card each")
    a = ap.parse_args()
    dryrun_multichip(a.n_devices, "cpu" if a.cpu else "cuda")
    print(f"dryrun_multichip({a.n_devices}) OK")
