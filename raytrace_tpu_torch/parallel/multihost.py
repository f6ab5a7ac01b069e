"""Several processes and hosts: process-group start-up, the hierarchical
('hosts', 'chips') mesh, and the scaling report (port of
raytrace_tpu/parallel/multihost.py).

  - `initialize_distributed` joins the process group once per process, from
    torch's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) or
    from its arguments: NCCL when the process's device is a card, gloo when
    it is the CPU;
  - the hierarchical mesh puts the ranks of one host on the inner 'chips'
    axis (NVLink within a host) and the hosts on the outer one, so the
    photon map's all_gather takes two hops, within the host first
    (parallel/sharded.py);
  - `scaling_report` renders the same frame on the first 1, 2, … ranks and
    reports rays/s at each count.
"""
from __future__ import annotations

import os
import socket
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.parallel import sharded


def initialize_distributed(init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None,
                           device_id=None) -> bool:
    """Join the default process group. The arguments left out come from
    torch's environment: init_method 'env://' when MASTER_ADDR is set,
    WORLD_SIZE and RANK. A single process (no rendezvous, or a world of 1)
    is a no-op that returns False; a process already in a group returns
    True at once. device_id is this process's device: by default the card
    LOCAL_RANK names (0 without it), which selects NCCL and becomes the
    current card; torch.device('cpu') selects gloo. Without a card and
    without a CPU request this raises."""
    if dist.is_initialized():
        return True
    if init_method is None and "MASTER_ADDR" in os.environ:
        init_method = "env://"
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if not init_method or not world_size or world_size <= 1:
        return False
    if device_id is None:
        device_id = torch.device("cuda",
                                 int(os.environ.get("LOCAL_RANK", 0)))
    device = torch.device(device_id)
    sharded.require_device(device.type)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=init_method, world_size=world_size,
                            rank=rank, device_id=device if cuda else None)
    return True


def make_hierarchical_mesh(device_type: str = "cuda") -> DeviceMesh:
    """('hosts', 'chips') mesh over every rank: the ranks grouped by the
    host they run on, hosts in order of their lowest rank. One host, or
    hosts with unequal rank counts (no (hosts, chips) factoring), give a
    (1, world) mesh. Collective: every rank calls it."""
    sharded.require_device(device_type)
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call initialize_distributed first")
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    by_host: dict[str, list[int]] = {}
    for r, h in enumerate(hosts):
        by_host.setdefault(h, []).append(r)
    groups = list(by_host.values())
    if len({len(g) for g in groups}) != 1:
        groups = [list(range(len(hosts)))]
    return DeviceMesh(device_type, torch.tensor(groups, dtype=torch.int),
                      mesh_dim_names=("hosts", "chips"))


def flat_mesh_axis_order(mesh: DeviceMesh) -> tuple[str, ...]:
    return mesh.mesh_dim_names


def scaling_report(scene, camera, config, key, device_counts=None,
                   n_iters: int = 3) -> dict:
    """rays/s at several rank counts over the same frame → {count:
    rays_per_s}, plus 'efficiency' = rays/s(n_max) / (n_max/n_min ·
    rays/s(n_min)) when two or more counts ran. Count n renders on the
    first n ranks (a mesh over ranks[:n]) while the others wait at a
    barrier; counts above the world size are skipped. Every rank calls it
    and gets rank 0's report, which took part in every count. A world on
    one card measures the sharded program's cost, not scaling."""
    world = dist.get_world_size()
    device_type = key.device.type
    if device_counts is None:
        device_counts = sorted({1, world})
    out = {}
    for n in device_counts:
        if n > world:
            continue
        mesh = sharded.make_mesh(device_type, range(n))
        if mesh.get_coordinate() is not None:
            img = sharded.render_photon_sharded(scene, camera, config, key,
                                                mesh)
            _sync(img)
            t0 = time.perf_counter()
            for i in range(n_iters):
                img = sharded.render_photon_sharded(
                    scene, camera, config, prng.fold_in(key, i), mesh)
            _sync(img)
            out[n] = config.n_pixel_samples * n_iters / (
                time.perf_counter() - t0)
        dist.barrier()
    counts = sorted(out)
    if len(counts) >= 2 and out[counts[0]] > 0:
        n_max = counts[-1]
        out["efficiency"] = out[n_max] / (n_max / counts[0]
                                          * out[counts[0]])
    report = [out]
    dist.broadcast_object_list(report, src=0)
    return report[0]


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
