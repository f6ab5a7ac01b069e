"""Start a world of ranks on one machine: `run_world` spawns one process per
rank with torch.multiprocessing (spawn), joins each to a process group on a
file:// rendezvous (gloo for the CPU, NCCL for the cards, rank r on card r)
and returns each rank's result. parallel/dryrun.py, chip_smoke.py and the
tests start their worlds through it.

The function a rank runs is pickled by its import path, so it lives at the
top level of an importable module; its result crosses back through
torch.save / torch.load (tensors, numbers, strings, lists and dicts).
"""
from __future__ import annotations

import os
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from raytrace_tpu_torch.parallel.sharded import require_device


def _result_path(workdir: str, rank: int) -> Path:
    return Path(workdir) / f"rank{rank}.pt"


def _child(rank: int, fn, args: tuple, workdir: str, threads: int) -> None:
    torch.set_num_threads(threads)
    result = fn(rank, *args)
    torch.save(result, _result_path(workdir, rank))


def spawn(fn, nprocs: int, args: tuple = (), threads: int = 1) -> list:
    """fn(rank, *args) in `nprocs` spawned processes, each with `threads`
    intra-op threads → their results, by rank. A failed rank raises here
    (torch.multiprocessing's ProcessRaisedException, with its traceback)."""
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_child, args=(fn, args, tmp, threads),
                           nprocs=nprocs, start_method="spawn")
        return [torch.load(_result_path(tmp, r), weights_only=True)
                for r in range(nprocs)]


def _in_group(rank: int, fn, world_size: int, device_type: str,
              store: str, args: tuple):
    cuda = device_type == "cuda"
    device = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"file://{store}",
                            world_size=world_size, rank=rank,
                            device_id=device if cuda else None)
    try:
        return fn(rank, world_size, device, *args)
    finally:
        dist.destroy_process_group()


def run_world(fn, world_size: int, device_type: str, args: tuple = (),
              threads: int = 1) -> list:
    """fn(rank, world_size, device, *args) on every rank of a new process
    group of `world_size` processes → their results, by rank. device_type
    'cuda' needs a card for each rank."""
    require_device(device_type)
    if device_type == "cuda" and world_size > torch.cuda.device_count():
        raise RuntimeError(f"need {world_size} CUDA devices, found "
                           f"{torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as tmp:
        return spawn(_in_group, world_size,
                     (fn, world_size, device_type,
                      os.path.join(tmp, "store"), args),
                     threads=threads)
