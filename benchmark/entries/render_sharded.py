"""One sharded photon-mapping frame a call on every card of the cell: the
program's `parallel/sharded.py::render_photon_sharded` on one process a
rank over torch.distributed (NCCL on the cards, gloo on the CPU), a new
key each frame. Each rank renders its contiguous quarter of the pixel
samples and traces its quarter of the global photon path ids; the photon
map and the radiance are all-gathered. Rank 0 times the window, takes the
trace and, once the program's state is freed on every rank, checks the
frame it drew against the plain reference (the frame's key schedule of
render_photon_sharded, every path of the frame). Each rank lists the
JAX modules it holds once the window has closed (run.forbidden_modules),
and the run prints no result where any rank holds one."""
from __future__ import annotations

import json
import os
import socket
import tempfile
import time

import torch

from benchmark import frames as F
from benchmark import program, spec


def run(cell, args, t0: float, device: str = "cuda") -> dict:
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(cell, args, t0, device, port, tmp),
                           nprocs=cell.chips, start_method="spawn")
        with open(os.path.join(tmp, "result.json")) as f:
            result = json.load(f)
        loaded = set()
        for r in range(cell.chips):
            with open(os.path.join(tmp, f"modules.{r}.json")) as f:
                loaded.update(f"rank {r}: {m}" for m in json.load(f))
        result["forbidden"] = sorted(loaded)
        return result


def _rank(rank: int, cell, args, t0: float, device: str, port: int,
          out_dir: str) -> None:
    import torch.distributed as dist

    world = cell.chips
    cuda = device == "cuda"
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            device_id=dev if cuda else None)
    from benchmark import faults

    from benchmark.run import forbidden_modules

    try:
        # `plant` names a fault of faults.py: the CPU tests' way into the
        # ranks' processes; no cell's traffic file sets it
        with faults.planted(cell.traffic.get("plant")):
            result = _render(rank, cell, args, t0, dev)
            loaded = forbidden_modules()  # this rank's, the window closed
        with open(os.path.join(out_dir, f"modules.{rank}.json"), "w") as f:
            json.dump(loaded, f)
        if rank == 0:
            with open(os.path.join(out_dir, "result.json"), "w") as f:
                json.dump(result, f)
    finally:
        dist.destroy_process_group()


def _render(rank: int, cell, args, t0: float, dev) -> dict | None:
    import torch.distributed as dist

    from raytrace_tpu_torch.core import prng
    from raytrace_tpu_torch.parallel import sharded

    conf, traffic = cell.config, cell.traffic
    render, scene_p = conf["render"], conf["scene"]
    desc = spec.load_module("scenes", scene_p["kind"], cell.root).describe(
        scene_p, args.seed & F.MASK, render["width"], render["height"])
    n_tris = sum(len(m["idx"]) for m in desc["meshes"])
    build_s = 0.0
    if dev.type == "cuda" and rank == 0:  # one build, then every rank loads
        build_s = F.build_kernels(conf["kernels"], host=n_tris >= 512)
    dist.barrier()
    scene, cam = program.build_scene(desc, dev)
    rcfg = program.render_config(render)
    mesh = sharded.make_mesh(dev.type)

    def call(i):
        key = prng.PRNGKey(F.word(args.seed, i), dev)
        return sharded.render_photon_sharded(scene, cam, rcfg, key, mesh,
                                             return_aux=True)

    for i in range(int(traffic["warmup"])):
        call(-1 - i)
    F.sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    dist.barrier()
    setup_s = time.perf_counter() - t0
    tr = None
    if args.trace:
        n = int(traffic["trace_calls"])
        if rank == 0:
            outs, tr = F.traced(call, n, dev)
        else:  # the same calls: the n traced ones and the one more
            outs = [call(i) for i in range(n)]
            call(n)
        metrics = F.per_layer(cell, tr) if rank == 0 else {}
    else:
        outs, walls = [], []
        flag = torch.ones(1, dtype=torch.int32, device=dev)
        start = time.perf_counter()
        end = start
        while True:
            flag.fill_(int(end - start < args.seconds))
            dist.broadcast(flag, 0)  # rank 0's clock ends the window
            if not int(flag):
                break
            a = time.perf_counter()
            outs.append(call(len(outs)))
            F.sync(dev)
            end = time.perf_counter()
            walls.append(end - a)
        win = end - start
        metrics = {"sharded_frame_s": {"value": win / len(outs),
                                       "unit": "s/frame"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    peak = torch.tensor([F.peak_bytes(dev)], dtype=torch.int64, device=dev)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)  # the fullest card's peak
    imgs = [o[0] for o in outs]
    ovf = [o[1]["gather_overflow"] + o[1]["pair_overflow"] for o in outs]
    bad = [int((~torch.isfinite(im)).sum()) for im in imgs]
    w, h = render["width"], render["height"]
    j, pix = F.sample(args.seed, len(imgs), w * h,
                      int(traffic["check_pixels"]))
    pix_t = torch.as_tensor(pix, device=dev)
    got = imgs[j].reshape(-1, 3)[pix_t].double()
    result = None
    if rank == 0:
        result = dict(
            attempted=len(imgs),
            failed=sum(1 for o, b in zip(ovf, bad) if o or b),
            metrics=metrics,
            device=F.device_info(cell, dev, int(peak), tr),
            info=dict(workload=cell.name, seed=args.seed, frames=len(imgs),
                      ranks=cell.chips, kernel_build_s=build_s,
                      setup_s=setup_s, memory_peak_bytes=int(peak)))
        if tr is not None:
            result["breakdown"] = tr.breakdown()
    del outs, imgs, scene, cam, tr
    F.free(dev)
    dist.barrier()  # every rank's program state is freed
    if rank == 0:
        from benchmark.entries import render_photon as RP

        rel, ref_s = RP.compare(desc, render, F.word(args.seed, j), pix_t,
                                got, dev, schedule="sharded")
        result["info"]["reference_s"] = ref_s
        result["checks"] = {
            **F.check_entry("rel_l1", rel, cell.limits["rel_l1"]),
            **F.check_entry("overflow", sum(ovf), 0, exact=True),
            **F.check_entry("nonfinite", sum(bad), 0, exact=True)}
    dist.barrier()
    return result
