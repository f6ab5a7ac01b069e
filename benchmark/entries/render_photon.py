"""One progressive photon-mapping frame a call: the program's
`renderers/photon.py::render_photon`, a new key each frame. The check
renders the same frame's pixels, a sample drawn from the seed, through
the plain reference (reference/frame.py) and compares."""
from __future__ import annotations

import time

import torch

from benchmark import frames as F
from benchmark import program, spec


def setup(cell, seed: int, dev):
    """The cell's scene from the seed, the kernels built and the program's
    scene, camera and RenderConfig → (description, the window's call, the
    kernel build's seconds, the scene build's seconds). Call i renders
    frame i of a run with this seed (i < 0: warm-up frames)."""
    from raytrace_tpu_torch.core import prng
    from raytrace_tpu_torch.renderers import photon

    render, scene_p = cell.config["render"], cell.config["scene"]
    desc = spec.load_module("scenes", scene_p["kind"], cell.root).describe(
        scene_p, seed & F.MASK, render["width"], render["height"])
    n_tris = sum(len(m["idx"]) for m in desc["meshes"])
    build_s = (F.build_kernels(cell.config["kernels"], host=n_tris >= 512)
               if dev.type == "cuda" else 0.0)
    t = time.perf_counter()
    scene, cam = program.build_scene(desc, dev)
    scene_s = time.perf_counter() - t
    rcfg = program.render_config(render)

    def call(i):
        key = prng.PRNGKey(F.word(seed, i), dev)
        return photon.render_photon(scene, cam, rcfg, key, return_aux=True)

    return desc, call, build_s, scene_s


def run(cell, args, t0: float, device: str = "cuda") -> dict:
    traffic, render = cell.traffic, cell.config["render"]
    dev = torch.device("cuda:0" if device == "cuda" else device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    desc, call, build_s, scene_s = setup(cell, args.seed, dev)
    for i in range(int(traffic["warmup"])):
        call(-1 - i)
    F.sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t0
    tr = None
    if args.trace:
        outs, tr = F.traced(call, int(traffic["trace_calls"]), dev)
        metrics = F.per_layer(cell, tr)
    else:
        outs, walls, win = F.window(call, args.seconds, dev)
        metrics = {"frame_s": {"value": win / len(outs), "unit": "s/frame"},
                   "frame_p90_s": {"value": F.p90(walls) if len(walls) > 1
                                   else walls[0], "unit": "s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    peak = F.peak_bytes(dev)
    imgs = [o[0] for o in outs]
    ovf = [int(o[1]["gather_overflow"]) + int(o[1]["pair_overflow"])
           for o in outs]
    bad = [int((~torch.isfinite(im)).sum()) for im in imgs]
    w, h = render["width"], render["height"]
    j, pix = F.sample(args.seed, len(imgs), w * h, int(traffic["check_pixels"]))
    pix_t = torch.as_tensor(pix, device=dev)
    got = imgs[j].reshape(-1, 3)[pix_t].double()
    result = dict(
        attempted=len(imgs),
        failed=sum(1 for o, b in zip(ovf, bad) if o or b),
        metrics=metrics, device=F.device_info(cell, dev, peak, tr),
        info=dict(workload=cell.name, seed=args.seed, frames=len(imgs),
                  kernel_build_s=build_s, scene_build_s=scene_s,
                  setup_s=setup_s, memory_peak_bytes=peak))
    if tr is not None:
        result["breakdown"] = tr.breakdown()
    del outs, imgs, call, tr
    F.free(dev)
    rel, ref_s = compare(desc, render, F.word(args.seed, j), pix_t, got,
                         dev)
    result["info"]["reference_s"] = ref_s
    lim = cell.limits
    result["checks"] = {
        **F.check_entry("rel_l1", rel, lim["rel_l1"]),
        **F.check_entry("overflow", sum(ovf), 0, exact=True),
        **F.check_entry("nonfinite", sum(bad), 0, exact=True)}
    return result


def compare(desc, render, seed_word, pix, got, dev, dt=torch.float32,
            schedule: str = "single"):
    """Relative L1 distance of `got` from the reference's pixels (the
    frame's keys split as `schedule` says, reference/frame.py frame_keys)
    → (the distance, the reference's seconds)."""
    from benchmark.reference import frame as RF
    from benchmark.reference import scene as RS

    t = time.perf_counter()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            ref, _ = RF.render_pixels(RS.build(desc, dev, dt=dt), render,
                                      seed_word, pix, schedule)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    F.sync(dev)
    rel = float((got - ref).abs().sum() / ref.abs().sum().clamp(min=1e-30))
    return rel, time.perf_counter() - t
