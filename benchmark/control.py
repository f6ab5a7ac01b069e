"""The readings that a cell's limits are set from, at the cell's own size
on the card: for each seed, the program's output (the sound reading), the
program with each planted fault (faults.py), and the control — the
reference itself put in the program's place and computed with TF32
matrix products, the precision below the configurations' float32 with
TF32 off — each compared with the float32 reference as the run's check
compares.

    python -m benchmark.control --workload field4m.frame --seeds 1 2 3

One JSON line a seed. The benchmark's own runs never run this."""
from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch

from benchmark import faults
from benchmark import frames as F
from benchmark import program, spec
from benchmark.entries import render_photon as RP


def step_readings(cell, seed: int, dev) -> dict:
    """The step cell's numbers (entries/fit_step.check_gaps) for the
    program's first three steps through the entry's own Fit, sound and
    with each fault planted, and for the reference with TF32 products in
    the program's place."""
    from benchmark.entries import fit_step as FS
    from benchmark.reference import grad as RG
    from benchmark.reference import scene as RS

    fit = FS.Fit(cell, seed, dev)

    def three():
        fit.restart()
        got = {}
        for i in range(FS.CHECKED_STEPS):
            fit.checked(i, fit.step(i), got)
        return got

    runs = {"program": three()}
    for name, fault in faults.FAULTS.items():
        with fault():
            runs[name] = three()
    fit.free_program()
    out = {name: {k: gp[k] for k in ("loss", "grad", "change")}
           for name, gp in ((n, fit.gaps(g)) for n, g in runs.items())}
    t = time.perf_counter()
    words = [F.word(seed, i) for i in range(FS.CHECKED_STEPS)]
    with tf32():
        cl, cg, cd = RG.steps(RS.build(fit.desc, dev), fit.render, words,
                              fit.kd0, fit.i0, fit.target, fit.lr)
    gp = fit.gaps({"losses": cl, "first": cg, "delta": cd})
    out["control_tf32"] = {k: gp[k] for k in ("loss", "grad", "change")}
    out["control_s"] = time.perf_counter() - t
    return out


@contextlib.contextmanager
def tf32():
    """Matrix products in TF32 (the control's precision)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def readings(cell, seed: int, dev) -> dict:
    """A frame cell's numbers for frame 0 of a run with this seed through
    the entry's own call, sound and with each fault planted, and for the
    reference with TF32 products in the program's place."""
    from benchmark.reference import frame as RF
    from benchmark.reference import scene as RS

    render = cell.config["render"]
    desc, call, _, _ = RP.setup(cell, seed, dev)
    w = F.word(seed, 0)
    _, pix = F.sample(seed, 1, render["width"] * render["height"],
                      int(cell.traffic["check_pixels"]))
    pix = torch.as_tensor(pix, device=dev)
    frame = lambda: call(0)[0].reshape(-1, 3)[pix].double()
    got = {"program": frame()}
    for name, fault in faults.FAULTS.items():
        with fault():
            got[name] = frame()
    del call
    F.free(dev)
    out = {}
    for name, g in got.items():
        out[name], _ = RP.compare(desc, render, w, pix, g, dev)
    t = time.perf_counter()
    with tf32():
        ctl, _ = RF.render_pixels(RS.build(desc, dev), render, w, pix)
    out["control_tf32"], _ = RP.compare(desc, render, w, pix, ctl, dev)
    out["control_s"] = time.perf_counter() - t
    return out


def control_only(cell, seed: int, dev) -> dict:
    """For a cell whose program spans several cards: the control alone, on
    one card (the sound readings come from the cell's own runs)."""
    from benchmark.reference import frame as RF
    from benchmark.reference import scene as RS

    render, scene_p = cell.config["render"], cell.config["scene"]
    desc = spec.load_module("scenes", scene_p["kind"], cell.root).describe(
        scene_p, seed & F.MASK, render["width"], render["height"])
    w = F.word(seed, 0)
    _, pix = F.sample(seed, 1, render["width"] * render["height"],
                      int(cell.traffic["check_pixels"]))
    pix = torch.as_tensor(pix, device=dev)
    t = time.perf_counter()
    with tf32():
        ctl, _ = RF.render_pixels(RS.build(desc, dev), render, w, pix,
                                  "sharded")
    s_ctl = time.perf_counter() - t
    rel, ref_s = RP.compare(desc, render, w, pix, ctl, dev,
                            schedule="sharded")
    return {"control_tf32": rel, "control_s": s_ctl, "reference_s": ref_s}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    cell = spec.load_cell(a.workload)
    dev = torch.device("cuda:0")
    for s in a.seeds:
        entry = cell.traffic["entry"]
        r = (step_readings(cell, s, dev) if entry == "fit_step"
             else control_only(cell, s, dev) if entry == "render_sharded"
             else readings(cell, s, dev))
        print(json.dumps(dict(workload=a.workload, seed=s, **r)), flush=True)


if __name__ == "__main__":
    main()
