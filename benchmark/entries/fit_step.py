"""One inverse-rendering step a call: an iteration of the program's
`diff/optim.py::fit` loop — `render_image_from_params` at the current
parameters, the MSE against the target, `backward` (record and replay,
K3), then Adam on the transformed parameters — with a new key each step.

Set-up makes the inputs from the seed (the starting kd and intensities,
perturbed from the scene's, and the target, the reference's frame at the
scene's own parameters), builds the step's one object (Fit) and warms it
up, then restarts it from the starting parameters with Adam's state
cleared. The window's first three steps are the checked ones: their
losses, the first gradient (from Adam's state after one step) and the
parameters' change after three are held against the reference's three
steps (reference/grad.py) once the window has closed."""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import frames as F
from benchmark import program, spec

CHECKED_STEPS = 3


def inputs(desc, seed: int, dev):
    """(kd0 [M, 3], intensity0 [L, 3], the scene's own kd and intensity):
    every matte kd scaled by U(0.6, 1.4) and clipped to [0.02, 0.98], every
    intensity channel scaled by U(0.6, 1.4), drawn from the seed."""
    rng = np.random.default_rng((seed & F.MASK) + 17)
    mats = list(desc["materials"].values())
    kd = np.array([m.get("kd", [1.0, 1.0, 1.0]) for m in mats], np.float32)
    matte = np.array([m["type"] == "matte" for m in mats])
    scale = rng.uniform(0.6, 1.4, kd.shape).astype(np.float32)
    kd0 = np.where(matte[:, None], np.clip(kd * scale, 0.02, 0.98), kd)
    inten = np.array([l.get("emit", l.get("intensity")) for l in desc["lights"]],
                     np.float32)
    i0 = inten * rng.uniform(0.6, 1.4, inten.shape).astype(np.float32)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return t(kd0), t(i0), t(kd), t(inten)


class Fit:
    """The step's one object: the program's scene, camera and lights, the
    target, the transformed leaves and their Adam optimizer. `step(i)` is
    one iteration of fit's loop with the key of call i of a run with this
    seed; `restart()` puts the leaves back to the start and clears Adam's
    state, as a fresh optimizer has it."""

    def __init__(self, cell, seed: int, dev):
        from raytrace_tpu_torch.diff import optim
        from raytrace_tpu_torch.diff.render import SceneParams
        from raytrace_tpu_torch.renderers import common

        from benchmark.reference import grad as RG
        from benchmark.reference import scene as RS

        render, scene_p = cell.config["render"], cell.config["scene"]
        self.seed, self.dev, self.render = seed, dev, render
        self.lr = float(cell.traffic["lr"])
        self.desc = spec.load_module("scenes", scene_p["kind"],
                                     cell.root).describe(
            scene_p, seed & F.MASK, render["width"], render["height"])
        n_tris = sum(len(m["idx"]) for m in self.desc["meshes"])
        self.build_s = (F.build_kernels(
            cell.config["kernels"] + ["rowspan_gather_bwd"],
            host=n_tris >= 512) if dev.type == "cuda" else 0.0)
        self.kd0, self.i0, kd_true, i_true = inputs(self.desc, seed, dev)
        with torch.no_grad():
            self.target = RG.image(RS.build(self.desc, dev), render,
                                   F.word(seed, -100), kd_true,
                                   i_true).float()
        F.free(dev)
        self.scene, self.cam = program.build_scene(self.desc, dev)
        self.rcfg = program.render_config(render, differentiable=True)
        self.lights = common.static_light_samples(self.scene, self.rcfg)
        tr0 = optim.to_transformed(SceneParams(kd=self.kd0,
                                               intensity=self.i0))
        self.start = [tr0.kd_logit.detach().clone(),
                      tr0.log_intensity.detach().clone()]
        self.leaves = [x.clone().requires_grad_(True) for x in self.start]
        self.opt = torch.optim.Adam(self.leaves, lr=self.lr)

    def step(self, i: int):
        from raytrace_tpu_torch.core import prng
        from raytrace_tpu_torch.diff import optim
        from raytrace_tpu_torch.diff.render import render_image_from_params

        self.opt.zero_grad(set_to_none=True)
        img = render_image_from_params(
            optim.from_transformed(optim.TransformedParams(*self.leaves)),
            self.scene, self.cam, self.rcfg,
            prng.PRNGKey(F.word(self.seed, i), self.dev), self.lights,
            jitter=False)
        loss = torch.mean((img - self.target) ** 2)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def restart(self):
        with torch.no_grad():
            for x, s in zip(self.leaves, self.start):
                x.copy_(s)
        self.opt.state.clear()

    def first_gradient(self) -> list:
        """The gradient of the first step as Adam's state holds it after
        that step (an optimizer that kept no state got nothing)."""
        from benchmark.reference import grad as RG

        return [self.opt.state.get(x, {}).get("exp_avg", torch.zeros_like(x))
                .clone() / (1 - RG.BETA1) for x in self.leaves]

    def change(self) -> list:
        return [x.detach() - s for x, s in zip(self.leaves, self.start)]

    def checked(self, i: int, loss, got: dict):
        """Record what the check needs after step i of the run (0-based)."""
        if i < CHECKED_STEPS:
            got.setdefault("losses", []).append(loss)
        if i == 0:
            got["first"] = self.first_gradient()
        if i == CHECKED_STEPS - 1:
            got["delta"] = self.change()

    def gaps(self, got: dict, dt=torch.float32) -> dict:
        words = [F.word(self.seed, i) for i in range(CHECKED_STEPS)]
        return check_gaps(self.desc, self.render, words, self.kd0, self.i0,
                          self.target, self.lr,
                          [float(x) for x in got["losses"]], got["first"],
                          got["delta"], self.dev, dt)

    def free_program(self):
        """Drop the program's state; what the check needs stays."""
        del self.scene, self.cam, self.lights, self.opt
        F.free(self.dev)


def run(cell, args, t0: float, device: str = "cuda") -> dict:
    traffic = cell.traffic
    dev = torch.device("cuda:0" if device == "cuda" else device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    fit = Fit(cell, args.seed, dev)
    for i in range(int(traffic["warmup"])):
        fit.step(-1 - i)
    fit.restart()
    F.sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t0
    got = {}

    def call(i):
        loss = fit.step(i)
        fit.checked(i, loss, got)
        return loss

    tr = None
    if args.trace:
        outs, tr = F.traced(call, int(traffic["trace_calls"]), dev)
        metrics = F.per_layer(cell, tr)
    else:
        outs, walls, win = F.window(call, args.seconds, dev)
        metrics = {"step_s": {"value": win / len(outs), "unit": "s/step"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    peak = F.peak_bytes(dev)
    # a window shorter than the checked steps: the rest run after it
    extra = [call(i) for i in range(len(outs) + (tr is not None),
                                    CHECKED_STEPS)]
    bad = sum(1 for x in outs + extra if not bool(torch.isfinite(x)))
    result = dict(
        attempted=len(outs), failed=bad, metrics=metrics,
        device=F.device_info(cell, dev, peak, tr),
        info=dict(workload=cell.name, seed=args.seed, steps=len(outs),
                  kernel_build_s=fit.build_s, setup_s=setup_s,
                  memory_peak_bytes=peak,
                  losses=[float(x) for x in got["losses"]]))
    if tr is not None:
        result["breakdown"] = tr.breakdown()
    del outs, extra, tr, call
    fit.free_program()
    t = time.perf_counter()
    gaps = fit.gaps(got)
    result["info"]["reference_s"] = time.perf_counter() - t
    lim = cell.limits
    result["checks"] = {
        **F.check_entry("loss_gap", gaps["loss"], lim["loss_gap"]),
        **F.check_entry("grad_gap", gaps["grad"], lim["grad_gap"]),
        **F.check_entry("change_gap", gaps["change"], lim["change_gap"]),
        **F.check_entry("nonfinite", bad, 0, exact=True)}
    return result


def check_gaps(desc, render, words, kd0, i0, target, lr, losses, first,
               delta, dev, dt=torch.float32) -> dict:
    """The program's three steps against the reference's: the largest
    relative gap of the losses, and by the worst leaf the gaps of the
    first gradient's and of the parameters' change's norms. Leaves whose
    reference gradient is under a thousandth of the median leaf's are left
    out (their change is round-off)."""
    from benchmark.reference import grad as RG
    from benchmark.reference import scene as RS

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rl, rg, rd = RG.steps(RS.build(desc, dev, dt=dt), render, words,
                              kd0, i0, target, lr)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    norms = [float(torch.linalg.vector_norm(g.double())) for g in rg]
    med = float(np.median(norms))
    keep = [i for i, n in enumerate(norms) if n >= 1e-3 * med]
    pick = lambda xs: [xs[i] for i in keep]
    return dict(
        loss=max(abs(a - b) / max(abs(b), 1e-300) for a, b in zip(losses, rl)),
        grad=max(RG.leaf_gaps(pick(first), pick(rg))),
        change=max(RG.leaf_gaps(pick(delta), pick(rd))),
        reference_losses=rl)
