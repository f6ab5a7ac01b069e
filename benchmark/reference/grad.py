"""The gradient step, plainly: the frame of reference/frame.py over the
whole image as a function of the scene's parameters (kd [M, 3], the light
intensities [L, 3]), its MSE against a target, the gradient, and Adam on
the transformed parameters (kd through a logit, intensities through a
log), as torch.optim.Adam's defaults define it.

The estimator is the program's: hit geometry, the photon walk and its
Russian roulette are sampled without gradient, and a photon's flux
carries the gradient of value · N / N₀, N = Le[light] · Π kd[chain]
(record and replay); the radius statistics take none."""
from __future__ import annotations


import torch

from benchmark.reference import frame as RF
from benchmark.reference import geometry as geo
from benchmark.reference import prng

EPS = 1e-6
BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-8


class _Gather(torch.autograd.Function):
    """S = Σ_pairs |n·wi| alpha_p per query, linear in alpha; the pairs are
    found again for the backward."""

    @staticmethod
    def forward(ctx, alpha, pp, pw, q, r2, qns):
        S = torch.zeros((q.shape[0], 3), dtype=alpha.dtype, device=q.device)
        M = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
        for ql, pj in RF.pair_blocks(pp, q, r2):
            w = geo.dot(qns[ql], pw[pj]).abs().to(alpha.dtype)
            S.index_add_(0, ql, w[:, None] * alpha[pj])
            M.index_add_(0, ql, torch.ones_like(ql))
        ctx.save_for_backward(pp, pw, q, r2, qns)
        ctx.mark_non_differentiable(M)
        return S, M

    @staticmethod
    def backward(ctx, gS, gM):
        pp, pw, q, r2, qns = ctx.saved_tensors
        ga = torch.zeros((pp.shape[0], 3), dtype=gS.dtype, device=gS.device)
        for ql, pj in RF.pair_blocks(pp, q, r2):
            w = geo.dot(qns[ql], pw[pj]).abs().to(gS.dtype)
            ga.index_add_(0, pj, w[:, None] * gS[ql])
        return ga, None, None, None, None, None


def image(sc, cfg: dict, seed_word: int, kd, inten, jitter: bool = False):
    """The whole frame [H, W, 3] (float64 for a float32 reference) at the
    parameters (kd, inten), differentiable in both."""
    dt, dev = sc.dt, sc.device
    acc = torch.float64 if dt == torch.float32 else dt
    w, h, spp = cfg["width"], cfg["height"], cfg["spp"]
    sc.kd = kd.to(dt)
    for i, l in enumerate(sc.lights):
        l["I"] = inten[i].to(dt)
    k_pix, k_light, k_photon = prng.split(prng.key(seed_word, dev), 3)
    pix = torch.arange(w * h, device=dev)
    with torch.no_grad():
        e, o, d, rxo, rxd, ryo, ryd = RF.camera_samples(sc, k_pix, pix, spp,
                                                        dt, jitter)
    rec = RF.camera_pass(sc, cfg, o, d, rxo, rxd, ryo, ryd)
    direct = RF.direct_light(sc, cfg, rec, k_light, e)
    hit = rec["hit"]
    r2 = torch.full_like(rec["footprint"], cfg["initial_radius2"])
    if cfg["footprint_radius_scale"] > 0.0:
        f = cfg["footprint_radius_scale"] * rec["footprint"]
        r2 = torch.where(rec["footprint"] > 0.0,
                         torch.clamp(f * f, cfg["min_radius2"],
                                     cfg["initial_radius2"]), r2)
    r2 = r2.detach()
    kd_pi = RF.lambert(sc, rec["mat"])
    n = e.shape[0]
    count = torch.zeros(n, dtype=dt, device=dev)
    flux = torch.zeros((n, 3), dtype=acc, device=dev)
    emitted = torch.zeros(n, dtype=acc, device=dev)
    for p in range(cfg["photon_passes"]):
        with torch.no_grad():
            pp, pa, pw, chain, light = RF.photon_walk(sc, cfg, k_photon, p,
                                                      record=True)
        # N = Le[light] · Π kd[chain]; the flux is value · N / sg(N)
        N = torch.stack([l["I"] for l in sc.lights])[light].to(acc)
        for j in range(chain.shape[1]):
            m = chain[:, j]
            N = N * torch.where((m >= 0)[:, None], sc.kd[m.clamp(min=0)].to(acc),
                                1.0)
        Ns = N.detach()
        ratio = torch.where(Ns != 0.0, pa.to(acc) / torch.where(Ns == 0.0, 1.0,
                                                                 Ns), 0.0)
        alpha = pa.to(acc) + (N - Ns) * ratio
        S, M = _Gather.apply(alpha, pp, pw, rec["p"].detach(),
                             torch.where(hit, r2, 0.0), rec["ns"].detach())
        idl = kd_pi.to(acc) * S
        M = torch.where(hit, M, 0)
        mf = M.to(dt)
        new = count + cfg["ppm_alpha"] * mf
        den = count + mf
        rat = (new / torch.where(den == 0.0, 1.0, den)).detach()
        up = M > 0
        r2 = torch.where(up, r2 * rat, r2)
        count = torch.where(up, new, count)
        flux = torch.where(up[:, None], (flux + idl) * rat[:, None].to(acc),
                           flux)
        emitted = emitted + cfg["photon_paths"]
    den = r2.to(acc) * torch.clamp(emitted, min=1.0)
    have = (count != 0.0) & (emitted > 0.0)
    ind = torch.where(have[:, None], flux * RF.INV_PI / den[:, None], 0.0)
    L = rec["atten"].to(acc) * (direct.to(acc) + ind)
    L = torch.where(hit[:, None], L, 0.0)
    y = RF.luminance(L.detach())
    bad = (torch.isnan(y) | torch.isinf(y) | (y < -1e-5)
           | torch.any(torch.isnan(L) | torch.isinf(L), dim=-1))
    L = torch.where(bad[:, None], 0.0, L)
    return L.reshape(h, w, spp, 3).mean(dim=2)


def transformed(kd, inten):
    kd = torch.clamp(kd, EPS, 1.0 - EPS)
    return (torch.log(kd) - torch.log1p(-kd),
            torch.log(torch.clamp(inten, min=EPS)))


def steps(sc, cfg: dict, words, kd0, inten0, target, lr: float,
          jitter: bool = False):
    """Adam from (kd0, inten0) over one step a key word → (losses, the
    first step's gradient of each transformed leaf, each leaf's change
    after the last step)."""
    acc = torch.float64 if sc.dt == torch.float32 else sc.dt
    t = [x.detach().to(acc)
         for x in transformed(kd0.float(), inten0.float())]
    start = [x.clone() for x in t]
    m = [torch.zeros_like(x) for x in t]
    v = [torch.zeros_like(x) for x in t]
    losses, first = [], None
    for k, word in enumerate(words, start=1):
        leaves = [x.clone().requires_grad_(True) for x in t]
        img = image(sc, cfg, word, torch.sigmoid(leaves[0]),
                    torch.exp(leaves[1]), jitter)
        loss = torch.mean((img - target.to(img.dtype)) ** 2)
        g = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        if first is None:
            first = [x.detach() for x in g]
        with torch.no_grad():
            for i in range(len(t)):
                m[i] = BETA1 * m[i] + (1 - BETA1) * g[i]
                v[i] = BETA2 * v[i] + (1 - BETA2) * g[i] * g[i]
                mh = m[i] / (1 - BETA1 ** k)
                vh = v[i] / (1 - BETA2 ** k)
                t[i] = t[i] - lr * mh / (torch.sqrt(vh) + ADAM_EPS)
    return losses, first, [a - b for a, b in zip(t, start)]


def leaf_gaps(prog, ref) -> list:
    """Per leaf |‖prog‖ − ‖ref‖| ÷ max(‖ref‖, the median leaf's ‖ref‖)."""
    norms = [float(torch.linalg.vector_norm(r.double())) for r in ref]
    med = sorted(norms)[len(norms) // 2] if len(norms) % 2 else \
        0.5 * sum(sorted(norms)[len(norms) // 2 - 1:len(norms) // 2 + 1])
    return [abs(float(torch.linalg.vector_norm(p.double())) - n)
            / max(n, med, 1e-300) for p, n in zip(prog, norms)]
