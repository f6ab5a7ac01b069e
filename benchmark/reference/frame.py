"""The photon-mapping frame, plainly: the same estimator, drawn from the
same key, as the program's `render_photon` — camera samples, specular
chains, direct light with shadow rays, a photon walk with Russian
roulette, an exact radius gather, the progressive update and the box
film — for a chosen set of pixels. Geometry comes from geometry.py; the
photon map is traced whole, since any path may light a chosen pixel."""
from __future__ import annotations

import math

import torch

from benchmark.reference import geometry as geo
from benchmark.reference import prng
from benchmark.reference.scene import GLASS, MATTE, MIRROR, POINT

INV_PI = 1.0 / math.pi
BIG = geo.BIG
HALTON = (2, 3, 5, 7, 11)
_Y = (0.212671, 0.715160, 0.072169)
_GATHER_PAIRS = 1 << 25


def _grid2(n: int):
    sx, sy = n, 1
    while sx > sy and (sx & 1) == 0:
        sx //= 2
        sy *= 2
    return sx, sy


def concentric(u1, u2):
    sx, sy = 2.0 * u1 - 1.0, 2.0 * u2 - 1.0
    r1 = (sx >= -sy) & (sx > sy)
    r2 = (sx >= -sy) & ~(sx > sy)
    r3 = ~(sx >= -sy) & (sx <= sy)
    r = torch.where(r1, sx, torch.where(r2, sy, torch.where(r3, -sx, -sy)))
    sr = torch.where(r == 0.0, torch.ones_like(r), r)
    th = torch.where(r1, torch.where(sy > 0.0, sy / sr, 8.0 + sy / sr),
                     torch.where(r2, 2.0 - sx / sr,
                                 torch.where(r3, 4.0 - sy / sr,
                                             6.0 + sx / sr))) * (math.pi / 4)
    deg = (sx == 0.0) & (sy == 0.0)
    z = torch.zeros_like(r)
    return (torch.where(deg, z, r * torch.cos(th)),
            torch.where(deg, z, r * torch.sin(th)))


def sphere_dir(u1, u2):
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def luminance(s):
    return torch.sum(s * torch.tensor(_Y, dtype=s.dtype, device=s.device), -1)


def is_black(s):
    return torch.all(s == 0.0, dim=-1)


def frame(ns, dpdu):
    nn = geo.normalize(ns)
    sn = geo.normalize(dpdu)
    return nn, sn, geo.cross(nn, sn)


def to_local(v, nn, sn, tn):
    return torch.stack([geo.dot(v, sn), geo.dot(v, tn), geo.dot(v, nn)], -1)


def to_world(v, nn, sn, tn):
    return sn * v[..., 0:1] + tn * v[..., 1:2] + nn * v[..., 2:3]


def lambert(sc, mat):
    """kd/π on matte hits, 0 elsewhere."""
    m = mat.clamp(min=0)
    kd = sc.kd[m]
    ok = (sc.mtype[m] == MATTE) & (mat >= 0)
    return torch.where(ok[:, None], kd * INV_PI, torch.zeros_like(kd))


def specular(sc, mat, ns, dpdu, wo_w):
    """Mirror reflection (× kd) or glass refraction (total internal
    reflection reflects) → (throughput, wi)."""
    nn, sn, tn = frame(ns, dpdu)
    wo = to_local(wo_w, nn, sn, tn)
    m = mat.clamp(min=0)
    mt, kr, eta_m = sc.mtype[m], sc.kd[m], sc.eta[m]
    mirror = torch.stack([-wo[:, 0], -wo[:, 1], wo[:, 2]], -1)
    cos_o = wo[:, 2]
    ent = cos_o > 0.0
    eta = torch.where(ent, 1.0 / eta_m, eta_m)
    sint2 = eta * eta * torch.clamp(1.0 - cos_o * cos_o, min=0.0)
    cost = torch.sqrt(torch.clamp(1.0 - sint2, min=0.0))
    cost = torch.where(ent, -cost, cost)
    refr = torch.stack([eta * -wo[:, 0], eta * -wo[:, 1], cost], -1)
    glass = torch.where((sint2 >= 1.0)[:, None], mirror, refr)
    is_m = (mt == MIRROR)[:, None]
    wi = torch.where(is_m, mirror, glass)
    thr = torch.where(is_m, kr, torch.ones_like(kr))
    return thr, to_world(wi, nn, sn, tn)


def is_spec(sc, mat):
    mt = sc.mtype[mat.clamp(min=0)]
    return ((mt == MIRROR) | (mt == GLASS)) & (mat >= 0)


def uniform_at(k, counts, dt):
    return prng.to_uniform(prng.bits_at(k, counts)).to(dt)


def camera_samples(sc, key, pix, spp, dt, jitter: bool = True):
    """Raster positions and ray differentials of every sample of the
    pixels `pix` → (global sample ids, o, d, rx_o, rx_d, ry_o, ry_d);
    without jitter each sample sits at the centre of its stratum."""
    cam, dev = sc.camera, sc.device
    w = cam["width"]
    sx, sy = _grid2(spp)
    s = torch.arange(spp, device=dev)
    e = (pix[:, None] * spp + s[None, :]).reshape(-1)
    si = e % spp
    px, py = (e // spp) % w, (e // spp) // w
    if jitter:
        kj = prng.split(key)[0]
        j0, j1 = uniform_at(kj, 2 * e, dt), uniform_at(kj, 2 * e + 1, dt)
    else:
        j0 = j1 = torch.full(e.shape, 0.5, dtype=dt, device=dev)
    ix = px.to(dt) + ((si % sx).to(dt) + j0) / sx
    iy = py.to(dt) + ((si // sx).to(dt) + j1) / sy
    n = e.shape[0]
    one = torch.ones(n, dtype=dt, device=dev)
    pr = torch.stack([ix, iy, torch.zeros_like(one), one], -1)
    ph = pr @ cam["r2c"].T
    pc = ph[:, :3] / ph[:, 3:4]
    rot, tr = cam["c2w"][:, :3], cam["c2w"][:, 3]
    d = geo.normalize(pc) @ rot.T
    rxd = geo.normalize(pc + cam["dx"]) @ rot.T
    ryd = geo.normalize(pc + cam["dy"]) @ rot.T
    o = tr.expand(n, 3)
    s_ = torch.tensor(1.0 / math.sqrt(spp), dtype=torch.float32).to(dt)
    return e, o, d, o, d + (rxd - d) * s_, o, d + (ryd - d) * s_


def camera_pass(sc, cfg, o, d, rx_o, rx_d, ry_o, ry_d):
    n, dev, dt = o.shape[0], sc.device, sc.dt
    z3 = lambda: torch.zeros((n, 3), dtype=dt, device=dev)
    rec = dict(status=torch.ones(n, dtype=torch.long, device=dev), p=z3(),
               ns=z3(), dpdu=z3(), direction=d.clone(),
               mat=torch.full((n,), -1, device=dev),
               light=torch.full((n,), -1, device=dev))
    atten = torch.ones((n, 3), dtype=dt, device=dev)
    fp = torch.zeros(n, dtype=dt, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    o, d = o.clone(), d.clone()
    eps = cfg["scene_epsilon"]
    for depth in range(cfg["max_specular_depth"] + 1):
        ln = active.nonzero()[:, 0]
        if ln.numel() == 0:
            break
        ol, dl = o[ln], d[ln]
        h = geo.closest(sc, ol, dl, torch.full((ln.numel(),), eps, dtype=dt,
                                               device=dev),
                        torch.full((ln.numel(),), BIG, dtype=dt, device=dev))
        if depth == 0:
            pa = rx_o + rx_d * h["t"][:, None]
            pb = ry_o + ry_d * h["t"][:, None]
            f = 0.5 * (geo.dot(pa - h["p"], pa - h["p"]).sqrt()
                       + geo.dot(pb - h["p"], pb - h["p"]).sqrt())
            fp = torch.where(h["valid"], f, 0.0)
        sp = h["valid"] & is_spec(sc, h["mat"])
        df = h["valid"] & ~sp
        dl_ = ln[df]
        rec["status"][dl_] = 0
        for k in ("p", "ns", "dpdu", "mat", "light"):
            rec[k][dl_] = h[k][df]
        rec["direction"][dl_] = dl[df]
        rec["status"][ln[~h["valid"]]] = 1
        thr, wi = specular(sc, h["mat"], h["ns"], h["dpdu"], -dl)
        sl = ln[sp]
        o[sl], d[sl] = h["p"][sp], wi[sp]
        atten[sl] = atten[sl] * thr[sp]
        active[ln] = sp
    rec["status"] = torch.where(active, 2, rec["status"])
    rec["atten"], rec["footprint"] = atten, fp
    rec["hit"] = rec["status"] == 0
    return rec


def direct_light(sc, cfg, rec, key, ids):
    """Emitted light on emitter hits plus each light's samples with their
    shadow rays."""
    dt, dev = sc.dt, sc.device
    n = ids.shape[0]
    hit = rec["hit"]
    L = torch.zeros((n, 3), dtype=dt, device=dev)
    li_ = rec["light"].clamp(min=0)
    if sc.lights:
        nrm = torch.stack([l["normal"] for l in sc.lights])[li_]
        inten = torch.stack([l["I"] for l in sc.lights])[li_]
        front = (geo.dot(nrm, -rec["direction"]) > 0.0) & (rec["light"] >= 0)
        L = L + torch.where(front[:, None], inten, 0.0)
    eps = cfg["shadow_epsilon"]
    tmin = torch.full((n,), eps, dtype=dt, device=dev)
    tmax = torch.full((n,), 1.0 - eps, dtype=dt, device=dev)
    for l in sc.lights:
        ns_i = min(l["n"], cfg["max_light_samples"])
        sx, sy = _grid2(ns_i)
        for s in range(ns_i):
            key, sub = prng.split(key)
            fk = prng.fold_in(sub, ids)[:, None, :]
            u = uniform_at(fk, torch.arange(2, device=dev)[None, :], dt)
            u = (u + torch.tensor([s % sx, s // sx], dtype=dt, device=dev)) \
                / torch.tensor([sx, sy], dtype=dt, device=dev)
            p = rec["p"]
            if l["type"] == POINT:
                uwi = l["o"] - p
                li = l["I"] * (1.0 / torch.clamp(geo.dot(uwi, uwi),
                                                 min=1e-20))[:, None]
                pdf = torch.ones(n, dtype=dt, device=dev)
            else:
                dx, dy = concentric(u[:, 0], u[:, 1])
                uwi = l["o"] + dx[:, None] * l["p1"] + dy[:, None] * l["p2"] - p
                wi = geo.normalize(uwi)
                cos_t = -geo.dot(l["normal"].expand_as(wi), wi)
                ca = cos_t * l["area"]
                pdf = geo.dot(uwi, uwi) / torch.where(ca == 0.0, 1e-20, ca)
                li = torch.where(cos_t[:, None] > 0.0, l["I"].expand(n, 3),
                                 0.0)
            shadow = geo.occluded(sc, p, uwi, tmin, tmax)
            wi = geo.normalize(uwi)
            fr = lambert(sc, rec["mat"])
            cos = geo.dot(rec["ns"], wi).abs()
            good = hit & ~shadow & (pdf > 0.0) & (geo.dot(li, li) > 0.0)
            c = cos[:, None] * fr * li * ((1.0 / ns_i)
                                          / torch.where(pdf == 0.0, 1.0,
                                                        pdf))[:, None]
            L = L + torch.where(good[:, None], c, 0.0)
    return torch.where(hit[:, None], L, 0.0)


def halton(n, perms, dt):
    """Permuted radical inverses of n in bases 2, 3, 5, 7 → [len(n), 4]."""
    out = []
    for i in range(4):
        b = HALTON[i]
        ib = torch.tensor(1.0 / b, dtype=torch.float32).to(dt)
        val = torch.zeros(n.shape, dtype=dt, device=n.device)
        f = torch.full(n.shape, float(ib), dtype=dt, device=n.device)
        rem = n.clone()
        for _ in range(int(math.ceil(32 / math.log2(b)))):
            dg = perms[i][rem % b].to(dt)
            val = val + torch.where(rem > 0, dg * f, torch.zeros_like(val))
            f = f * ib
            rem = rem // b
        out.append(val)
    return torch.stack(out, -1)


def photon_walk(sc, cfg, key, pass_idx, record: bool = False):
    """Every photon path of one wave → the deposits (p, alpha, wi) of the
    valid slots; with `record` also each deposit's chain (the material of
    every earlier bounce whose factor holds kd — diffuse continuations and
    mirrors — by walk step, −1 for none) and its light."""
    dt, dev = sc.dt, sc.device
    n = cfg["photon_paths"]
    depth = cfg["max_photon_depth"]
    k_perm, k_bounce = prng.split(prng.fold_in(key, pass_idx))
    perms = []
    kk = k_perm
    for b in HALTON:
        kk, sub = prng.split(kk)
        perms.append(prng.permutation(sub, b))
    gids = torch.arange(n, dtype=torch.int64, device=dev) & prng.MASK
    stride = depth if cfg.get("halton_stride_by_depth") else 1
    smp = halton((gids * stride) & prng.MASK, perms, dt)
    nl = len(sc.lights)
    lid = gids % nl if nl > 1 else torch.zeros_like(gids)
    scale = float(nl) if nl > 1 else 1.0
    o = torch.zeros((n, 3), dtype=dt, device=dev)
    d = torch.zeros_like(o)
    alpha = torch.zeros_like(o)
    pdf = torch.zeros(n, dtype=dt, device=dev)
    lit = torch.zeros(n, dtype=torch.bool, device=dev)
    for i, l in enumerate(sc.lights):
        m = lid == i
        u = smp[m]
        if l["type"] == POINT:
            dd = sphere_dir(u[:, 0], u[:, 1])
            le = l["I"].expand(dd.shape[0], 3) * scale
            pd = torch.full((dd.shape[0],), 1.0 / (4.0 * math.pi), dtype=dt,
                            device=dev)
            oo, nsl = l["o"].expand_as(dd), dd
        else:
            dx, dy = concentric(u[:, 0], u[:, 1])
            oo = l["o"] + dx[:, None] * l["p1"] + dy[:, None] * l["p2"]
            dd = sphere_dir(u[:, 2], u[:, 3])
            dd = torch.where((geo.dot(dd, l["normal"]) < 0.0)[:, None], -dd, dd)
            pd = torch.full((dd.shape[0],), 1.0 / (2.0 * math.pi), dtype=dt,
                            device=dev)
            le = (l["I"] * l["area"]).expand(dd.shape[0], 3) * scale
            nsl = l["normal"].expand_as(dd)
        o[m], d[m], pdf[m], lit[m] = oo, dd, pd, ~is_black(le)
        alpha[m] = (geo.dot(nsl, dd).abs()[:, None] * le
                    / torch.where(pd == 0.0, 1.0, pd)[:, None])
    alive = (pdf > 0.0) & lit
    n_int = torch.zeros(n, dtype=torch.int64, device=dev)
    dep_p, dep_a, dep_w, dep_c, dep_l = [], [], [], [], []
    steps = cfg["max_photon_bounces"]
    chain = (torch.full((n, steps), -1, dtype=torch.long, device=dev)
             if record else None)
    eps = cfg["scene_epsilon"]
    for it in range(steps):
        ln = alive.nonzero()[:, 0]
        if ln.numel() == 0:
            break
        fk = prng.fold_in(prng.fold_in(k_bounce, gids[ln]), n_int[ln])
        u = uniform_at(fk[:, None, :], torch.arange(3, device=dev)[None, :],
                       dt)
        ol, dl, al, nl_ = o[ln], d[ln], alpha[ln], n_int[ln]
        h = geo.closest(sc, ol, dl, torch.full((ln.numel(),), eps, dtype=dt,
                                               device=dev),
                        torch.full((ln.numel(),), BIG, dtype=dt, device=dev))
        sp = h["valid"] & is_spec(sc, h["mat"])
        df = h["valid"] & ~sp
        dep = df & (nl_ >= 1)
        dep_p.append(h["p"][dep]); dep_a.append(al[dep]); dep_w.append(-dl[dep])
        if record:
            dep_c.append(chain[ln[dep]])
            dep_l.append(lid[ln[dep]])
        thr, wi_s = specular(sc, h["mat"], h["ns"], h["dpdu"], -dl)
        cont = df & (nl_ < depth)
        nn, sn, tn = frame(h["ns"], h["dpdu"])
        wo = to_local(-dl, nn, sn, tn)
        cx, cy = concentric(u[:, 0], u[:, 1])
        cz = torch.sqrt(torch.clamp(1.0 - cx * cx - cy * cy, min=0.0))
        cz = torch.where(wo[:, 2] < 0.0, -cz, cz)
        wil = torch.stack([cx, cy, cz], -1)
        pdf_b = torch.where(wo[:, 2] * wil[:, 2] > 0.0, wil[:, 2].abs() * INV_PI,
                            0.0)
        fr = lambert(sc, h["mat"])
        wi_d = to_world(wil, nn, sn, tn)
        cont = cont & ~is_black(fr) & (pdf_b > 0.0)
        anew = (al * fr * geo.dot(wi_d, geo.normalize(h["ns"])).abs()[:, None]
                / torch.where(pdf_b == 0.0, 1.0, pdf_b)[:, None])
        if cfg.get("russian_roulette", True):
            yo, yn = luminance(al), luminance(anew)
            pc = torch.clamp(yn / torch.where(yo == 0.0, 1.0, yo), max=1.0)
            cont = cont & (u[:, 2] <= pc) & (pc > 0.0)
            anew = anew / torch.where(pc == 0.0, 1.0, pc)[:, None]
        nxt = sp | cont
        s3, c3 = sp[:, None], cont[:, None]
        o[ln] = torch.where(nxt[:, None], h["p"], ol)
        d[ln] = torch.where(s3, wi_s, torch.where(c3, wi_d, dl))
        a2 = torch.where(s3, al * thr, torch.where(c3, anew, al))
        alpha[ln] = a2
        n_int[ln] = torch.where(sp & (nl_ == 0), 1,
                                torch.where(cont, nl_ + 1, nl_))
        alive[ln] = nxt & ~is_black(a2)
        if record:
            kd_spec = sc.mtype[h["mat"].clamp(min=0)] == MIRROR
            app = alive[ln] & (cont | (sp & kd_spec))
            chain[ln[app], it] = h["mat"][app]
    out = (torch.cat(dep_p), torch.cat(dep_a), torch.cat(dep_w))
    if record:
        out = out + (torch.cat(dep_c), torch.cat(dep_l))
    return out


def pair_blocks(pp, q, r2, block_q: int = 1 << 20):
    """The (query, photon) pairs with |p − q|² < r², found through a
    uniform grid of cells, in blocks → iterator of (query rows, photon
    rows)."""
    dev = q.device
    live = (r2 > 0).nonzero()[:, 0]
    if live.numel() == 0 or pp.shape[0] == 0:
        return
    r = r2[live].double().sqrt()
    h = max(float(torch.quantile(r[:1 << 24], 0.9)), 1e-6)
    P = pp.double()
    lo = torch.minimum(P.amin(0), (q[live].double() - r[:, None]).amin(0)) - h
    hi = torch.maximum(P.amax(0), (q[live].double() + r[:, None]).amax(0)) + h
    dims = torch.ceil((hi - lo) / h).long() + 1
    cell = lambda x: torch.floor((x - lo) / h).long()
    key = lambda c: (c[..., 0] * dims[1] + c[..., 1]) * dims[2] + c[..., 2]
    pk = key(cell(P))
    order = torch.argsort(pk)
    pk = pk[order]
    for b0 in range(0, live.numel(), block_q):
        lq = live[b0:b0 + block_q]
        Q, rr = q[lq].double(), r[b0:b0 + block_q]
        c0, c1 = cell(Q - rr[:, None]), cell(Q + rr[:, None])
        span = c1 - c0 + 1
        ncell = span.prod(1)
        qi = torch.repeat_interleave(torch.arange(lq.numel(), device=dev),
                                     ncell)
        first = torch.cumsum(ncell, 0) - ncell
        k = torch.arange(qi.numel(), device=dev) - first[qi]
        sx, sy = span[qi, 0], span[qi, 1]
        cc = torch.stack([c0[qi, 0] + k % sx, c0[qi, 1] + (k // sx) % sy,
                          c0[qi, 2] + k // (sx * sy)], -1)
        ck = key(cc)
        beg = torch.searchsorted(pk, ck)
        cnt = torch.searchsorted(pk, ck, right=True) - beg
        keep = cnt > 0
        qi, beg, cnt = qi[keep], beg[keep], cnt[keep]
        if qi.numel() == 0:
            continue
        cum = torch.cumsum(cnt, 0)
        total = int(cum[-1])
        edges = torch.arange(_GATHER_PAIRS, max(total, _GATHER_PAIRS),
                             _GATHER_PAIRS, device=dev)
        cuts = [0] + (torch.searchsorted(cum, edges) + 1).tolist() + [qi.numel()]
        for a, b in zip(cuts[:-1], cuts[1:]):
            if a >= b:
                continue
            c = cnt[a:b]
            rows = torch.repeat_interleave(qi[a:b], c)
            off = torch.cumsum(c, 0) - c
            j = (torch.repeat_interleave(beg[a:b] - off, c)
                 + torch.arange(rows.numel(), device=dev))
            ql, pj = lq[rows], order[j]
            dv = q[ql] - pp[pj]
            ok = geo.dot(dv, dv) < r2[ql]
            yield ql[ok], pj[ok]


def gather(pp, pa, pw, q, r2, qns, acc_dt):
    """Exact radius search: per query Σ |n·wi|·alpha and the count over the
    photons with |p − q|² < r² → (S [Q, 3] in acc_dt, M [Q])."""
    S = torch.zeros((q.shape[0], 3), dtype=acc_dt, device=q.device)
    M = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    for ql, pj in pair_blocks(pp, q, r2):
        w = geo.dot(qns[ql], pw[pj]).abs()
        S.index_add_(0, ql, (w[:, None] * pa[pj]).to(acc_dt))
        M.index_add_(0, ql, torch.ones_like(ql))
    return S, M


def frame_keys(key, schedule: str):
    """(pixel, light and photon keys) of a frame's key: `single`, as
    render_photon splits it, or `sharded`, as render_photon_sharded does
    (the pixel key, then a render key whose fold by 1 splits in two)."""
    if schedule == "single":
        return tuple(prng.split(key, 3))
    k_pix, k_render = prng.split(key)
    return (k_pix,) + tuple(prng.split(prng.fold_in(k_render, 1)))


def render_pixels(sc, cfg: dict, seed_word: int, pix,
                  schedule: str = "single"):
    """The frame of key PRNGKey(seed_word) at the pixels `pix` (flat
    indices y·width + x) → float64 radiance [len(pix), 3], and the valid
    photons of the last wave."""
    dt, dev = sc.dt, sc.device
    acc_dt = torch.float64 if dt == torch.float32 else dt
    spp = cfg["spp"]
    k_pix, k_light, k_photon = frame_keys(prng.key(seed_word, dev), schedule)
    e, o, d, rxo, rxd, ryo, ryd = camera_samples(sc, k_pix, pix, spp, dt)
    rec = camera_pass(sc, cfg, o, d, rxo, rxd, ryo, ryd)
    direct = direct_light(sc, cfg, rec, k_light, e)
    hit = rec["hit"]
    r2 = torch.full_like(rec["footprint"], cfg["initial_radius2"])
    if cfg["footprint_radius_scale"] > 0.0:
        f = cfg["footprint_radius_scale"] * rec["footprint"]
        r2 = torch.where(rec["footprint"] > 0.0,
                         torch.clamp(f * f, cfg["min_radius2"],
                                     cfg["initial_radius2"]), r2)
    kd_pi = lambert(sc, rec["mat"])
    n = e.shape[0]
    count = torch.zeros(n, dtype=dt, device=dev)
    flux = torch.zeros((n, 3), dtype=acc_dt, device=dev)
    emitted = torch.zeros(n, dtype=acc_dt, device=dev)
    n_photons = 0
    for p in range(cfg["photon_passes"]):
        pp, pa, pw = photon_walk(sc, cfg, k_photon, p)
        n_photons = pp.shape[0]
        S, M = gather(pp, pa, pw, rec["p"], torch.where(hit, r2, 0.0),
                      rec["ns"], acc_dt)
        del pp, pa, pw
        idl = kd_pi.to(acc_dt) * S
        M = torch.where(hit, M, 0)
        mf = M.to(dt)
        new = count + cfg["ppm_alpha"] * mf
        den = count + mf
        ratio = new / torch.where(den == 0.0, 1.0, den)
        up = M > 0
        r2 = torch.where(up, r2 * ratio, r2)
        count = torch.where(up, new, count)
        flux = torch.where(up[:, None], (flux + idl) * ratio[:, None].to(acc_dt),
                           flux)
        emitted = emitted + cfg["photon_paths"]
    den = r2.to(acc_dt) * torch.clamp(emitted, min=1.0)
    have = (count != 0.0) & (emitted > 0.0)
    ind = torch.where(have[:, None], flux * INV_PI / den[:, None], 0.0)
    L = rec["atten"].to(acc_dt) * (direct.to(acc_dt) + ind)
    L = torch.where(hit[:, None], L, 0.0).double()
    y = luminance(L)
    bad = (torch.isnan(y) | torch.isinf(y) | (y < -1e-5)
           | torch.any(torch.isnan(L) | torch.isinf(L), dim=-1))
    L = torch.where(bad[:, None], 0.0, L)
    return L.reshape(-1, spp, 3).mean(dim=1), n_photons
