"""Closest-hit and any-hit ray casts for the reference: Möller–Trumbore
against every triangle (few triangles) or the triangles of the cells of a
uniform xy grid that the ray crosses (many), spheres and disks in closed
form. Families combine with the first family winning ties (triangles,
spheres, disks)."""
from __future__ import annotations

import math

import torch

BIG = 1e30
_PAIRS = 1 << 23  # ray-triangle pairs a block


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def normalize(v):
    return v * torch.reciprocal(torch.sqrt(dot(v, v) + 1e-20))[..., None]


def mt_pairs(o, d, tmin, tmax, v0, v1, v2):
    """Möller–Trumbore for matching rows of rays and triangles → t, BIG
    where the test fails."""
    e1, e2 = v1 - v0, v2 - v0
    p = cross(d, e2)
    det = dot(e1, p)
    inv = torch.where(det != 0.0, 1.0 / torch.where(det == 0.0, 1.0, det),
                      0.0)
    tv = o - v0
    beta = dot(tv, p) * inv
    q = cross(tv, e1)
    gamma = dot(d, q) * inv
    t = dot(e2, q) * inv
    ok = ((det != 0.0) & (beta >= 0.0) & (gamma >= 0.0)
          & (beta + gamma <= 1.0) & (t > tmin) & (t < tmax))
    return torch.where(ok, t, BIG)


def _best(rows, t, tri, n, dt, device):
    """Per ray the least t over its (row, t, triangle) pairs, the lowest
    triangle index among equal t → (t [n], idx [n])."""
    best = torch.full((n,), BIG, dtype=dt, device=device)
    best.scatter_reduce_(0, rows, t, "amin")
    at = (t == best[rows]) & (t < BIG)
    idx = torch.full((n,), -1, dtype=torch.long, device=device)
    big_i = torch.iinfo(torch.long).max
    cand = torch.where(at, tri, big_i)
    idx.scatter_reduce_(0, rows, cand, "amin", include_self=False)
    idx = torch.where(best < BIG, idx, -1)
    return best, idx


def _tris_brute(sc, o, d, tmin, tmax):
    tr = sc.tri
    n, nt = o.shape[0], tr["v0"].shape[0]
    t = torch.full((n,), BIG, dtype=sc.dt, device=o.device)
    idx = torch.full((n,), -1, dtype=torch.long, device=o.device)
    step = max(1, _PAIRS // max(nt, 1))
    for r0 in range(0, n, step):
        s = slice(r0, r0 + step)
        m = o[s].shape[0]
        tc = mt_pairs(o[s, None], d[s, None], tmin[s, None], tmax[s, None],
                      tr["v0"][None], tr["v1"][None], tr["v2"][None])
        j = torch.argmin(tc, dim=1)
        tj = tc[torch.arange(m, device=o.device), j]
        t[s] = tj
        idx[s] = torch.where(tj < BIG, j, -1)
    return t, idx


class TriGrid:
    """Triangles binned by their xy bounding boxes into a uniform grid of
    about 8 triangles a cell, with each cell's z range; rays walk the
    cells they cross in order (2D DDA, in float64) inside the box of the
    triangles, and stop once the best hit lies before the cell's exit."""

    def __init__(self, v0, v1, v2):
        dev = v0.device
        w = torch.stack([v0, v1, v2]).double()
        lo, hi = w.amin(dim=0), w.amax(dim=0)  # per-triangle boxes [T, 3]
        self.lo = lo.amin(dim=0)
        self.hi = hi.amax(dim=0)
        n = v0.shape[0]
        g = max(1, min(4096, int(math.ceil(math.sqrt(n / 8)))))
        self.g = g
        ext = (self.hi - self.lo)[:2].clamp(min=1e-12)
        self.cell = ext / g
        pad = 1e-6 * ext
        c0 = torch.floor((lo[:, :2] - pad - self.lo[:2]) / self.cell).long()
        c1 = torch.floor((hi[:, :2] + pad - self.lo[:2]) / self.cell).long()
        c0, c1 = c0.clamp(0, g - 1), c1.clamp(0, g - 1)
        nx, ny = c1[:, 0] - c0[:, 0] + 1, c1[:, 1] - c0[:, 1] + 1
        cnt = nx * ny
        tri = torch.repeat_interleave(torch.arange(n, device=dev), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        k = torch.arange(tri.shape[0], device=dev) - first[tri]
        cx = c0[tri, 0] + k % nx[tri]
        cy = c0[tri, 1] + k // nx[tri]
        cid = cx * g + cy
        order = torch.argsort(cid, stable=True)
        self.tri = tri[order]
        cid = cid[order]
        counts = torch.bincount(cid, minlength=g * g)
        self.start = torch.cumsum(counts, 0) - counts
        self.count = counts
        big = float("inf")
        self.zlo = torch.full((g * g,), big, dtype=torch.float64, device=dev)
        self.zhi = torch.full((g * g,), -big, dtype=torch.float64,
                              device=dev)
        self.zlo.scatter_reduce_(0, cid, lo[self.tri, 2], "amin")
        self.zhi.scatter_reduce_(0, cid, hi[self.tri, 2], "amax")
        zpad = 1e-6 * float((self.hi - self.lo).abs().max())
        self.zlo -= zpad
        self.zhi += zpad

    def closest(self, sc, o, d, tmin, tmax):
        """→ (t [n] in sc.dt, triangle index [n], −1 for a miss)."""
        dev, n = o.device, o.shape[0]
        best = torch.full((n,), BIG, dtype=sc.dt, device=dev)
        best_i = torch.full((n,), -1, dtype=torch.long, device=dev)
        O, D = o.double(), d.double()
        with torch.no_grad():
            inv = 1.0 / D
            ta = (self.lo - O) * inv
            tb = (self.hi - O) * inv
            tlo = torch.minimum(ta, tb).nan_to_num(nan=-math.inf)
            thi = torch.maximum(ta, tb).nan_to_num(nan=math.inf)
            t0 = torch.maximum(tlo.amax(dim=1), tmin.double())
            t1 = torch.minimum(thi.amin(dim=1), tmax.double())
        live = (t0 <= t1).nonzero()[:, 0]
        if live.numel() == 0:
            return best, best_i
        O, D, t0, t1 = O[live], D[live], t0[live], t1[live]
        g, cs, lo = self.g, self.cell, self.lo
        p0 = O[:, :2] + D[:, :2] * t0[:, None]
        c = torch.floor((p0 - lo[:2]) / cs).long().clamp(0, g - 1)
        step = torch.where(D[:, :2] > 0, 1, -1)
        nxt = lo[:2] + (c + (D[:, :2] > 0).long()) * cs
        with torch.no_grad():
            tnext = torch.where(D[:, :2] != 0, (nxt - O[:, :2]) / D[:, :2],
                                math.inf)
            tdelta = torch.where(D[:, :2] != 0, cs / D[:, :2].abs(),
                                 math.inf)
        tin = t0
        rid = live
        while rid.numel():
            texit = torch.minimum(torch.minimum(tnext[:, 0], tnext[:, 1]),
                                  t1)
            cid = c[:, 0] * g + c[:, 1]
            za, zb = O[:, 2] + D[:, 2] * tin, O[:, 2] + D[:, 2] * texit
            need = ((torch.minimum(za, zb) <= self.zhi[cid])
                    & (torch.maximum(za, zb) >= self.zlo[cid])
                    & (self.count[cid] > 0))
            q = need.nonzero()[:, 0]
            if q.numel():
                cnt = self.count[cid[q]]
                rows = torch.repeat_interleave(q, cnt)
                first = torch.cumsum(cnt, 0) - cnt
                k = (torch.arange(rows.shape[0], device=dev)
                     - torch.repeat_interleave(first, cnt))
                tri = self.tri[self.start[cid[rows]] + k]
                r = rid[rows]
                tt = mt_pairs(o[r], d[r], tmin[r], tmax[r], sc.tri["v0"][tri],
                              sc.tri["v1"][tri], sc.tri["v2"][tri])
                bt, bi = _best(rows, tt, tri, rid.shape[0], sc.dt, dev)
                old_t, old_i = best[rid], best_i[rid]
                better = (bt < old_t) | ((bt == old_t) & (bt < BIG)
                                         & (bi < old_i) & (bi >= 0))
                best[rid] = torch.where(better, bt, old_t)
                best_i[rid] = torch.where(better, bi, old_i)
            done = (best[rid].double() <= texit) | (texit >= t1)
            ax = (tnext[:, 0] >= tnext[:, 1]).long()  # axis crossed next
            rows_all = torch.arange(rid.shape[0], device=dev)
            c = c.clone()
            c[rows_all, ax] += step[rows_all, ax]
            tin = texit
            tnext = tnext.clone()
            tnext[rows_all, ax] += tdelta[rows_all, ax]
            done = done | (c < 0).any(dim=1) | (c >= g).any(dim=1)
            keep = (~done).nonzero()[:, 0]
            rid, O, D, c, step = rid[keep], O[keep], D[keep], c[keep], step[keep]
            tnext, tdelta, tin, t1 = tnext[keep], tdelta[keep], tin[keep], t1[keep]
        return best, best_i


def _triangles(sc, o, d, tmin, tmax):
    if sc.tri["v0"].shape[0] == 0:
        return None
    if sc.grid is not None:
        return sc.grid.closest(sc, o, d, tmin, tmax)
    return _tris_brute(sc, o, d, tmin, tmax)


def _sphere_t(sc, o, d, tmin, tmax):
    sp = sc.spheres
    n = o.shape[0]
    best = torch.full((n,), BIG, dtype=sc.dt, device=o.device)
    bi = torch.zeros((n,), dtype=torch.long, device=o.device)
    for k in range(sp["r"].shape[0]):
        oo = o - sp["c"][k]
        a = dot(d, d)
        b = 2.0 * dot(d, oo)
        c = dot(oo, oo) - sp["r"][k] * sp["r"][k]
        disc = b * b - 4.0 * a * c
        ok = disc >= 0.0
        root = torch.sqrt(torch.clamp(disc, min=0.0))
        q = torch.where(b < 0.0, -0.5 * (b - root), -0.5 * (b + root))
        sdiv = lambda x, y: torch.where(
            y != 0.0, x / torch.where(y == 0.0, 1.0, y), BIG)
        t0, t1 = sdiv(q, a), sdiv(c, q)
        tl, th = torch.minimum(t0, t1), torch.maximum(t0, t1)
        inr = lambda t: ok & (t > tmin) & (t < tmax)
        t = torch.where(inr(tl), tl, torch.where(inr(th), th, BIG))
        bi = torch.where(t < best, k, bi)
        best = torch.minimum(best, t)
    return best, bi


def _disk_t(sc, o, d, tmin, tmax):
    dk = sc.disks
    n = o.shape[0]
    best = torch.full((n,), BIG, dtype=sc.dt, device=o.device)
    bi = torch.zeros((n,), dtype=torch.long, device=o.device)
    for k in range(dk["moffset"].shape[0]):
        zd, zo = dot(d, dk["z"][k]), dot(o, dk["z"][k])
        th = (dk["moffset"][k] - zo) / torch.where(zd == 0.0, 1e-20, zd)
        loc = o + th[:, None] * d - dk["o"][k]
        lx = dot(loc, dk["x"][k]) * dk["inv_r2"][k, 0]
        ly = dot(loc, dk["y"][k]) * dk["inv_r2"][k, 1]
        ok = (th > tmin) & (th < tmax) & (lx * lx + ly * ly <= 1.0)
        t = torch.where(ok, th, BIG)
        bi = torch.where(t < best, k, bi)
        best = torch.minimum(best, t)
    return best, bi


def closest(sc, o, d, tmin, tmax) -> dict:
    """Closest hit → dict valid, t, p, ns, dpdu, mat, light (−1 where no
    hit, and `light` −1 off the emitters)."""
    n, dev, dt = o.shape[0], o.device, sc.dt
    fam = []
    tri = _triangles(sc, o, d, tmin, tmax)
    if tri is not None:
        t_t, i_t = tri
        found = i_t >= 0
        k = i_t.clamp(min=0)
        v0, v1, v2 = sc.tri["v0"][k], sc.tri["v1"][k], sc.tri["v2"][k]
        # the winner re-intersected: its t from the same arithmetic
        e1, e2 = v1 - v0, v2 - v0
        pv = cross(d, e2)
        det = dot(e1, pv)
        inv = torch.where(det != 0.0, 1.0 / torch.where(det == 0.0, 1.0, det),
                          0.0)
        tv = o - v0
        t_w = dot(e2, cross(tv, e1)) * inv
        t_t = torch.where(found, t_w, BIG)
        fam.append((t_t, lambda: (sc.tri["ng"][k], sc.tri["dpdu"][k],
                                  sc.tri["mat"][k],
                                  torch.full((n,), -1, device=dev)), t_t))
    if sc.spheres["r"].shape[0]:
        t_s, i_s = _sphere_t(sc, o, d, tmin, tmax)

        def sph(t_s=t_s, i_s=i_s):
            c, r = sc.spheres["c"][i_s], sc.spheres["r"][i_s]
            ph = (o - c) + d * t_s[:, None]
            degen = (ph[:, 0] == 0.0) & (ph[:, 1] == 0.0)
            ph = torch.cat([torch.where(degen, 1e-5 * r, ph[:, 0])[:, None],
                            ph[:, 1:]], dim=1)
            nrm = ph / torch.clamp(r, min=1e-20)[:, None]
            dpdu = torch.stack([-nrm[:, 1], nrm[:, 0], torch.zeros_like(r)],
                               -1)
            return (normalize(nrm), dpdu, sc.spheres["mat"][i_s],
                    torch.full((n,), -1, device=dev))
        fam.append((t_s, sph, t_s))
    if sc.disks["moffset"].shape[0]:
        t_d, i_d = _disk_t(sc, o, d, tmin, tmax)

        def dsk(t_d=t_d, i_d=i_d):
            dk = sc.disks
            loc = o + d * t_d[:, None] - dk["o"][i_d]
            lx = dot(loc, dk["x"][i_d]) * dk["inv_r2"][i_d][:, 0]
            ly = dot(loc, dk["y"][i_d]) * dk["inv_r2"][i_d][:, 1]
            dpdu = -ly[:, None] * dk["x"][i_d] + lx[:, None] * dk["y"][i_d]
            return dk["z"][i_d], dpdu, dk["mat"][i_d], dk["light"][i_d]
        fam.append((t_d, dsk, t_d))
    if not fam:
        z = torch.zeros((n, 3), dtype=dt, device=dev)
        no = torch.full((n,), -1, device=dev)
        return dict(valid=torch.zeros(n, dtype=torch.bool, device=dev),
                    t=torch.full((n,), BIG, dtype=dt, device=dev), p=z, ns=z,
                    dpdu=z, mat=no, light=no)
    t = fam[0][0]
    for f in fam[1:]:
        t = torch.minimum(t, f[0])
    valid = t < BIG
    attrs = [f[1]() for f in fam]
    ps = [o + d * f[2][:, None] for f in fam]
    out = list(attrs[-1]) + [ps[-1]]
    for i in range(len(fam) - 2, -1, -1):
        w = fam[i][0] <= t
        cur = list(attrs[i]) + [ps[i]]
        out = [torch.where(w[:, None] if a.ndim == 2 else w, a, b)
               for a, b in zip(cur, out)]
    ns, dpdu, mat, light, p = out
    return dict(valid=valid, t=torch.where(valid, t, BIG), p=p, ns=ns,
                dpdu=dpdu, mat=torch.where(valid, mat, -1),
                light=torch.where(valid, light, -1))


def occluded(sc, o, d, tmin, tmax):
    """Any hit in (tmin, tmax)."""
    return closest(sc, o, d, tmin, tmax)["valid"]
