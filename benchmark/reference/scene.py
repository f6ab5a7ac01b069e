"""The reference's scene: the description the benchmark made, flattened to
plain tensors in the reference's precision, with the camera matrices and
the disk frames worked out again from their transforms (pbrt's
definitions)."""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

MATTE, MIRROR, GLASS = 0, 1, 2
POINT, DISK = 0, 1


@dataclasses.dataclass
class RefScene:
    device: torch.device
    dt: torch.dtype
    tri: dict       # v0, v1, v2, ng, dpdu [T, 3]; mat [T]
    spheres: dict   # c [S, 3], r [S], mat [S]
    disks: dict     # o, x, y, z [D, 3], moffset [D], inv_r2 [D, 2], mat, light
    mtype: torch.Tensor
    kd: torch.Tensor
    eta: torch.Tensor
    lights: list    # dicts of tensors: type, o, p1, p2, normal, area, I, n
    camera: dict
    grid: object = None  # geometry.TriGrid over many triangles


def _apply_point(m, p):
    return np.asarray(p, np.float64) @ m[:3, :3].T + m[:3, 3]


def _apply_vector(m, v):
    return np.asarray(v, np.float64) @ m[:3, :3].T


def camera_matrices(cam: dict):
    """pbrt's perspective raster→camera chain in float64 → (raster to
    camera [4, 4], camera to world [3, 4], one-pixel steps dx, dy)."""
    w, h = cam["width"], cam["height"]
    aspect = w / h
    x0, x1, y0, y1 = ((-aspect, aspect, -1.0, 1.0) if aspect > 1.0
                      else (-1.0, 1.0, -1.0 / aspect, 1.0 / aspect))
    n_, f_ = 1e-2, 1000.0
    persp = np.array([[1, 0, 0, 0], [0, 1, 0, 0],
                      [0, 0, f_ / (f_ - n_), -f_ * n_ / (f_ - n_)],
                      [0, 0, 1, 0]], np.float64)
    inv_tan = 1.0 / math.tan(math.radians(cam["fov"]) / 2.0)
    c2s = np.diag([inv_tan, inv_tan, 1.0, 1.0]) @ persp
    s2r = (np.diag([w, h, 1.0, 1.0])
           @ np.diag([1.0 / (x1 - x0), 1.0 / (y0 - y1), 1.0, 1.0])
           @ np.array([[1, 0, 0, -x0], [0, 1, 0, -y1], [0, 0, 1, 0],
                       [0, 0, 0, 1.0]]))
    r2c = np.linalg.inv(c2s) @ np.linalg.inv(s2r)

    def r2c_pt(p):
        q = r2c @ np.array([p[0], p[1], p[2], 1.0])
        return q[:3] / q[3]

    dx = r2c_pt((1, 0, 0)) - r2c_pt((0, 0, 0))
    dy = r2c_pt((0, 1, 0)) - r2c_pt((0, 0, 0))
    return r2c, np.asarray(cam["c2w"], np.float64)[:3, :4], dx, dy


def build(desc: dict, device, dt=torch.float32, grid_min: int = 4096):
    """RefScene of `desc` (scenes/*.py) on `device` in precision dt; meshes
    of more than grid_min triangles get a uniform grid (geometry.TriGrid)."""
    from benchmark.reference import geometry

    f = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                  device=device).to(dt)
    names = list(desc["materials"])
    mid = {n: i for i, n in enumerate(names)}
    mt = {"matte": MATTE, "mirror": MIRROR, "glass": GLASS}
    mats = [desc["materials"][n] for n in names]
    mtype = torch.tensor([mt[m["type"]] for m in mats], device=device)
    kd = f([m.get("kd", [1.0, 1.0, 1.0]) for m in mats])
    eta = f([m.get("eta", 1.0) for m in mats])

    v0s, v1s, v2s, tm = [], [], [], []
    for mesh in desc["meshes"]:
        v, idx = np.asarray(mesh["v"], np.float64), np.asarray(mesh["idx"])
        v0s.append(v[idx[:, 0]]); v1s.append(v[idx[:, 1]]); v2s.append(v[idx[:, 2]])
        tm.append(np.full(len(idx), mid[mesh["mat"]]))
    v0, v1, v2 = (f(np.concatenate(a)) for a in (v0s, v1s, v2s))
    ng = geometry.normalize(geometry.cross(v1 - v0, v2 - v0))
    # dp/du of the default uvs (0,0), (1,0), (0,1)
    dpdu = (v1 - v2) - (v0 - v2)
    tri = dict(v0=v0, v1=v1, v2=v2, ng=ng, dpdu=dpdu,
               mat=torch.as_tensor(np.concatenate(tm), device=device))

    sph = desc["spheres"]
    spheres = dict(c=f([s["o2w"][:3, 3] for s in sph]).reshape(-1, 3),
                   r=f([s["radius"] for s in sph]),
                   mat=torch.tensor([mid[s["mat"]] for s in sph],
                                    dtype=torch.long, device=device))

    lights, disk_rows = [], []
    for i, l in enumerate(desc["lights"]):
        if l["kind"] == "point":
            lights.append(dict(type=POINT, o=f(l["pos"]), I=f(l["intensity"]),
                               n=1, normal=f([0, 0, 1]), p1=f([0, 0, 0]),
                               p2=f([0, 0, 0]), area=f(0.0)))
            continue
        m, r = l["o2w"], l["radius"]
        wo = _apply_point(m, [0.0, 0.0, 0.0])
        wx, wy = _apply_vector(m, [r, 0.0, 0.0]), _apply_vector(m, [0.0, r, 0.0])
        normal = np.cross(wx, wy)
        normal /= np.linalg.norm(normal)
        wz = _apply_vector(m, [0.0, 0.0, 1.0])
        wz /= np.linalg.norm(wz)
        lights.append(dict(type=DISK, o=f(wo), p1=f(wx), p2=f(wy),
                           normal=f(normal), area=f(math.pi * r * r),
                           I=f(l["emit"]), n=int(l["n_samples"])))
        disk_rows.append((wo, wx, wy, wz, mid[l["mat"]], i))
    disks = dict(
        o=f([d[0] for d in disk_rows]).reshape(-1, 3),
        x=f([d[1] for d in disk_rows]).reshape(-1, 3),
        y=f([d[2] for d in disk_rows]).reshape(-1, 3),
        z=f([d[3] for d in disk_rows]).reshape(-1, 3),
        moffset=f([np.dot(d[0], d[3]) for d in disk_rows]),
        inv_r2=f([[1 / np.dot(d[1], d[1]), 1 / np.dot(d[2], d[2])]
                  for d in disk_rows]).reshape(-1, 2),
        mat=torch.tensor([d[4] for d in disk_rows], dtype=torch.long,
                         device=device),
        light=torch.tensor([d[5] for d in disk_rows], dtype=torch.long,
                           device=device))

    r2c, c2w, dx, dy = camera_matrices(desc["camera"])
    camera = dict(r2c=f(r2c), c2w=f(c2w), dx=f(dx), dy=f(dy),
                  width=desc["camera"]["width"],
                  height=desc["camera"]["height"])
    sc = RefScene(device=torch.device(device), dt=dt, tri=tri,
                  spheres=spheres, disks=disks, mtype=mtype, kd=kd, eta=eta,
                  lights=lights, camera=camera)
    if v0.shape[0] > grid_min:
        sc.grid = geometry.TriGrid(v0, v1, v2)
    return sc
