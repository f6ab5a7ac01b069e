"""Python scene builder (port of raytrace_tpu/scene/builder.py).

Shapes, materials and lights accumulate in numpy lists exactly as in the JAX
builder, and `build(device)` emits the SoA Scene of torch tensors on the
given device — the JAX builder's numpy staging is unchanged, only its final
`jnp.asarray` calls became `torch.as_tensor`. Scenes of ≥ 512 triangles
get the JAX builder's BVH (binned SAH, ops/bvh.py) and cluster set
(ops/cluster_intersect.py), with every triangle array in the BVH's order.
"""
from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Optional

import numpy as np
import torch

from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.ops import bvh as bvh_ops
from raytrace_tpu_torch.ops import cluster_intersect as ci
from raytrace_tpu_torch.scene import transform as tr
from raytrace_tpu_torch.utils import metrics
from raytrace_tpu_torch.scene.scene import (
    GLASS,
    LIGHT_AREA_DISK,
    LIGHT_DISTANT,
    LIGHT_POINT,
    MATTE,
    MIRROR,
    Disks,
    Lights,
    Materials,
    Scene,
    Spheres,
    Triangles,
    empty_disks,
    empty_spheres,
    empty_triangles,
)

_F32 = np.float32


class SceneBuilder:
    def __init__(self):
        self._mat_type: list[int] = []
        self._mat_kd: list[np.ndarray] = []
        self._mat_eta: list[float] = []
        self._mat_tex: list[int] = []
        self._mat_tex_scale: list[float] = []
        self._mat_dedup: dict = {}

        self._tris: list[dict] = []
        self._spheres: list[dict] = []
        self._disks: list[dict] = []

        self._lights: list[dict] = []

        # named objects for ObjectBegin/ObjectInstance
        self._objects: dict[str, list] = {}

    # -- materials (dedup map mirrors cudarender.cpp:181-192) ---------------
    def _add_material(self, mtype: int, kd, eta: float,
                      tex_type: int = 0, tex_scale: float = 1.0) -> int:
        key = (mtype, tuple(np.round(np.asarray(kd, np.float64), 9)),
               round(eta, 9), tex_type, round(tex_scale, 9))
        if key in self._mat_dedup:
            return self._mat_dedup[key]
        idx = len(self._mat_type)
        self._mat_type.append(mtype)
        self._mat_kd.append(np.asarray(kd, dtype=np.float64))
        self._mat_eta.append(float(eta))
        self._mat_tex.append(int(tex_type))
        self._mat_tex_scale.append(float(tex_scale))
        self._mat_dedup[key] = idx
        return idx

    def matte(self, kd=(0.5, 0.5, 0.5), texture: str | None = None,
              tex_scale: float = 8.0) -> int:
        """texture: None (constant) or "checker" — the per-material lookup
        the reference stubs out (cudatexture.cu.h:7-9)."""
        tex = {None: 0, "checker": 1}[texture]
        return self._add_material(MATTE, kd, 1.0, tex_type=tex,
                                  tex_scale=tex_scale)

    def mirror(self, kr=(0.9, 0.9, 0.9)) -> int:
        return self._add_material(MIRROR, kr, 1.0)

    def glass(self, eta: float = 1.5) -> int:
        return self._add_material(GLASS, (1.0, 1.0, 1.0), eta)

    def default_material(self) -> int:
        # Unknown pbrt materials collapse to matte Kd=0.5
        # (reference: cudamaterial.cpp:20, cudamaterial.h:29-31).
        return self.matte((0.5, 0.5, 0.5))

    # -- shapes ---------------------------------------------------------------
    def triangle_mesh(
        self,
        vertices: np.ndarray,
        indices: np.ndarray,
        normals: Optional[np.ndarray] = None,
        uvs: Optional[np.ndarray] = None,
        material: Optional[int] = None,
        object_to_world: Optional[np.ndarray] = None,
        light: int = -1,
        reverse_orientation: bool = False,
        _sink: Optional[list] = None,
    ):
        """World-space triangle mesh. Vertices are pre-transformed to world
        exactly like pbrt does for the reference (cudatrianglemesh.cpp:28-31).

        reverse_orientation (pbrt ReverseOrientation): flips the geometric
        normal by swapping the winding (v1↔v2 with their uvs — the p(u,v)
        map and hence dpdu are unchanged) and negates supplied shading
        normals, matching pbrt's normal-flip-only semantics."""
        o2w = tr.identity() if object_to_world is None else object_to_world
        v = tr.apply_point(o2w, np.asarray(vertices, np.float64))
        idx = np.asarray(indices, np.int64).reshape(-1, 3)
        if normals is not None:
            n = tr.apply_normal(o2w, np.asarray(normals, np.float64))
        else:
            n = None
        if reverse_orientation:
            idx = idx[:, [0, 2, 1]]
            if n is not None:
                n = -n
        rec = dict(
            v=v, idx=idx, n=n,
            uv=None if uvs is None else np.asarray(uvs, np.float64),
            mat=self.default_material() if material is None else material,
            light=light,
        )
        (self._tris if _sink is None else _sink).append(("mesh", rec))

    def sphere(
        self,
        radius: float = 1.0,
        material: Optional[int] = None,
        object_to_world: Optional[np.ndarray] = None,
        light: int = -1,
        reverse_orientation: bool = False,
        _sink: Optional[list] = None,
    ):
        """Full sphere in object space behind an o2w transform
        (reference: cudasphere.cpp:16-40; zmin/zmax/phiMax clipping is dropped
        there too). reverse_orientation flips normals at the hit (pbrt
        ReverseOrientation)."""
        o2w = tr.identity() if object_to_world is None else object_to_world
        rec = dict(
            o2w=np.asarray(o2w, np.float64), radius=float(radius),
            mat=self.default_material() if material is None else material,
            light=light, flip=bool(reverse_orientation),
        )
        (self._spheres if _sink is None else _sink).append(("sphere", rec))

    def disk(
        self,
        height: float = 0.0,
        radius: float = 1.0,
        inner_radius: float = 0.0,
        phi_max_deg: float = 360.0,
        material: Optional[int] = None,
        object_to_world: Optional[np.ndarray] = None,
        light: int = -1,
        reverse_orientation: bool = False,
        _sink: Optional[list] = None,
    ):
        """Disk pre-flattened to a world frame (reference: cudadisk.cpp:23-43).
        reverse_orientation negates the world z (normal) — the plane
        equation is sign-invariant, only the reported normal flips."""
        o2w = tr.identity() if object_to_world is None else object_to_world
        rec = dict(
            o2w=np.asarray(o2w, np.float64), height=float(height),
            radius=float(radius), inner_radius=float(inner_radius),
            phi_max=math.radians(phi_max_deg),
            mat=self.default_material() if material is None else material,
            light=light, flip=bool(reverse_orientation),
        )
        (self._disks if _sink is None else _sink).append(("disk", rec))

    # -- object instancing (pbrt ObjectBegin/ObjectInstance) -----------------
    def object_begin(self, name: str) -> "ObjectRecorder":
        self._objects[name] = []
        return ObjectRecorder(self, self._objects[name])

    def object_instance(self, name: str, instance_to_world: np.ndarray):
        """Flatten an instanced object through its transform (the reference
        keeps shared geometry behind a Transform node, cudarender.cpp:88-103;
        we re-emit with composed transforms — same rendered result)."""
        if name not in self._objects:
            warnings.warn(f"ObjectInstance of unknown object {name!r}")
            return
        for kind, rec in self._objects[name]:
            rec = dict(rec)
            if kind == "mesh":
                rec["v"] = tr.apply_point(instance_to_world, rec["v"])
                if rec["n"] is not None:
                    rec["n"] = tr.apply_normal(instance_to_world, rec["n"])
                self._tris.append((kind, rec))
            elif kind == "sphere":
                rec["o2w"] = instance_to_world @ rec["o2w"]
                self._spheres.append((kind, rec))
            elif kind == "disk":
                rec["o2w"] = instance_to_world @ rec["o2w"]
                self._disks.append((kind, rec))

    # -- lights ---------------------------------------------------------------
    def point_light(self, position, intensity):
        """(reference: cudalight.cpp:16-24)"""
        self._lights.append(dict(
            ltype=LIGHT_POINT,
            o=np.asarray(position, np.float64),
            p1=np.zeros(3), p2=np.zeros(3), normal=np.array([0.0, 0.0, 1.0]),
            area=0.0, intensity=np.asarray(intensity, np.float64), n_samples=1,
        ))

    def distant_light(self, direction, radiance):
        """Directional (distant) light: constant radiance L arriving from
        `direction` (the direction light TRAVELS, i.e. from light toward the
        scene). The reference declares this type but never implements it
        (DIRECTION, common.cu.h:48); semantics here follow pbrt's
        DistantLight — photons launch from a disk spanning the scene's
        bounding sphere, filled in at build() when the bounds are known."""
        d = np.asarray(direction, np.float64)
        d = d / np.linalg.norm(d)
        self._lights.append(dict(
            ltype=LIGHT_DISTANT,
            o=np.zeros(3),  # world center, filled at build()
            p1=np.zeros(3), p2=np.zeros(3),  # launch-disk frame, at build()
            normal=d,
            area=0.0,  # π·world_radius², at build()
            intensity=np.asarray(radiance, np.float64), n_samples=1,
        ))

    def area_light_disk(
        self,
        emit,
        height: float = 0.0,
        radius: float = 1.0,
        object_to_world: Optional[np.ndarray] = None,
        n_samples: int = 1,
        material: Optional[int] = None,
        reverse_orientation: bool = False,
    ) -> int:
        """Diffuse area light over a disk. Adds both the light-table entry
        (reference: cudalight.cpp:26-59) and the emitting disk geometry
        carrying the light index (reference: cudarender.cpp:193).
        reverse_orientation flips the one-sided emission hemisphere (pbrt:
        ReverseOrientation on an area light's shape flips which side
        emits)."""
        o2w = tr.identity() if object_to_world is None else object_to_world
        worldo = tr.apply_point(o2w, np.array([0.0, 0.0, height]))
        worldx = tr.apply_vector(o2w, np.array([radius, 0.0, 0.0]))
        worldy = tr.apply_vector(o2w, np.array([0.0, radius, 0.0]))
        normal = np.cross(worldx, worldy)
        normal = normal / np.linalg.norm(normal)
        if reverse_orientation:
            normal = -normal
        # pbrt Disk::Area() = phiMax*0.5*(radius²-innerRadius²) in OBJECT space
        area = math.pi * radius * radius
        light_idx = len(self._lights)
        self._lights.append(dict(
            ltype=LIGHT_AREA_DISK,
            o=worldo, p1=worldx, p2=worldy, normal=normal,
            area=float(area), intensity=np.asarray(emit, np.float64),
            n_samples=int(n_samples),
        ))
        self.disk(height=height, radius=radius, object_to_world=o2w,
                  material=material, light=light_idx,
                  reverse_orientation=reverse_orientation)
        return light_idx

    # -- build -----------------------------------------------------------------
    def build(
        self,
        device,
        use_bvh: Optional[bool] = None,
        bvh_leaf_size: int = 4,
        bvh_threshold: int = 512,
    ) -> Scene:
        """Emit the static SoA Scene with every tensor on `device`.

        use_bvh: True/False forces the triangle BVH and cluster set on/off;
        None (default) makes them once the scene holds ≥ bvh_threshold
        triangles. The triangle arrays are then reordered by the BVH's
        permutation, and clusters hold 512 triangles from 2^21 triangles
        on, 256 below. The host times of the three steps go to the
        `raytrace_tpu_torch` logger as one `scene_build` line. The draws'
        kernel starts building first (`prng.prefetch`), so that on a card
        nvcc runs while the host builds the BVH and the clusters."""
        prng.prefetch(device)
        t = lambda a: torch.as_tensor(a, device=device)
        materials = Materials(
            mtype=t(np.asarray(self._mat_type or [0], np.int32)),
            kd=t(np.stack(self._mat_kd or [np.full(3, 0.5)]).astype(_F32)),
            eta=t(np.asarray(self._mat_eta or [1.0], _F32)),
            tex_type=t(np.asarray(self._mat_tex or [0], np.int32)),
            tex_scale=t(np.asarray(self._mat_tex_scale or [1.0], _F32)),
        )
        tris_np = self._build_tris_np()
        bvh_tree = None
        cluster_set = None
        n_tris = int(tris_np["v0"].shape[0])
        if use_bvh or (use_bvh is None and n_tris >= bvh_threshold):
            t0 = time.perf_counter()
            arrays, perm = bvh_ops.build_bvh_native(
                tris_np["v0"], tris_np["v1"], tris_np["v2"],
                leaf_size=bvh_leaf_size)
            tris_np = {k: v[perm] for k, v in tris_np.items()}
            t1 = time.perf_counter()
            # clusters share the BVH-leaf order; big scenes keep coarser
            # clusters, since the cull is O(rays × clusters)
            cluster_set = ci.build_clusters(
                tris_np["v0"], tris_np["v1"], tris_np["v2"], device,
                cluster_size=512 if n_tris >= (1 << 21) else 256)
            t2 = time.perf_counter()
            bvh_tree = bvh_ops.bvh_from_arrays(arrays, device)
            tris = Triangles(**{k: t(v) for k, v in tris_np.items()})
            if tris.v0.is_cuda:
                torch.cuda.synchronize(tris.v0.device)
            metrics.log_pass(
                "scene_build", triangles=n_tris,
                nodes=int(bvh_tree.packed.shape[0]),
                clusters=cluster_set.n_clusters, bvh_s=t1 - t0,
                clusters_s=t2 - t1, upload_s=time.perf_counter() - t2)
        else:
            tris = Triangles(**{k: t(v) for k, v in tris_np.items()})
        return Scene(
            tris=tris,
            spheres=self._build_spheres(device),
            disks=self._build_disks(device),
            materials=materials,
            lights=self._build_lights(self._world_bounds_np(tris_np), device),
            bvh=bvh_tree,
            clusters=cluster_set,
        )

    def _build_tris_np(self) -> dict:
        """Triangle SoA as numpy arrays (field name → array, matching the
        Triangles dataclass)."""
        if not self._tris:
            t = empty_triangles("cpu")
            return {f.name: getattr(t, f.name).numpy()
                    for f in dataclasses.fields(t)}
        v0s, v1s, v2s, n0s, n1s, n2s = [], [], [], [], [], []
        uv0s, uv1s, uv2s, hn, mats, lgs = [], [], [], [], [], []
        default_uv = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
        for _, rec in self._tris:
            v, idx = rec["v"], rec["idx"]
            t0, t1, t2 = v[idx[:, 0]], v[idx[:, 1]], v[idx[:, 2]]
            v0s.append(t0); v1s.append(t1); v2s.append(t2)
            ng = np.cross(t1 - t0, t2 - t0)
            ng = ng / np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
            if rec["n"] is not None:
                n = rec["n"]
                n0s.append(n[idx[:, 0]]); n1s.append(n[idx[:, 1]]); n2s.append(n[idx[:, 2]])
                hn.append(np.ones(len(idx), bool))
            else:
                n0s.append(ng); n1s.append(ng); n2s.append(ng)
                hn.append(np.zeros(len(idx), bool))
            if rec["uv"] is not None:
                uv = rec["uv"]
                uv0s.append(uv[idx[:, 0]]); uv1s.append(uv[idx[:, 1]]); uv2s.append(uv[idx[:, 2]])
            else:
                # default UVs (0,0),(1,0),(0,1) (reference: cudatrianglemesh.cu:27-33)
                uv0s.append(np.tile(default_uv[0], (len(idx), 1)))
                uv1s.append(np.tile(default_uv[1], (len(idx), 1)))
                uv2s.append(np.tile(default_uv[2], (len(idx), 1)))
            mats.append(np.full(len(idx), rec["mat"], np.int32))
            lgs.append(np.full(len(idx), rec["light"], np.int32))
        cat = lambda xs: np.concatenate(xs).astype(_F32)
        return dict(
            v0=cat(v0s), v1=cat(v1s), v2=cat(v2s),
            n0=cat(n0s), n1=cat(n1s), n2=cat(n2s),
            uv0=cat(uv0s), uv1=cat(uv1s), uv2=cat(uv2s),
            has_normals=np.concatenate(hn),
            mat=np.concatenate(mats),
            light=np.concatenate(lgs),
        )

    def _build_spheres(self, device) -> Spheres:
        if not self._spheres:
            return empty_spheres(device)
        o2ws, w2os, radii, mats, lgs, flips = [], [], [], [], [], []
        for _, rec in self._spheres:
            o2w = rec["o2w"]
            o2ws.append(tr.to_affine34(o2w))
            w2os.append(tr.to_affine34(np.linalg.inv(o2w)))
            radii.append(rec["radius"])
            mats.append(rec["mat"])
            lgs.append(rec["light"])
            flips.append(rec.get("flip", False))
        t = lambda a: torch.as_tensor(a, device=device)
        return Spheres(
            o2w=t(np.stack(o2ws).astype(_F32)),
            w2o=t(np.stack(w2os).astype(_F32)),
            radius=t(np.asarray(radii, _F32)),
            mat=t(np.asarray(mats, np.int32)),
            light=t(np.asarray(lgs, np.int32)),
            flip=t(np.asarray(flips, bool)),
        )

    def _build_disks(self, device) -> Disks:
        if not self._disks:
            return empty_disks(device)
        os_, xs, ys, zs, moffs, invr2s, innr, phim, mats, lgs = ([] for _ in range(10))
        for _, rec in self._disks:
            o2w = rec["o2w"]
            worldo = tr.apply_point(o2w, np.array([0.0, 0.0, rec["height"]]))
            worldx = tr.apply_vector(o2w, np.array([rec["radius"], 0.0, 0.0]))
            worldy = tr.apply_vector(o2w, np.array([0.0, rec["radius"], 0.0]))
            worldz = tr.apply_vector(o2w, np.array([0.0, 0.0, 1.0]))
            worldz = worldz / np.linalg.norm(worldz)
            if rec.get("flip", False):  # pbrt ReverseOrientation
                worldz = -worldz
            os_.append(worldo); xs.append(worldx); ys.append(worldy); zs.append(worldz)
            moffs.append(float(np.dot(worldo, worldz)))
            invr2s.append([1.0 / np.dot(worldx, worldx), 1.0 / np.dot(worldy, worldy)])
            innr.append(rec["inner_radius"] / rec["radius"])
            phim.append(rec["phi_max"])
            mats.append(rec["mat"]); lgs.append(rec["light"])
        f = lambda xs_: torch.as_tensor(np.asarray(xs_, _F32), device=device)
        i = lambda xs_: torch.as_tensor(np.asarray(xs_, np.int32),
                                        device=device)
        return Disks(
            o=f(os_), x=f(xs), y=f(ys), z=f(zs),
            moffset=f(moffs), inv_r2=f(invr2s),
            inner_radius=f(innr), phi_max=f(phim),
            mat=i(mats), light=i(lgs),
        )

    def _world_bounds_np(self, tris_np: dict) -> tuple:
        """Conservative world bounding sphere (center, radius) over every
        shape — sized only when distant lights need a launch disk."""
        lo = np.full(3, np.inf)
        hi = np.full(3, -np.inf)
        # mat < 0 marks the degenerate far-away padding triangle inserted for
        # triangle-free scenes (scene.empty_triangles, vertices at 1e30) —
        # including it would blow the distant-light disk area past f32 range
        real = np.asarray(tris_np["mat"]) >= 0
        if real.any():
            for k in ("v0", "v1", "v2"):
                vs = tris_np[k][real]
                lo = np.minimum(lo, vs.min(axis=0))
                hi = np.maximum(hi, vs.max(axis=0))
        for _, rec in self._spheres:
            c = tr.apply_point(rec["o2w"], np.zeros(3))
            lo = np.minimum(lo, c - rec["radius"])
            hi = np.maximum(hi, c + rec["radius"])
        for _, rec in self._disks:
            o2w = rec["o2w"]
            worldo = tr.apply_point(o2w, np.array([0.0, 0.0, rec["height"]]))
            r = np.linalg.norm(
                tr.apply_vector(o2w, np.array([rec["radius"], 0.0, 0.0]))
            ) + np.linalg.norm(
                tr.apply_vector(o2w, np.array([0.0, rec["radius"], 0.0]))
            )
            lo = np.minimum(lo, worldo - r)
            hi = np.maximum(hi, worldo + r)
        if not np.all(np.isfinite(lo)):
            return np.zeros(3), 1.0
        center = 0.5 * (lo + hi)
        radius = max(float(np.linalg.norm(hi - center)), 1e-6)
        return center, radius

    def _build_lights(self, world_bounds: tuple, device) -> Lights:
        ls = self._lights or [dict(
            ltype=LIGHT_POINT, o=np.zeros(3), p1=np.zeros(3), p2=np.zeros(3),
            normal=np.array([0.0, 0.0, 1.0]), area=0.0,
            intensity=np.zeros(3), n_samples=1,
        )]
        center, radius = world_bounds
        for l in ls:
            if l["ltype"] != LIGHT_DISTANT:
                continue
            # photon launch disk spanning the scene's bounding sphere
            # (pbrt DistantLight::Sample_L): center - r·d + disk(r) ⊥ d
            d = l["normal"]
            v1, v2 = _coordinate_system(d)
            l["o"] = np.asarray(center, np.float64)
            l["p1"] = v1 * radius
            l["p2"] = v2 * radius
            l["area"] = math.pi * radius * radius
        f = lambda k: torch.as_tensor(np.asarray([l[k] for l in ls], _F32),
                                      device=device)
        i = lambda k: torch.as_tensor(
            np.asarray([l[k] for l in ls], np.int32), device=device)
        return Lights(
            ltype=i("ltype"),
            o=f("o"), p1=f("p1"), p2=f("p2"), normal=f("normal"),
            area=f("area"), intensity=f("intensity"),
            n_samples=i("n_samples"),
        )


def _coordinate_system(v: np.ndarray) -> tuple:
    """Orthonormal frame ⊥ unit v (pbrt CoordinateSystem)."""
    if abs(v[0]) > abs(v[1]):
        v1 = np.array([-v[2], 0.0, v[0]]) / math.sqrt(v[0] * v[0] + v[2] * v[2])
    else:
        v1 = np.array([0.0, v[2], -v[1]]) / math.sqrt(v[1] * v[1] + v[2] * v[2])
    return v1, np.cross(v, v1)


class ObjectRecorder:
    """Records shapes added between ObjectBegin/ObjectEnd for later instancing."""

    def __init__(self, builder: SceneBuilder, sink: list):
        self._b = builder
        self._sink = sink

    def triangle_mesh(self, *a, **kw):
        self._b.triangle_mesh(*a, **kw, _sink=self._sink)

    def sphere(self, *a, **kw):
        self._b.sphere(*a, **kw, _sink=self._sink)

    def disk(self, *a, **kw):
        self._b.disk(*a, **kw, _sink=self._sink)
