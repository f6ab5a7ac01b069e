"""Carry the JAX package's state into the port.

Each function takes an object whose fields are numpy arrays — a
`raytrace_tpu` pytree after `jax.tree_util.tree_map(np.asarray, ...)`, or a
plain dict with the same keys — and builds the port's dataclass on
`device`. Only numpy crosses over, so this module never imports jax; the
parity tests use it to feed both packages the same scene and the same
intermediate states.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytrace_tpu_torch.diff.render import SceneParams
from raytrace_tpu_torch.ops.photon_grid import PhotonMap
from raytrace_tpu_torch.renderers.common import CameraRecords
from raytrace_tpu_torch.renderers.photon import ProgressiveState
from raytrace_tpu_torch.scene import scene as sc
from raytrace_tpu_torch.scene.camera import PerspectiveCamera


def _get(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name, None)


def _build(cls, obj, device, defaults=None):
    """cls(**fields) with every numpy field as a tensor on `device`."""
    kw = {}
    for f in dataclasses.fields(cls):
        v = _get(obj, f.name)
        if v is None and defaults and f.name in defaults:
            v = defaults[f.name]
        kw[f.name] = None if v is None else torch.as_tensor(
            np.array(v), device=device)
    return cls(**kw)


def scene_from_numpy(scene, device) -> sc.Scene:
    mats = _get(scene, "materials")
    m = np.asarray(_get(mats, "mtype")).shape[0]
    return sc.Scene(
        tris=_build(sc.Triangles, _get(scene, "tris"), device),
        spheres=_build(sc.Spheres, _get(scene, "spheres"), device),
        disks=_build(sc.Disks, _get(scene, "disks"), device),
        materials=_build(sc.Materials, mats, device, defaults=dict(
            tex_type=np.zeros(m, np.int32),
            tex_scale=np.ones(m, np.float32))),
        lights=_build(sc.Lights, _get(scene, "lights"), device),
    )


def camera_from_numpy(camera, device) -> PerspectiveCamera:
    t = lambda name: torch.as_tensor(np.array(_get(camera, name)),
                                     device=device)
    return PerspectiveCamera(
        raster_to_camera=t("raster_to_camera"),
        camera_to_world=t("camera_to_world"),
        dx_camera=t("dx_camera"), dy_camera=t("dy_camera"),
        lens_radius=float(_get(camera, "lens_radius")),
        focal_distance=float(_get(camera, "focal_distance")),
        width=int(_get(camera, "width")), height=int(_get(camera, "height")),
    )


def records_from_numpy(rec, device) -> CameraRecords:
    return _build(CameraRecords, rec, device)


def photon_map_from_numpy(photons, device) -> PhotonMap:
    return _build(PhotonMap, photons, device)


def state_from_numpy(state, device) -> ProgressiveState:
    return _build(ProgressiveState, state, device)


def params_from_numpy(params, device) -> SceneParams:
    return _build(SceneParams, params, device)
