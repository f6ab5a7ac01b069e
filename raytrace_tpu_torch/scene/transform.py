"""Affine transforms (host-side, numpy 4x4) for scene construction — a copy of
raytrace_tpu/scene/transform.py, which is pure numpy already.

Plays the role of pbrt's Transform stack that the reference consumes through
ObjectToWorld on each shape (cudasphere.cpp:27-29, cudadisk.cpp:23-43,
cudatrianglemesh.cpp:28-31).
"""
from __future__ import annotations

import numpy as np


def identity() -> np.ndarray:
    return np.eye(4, dtype=np.float64)


def translate(x: float, y: float, z: float) -> np.ndarray:
    m = identity()
    m[:3, 3] = (x, y, z)
    return m


def scale(x: float, y: float, z: float) -> np.ndarray:
    m = identity()
    m[0, 0], m[1, 1], m[2, 2] = x, y, z
    return m


def rotate(angle_deg: float, axis) -> np.ndarray:
    a = np.asarray(axis, dtype=np.float64)
    a = a / np.linalg.norm(a)
    s = np.sin(np.deg2rad(angle_deg))
    c = np.cos(np.deg2rad(angle_deg))
    x, y, z = a
    m = identity()
    m[:3, :3] = np.array([
        [x * x + (1 - x * x) * c, x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
        [x * y * (1 - c) + z * s, y * y + (1 - y * y) * c, y * z * (1 - c) - x * s],
        [x * z * (1 - c) - y * s, y * z * (1 - c) + x * s, z * z + (1 - z * z) * c],
    ])
    return m


def look_at(eye, look, up) -> np.ndarray:
    """pbrt LookAt: returns the camera-to-world transform (left-handed pbrt
    convention: +z into the screen, dir = normalize(look - eye))."""
    eye = np.asarray(eye, dtype=np.float64)
    look = np.asarray(look, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    d = look - eye
    d = d / np.linalg.norm(d)
    right = np.cross(up / np.linalg.norm(up), d)
    if np.linalg.norm(right) < 1e-12:
        raise ValueError("LookAt: up and viewing direction are parallel")
    right = right / np.linalg.norm(right)
    new_up = np.cross(d, right)
    m = identity()
    m[:3, 0] = right
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = eye
    return m


def apply_point(m: np.ndarray, p: np.ndarray) -> np.ndarray:
    p = np.asarray(p, dtype=np.float64)
    return p @ m[:3, :3].T + m[:3, 3]


def apply_vector(m: np.ndarray, v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, dtype=np.float64)
    return v @ m[:3, :3].T


def apply_normal(m: np.ndarray, n: np.ndarray) -> np.ndarray:
    n = np.asarray(n, dtype=np.float64)
    inv = np.linalg.inv(m[:3, :3])
    return n @ inv


def to_affine34(m: np.ndarray) -> np.ndarray:
    return np.asarray(m, dtype=np.float64)[:3, :4]
