"""pbrt's affine transforms in float64 numpy, for the scene descriptions."""
from __future__ import annotations

import numpy as np


def translate(x: float, y: float, z: float) -> np.ndarray:
    m = np.eye(4)
    m[:3, 3] = (x, y, z)
    return m


def rotate(angle_deg: float, axis) -> np.ndarray:
    """Rotation by angle_deg about axis (pbrt Rotate)."""
    a = np.asarray(axis, np.float64)
    x, y, z = a / np.linalg.norm(a)
    s, c = np.sin(np.deg2rad(angle_deg)), np.cos(np.deg2rad(angle_deg))
    m = np.eye(4)
    m[:3, :3] = [
        [x * x + (1 - x * x) * c, x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
        [x * y * (1 - c) + z * s, y * y + (1 - y * y) * c, y * z * (1 - c) - x * s],
        [x * z * (1 - c) - y * s, y * z * (1 - c) + x * s, z * z + (1 - z * z) * c],
    ]
    return m


def look_at(eye, look, up) -> np.ndarray:
    """pbrt LookAt as a camera-to-world matrix (+z looks at `look`)."""
    eye, look, up = (np.asarray(v, np.float64) for v in (eye, look, up))
    d = (look - eye) / np.linalg.norm(look - eye)
    right = np.cross(up / np.linalg.norm(up), d)
    right = right / np.linalg.norm(right)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, np.cross(d, right), d, eye
    return m
