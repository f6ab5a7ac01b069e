"""The scenes of the edge-gradient tests (tests/test_edges.py,
tests/test_penumbra.py) on the port's builder, at any width and on any
device, and a closed icosphere occluder. numpy and the port only: the
smoke run on the card loads this file, and that machine has no JAX.

A floor at z = 0 seen straight down from z = 6 (the frame spans ~±1.5 at
the floor), an occluder at z = 3 and a point light at (4, 0, 6) or a disk
light aimed at the occluder."""
import numpy as np

from raytrace_tpu_torch.scene import transform as tr
from raytrace_tpu_torch.scene.builder import SceneBuilder
from raytrace_tpu_torch.scene.camera import PerspectiveCamera

OCC_Z = 3.0
OCC_HALF = 0.4
CUBE_HALF = 0.35
LIGHT = (4.0, 0.0, 6.0)
# off the y-axis, so that both DOFs of the Jacobian tests get a gradient
DOF_LIGHT = (4.0, 1.3, 6.0)
INTENSITY = (120.0, 120.0, 120.0)
LIGHT_R = 0.4
N_LIGHT = 16
QUAD_FACES = np.array([[0, 1, 2], [0, 2, 3]])
FLOOR = np.array([[-8, -8, 0], [8, -8, 0], [8, 8, 0], [-8, 8, 0]],
                 np.float64)
X = np.array([1.0, 0.0, 0.0])
# the port's image derivatives against a reference (JAX's on the CPU, or
# the CPU's against the card's): relative L1, the share of the reference's
# nonzero pixels that may be off by more than OFF_REL of its largest entry,
# and the relative error of a weighted sum
REL_L1, OFF_SHARE, OFF_REL, SCALAR_REL = 1e-4, 0.01, 1e-3, 1e-4


def camera(device, size: int) -> PerspectiveCamera:
    c2w = tr.look_at((0.0, 0.0, 6.0), (0.0, 1e-6, 0.0), (0.0, 1.0, 0.0))
    return PerspectiveCamera.make(c2w, 2 * np.degrees(np.arctan(1.5 / 6.0)),
                                  size, size, device=device)


def occ_corners(theta: float) -> np.ndarray:
    """The quad occluder out of view (x ≥ 1.2 at z = 3), shifted by θ in x."""
    cx = 1.6 + theta
    return np.array([
        [cx - OCC_HALF, -OCC_HALF, OCC_Z],
        [cx + OCC_HALF, -OCC_HALF, OCC_Z],
        [cx + OCC_HALF, OCC_HALF, OCC_Z],
        [cx - OCC_HALF, OCC_HALF, OCC_Z],
    ])


def cube_mesh(center):
    """Closed axis-aligned cube: 8 verts, 12 consistently wound tris."""
    cx, cy, cz = center
    s = CUBE_HALF
    v = np.array([
        [cx - s, cy - s, cz - s], [cx + s, cy - s, cz - s],
        [cx + s, cy + s, cz - s], [cx - s, cy + s, cz - s],
        [cx - s, cy - s, cz + s], [cx + s, cy - s, cz + s],
        [cx + s, cy + s, cz + s], [cx - s, cy + s, cz + s],
    ])
    f = np.array([
        [0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
        [2, 3, 7], [2, 7, 6], [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7],
    ])
    return v, f


def icosphere(subdivisions: int, radius: float = 0.5, center=(0, 0, 0)):
    """A closed icosahedron subdivided `subdivisions` times (each triangle
    into four, the new vertices pushed onto the sphere), outward winding
    → (verts [10·4^s + 2, 3], faces [20·4^s, 3])."""
    p = (1.0 + 5.0 ** 0.5) / 2.0
    v = [[-1, p, 0], [1, p, 0], [-1, -p, 0], [1, -p, 0],
         [0, -1, p], [0, 1, p], [0, -1, -p], [0, 1, -p],
         [p, 0, -1], [p, 0, 1], [-p, 0, -1], [-p, 0, 1]]
    f = [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
         [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
         [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
         [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]]
    verts = [np.asarray(x, np.float64) / np.linalg.norm(x) for x in v]
    for _ in range(subdivisions):
        mid = {}

        def midpoint(a, b):
            k = (min(a, b), max(a, b))
            if k not in mid:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                mid[k] = len(verts) - 1
            return mid[k]

        nf = []
        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        f = nf
    return (np.asarray(center, np.float64) + radius * np.stack(verts),
            np.asarray(f, np.int64))


def occluder_scene(device, verts, faces, occ_kd=(0.3, 0.3, 0.3),
                   light=LIGHT, use_bvh=None):
    """Floor (matte 0.7, material 0), the occluder mesh (material 1) and a
    point light."""
    b = SceneBuilder()
    floor = b.matte((0.7, 0.7, 0.7))
    occ = b.matte(occ_kd)
    b.triangle_mesh(FLOOR, QUAD_FACES, material=floor)
    b.triangle_mesh(np.asarray(verts, np.float64), faces, material=occ)
    b.point_light(light, INTENSITY)
    return b.build(device, use_bvh=use_bvh)


def quad_scene(device, theta: float):
    return occluder_scene(device, occ_corners(theta), QUAD_FACES)


def cube_scene(device, theta: float):
    """The closed cube out of view → (scene, verts, faces)."""
    v, f = cube_mesh((1.7 + theta, 0.0, OCC_Z))
    return occluder_scene(device, v, f), v, f


def in_view_cube_scene(device, theta: float):
    """The cube IN VIEW at z = 0.8, material (0.25, 0.4, 0.3) → (scene,
    verts, faces)."""
    v, f = cube_mesh((0.3 + theta, 0.0, 0.8))
    return occluder_scene(device, v, f, occ_kd=(0.25, 0.4, 0.3)), v, f


def mesh_builder(device, faces, light=LIGHT):
    """build_scene for the fits: verts (a tensor) → the occluder scene."""
    return lambda verts: occluder_scene(
        device, verts.detach().cpu().numpy(), faces, light=light)


def dof_parts(device):
    """The quad out of view under DOF_LIGHT with two velocity fields (rigid
    x and y translation) → (base verts, vel [2, 4, 3], build_scene)."""
    vel = np.zeros((2, 4, 3), np.float64)
    vel[0, :, 0] = 1.0
    vel[1, :, 1] = 1.0
    return occ_corners(0.0), vel, mesh_builder(device, QUAD_FACES,
                                               light=DOF_LIGHT)


def penumbra_base_verts() -> np.ndarray:
    return occ_corners(0.0)


def penumbra_scene(device, verts, kd_floor=(0.7, 0.7, 0.7)):
    """The quad out of view under a disk light of radius 0.4 at (4, 0, 6)
    aimed at (1.6, 0, 0), 16 light samples."""
    b = SceneBuilder()
    floor = b.matte(kd_floor)
    occ = b.matte((0.3, 0.3, 0.3))
    b.triangle_mesh(FLOOR, QUAD_FACES, material=floor)
    b.triangle_mesh(np.asarray(verts, np.float64), QUAD_FACES, material=occ)
    o2w = tr.look_at(LIGHT, (1.6, 0.0, 0.0), (0.0, 1.0, 0.0))
    b.area_light_disk((60.0, 60.0, 60.0), radius=LIGHT_R,
                      object_to_world=o2w, n_samples=N_LIGHT)
    return b.build(device)


def penumbra_builder(device):
    return lambda verts: penumbra_scene(device, verts.detach().cpu().numpy())


def weights(size: int, seed: int = 3) -> np.ndarray:
    """A fixed random pixel weighting [size, size, 3]: a scalar loss that
    sees the shape of a shadow, not just its area."""
    return np.random.default_rng(seed).uniform(
        size=(size, size, 3)).astype(np.float32)


def dimg_check(got, want, spread=None) -> dict:
    """Hold an image derivative `got` [H, W, 3] to `want` (numpy): relative
    L1 ≤ REL_L1, at most OFF_SHARE of want's nonzero pixels off by more
    than OFF_REL of max |want|, and Σ weights·dimg within SCALAR_REL
    relative. `spread` [H, W, 3] ≥ 0, what two runs of the same call differ
    by, widens each bound by itself: its sum, its largest entry and its
    weighted sum. → the measures; AssertionError past a bound."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    spread = (np.zeros_like(want) if spread is None
              else np.asarray(spread, np.float64))
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"dimg: shape {got.shape} against "
                             f"{want.shape}, or not finite")
    scale = np.abs(want).max()
    diff = np.abs(got - want)
    w = weights(want.shape[0])
    out = dict(
        rel_l1=float(diff.sum() / np.abs(want).sum()),
        rel_l1_bound=float(REL_L1 + spread.sum() / np.abs(want).sum()),
        nonzero_pixels=int((want != 0.0).any(-1).sum()),
        off_pixels=int((diff > OFF_REL * scale + spread.max()).any(-1)
                       .sum()),
        weighted=float((got * w).sum()),
        weighted_want=float((want * w).sum()),
        weighted_bound=float(SCALAR_REL * abs((want * w).sum())
                             + (spread * w).sum()))
    if not (scale > 0.0 and out["rel_l1"] <= out["rel_l1_bound"]
            and out["off_pixels"] <= OFF_SHARE * out["nonzero_pixels"]
            and abs(out["weighted"] - out["weighted_want"])
            <= out["weighted_bound"]):
        raise AssertionError(f"dimg off its reference: {out}")
    return out
