"""Visibility (geometry) gradients by edge sampling (port of
raytrace_tpu/diff/edges.py).

Pathwise AD through the renderer sees no geometry gradient: visibility is a
step in the occluder's position, so d(image)/d(occluder θ) is a boundary
integral that point sampling misses. For a point light (the boundary
formulation of Li et al. 2018, "Differentiable Monte Carlo Ray Tracing
through Edge Sampling", re-derived for the shadow case as in the JAX
package)

    dI_pixel/dθ = ∮_{shadow boundary} ΔL(x) · (v(x)·n_s(x)) dl

where the shadow boundary on a receiver is the occluder's silhouette
projected from the light, ΔL the radiance jump across it (the lit side's
direct term), v = dx/dθ the boundary velocity and n_s the in-surface normal
of the boundary curve, oriented toward the shadow. The disk-light
(penumbra) term averages that integral over a stratified grid of light
points; the primary term integrates the occluder's own silhouette seen
from the camera.

No derivative here goes through an intersection: the projection's JVPs are
in closed form, the tangents (edge velocity, curve direction, shadow-side
normal) are plain tensors, and every intersector call runs under
`torch.no_grad()`. `joint_loss_and_grad` takes the smooth parameters'
gradient by autograd through the renderer, as diff/render.py does. The
pixel splat is `index_add_`, which on a CUDA tensor adds with atomics, so
the last bits of a pixel that several samples hit may change from run to
run.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import Tensor

from raytrace_tpu_torch.core import vec
from raytrace_tpu_torch.core.config import RenderConfig
from raytrace_tpu_torch.core.sampling import concentric_sample_disk
from raytrace_tpu_torch.diff.render import SceneParams, apply_params
from raytrace_tpu_torch.ops import intersect as isect_ops
from raytrace_tpu_torch.renderers.simple import render_simple
from raytrace_tpu_torch.scene.camera import PerspectiveCamera, generate_rays
from raytrace_tpu_torch.scene.scene import LIGHT_AREA_DISK, Scene
from raytrace_tpu_torch.shading import light as light_ops
from raytrace_tpu_torch.shading import material as mat_ops

BIG = isect_ops.BIG


def _f32(x, device) -> Tensor:
    """x (tensor, array or sequence) as a float32 tensor on `device`."""
    if isinstance(x, Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x, np.float32), device=device)


def _index(x, device) -> Tensor:
    """Integer indices (tensor or array) as an int64 tensor on `device`."""
    if isinstance(x, Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.tensor(np.asarray(x, np.int64), device=device)


def _device_of(*xs) -> torch.device:
    """The device of the first tensor among xs; the CPU if none is one."""
    for x in xs:
        if isinstance(x, Tensor):
            return x.device
    return torch.device("cpu")


def _raster_chain(camera: PerspectiveCamera, p: Tensor):
    """→ (homogeneous raster points [N, 4], the linear map of a world
    tangent onto them [3, 4]): ph = [R^T (p - t), 1] · inv(raster_to_camera)^T.
    inv_ex is linalg.inv without its error check, which would read the
    device's status back to the host."""
    c2w = camera.camera_to_world  # [3, 4] affine
    r = c2w[:, :3]
    t = c2w[:, 3]
    p_cam = (p - t) @ r  # R^T (p - t): world → camera
    c2r = torch.linalg.inv_ex(camera.raster_to_camera).inverse
    ph = torch.cat([p_cam, torch.ones_like(p_cam[:, :1])], dim=-1) @ c2r.T
    return ph, r @ c2r[:, :3].T


def project_to_raster(camera: PerspectiveCamera, p: Tensor) -> Tensor:
    """World points [N, 3] → raster coordinates [N, 2] (the inverse of the
    camera's raster→camera→world ray chain, scene/camera.py)."""
    ph, _ = _raster_chain(camera, p)
    return ph[:, :2] / ph[:, 3:4]


def _project_jvp(camera: PerspectiveCamera, p: Tensor, *tangents: Tensor):
    """project_to_raster at p [N, 3] and its JVPs along each tangent [N, 3]
    → (xy [N, 2], [J·tangent [N, 2], ...]), by the quotient rule as JAX's
    jvp of the division forms it: da/b - a·db/b²."""
    ph, lin = _raster_chain(camera, p)
    w = ph[:, 3:4]
    outs = []
    for tan in tangents:
        dph = tan @ lin
        outs.append(dph[:, :2] / w - ph[:, :2] * dph[:, 3:4] / (w * w))
    return ph[:, :2] / w, outs


def _edge_samples(edge_v0: Tensor, edge_v1: Tensor, k: int):
    """K stratified midpoints on each of E edges → (ts [K], points [E·K, 3],
    edge directions [E·K, 3]), edge-major."""
    n_e = edge_v0.shape[0]
    ts = (torch.arange(k, dtype=torch.float32, device=edge_v0.device)
          + 0.5) / k
    e = (edge_v0[:, None, :] * (1.0 - ts)[None, :, None]
         + edge_v1[:, None, :] * ts[None, :, None]).reshape(n_e * k, 3)
    edot = (edge_v1 - edge_v0)[:, None, :].expand(n_e, k, 3).reshape(
        n_e * k, 3)
    return ts, e, edot


def _occluded(scene: Scene, o: Tensor, d: Tensor, config: RenderConfig):
    """Any hit on the segment o → o + d, its ends excluded by the shadow
    epsilon (a non-coherent launch, as JAX's estimators cast it)."""
    n, eps = o.shape[0], float(np.float32(config.shadow_epsilon))
    with torch.no_grad():
        return isect_ops.occluded(
            scene, o.contiguous(), d.contiguous(),
            torch.full((n,), eps, device=o.device),
            torch.full((n,), 1.0 - eps, device=o.device))


def _intersect(scene: Scene, o: Tensor, d: Tensor, tmin: Tensor,
               tmax: Tensor):
    with torch.no_grad():
        return isect_ops.intersect(scene, o.contiguous(), d.contiguous(),
                                   tmin, tmax)


def _splat(xy: Tensor, contrib: Tensor, config: RenderConfig) -> Tensor:
    """Scatter-add each sample into the pixel it lands in → [H, W, 3] (the
    derivative of a pixel's mean over unit raster area). `in_view` is taken
    on the floats, so a NaN or infinite raster point is out of view and
    never cast to an index."""
    w, h = config.width, config.height
    fx = torch.floor(xy[:, 0])
    fy = torch.floor(xy[:, 1])
    in_view = (fx >= 0) & (fx < w) & (fy >= 0) & (fy < h)
    px = torch.where(in_view, fx, 0.0).long()
    py = torch.where(in_view, fy, 0.0).long()
    contrib = torch.where(in_view[:, None], contrib, 0.0)
    dimg = torch.zeros((h * w, 3), dtype=torch.float32, device=xy.device)
    dimg.index_add_(0, py * w + px, contrib)
    return dimg.reshape(h, w, 3)


def _sample_velocity(edge_vel, ts: Tensor, n: int, device) -> Tensor:
    """Edge velocity [3], [E, 3] or per endpoint [E, 2, 3] → [E·K, 3] at the
    samples (per endpoint: lerped as the samples are, so a vertex field
    moves each sample by exactly this interpolant)."""
    edge_vel = _f32(edge_vel, device)
    if edge_vel.ndim == 3:
        edge_vel = (edge_vel[:, 0, None, :] * (1.0 - ts)[None, :, None]
                    + edge_vel[:, 1, None, :] * ts[None, :, None]
                    ).reshape(-1, 3)
    elif edge_vel.ndim == 2:
        edge_vel = torch.repeat_interleave(edge_vel, ts.shape[0], dim=0)
    return edge_vel.expand(n, 3)


def shadow_boundary_image_grad(
    scene: Scene,
    camera: PerspectiveCamera,
    config: RenderConfig,
    edge_v0,          # [E, 3] silhouette edge start points
    edge_v1,          # [E, 3] silhouette edge end points
    edge_vel,         # [3] rigid d(edge point)/dθ, [E, 3] per edge, or
                      # [E, 2, 3] per edge ENDPOINT (lerped along the edge)
    light_index: int = 0,
    samples_per_edge: int = 64,
    edge_mask=None,   # [E] bool: which edges are silhouette
    occluder_aabb=None,
    light_point=None,  # [3] override (an area-light sample)
    area_light: bool = False,  # ΔL in the area-light measure
    weight=1.0,       # scales ΔL (1/N light samples)
) -> Tensor:
    """d(image)/dθ for an occluder motion, by shadow-boundary edge sampling
    → [H, W, 3] on the scene's device (the derivative of each pixel's
    area-averaged radiance). Deterministic: each edge is sampled at K
    stratified midpoints, all E·K in one launch; masked-out edges
    contribute exactly zero.

    occluder_aabb=(lo, hi), for an occluder IN VIEW, drops two kinds of
    boundary points: those that land on the occluder itself (its own
    terminator, where the receiver moves with the parameter) and, by a
    camera-visibility ray, those hidden from the camera."""
    dev = scene.lights.o.device
    edge_v0, edge_v1 = _f32(edge_v0, dev), _f32(edge_v1, dev)
    lp = (scene.lights.o[light_index] if light_point is None
          else _f32(light_point, dev))
    k = samples_per_edge
    ts, e, edot = _edge_samples(edge_v0, edge_v1, k)
    n = e.shape[0]
    sample_mask = (torch.ones((n,), dtype=torch.bool, device=dev)
                   if edge_mask is None else torch.repeat_interleave(
                       torch.as_tensor(edge_mask, device=dev), k))
    u = _sample_velocity(edge_vel, ts, n, dev)

    # ---- project each edge sample from the light onto the receiver --------
    w = e - lp
    t_e = vec.length(w)
    w_hat = w / torch.clamp(t_e, min=1e-12)[:, None]
    eps = float(np.float32(config.scene_epsilon))
    hit = _intersect(scene, lp.expand(n, 3), w_hat,
                     t_e * (1.0 + 1e-4) + eps,
                     torch.full((n,), BIG, device=dev))
    x_b = hit.p
    n_r = vec.normalize(hit.ns)

    # ---- boundary velocity + curve direction on the receiver plane --------
    #   τ = n_r·(x_b - lp) / n_r·(e - lp)
    #   dx_b/dθ = τ [u - (n_r·u)/(n_r·(e-lp)) (e-lp)]   (u: edge velocity)
    # and the same with u → ė for the curve direction
    denom = vec.dot(n_r, e - lp)
    safe_denom = torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
    tau = vec.dot(n_r, x_b - lp) / safe_denom

    def in_plane(a):
        return tau[:, None] * (
            a - (vec.dot(n_r, a) / safe_denom)[:, None] * (e - lp))

    v_b = in_plane(u)
    m = in_plane(edot)
    m_len = vec.length(m)
    m_hat = m / torch.clamp(m_len, min=1e-12)[:, None]
    n_c = vec.normalize(vec.cross(n_r, m_hat))  # in-plane curve normal

    # ---- orient n_c toward the shadow side (probe both sides) -------------
    delta = 1e-3 * torch.clamp(t_e, min=1.0)
    probe = lambda x: _occluded(scene, x, lp - x, config)
    sh_plus = probe(x_b + delta[:, None] * n_c)
    sh_minus = probe(x_b - delta[:, None] * n_c)
    is_boundary = sh_plus != sh_minus  # exactly one side in shadow
    n_s = torch.where(sh_plus[:, None], n_c, -n_c)  # points INTO the shadow

    # ---- radiance jump across the boundary (lit-side direct term) ---------
    wl = lp - x_b
    r2 = torch.clamp(vec.length_squared(wl), min=1e-12)
    wl_hat = wl / torch.sqrt(r2)[:, None]
    f = mat_ops.f(scene.materials, hit.mat, wl_hat, wl_hat)
    cos_l = vec.absdot(n_r, wl_hat)
    intensity = scene.lights.intensity[light_index]
    if area_light:
        # one light-area sample y = light_point: the per-sample direct term
        # f·cosθ_x·Le·cosθ_y·A/r² (shading/light.py's illumination measure);
        # `weight` carries the 1/N of the light-sample average
        n_l = scene.lights.normal[light_index]
        cos_y = torch.clamp(-vec.dot(n_l.expand_as(wl_hat), wl_hat),
                            min=0.0)
        area = scene.lights.area[light_index]
        dl = f * (cos_l * cos_y * area / r2)[:, None] * intensity
    else:
        dl = f * (cos_l / r2)[:, None] * intensity  # [n, 3]
    dl = dl * weight

    # ---- move the integral to IMAGE space -----------------------------------
    # pixels average radiance over unit raster area: push the curve tangent,
    # the boundary velocity and the shadow-side normal through the
    # projection's Jacobian
    xy, (jm, jv, jn) = _project_jvp(camera, x_b, m, v_b, n_s)
    jm_len = torch.sqrt(torch.clamp(torch.sum(jm * jm, -1), min=1e-20))
    jm_hat = jm / jm_len[:, None]
    # in-image unit normal of the raster curve, oriented toward the shadow
    perp = torch.stack([-jm_hat[:, 1], jm_hat[:, 0]], dim=-1)
    sgn = torch.sign(torch.sum(perp * jn, dim=-1))
    n_im = perp * sgn[:, None]

    # lit region grows where the boundary moves INTO the shadow
    speed_im = torch.sum(jv * n_im, dim=-1)
    scale = speed_im * jm_len / k  # dl_image = |J·m| dt, dt = 1/K
    ok = hit.valid & is_boundary & (torch.abs(denom) > 1e-9) & sample_mask
    if occluder_aabb is not None:
        lo, hi = (_f32(b, dev) for b in occluder_aabb)
        margin = 1e-3
        on_occluder = torch.all(
            (x_b > lo[None, :] - margin) & (x_b < hi[None, :] + margin),
            dim=-1)
        cam_o = camera.camera_to_world[:, 3]
        cam_hidden = _occluded(scene, cam_o.expand(n, 3), x_b - cam_o,
                               config)
        ok = ok & ~on_occluder & ~cam_hidden
    contrib = torch.where(ok[:, None], dl * scale[:, None], 0.0)
    return _splat(xy, contrib, config)


def _light_points(scene: Scene, light_index: int, n: int) -> Tensor:
    """A gu × gv stratified concentric-disk grid of N points on a disk light
    → [N, 3], gu·gv == N (gu the largest divisor ≤ √N), so that every
    stratum is covered exactly once."""
    lights = scene.lights
    gu = int(np.floor(np.sqrt(n)))
    while n % gu:
        gu -= 1
    gv = n // gu
    jj = torch.arange(n, dtype=torch.float32, device=lights.o.device)
    u1 = (torch.remainder(jj, gu) + 0.5) / gu
    u2 = (torch.div(jj, gu, rounding_mode="floor") + 0.5) / gv
    dx, dy = concentric_sample_disk(u1, u2)
    return (lights.o[light_index][None, :]
            + dx[:, None] * lights.p1[light_index][None, :]
            + dy[:, None] * lights.p2[light_index][None, :])


def area_shadow_boundary_image_grad(
    scene: Scene,
    camera: PerspectiveCamera,
    config: RenderConfig,
    verts,            # occluder mesh vertices [V, 3]
    faces,            # [F, 3] topology
    edge_vel,         # [3] rigid d(edge point)/dθ
    light_index: int = 0,
    samples_per_edge: int = 64,
    n_light_samples: int = 8,
    occluder_aabb=None,
) -> Tensor:
    """PENUMBRA visibility gradient: d(image)/dθ for an occluder under a
    disk area light → [H, W, 3].

    Visibility V(x, y) is a step in θ for each light point y, so the
    derivative of the soft shadow is the average over light points of the
    sharp-shadow boundary integral with the silhouette taken w.r.t. each y:

        dI/dθ = (1/N) Σ_j ∮_{silhouette(y_j) proj} ΔL_j (v·n) dl

    over a stratified concentric-disk grid of light points."""
    dev = scene.lights.o.device
    edge_vid, edge_fid = mesh_edge_adjacency(np.asarray(faces))
    verts = _f32(verts, dev)
    vid = _index(edge_vid, dev)
    return _area_boundary_with_vel(
        scene, camera, config, verts, _index(faces, dev),
        _index(edge_fid, dev), verts[vid[:, 0]], verts[vid[:, 1]], edge_vel,
        light_index, samples_per_edge, n_light_samples, occluder_aabb)


def quad_boundary_edges(corners) -> tuple[Tensor, Tensor]:
    """The 4 boundary edges of a quad occluder (its silhouette w.r.t. any
    light not in its plane). corners: [4, 3] in loop order."""
    c = _f32(corners, _device_of(corners))
    return c, torch.roll(c, -1, dims=0)


# ---------------------------------------------------------------------------
# Silhouettes of triangle meshes (closed or open).
#
# The silhouette w.r.t. a viewpoint (a point light for shadow boundaries,
# the camera for primary-visibility boundaries) is the set of edges whose
# two faces face opposite sides of the viewpoint, plus the open-boundary
# edges of front-facing faces. Adjacency is static (host numpy, once per
# topology); the facing test runs on the vertices' device.
# ---------------------------------------------------------------------------


def mesh_edge_adjacency(faces) -> tuple:
    """Static edge topology of a triangle mesh. faces: [F, 3] int.

    Returns (edge_vid [E, 2] int32, edge_fid [E, 2] int32) — unique
    undirected edges and their adjacent faces (second face −1 for open
    boundary edges). Non-manifold edges (>2 faces) keep the first two."""
    faces = np.asarray(faces, np.int64)
    e = np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0)
    fid = np.tile(np.arange(len(faces)), 3)
    key = np.sort(e, axis=1)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    # grouped assignment of the first two face ids per unique edge,
    # vectorized (a Python loop over 3F half-edges is slow at mesh scale)
    order = np.argsort(inv, kind="stable")
    inv_s, fid_s = inv[order], fid[order]
    first = np.concatenate([[True], inv_s[1:] != inv_s[:-1]])
    rank = np.arange(len(inv_s)) - np.maximum.accumulate(
        np.where(first, np.arange(len(inv_s)), -1))
    edge_fid = np.full((len(uniq), 2), -1, np.int64)
    keep = rank < 2  # non-manifold edges (>2 faces) keep the first two
    edge_fid[inv_s[keep], rank[keep]] = fid_s[keep]
    return uniq.astype("int32"), edge_fid.astype("int32")


def _face_normals(verts: Tensor, faces: Tensor):
    """→ (unnormalized face normals [F, 3], each face's first vertex)."""
    v0 = verts[faces[:, 0]]
    return vec.cross(verts[faces[:, 1]] - v0, verts[faces[:, 2]] - v0), v0


def silhouette_mask(verts, faces, edge_fid, viewpoint) -> Tensor:
    """[E] bool: edge is on the silhouette w.r.t. `viewpoint` — its adjacent
    faces flip facing sign, or it is an open-boundary edge of a front-facing
    face. On the device of `verts`."""
    dev = verts.device
    faces, edge_fid = _index(faces, dev), _index(edge_fid, dev)
    n_f, v0 = _face_normals(verts, faces)
    front = vec.dot(n_f, _f32(viewpoint, dev)[None, :] - v0) > 0.0  # [F]
    f0 = edge_fid[:, 0]
    f1 = edge_fid[:, 1]
    fr0 = front[torch.clamp(f0, min=0)]
    fr1 = front[torch.clamp(f1, min=0)]
    return torch.where(f1 < 0, fr0, fr0 != fr1)


def silhouette_edges_full(verts, faces, viewpoint):
    """→ (edge_v0 [E, 3], edge_v1 [E, 3], mask [E], front_normal [E, 3]).

    front_normal is the unit normal of each edge's FRONT-facing adjacent
    face (the surface a viewer at `viewpoint` sees at the silhouette) —
    what primary_boundary_image_grad shades instead of re-intersecting a
    grazing ray.

    Static shape: ALL mesh edges come back with a boolean silhouette mask.
    The tensors lie on the device of `verts`, or of `viewpoint` when verts
    is an array."""
    dev = _device_of(verts, viewpoint)
    verts = _f32(verts, dev)
    faces_t = _index(faces, dev)
    viewpoint = _f32(viewpoint, dev)
    edge_vid, edge_fid = mesh_edge_adjacency(np.asarray(faces))
    edge_fid = _index(edge_fid, dev)
    vid = _index(edge_vid, dev)
    mask = silhouette_mask(verts, faces_t, edge_fid, viewpoint)

    n_raw, v0f = _face_normals(verts, faces_t)
    n_f = vec.normalize(n_raw)
    front = vec.dot(n_f, viewpoint[None, :] - v0f) > 0.0
    f0 = torch.clamp(edge_fid[:, 0], min=0)
    f1 = torch.clamp(edge_fid[:, 1], min=0)
    pick0 = front[f0] | (edge_fid[:, 1] < 0)
    front_n = torch.where(pick0[:, None], n_f[f0], n_f[f1])
    return verts[vid[:, 0]], verts[vid[:, 1]], mask, front_n


def silhouette_edges(verts, faces, viewpoint):
    """silhouette_edges_full without the front normals."""
    v0, v1, mask, _ = silhouette_edges_full(verts, faces, viewpoint)
    return v0, v1, mask


def _default_render(render):
    return render or (
        lambda s, c, cfg, k, j: render_simple(s, c, cfg, k, jitter=j))


def _moved_verts(base_verts, theta, direction, device):
    """(base_verts + θ·direction on `device`, direction as float32)."""
    direction = _f32(direction, device)
    if not isinstance(theta, Tensor):
        theta = float(theta)
    return _f32(base_verts, device) + theta * direction, direction


def translation_loss_and_grad(
    theta,
    direction,
    base_verts,
    faces,
    build_scene,
    camera: PerspectiveCamera,
    config: RenderConfig,
    target: Tensor,
    key,
    light_index: int = 0,
    samples_per_edge: int = 128,
    jitter: bool = True,
    render=None,
):
    """Geometry inverse rendering: MSE image loss and d(loss)/dθ for an
    occluder translated by θ·direction, where the image depends on θ ONLY
    through visibility (shadow boundaries):

        dL/dθ = Σ_pixels ∂L/∂I · dI/dθ,   dI/dθ = shadow-boundary integral

    with the mesh silhouette taken w.r.t. the light at the current θ.

    build_scene: verts (a tensor on the camera's device) → Scene. render:
    optional (scene, camera, config, key, jitter) → image; defaults to the
    simple renderer.

    Returns (loss [], dloss_dtheta [], image)."""
    render = _default_render(render)
    verts, direction = _moved_verts(base_verts, theta, direction,
                                    camera.camera_to_world.device)
    scene = build_scene(verts)
    img = render(scene, camera, config, key, jitter)
    loss = torch.mean((img - target) ** 2)

    lp = scene.lights.o[light_index]
    v0, v1, mask = silhouette_edges(verts, faces, lp)
    dimg = shadow_boundary_image_grad(
        scene, camera, config, v0, v1, direction,
        light_index=light_index, samples_per_edge=samples_per_edge,
        edge_mask=mask)
    dloss = torch.sum(2.0 * (img - target) * dimg) / img.numel()
    return loss, dloss, img


def joint_loss_and_grad(
    params,
    theta,
    direction,
    base_verts,
    faces,
    build_scene,
    camera: PerspectiveCamera,
    config: RenderConfig,
    target: Tensor,
    key,
    light_index: int = 0,
    samples_per_edge: int = 128,
    n_light_samples: int = 8,
    jitter: bool = True,
    include_primary: bool = False,
    render=None,
):
    """ONE differentiable loss over material AND geometry parameters:
    pathwise autograd for the smooth terms (albedo kd, emitter intensity)
    summed with the boundary visibility term for the occluder translation θ.

        L(params, θ) = mean‖render(params, θ) − target‖²
        ∂L/∂params   = autograd through the renderer (visibility fixed)
        ∂L/∂θ        = Σ_px 2(I−target)·dI/dθ,  dI/dθ = boundary integral
                       — PENUMBRA (disk light) or sharp (point light), by
                       the scene's light type, plus the optional
                       primary-visibility silhouette term.

    The pathwise θ-gradient is ~0 by design (hit geometry takes no
    gradient), so the boundary term IS the θ-gradient. The pathwise term is
    taken with respect to detached copies of params.kd and params.intensity
    (the caller's tensors are unchanged), through the render with
    config.differentiable set.

    build_scene: verts (a tensor on the camera's device) → Scene. render:
    optional (scene, camera, config, key, jitter) → image; defaults to the
    simple renderer.

    Returns (loss, g_params, g_theta, image)."""
    render = _default_render(render)
    verts, direction = _moved_verts(base_verts, theta, direction,
                                    camera.camera_to_world.device)
    scene0 = build_scene(verts)

    cfg_ad = (config if config.differentiable
              else dataclasses.replace(config, differentiable=True))
    leaves = SceneParams(
        kd=params.kd.detach().requires_grad_(True),
        intensity=params.intensity.detach().requires_grad_(True))
    img = render(apply_params(scene0, leaves), camera, cfg_ad, key, jitter)
    loss = torch.mean((img - target) ** 2)
    g_kd, g_int = torch.autograd.grad(loss, (leaves.kd, leaves.intensity))
    loss, img = loss.detach(), img.detach()
    scene = apply_params(scene0, params)

    # ---- boundary term for θ, by the light type --------------------------
    ltype = int(scene.lights.ltype[light_index])
    aabb = (torch.amin(verts, dim=0), torch.amax(verts, dim=0))
    if ltype == LIGHT_AREA_DISK:
        dimg = area_shadow_boundary_image_grad(
            scene, camera, config, verts, faces, direction,
            light_index=light_index, samples_per_edge=samples_per_edge,
            n_light_samples=n_light_samples, occluder_aabb=aabb)
    else:
        lp = scene.lights.o[light_index]
        v0, v1, mask = silhouette_edges(verts, faces, lp)
        dimg = shadow_boundary_image_grad(
            scene, camera, config, v0, v1, direction,
            light_index=light_index, samples_per_edge=samples_per_edge,
            edge_mask=mask, occluder_aabb=aabb)
    if include_primary:
        cam_o = camera.camera_to_world[:, 3]
        v0c, v1c, maskc, fn = silhouette_edges_full(verts, faces, cam_o)
        dimg = dimg + primary_boundary_image_grad(
            scene, camera, config, v0c, v1c, direction,
            light_index=light_index, samples_per_edge=samples_per_edge,
            edge_mask=maskc, front_normal=fn)
    g_theta = torch.sum(2.0 * (img - target) * dimg) / img.numel()
    return loss, SceneParams(kd=g_kd, intensity=g_int), g_theta, img


def recover_translation(
    theta0,
    direction,
    base_verts,
    faces,
    build_scene,
    camera: PerspectiveCamera,
    config: RenderConfig,
    target: Tensor,
    key,
    steps: int = 24,
    lr: float = 0.5,
    **kw,
):
    """Gradient-descent recovery of an occluder translation from a target
    image using ONLY the boundary gradient.

    The MSE of two shifted hard shadows grows ~|Δθ|, so the boundary
    gradient is signum-like: fixed-step descent oscillates around the
    optimum. The loop halves the step whenever the loss stops improving
    (backtracking), which converges geometrically on |θ−θ*|. Returns
    (theta_hat, losses), theta_hat the best-loss iterate."""
    theta = float(theta0)
    losses = []
    best_loss, best_theta, best_g = float("inf"), theta, 0.0
    for _ in range(steps):
        loss, g, _ = translation_loss_and_grad(
            theta, direction, base_verts, faces, build_scene, camera,
            config, target, key, **kw)
        loss, g = float(loss), float(g)
        losses.append(loss)
        if loss < best_loss:
            best_loss, best_theta, best_g = loss, theta, g
            theta = theta - lr * g
        else:
            lr *= 0.5  # overshoot: retry a shorter step from the best point
            theta = best_theta - lr * best_g
    return best_theta, losses


def jacobian_loss_and_grad(
    thetas,
    vel_fields,
    base_verts,
    faces,
    build_scene,
    camera: PerspectiveCamera,
    config: RenderConfig,
    target: Tensor,
    key,
    light_index: int = 0,
    samples_per_edge: int = 128,
    n_light_samples: int = 8,
    jitter: bool = True,
    render=None,
):
    """MULTI-DOF geometry gradients over a basis of per-vertex velocity
    fields:

        verts(θ) = base_verts + Σ_d θ_d · vel_fields[d]        θ ∈ R^D
        dL/dθ_d  = Σ_px 2(I−target)·dI/dθ_d
        dI/dθ_d  = boundary integral with the per-edge-ENDPOINT velocity
                   vel_fields[d][edge_vid] (lerped along each edge — exact
                   for a linear vertex field)

    thetas: [D]; vel_fields: [D, Vn, 3]. build_scene: verts (a tensor on the
    camera's device) → Scene. Disk lights get the penumbra boundary term,
    point lights the sharp one.

    Returns (loss, g_thetas [D], image)."""
    render = _default_render(render)
    dev = camera.camera_to_world.device
    thetas = _f32(thetas, dev)
    vel_fields = _f32(vel_fields, dev)  # [D, Vn, 3]
    verts = _f32(base_verts, dev) + torch.einsum("d,dvk->vk", thetas,
                                                 vel_fields)
    scene = build_scene(verts)
    img = render(scene, camera, config, key, jitter)
    loss = torch.mean((img - target) ** 2)

    edge_vid, edge_fid = mesh_edge_adjacency(np.asarray(faces))
    edge_fid = _index(edge_fid, dev)
    faces_t = _index(faces, dev)
    vid = _index(edge_vid, dev)
    ev0 = verts[vid[:, 0]]
    ev1 = verts[vid[:, 1]]
    aabb = (torch.amin(verts, dim=0), torch.amax(verts, dim=0))
    ltype = int(scene.lights.ltype[light_index])
    weights = 2.0 * (img - target) / img.numel()

    gs = []
    for d in range(vel_fields.shape[0]):
        vel_e = vel_fields[d][vid]  # [E, 2, 3]
        if ltype == LIGHT_AREA_DISK:
            dimg = _area_boundary_with_vel(
                scene, camera, config, verts, faces_t, edge_fid, ev0, ev1,
                vel_e, light_index, samples_per_edge, n_light_samples, aabb)
        else:
            lp = scene.lights.o[light_index]
            mask = silhouette_mask(verts, faces_t, edge_fid, lp)
            dimg = shadow_boundary_image_grad(
                scene, camera, config, ev0, ev1, vel_e,
                light_index=light_index, samples_per_edge=samples_per_edge,
                edge_mask=mask, occluder_aabb=aabb)
        gs.append(torch.sum(weights * dimg))
    return loss, torch.stack(gs), img


def _area_boundary_with_vel(
    scene, camera, config, verts, faces_t, edge_fid, ev0, ev1, vel_e,
    light_index, samples_per_edge, n_light_samples, occluder_aabb,
):
    """The stratified light-area quadrature of the penumbra boundary term,
    for any edge velocity shadow_boundary_image_grad takes: the light points
    in grid order, each with the silhouette w.r.t. that point, summed into
    the image in that order."""
    n = n_light_samples
    dimg = torch.zeros((config.height, config.width, 3), dtype=torch.float32,
                       device=verts.device)
    for y in _light_points(scene, light_index, n):
        mask = silhouette_mask(verts, faces_t, edge_fid, y)
        dimg = dimg + shadow_boundary_image_grad(
            scene, camera, config, ev0, ev1, vel_e,
            light_index=light_index, samples_per_edge=samples_per_edge,
            edge_mask=mask, occluder_aabb=occluder_aabb, light_point=y,
            area_light=True, weight=1.0 / n)
    return dimg


def recover_dofs(
    thetas0,
    vel_fields,
    base_verts,
    faces,
    build_scene,
    camera: PerspectiveCamera,
    config: RenderConfig,
    target: Tensor,
    key,
    steps: int = 30,
    lr: float = 0.5,
    **kw,
):
    """Multi-DOF occluder recovery by backtracking gradient descent on the
    boundary gradient (the ≥2-DOF companion of recover_translation).
    Returns (thetas_hat [D] numpy, losses)."""
    thetas = np.asarray(thetas0, np.float64)
    losses = []
    best = (float("inf"), thetas.copy(), np.zeros_like(thetas))
    for _ in range(steps):
        loss, g, _ = jacobian_loss_and_grad(
            thetas, vel_fields, base_verts, faces, build_scene, camera,
            config, target, key, **kw)
        loss = float(loss)
        g = g.double().cpu().numpy()
        losses.append(loss)
        if loss < best[0]:
            best = (loss, thetas.copy(), g.copy())
            thetas = thetas - lr * g / max(1e-12, np.linalg.norm(g))
        else:
            lr *= 0.5
            thetas = best[1] - lr * best[2] / max(
                1e-12, np.linalg.norm(best[2]))
    return best[1], losses


def primary_boundary_image_grad(
    scene: Scene,
    camera: PerspectiveCamera,
    config: RenderConfig,
    edge_v0,          # [E, 3] silhouette edges w.r.t. the CAMERA position
    edge_v1,
    edge_vel,         # [3] rigid d(edge point)/dθ, or [E, 3] per edge
    light_index: int = 0,
    samples_per_edge: int = 64,
    edge_mask=None,
    front_normal=None,  # [E, 3] from silhouette_edges_full
    front_mat: int = 0,  # occluder material id for L_front
) -> Tensor:
    """PRIMARY-visibility boundary term: d(image)/dθ from the occluder's own
    silhouette sweeping across pixels → [H, W, 3] (the in-view companion of
    shadow_boundary_image_grad):

        dI = (L_occluder − L_background) · (v_im · n_im) |J·ė| dt

    v_im / n_im are the image-space edge velocity and the unit normal of
    the projected silhouette oriented toward the BACKGROUND, and the two
    radiances direct-lit matte shading of the silhouette point and of the
    surface the camera ray hits beyond it.

    Supply front_normal + front_mat (silhouette_edges_full) where possible:
    L_front is then shaded analytically at the edge point with the front
    face's normal. The fallback re-intersects a ray through the silhouette
    point, which grazes the edge and misses ~half the samples in float32."""
    dev = scene.lights.o.device
    cam_o = camera.camera_to_world[:, 3]
    edge_v0, edge_v1 = _f32(edge_v0, dev), _f32(edge_v1, dev)
    k = samples_per_edge
    ts, e, edot = _edge_samples(edge_v0, edge_v1, k)
    n = e.shape[0]
    sample_mask = (torch.ones((n,), dtype=torch.bool, device=dev)
                   if edge_mask is None else torch.repeat_interleave(
                       torch.as_tensor(edge_mask, device=dev), k))
    u = _sample_velocity(edge_vel, ts, n, dev)
    eps = float(np.float32(config.scene_epsilon))
    lp = scene.lights.o[light_index]
    li = scene.lights.intensity[light_index]

    def shade(hit):
        """Direct-lit matte radiance at a hit, shadow ray included, plus
        the emitted radiance of an emitter hit."""
        wl = lp - hit.p
        r2 = torch.clamp(vec.length_squared(wl), min=1e-12)
        wl_hat = wl / torch.sqrt(r2)[:, None]
        f = mat_ops.f(scene.materials, hit.mat, wl_hat, wl_hat)
        cos_l = vec.absdot(vec.normalize(hit.ns), wl_hat)
        shadowed = _occluded(scene, hit.p, lp - hit.p, config)
        lo = f * cos_l[:, None] * (li / r2[:, None])
        lo = lo + light_ops.light_L(scene.lights, hit.light, -wl_hat)
        return torch.where((hit.valid & ~shadowed)[:, None], lo, 0.0), \
            hit.valid

    # front side: shade the silhouette point itself
    w = e - cam_o
    t_e = vec.length(w)
    w_hat = w / torch.clamp(t_e, min=1e-12)[:, None]
    o_b = cam_o.expand(n, 3)
    if front_normal is not None:
        # analytic: point e on the front face with its known normal
        ns_f = torch.repeat_interleave(_f32(front_normal, dev), k, dim=0)
        p_f = e + 1e-3 * ns_f  # lift off the surface for the shadow ray
        wl = lp - p_f
        r2 = torch.clamp(vec.length_squared(wl), min=1e-12)
        wl_hat = wl / torch.sqrt(r2)[:, None]
        f_b = mat_ops.f(
            scene.materials,
            torch.full((n,), front_mat, dtype=torch.int32, device=dev),
            wl_hat, wl_hat)
        cos_l = vec.absdot(ns_f, wl_hat)
        shadowed = _occluded(scene, p_f, lp - p_f, config)
        l_f = torch.where(~shadowed[:, None],
                          f_b * cos_l[:, None] * (li / r2[:, None]), 0.0)
        valid_f = torch.ones((n,), dtype=torch.bool, device=dev)
    else:
        hit_f = _intersect(scene, o_b, w_hat,
                           torch.full((n,), eps, device=dev),
                           t_e * (1.0 + 1e-4))
        l_f, valid_f = shade(hit_f)
    # back side: continue past the occluder
    hit_b = _intersect(scene, o_b, w_hat, t_e * (1.0 + 1e-4),
                       torch.full((n,), BIG, device=dev))
    l_b, _ = shade(hit_b)  # miss → black background (l_b already 0)
    dl = l_f - l_b

    # image-space geometry: the silhouette projects through the camera
    xy, (jm, jv) = _project_jvp(camera, e, edot, u)
    jm_len = torch.sqrt(torch.clamp(torch.sum(jm * jm, -1), min=1e-20))
    jm_hat = jm / jm_len[:, None]
    perp = torch.stack([-jm_hat[:, 1], jm_hat[:, 0]], dim=-1)

    # orient perp toward the BACKGROUND: probe camera rays half a pixel to
    # each side; the occluder side hits at ~t_e, the background side farther
    delta = 0.5
    half = torch.full((n, 2), 0.5, device=dev)

    def probe_t(xy_):
        rays = generate_rays(camera, xy_, half, 1)
        return _intersect(scene, rays.o, rays.d,
                          torch.full((n,), eps, device=dev),
                          torch.full((n,), BIG, device=dev)).t

    t_plus = probe_t(xy + delta * perp)
    t_minus = probe_t(xy - delta * perp)
    near = t_e * (1.0 + 1e-2)
    occ_plus = t_plus < near
    occ_minus = t_minus < near
    is_boundary = occ_plus != occ_minus
    sgn = torch.where(occ_plus, -1.0, 1.0)  # background side = +perp when
    n_im = perp * sgn[:, None]              # the +side is NOT the occluder

    speed_im = torch.sum(jv * n_im, dim=-1)
    scale = speed_im * jm_len / k
    ok = valid_f & is_boundary & sample_mask
    contrib = torch.where(ok[:, None], dl * scale[:, None], 0.0)
    return _splat(xy, contrib, config)
