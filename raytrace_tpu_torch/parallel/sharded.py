"""Rendering over several processes on torch.distributed (port of
raytrace_tpu/parallel/sharded.py).

One process per device, each a rank of a `DeviceMesh` (the stand-in for
JAX's `Mesh`): a 1-D ('chips',) mesh from `make_mesh`, or the 2-D
('hosts', 'chips') mesh of multihost.py. The collectives run on the
backend of the tensors' device: NCCL for CUDA tensors, gloo for CPU ones.

  - camera pixel samples are sharded over the ranks, a contiguous block
    each, outer axis major;
  - each rank traces a disjoint slice of the GLOBAL photon path ids
    (renderers/photon.py `trace_photons(path_offset=...)`): Halton indices,
    lights and bounce uniforms are pure functions of the global id, so the
    union over any rank count is the 1-rank photon set;
  - each wave's photon map is all-gathered (innermost axis first, then
    outward), so every rank holds the whole map, and each rank runs the
    gather pass on its own camera records;
  - the radiance L is all-gathered and every rank splats the whole image;
  - in train_step_sharded the scene-parameter gradients are summed over
    the ranks.

Every rank computes the same image and so the same loss. The backward of
the L gather therefore hands each rank its own rows of the gradient,
unsummed, while the backward of the photon-map gather sums over the ranks
(each rank gathered against the whole map with its own pixels) and keeps
the rank's own rows: JAX's transpose of all_gather, a psum_scatter, done
here as an all_reduce and a slice, which gloo and NCCL both offer.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch import Tensor
from torch.distributed.device_mesh import DeviceMesh

from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.core.config import RenderConfig
from raytrace_tpu_torch.ops.photon_grid import PhotonMap
from raytrace_tpu_torch.renderers import common
from raytrace_tpu_torch.renderers import photon as photon_renderer
from raytrace_tpu_torch.scene.camera import (PerspectiveCamera,
                                             generate_rays, pixel_samples)
from raytrace_tpu_torch.scene.scene import Scene
from raytrace_tpu_torch.utils import film

AXIS = "chips"


def require_device(device_type: str) -> None:
    """Refuse a device type the process cannot use: 'cuda' without a card
    raises rather than falling back to the CPU."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', not "
                         f"{device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device_type='cpu' to run "
                           "the ranks on the CPU")


def make_mesh(device_type: str = "cuda", ranks=None) -> DeviceMesh:
    """1-D ('chips',) mesh over `ranks` of the default process group (all
    of them by default), in that order. Building a mesh is collective:
    every rank of the default group calls it, those outside `ranks` too."""
    require_device(device_type)
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call multihost.initialize_distributed or "
            "torch.distributed.init_process_group first")
    ranks = range(dist.get_world_size()) if ranks is None else ranks
    return DeviceMesh(device_type, torch.tensor(list(ranks), dtype=torch.int),
                      mesh_dim_names=(AXIS,))


def mesh_index(mesh: DeviceMesh) -> int:
    """This rank's linear index in the mesh, outer axis major: the order in
    which the gathers below concatenate the ranks' rows."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError(f"rank {dist.get_rank()} is not in the mesh")
    index = 0
    for dim, c in enumerate(coord):
        index = index * mesh.size(dim) + c
    return index


def _all_gather(x: Tensor, group, async_op: bool = False):
    """(one output tensor per rank of `group`, the work or None)."""
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    return out, dist.all_gather(out, x, group=group, async_op=async_op)


def gather_rows(x: Tensor, mesh: DeviceMesh) -> Tensor:
    """Concatenate every rank's rows of x in mesh_index order: one
    all_gather per axis, innermost first (within a host), then outward."""
    for ax in reversed(mesh.mesh_dim_names):
        x = torch.cat(_all_gather(x.contiguous(), mesh.get_group(ax))[0])
    return x


def sum_over_mesh(x: Tensor, mesh: DeviceMesh) -> Tensor:
    """x summed over every rank of the mesh, in place: one all_reduce per
    axis."""
    for ax in reversed(mesh.mesh_dim_names):
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.get_group(ax))
    return x


class _RowGather(torch.autograd.Function):
    """gather_rows with its backward: the rank's own rows of the incoming
    gradient, summed over the ranks first when `sum_grads` (the photon
    map, which every rank consumed whole) and not (the radiance L, whose
    gathered copies feed the same loss on every rank)."""

    @staticmethod
    def forward(ctx, x, mesh, sum_grads):
        ctx.mesh, ctx.sum_grads = mesh, sum_grads
        ctx.rows, ctx.index = x.shape[0], mesh_index(mesh)
        return gather_rows(x, mesh)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grads:
            g = sum_over_mesh(g.contiguous().clone(), ctx.mesh)
        lo = ctx.index * ctx.rows
        return g[lo:lo + ctx.rows], None, None


def start_gather(x: Tensor, mesh: DeviceMesh):
    """Start gathering x's rows over the mesh → a function that waits for
    them and returns the gathered tensor. The innermost axis's all_gather
    runs asynchronously (NCCL on its own stream, gloo on its own thread),
    so work issued before the wait overlaps it; the outer axes are gathered
    at the wait. The closure holds x and the outputs until then. A tensor
    that takes a gradient is gathered at once, through _RowGather."""
    if x.requires_grad:
        y = _RowGather.apply(x, mesh, True)
        return lambda: y
    axes = mesh.mesh_dim_names
    x = x.contiguous()
    out, work = _all_gather(x, mesh.get_group(axes[-1]), async_op=True)
    held = (x, out)

    def wait():
        work.wait()
        y = torch.cat(held[1])
        for ax in reversed(axes[:-1]):
            y = torch.cat(_all_gather(y, mesh.get_group(ax))[0])
        return y

    return wait


def _pack_photons(pm: PhotonMap) -> Tensor:
    """p, alpha, wi and valid as one float32 [S, 10] tensor: one collective
    a wave, and no bool tensor, which not every backend gathers."""
    return torch.cat([pm.p, pm.alpha, pm.wi,
                      pm.valid[:, None].to(torch.float32)], 1)


def _unpack_photons(t: Tensor) -> PhotonMap:
    return PhotonMap(p=t[:, 0:3].contiguous(), alpha=t[:, 3:6].contiguous(),
                     wi=t[:, 6:9].contiguous(), valid=t[:, 9] > 0.5)


def _radiance_shard(scene: Scene, camera: PerspectiveCamera, xy_s: Tensor,
                    lens_s: Tensor, key: Tensor, config: RenderConfig,
                    light_samples: tuple, mesh: DeviceMesh):
    """This rank's radiance for its block of pixel samples → (L [n, 3],
    this rank's counters: valid_photons, gather_overflow, pair_overflow).

    Waves are software-pipelined as in JAX: wave p's photon map starts its
    all_gather before the gather pass of wave p−1, so the transfer overlaps
    that pass. Each map still meets the state it would meet in sequence, so
    the result is the same."""
    n_chips = mesh.size()
    chip = mesh_index(mesh)
    keys = prng.split(prng.fold_in(key, 1), 2)
    k_light, k_photon = keys[0], keys[1]

    rays = generate_rays(camera, xy_s, lens_s, config.spp)
    rec = common.camera_pass(scene, rays.o, rays.d, config, rays=rays)
    # global pixel-sample ids: the light-sample uniforms are a function of
    # them, so N ranks draw the numbers one rank draws
    n_local = xy_s.shape[0]
    sample_ids = chip * n_local + torch.arange(n_local, dtype=torch.int64,
                                               device=xy_s.device)
    direct = common.direct_lighting(
        scene, rec, k_light, config, light_samples, include_emitted=True,
        sample_ids=sample_ids)
    zeros = lambda *s: torch.zeros((n_local, *s), dtype=torch.float32,
                                   device=xy_s.device)
    state = photon_renderer.ProgressiveState(
        radius2=photon_renderer.initial_radius2(rec, config),
        photon_count=zeros(), flux=zeros(3), emitted=zeros())

    paths_local = max(1, config.photon_paths // n_chips)
    cfg_local = dataclasses.replace(config, photon_paths=paths_local)
    aux = dict(valid_photons=0, gather_overflow=0, pair_overflow=0)

    def trace(p):
        photons = photon_renderer.trace_photons(
            scene, cfg_local, k_photon, p, path_offset=chip * paths_local)
        return start_gather(_pack_photons(photons), mesh)

    def gather(state, pending):
        state, info = photon_renderer.gathering_pass(
            scene, rec, state, _unpack_photons(pending()), config)
        aux["valid_photons"] = aux["valid_photons"] + info["valid_photons"]
        aux["gather_overflow"] = (aux["gather_overflow"]
                                  + info["gather_overflow"])
        return state

    pending = trace(0)
    for p in range(1, config.photon_passes):
        ahead = trace(p)
        state = gather(state, pending)
        pending = ahead
    state = gather(state, pending)
    # state.emitted counts the gathered maps' paths: paths_local · n_chips
    # a wave, JAX's `emitting`
    return photon_renderer.final_gathering(rec, direct, state), aux


def render_photon_sharded(scene: Scene, camera: PerspectiveCamera,
                          config: RenderConfig, key: Tensor,
                          mesh: DeviceMesh, jitter: bool = True,
                          return_aux: bool = False):
    """Progressive photon render sharded over the mesh → the whole
    [H, W, 3] image on every rank; with return_aux also the frame's
    counters (valid_photons, gather_overflow, pair_overflow) summed over
    the ranks. Every rank of the mesh calls it with the same arguments."""
    light_samples = common.static_light_samples(scene, config)
    img, aux = _render_sharded(scene, camera, key, config, light_samples,
                               jitter, mesh)
    if not return_aux:
        return img
    counts = torch.tensor([float(aux[k]) for k in sorted(aux)],
                          dtype=torch.float64, device=img.device)
    counts = sum_over_mesh(counts, mesh).tolist()
    return img, {k: int(v) for k, v in zip(sorted(aux), counts)}


def _render_sharded(scene: Scene, camera: PerspectiveCamera, key: Tensor,
                    config: RenderConfig, light_samples: tuple, jitter: bool,
                    mesh: DeviceMesh):
    """render_photon_sharded with the per-light sample counts given →
    (image, this rank's counters)."""
    if key.device.type != mesh.device_type:
        raise ValueError(f"key on {key.device}, mesh of "
                         f"{mesh.device_type} devices")
    n_chips = mesh.size()
    keys = prng.split(key)
    k_pix, k_render = keys[0], keys[1]
    xy, lens = pixel_samples(k_pix, config.width, config.height, config.spp,
                             jitter=jitter)
    if xy.shape[0] % n_chips != 0:
        raise AssertionError(f"pixel samples ({xy.shape[0]}) must divide the "
                             f"chip count {n_chips}")
    n_local = xy.shape[0] // n_chips
    lo = mesh_index(mesh) * n_local
    L, aux = _radiance_shard(scene, camera, xy[lo:lo + n_local],
                             lens[lo:lo + n_local], k_render, config,
                             light_samples, mesh)
    L = _RowGather.apply(L, mesh, False)
    img = film.splat(xy, L, config.width, config.height, config.pixel_filter,
                     config.filter_radius)
    return img, aux


def train_step_sharded(params, target: Tensor, scene: Scene,
                       camera: PerspectiveCamera, config: RenderConfig,
                       key: Tensor, mesh: DeviceMesh, lr: float = 0.05):
    """One inverse-rendering SGD step, sharded: the forward frame with rays
    and photons split over the ranks, the MSE loss against `target`, its
    gradient in `params` (SceneParams) summed over the ranks, and
    params − lr·gradient → (loss, new SceneParams), equal on every rank.
    Pixel samples are not jittered, as in JAX."""
    from raytrace_tpu_torch.diff.render import SceneParams, apply_params

    light_samples = common.static_light_samples(scene, config)
    leaves = SceneParams(kd=params.kd.detach().requires_grad_(True),
                         intensity=params.intensity.detach()
                         .requires_grad_(True))
    img, _ = _render_sharded(apply_params(scene, leaves), camera, key,
                             config, light_samples, False, mesh)
    loss = torch.mean((img - target) ** 2)
    grads = torch.autograd.grad(loss, (leaves.kd, leaves.intensity))
    flat = sum_over_mesh(torch.cat([g.reshape(-1) for g in grads]), mesh)
    g_kd, g_int = flat.split([g.numel() for g in grads])
    return loss.detach(), SceneParams(
        kd=params.kd - lr * g_kd.reshape(params.kd.shape),
        intensity=params.intensity - lr * g_int.reshape(
            params.intensity.shape))
