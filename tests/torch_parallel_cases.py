"""The ranks' side of tests/test_torch_sharded.py and
tests/test_torch_multihost.py: functions that
`raytrace_tpu_torch.parallel.launch` runs in spawned processes, each
returning what the test compares. This module imports torch and the port
only, so the spawned processes never import jax."""
import dataclasses
import os

import torch
from torch.distributed.device_mesh import DeviceMesh

from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.ops.photon_grid import PhotonMap
from raytrace_tpu_torch.parallel import multihost, sharded
from raytrace_tpu_torch.renderers import common
from raytrace_tpu_torch.renderers import photon
from raytrace_tpu_torch.scene.camera import generate_rays, pixel_samples
from raytrace_tpu_torch.utils import film


def sequential_render(scene, camera, config, key, mesh):
    """render_photon_sharded (jitter off) composed from the public pieces,
    each wave's photon map gathered before its gather pass: the order the
    pipelined waves must reproduce."""
    n_chips, chip = mesh.size(), sharded.mesh_index(mesh)
    k_pix, k_render = prng.split(key)
    xy, lens = pixel_samples(k_pix, config.width, config.height, config.spp,
                             jitter=False)
    n = xy.shape[0] // n_chips
    lo = chip * n
    k_light, k_photon = prng.split(prng.fold_in(k_render, 1), 2)
    rays = generate_rays(camera, xy[lo:lo + n], lens[lo:lo + n], config.spp)
    rec = common.camera_pass(scene, rays.o, rays.d, config, rays=rays)
    direct = common.direct_lighting(
        scene, rec, k_light, config, common.static_light_samples(scene,
                                                                 config),
        include_emitted=True, sample_ids=lo + torch.arange(n))
    state = photon.ProgressiveState(
        radius2=photon.initial_radius2(rec, config),
        photon_count=torch.zeros(n), flux=torch.zeros(n, 3),
        emitted=torch.zeros(n))
    paths = config.photon_paths // n_chips
    local = dataclasses.replace(config, photon_paths=paths)
    for p in range(config.photon_passes):
        pm = photon.trace_photons(scene, local, k_photon, p,
                                  path_offset=chip * paths)
        whole = PhotonMap(
            p=sharded.gather_rows(pm.p, mesh),
            alpha=sharded.gather_rows(pm.alpha, mesh),
            wi=sharded.gather_rows(pm.wi, mesh),
            valid=sharded.gather_rows(pm.valid.float(), mesh) > 0.5)
        state, _ = photon.gathering_pass(scene, rec, state, whole, config)
    L = sharded.gather_rows(photon.final_gathering(rec, direct, state), mesh)
    return film.splat(xy, L, config.width, config.height,
                      config.pixel_filter, config.filter_radius)


def _grad(params, new, lr):
    return torch.cat([(params.kd - new.kd).reshape(-1),
                      (params.intensity - new.intensity).reshape(-1)]) / lr


def sharded_world(rank, world, device, inp):
    """The cases of tests/test_torch_sharded.py on a world of 4 gloo ranks;
    the world-1 runs on a mesh of rank 0 alone while the others wait."""
    scene, cam, key = inp["scene"], inp["camera"], prng.PRNGKey(inp["seed"],
                                                                "cpu")
    mesh = sharded.make_mesh("cpu")
    solo = sharded.make_mesh("cpu", [0])
    out = {}
    render = lambda cfg, m: sharded.render_photon_sharded(
        scene, cam, cfg, key, m, jitter=False)
    out["img4"], aux = sharded.render_photon_sharded(
        scene, cam, inp["render"], key, mesh, jitter=False, return_aux=True)
    out["aux4"] = aux
    out["odd4"] = render(inp["odd"], mesh)
    out["pipelined"] = render(inp["passes"], mesh)
    out["sequential"] = sequential_render(scene, cam, inp["passes"], key,
                                          mesh)
    try:
        render(inp["indivisible"], mesh)
    except AssertionError as e:
        out["indivisible"] = str(e)
    loss, new = sharded.train_step_sharded(
        inp["params"], inp["target"], scene, cam, inp["train"], key, mesh,
        lr=inp["lr"])
    out["loss4"], out["grad4"] = float(loss), _grad(inp["params"], new,
                                                    inp["lr"])
    out["kd4"], out["intensity4"] = new.kd, new.intensity
    if rank == 0:
        out["img1"] = render(inp["render"], solo)
        loss, new = sharded.train_step_sharded(
            inp["params"], inp["target"], scene, cam, inp["train"], key, solo,
            lr=inp["lr"])
        out["loss1"], out["grad1"] = float(loss), _grad(inp["params"], new,
                                                        inp["lr"])
    return out


def multihost_world(rank, world, device, inp):
    """The cases of tests/test_torch_multihost.py on a world of 4 gloo
    ranks: the (2, 2) mesh against the flat one, make_hierarchical_mesh on
    one host, scaling_report at counts (1, 2), and the world-1 frame of the
    two-process case on rank 0 alone."""
    scene, cam, cfg = inp["scene"], inp["camera"], inp["render"]
    key = prng.PRNGKey(inp["seed"], "cpu")
    flat = sharded.make_mesh("cpu")
    hier = DeviceMesh("cpu", torch.arange(4, dtype=torch.int).reshape(2, 2),
                      mesh_dim_names=("hosts", "chips"))
    solo = sharded.make_mesh("cpu", [0])
    one_host = multihost.make_hierarchical_mesh("cpu")
    rows = torch.arange(6, dtype=torch.float32).reshape(3, 2) + 10 * rank
    out = dict(
        index_flat=sharded.mesh_index(flat),
        index_hier=sharded.mesh_index(hier),
        rows_flat=sharded.gather_rows(rows, flat),
        rows_hier=sharded.gather_rows(rows, hier),
        one_host_shape=list(one_host.mesh.shape),
        one_host_names=list(multihost.flat_mesh_axis_order(one_host)),
        img_flat=sharded.render_photon_sharded(scene, cam, cfg, key, flat,
                                               jitter=False),
        img_hier=sharded.render_photon_sharded(scene, cam, cfg, key, hier,
                                               jitter=False),
        scaling=multihost.scaling_report(scene, cam, inp["scaling"], key,
                                         device_counts=(1, 2), n_iters=1))
    if rank == 0:
        out["img_two_proc_1"] = sharded.render_photon_sharded(
            scene, cam, inp["two_proc"], key, solo, jitter=False)
    return out


def two_process_from_env(rank, port, inp):
    """One of two processes that join through initialize_distributed from
    torch's environment variables, as a launcher would set them, and render
    on the hierarchical mesh (one host: (1, 2))."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE="2", RANK=str(rank))
    try:
        joined = multihost.initialize_distributed(device_id="cpu")
        again = multihost.initialize_distributed(device_id="cpu")
        mesh = multihost.make_hierarchical_mesh("cpu")
        img = sharded.render_photon_sharded(
            inp["scene"], inp["camera"], inp["two_proc"],
            prng.PRNGKey(inp["seed"], "cpu"), mesh, jitter=False)
        return dict(joined=joined, again=again, shape=list(mesh.mesh.shape),
                    img=img)
    finally:
        torch.distributed.destroy_process_group()
