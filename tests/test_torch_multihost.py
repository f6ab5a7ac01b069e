"""The port's multi-process layer (raytrace_tpu_torch/parallel/multihost.py,
parallel/dryrun.py and the launcher parallel/launch.py) on gloo ranks on
the CPU: process-group start-up from the environment, the hierarchical
('hosts', 'chips') mesh and its two-hop gather, scaling_report's
structure, a real two-process run, and the dry run.

One 4-rank world is spawned for the module (tests/torch_parallel_cases.py
`multihost_world`, in a thread while JAX compiles its (2, 2) mesh). Frames
are held to rtol 5e-4 and atol 5e-5, the JAX package's bound
(tests/test_multihost.py); against JAX, the pixels whose camera ray meets
a corner edge of the box may flip (tests/test_torch_sharded.py).
"""
import socket
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tests import torch_parallel_cases as cases
from tests.torch_port_util import (assert_frames_close,
                                  corner_edge_pixels, n, np_tree,
                                  port_scene)
from raytrace_tpu.core.config import RenderConfig as JConfig
from raytrace_tpu.parallel import sharded as J
from raytrace_tpu.scene import presets as j_presets
from raytrace_tpu_torch import interop
from raytrace_tpu_torch.core.config import RenderConfig as PConfig
from raytrace_tpu_torch.parallel import dryrun, launch, multihost, sharded

SIZE, SEED = 16, 2
BASE = dict(width=SIZE, height=SIZE, spp=1, scene_epsilon=1e-3,
            photon_paths=1 << 10, photon_passes=2, max_photon_bounces=4,
            exact_gather=True)
CASES = dict(
    render=BASE,
    scaling=dict(BASE, photon_paths=1 << 9, photon_passes=1,
                 exact_gather=False),
    # tests/_distributed_child.py's settings
    two_proc=dict(BASE, spp=4, photon_paths=1 << 9, photon_passes=1))
RTOL, ATOL = 5e-4, 5e-5


@pytest.fixture(scope="module")
def scene():
    return j_presets.cornell_box(SIZE)


@pytest.fixture(scope="module")
def inputs(scene):
    js, jc = scene
    return dict(scene=port_scene(js),
                camera=interop.camera_from_numpy(np_tree(jc), "cpu"),
                seed=SEED, **{k: PConfig(**v) for k, v in CASES.items()})


@pytest.fixture(scope="module")
def edge(inputs):
    return corner_edge_pixels(inputs["scene"], inputs["camera"],
                              inputs["render"])


@pytest.fixture(scope="module")
def world(inputs):
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(launch.run_world, cases.multihost_world, 4, "cpu",
                          (inputs,))


def test_initialize_distributed_noop_single_process(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize_distributed() is False
    assert multihost.initialize_distributed(
        "file:///nonexistent", world_size=1, rank=0, device_id="cpu") is False
    assert not torch.distributed.is_initialized()


def test_no_silent_fallback():
    """Without a process group, or asked for a card this process lacks, the
    entry points raise rather than run on something else."""
    with pytest.raises(RuntimeError, match="no process group"):
        sharded.make_mesh("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharded.make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun.dryrun_multichip(2)


def test_hierarchical_mesh_two_hop_gather_equals_flat(world):
    r = world.result()
    assert [x["index_hier"] for x in r] == [x["index_flat"] for x in r] == [
        0, 1, 2, 3]
    want = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    want = torch.cat([want + 10 * k for k in range(4)])
    for x in r:
        assert torch.equal(x["rows_flat"], want)
        assert torch.equal(x["rows_hier"], want)


def test_hierarchical_mesh_single_host(world):
    for x in world.result():
        assert x["one_host_shape"] == [1, 4]
        assert x["one_host_names"] == ["hosts", "chips"]


def test_hierarchical_render_matches_flat_and_jax(scene, world, edge):
    """The (2, 2) mesh: chip ids over both axes, photon maps gathered in two
    hops; photon_passes = 2, so wave 1's gather is pipelined."""
    js, jc = scene
    hmesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                 ("hosts", "chips"))
    j_img = J.render_photon_sharded(js, jc, JConfig(**CASES["render"]),
                                    jax.random.PRNGKey(SEED), hmesh,
                                    jitter=False)
    r = world.result()
    for x in r:
        assert torch.equal(x["img_hier"], r[0]["img_flat"])
    assert_frames_close(r[0]["img_hier"], j_img, edge)


def test_scaling_report_structure(world):
    for x in world.result():
        rep = x["scaling"]
        assert set(rep) == {1, 2, "efficiency"}
        assert rep[1] > 0 and rep[2] > 0
        assert np.isfinite(rep["efficiency"])


def test_two_process_distributed_render(inputs, world):
    """Two processes join through initialize_distributed from MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE and RANK (idempotent), build the hierarchical
    mesh on their one host, (1, 2), and render world 1's frame."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    got = launch.spawn(cases.two_process_from_env, 2, (port, inputs))
    want = world.result()[0]["img_two_proc_1"]
    for g in got:
        assert g["joined"] is True and g["again"] is True
        assert g["shape"] == [1, 2]
        np.testing.assert_allclose(n(g["img"]), n(want), rtol=RTOL,
                                   atol=ATOL)
    assert float(want.mean()) > 0.01


def test_dryrun_multichip_two_gloo_ranks():
    dryrun.dryrun_multichip(2, "cpu")
