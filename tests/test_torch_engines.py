"""The port's two cluster-scene engines (ops/cluster_intersect.py, kernels
K6 and K7; ops/epoch_intersect.py, K8 and K9; their plain versions on the
CPU) against the dense route (ops/tri_intersect.py `intersect_triangles`,
kernel K1's plain version) on the same triangles. Each launch here is one
that JAX's fixed-size pair budgets cut: the terrain's rays at a budget of 4
pairs and in two rounds (tests/test_torch_cluster.py), the epoch engine's
starved budget (tests/test_torch_epoch.py) and the emission of the glass
Cornell box's photons (tests/test_torch_caustic.py). The port's engines run
every pair of a launch, so each gives the dense route's hits."""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from tests.test_cluster_intersect import down_rays, field_scene
from tests.test_torch_caustic import toy  # noqa: F401 (a fixture)
from tests.test_torch_epoch import _case
from tests.torch_port_util import n, t
from benchmark import program
from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.ops import cluster_intersect as p_ci
from raytrace_tpu_torch.ops import epoch_intersect as p_ei
from raytrace_tpu_torch.ops import tri_intersect
from raytrace_tpu_torch.renderers import photon

BIG = 1e30
ENGINES = {"cluster": p_ci.intersect_clusters, "epoch": p_ei.intersect_epochs}
CASES = ["pair_budget_4", "two_rounds", "starved_budget", "caustic_emission"]


def _soup(v0, v1, v2, cluster_size):
    tris = types.SimpleNamespace(v0=t(v0), v1=t(v1), v2=t(v2))
    return tris, p_ci.build_clusters(v0, v1, v2, "cpu",
                                     cluster_size=cluster_size)


def _launch(case, request):
    """(triangles, their cluster set, o, d, tmin, tmax) of one case."""
    if case in ("pair_budget_4", "two_rounds"):
        tris = field_scene(n_tris=4000).tris
        v0, v1, v2 = (np.asarray(x) for x in (tris.v0, tris.v1, tris.v2))
        k, seed = (512, 12) if case == "pair_budget_4" else (1024, 8)
        o, d = (t(n(x)) for x in down_rays(k, seed=seed))
        return _soup(v0, v1, v2, 256) + (
            o, d, torch.full((k,), 1e-3), torch.full((k,), BIG))
    if case == "starved_budget":
        (v0, v1, v2), (o, d, tmin, tmax), _ = _case(case)
        return _soup(v0, v1, v2, 128) + (t(o), t(d), t(tmin), t(tmax))
    _, scene, _, render = request.getfixturevalue("toy")
    config = program.render_config(render)
    em = photon.emission(scene, config, prng.PRNGKey(7, "cpu"), 0)
    k = em["o"].shape[0]
    return (scene.tris, scene.clusters, em["o"], em["d"],
            torch.full((k,), config.scene_epsilon),
            torch.where(em["alive"], BIG, 0.0))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("engine", list(ENGINES))
def test_engine_equals_the_dense_route(engine, case, request):
    """(t, idx) of the engine against the dense route's: the same rays hit,
    the same triangle wins, t within rtol 1e-5 and atol 1e-6 (the tolerances
    of tests/test_torch_caustic.py's chain against the dense route)."""
    tris, clusters, o, d, tmin, tmax = _launch(case, request)
    t_e, i_e = ENGINES[engine](clusters, o, d, tmin, tmax)
    t_d, i_d, _, _ = tri_intersect.intersect_triangles(tris, o, d, tmin,
                                                       tmax)
    hit = t_d < BIG
    assert hit.any()
    assert torch.equal(t_e < BIG, hit)
    assert torch.equal(i_e[hit], i_d[hit])
    torch.testing.assert_close(t_e[hit], t_d[hit], rtol=1e-5, atol=1e-6)
