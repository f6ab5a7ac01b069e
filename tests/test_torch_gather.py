"""The port's row-span gather (the torch prep + kernel K2's plain version)
against `gather_radius_pallas_rowspan` in interpret mode and against the
exact all-pairs gather, on fixtures shaped like tests/test_pallas.py's.

Tolerance: per query the flux is a sum of ≤ a few hundred float32 terms,
which the Pallas kernel and the plain version add in different orders —
rtol 1e-5 covers that; counts M, overflow and coverage are exact."""
import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_port_util import n, t
from raytrace_tpu.ops import pallas_gather as j_gather
from raytrace_tpu.ops import photon_grid as j_grid
from raytrace_tpu_torch.ops import photon_grid as p_grid
from raytrace_tpu_torch.ops import rowspan_gather as p_gather

RTOL, ATOL = 1e-5, 1e-6


def _fixture(seed=3, P=3000, N=500, valid_frac=0.8):
    rng = np.random.default_rng(seed)
    pp = rng.uniform(0, 8, (P, 3)).astype(np.float32)
    pa = rng.uniform(0, 1, (P, 3)).astype(np.float32)
    pw = rng.normal(size=(P, 3)).astype(np.float32)
    pw /= np.linalg.norm(pw, axis=1, keepdims=True)
    pv = rng.uniform(size=P) < valid_frac
    qp = rng.uniform(0, 8, (N, 3)).astype(np.float32)
    r2 = rng.uniform(0.01, 0.4, N).astype(np.float32)
    r2[rng.uniform(size=N) < 0.1] = 0.0  # disabled queries (camera misses)
    ns = rng.normal(size=(N, 3)).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=1, keepdims=True)
    kd = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    return pp, pa, pw, pv, qp, r2, ns, kd


# (name, fixture kwargs, cell scale vs the largest radius, job_budget,
#  rounds): the exact case, a forced overflow, capacity bought in rounds,
#  no valid photons, and a cell much smaller than the radii
CASES = [
    ("exact", {}, 1.0, 64, 1),
    ("overflow", dict(seed=9), 1.0, 16, 1),
    ("rounds", dict(seed=4), 1.0, 8, 8),
    ("rounds_overflow", dict(seed=5), 1.0, 8, 3),
    ("no_valid_photons", dict(seed=5, valid_frac=0.0), 1.0, 64, 1),
    ("small_cell", dict(seed=6), 0.3, 256, 1),
]


@pytest.mark.parametrize("name,kw,cell_scale,budget,rounds", CASES,
                         ids=[c[0] for c in CASES])
def test_rowspan_matches_pallas_interpret(name, kw, cell_scale, budget,
                                          rounds):
    pp, pa, pw, pv, qp, r2, ns, kd = _fixture(**kw)
    cell = cell_scale * float(np.sqrt(r2.max()))
    J = jnp.asarray
    jL, jm, jovf, jcov = j_gather.gather_radius_pallas_rowspan(
        J(pp), J(pa), J(pw), J(pv), cell, J(qp), J(r2), J(ns), J(kd),
        interpret=True, chunk=256, job_budget=budget, rounds=rounds,
        return_covered=True)
    pL, pm, povf, pcov = p_gather.gather_radius_rowspan(
        t(pp), t(pa), t(pw), t(pv), cell, t(qp), t(r2), t(ns), t(kd),
        chunk=256, job_budget=budget, rounds=rounds)
    assert int(povf) == int(jovf)
    assert (int(povf) > 0) == name.endswith("overflow")
    np.testing.assert_array_equal(n(pcov), n(jcov))
    np.testing.assert_array_equal(n(pm), n(jm))
    np.testing.assert_allclose(n(pL), n(jL), rtol=RTOL, atol=ATOL)

    # covered queries are exact: they equal the all-pairs gather
    dL, dm = _dense_gather(pp, pa, pw, pv, qp, r2, ns, kd)
    cov = n(pcov)
    np.testing.assert_array_equal(n(pm)[cov], dm[cov])
    np.testing.assert_allclose(n(pL)[cov], dL[cov], rtol=RTOL, atol=ATOL)
    assert (n(pm)[~cov] == 0).all() and (n(pL)[~cov] == 0).all()
    if name == "no_valid_photons":
        assert n(pm).sum() == 0 and np.abs(n(pL)).sum() == 0
    else:
        assert n(pm).sum() > 0


def _dense_gather(pp, pa, pw, pv, qp, r2, ns, kd):
    """The port's exact gather, checked against JAX's on the way."""
    J = jnp.asarray
    jL, jm = j_grid.gather_radius_dense(
        j_grid.PhotonMap(p=J(pp), alpha=J(pa), wi=J(pw), valid=J(pv)),
        J(qp), J(r2), J(ns), J(kd))
    pL, pm = p_grid.gather_radius_dense(
        p_grid.PhotonMap(p=t(pp), alpha=t(pa), wi=t(pw), valid=t(pv)),
        t(qp), t(r2), t(ns), t(kd))
    np.testing.assert_array_equal(n(pm), n(jm))
    np.testing.assert_allclose(n(pL), n(jL), rtol=RTOL, atol=ATOL)
    return n(pL), n(pm)


@pytest.mark.parametrize("seed", [0, 1])
def test_morton3_matches(seed):
    cells = np.random.default_rng(seed).integers(0, 1024, (500, 3))
    np.testing.assert_array_equal(
        n(p_grid.morton3(t(cells))).astype(np.uint32),
        n(j_grid.morton3(jnp.asarray(cells, jnp.int32))))


def test_k2_wrapper_takes_plain_version_on_cpu():
    pp, pa, pw, pv, qp, r2, ns, kd = _fixture(seed=2, P=700, N=300)
    jobs = p_gather.rowspan_jobs(t(pp), t(pw), t(pa), t(pv),
                                 float(np.sqrt(r2.max())), t(qp), t(r2),
                                 t(ns), chunk=128)
    args = [jobs[k] for k in ("pid", "tile_begin", "tile_end", "n_chunks",
                              "qpT", "qr2", "qnsT", "pdata")]
    before = p_gather.rowspan_S.launches
    np.testing.assert_array_equal(n(p_gather.rowspan_S(*args)),
                                  n(p_gather.rowspan_S_plain(*args)))
    assert p_gather.rowspan_S.launches == before  # no kernel on CPU tensors
    # the job ranges tile the capacity-cut list in order
    b, e = n(jobs["tile_begin"]), n(jobs["tile_end"])
    assert b[0] == 0 and (b[1:] == e[:-1]).all() and (e >= b).all()
    assert e[-1] == int(jobs["n_jobs"])
