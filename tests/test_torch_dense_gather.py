"""The port's dense small-map gather (compaction + kernel K4's plain version)
against `gather_radius_pallas` in interpret mode, on the inputs of
tests/test_pallas.py's dense-gather test and on edge cases.

Tolerance: the Pallas kernel multiplies kd into each chunk's partial sum,
the port once into the whole sum, and the two add the terms in different
orders: L rtol 1e-5. Counts M and the compaction order are exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import n, t
from raytrace_tpu.ops import pallas_gather as j_gather
from raytrace_tpu.ops import photon_grid as j_grid
from raytrace_tpu_torch.ops import dense_gather as p_dense
from raytrace_tpu_torch.ops import photon_grid as p_grid

RTOL, ATOL = 1e-5, 1e-6


def _fixture(seed=19, P=1000, N=200, valid=None):
    """tests/test_pallas.py:69's inputs (seed 19); `valid` overrides the
    validity mask."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-2, 2, (P, 3)).astype(np.float32)
    alpha = rng.uniform(0, 1, (P, 3)).astype(np.float32)
    wi = rng.normal(size=(P, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    v = rng.uniform(size=P) < 0.7
    qp = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    r2 = rng.uniform(0.05, 0.25, N).astype(np.float32)
    ns = rng.normal(size=(N, 3)).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=-1, keepdims=True)
    kd = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    return p, alpha, wi, v if valid is None else valid, qp, r2, ns, kd


def _both(p, alpha, wi, valid, qp, r2, ns, kd):
    """(JAX (L, M), port (L, M)), each through its own compaction."""
    J = jnp.asarray
    jL, jm = j_gather.gather_radius_pallas(
        *j_gather.compact_photons(j_grid.PhotonMap(
            p=J(p), alpha=J(alpha), wi=J(wi), valid=J(valid))),
        J(qp), J(r2), J(ns), J(kd), interpret=True)
    pp, pa, pw, pv, nv = p_dense.compact_photons(p_grid.PhotonMap(
        p=t(p), alpha=t(alpha), wi=t(wi), valid=t(valid)))
    pL, pm = p_dense.gather_radius_dense_tiles(pp, pa, pw, pv, nv, t(qp),
                                               t(r2), t(ns), t(kd))
    return (n(jL), n(jm)), (n(pL), n(pm))


def _valid_mask(case, P=1536):
    rng = np.random.default_rng(7)
    if case == "none":
        return np.zeros(P, bool)
    # exactly 1024 valid photons: the valid prefix ends on a chunk edge
    # (the port's 512-photon chunks, JAX's 512-photon tile)
    v = np.zeros(P, bool)
    v[rng.permutation(P)[:1024]] = True
    return v


@pytest.mark.parametrize("case", ["pallas_inputs", "none", "chunk_edge"])
def test_dense_gather_matches_pallas_interpret(case):
    if case == "pallas_inputs":
        args = _fixture()
    else:
        args = _fixture(seed=3, P=1536, N=300, valid=_valid_mask(case))
    (jL, jm), (pL, pm) = _both(*args)
    np.testing.assert_array_equal(pm, jm)
    np.testing.assert_allclose(pL, jL, rtol=RTOL, atol=ATOL)
    if case == "none":
        assert pm.sum() == 0 and np.abs(pL).sum() == 0.0
    else:
        assert pm.sum() > 0
        # and the port's exact all-pairs gather agrees
        p, alpha, wi, valid, qp, r2, ns, kd = args
        dL, dm = p_grid.gather_radius_dense(
            p_grid.PhotonMap(p=t(p), alpha=t(alpha), wi=t(wi),
                             valid=t(valid)),
            t(qp), t(r2), t(ns), t(kd))
        np.testing.assert_array_equal(pm, n(dm))
        np.testing.assert_allclose(pL, n(dL), rtol=RTOL, atol=ATOL)


def test_compact_photons_order_matches_jax():
    p, alpha, wi, valid, *_ = _fixture(seed=5, P=777)
    J = jnp.asarray
    got = p_dense.compact_photons(p_grid.PhotonMap(
        p=t(p), alpha=t(alpha), wi=t(wi), valid=t(valid)))
    want = j_gather.compact_photons(j_grid.PhotonMap(
        p=J(p), alpha=J(alpha), wi=J(wi), valid=J(valid)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), n(w))
    assert got[4].dtype == torch.int32
    nv = int(got[4])
    assert n(got[3])[:nv].all() and not n(got[3])[nv:].any()


def test_k4_wrapper_takes_plain_version_on_cpu():
    p, alpha, wi, valid, qp, r2, ns, kd = _fixture(seed=2, P=700, N=300)
    pp, pa, pw, pv, nv = p_dense.compact_photons(p_grid.PhotonMap(
        p=t(p), alpha=t(alpha), wi=t(wi), valid=t(valid)))
    args = (t(qp), t(r2), t(ns), pp, pa, pw, pv, nv)
    before = p_dense.dense_S.launches
    got = p_dense.dense_S(*args)
    assert p_dense.dense_S.launches == before  # no kernel on CPU tensors
    np.testing.assert_array_equal(n(got), n(p_dense.dense_S_plain(*args)))
    assert got.shape == (4, 300) and n(got)[3].sum() > 0
