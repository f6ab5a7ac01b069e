"""The port's Morton-span gather (the torch span prep + kernel K5's plain
version) against `gather_radius_pallas_grid` in interpret mode and against
the exact all-pairs gather, on tests/test_pallas.py's grid-gather inputs.

Tolerance: per query the flux is a sum the Pallas kernel and the plain
version add in different orders: L rtol 1e-5; counts M are exact."""
import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_port_util import n, t
from raytrace_tpu.ops import pallas_gather as j_gather
from raytrace_tpu_torch.ops import grid_gather as p_grid_gather
from raytrace_tpu_torch.ops import photon_grid as p_grid

RTOL, ATOL = 1e-5, 1e-6


def _fixture(seed=23, P=3000, N=300, cell=0.5):
    """tests/test_pallas.py:116's inputs: clustered photons, radii at or
    below the cell, counts off the tile boundaries."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-3, 3, (12, 3))
    p = (centers[rng.integers(0, 12, P)]
         + rng.normal(scale=0.4, size=(P, 3))).astype(np.float32)
    alpha = rng.uniform(0, 1, (P, 3)).astype(np.float32)
    wi = rng.normal(size=(P, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    valid = rng.uniform(size=P) < 0.8
    qp = rng.uniform(-3.5, 3.5, (N, 3)).astype(np.float32)
    r2 = rng.uniform(0.01, cell * cell, N).astype(np.float32)
    ns = rng.normal(size=(N, 3)).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=-1, keepdims=True)
    kd = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    return p, alpha, wi, valid, cell, qp, r2, ns, kd


@pytest.mark.parametrize("seed", [23, 29])
def test_grid_gather_matches_pallas_interpret_and_dense(seed):
    args = _fixture(seed=seed)
    J = jnp.asarray
    jL, jm = j_gather.gather_radius_pallas_grid(
        *(J(a) if isinstance(a, np.ndarray) else a for a in args),
        interpret=True, chunk=256)
    pL, pm = p_grid_gather.gather_radius_grid(
        *(t(a) if isinstance(a, np.ndarray) else a for a in args), chunk=256)
    np.testing.assert_array_equal(n(pm), n(jm))
    np.testing.assert_allclose(n(pL), n(jL), rtol=RTOL, atol=ATOL)
    assert n(pm).sum() > 0

    p, alpha, wi, valid, _, qp, r2, ns, kd = args
    dL, dm = p_grid.gather_radius_dense(
        p_grid.PhotonMap(p=t(p), alpha=t(alpha), wi=t(wi), valid=t(valid)),
        t(qp), t(r2), t(ns), t(kd))
    np.testing.assert_array_equal(n(pm), n(dm))
    np.testing.assert_allclose(n(pL), n(dL), rtol=RTOL, atol=ATOL)


def test_grid_gather_no_valid_photons():
    """tests/test_pallas.py:158's case."""
    rng = np.random.default_rng(5)
    P, N = 300, 130
    p = rng.uniform(-1, 1, (P, 3)).astype(np.float32)
    z3 = np.zeros((P, 3), np.float32)
    L, m = p_grid_gather.gather_radius_grid(
        t(p), t(z3), t(z3), t(np.zeros(P, bool)), 1.0,
        t(rng.uniform(-1, 1, (N, 3)).astype(np.float32)),
        t(np.full(N, 0.5, np.float32)),
        t(np.tile(np.float32([[0.0, 0.0, 1.0]]), (N, 1))),
        t(np.full((N, 3), 0.3, np.float32)), chunk=128)
    assert n(m).sum() == 0
    assert np.abs(n(L)).sum() == 0.0


def test_k5_spans_and_wrapper_on_cpu():
    """Each tile's span lies inside the photon chunks and covers every
    valid photon in reach of its queries; the wrapper takes the plain
    version on CPU tensors."""
    p, alpha, wi, valid, cell, qp, r2, ns, kd = _fixture(seed=31)
    sp = p_grid_gather.grid_spans(t(p), t(alpha), t(wi), t(valid), cell,
                                  t(qp), t(r2), t(ns), chunk=256)
    lo, nc = n(sp["lo_chunk"]), n(sp["nc"])
    n_chunks = sp["pdata"].shape[0]
    assert (lo >= 0).all() and (nc >= 0).all()
    assert (lo + nc <= n_chunks).all() and nc.max() > 0
    args = [sp[k] for k in ("lo_chunk", "nc", "qpT", "qr2", "qnsT", "pdata")]
    before = p_grid_gather.grid_S.launches
    got = p_grid_gather.grid_S(*args)
    assert p_grid_gather.grid_S.launches == before  # no kernel on CPU tensors
    np.testing.assert_array_equal(n(got), n(p_grid_gather.grid_S_plain(*args)))
    # the photons of a tile's span: every valid photon within any of its
    # queries' radius lies in it
    pdata = n(sp["pdata"])  # [n_chunks, 10, chunk]
    qpT, qr2 = n(sp["qpT"]), n(sp["qr2"])
    for tile in range(lo.shape[0]):
        span = pdata[lo[tile]:lo[tile] + nc[tile]].transpose(1, 0, 2)
        span = span.reshape(10, -1)
        q = qpT[:, tile * 128:(tile + 1) * 128]
        d2 = ((q[:, :, None] - p.T[:, None, valid]) ** 2).sum(0)
        near = (d2 < qr2[tile * 128:(tile + 1) * 128, None]).sum()
        sd2 = ((q[:, :, None] - span[:3, None, :]) ** 2).sum(0)
        in_span = ((sd2 < qr2[tile * 128:(tile + 1) * 128, None])
                   & (span[6] > 0)[None, :]).sum()
        assert in_span == near
