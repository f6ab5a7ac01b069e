"""The gradient of the port's row-span gather (`RowspanS`, whose backward is
kernel K3; its plain version on the CPU) against `jax.grad` of
`gather_radius_pallas_rowspan` in interpret mode (the custom VJP over
`_rowspan_bwd_kernel`), on fixtures shaped like tests/test_pallas.py's.

Tolerance: rtol 1e-4, atol 1e-5, as tests/test_pallas.py holds the JAX VJP
against dense AD. Each dα and dkd entry is a sum of ≤ a few hundred float32
terms that the two sides add in different orders."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import n, t
from raytrace_tpu.ops import pallas_gather as j_gather
from raytrace_tpu_torch.ops import photon_grid as p_grid
from raytrace_tpu_torch.ops import rowspan_gather as p_gather

RTOL, ATOL = 1e-4, 1e-5
CHUNK = 256


def _fixture(seed=3, P=3000, N=500, valid_frac=0.8):
    """tests/test_pallas.py `_rowspan_fixture`, plus a cotangent of L."""
    rng = np.random.default_rng(seed)
    pp = rng.uniform(0, 8, (P, 3)).astype(np.float32)
    pa = rng.uniform(0, 1, (P, 3)).astype(np.float32)
    pw = rng.normal(size=(P, 3)).astype(np.float32)
    pw /= np.linalg.norm(pw, axis=1, keepdims=True)
    pv = rng.uniform(size=P) < valid_frac
    qp = rng.uniform(0, 8, (N, 3)).astype(np.float32)
    r2 = rng.uniform(0.01, 0.4, N).astype(np.float32)
    ns = rng.normal(size=(N, 3)).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=1, keepdims=True)
    kd = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    cot = rng.normal(size=(N, 3)).astype(np.float32)
    return pp, pa, pw, pv, qp, r2, ns, kd, cot


def _port_grad(pp, pa, pw, pv, qp, r2, ns, kd, cot, **kw):
    """(dα, dkd, overflow) of Σ L·cot through the port's row-span gather."""
    a = t(pa).requires_grad_(True)
    k = t(kd).requires_grad_(True)
    L, _, ovf, _ = p_gather.gather_radius_rowspan(
        t(pp), a, t(pw), t(pv), float(np.sqrt(r2.max())), t(qp), t(r2),
        t(ns), k, chunk=CHUNK, **kw)
    ga, gk = torch.autograd.grad((L * t(cot)).sum(), (a, k))
    return n(ga), n(gk), int(ovf)


def _jax_grad(pp, pa, pw, pv, qp, r2, ns, kd, cot, **kw):
    def loss(alpha, kd_):
        L, _, _ = j_gather.gather_radius_pallas_rowspan(
            pp, alpha, pw, pv, float(np.sqrt(r2.max())), qp, r2, ns, kd_,
            interpret=True, chunk=CHUNK, **kw)
        return jnp.sum(L * cot)

    ga, gk = jax.grad(loss, argnums=(0, 1))(jnp.asarray(pa), jnp.asarray(kd))
    return np.asarray(ga), np.asarray(gk)


# (name, fixture kwargs, capacity knobs): one exact round; capacity bought
# in rounds (the jobs span three of them); a forced overflow; no valid
# photon; the default budget, whose capacity exceeds n_jobs, so the job
# list ends in fill jobs
CASES = [
    ("exact", {}, dict(job_budget=64)),
    ("rounds", dict(seed=4), dict(job_budget=16, rounds=4)),
    ("overflow", dict(seed=9), dict(job_budget=30)),
    ("no_valid_photons", dict(seed=5, valid_frac=0.0), dict(job_budget=64)),
    ("default", dict(seed=6), {}),
]


@pytest.mark.parametrize("name,kw,knobs", CASES, ids=[c[0] for c in CASES])
def test_rowspan_grad_matches_pallas_interpret(name, kw, knobs):
    fx = _fixture(**kw)
    ga, gk, ovf = _port_grad(*fx, **knobs)
    ja, jk = _jax_grad(*fx, **knobs)
    assert (ovf > 0) == (name == "overflow")
    assert np.isfinite(ga).all() and np.isfinite(gk).all()
    np.testing.assert_allclose(ga, ja, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gk, jk, rtol=RTOL, atol=ATOL)
    if name == "no_valid_photons":
        assert not ga.any() and not gk.any()
    else:
        assert np.abs(ga).sum() > 0 and np.abs(gk).sum() > 0


def _jobs(pp, pa, pw, pv, qp, r2, ns, **knobs):
    return p_gather.rowspan_jobs(t(pp), t(pw), t(pa), t(pv),
                                 float(np.sqrt(r2.max())), t(qp), t(r2),
                                 t(ns), chunk=CHUNK, **knobs)


def _k3_args(jobs, cot):
    """K3's inputs for a query-order cotangent [N, 3]."""
    n_tiles = jobs["tile_begin"].shape[0]
    pid, begin, end = p_gather.chunk_major(jobs["pid"], jobs["n_valid"],
                                           jobs["n_chunks"], n_tiles)
    cotT = torch.zeros_like(jobs["qpT"])
    cotT[:, :cot.shape[0]] = t(cot)[jobs["qorder"]].T
    return pid, begin, end, n_tiles, jobs["qpT"], jobs["qr2"], jobs["qnsT"], \
        cotT, jobs["pdata"]


@pytest.mark.parametrize("knobs", [{}, dict(job_budget=30)],
                         ids=["fill_jobs", "overflow"])
def test_chunk_major_takes_each_valid_job_once(knobs):
    """The chunk-major list holds the first n_valid jobs and no fill job,
    each chunk's range holds its own jobs in tile order, and a chunk that
    no job touches has an empty range and a gradient of exactly 0."""
    pp, pa, pw, pv, qp, r2, ns, kd, cot = _fixture(seed=9)
    jobs = _jobs(pp, pa, pw, pv, qp, r2, ns, **knobs)
    args = _k3_args(jobs, cot)
    pid, begin, end = (n(x).astype(np.int64) for x in args[:3])
    nv, nc = int(jobs["n_valid"]), jobs["n_chunks"]
    if not knobs:
        assert len(n(jobs["pid"])) > nv  # capacity > n_jobs: fill jobs
    assert begin[0] == 0 and (begin[1:] == end[:-1]).all()
    assert end[-1] == nv
    np.testing.assert_array_equal(np.sort(pid[:nv]),
                                  np.sort(n(jobs["pid"])[:nv]))
    for c in range(nc):
        own = pid[begin[c]:end[c]]
        assert (own % nc == c).all() and (np.diff(own // nc) > 0).all()
    dout = n(p_gather.rowspan_S_bwd_plain(*args))
    empty = begin == end
    if knobs:
        assert empty.any()  # the overflow leaves chunks unscanned
    assert not dout[empty].any()
    assert dout[~empty, 3].sum() > 0


def test_k3_term_counts_equal_k2_counts():
    """Every (query, photon) pair within radius is one term of dα and one
    count of M: the photon term counts of K3's plain version sum to the
    query counts of K2's, over the same job list."""
    pp, pa, pw, pv, qp, r2, ns, kd, cot = _fixture(seed=2)
    jobs = _jobs(pp, pa, pw, pv, qp, r2, ns)
    fwd = p_gather.rowspan_S_plain(*[jobs[k] for k in (
        "pid", "tile_begin", "tile_end", "n_chunks", "qpT", "qr2", "qnsT",
        "pdata")])
    bwd = p_gather.rowspan_S_bwd_plain(*_k3_args(jobs, cot))
    assert int(fwd[3].sum()) == int(bwd[:, 3].sum()) > 0


def test_k3_wrapper_takes_plain_version_on_cpu_and_repeats():
    pp, pa, pw, pv, qp, r2, ns, kd, cot = _fixture(seed=7, P=900, N=300)
    args = _k3_args(_jobs(pp, pa, pw, pv, qp, r2, ns), cot)
    before = p_gather.rowspan_S_bwd.launches
    got = p_gather.rowspan_S_bwd(*args)
    assert p_gather.rowspan_S_bwd.launches == before  # no kernel on CPU
    assert torch.equal(got, p_gather.rowspan_S_bwd_plain(*args))
    assert torch.equal(got, p_gather.rowspan_S_bwd(*args))  # repeats


def test_rowspan_grad_matches_dense_autograd():
    """The row-span gradient equals plain autograd through the port's exact
    all-pairs gather (tests/test_pallas.py's dense-AD check)."""
    pp, pa, pw, pv, qp, r2, ns, kd, cot = _fixture()
    ga, gk, ovf = _port_grad(pp, pa, pw, pv, qp, r2, ns, kd, cot)
    assert ovf == 0
    a = t(pa).requires_grad_(True)
    k = t(kd).requires_grad_(True)
    L, _ = p_grid.gather_radius_dense(
        p_grid.PhotonMap(p=t(pp), alpha=a, wi=t(pw), valid=t(pv)), t(qp),
        t(r2), t(ns), k)
    da, dk = torch.autograd.grad((L * t(cot)).sum(), (a, k))
    np.testing.assert_allclose(ga, n(da), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gk, n(dk), rtol=RTOL, atol=ATOL)


def test_rowspan_grad_matches_central_differences():
    """Central differences of Σ L·cot on the largest-|gradient| entries of α
    and kd (tests/test_pallas.py's FD check of the JAX VJP). L is linear in
    each, so only float32 rounding separates the two."""
    pp, pa, pw, pv, qp, r2, ns, kd, cot = _fixture(seed=21, P=1500, N=300)
    ga, gk, _ = _port_grad(pp, pa, pw, pv, qp, r2, ns, kd, cot)

    def loss(alpha, kd_):
        L, _, _, _ = p_gather.gather_radius_rowspan(
            t(pp), t(alpha), t(pw), t(pv), float(np.sqrt(r2.max())), t(qp),
            t(r2), t(ns), t(kd_), chunk=CHUNK)
        return float((L * t(cot)).sum())

    h = 1e-2
    assert np.abs(ga).max() > 1e-4
    for g, base, other_first in ((ga, pa, True), (gk, kd, False)):
        for flat in np.argsort(-np.abs(g).ravel())[:3]:
            idx = np.unravel_index(flat, g.shape)
            e = np.zeros_like(base)
            e[idx] = h
            args = lambda x: (x, kd) if other_first else (pa, x)
            fd = (loss(*args(base + e)) - loss(*args(base - e))) / (2 * h)
            np.testing.assert_allclose(fd, g[idx], rtol=2e-2, atol=1e-4)
