"""The epoch engine of the PyTorch port (ops/epoch_intersect.py, kernels K8
and K9 through their plain versions) against the JAX package's
raytrace_tpu/ops/epoch_intersect.py, whose Pallas kernels run with
interpret=True, on the same numpy inputs, on the CPU. JAX's pair and
subpair budgets are its own: they must hold each launch here, while the
port runs every pair."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_epoch_intersect import _random_tris, _rays
from tests.torch_port_util import assert_t_close, n, port_scene, t
from raytrace_tpu.ops import cluster_intersect as j_ci
from raytrace_tpu.ops import epoch_intersect as j_ei
from raytrace_tpu.scene import presets as j_presets
from raytrace_tpu_torch.ops import cluster_intersect as p_ci
from raytrace_tpu_torch.ops import epoch_intersect as p_ei
from raytrace_tpu_torch.ops import epoch_kernels as ek
from raytrace_tpu_torch.ops import intersect as p_isect

BIG = 1e30


def _clusters(v0, v1, v2, size=128):
    return (j_ci.build_clusters(v0, v1, v2, cluster_size=size),
            p_ci.build_clusters(v0, v1, v2, "cpu", cluster_size=size))


def _run_both(v0, v1, v2, o, d, tmin, tmax, **kw):
    """JAX's engine, whose budgets must hold the launch (its own overflow
    0), and the port's → ([t, idx], [t, idx]) as numpy."""
    kw.setdefault("round_size", 256)
    jcs, pcs = _clusters(v0, v1, v2)
    jr = j_ei.intersect_epochs(jcs, jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(tmin), jnp.asarray(tmax),
                               interpret=True, **kw)
    assert int(jr[3]) == 0
    pr = p_ei.intersect_epochs(pcs, t(o), t(d), t(tmin), t(tmax), **kw)
    return [n(x) for x in jr[:2]], [n(x) for x in pr]


def _own_t(v0, v1, v2, idx, o, d):
    """t of each ray against its own triangle idx (float64)."""
    a, b, c = (x[idx].astype(np.float64) for x in (v0, v1, v2))
    e1, e2 = b - a, c - a
    q = np.cross(o - a, e1)
    return np.sum(e2 * q, -1) / np.sum(e1 * np.cross(d, e2), -1)


def _assert_same_hits(jr, pr, v0, v1, v2, o, d):
    """t within rtol 2e-5 on all rays and 1e-6 on all but 2% of them, where the winner is the same
    triangle (rays that start on a surface have short hits, whose t = e2·q
    / det cancels, and XLA's CPU backend fuses multiply-adds that PyTorch
    rounds step by step); idx equal on hits, except where both winners are
    hit at the same t (a tie the same rounding can break the other way), at
    most 1%."""
    (jt, ji), (pt, pi) = jr, pr
    np.testing.assert_allclose(pt, jt, rtol=2e-5)
    loose = ~np.isclose(pt, jt, rtol=1e-6, atol=0.0)
    assert loose.sum() <= 0.02 * pt.size
    np.testing.assert_array_equal(pi[loose], ji[loose])
    hit = jt < BIG
    assert np.array_equal(hit, pt < BIG)
    differ = hit & (pi != ji)
    assert differ.sum() <= 0.01 * max(hit.sum(), 1)
    if differ.any():
        np.testing.assert_allclose(
            _own_t(v0, v1, v2, pi[differ], o[differ], d[differ]),
            _own_t(v0, v1, v2, ji[differ], o[differ], d[differ]), rtol=2e-5)
    assert pi.dtype == np.int32 and pt.dtype == np.float32


def _case(name):
    """The inputs of each case of tests/test_epoch_intersect.py → (tris,
    rays, keyword arguments)."""
    big = lambda k: np.full(k, BIG, np.float32)
    eps = lambda k: np.full(k, 1e-3, np.float32)
    if name == "incoherent":
        rng = np.random.default_rng(0)
        tris = _random_tris(700, rng)
        o, d = _rays(300, rng)
        return tris, (o, d, eps(300), big(300)), {}
    if name == "inside_geometry":
        rng = np.random.default_rng(1)
        tris = _random_tris(500, rng, spread=2.0, size=1.5)
        pick = rng.integers(0, 500, size=200)
        o = ((tris[0][pick] + tris[1][pick] + tris[2][pick]) / 3).astype(
            np.float32)
        d = rng.standard_normal((200, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return tris, (o, d, eps(200), big(200)), {}
    if name == "tmin_tmax_windows":
        rng = np.random.default_rng(2)
        tris = _random_tris(400, rng)
        o, d = _rays(200, rng)
        tmin = (0.5 + rng.random(200) * 2).astype(np.float32)
        tmax = tmin + (rng.random(200) * 6).astype(np.float32)
        return tris, (o, d, tmin, tmax), {}
    if name.startswith("epochs"):
        rng = np.random.default_rng(9)
        tris = _random_tris(500, rng)
        o, d = _rays(192, rng)
        return tris, (o, d, eps(192), big(192)), dict(
            n_epochs=int(name[6:]))
    if name == "all_miss":
        rng = np.random.default_rng(4)
        tris = _random_tris(300, rng)
        o = np.full((64, 3), 50.0, np.float32)
        d = np.tile(np.array([[1.0, 0, 0]], np.float32), (64, 1))
        return tris, (o, d, eps(64), big(64)), {}
    if name == "starved_budget":
        # JAX's budgets starve on it; tests/test_torch_engines.py holds the
        # port's engines, which run every pair, to the dense route
        rng = np.random.default_rng(5)
        tris = _random_tris(800, rng)
        o, d = _rays(512, rng)
        return tris, (o, d, eps(512), big(512)), dict(round_size=256)
    assert name == "mixed_population"
    rng = np.random.default_rng(6)
    tris = _random_tris(1500, rng)
    k = 1024
    o1, d1 = _rays(k // 2, rng)
    o2 = np.tile(np.array([[0.0, 0, 8.0]], np.float32), (k // 2, 1))
    d2 = rng.standard_normal((k // 2, 3)).astype(np.float32)
    d2[:, 2] = -np.abs(d2[:, 2]) - 0.2
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    o, d = np.concatenate([o1, o2]), np.concatenate([d1, d2])
    return tris, (o, d, eps(k), big(k)), {}


CASES = ["incoherent", "inside_geometry", "tmin_tmax_windows", "epochs1",
         "epochs2", "epochs4", "all_miss", "mixed_population"]


@pytest.mark.parametrize("name", CASES)
def test_intersect_epochs_equals_jax(name):
    """Every case of tests/test_epoch_intersect.py that JAX's budgets hold
    (n_epochs 1, 2 and 4 each): t, and idx on hits, against JAX."""
    (v0, v1, v2), (o, d, tmin, tmax), kw = _case(name)
    jr, pr = _run_both(v0, v1, v2, o, d, tmin, tmax, **kw)
    _assert_same_hits(jr, pr, v0, v1, v2, o, d)
    if name != "all_miss":
        assert (pr[0] < BIG).sum() > 0


def _cull_inputs(seed, n_rays, n_live):
    """Rays in tile order (dead rays last, as the engine sorts them), epoch
    windows of every kind, and a padded cluster set."""
    rng = np.random.default_rng(seed)
    v0, v1, v2 = _random_tris(900, rng)
    o, d = _rays(n_rays, rng)
    d[::97, 1] = 0.0  # axis-parallel components: inv = 1e30
    live = np.arange(n_rays) < n_live
    tmin = np.where(live, 1e-3, 0.0).astype(np.float32)
    tbest = np.where(live, np.where(rng.random(n_rays) < 0.3,
                                    rng.random(n_rays) * 8, BIG),
                     0.0).astype(np.float32)
    te = rng.random(n_rays).astype(np.float32) * 4
    w0 = np.where(rng.random(n_rays) < 0.5, -BIG, te).astype(np.float32)
    w1 = np.where(rng.random(n_rays) < 0.5, BIG, te + 3.0).astype(np.float32)
    return (v0, v1, v2), o, d, tmin, tbest, w0, w1


@pytest.mark.parametrize("n_rays,n_live", [(2048, 2048), (6144, 2500),
                                           (4096, 0)])
def test_cull_plain_equals_jax(n_rays, n_live):
    """Plain K8 against JAX `_cull_bits` (interpret): the same bits, bit for
    bit, with the tiles past the live prefix zero."""
    (v0, v1, v2), o, d, tmin, tbest, w0, w1 = _cull_inputs(n_live, n_rays,
                                                           n_live)
    jcs, pcs = _clusters(v0, v1, v2)
    n_tiles = n_rays // ek.TILE
    row = lambda a: jnp.asarray(a)[None, :]
    jbits = j_ei._cull_bits(
        jcs, jnp.asarray(o.T), jnp.asarray(d.T), row(tmin), row(tbest),
        row(w0), row(w1), n_tiles, True,
        n_live_groups=jnp.int32(-(-n_live // 2048)))
    inv = 1.0 / np.where(d == 0.0, np.float32(1e-30), d)
    pbits = ek.cull_bits(t(o), t(inv), t(tmin), t(tbest), t(w0), t(w1),
                         pcs.cmin, pcs.cmax, t(np.array([n_live], np.int32)),
                         *_precull(pcs))
    assert pbits.dtype == torch.uint8 and pbits.shape == (128, n_tiles)
    np.testing.assert_array_equal(n(pbits).T.astype(np.int32), n(jbits))
    live_tiles = -(-n_live // ek.TILE)
    assert not n(pbits)[:, live_tiles:].any()
    if n_live:
        assert n(pbits)[:, :live_tiles].any()


def _precull(pcs):
    """K8's pre-cull arguments for a port cluster set, as the engine passes
    them: the hull of the real clusters' boxes, their count and their
    groups' hulls."""
    n_real = pcs.n_real
    return (torch.stack([pcs.cmin[:n_real].amin(0),
                         pcs.cmax[:n_real].amax(0)]), n_real, pcs.gmin,
            pcs.gmax)


def _job_list(rng, cp, n_real, n_subtiles, count):
    """A random cluster-major job list over the real clusters, aligned as
    the engine aligns it → (cluster, subtile) per position."""
    pid = np.unique(rng.integers(0, n_real * n_subtiles, size=count))
    clus = torch.as_tensor(pid // n_subtiles)
    sub = torch.as_tensor(pid % n_subtiles)
    return p_ei._aligned_jobs(clus, sub, cp, n_subtiles)


@pytest.mark.parametrize("round_size", [64, 1 << 17])
def test_mt_plain_and_combine_equal_jax(round_size):
    """Plain K9 plus the per-subtile combine against JAX `_mt_rounds`
    (interpret) on one aligned job list, rounds of 64 jobs (many) and of
    2^17 (one): t per subtile lane, and idx on hits."""
    rng = np.random.default_rng(21)
    v0, v1, v2 = _random_tris(1000, rng)
    # duplicates at both ends of the index range: exact ties across
    # clusters (and rounds)
    for a, b in ((3, 990), (130, 700)):
        v0[b], v1[b], v2[b] = v0[a], v1[a], v2[a]
    jcs, pcs = _clusters(v0, v1, v2)
    cp, n_real = 128, 8
    n_rays = 2048
    o, d = _rays(n_rays, rng)
    tmin = np.full(n_rays, 1e-3, np.float32)
    tmax = np.where(rng.random(n_rays) < 0.2, 3.0, BIG).astype(np.float32)
    n_subtiles = n_rays // ek.SUB
    # most (cluster, subtile) pairs: each ray meets most of the soup
    a_clus, a_sub = _job_list(rng, cp, n_real, n_subtiles, 1500)
    total = a_clus.shape[0]
    rounds = -(-total // round_size)
    pid = (a_clus * n_subtiles + a_sub).numpy().astype(np.int32)
    pid = np.concatenate([pid, np.full(rounds * round_size - total,
                                       cp * n_subtiles - 1, np.int32)])
    rayT = np.stack([o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                     tmin, tmax], 0).reshape(8, n_subtiles, 32)
    jt, ji = j_ei._mt_rounds(jnp.asarray(pid), jnp.int32(total),
                             jnp.asarray(rayT.transpose(1, 0, 2)),
                             jcs.tv, n_subtiles, rounds, round_size, True)
    t_rows, i_rows = ek.mt_jobs(a_clus.int(), a_sub.int(), t(o), t(d),
                                t(tmin), t(tmax), pcs.tv)
    rnd = torch.arange(total) // round_size
    pt, pi = p_ei._combine(t_rows, i_rows, a_sub, rnd, n_rays)
    jt, ji = n(jt).reshape(-1), n(ji).reshape(-1)
    assert_t_close(n(pt), jt)
    hit = jt < BIG
    assert hit.sum() > 100
    assert (n(pi)[hit] == ji[hit]).mean() >= 0.99


@pytest.mark.parametrize("n_epochs,round_size", [(1, 256), (2, 256),
                                                 (4, 64)])
def test_tie_between_clusters_and_epochs(n_epochs, round_size):
    """The same triangle in two clusters (indices 5 and 260): JAX's tie
    rules give one winner index, and the port gives the same."""
    rng = np.random.default_rng(31)
    v0, v1, v2 = _random_tris(400, rng, spread=6.0, size=0.4)
    big = np.array([[-1.0, -1.0, 0.0], [1.0, -1.0, 0.0], [0.0, 1.0, 0.0]],
                   np.float32)
    for k in (5, 260):
        v0[k], v1[k], v2[k] = big
    o = np.zeros((256, 3), np.float32)
    o[:, :2] = (rng.random((256, 2)) - 0.5).astype(np.float32) * 0.6
    o[:, 2] = 2.0 + rng.random(256).astype(np.float32) * 10.0
    d = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (256, 1))
    tmin = np.full(256, 1e-3, np.float32)
    tmax = np.full(256, BIG, np.float32)
    jr, pr = _run_both(v0, v1, v2, o, d, tmin, tmax, n_epochs=n_epochs,
                       round_size=round_size)
    on_big = np.isclose(jr[0], o[:, 2], rtol=1e-6)
    assert on_big.sum() > 100
    np.testing.assert_array_equal(pr[1][on_big], jr[1][on_big])
    assert set(jr[1][on_big]) <= {5, 260}
    _assert_same_hits(jr, pr, v0, v1, v2, o, d)


def test_compaction_forms_equal_jax(monkeypatch):
    """The compacted pair list (every set entry, ascending) equals JAX's
    word-packed form at a PB that holds it; and the whole engine equals
    JAX's under RAYTRACE_TPU_COMPACT=sort and =word."""
    rng = np.random.default_rng(41)
    for density, pb in ((0.02, 1 << 14), (0.9, 1 << 15), (0.3, 1 << 13)):
        bits = np.where(rng.random((96, 256)) < density,
                        rng.integers(1, 256, (96, 256)), 0).astype(np.int32)
        flatT = jnp.asarray(bits.T.reshape(-1))
        safe, pbits, valid = j_ei._compact_pairs_word(flatT, 96, 256, pb)
        valid = n(valid)
        pairs, ppbits = p_ei.compact_pairs(t(bits.T.astype(np.uint8)))
        assert pairs.shape[0] == int((bits != 0).sum()) == valid.sum()
        np.testing.assert_array_equal(n(pairs), n(safe)[valid])
        np.testing.assert_array_equal(n(ppbits), n(pbits)[valid])
    (v0, v1, v2), (o, d, tmin, tmax), _ = _case("mixed_population")
    for form, round_size in (("sort", 512), ("word", 1024)):
        # a round size of its own per form: a fresh trace reads the variable
        monkeypatch.setenv("RAYTRACE_TPU_COMPACT", form)
        jr, pr = _run_both(v0, v1, v2, o, d, tmin, tmax,
                           round_size=round_size)
        _assert_same_hits(jr, pr, v0, v1, v2, o, d)


@pytest.fixture(scope="module")
def field_scene():
    js, _ = j_presets.triangle_field(2048, 16)
    return port_scene(js)


def test_engine_choice(field_scene, monkeypatch):
    """JAX's routing on a cluster scene: coherent launches take the cluster
    engine and the rest the epoch engine; RAYTRACE_TPU_ENGINE=epoch|cluster
    forces either, for closest hit and any hit alike, and another value
    raises."""
    o = t(np.array([[0.0, -14.0, 9.0]] * 4, np.float32))
    d = t(np.array([[0.0, 0.8, -0.6]] * 4, np.float32))
    lo, hi = t(np.full(4, 1e-3, np.float32)), t(np.full(4, BIG, np.float32))
    calls = []
    for mod, fn in ((p_isect.cluster_intersect, "intersect_clusters"),
                    (p_isect.epoch_intersect, "intersect_epochs")):
        orig = getattr(mod, fn)

        def spy(*args, _orig=orig, _fn=fn, **kw):
            calls.append(_fn)
            return _orig(*args, **kw)

        monkeypatch.setattr(mod, fn, spy)
    route = {False: "intersect_epochs", True: "intersect_clusters"}
    for forced in (None, "epoch", "cluster"):
        if forced:
            monkeypatch.setenv("RAYTRACE_TPU_ENGINE", forced)
        for coherent in (False, True):
            calls.clear()
            hit = p_isect.intersect(field_scene, o, d, lo, hi,
                                    coherent=coherent)
            occ = p_isect.occluded(field_scene, o, d, lo, hi,
                                   coherent=coherent)
            assert hit.valid.all() and occ.all()
            want = route[coherent] if forced is None else route[
                forced == "cluster"]
            assert calls == [want, want]
    monkeypatch.setenv("RAYTRACE_TPU_ENGINE", "tile")
    with pytest.raises(ValueError, match="RAYTRACE_TPU_ENGINE"):
        p_isect.intersect(field_scene, o, d, lo, hi)


def test_wrappers_on_cpu_take_the_plain_versions():
    """On CPU tensors the wrappers return the plain versions' results and
    count no launch."""
    (v0, v1, v2), o, d, tmin, tbest, w0, w1 = _cull_inputs(3, 1024, 700)
    _, pcs = _clusters(v0, v1, v2)
    inv = t(1.0 / np.where(d == 0.0, np.float32(1e-30), d))
    args = (t(o), inv, t(tmin), t(tbest), t(w0), t(w1), pcs.cmin, pcs.cmax,
            t(np.array([700], np.int32)))
    k8, k9 = ek.cull_bits.launches, ek.mt_jobs.launches
    assert torch.equal(ek.cull_bits(*args, *_precull(pcs)),
                       ek.cull_bits_plain(*args))
    jobs = (torch.tensor([0, 0, 3], dtype=torch.int32),
            torch.tensor([1, 7, 30], dtype=torch.int32))
    margs = jobs + (t(o), t(d), t(tmin), t(tbest), pcs.tv)
    for a, b in zip(ek.mt_jobs(*margs), ek.mt_jobs_plain(*margs)):
        assert torch.equal(a, b)
    assert (ek.cull_bits.launches, ek.mt_jobs.launches) == (k8, k9)
