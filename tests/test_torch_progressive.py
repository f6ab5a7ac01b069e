"""The port's progressive entry point against the JAX package: the gather
dispatch (kernel K4's route for forward waves under 2^14 slots), the
wave-by-wave `render_photon_progressive`, and checkpoints that cross between
the two packages in both directions.

JAX's own small-map route calls `gather_radius_pallas` without interpret
mode, so it cannot run on the CPU; JAX is held here through
exact_gather=True, the same all-pairs sums. Bounds as in
tests/test_torch_render.py: states rtol 2e-5 (float32 rounding of the two
frameworks), whole frames relative L1 ≤ 1e-4 with ≤ 1% of the pixels off by
more than 1e-3 relative (a grazing ray or a roulette draw may flip).
Within the port, resumed and fused renders are compared bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import n, np_tree, port_scene
from raytrace_tpu.core.config import RenderConfig as JConfig
from raytrace_tpu.renderers import common as j_common
from raytrace_tpu.renderers import photon as j_photon
from raytrace_tpu.scene import camera as j_camera
from raytrace_tpu.scene import presets as j_presets
from raytrace_tpu.utils import checkpoint as j_ckpt
from raytrace_tpu_torch import interop
from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.core.config import RenderConfig as PConfig
from raytrace_tpu_torch.renderers import photon as p_photon
from raytrace_tpu_torch.scene import presets as p_presets
from raytrace_tpu_torch.utils import checkpoint as p_ckpt

SIZE = 16
SETTINGS = dict(width=SIZE, height=SIZE, spp=1, scene_epsilon=1e-3,
                photon_paths=1 << 9, photon_passes=3, max_photon_bounces=8,
                footprint_radius_scale=8.0)
SEED = 5
RTOL, ATOL = 2e-5, 2e-6


def _scenes():
    js, jc = j_presets.cornell_box(SIZE, ball="glass")
    ps, pc = p_presets.cornell_box("cpu", SIZE, ball="glass")
    return js, jc, ps, pc


def _frames_close(p_img, j_img):
    p_img, j_img = n(p_img), n(j_img)
    assert p_img.shape == (SIZE, SIZE, 3) and np.isfinite(p_img).all()
    assert p_img.mean() > 0.05
    rel_l1 = np.abs(p_img - j_img).sum() / np.abs(j_img).sum()
    assert rel_l1 <= 1e-4
    off = np.abs(p_img - j_img).max(-1) > 1e-3 * np.maximum(j_img.max(-1),
                                                            1.0)
    assert off.mean() <= 0.01


@pytest.fixture(scope="module")
def jax_progressive(tmp_path_factory):
    """JAX's uninterrupted 3-wave render and a checkpoint it wrote after
    wave 1, both with exact_gather=True."""
    js, jc, _, _ = _scenes()
    cfg = JConfig(**SETTINGS, exact_gather=True)
    key = jax.random.PRNGKey(SEED)
    img, state = j_photon.render_photon_progressive(js, jc, cfg, key)
    path = str(tmp_path_factory.mktemp("jax_ckpt") / "ppm.ckpt")
    j_photon.render_photon_progressive(
        js, jc, dataclasses.replace(cfg, photon_passes=1), key,
        checkpoint_path=path)
    return n(img), np_tree(state), path


def _gather_inputs():
    """A first wave at 16×16 with 2^9 paths (2,048 slots) from JAX, carried
    into the port."""
    js, jc, _, _ = _scenes()
    jcfg = JConfig(**SETTINGS)
    xy, lens = j_camera.pixel_samples(jax.random.PRNGKey(1), SIZE, SIZE, 1)
    rays = j_camera.generate_rays(jc, xy, lens, 1)
    jrec = j_common.camera_pass(js, rays.o, rays.d, jcfg, rays=rays)
    z = jnp.zeros((SIZE * SIZE,), jnp.float32)
    jstate = j_photon.ProgressiveState(
        radius2=j_photon.initial_radius2(jrec, jcfg), photon_count=z,
        flux=jnp.zeros((SIZE * SIZE, 3), jnp.float32), emitted=z)
    jpm = j_photon.trace_photons(js, jcfg, jax.random.PRNGKey(7), 0)
    return js, port_scene(js), jrec, jstate, jpm


def _pad_map(pm, slots):
    """The photon map with invalid slots appended up to `slots`."""
    pad = slots - pm.valid.shape[0]
    z3 = np.zeros((pad, 3), np.float32)
    return dict(p=np.concatenate([pm.p, z3]),
                alpha=np.concatenate([pm.alpha, z3]),
                wi=np.concatenate([pm.wi, z3]),
                valid=np.concatenate([pm.valid, np.zeros(pad, bool)]))


# (slots, differentiable, route): the threshold is slots >= 2^14 → row-span
ROUTES = [(2048, False, "dense"), ((1 << 14) - 1, False, "dense"),
          (1 << 14, False, "rowspan"), (2048, True, "rowspan")]


@pytest.mark.parametrize("slots,differentiable,route", ROUTES,
                         ids=["2048", "16383", "16384", "2048_ad"])
def test_gathering_pass_route_matches_exact_gather(monkeypatch, slots,
                                                   differentiable, route):
    """Forward waves under 2^14 slots take K4 (compaction + dense gather);
    maps of 2^14 slots and differentiable waves take the row-span gather.
    Every route matches JAX's exact all-pairs gather from the same map."""
    js, ps, jrec, jstate, jpm = _gather_inputs()
    padded = _pad_map(np_tree(jpm), slots)
    calls = dict(dense=0, rowspan=0)

    def spy(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        monkeypatch.setattr(p_photon, fn.__name__, wrapped)

    spy("dense", p_photon.gather_radius_dense_tiles)
    spy("rowspan", p_photon.gather_radius_rowspan)
    jcfg = JConfig(**SETTINGS, exact_gather=True)
    pcfg = PConfig(**SETTINGS, differentiable=differentiable)
    jmap = type(jpm)(**{k: jnp.asarray(v) for k, v in padded.items()})
    prec = interop.records_from_numpy(np_tree(jrec), "cpu")
    pstate = interop.state_from_numpy(np_tree(jstate), "cpu")
    pmap = interop.photon_map_from_numpy(padded, "cpu")
    jnew, jinfo = j_photon.gathering_pass(js, jrec, jstate, jmap, jcfg)
    pnew, pinfo = p_photon.gathering_pass(ps, prec, pstate, pmap, pcfg)
    assert calls == dict(dense=int(route == "dense"),
                         rowspan=int(route == "rowspan"))
    assert int(pinfo["gather_overflow"]) == 0
    assert int(pinfo["valid_photons"]) == int(jinfo["valid_photons"]) > 0
    for f in ("radius2", "photon_count", "flux", "emitted"):
        np.testing.assert_allclose(n(getattr(pnew, f)), n(getattr(jnew, f)),
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    assert n(pnew.photon_count).sum() > 0


def test_progressive_matches_jax(jax_progressive):
    j_img, j_state, _ = jax_progressive
    _, _, ps, pc = _scenes()
    img, state, aux = p_photon.render_photon_progressive(
        ps, pc, PConfig(**SETTINGS), prng.PRNGKey(SEED, "cpu"),
        return_aux=True)
    _frames_close(img, j_img)
    for f in ("radius2", "photon_count", "flux", "emitted"):
        np.testing.assert_allclose(n(getattr(state, f)), getattr(j_state, f),
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    assert int(aux["gather_overflow"]) == 0 and aux["pair_overflow"] == 0
    assert len(aux["wave_s"]) == SETTINGS["photon_passes"]


def test_progressive_equals_fused_render_photon():
    """Wave by wave or in one call, the port renders the same image."""
    _, _, ps, pc = _scenes()
    cfg = PConfig(**SETTINGS)
    key = prng.PRNGKey(SEED, "cpu")
    img_prog, _ = p_photon.render_photon_progressive(ps, pc, cfg, key)
    img_fused = p_photon.render_photon(ps, pc, cfg, key)
    assert torch.equal(img_prog, img_fused)


def _assert_states_equal(a, b):
    for f in ("radius2", "photon_count", "flux", "emitted"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_resume_equals_uninterrupted(tmp_path, caplog):
    """A render stopped after wave 1 and resumed from its checkpoint equals
    the uninterrupted render bit for bit; verbose logs one line per wave
    run."""
    _, _, ps, pc = _scenes()
    cfg = PConfig(**SETTINGS)
    key = prng.PRNGKey(SEED, "cpu")
    path = str(tmp_path / "ppm.ckpt")
    img_ref, state_ref = p_photon.render_photon_progressive(
        ps, pc, cfg, key)
    p_photon.render_photon_progressive(
        ps, pc, dataclasses.replace(cfg, photon_passes=1), key,
        checkpoint_path=path)
    with caplog.at_level("INFO", logger="raytrace_tpu_torch"):
        img_res, state_res, aux = p_photon.render_photon_progressive(
            ps, pc, cfg, key, checkpoint_path=path,
            verbose=True, return_aux=True)
    assert torch.equal(img_res, img_ref)
    _assert_states_equal(state_res, state_ref)
    assert len(aux["wave_s"]) == 2  # waves 1 and 2 ran, wave 0 was loaded
    assert caplog.text.count("pass=photon_wave") == 2
    assert "wave=1" in caplog.text and "photons_per_s=" in caplog.text
    # the final wave was saved: its checkpoint holds the finished state
    state, next_pass, _, emitted = p_ckpt.load_progressive(path, "cpu")
    assert next_pass == 3 and emitted == 3.0 * SETTINGS["photon_paths"]
    _assert_states_equal(state, state_ref)


def test_jax_checkpoint_resumes_in_port(jax_progressive):
    """A checkpoint JAX wrote after wave 1 loads in the port with equal
    fields, and the port finishes the render to JAX's image."""
    j_img, _, path = jax_progressive
    state, next_pass, key, emitted = p_ckpt.load_progressive(path, "cpu")
    j_state, j_next, j_key, j_emitted = j_ckpt.load_progressive(path)
    assert next_pass == j_next == 1 and emitted == j_emitted
    for f in ("radius2", "photon_count", "flux", "emitted"):
        np.testing.assert_array_equal(n(getattr(state, f)),
                                      n(getattr(j_state, f)))
    assert torch.equal(key, prng.PRNGKey(SEED, "cpu"))
    np.testing.assert_array_equal(j_key, n(jax.random.PRNGKey(SEED)))
    _, _, ps, pc = _scenes()
    img, _ = p_photon.render_photon_progressive(
        ps, pc, PConfig(**SETTINGS), prng.PRNGKey(SEED, "cpu"),
        checkpoint_path=path, save_every=0)
    _frames_close(img, j_img)


def test_port_checkpoint_loads_in_jax(tmp_path):
    """A checkpoint the port wrote loads in JAX's load_progressive with
    equal fields, next pass and key."""
    _, _, ps, pc = _scenes()
    path = str(tmp_path / "ppm.ckpt")
    seed = 0xDEADBEEF  # the high bit of the key's low word set
    _, state = p_photon.render_photon_progressive(
        ps, pc, PConfig(**dict(SETTINGS, photon_passes=1)),
        prng.PRNGKey(seed, "cpu"), checkpoint_path=path)
    j_state, j_next, j_key, j_emitted = j_ckpt.load_progressive(path)
    assert j_next == 1 and j_emitted == float(SETTINGS["photon_paths"])
    for f in ("radius2", "photon_count", "flux", "emitted"):
        np.testing.assert_array_equal(n(getattr(j_state, f)),
                                      n(getattr(state, f)))
    np.testing.assert_array_equal(j_key, n(jax.random.PRNGKey(seed)))


def test_checkpoint_roundtrip_and_untracked_emitted(tmp_path):
    """Port save → port load is exact; a JAX state without per-pixel
    emitted (the legacy form) loads with emitted = the paths so far."""
    rng = np.random.default_rng(0)
    arr = lambda *s: rng.random(s, dtype=np.float32)
    state = p_photon.ProgressiveState(
        radius2=torch.as_tensor(arr(64)),
        photon_count=torch.as_tensor(arr(64)),
        flux=torch.as_tensor(arr(64, 3)), emitted=torch.as_tensor(arr(64)))
    path = str(tmp_path / "s.ckpt")
    key = prng.split(prng.PRNGKey(3, "cpu"))[1]  # both words nonzero
    p_ckpt.save_progressive(path, state, next_pass=7, key=key,
                            emitted_photons=12345.0)
    s2, nxt, k2, emitted = p_ckpt.load_progressive(path, "cpu")
    assert nxt == 7 and emitted == 12345.0 and torch.equal(k2, key)
    _assert_states_equal(s2, state)

    j_state = j_photon.ProgressiveState(
        radius2=jnp.asarray(arr(64)), photon_count=jnp.asarray(arr(64)),
        flux=jnp.asarray(arr(64, 3)))
    j_ckpt.save_progressive(path, j_state, next_pass=2,
                            key=jax.random.PRNGKey(3), emitted_photons=1024.0)
    s3, nxt, _, _ = p_ckpt.load_progressive(path, "cpu")
    assert nxt == 2
    np.testing.assert_array_equal(n(s3.flux), n(j_state.flux))
    assert torch.equal(s3.emitted, torch.full((64,), 1024.0))

