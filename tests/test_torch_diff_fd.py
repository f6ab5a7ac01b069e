"""The port's own gradient checks, mirroring tests/test_diff.py: central
differences of the image loss against `loss_and_grad` for white-wall kd,
emitter power and mirror Kr (with test_diff.py's keys, step sizes and
tolerances), gradient flow through photon transport, and recovery of a
mis-set albedo and emitter power."""
import dataclasses

import numpy as np
import torch

from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.core.config import RenderConfig
from raytrace_tpu_torch.core.vec import take_rows
from raytrace_tpu_torch.diff.optim import fit
from raytrace_tpu_torch.diff.render import (extract_params, loss_and_grad,
                                            render_image_from_params)
from raytrace_tpu_torch.renderers import common
from raytrace_tpu_torch.scene import presets
from raytrace_tpu_torch.scene.scene import LIGHT_POINT

SIZE = 16


def _key(k=None):
    key = prng.PRNGKey(7, "cpu")
    return key if k is None else prng.fold_in(key, k)


def _setup(ball=None, photon_paths=1 << 10):
    scene, camera = presets.cornell_box("cpu", SIZE, ball=ball)
    config = RenderConfig(
        width=SIZE, height=SIZE, spp=1, scene_epsilon=1e-3,
        photon_paths=photon_paths, photon_passes=1, max_photon_bounces=4,
        differentiable=True)
    return scene, camera, config, common.static_light_samples(scene, config)


def _loss(params, target, scene, camera, config, ls, key):
    img = render_image_from_params(params, scene, camera, config, key, ls,
                                   jitter=False)
    return torch.mean((img - target) ** 2)


def _fd_check(field, flat_idx, scene, camera, config, ls, h=2e-2,
              rtol=0.12, n_keys=1):
    """Central difference on one parameter coordinate against the autograd
    gradient, averaged over n_keys keys (test_diff.py `_fd_check`: with
    Russian roulette on, a fixed-key difference carries survival-flip jump
    noise that only averaging over keys removes)."""
    params = extract_params(scene)
    target = torch.zeros((SIZE, SIZE, 3))
    base = getattr(params, field)

    def perturbed(delta):
        flat = base.reshape(-1).clone()
        flat[flat_idx] += delta
        return dataclasses.replace(params, **{field: flat.reshape(base.shape)})

    fds, ads = [], []
    for k in range(n_keys):
        key = _key() if n_keys == 1 else _key(k)
        with torch.no_grad():
            l_plus = _loss(perturbed(+h), target, scene, camera, config, ls,
                           key)
            l_minus = _loss(perturbed(-h), target, scene, camera, config, ls,
                            key)
        fds.append(float((l_plus - l_minus) / (2.0 * h)))
        _, g = loss_and_grad(params, target, scene, camera, config, key, ls,
                             jitter=False)
        ads.append(float(getattr(g, field).reshape(-1)[flat_idx]))
    fd, ad = float(np.mean(fds)), float(np.mean(ads))
    assert abs(ad) > 1e-9, f"{field}[{flat_idx}]: gradient is zero"
    assert abs(fd - ad) <= rtol * max(abs(fd), abs(ad)), (
        f"{field}[{flat_idx}]: fd={fd:.6g} ad={ad:.6g} ({fds} vs {ads})")


def test_albedo_gradient_matches_fd():
    # material 0 = white walls, red channel; 4× the paths and 8 keys
    # against roulette's survival-flip noise, as in test_diff.py
    scene, camera, config, ls = _setup(photon_paths=1 << 12)
    _fd_check("kd", 0, scene, camera, config, ls, n_keys=8)


def test_albedo_gradient_matches_fd_green_wall():
    # green wall, green channel: 16 keys and rtol 0.2, as in test_diff.py
    # (the difference side carries heavy-tailed survival-flip jumps)
    scene, camera, config, ls = _setup(photon_paths=1 << 12)
    _fd_check("kd", 2 * 3 + 1, scene, camera, config, ls, n_keys=16,
              rtol=0.2)


def test_emitter_power_gradient_matches_fd():
    # intensity scales alpha uniformly, so roulette's survival ratio does
    # not depend on it: no flip noise; larger h since intensity ~30
    scene, camera, config, ls = _setup()
    _fd_check("intensity", 0, scene, camera, config, ls, h=0.5)


def test_second_light_power_gradient_matches_fd():
    """Two lights: the Cornell disk and a point light near the ceiling.
    Photon paths are striped over the lights by path id, so each photon's
    flux must replay the intensity of the light its path left."""
    scene, camera, config, ls = _setup()
    lt = scene.lights
    row = lambda x, v: torch.cat([x, torch.tensor([v], dtype=x.dtype)])
    scene = dataclasses.replace(scene, lights=dataclasses.replace(
        lt, ltype=row(lt.ltype, LIGHT_POINT), o=row(lt.o, [0.3, 1.2, 1.7]),
        p1=row(lt.p1, [0.0] * 3), p2=row(lt.p2, [0.0] * 3),
        normal=row(lt.normal, [0.0, 0.0, 1.0]), area=row(lt.area, 0.0),
        intensity=row(lt.intensity, [5.0, 4.0, 3.0]),
        n_samples=row(lt.n_samples, 1)))
    ls = common.static_light_samples(scene, config)
    assert scene.lights.count == 2
    _fd_check("intensity", 3 * 1 + 0, scene, camera, config, ls, h=0.2)


def test_mirror_kr_gradient_matches_fd():
    """Mirror throughput is its kd row (Kr): the chains must record mirror
    bounces for the camera and photon paths through the ball."""
    scene, camera, config, ls = _setup(ball="mirror")
    _fd_check("kd", 3 * 3 + 0, scene, camera, config, ls)


def test_gradients_flow_through_photon_transport():
    scene, camera, config, ls = _setup()
    _, g = loss_and_grad(extract_params(scene), torch.zeros((SIZE, SIZE, 3)),
                         scene, camera, config, _key(), ls, jitter=False)
    assert torch.isfinite(g.kd).all() and torch.isfinite(g.intensity).all()
    # every matte material gets gradient, the intensities too
    assert (g.kd.abs().sum(dim=1) > 0).all()
    assert float(g.intensity.abs().sum()) > 0.0


def test_recover_albedo():
    """Gradient descent on the image MSE moves a perturbed wall albedo back
    toward the truth (test_diff.py: 14 steps of lr 2.0)."""
    scene, camera, config, ls = _setup()
    true_params = extract_params(scene)
    target = render_image_from_params(true_params, scene, camera, config,
                                      _key(), ls, jitter=False)
    kd0 = true_params.kd.clone()
    kd0[0] = torch.tensor([0.25, 0.9, 0.4])
    params = dataclasses.replace(true_params, kd=kd0)
    err0 = float((params.kd[0] - true_params.kd[0]).abs().sum())
    for _ in range(14):
        loss, g = loss_and_grad(params, target, scene, camera, config,
                                _key(), ls, jitter=False)
        params = dataclasses.replace(params, kd=params.kd - 2.0 * g.kd,
                                     intensity=params.intensity
                                     - 2.0 * g.intensity)
    err1 = float((params.kd[0] - true_params.kd[0]).abs().sum())
    assert err1 < 0.5 * err0, (err0, err1)
    assert float(loss) >= 0.0


def test_recover_emitter_power():
    """fit (log-intensity + Adam) recovers a 1.8× over-bright emitter
    (test_diff.py: 25 steps of lr 0.1)."""
    scene, camera, config, ls = _setup()
    true_params = extract_params(scene)
    target = render_image_from_params(true_params, scene, camera, config,
                                      _key(), ls, jitter=False)
    params = dataclasses.replace(true_params,
                                 intensity=true_params.intensity * 1.8)
    err0 = float((params.intensity - true_params.intensity).abs().sum())
    recovered, losses = fit(params, target, scene, camera, config, _key(),
                            steps=25, lr=0.1, light_samples=ls)
    err1 = float((recovered.intensity - true_params.intensity).abs().sum())
    assert err1 < 0.2 * err0, (err0, err1, losses)
    assert losses[-1] < losses[0], losses


def test_take_rows_matches_indexing():
    """vec.take_rows reads a table that requires grad through a one-hot
    product: the same values as indexing, bit for bit, and the same
    gradient."""
    g = torch.Generator().manual_seed(0)
    table = torch.rand((5, 3), generator=g)
    idx = torch.randint(0, 5, (1000,), generator=g)
    w = torch.randn((1000, 3), generator=g)
    leaf = table.clone().requires_grad_(True)
    got = take_rows(leaf, idx)
    assert torch.equal(got.detach(), table[idx])
    assert torch.equal(take_rows(table, idx), table[idx])
    (g_rows,) = torch.autograd.grad((got * w).sum(), leaf)
    leaf2 = table.clone().requires_grad_(True)
    (g_index,) = torch.autograd.grad((leaf2[idx] * w).sum(), leaf2)
    torch.testing.assert_close(g_rows, g_index, rtol=1e-5, atol=1e-5)
