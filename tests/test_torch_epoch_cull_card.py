"""K8 (csrc/epoch_cull.cu) with its group hulls on the card against the plain
version (ops/epoch_kernels.py `cull_bits_plain`) bit for bit, and its
counter against `cull_tests_plain`: every K8 launch of a photon walk of
the glass Cornell box with a 327,680-triangle ball (photons from the disk
light, then refracted and reflected: both epochs of each step), of a
triangle_field frame's walk, and the adversarial group cases of
tests/test_torch_epoch_precull.py. Marker `card`, skipped without one; no
JAX, so on the card:
`python -m pytest tests/test_torch_epoch_cull_card.py -m card --noconftest`.
"""
import contextlib
import importlib.util
import pathlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import program, spec
from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.ops import epoch_kernels as ek
from raytrace_tpu_torch.renderers import photon
from raytrace_tpu_torch.scene import presets
from raytrace_tpu_torch.utils import metrics

pytestmark = pytest.mark.card


def _precull_cases():
    """tests/test_torch_epoch_precull.py, loaded by path: on the card's
    machine another installed package may hold the name `tests`."""
    path = pathlib.Path(__file__).with_name("test_torch_epoch_precull.py")
    spec_ = importlib.util.spec_from_file_location("epoch_precull_cases",
                                                   path)
    module = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(module)
    return module


CASES = _precull_cases()

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: runs on the H100")
    return torch.device("cuda:0")


@contextlib.contextmanager
def k8_calls():
    """Every cull_bits call's arguments while inside."""
    calls, real = [], ek.cull_bits

    def rec(*args):
        calls.append(args)
        return real(*args)

    rec.launches = 0
    ek.cull_bits = rec
    try:
        yield calls
    finally:
        ek.cull_bits = real


def counted(args):
    """K8 on `args` under a profiler → (mask, its counter's (ran, asked))."""
    dev = args[0].device
    with profile(activities=[ProfilerActivity.CUDA]):
        buf = metrics.device_counter("cull_tests", dev)
        before = buf.clone()
        got = ek.cull_bits(*args)
        torch.cuda.synchronize(dev)
    ran, asked = (buf - before).tolist()
    return got, (ran, asked)


def check(args):
    """The kernel's mask equals the plain version's, and its counter the
    plain count → the launch's (ran, asked)."""
    got, count = counted(args)
    want = ek.cull_bits_plain(*args[:9])
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, want), int((got != want).sum())
    assert count == ek.cull_tests_plain(*args)
    return count


def frame_launches(scene, cam, render, dev):
    """The K8 calls of one render_photon frame of `render` with key 5: its
    photon walk's steps, two epochs each."""
    with k8_calls() as calls:
        photon.render_photon(scene, cam, program.render_config(render),
                             prng.PRNGKey(5, dev))
    return calls


def test_glass_box_photons_equal_the_plain_cull(card):
    """The caustic cell's scene at 7 levels (327,680 triangles + the box:
    1,281 clusters, 41 groups over two blocks) and its render block at 32²
    and 2^16 paths: every K8 launch of a frame's photon walk (photons from
    the disk light, then refracted and reflected), both epochs."""
    cfg = spec.load_cell("caustic_glass_mesh.frame").config
    scene_p = dict(cfg["scene"], subdivisions=7)
    desc = spec.load_module("scenes", scene_p["kind"]).describe(
        scene_p, 0, 64, 64)
    scene, cam = program.build_scene(desc, card)
    cs = scene.clusters
    assert cs.n_real > ek.CULL_BLOCK_CLUSTERS and cs.n_real % ek.GROUP
    render = dict(cfg["render"], width=32, height=32, photon_paths=1 << 16)
    calls = frame_launches(scene, cam, render, card)
    assert len(calls) >= 6
    ran = asked = 0
    for args in calls:
        assert args[11] is cs.gmin and args[12] is cs.gmax
        r, a = check(args)
        ran, asked = ran + r, asked + a
    assert 0 < ran < 0.5 * asked


def test_triangle_field_emission_equals_the_plain_cull(card):
    """A 2^18-triangle terrain (1,024 clusters of 256, 32 groups) at the
    field4m cell's render block, 32² and 2^16 paths: every K8 launch of a
    frame's photon walk, its point-light emission first."""
    scene, cam = presets.triangle_field(card, 1 << 18, 32)
    render = dict(spec.load_cell("field4m.frame").config["render"],
                  width=32, height=32, photon_paths=1 << 16)
    calls = frame_launches(scene, cam, render, card)
    assert len(calls) >= 2
    for args in calls:
        check(args)


@pytest.mark.parametrize("name", CASES.GROUP_CASES)
@pytest.mark.parametrize("dead", [0, 300])
def test_adversarial_cases_equal_the_plain_cull(card, name, dead):
    """The CPU tests' group cases on the card: NaN and denormal directions,
    origins on face planes, resolved rays, a room-sized cluster among a
    ball's, a partial last group, two blocks; with a live prefix that ends
    inside a tile."""
    *arrays, n_real = CASES._group_case(name)
    host = CASES._tensors(*arrays, n_real)
    o, inv, tmin, tbest, w0, w1, cmin, cmax, box = (a.to(card) for a in host)
    n_live = torch.tensor([o.shape[0] - dead], dtype=torch.int32,
                          device=card)
    check((o, inv, tmin, tbest, w0, w1, cmin, cmax, n_live, box, n_real,
           *ek.group_hulls(cmin, cmax, n_real)))


def test_no_profiler_counts_nothing(card):
    """Outside a profiler the kernel gets no counter: the counter stays."""
    *arrays, n_real = CASES._group_case("wall_among_ball")
    o, inv, tmin, tbest, w0, w1, cmin, cmax, box = (
        a.to(card) for a in CASES._tensors(*arrays, n_real))
    n_live = torch.tensor([o.shape[0]], dtype=torch.int32, device=card)
    args = (o, inv, tmin, tbest, w0, w1, cmin, cmax, n_live, box, n_real,
            *ek.group_hulls(cmin, cmax, n_real))
    counted(args)
    buf = metrics.DEVICE_COUNTERS[("cull_tests", card)]
    before = buf.clone()
    ek.cull_bits(*args)
    torch.cuda.synchronize(card)
    assert torch.equal(buf, before)
