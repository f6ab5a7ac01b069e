"""The draws' kernel (csrc/threefry.cu) on the card against the eager
threefry ops of core/prng.py on the same card, bit for bit: folds of ints
and tensors, splits, bits and uniforms of batched keys, empty draws, sizes
that are no multiple of a block, counters near 2^31, the fused bounce and
sample uniforms, and a whole small frame. Marker `card`, skipped without
one; no JAX, so on the card:
`python -m pytest tests/test_torch_prng_card.py -m card --noconftest`."""
import contextlib

import pytest
import torch

from benchmark import program, spec
from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.core import samples as p_samples
from raytrace_tpu_torch.renderers import photon
from raytrace_tpu_torch.scene import presets


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: runs on the H100")
    return torch.device("cuda:0")


@contextlib.contextmanager
def eager():
    """Draws on the card through the eager ops instead of the kernel."""
    real = prng._on_card
    prng._on_card = lambda key: False
    try:
        yield
    finally:
        prng._on_card = real


def both(fn, *args):
    """fn(*args) through the kernel and through the eager ops → (kernel's,
    eager's, the kernel's launches)."""
    before = prng.kernel_draw.launches
    got = fn(*args)
    torch.cuda.synchronize()
    launches = prng.kernel_draw.launches - before
    with eager():
        want = fn(*args)
    assert prng.kernel_draw.launches - before == launches
    return got, want, launches


def assert_same(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.device == want.device
    assert torch.equal(got, want)


def ids(card, n, dtype=torch.int64, seed=0):
    g = torch.Generator(device=card).manual_seed(seed + n)
    return torch.randint(-2**40, 2**40, (n,), generator=g,
                         device=card).to(dtype)


def keys(card, *lead):
    with eager():
        return prng.random_bits(prng.PRNGKey(3, card), lead + (2,))


@pytest.mark.card
@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, 2**32 + 5])
def test_fold_in_and_split(card, seed):
    key = prng.PRNGKey(seed, card)
    for data in (0, 5, 2**32 + 9, -3, ids(card, 1), ids(card, 257),
                 ids(card, 1000, torch.int32), torch.tensor(11, device=card),
                 ids(card, 0)):
        got, want, n = both(prng.fold_in, key, data)
        assert_same(got, want)
        assert n == (1 if want.numel() else 0)
    for lead, data in (((300,), 4), ((300,), ids(card, 300)),
                       ((300,), ids(card, 1)), ((3, 1), ids(card, 5)),
                       ((0,), 2)):
        got, want, _ = both(prng.fold_in, keys(card, *lead), data)
        assert_same(got, want)
    for num in (1, 2, 3, 1000, 4099):
        got, want, n = both(prng.split, key, num)
        assert_same(got, want)
        assert n == 1


@pytest.mark.card
@pytest.mark.parametrize("draw", [prng.random_bits, prng.uniform],
                         ids=["bits", "uniform"])
@pytest.mark.parametrize("lead", [(), (1,), (5,), (2, 3)])
@pytest.mark.parametrize("shape", [(), (2,), (3,), (0,), (7, 5), (1023,),
                                   (262_147, 2)])
def test_draws(card, draw, lead, shape):
    key = keys(card, *lead) if lead else prng.PRNGKey(11, card)
    got, want, n = both(draw, key, shape)
    assert_same(got, want)
    assert n == (1 if want.numel() else 0)


@pytest.mark.card
def test_counters_near_2_31(card):
    """A draw of 2^31 - 3 uniforms, and bits of two keys of 2^30 + 5
    counters each (2^31 + 10 elements): their ends against the eager
    hash of the same counters."""
    key = prng.PRNGKey(5, card)
    n = 2**31 - 3
    u = prng.uniform(key, (n,))
    bits = prng.random_bits(keys(card, 2), (2**30 + 5,))
    torch.cuda.synchronize()
    for lo, hi in ((0, 4096), (2**31 - 70_000, n)):
        c = torch.arange(lo, hi, dtype=torch.int64, device=card)
        y1, y2 = prng.threefry2x32(key[0], key[1], torch.zeros_like(c), c)
        f = (((y1 ^ y2) >> 9) | 0x3F800000).to(torch.int32).view(
            torch.float32) - 1.0
        assert torch.equal(u[lo:hi], f)
    del u
    k = keys(card, 2)
    for lo, hi in ((0, 4096), (2**30 - 4091, 2**30 + 5)):
        c = torch.arange(lo, hi, dtype=torch.int64, device=card)
        y1, y2 = prng.threefry2x32(k[1, 0], k[1, 1], torch.zeros_like(c), c)
        assert torch.equal(bits[1, lo:hi], y1 ^ y2)


@pytest.mark.card
@pytest.mark.parametrize("n", [1, 255, 4096 + 3, 1 << 20])
def test_bounce_and_sample_uniforms(card, n):
    """The photon walk's 3 uniforms a lane (2 folds, 3 draws) and the
    light samples' stratified arrays, each draw one launch."""
    key = prng.PRNGKey(9, card)
    gids = ids(card, n) & prng._MASK
    n_int = ids(card, n, torch.int32, seed=1) % 9
    got, want, launches = both(photon._bounce_uniforms, key, gids, n_int)
    assert_same(got, want)
    assert launches == 1
    for data, shape in (((gids,), (2,)), ((gids,), ()),
                        ((gids, 3), (3,)), ((gids, n_int, 4), (1,))):
        got, want, _ = both(prng.folded_uniform, key, data, shape)
        assert_same(got, want)
    layout = p_samples.SampleLayout()
    layout.add_1d(2)
    layout.add_2d(4)
    for name in ("materialize_1d", "materialize_2d"):
        got, want, _ = both(getattr(layout, name), key, gids)
        assert_same(got, want)


@pytest.mark.card
@pytest.mark.parametrize("n", [2, 3, 5, 7, 11, 4099])
def test_permutation(card, n):
    got, want, _ = both(prng.permutation, prng.PRNGKey(n, card), n)
    assert_same(got, want)


@pytest.mark.card
def test_frame_equals_the_eager_frame(card):
    """A 2^14-triangle 64² frame at 2^16 paths (the field4m cell's settings
    otherwise) with the same key through the kernel and through the eager
    draws: the same image bit for bit, and the frame's draws launched."""
    render = dict(spec.load_cell("field4m.frame").config["render"],
                  width=64, height=64, photon_paths=1 << 16)
    rcfg = program.render_config(render)
    scene, cam = presets.triangle_field(card, 1 << 14, 64)
    key = prng.PRNGKey(123_456_789, card)
    before = prng.kernel_draw.launches
    img, aux = photon.render_photon(scene, cam, rcfg, key, return_aux=True)
    torch.cuda.synchronize()
    assert prng.kernel_draw.launches > before
    with eager():
        want, want_aux = photon.render_photon(scene, cam, rcfg, key,
                                              return_aux=True)
    assert int(aux["pair_overflow"]) == 0
    assert bool(torch.isfinite(img).all()) and float(img.sum()) > 0
    assert torch.equal(img, want)
