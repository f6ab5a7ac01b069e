"""core/prng.py's launches of the draws' kernel (csrc/threefry.cu), on the
CPU: the C entry point `threefry_draw` is stood in for by a Python version
of what the kernel computes, reading and writing the very buffers the
wrapper hands it, so that the wrapper's words, strides, broadcasts and
output shapes are held to the eager draws bit for bit without a card.
tests/test_torch_prng_card.py holds the kernel itself to the eager draws on
the card."""
import ctypes

import numpy as np
import pytest
import torch

from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.core import samples as p_samples
from raytrace_tpu_torch.ops import cuda_lib
from raytrace_tpu_torch.renderers import photon as p_photon

_CTYPES = {torch.int64: ctypes.c_int64, torch.int32: ctypes.c_int32,
           torch.float32: ctypes.c_float}


def _view(address, dtype, n):
    """The n elements of `dtype` at `address`, as a tensor sharing them."""
    buf = (_CTYPES[dtype] * n).from_address(address.value)
    return torch.from_numpy(np.ctypeslib.as_array(buf))


def threefry_draw(key, key_stride, n_fold, d0, kind0, stride0, value0, d1,
                  kind1, stride1, value1, lanes, count, out_kind, out,
                  stream):
    """csrc/threefry.cu `threefry_draw`, element for element."""
    lane = torch.arange(lanes, dtype=torch.int64)
    keys = _view(key, torch.int64, 2 * ((lanes - 1) * key_stride + 1))
    k0 = keys[2 * lane * key_stride]
    k1 = keys[2 * lane * key_stride + 1]
    for ptr, kind, stride, value in ((d0, kind0, stride0, value0),
                                     (d1, kind1, stride1, value1))[:n_fold]:
        if kind == prng._DATA_VALUE:
            word = torch.full((lanes,), value, dtype=torch.int64)
        elif kind == prng._DATA_LANE:
            word = lane
        else:
            dtype = (torch.int64 if kind == prng._DATA_I64 else torch.int32)
            n = (lanes - 1) * stride + 1
            word = _view(ptr, dtype, n)[lane * stride].to(torch.int64)
        k0, k1 = prng.threefry2x32(k0, k1, torch.zeros_like(word),
                                   word & prng._MASK)
    if out_kind == prng._OUT_KEYS:
        _view(out, torch.int64, 2 * lanes)[:] = torch.stack(
            [k0, k1], -1).reshape(-1)
        return 0
    c = torch.arange(count, dtype=torch.int64)
    y0, y1 = prng.threefry2x32(k0[:, None], k1[:, None], torch.zeros_like(c),
                               c)
    bits = (y0 ^ y1).reshape(-1)
    if out_kind == prng._OUT_BITS:
        _view(out, torch.int64, lanes * count)[:] = bits
    else:
        f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
        _view(out, torch.float32, lanes * count)[:] = f - 1.0
    return 0


class _Lib:
    threefry_draw = staticmethod(threefry_draw)


@pytest.fixture
def launched(monkeypatch):
    """Calls `fn(*args)` once with the draws through the stand-in kernel and
    once through the eager ops → (kernel's, eager's, launches)."""
    def run(fn, *args):
        want = fn(*args)
        with monkeypatch.context() as m:
            m.setattr(prng, "_on_card", lambda key: True)
            m.setattr(cuda_lib, "load", lambda name, sigs: _Lib)
            m.setattr(cuda_lib, "stream_ptr", lambda dev: None)
            before = prng.kernel_draw.launches
            got = fn(*args)
            return got, want, prng.kernel_draw.launches - before
    return run


def _key(seed=7):
    return prng.PRNGKey(seed, "cpu")


def _keys(*lead):
    return prng.random_bits(_key(3), lead + (2,))


def _ids(n, dtype=torch.int64):
    g = torch.Generator().manual_seed(n)
    return torch.randint(-2**40, 2**40, (n,), generator=g).to(dtype)


def _equal(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, want)


FOLDS = {
    "int": lambda: (_key(), 5),
    "int_large": lambda: (_key(), 2**32 + 9),
    "int_negative": lambda: (_key(), -3),
    "ids": lambda: (_key(), _ids(37)),
    "ids_int32": lambda: (_key(), _ids(37, torch.int32)),
    "ids_0d": lambda: (_key(), torch.tensor(11)),
    "keys_int": lambda: (_keys(6), 4),
    "keys_ids": lambda: (_keys(6), _ids(6)),
    "keys_one_id": lambda: (_keys(6), torch.tensor([2])),
    "keys_broadcast": lambda: (_keys(3, 1), _ids(4)),
    "empty": lambda: (_key(), _ids(0)),
}


@pytest.mark.parametrize("case", list(FOLDS))
def test_fold_in(launched, case):
    got, want, n = launched(prng.fold_in, *FOLDS[case]())
    _equal(got, want)
    assert n == (1 if want.numel() else 0)


@pytest.mark.parametrize("num", [1, 2, 3, 1000])
def test_split(launched, num):
    got, want, n = launched(prng.split, _key(), num)
    _equal(got, want)
    assert n == 1


DRAWS = [((), ()), ((), (2,)), ((), (3,)), ((), (5, 7)), ((), (1000,)),
         ((4,), ()), ((4,), (3,)), ((2, 3), (5,)), ((0,), (3,)), ((), (0,))]


@pytest.mark.parametrize("draw", [prng.random_bits, prng.uniform],
                         ids=["bits", "uniform"])
@pytest.mark.parametrize("lead,shape", DRAWS)
def test_draws(launched, draw, lead, shape):
    key = _keys(*lead) if lead else _key()
    got, want, n = launched(draw, key, shape)
    _equal(got, want)
    assert n == (1 if want.numel() else 0)


@pytest.mark.parametrize("data,shape", [
    ((_ids(9),), (2,)), ((_ids(9),), ()), ((_ids(9), _ids(9, torch.int32)),
                                           (3,)),
    ((_ids(9), 4), (3,)), ((5, _ids(9)), ()), ((_ids(9), 4, 2), (3,))])
def test_folded_uniform(launched, data, shape):
    got, want, n = launched(prng.folded_uniform, _key(), data, shape)
    _equal(got, want)
    assert n == max(1, len(data) - 1)


def test_permutation(launched):
    got, want, n = launched(prng.permutation, _key(), 101)
    _equal(got, want)
    assert n == 2


def test_bounce_and_sample_uniforms(launched):
    """The photon walk's bounce uniforms and the light samples' arrays, one
    launch each draw."""
    n_int = torch.tensor([0, 1, 2, 7, 1, 0], dtype=torch.int32)
    got, want, n = launched(p_photon._bounce_uniforms, _key(), _ids(6),
                            n_int)
    _equal(got, want)
    assert n == 1
    layout = p_samples.SampleLayout()
    layout.add_1d(2)
    layout.add_2d(3)
    for name in ("materialize_1d", "materialize_2d"):
        got, want, n = launched(getattr(layout, name), _key(), _ids(5))
        _equal(got, want)


@pytest.mark.parametrize("broken", [False, True])
def test_smoke_phase_threefry(monkeypatch, broken):
    """chip_smoke.py's phase threefry on a 16×16 frame of 2^10 paths, the
    kernel stood in for: every draw is held to the eager ops and counted
    at one launch; a kernel that writes one uniform of a wide draw wrong
    fails the phase."""
    import chip_smoke
    from raytrace_tpu_torch.scene import presets

    def kernel(*args):
        threefry_draw(*args)
        lanes, out_kind, out = args[11], args[13], args[14]
        if broken and out_kind == prng._OUT_FLOATS and lanes > 100:
            _view(out, torch.float32, 1)[0] += 1e-3
        return 0

    monkeypatch.setattr(prng, "_on_card", lambda key: True)
    monkeypatch.setattr(cuda_lib, "load", lambda name, sigs: type(
        "Lib", (), {"threefry_draw": staticmethod(kernel)}))
    monkeypatch.setattr(cuda_lib, "stream_ptr", lambda dev: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "LARGE", dict(
        chip_smoke.LARGE, width=16, height=16, photon_paths=1 << 10))
    monkeypatch.setattr(chip_smoke, "SIZE", 16)
    monkeypatch.setattr(chip_smoke, "emit", lambda phase, **kv: None)
    scene, cam = presets.triangle_field("cpu", 2048, 16)
    if broken:
        with pytest.raises(AssertionError, match="differs from the eager"):
            chip_smoke.phase_threefry(torch.device("cpu"), scene, cam)
        return
    row = chip_smoke.phase_threefry(torch.device("cpu"), scene, cam)
    assert (row["bounce_lanes"], row["camera_lanes"]) == (1 << 10, 256)
    assert all(draws["calls"] for draws in row["direct"].values())
    assert row["direct"]["folded_uniform"]["launches"] == 4
    assert [1024, 3] in row["frame"]["folded_uniform"]["shapes"]
