"""The port's image files (raytrace_tpu_torch/utils/image.py) against the
JAX package's: for the same float32 array every writer puts the same bytes
on disk, each reader gives back what the writer was given, and the error
metrics are equal."""
import numpy as np
import pytest

from raytrace_tpu.utils import image as j_image
from raytrace_tpu_torch.utils import image as p_image


def _img(h=5, w=7, seed=0):
    """HDR-ish radiance with values below 0, inside [0, 1] and above 1."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.2, 1.6, (h, w, 3)).astype(np.float32)


WRITERS = {
    "png_gamma": (lambda m, p, a: m.write_png(p, a), ".png"),
    "png_linear": (lambda m, p, a: m.write_png(p, a, gamma=False), ".png"),
    "pfm": (lambda m, p, a: m.write_pfm(p, a), ".pfm"),
    "exr": (lambda m, p, a: m.write_exr(p, a), ".exr"),
}


@pytest.mark.parametrize("writer", list(WRITERS))
def test_writer_bytes_equal_jax(writer, tmp_path):
    write, ext = WRITERS[writer]
    img = _img()
    write(j_image, str(tmp_path / ("jax" + ext)), img)
    write(p_image, str(tmp_path / ("port" + ext)), img)
    want = (tmp_path / ("jax" + ext)).read_bytes()
    assert (tmp_path / ("port" + ext)).read_bytes() == want
    assert len(want) > img.shape[0] * img.shape[1] * 3


@pytest.mark.parametrize("fmt", ["pfm", "exr"])
def test_float_round_trip(fmt, tmp_path):
    img = _img(4, 9, seed=1)
    path = str(tmp_path / f"x.{fmt}")
    getattr(p_image, f"write_{fmt}")(path, img)
    back = getattr(p_image, f"read_{fmt}")(path)
    np.testing.assert_array_equal(back, img)
    # files cross between the packages both ways
    np.testing.assert_array_equal(getattr(j_image, f"read_{fmt}")(path), img)
    getattr(j_image, f"write_{fmt}")(path, img)
    np.testing.assert_array_equal(getattr(p_image, f"read_{fmt}")(path), img)


def test_readers_refuse_other_files(tmp_path):
    path = tmp_path / "x.bin"
    path.write_bytes(b"P6\n1 1\n255\n\x00\x00\x00")
    with pytest.raises(ValueError):
        p_image.read_pfm(str(path))
    with pytest.raises(ValueError):
        p_image.read_exr(str(path))


def test_srgb_and_error_metrics_equal_jax():
    a, b = _img(seed=2), _img(seed=3)
    np.testing.assert_array_equal(p_image.to_srgb(a), j_image.to_srgb(a))
    assert p_image.rmse(a, b) == j_image.rmse(a, b)
    assert p_image.relative_error(a, b) == j_image.relative_error(a, b)
    assert (p_image.relative_error(a, b, floor=0.5)
            == j_image.relative_error(a, b, floor=0.5))
    assert p_image.rmse(a, a) == 0.0
