"""The port's `raytrace-tpu-torch` CLI (raytrace_tpu_torch/cli.py) on a
16×16 copy of examples/cornell.pbrt, on the CPU: it writes exactly the image
the renderers give for the parsed scene, dispatches the output format by
extension as JAX's CLI does, resumes from its checkpoint, refuses to run
without CUDA unless asked for the CPU, and is the console script that
pyproject.toml names. Also the two example scripts, on the CPU."""
import os
import struct
import subprocess
import sys
import tomllib

import numpy as np
import pytest
import torch

from raytrace_tpu_torch import cli, load_pbrt
from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.core.config import RenderConfig
from raytrace_tpu_torch.renderers import photon, simple
from raytrace_tpu_torch.utils import image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATHS = 1 << 12


@pytest.fixture(scope="module")
def scene_file(tmp_path_factory):
    text = open(os.path.join(ROOT, "examples", "cornell.pbrt")).read()
    film = '"integer xresolution" [128] "integer yresolution" [128]'
    assert film in text
    path = tmp_path_factory.mktemp("scene") / "cornell16.pbrt"
    path.write_text(text.replace(film, film.replace("128", "16")))
    return str(path)


def _run(scene_file, out, *flags):
    cli.main([scene_file, "--cpu", "--seed", "0", "--photon-paths",
              str(PATHS), "-o", str(out), *flags])


def _config(passes=1, **kw):
    """The config the CLI builds for the 16×16 file, written out."""
    return RenderConfig(width=16, height=16, spp=1, scene_epsilon=1e-3,
                        photon_paths=PATHS, photon_passes=passes, seed=0,
                        **kw)


def test_pfm_equals_direct_render(scene_file, tmp_path):
    _run(scene_file, tmp_path / "a.pfm", "--footprint-radius-scale", "8")
    got = image.read_pfm(str(tmp_path / "a.pfm"))
    parsed = load_pbrt(scene_file, "cpu")
    want = photon.render_photon(parsed.scene, parsed.camera,
                                _config(footprint_radius_scale=8.0),
                                prng.PRNGKey(0, "cpu")).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all() and got.mean() > 0.0


def test_output_dispatch_by_extension(scene_file, tmp_path):
    """.exr and .pfm linear, anything else a gamma-mapped PNG; --pfm also
    writes the PFM. Each file holds the bytes its writer gives for the
    image."""
    _run(scene_file, tmp_path / "a.exr", "--pfm", str(tmp_path / "a.pfm"))
    _run(scene_file, tmp_path / "b.png")
    img = image.read_pfm(str(tmp_path / "a.pfm"))
    np.testing.assert_array_equal(image.read_exr(str(tmp_path / "a.exr")),
                                  img)
    for name, write in (("a.exr", image.write_exr),
                        ("b.png", image.write_png)):
        write(str(tmp_path / ("want_" + name)), img)
        assert ((tmp_path / name).read_bytes()
                == (tmp_path / ("want_" + name)).read_bytes())
    assert struct.unpack("<I", (tmp_path / "a.exr").read_bytes()[:4]) == (
        20000630,)
    assert (tmp_path / "b.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_simple_renderer(scene_file, tmp_path):
    _run(scene_file, tmp_path / "s.pfm", "--renderer", "simple")
    got = image.read_pfm(str(tmp_path / "s.pfm"))
    parsed = load_pbrt(scene_file, "cpu")
    want = simple.render_simple(parsed.scene, parsed.camera, _config(),
                                prng.PRNGKey(0, "cpu")).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all() and got.mean() > 0.0


def test_checkpoint_resumes_to_the_same_image(scene_file, tmp_path):
    ckpt = str(tmp_path / "ppm.ckpt")
    _run(scene_file, tmp_path / "half.pfm", "--passes", "2",
         "--checkpoint", ckpt)
    _run(scene_file, tmp_path / "resumed.pfm", "--passes", "3",
         "--checkpoint", ckpt)
    _run(scene_file, tmp_path / "whole.pfm", "--passes", "3")
    resumed = image.read_pfm(str(tmp_path / "resumed.pfm"))
    np.testing.assert_array_equal(
        resumed, image.read_pfm(str(tmp_path / "whole.pfm")))
    assert not np.array_equal(
        resumed, image.read_pfm(str(tmp_path / "half.pfm")))


def test_without_cuda_it_raises_unless_asked_for_the_cpu(scene_file,
                                                         tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "never.png"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([scene_file, "-o", str(out)])
    assert not out.exists()


def test_console_script_resolves_to_main():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts["raytrace-tpu"] == "raytrace_tpu.cli:main"
    module, _, attr = scripts["raytrace-tpu-torch"].partition(":")
    assert module == "raytrace_tpu_torch.cli" and attr == "main"
    assert getattr(cli, attr) is cli.main


@pytest.mark.parametrize("script,args,outputs", [
    ("render_pbrt_torch.py", ["--photon-paths", "1024", "-o", "{tmp}/c.png"],
     ["c.png"]),
    ("render_sphere_plane_torch.py", [],
     ["sphere_plane_torch.png", "sphere_plane_torch.pfm"]),
])
def test_example_scripts_on_the_cpu(script, args, outputs, scene_file,
                                    tmp_path):
    args = [a.format(tmp=tmp_path) for a in args]
    if script == "render_pbrt_torch.py":
        args = [scene_file] + args
    env = dict(os.environ, TMPDIR=str(tmp_path))
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", script), "--cpu",
         *args], capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    for name in outputs:
        assert (tmp_path / name).stat().st_size > 0
