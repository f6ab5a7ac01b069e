"""The port's simple direct-lighting renderer against the JAX package's at
16×16, and the port's observability helpers (utils/metrics.py).

Bounds as in tests/test_torch_render.py: both renderers draw the same
pixel and light samples from the same key; float32 rounding differs by
ulps, and a ray that grazes an edge may flip between two surfaces. The
image must agree to relative L1 ≤ 1e-4 with at most 1% of the pixels off by
more than 1e-3 relative."""
import logging
import time

import jax
import numpy as np
import pytest

from tests.torch_port_util import n
from raytrace_tpu.core.config import RenderConfig as JConfig
from raytrace_tpu.renderers import simple as j_simple
from raytrace_tpu.scene import presets as j_presets
from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.core.config import RenderConfig as PConfig
from raytrace_tpu_torch.renderers import simple as p_simple
from raytrace_tpu_torch.scene import presets as p_presets
from raytrace_tpu_torch.utils import metrics

SIZE = 16
SCENES = {
    # BASELINE config[0]: sphere on a plane, one point light
    "sphere_plane": (lambda: j_presets.sphere_plane(SIZE),
                     lambda: p_presets.sphere_plane("cpu", SIZE), {}),
    # the Cornell box with a mirror ball (a specular chain into direct
    # light) and 2 area-light samples
    "cornell_mirror": (
        lambda: j_presets.cornell_box(SIZE, ball="mirror",
                                      n_light_samples=2),
        lambda: p_presets.cornell_box("cpu", SIZE, ball="mirror",
                                      n_light_samples=2),
        dict(scene_epsilon=1e-3)),
}


@pytest.mark.parametrize("name", list(SCENES))
def test_render_simple_matches_jax(name):
    j_make, p_make, kw = SCENES[name]
    (js, jc), (ps, pc) = j_make(), p_make()
    cfg = dict(width=SIZE, height=SIZE, spp=2, **kw)
    jimg = n(j_simple.render_simple(js, jc, JConfig(**cfg),
                                    jax.random.PRNGKey(3)))
    pimg = n(p_simple.render_simple(ps, pc, PConfig(**cfg),
                                    prng.PRNGKey(3, "cpu")))
    assert pimg.shape == (SIZE, SIZE, 3) and np.isfinite(pimg).all()
    assert pimg.mean() > 0.01
    rel_l1 = np.abs(pimg - jimg).sum() / np.abs(jimg).sum()
    assert rel_l1 <= 1e-4
    off = np.abs(pimg - jimg).max(-1) > 1e-3 * np.maximum(jimg.max(-1), 1.0)
    assert off.mean() <= 0.01


def test_log_pass_structured(caplog):
    with caplog.at_level(logging.INFO, logger="raytrace_tpu_torch"):
        metrics.log_pass("photon_wave", wave=3, valid_photons=123)
    assert "pass=photon_wave" in caplog.text
    assert "wave=3" in caplog.text and "valid_photons=123" in caplog.text


def test_throughput_counter():
    with metrics.Throughput() as tp:
        time.sleep(0.05)
    assert tp.seconds >= 0.05
    assert 0 < tp.rate(1000) <= 1000 / 0.05


def test_trace_writes_chrome_trace(tmp_path):
    import torch

    with metrics.trace(str(tmp_path / "prof")):
        torch.ones(64).cumsum(0)
    text = (tmp_path / "prof" / "trace.json").read_text()
    assert "traceEvents" in text
