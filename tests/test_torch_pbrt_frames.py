"""Whole photon-mapping frames of pbrt scenes that use a distant light, a
checker texture and a thin lens: each scene is parsed from the same pbrt
text by both packages and rendered at 32×32, 1 spp, 2^12 photon paths
(16,384 slots, so the row-span gather runs), JAX with its exact gather.

Bounds as in tests/test_torch_render.py: float32 rounding differs by ulps
between the two, which rarely flips a grazing hit or a Russian-roulette
draw on its threshold. The image must agree to relative L1 ≤ 1e-4 with at
most 1% of the pixels off by more than 1e-3 relative, and the valid photon
counts may differ by the flipped slots, at most 2% of them. The three
scenes share their array shapes, so JAX compiles the frame once."""
import dataclasses

import jax
import numpy as np
import pytest

from tests.torch_port_util import n
from raytrace_tpu.core.config import RenderConfig as JConfig
from raytrace_tpu.renderers import photon as j_photon
from raytrace_tpu.scene import pbrt as j_pbrt
from raytrace_tpu_torch import loads_pbrt
from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.core.config import RenderConfig as PConfig
from raytrace_tpu_torch.renderers import photon as p_photon
from raytrace_tpu_torch.scene.scene import LIGHT_DISTANT

SIZE = 32
BENCH = dict(width=SIZE, height=SIZE, spp=1, scene_epsilon=1e-3,
             photon_paths=1 << 12, max_photon_bounces=8,
             footprint_radius_scale=8.0)
SLOT_FLIP_FRAC = 0.02

# a textured ground quad in a corner of two walls, and a ball, under one
# light: the walls send photons back to the floor
SCENE = """
LookAt 0 -4 2.5  0 0 0.5  0 0 1
Camera "perspective" "float fov" [45] {lens}
Film "image" "integer xresolution" [32] "integer yresolution" [32]
WorldBegin
{light}
{texture}
Material "matte" {kd}
Shape "trianglemesh" "point P" [-3 -3 0  3 -3 0  3 3 0  -3 3 0]
  "integer indices" [0 1 2  0 2 3] "float uv" [0 0  1 0  1 1  0 1]
AttributeBegin
  Material "matte" "rgb Kd" [0.2 0.5 0.7]
  Shape "trianglemesh"
    "point P" [-3 3 0  3 3 0  3 3 3  -3 3 3  -3 -3 0  -3 -3 3]
    "integer indices" [0 1 2  0 2 3  4 0 3  4 3 5]
AttributeEnd
AttributeBegin
  Material "matte" "rgb Kd" [0.7 0.3 0.2]
  Translate 0.3 0.2 0.8
  Shape "sphere" "float radius" [0.8]
AttributeEnd
WorldEnd
"""
POINT = 'LightSource "point" "rgb I" [20 20 20] "point from" [1 -2 4]'
PLAIN = dict(lens="", light=POINT, texture="", kd='"rgb Kd" [0.6 0.6 0.6]')
FEATURES = {
    "distant_light": dict(
        PLAIN, light='LightSource "distant" "rgb L" [3 3 3] '
                     '"point from" [1 -1 4] "point to" [0 0 0]'),
    "checker_texture": dict(
        PLAIN, texture='Texture "checks" "spectrum" "checkerboard" '
                       '"rgb tex1" [0.8 0.7 0.2] "float uscale" [4]',
        kd='"texture Kd" "checks"'),
    "thin_lens": dict(
        PLAIN, lens='"float lensradius" [0.25] "float focaldistance" [2]'),
}


@pytest.mark.parametrize("feature", list(FEATURES))
def test_pbrt_frame_matches_jax(feature):
    text = SCENE.format(**FEATURES[feature])
    jp, pp = j_pbrt.loads_pbrt(text), loads_pbrt(text, "cpu")
    s = pp.scene
    if feature == "distant_light":
        assert int(s.lights.ltype[0]) == LIGHT_DISTANT
    elif feature == "checker_texture":
        assert int(s.materials.tex_type[int(s.tris.mat[0])]) == 1
    else:
        assert pp.camera.lens_radius > 0.0
    jcfg = JConfig(**BENCH, exact_gather=True)
    pcfg = PConfig(**BENCH)
    jimg, jaux = j_photon.render_photon(jp.scene, jp.camera, jcfg,
                                        jax.random.PRNGKey(0),
                                        return_aux=True)
    pimg, paux = p_photon.render_photon(s, pp.camera, pcfg,
                                        prng.PRNGKey(0, "cpu"),
                                        return_aux=True)
    jimg, pimg = n(jimg), n(pimg)
    assert pimg.shape == (SIZE, SIZE, 3) and np.isfinite(pimg).all()
    assert pimg.mean() > 0.02
    rel_l1 = np.abs(pimg - jimg).sum() / np.abs(jimg).sum()
    assert rel_l1 <= 1e-4
    off = np.abs(pimg - jimg).max(-1) > 1e-3 * np.maximum(jimg.max(-1), 1.0)
    assert off.mean() <= 0.01
    assert int(paux["gather_overflow"]) == 0 and paux["pair_overflow"] == 0
    assert int(paux["valid_photons"]) > 0
    assert abs(int(paux["valid_photons"]) - int(jaux["valid_photons"])) <= (
        SLOT_FLIP_FRAC * BENCH["photon_paths"] * jcfg.max_photon_depth)
    # the feature shows: against the same scene without it, the frame moves
    plain = loads_pbrt(SCENE.format(**PLAIN), "cpu")
    base = n(p_photon.render_photon(plain.scene, plain.camera, pcfg,
                                    prng.PRNGKey(0, "cpu")))
    assert np.abs(pimg - base).sum() > 0.05 * np.abs(base).sum()


def test_scenes_share_shapes():
    """The three scenes differ in data, not in array shapes (one JAX
    compile for the file)."""
    shapes = set()
    for feat in FEATURES.values():
        s = loads_pbrt(SCENE.format(**feat), "cpu").scene
        shapes.add(tuple((f.name, tuple(getattr(fam, f.name).shape))
                         for fam in (s.tris, s.spheres, s.disks,
                                     s.materials, s.lights)
                         for f in dataclasses.fields(fam)
                         if getattr(fam, f.name) is not None))
    assert len(shapes) == 1
