"""The port's pbrt parser (raytrace_tpu_torch/scene/pbrt.py) against the JAX
package's on the same text: every Scene field and the camera equal, ints
exactly and floats to 1e-6, the same film options and the same warnings.
Twins of tests/test_pbrt.py and of
tests/test_distant.py::test_pbrt_parser_distant, each also checking what the
JAX test checks, plus the parser's scoping rules (textures and
ReverseOrientation in attribute blocks), instancing with a disk area light,
"st" in place of "uv", the Integrator alias and the pixel-filter
fallback."""
import dataclasses
import os
import warnings

import jax
import numpy as np
import pytest

from tests.torch_port_util import n, np_tree
from raytrace_tpu.renderers import simple as j_simple
from raytrace_tpu.core.config import RenderConfig as JConfig
from raytrace_tpu.scene import pbrt as j_pbrt
from raytrace_tpu_torch import load_pbrt, loads_pbrt
from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.core.config import RenderConfig as PConfig
from raytrace_tpu_torch.renderers import simple as p_simple
from raytrace_tpu_torch.scene import presets as p_presets
from raytrace_tpu_torch.scene import transform as tr
from raytrace_tpu_torch.scene.scene import LIGHT_DISTANT

EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "examples",
                       "cornell.pbrt")
# float32 fields built from the same float64 numpy math in both packages;
# the camera inverts the CTM twice in float64
ATOL = 1e-6


def assert_tree_close(port_obj, ref_obj, path="", atol=ATOL):
    """Every field of a port dataclass against the same field of `ref_obj`
    (a JAX pytree as numpy, or another port object): ints and bools
    exactly, floats within `atol`, None where the other is None."""
    for f in dataclasses.fields(port_obj):
        name = f"{path}.{f.name}"
        a, b = getattr(port_obj, f.name), getattr(ref_obj, f.name)
        if dataclasses.is_dataclass(a):
            assert_tree_close(a, b, name, atol)
        elif a is None or b is None:
            assert a is None and b is None, name
        else:
            a, b = np.asarray(n(a)), np.asarray(n(b))
            assert a.shape == b.shape, name
            if np.issubdtype(b.dtype, np.floating):
                np.testing.assert_allclose(a, b, rtol=0, atol=atol,
                                           err_msg=name)
            else:
                np.testing.assert_array_equal(a, b, err_msg=name)


def assert_parsed_equal(port, ref):
    """A port PbrtScene against JAX's (or the port's own) parse result."""
    for f in ("width", "height", "spp", "renderer", "pixel_filter"):
        assert getattr(port, f) == getattr(ref, f), f
    assert_tree_close(port.scene, np_tree(ref.scene), "scene")
    assert_tree_close(port.camera, np_tree(ref.camera), "camera")


def parse_both(text):
    """The same text through both parsers, held equal field for field and
    warning for warning → (the port's PbrtScene, its pbrt warnings)."""
    out = []
    for parse in (lambda: loads_pbrt(text, "cpu"),
                  lambda: j_pbrt.loads_pbrt(text)):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            parsed = parse()
        out.append((parsed, [str(x.message) for x in w
                             if str(x.message).startswith("pbrt:")]))
    (port, port_w), (ref, ref_w) = out
    assert_parsed_equal(port, ref)
    assert port_w == ref_w
    return port, port_w


def test_cornell_pbrt_matches_preset():
    parsed = load_pbrt(EXAMPLE, "cpu")
    assert_parsed_equal(parsed, j_pbrt.load_pbrt(EXAMPLE))
    scene_ref, cam_ref = p_presets.cornell_box("cpu", 128, ball="glass")
    assert parsed.width == 128 and parsed.height == 128
    assert parsed.renderer == "photonmapping"
    assert_tree_close(parsed.scene, scene_ref, "scene")
    assert_tree_close(parsed.camera, cam_ref, "camera")


def test_parsed_scene_renders():
    parsed = load_pbrt(EXAMPLE, "cpu")
    ref = j_pbrt.load_pbrt(EXAMPLE)
    cfg = dict(width=parsed.width, height=parsed.height, spp=1,
               scene_epsilon=1e-3)
    img = n(p_simple.render_simple(parsed.scene, parsed.camera,
                                   PConfig(**cfg), prng.PRNGKey(0, "cpu"),
                                   jitter=False))
    jimg = n(j_simple.render_simple(ref.scene, ref.camera, JConfig(**cfg),
                                    jax.random.PRNGKey(0), jitter=False))
    assert np.isfinite(img).all() and float(img.mean()) > 0.0
    # without jitter, a few pixel centres sight the box's floor-wall edge
    # exactly, and the two packages pick different (valid) triangles
    # there: those pixels are counted and bounded (3 of 16,384 seen), the
    # rest held to relative L1 1e-4
    off = np.abs(img - jimg).max(-1) > 1e-3 * np.maximum(jimg.max(-1), 1.0)
    assert off.sum() <= 1e-3 * off.size
    keep = ~off[..., None]
    rel_l1 = (np.abs(img - jimg) * keep).sum() / (np.abs(jimg) * keep).sum()
    assert rel_l1 <= 1e-4


def test_transform_stack_and_instancing():
    parsed, _ = parse_both("""
    Film "image" "integer xresolution" [8] "integer yresolution" [8]
    WorldBegin
    Material "matte" "rgb Kd" [0.5 0.5 0.5]
    ObjectBegin "ball"
      Shape "sphere" "float radius" [2]
    ObjectEnd
    AttributeBegin
      Translate 5 0 0
      ObjectInstance "ball"
    AttributeEnd
    AttributeBegin
      Translate 0 7 0
      Scale 2 2 2
      ObjectInstance "ball"
    AttributeEnd
    LightSource "point" "rgb I" [10 10 10] "point from" [0 0 5]
    WorldEnd
    """)
    s = parsed.scene
    assert s.spheres.count == 2
    np.testing.assert_allclose(n(s.spheres.o2w[0, :, 3]), [5.0, 0.0, 0.0],
                               atol=1e-6)
    np.testing.assert_allclose(n(s.spheres.o2w[1, :, 3]), [0.0, 7.0, 0.0],
                               atol=1e-6)
    np.testing.assert_allclose(n(s.spheres.o2w[1, :, :3]), 2 * np.eye(3),
                               atol=1e-6)
    np.testing.assert_allclose(n(s.lights.o[0]), [0, 0, 5], atol=1e-6)


def test_unsupported_statements_warn_not_crash():
    parsed, msgs = parse_both("""
    Film "image" "integer xresolution" [8] "integer yresolution" [8]
    WorldBegin
    Material "plastic" "rgb Kd" [0.3 0.3 0.3]
    Shape "cone" "float radius" [1]
    LightSource "spot" "rgb I" [1 1 1]
    Material "matte" "rgb Kd" [0.4 0.4 0.4]
    Shape "sphere" "float radius" [1]
    WorldEnd
    """)
    msgs = " ".join(msgs)
    assert "plastic" in msgs and "cone" in msgs and "spot" in msgs
    assert parsed.scene.spheres.count == 1
    np.testing.assert_allclose(n(parsed.scene.materials.kd[0]),
                               [0.5, 0.5, 0.5])


def test_lookat_and_fov():
    parsed, _ = parse_both("""
    LookAt 1 2 3  4 5 6  0 0 1
    Camera "perspective" "float fov" [42.5]
    Film "image" "integer xresolution" [32] "integer yresolution" [16]
    WorldBegin
    WorldEnd
    """)
    assert parsed.width == 32 and parsed.height == 16
    expect = tr.look_at((1, 2, 3), (4, 5, 6), (0, 0, 1))
    np.testing.assert_allclose(n(parsed.camera.camera_to_world)[:, 3],
                               expect[:3, 3], atol=1e-5)


def test_texture_checkerboard_maps_to_checker_seam():
    out, _ = parse_both("""
    Film "image" "integer xresolution" [32] "integer yresolution" [32]
    Camera "perspective" "float fov" [45]
    WorldBegin
    Texture "checks" "spectrum" "checkerboard"
        "rgb tex1" [0.8 0.6 0.4] "float uscale" [4]
    Material "matte" "texture Kd" "checks"
    Shape "trianglemesh"
        "integer indices" [0 1 2]
        "point P" [-1 -1 0  1 -1 0  0 1 0]
    LightSource "point" "rgb I" [10 10 10] "point from" [0 0 5]
    WorldEnd
    """)
    mats = out.scene.materials
    m = int(out.scene.tris.mat[0])
    assert int(mats.tex_type[m]) == 1
    assert float(mats.tex_scale[m]) == 4.0
    np.testing.assert_allclose(n(mats.kd[m]), [0.8, 0.6, 0.4], rtol=1e-6)


def test_camera_dof_and_pixel_filter_wired():
    parsed, _ = parse_both("""
    LookAt 0 0 0  0 1 0  0 0 1
    Camera "perspective" "float fov" [45]
        "float lensradius" [0.125] "float focaldistance" [3.5]
    PixelFilter "triangle" "float xwidth" [2]
    Film "image" "integer xresolution" [8] "integer yresolution" [8]
    WorldBegin
    Material "matte" "rgb Kd" [0.5 0.5 0.5]
    Shape "sphere" "float radius" [1]
    WorldEnd
    """)
    assert float(parsed.camera.lens_radius) == 0.125
    assert float(parsed.camera.focal_distance) == 3.5
    assert parsed.pixel_filter == "triangle"


def test_reverse_orientation_scoped_by_attribute_blocks():
    parsed, _ = parse_both("""
    Film "image" "integer xresolution" [8] "integer yresolution" [8]
    WorldBegin
    Material "matte" "rgb Kd" [0.5 0.5 0.5]
    AttributeBegin
      ReverseOrientation
      Shape "trianglemesh" "point P" [-1 0 -1  1 0 -1  1 0 1]
        "integer indices" [0 1 2]
    AttributeEnd
    Shape "trianglemesh" "point P" [-1 2 -1  1 2 -1  1 2 1]
      "integer indices" [0 1 2]
    WorldEnd
    """)
    tris = parsed.scene.tris
    assert tris.count == 2
    n0 = n(tris.n0)
    np.testing.assert_allclose(n0[0], -n0[1], atol=1e-6)


def test_pbrt_parser_distant():
    parsed, _ = parse_both("""
        LookAt 0 -3 1  0 0 1  0 0 1
        Camera "perspective" "float fov" [40]
        Film "image" "integer xresolution" [32] "integer yresolution" [32]
        WorldBegin
        LightSource "distant" "rgb L" [3 3 3]
            "point from" [0 0 5] "point to" [0.2 0.1 0]
        Material "matte" "rgb Kd" [0.6 0.6 0.6]
        Shape "sphere" "float radius" [1]
        WorldEnd
        """)
    lt = parsed.scene.lights
    assert int(lt.ltype[0]) == LIGHT_DISTANT
    expect = np.array([0.2, 0.1, -5.0])
    expect /= np.linalg.norm(expect)
    np.testing.assert_allclose(n(lt.normal[0]), expect, atol=1e-6)


# cases the JAX tests do not cover; each is held field for field and
# warning for warning against JAX, then checked for its own rule
CASES = {
    # a Texture defined inside a block is scoped to it: the same name
    # outside resolves to the outer definition
    "texture_scope": ("""
    WorldBegin
    Texture "t" "spectrum" "constant" "rgb value" [0.2 0.3 0.4]
    AttributeBegin
      Texture "t" "spectrum" "checkerboard" "rgb tex1" [0.9 0.1 0.1]
        "float uscale" [3]
      Material "matte" "texture Kd" "t"
      Shape "sphere" "float radius" [1]
    AttributeEnd
    Material "matte" "texture Kd" "t"
    Shape "sphere" "float radius" [2]
    WorldEnd
    """, []),
    # ReverseOrientation toggles, is restored by AttributeEnd, and reaches
    # spheres, disks and the area-light disk
    "reverse_orientation_shapes": ("""
    WorldBegin
    ReverseOrientation
    Shape "sphere" "float radius" [1]
    AttributeBegin
      ReverseOrientation
      Shape "sphere" "float radius" [2]
      Shape "disk" "float radius" [1]
    AttributeEnd
    Shape "disk" "float radius" [2]
    AttributeBegin
      AreaLightSource "diffuse" "rgb L" [5 5 5]
      Translate 0 0 3
      Shape "disk" "float radius" [0.5]
    AttributeEnd
    WorldEnd
    """, []),
    # a disk with an area light inside ObjectBegin is plain geometry of the
    # object; its instances add no light
    "instanced_area_disk": ("""
    WorldBegin
    ObjectBegin "lamp"
      AreaLightSource "diffuse" "rgb L" [8 8 8]
      Shape "disk" "float radius" [0.5]
      Shape "trianglemesh" "point P" [0 0 0  1 0 0  0 1 0]
        "integer indices" [0 1 2]
    ObjectEnd
    AttributeBegin
      Translate 0 0 2
      ObjectInstance "lamp"
    AttributeEnd
    LightSource "point" "rgb I" [1 1 1] "point from" [0 0 5]
    WorldEnd
    """, ["pbrt: area light on trianglemesh unsupported (reference: disk "
          "area lights only, cudalight.cpp:55); emitting geometry only"]),
    # "st" in place of "uv"; a one-element rgb broadcasts; normals given
    "mesh_st_normals": ("""
    WorldBegin
    Material "matte" "rgb Kd" [0.25]
    Shape "trianglemesh" "point P" [0 0 0  1 0 0  1 1 0  0 1 0]
      "integer indices" [0 1 2  0 2 3]
      "float st" [0 0  1 0  1 1  0 1]
      "normal N" [0 0 1  0 0 1  0 0 1  0 0 1]
    LightSource "point" "rgb I" [1 1 1] "point from" [0 0 5]
    WorldEnd
    """, []),
    # the pbrt-v3 Integrator spelling selects the renderer; an unknown
    # pixel filter falls back to box; an unknown directive consumes its
    # name and parameters
    "integrator_filter_unknown": ("""
    Integrator "simple" "integer maxdepth" [5]
    PixelFilter "mitchell" "float B" [0.33]
    SurfaceIntegrator "directlighting" "integer maxdepth" [3]
    Accelerator "bvh"
    Sampler "halton" "integer pixelsamples" [4]
    WorldBegin
    Shape "sphere" "float radius" [1]
    WorldEnd
    """, ["pbrt: pixel filter 'mitchell' unsupported; using box",
          "pbrt: unsupported directive 'SurfaceIntegrator' ignored"]),
    # Transform replaces the CTM, ConcatTransform composes,
    # TransformBegin/End restores it; mirror and glass materials
    "transform_directives": ("""
    LookAt 0 -5 1  0 0 1  0 0 1
    Camera "perspective" "float fov" [50]
    WorldBegin
    Translate 9 9 9
    Transform [1 0 0 0  0 1 0 0  0 0 1 0  1 2 3 1]
    TransformBegin
      ConcatTransform [2 0 0 0  0 2 0 0  0 0 2 0  0 0 1 1]
      Rotate 30 0 0 1
      Material "mirror" "rgb Kr" [0.8 0.8 0.8]
      Shape "sphere" "float radius" [1]
    TransformEnd
    Material "glass" "float index" [1.33]
    Shape "sphere" "float radius" [0.5]
    LightSource "distant" "rgb L" [2 2 2]
    WorldEnd
    """, []),
}


@pytest.mark.parametrize("case", list(CASES))
def test_parser_rules_match_jax(case):
    text, want_warnings = CASES[case]
    parsed, msgs = parse_both(text)
    assert msgs == want_warnings
    s = parsed.scene
    if case == "texture_scope":
        mats = s.materials
        inner, outer = (int(m) for m in n(s.spheres.mat))
        assert int(mats.tex_type[inner]) == 1
        np.testing.assert_allclose(n(mats.kd[inner]), [0.9, 0.1, 0.1],
                                   rtol=1e-6)
        assert int(mats.tex_type[outer]) == 0
        np.testing.assert_allclose(n(mats.kd[outer]), [0.2, 0.3, 0.4],
                                   rtol=1e-6)
    elif case == "reverse_orientation_shapes":
        assert n(s.spheres.flip).tolist() == [True, False]
        # the inner disk is unflipped (toggled twice), the outer and the
        # area-light disk flipped: their frames' z axes point down
        assert n(s.disks.z)[:, 2].tolist() == [1.0, -1.0, -1.0]
        assert s.lights.count == 1
    elif case == "instanced_area_disk":
        assert s.disks.count == 1 and s.tris.count == 1
        assert int(s.disks.light[0]) == -1
        assert s.lights.count == 1  # the point light only
        np.testing.assert_allclose(n(s.disks.o[0]), [0, 0, 2], atol=1e-6)
    elif case == "mesh_st_normals":
        np.testing.assert_allclose(n(s.tris.uv1[1]), [1, 1], atol=1e-6)
        assert n(s.tris.has_normals).all()
        np.testing.assert_allclose(n(s.materials.kd[0]), [0.25] * 3)
    elif case == "integrator_filter_unknown":
        assert parsed.renderer == "simple"
        assert parsed.pixel_filter == "box" and parsed.spp == 4
        assert s.spheres.count == 1
    elif case == "transform_directives":
        np.testing.assert_allclose(n(s.spheres.o2w[1, :, 3]), [1, 2, 3],
                                   atol=1e-6)
        np.testing.assert_allclose(n(s.spheres.o2w[0, :, 3]), [1, 2, 4],
                                   atol=1e-6)


def test_texture_scoped_out_of_its_block_is_undefined():
    """A texture defined only inside a block is undefined after it: both
    parsers warn that they use a constant Kd. The port then does (pbrt's
    default 0.5); JAX's parser raises ValueError, reading the texture's name
    as the Kd value (ROADMAP Queue C)."""
    text = """
    WorldBegin
    AttributeBegin
      Texture "inner" "spectrum" "constant" "rgb value" [0.7 0.7 0.7]
    AttributeEnd
    Material "matte" "texture Kd" "inner"
    Shape "sphere" "float radius" [1]
    WorldEnd
    """
    want = ["pbrt: texture 'inner' undefined; using constant Kd"]
    for parse in (lambda: loads_pbrt(text, "cpu"),
                  lambda: j_pbrt.loads_pbrt(text)):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            try:
                parsed = parse()
            except ValueError:
                parsed = None
        assert [str(x.message) for x in w] == want
    assert parsed is None  # JAX's side
    with pytest.warns(UserWarning, match="undefined"):
        s = loads_pbrt(text, "cpu").scene
    m = int(s.spheres.mat[0])
    assert int(s.materials.tex_type[m]) == 0
    np.testing.assert_allclose(n(s.materials.kd[m]), [0.5, 0.5, 0.5])
