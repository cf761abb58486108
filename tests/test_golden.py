"""Golden-tracer self-consistency: the vectorized float64 golden must match
the scalar per-pixel transliteration bitwise-closely (both are float64; they
differ only in masking strategy)."""

import numpy as np
import pytest

from loltracer_tpu.golden import render_golden, render_golden_scalar, trace_pixel
from loltracer_tpu.lol import parse_scene_file
from loltracer_tpu.scene import build_scene


@pytest.mark.parametrize("name", ["scene.lol", "scene3.lol"])
def test_vectorized_matches_scalar(examples_dir, name):
    # tiny images: the scalar golden is pure-Python slow, and agreement at a
    # handful of pixels covering hit/miss/shadow cases is what matters
    scene = build_scene(parse_scene_file(str(examples_dir / name)), dtype=np.float64)
    vec = render_golden(scene, 8, 6)
    scal = render_golden_scalar(scene, 8, 6)
    np.testing.assert_allclose(vec, scal, rtol=1e-12, atol=1e-12)


def test_trace_pixel_consistent(examples_dir):
    scene = build_scene(
        parse_scene_file(str(examples_dir / "scene2.lol")), dtype=np.float64
    )
    vec = render_golden(scene, 16, 12)
    for (x, y) in [(8, 6), (0, 0), (15, 11)]:
        px = trace_pixel(scene, x, y, 16, 12)
        np.testing.assert_allclose(vec[y, x], px, rtol=1e-12, atol=1e-12)


def test_golden_is_float64(examples_dir):
    scene = build_scene(
        parse_scene_file(str(examples_dir / "scene.lol")), dtype=np.float64
    )
    img = render_golden(scene, 8, 6)
    assert img.dtype == np.float64
    assert np.all(np.isfinite(img))


@pytest.mark.parametrize("window", [(2, 3, 4, 5), (0, 0, 12, 16)],
                         ids=["inner", "whole"])
def test_window_matches_full_render(examples_dir, window):
    """render_golden(window=...) renders exactly that crop of the image."""
    scene = build_scene(
        parse_scene_file(str(examples_dir / "scene2.lol")), dtype=np.float64
    )
    full = render_golden(scene, 16, 12)
    y0, x0, h, w = window
    part = render_golden(scene, 16, 12, window=window)
    np.testing.assert_array_equal(part, full[y0:y0 + h, x0:x0 + w])


def test_instanced_golden_chunking_keeps_first_wins():
    """The instanced golden SDF scans spheres in chunks; the result equals
    one min/argmin over all of them (first-wins ties included)."""
    from loltracer_tpu.golden.tracer import _scene_sdf_vec
    from loltracer_tpu.scene import Scene, params_astype
    from loltracer_tpu.scenes import instanced_spheres

    s = instanced_spheres(n=2500, seed=1)
    scene = Scene(structure=s.structure,
                  params=params_astype(s.params, np.float64))
    p = np.random.RandomState(0).uniform(-30, 30, (64, 3))
    d, i = _scene_sdf_vec(scene, p)
    pr = scene.params
    all_d = np.concatenate(
        [np.linalg.norm(p[:, None] - pr.sphere_point, axis=-1)
         - pr.sphere_radius, p[:, 1:2] - pr.plane_y], axis=-1
    )
    np.testing.assert_array_equal(d, all_d.min(axis=-1))
    np.testing.assert_array_equal(i, all_d.argmin(axis=-1) + 1)
