"""Triton march kernel equivalence vs the jnp while_loop march.

The march result is stop-gradient'd by the differentiable path, so backend
choice must not change values (and cannot change gradients); these tests pin
value equivalence in interpret mode on CPU, including the closest-approach
channels the soft-coverage AA consumes. The step-clamp cases pin the
instanced step-clamp semantics on the jnp path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from loltracer_tpu.config import RenderConfig
from loltracer_tpu.lol import parse_scene_file
from loltracer_tpu.render.camera import camera_rays
from loltracer_tpu.render.jnp_renderer import make_renderer, render_image
from loltracer_tpu.render.march import march
from loltracer_tpu.render.triton_march import make_triton_march
from loltracer_tpu.render.sdf import make_scene_sdf
from loltracer_tpu.scene import build_scene

H, W = 16, 128


@pytest.fixture(scope="module")
def scenes(examples_dir):
    return {
        name: build_scene(parse_scene_file(str(examples_dir / name)))
        for name in ["scene.lol", "scene2.lol", "scene3.lol", "scene4.lol"]
    }


@pytest.mark.parametrize(
    "name", ["scene.lol", "scene2.lol", "scene3.lol", "scene4.lol"]
)
def test_march_kernel_matches_jnp(scenes, name):
    scene = scenes[name]
    cfg = RenderConfig()
    ro, rd = camera_rays(scene.params, H, W, cfg)
    sdf = make_scene_sdf(scene.structure)
    ref = march(sdf, scene.params, ro, rd, cfg)
    pal = make_triton_march(scene.structure, cfg, interpret=True)(
        scene.params, ro, rd
    )
    np.testing.assert_allclose(pal.t, ref.t, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(pal.t_query, ref.t_query, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(pal.t_close, ref.t_close, atol=1e-4, rtol=1e-4)
    # s_min is inf where never tracked; compare finite lanes
    fin = np.isfinite(np.asarray(ref.s_min))
    assert fin.shape == np.asarray(pal.s_min).shape
    np.testing.assert_array_equal(fin, np.isfinite(np.asarray(pal.s_min)))
    np.testing.assert_allclose(
        np.asarray(pal.s_min)[fin], np.asarray(ref.s_min)[fin],
        atol=1e-4, rtol=1e-4,
    )


def test_march_kernel_nonaligned(scenes):
    """Odd sizes pad with edge-replicated rays and crop."""
    scene = scenes["scene.lol"]
    cfg = RenderConfig()
    ro, rd = camera_rays(scene.params, 13, 150, cfg)
    sdf = make_scene_sdf(scene.structure)
    ref = march(sdf, scene.params, ro, rd, cfg)
    pal = make_triton_march(scene.structure, cfg, interpret=True)(
        scene.params, ro, rd
    )
    assert pal.t.shape == (13, 150)
    np.testing.assert_allclose(pal.t, ref.t, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("antialias", [False, True])
def test_render_with_pallas_march_matches(scenes, antialias):
    """Full render via march_backend=triton-interpret equals the default."""
    scene = scenes["scene3.lol"]
    base = RenderConfig(antialias=antialias)
    ref = np.asarray(
        render_image(scene.structure, scene.params, H, W, base)
    )
    img = np.asarray(
        render_image(
            scene.structure, scene.params, H, W,
            base.replace(march_backend="triton-interpret"),
        )
    )
    np.testing.assert_allclose(img, ref, atol=5e-5)


def test_grad_with_pallas_march_matches(scenes):
    """Gradients are identical across march backends (the march is frozen
    and IFT-re-attached either way)."""
    scene = scenes["scene4.lol"]
    base = RenderConfig(antialias=True)

    def loss(params, cfg):
        img = render_image(scene.structure, params, H, W, cfg)
        return jnp.mean(img * img)

    g_ref = jax.grad(loss)(scene.params, base)
    g_pal = jax.grad(loss)(
        scene.params, base.replace(march_backend="triton-interpret")
    )
    for a, b in zip(
        jax.tree_util.tree_leaves(g_ref), jax.tree_util.tree_leaves(g_pal)
    ):
        np.testing.assert_allclose(
            np.asarray(b), np.asarray(a), atol=1e-4, rtol=1e-3
        )


def test_instanced_step_clamp_same_hits_as_exact():
    """The clamp is conservative: rays hit the same surfaces (same hit
    mask; hit distances within a few epsilon), only free-space step sizes
    change. (config.py step_clamp docstring — the clamp may not create or
    destroy hits away from the 256-step budget edge.)"""
    from loltracer_tpu.config import DEFAULT_CONFIG
    from loltracer_tpu.scenes import instanced_spheres

    scene = instanced_spheres(n=300, seed=9)
    cfg = DEFAULT_CONFIG
    ro, rd = camera_rays(scene.params, H, W, cfg)
    exact = march(
        make_scene_sdf(scene.structure), scene.params, ro, rd, cfg
    )
    clamped = march(
        make_scene_sdf(scene.structure, 4.0), scene.params, ro, rd, cfg
    )
    hit_e = np.asarray(exact.t) < cfg.max_dist
    hit_c = np.asarray(clamped.t) < cfg.max_dist
    np.testing.assert_array_equal(hit_c, hit_e)
    np.testing.assert_allclose(
        np.asarray(clamped.t)[hit_c], np.asarray(exact.t)[hit_e],
        atol=5e-3,
    )


def test_instanced_step_clamp_render_close_to_exact():
    """Full render with the clamp stays visually identical to exact: the
    shading pipeline consumes only small distances (hits, penumbra minima,
    normal taps), all in the d < clamp regime where values are exact."""
    from loltracer_tpu.scenes import instanced_spheres

    scene = instanced_spheres(n=300, seed=9)
    base = RenderConfig()
    img_e = np.asarray(
        render_image(scene.structure, scene.params, H, W, base)
    )
    img_c = np.asarray(
        render_image(
            scene.structure, scene.params, H, W,
            base.replace(step_clamp=4.0),
        )
    )
    assert np.mean(np.abs(img_c - img_e)) < 1e-4
    assert np.max(np.abs(img_c - img_e)) < 2e-2
