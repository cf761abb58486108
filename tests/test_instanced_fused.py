"""Instanced scenes, whole pipeline: the banded render (jnp_renderer.
render_image_banded, the path instanced scenes take at large sizes) must
reproduce the unbanded render under every instanced config, and its
gradients must match the unbanded path's AD."""

import jax
import numpy as np
import pytest

from loltracer_tpu.config import RenderConfig
from loltracer_tpu.render.jnp_renderer import render_image, render_image_banded
from loltracer_tpu.scenes import instanced_spheres

H, W = 36, 64
N = 300


@pytest.fixture(scope="module")
def scene():
    return instanced_spheres(n=N, seed=9)


def _banded(scene, cfg, band_rows=12):
    return jax.jit(
        lambda p: render_image_banded(
            scene.structure, p, H, W, cfg, band_rows=band_rows
        )
    )


@pytest.mark.parametrize(
    "cfg",
    [
        RenderConfig(),
        RenderConfig(step_clamp=2.0),
        RenderConfig(step_clamp=2.0, antialias=True),
        RenderConfig(step_clamp=2.0, shadow_grad="envelope"),
        RenderConfig(step_clamp=2.0, shadow_step_clamp=8.0),
    ],
    ids=["exact", "clamp", "clamp-aa", "clamp-envelope", "shadow-clamp"],
)
def test_instanced_fused_matches_jnp(scene, cfg):
    ref = np.asarray(
        jax.jit(lambda p: render_image(scene.structure, p, H, W, cfg))(
            scene.params
        )
    )
    img = np.asarray(_banded(scene, cfg)(scene.params))
    np.testing.assert_allclose(img, ref, atol=1e-4)


def test_instanced_fused_single_sphere():
    """Degenerate block shapes: one sphere, padded to a whole SoA block."""
    scene = instanced_spheres(n=1, seed=7)
    cfg = RenderConfig(step_clamp=2.0)
    ref = np.asarray(
        jax.jit(lambda p: render_image(scene.structure, p, H, W, cfg))(
            scene.params
        )
    )
    img = np.asarray(_banded(scene, cfg)(scene.params))
    np.testing.assert_allclose(img, ref, atol=1e-4)


@pytest.mark.parametrize("clamp", [2.0, None], ids=["clamp", "exact"])
def test_instanced_fused_gradients_match_banded(scene, clamp):
    """Banded gradients (incl. sphere positions/radii through the per-band
    checkpoint) match the unbanded path's AD away from penumbra-argmin
    near-ties (tests/_penumbra.py)."""
    import jax.numpy as jnp
    from _penumbra import penumbra_pixels, shadow_res_planes

    cfg = RenderConfig(
        shadow_grad="envelope", march_backend="jnp", step_clamp=clamp
    )
    keep = ~penumbra_pixels(shadow_res_planes(scene, cfg, H, W, kernel=False))
    keep = keep[..., None].astype(np.float32)
    target = 0.5

    def grads(render_fn):
        def loss(p):
            img = render_fn(p)
            return jnp.mean(jnp.asarray(keep) * (img - target) ** 2)

        return jax.jit(jax.grad(loss))(scene.params)

    g_f = grads(
        lambda p: render_image(scene.structure, p, H, W, cfg)
    )
    g_j = grads(
        lambda p: render_image_banded(
            scene.structure, p, H, W, cfg, band_rows=8
        )
    )
    for f in (
        "sphere_point", "sphere_radius", "plane_y", "light_point",
        "mat_diffuse", "mat_ambient", "ambient_color", "cam_point",
        "cam_direction", "cam_fov",
    ):
        a = np.asarray(getattr(g_f, f))
        b = np.asarray(getattr(g_j, f))
        assert np.isfinite(a).all(), f
        scale = max(np.abs(b).max(), 1e-7)
        np.testing.assert_allclose(
            a, b, atol=2e-2 * scale, rtol=0, err_msg=f
        )
    assert np.abs(np.asarray(g_f.sphere_point)).max() > 0
