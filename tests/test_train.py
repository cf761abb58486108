"""Kernel route versus jnp route for training (render/triton_march.py).

With march_backend="triton-interpret" both march value passes (primary and
envelope shadow) run as the Triton kernels in the Pallas interpreter; the
rest of render_rays, and every gradient, is the same jnp code on both
routes (IFT + Danskin-envelope + coverage re-attachment). So the forward
must match the jnp route pixel for pixel and the gradients to float
tolerance, away from the penumbra near-ties of tests/_penumbra.py. The
same kernels compile for the GPU (chip_smoke.py runs them there)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from loltracer_tpu.config import RenderConfig
from loltracer_tpu.lol import parse_scene_file
from loltracer_tpu.render.jnp_renderer import render_image
from loltracer_tpu.scene import build_scene

H, W = 16, 144  # 144 = 9 x 16-wide patches; odd patch counts per row

CFG = RenderConfig(shadow_grad="envelope", march_backend="jnp")
CFG_AA = dataclasses.replace(CFG, antialias=True)


@pytest.fixture(
    scope="module",
    params=["scene.lol", "scene2.lol", "scene3.lol", "scene4.lol"],
)
def scene(request, examples_dir):
    return build_scene(parse_scene_file(str(examples_dir / request.param)))


def _jnp_image(scene, cfg):
    @jax.jit
    def f(p):
        return render_image(scene.structure, p, H, W, cfg)

    return f


def make_kernel_renderer(structure, h, w, cfg):
    """The render path with both march value passes on the kernel route."""
    kcfg = cfg.replace(march_backend="triton-interpret")
    return lambda p: render_image(structure, p, h, w, kcfg)


def test_forward_matches_jnp(scene):
    kern = jax.jit(make_kernel_renderer(scene.structure, H, W, CFG))
    a = np.asarray(kern(scene.params))
    b = np.asarray(_jnp_image(scene, CFG)(scene.params))
    np.testing.assert_allclose(a, b, atol=5e-5, rtol=0)


def test_forward_matches_jnp_aa(scene):
    kern = jax.jit(make_kernel_renderer(scene.structure, H, W, CFG_AA))
    a = np.asarray(kern(scene.params))
    b = np.asarray(_jnp_image(scene, CFG_AA)(scene.params))
    np.testing.assert_allclose(a, b, atol=5e-5, rtol=0)


def _grads(render_fn, params, target):
    def loss(p):
        img = render_fn(p)
        return jnp.mean((img - target) ** 2)

    return jax.jit(jax.grad(loss))(params)


# Fields whose gradients do not flow through any frozen-argmin residual
# (march t, penumbra t*): these must match the jnp path tightly everywhere.
SMOOTH_FIELDS = (
    "mat_diffuse", "mat_specular", "mat_ambient", "mat_shininess",
    "ambient_color", "light_diffuse", "light_specular",
)
GEOM_FIELDS_T = (
    "sphere_point", "sphere_radius", "plane_y", "smooth_k",
    "light_point", "cam_point", "cam_direction", "cam_fov",
)


def _penumbra_mask(scene, cfg):
    """True where the kernel-vs-jnp comparison must be tight: everywhere
    except the penumbra-argmin-dependent pixels. The band definition (and
    why those pixels legitimately diverge) lives in tests/_penumbra.py —
    ONE definition shared with test_instanced_fused."""
    from _penumbra import penumbra_pixels, shadow_res_planes

    res = shadow_res_planes(scene, cfg, H, W, kernel=True)
    return ~penumbra_pixels(res)


@pytest.mark.parametrize("cfg", [CFG, CFG_AA], ids=["parity", "aa"])
def test_gradients_match_jnp(scene, cfg):
    kern = make_kernel_renderer(scene.structure, H, W, cfg)
    # a target distinct from the render so cotangents are nonzero; penumbra
    # pixels masked out of the loss (see _penumbra_mask)
    keep = _penumbra_mask(scene, cfg)[..., None].astype(np.float32)
    target = 0.5 * np.ones((H, W, 3), np.float32)

    def masked_grads(render_fn):
        def loss(p):
            img = render_fn(p)
            return jnp.mean(jnp.asarray(keep) * (img - target) ** 2)

        return jax.jit(jax.grad(loss))(scene.params)

    g_kern = masked_grads(kern)
    g_jnp = masked_grads(
        lambda p: render_image(scene.structure, p, H, W, cfg)
    )

    for f in SMOOTH_FIELDS + GEOM_FIELDS_T:
        a = np.asarray(getattr(g_kern, f))
        b = np.asarray(getattr(g_jnp, f))
        if a.size == 0:
            continue
        assert np.isfinite(a).all(), f
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a, b, atol=2e-2 * scale, rtol=0, err_msg=f)
        if np.abs(b).max() > 1e-6:
            assert np.abs(a).max() > 0, f


@pytest.mark.parametrize("cfg", [CFG, CFG_AA], ids=["parity", "aa"])
def test_gradient_full_image_bound(scene, cfg):
    """Quantified FULL-IMAGE gradient bound, magnitude included, cam_fov
    included, no field exclusions. The loss is
    additive over pixels, so per field and path

        g_full = g_band + g_nonband          (exactly, by linearity)

    with `band` the shared penumbra mask (tests/_penumbra.py). The test
    asserts the two halves of the derivable full-image bound:

    1. NON-BAND divergence is tight (<= 5% of the gradient scale): every
       kernel-vs-jnp divergence source lives inside the penumbra band.
       This covers cam_fov under AA — its full-image total is a
       near-cancelling sum whose unmasked rel-L2 is unbounded in
       principle (|total| can be ~1e-4 of the per-pixel terms), but its
       non-band part must (and does) match tightly.
    2. Therefore ||g_full_f - g_full_j|| <= ||g_band_f - g_band_j|| +
       0.05 * scale — the full-image relative-L2 bound, with the band
       term itself capped at rel <= 1.0 of ||g_band_j|| by
       test_penumbra_estimator_variance_bounded. Where the band gradient
       is small relative to the full gradient this collapses to a tight
       full-image rel-L2; where it is not, the band term is the bound.
    """
    kern = make_kernel_renderer(scene.structure, H, W, cfg)
    target = 0.5 * np.ones((H, W, 3), np.float32)
    pen = ~_penumbra_mask(scene, cfg)  # True ON the band
    band = jnp.asarray(pen[..., None].astype(np.float32))

    def grads(render_fn, mask):
        def loss(p):
            img = render_fn(p)
            return jnp.mean(mask * (img - target) ** 2)

        return jax.jit(jax.grad(loss))(scene.params)

    jnp_fn = lambda p: render_image(scene.structure, p, H, W, cfg)
    g_full_f = grads(kern, 1.0)
    g_full_j = grads(jnp_fn, 1.0)
    g_band_f = grads(kern, band)
    g_band_j = grads(jnp_fn, band)

    for f in GEOM_FIELDS_T:
        af, aj = [np.asarray(getattr(g, f)).ravel()
                  for g in (g_full_f, g_full_j)]
        bf, bj = [np.asarray(getattr(g, f)).ravel()
                  for g in (g_band_f, g_band_j)]
        if af.size == 0:
            continue
        scale = max(np.linalg.norm(aj), np.linalg.norm(bj), 1e-6)
        # 1. non-band divergence tight: (g_full - g_band) matches across
        # paths — by linearity this IS the non-band gradient
        nonband_div = np.linalg.norm((af - bf) - (aj - bj))
        assert nonband_div <= 0.05 * scale, (f, nonband_div / scale)
        # 2. the derived full-image bound
        full_div = np.linalg.norm(af - aj)
        band_div = np.linalg.norm(bf - bj)
        assert full_div <= band_div + 0.05 * scale, (
            f, full_div, band_div, scale
        )


def test_fused_loss_decreases_under_adam(examples_dir):
    """End-to-end: one can actually train through the kernel route. Image-plane
    sphere positions are perturbed and are the only trainable field (the
    observable configuration the slow inverse tests establish for the jnp
    path, tests/test_inverse.py)."""
    import optax

    from loltracer_tpu.opt import masked_optimizer

    scene = build_scene(parse_scene_file(str(examples_dir / "scene3.lol")))
    kern = make_kernel_renderer(scene.structure, 24, 128, CFG_AA)
    target = np.asarray(jax.jit(kern)(scene.params))

    delta = np.zeros_like(scene.params.sphere_point)
    delta[:, 0] = 0.15
    delta[:, 1] = -0.1
    params = dataclasses.replace(
        scene.params, sphere_point=scene.params.sphere_point + delta
    )
    opt = masked_optimizer(optax.adam(3e-2), params, ("sphere_point",))
    state = opt.init(params)

    @jax.jit
    def step(params, state):
        def loss(p):
            return jnp.mean((kern(p) - target) ** 2)

        l, g = jax.value_and_grad(loss)(params)
        updates, state2 = opt.update(g, state, params)
        return optax.apply_updates(params, updates), state2, l

    params2, state, l0 = step(params, state)
    losses = []
    for _ in range(12):
        params2, state, l = step(params2, state)
        losses.append(float(l))
    assert min(losses) < 0.5 * float(l0), (float(l0), losses)


@pytest.mark.parametrize("name", ["scene3.lol", "scene4.lol"])
def test_penumbra_estimator_variance_bounded(examples_dir, name):
    """Quantified bound on the penumbra-pixel divergence that
    test_gradients_match_jnp masks out: restrict the loss to the penumbra
    BAND itself and compare kernel-vs-jnp envelope gradients. Both compute the same Danskin estimator; they differ only
    in WHICH near-tied shadow step the frozen march picks as argmin, an
    O(1)-per-pixel variance that largely cancels over the band. Asserted
    at cos >= 0.9 / rel <= 1.0 — i.e. even on ONLY the near-tie pixels the estimators agree in
    direction and to ~1x in magnitude (full-image totals are dominated by
    non-penumbra pixels, which match to 2e-2, see
    test_gradients_match_jnp)."""
    from _penumbra import penumbra_pixels, shadow_res_planes

    scene = build_scene(parse_scene_file(str(examples_dir / name)))
    st = scene.structure
    cfg = CFG
    pen = penumbra_pixels(shadow_res_planes(scene, cfg, H, W, kernel=True))
    assert pen.sum() > 0
    keep = jnp.asarray(pen[..., None].astype(np.float32))

    kern = make_kernel_renderer(st, H, W, cfg)

    def grads(rf):
        def loss(p):
            img = rf(p)
            return jnp.sum(keep * (img - 0.5) ** 2) / int(pen.sum())

        return jax.jit(jax.grad(loss))(scene.params)

    g_f = grads(kern)
    g_j = grads(lambda p: render_image(st, p, H, W, cfg))
    for f in ("light_point", "sphere_point", "plane_y", "smooth_k"):
        a = np.asarray(getattr(g_f, f)).ravel()
        b = np.asarray(getattr(g_j, f)).ravel()
        if a.size == 0 or np.linalg.norm(b) < 1e-7:
            continue
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        cos = float(a @ b) / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30)
        assert cos > 0.9, (f, cos)
        assert rel < 1.0, (f, rel)
