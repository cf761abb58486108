"""Multi-device tests on the 8 faked CPU devices: sharded rendering matches
single-device rendering bitwise, the sharded loss gradient matches the
unsharded gradient, and determinism holds across mesh shapes (the analog of
the reference's race-freedom-by-disjoint-rows, SURVEY.md §5.2)."""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp

from loltracer_tpu.lol import parse_scene_file
from loltracer_tpu.parallel import (
    make_mesh,
    make_sharded_renderer,
    make_sharded_train_step,
)
from loltracer_tpu.parallel.sharded import make_sharded_loss
from loltracer_tpu.render.jnp_renderer import make_renderer
from loltracer_tpu.scene import build_scene

H, W = 16, 32


@pytest.fixture(scope="module")
def scene(examples_dir):
    return build_scene(parse_scene_file(str(examples_dir / "scene3.lol")))


@pytest.fixture(scope="module")
def cpu8():
    devs = jax.devices("cpu")
    if len(devs) < 8:
        pytest.skip("needs 8 faked CPU devices")
    return devs


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_render_matches_single(scene, cpu8, n):
    mesh = make_mesh(cpu8, n_devices=n)
    sharded = make_sharded_renderer(scene.structure, mesh, H, W)
    single = make_renderer(scene.structure, H, W)
    np.testing.assert_array_equal(
        np.asarray(sharded(scene.params)), np.asarray(single(scene.params))
    )


def test_height_must_divide(scene, cpu8):
    mesh = make_mesh(cpu8, n_devices=8)
    with pytest.raises(ValueError, match="divide"):
        make_sharded_renderer(scene.structure, mesh, 12, W)


def test_sharded_grad_matches_unsharded(scene, cpu8):
    mesh = make_mesh(cpu8, n_devices=4)
    target = jnp.zeros((H, W, 3), jnp.float32)

    loss_sharded = make_sharded_loss(scene.structure, mesh, H, W)
    g_sharded = jax.jit(jax.grad(loss_sharded))(scene.params, target)

    single = make_renderer(scene.structure, H, W)

    def loss_single(params):
        return jnp.mean((single.__wrapped__(params) - target) ** 2)

    g_single = jax.grad(loss_single)(scene.params)

    for name in ["sphere_point", "smooth_k", "mat_diffuse", "light_point"]:
        np.testing.assert_allclose(
            np.asarray(getattr(g_sharded, name)),
            np.asarray(getattr(g_single, name)),
            rtol=2e-3,
            atol=1e-6,
        )


def test_sharded_train_step_decreases_loss(scene, cpu8):
    from loltracer_tpu.config import RenderConfig

    cfg_aa = RenderConfig(antialias=True)  # silhouette gradients
    mesh = make_mesh(cpu8, n_devices=4)
    single = make_renderer(scene.structure, H, W, cfg_aa)
    target = single(scene.params)

    # perturb sphere geometry, then Adam-step that field back to the target
    import dataclasses

    from loltracer_tpu.opt import masked_optimizer

    sp = np.array(scene.params.sphere_point)
    sp[0, 0] += 0.2  # image-plane perturbation of the first sphere
    perturbed = dataclasses.replace(
        scene.params, sphere_point=np.asarray(sp, np.float32)
    )
    optimizer = masked_optimizer(
        optax.adam(2e-2), scene.params, ("sphere_point",)
    )
    step = make_sharded_train_step(
        scene.structure, mesh, H, W, optimizer, cfg_aa
    )
    opt_state = optimizer.init(perturbed)
    params = perturbed
    losses = []
    for _ in range(25):
        params, opt_state, loss = step(params, opt_state, target)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_fused_tier_matches_jnp(examples_dir, n_dev):
    """The march value passes on the kernel route (the Triton kernels
    inside shard_map, in the interpreter here) render the same image as
    the sharded jnp route, and the sharded train step on that route
    produces finite replicated updates — at two mesh sizes."""
    import dataclasses

    import optax

    from loltracer_tpu.config import RenderConfig
    from loltracer_tpu.lol import parse_scene_file
    from loltracer_tpu.opt import masked_optimizer
    from loltracer_tpu.parallel import make_mesh, make_sharded_train_step
    from loltracer_tpu.parallel.sharded import make_sharded_renderer
    from loltracer_tpu.scene import build_scene

    scene = build_scene(parse_scene_file(str(examples_dir / "scene3.lol")))
    mesh = make_mesh(n_devices=n_dev)
    H, W = 32, 144  # 144 = 9 x 16-wide kernel patches per row
    cfg = RenderConfig(
        antialias=True, shadow_grad="envelope", march_backend="jnp"
    )
    kcfg = cfg.replace(march_backend="triton-interpret")

    r_fused = make_sharded_renderer(scene.structure, mesh, H, W, kcfg)
    r_jnp = make_sharded_renderer(scene.structure, mesh, H, W, cfg)
    a = np.asarray(r_fused(scene.params))
    b = np.asarray(r_jnp(scene.params))
    np.testing.assert_allclose(a, b, atol=5e-5, rtol=0)

    optimizer = masked_optimizer(
        optax.adam(1e-2), scene.params, ("sphere_point",)
    )
    step = make_sharded_train_step(
        scene.structure, mesh, H, W, optimizer, kcfg
    )
    state = optimizer.init(scene.params)
    params = dataclasses.replace(
        scene.params,
        sphere_point=scene.params.sphere_point + np.float32(0.1),
    )
    params2, state, loss = step(params, state, jnp.asarray(a))
    assert np.isfinite(float(loss))
    leaves = jax.tree_util.tree_leaves(params2)
    assert all(np.isfinite(np.asarray(l)).all() for l in leaves)
    # the update must actually move the perturbed field
    assert np.abs(
        np.asarray(params2.sphere_point) - np.asarray(params.sphere_point)
    ).max() > 1e-5


def _banded_single(structure, h, w, cfg):
    """The single-device instanced render the sharded path must match:
    banded in the sharded path's own band height."""
    from loltracer_tpu.parallel.sharded import INSTANCED_BAND_ROWS
    from loltracer_tpu.render.jnp_renderer import render_image_banded

    return jax.jit(
        lambda p: render_image_banded(
            structure, p, h, w, cfg, band_rows=INSTANCED_BAND_ROWS
        )
    )


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_instanced_fused_matches_single(n_dev):
    """Instanced scenes multi-device: each device renders its dealt row
    blocks in bands under shard_map; the image must match the
    single-device banded render, and the sharded gradients the unsharded
    ones to tolerance."""
    from loltracer_tpu.config import RenderConfig
    from loltracer_tpu.scenes import instanced_spheres

    scene = instanced_spheres(n=200, seed=5)
    Hs, Ws = 32 * n_dev, 64
    cfg = RenderConfig(shadow_grad="envelope", step_clamp=2.0)
    mesh = make_mesh(n_devices=n_dev)

    sharded = make_sharded_renderer(scene.structure, mesh, Hs, Ws, cfg)
    single = _banded_single(scene.structure, Hs, Ws, cfg)
    a = np.asarray(sharded(scene.params))
    b = np.asarray(single(scene.params))
    np.testing.assert_allclose(a, b, atol=2e-6)

    # gradients: sharded loss (psum over shards) vs unsharded loss
    target = jnp.asarray(0.5 * np.ones((Hs, Ws, 3), np.float32))
    loss_sh = make_sharded_loss(scene.structure, mesh, Hs, Ws, cfg)
    g_sh = jax.jit(jax.grad(loss_sh))(scene.params, target)

    def loss_single(p):
        return jnp.mean((single(p) - target) ** 2)

    g_si = jax.jit(jax.grad(loss_single))(scene.params)
    for name in ["sphere_point", "sphere_radius", "plane_y", "light_point",
                 "mat_diffuse", "cam_point", "cam_fov"]:
        ga, gb = np.asarray(getattr(g_sh, name)), np.asarray(
            getattr(g_si, name)
        )
        assert np.isfinite(ga).all(), name
        scale = max(np.abs(gb).max(), 1e-7)
        np.testing.assert_allclose(
            ga, gb, atol=1e-4 * scale, rtol=1e-4, err_msg=name
        )
    assert np.abs(np.asarray(g_sh.sphere_point)).max() > 0


def test_sharded_instanced_fused_2d_mesh():
    """Instanced scenes also row-shard over a 2-D (hosts, chips) mesh (rows
    split across BOTH axes, hosts major) — the multi-host layout."""
    from jax.sharding import Mesh

    from loltracer_tpu.config import RenderConfig
    from loltracer_tpu.scenes import instanced_spheres

    scene = instanced_spheres(n=150, seed=8)
    Hs, Ws = 64, 32  # 4 shards x 16 rows
    cfg = RenderConfig(shadow_grad="envelope", step_clamp=2.0)
    devs = np.asarray(jax.devices("cpu")[:4]).reshape(2, 2)
    mesh = Mesh(devs, ("hosts", "chips"))
    sharded = make_sharded_renderer(scene.structure, mesh, Hs, Ws, cfg)
    single = _banded_single(scene.structure, Hs, Ws, cfg)
    np.testing.assert_allclose(
        np.asarray(sharded(scene.params)), np.asarray(single(scene.params)),
        atol=2e-6,
    )


def test_sharded_instanced_jnp_fallback_is_banded(monkeypatch):
    """The sharded render of instanced scenes runs in row bands: band
    boundaries must not change values, and
    the banded sharded render must match the single-device render."""
    from loltracer_tpu.config import RenderConfig
    from loltracer_tpu.render.jnp_renderer import make_renderer as _mk
    from loltracer_tpu.scenes import instanced_spheres

    scene = instanced_spheres(n=150, seed=4)
    Hs, Ws = 48, 32  # 24 rows/shard -> 2 bands of 12 per shard (band 16->12)
    cfg = RenderConfig(march_backend="jnp", step_clamp=2.0)
    mesh = make_mesh(n_devices=2)
    sharded = make_sharded_renderer(scene.structure, mesh, Hs, Ws, cfg)
    single = _mk(scene.structure, Hs, Ws, cfg)
    np.testing.assert_allclose(
        np.asarray(sharded(scene.params)),
        np.asarray(single(scene.params)),
        atol=2e-6,
    )


@pytest.mark.slow
def test_sharded_instanced_720p_per_shard_banded_no_oom():
    """A sharded instanced render at 720p PER SHARD must complete through
    the banded path. The unbanded formulation materializes [shard_pixels,
    block] temporaries (1280*720 x 512 x 4B ~ 1.9 GB per SDF-eval site,
    several live sites); the row-banded path (sharded._jnp_row_renderer)
    caps that at one 16-row band."""
    from loltracer_tpu.config import RenderConfig
    from loltracer_tpu.scenes import instanced_spheres

    scene = instanced_spheres(n=512, seed=11)
    Hs, Ws = 1440, 1280  # 2 shards x (1280 x 720)
    cfg = RenderConfig(march_backend="jnp", step_clamp=2.0)
    mesh = make_mesh(n_devices=2)
    sharded = make_sharded_renderer(scene.structure, mesh, Hs, Ws, cfg)
    img = np.asarray(sharded(scene.params))
    assert img.shape == (Hs, Ws, 3)
    assert np.isfinite(img).all()
    assert img.max() > 0.05  # actually rendered something


def test_mesh_no_silent_cpu_fallback(monkeypatch):
    """Asking for more devices than exist must FAIL unless the faked-CPU
    fallback is explicitly opted into: a launch that got fewer cards than
    it asked for must not silently 'succeed' on host CPUs."""
    import pytest as _pytest

    monkeypatch.delenv("LOLTRACE_CPU_FALLBACK", raising=False)
    with _pytest.raises(ValueError, match="LOLTRACE_CPU_FALLBACK"):
        make_mesh(n_devices=1000)
    monkeypatch.setenv("LOLTRACE_CPU_FALLBACK", "1")
    mesh = make_mesh(n_devices=8)
    assert mesh.devices.size == 8


@pytest.mark.parametrize(
    "height,n,want",
    [(512, 8, 8), (1080, 4, 6), (1080, 8, 5), (96, 3, 8)],
)
def test_row_granularity_deals_equal_blocks(scene, height, n, want):
    """Dealt blocks stay at the kernel patch height where the image allows
    and shrink until every shard gets the same number of whole blocks
    (1080 rows over 4 cards: 6-row blocks, so LPT still applies)."""
    from loltracer_tpu.parallel.sharded import interleave_rows, row_granularity

    g = row_granularity(scene.structure, height, n)
    assert g == want
    perm, inv = interleave_rows(height, n, g)
    assert sorted(perm) == list(range(height))
