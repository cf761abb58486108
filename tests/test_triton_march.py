"""The Triton value passes (render/triton_march.py) and the scene evaluator
they compile (render/scalar_scene.py), run in the Pallas interpreter.

Per pixel the kernels must reproduce the jnp loops (render/march.py `march`
and the frozen shadow scan of render/shading.py) whatever block size the
wrapper uses, at image sizes that do not divide the block's pixel patch,
and at the edges of the loop configuration. The compiled kernels are
checked on a GPU by the `gpu` test below and by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from loltracer_tpu.config import RenderConfig
from loltracer_tpu.lol import parse_scene_file
from loltracer_tpu.render.camera import camera_rays
from loltracer_tpu.render.march import march
from loltracer_tpu.render.scalar_scene import (
    GEOM_FIELDS,
    ScalarScene,
    march_loop,
    pack_geometry,
    unpack_geometry,
)
from loltracer_tpu.render.sdf import make_scene_sdf
from loltracer_tpu.render.triton_march import (
    BLOCK_PATCHES,
    DEFAULT_BLOCK,
    from_blocks,
    make_triton_march,
    make_triton_shadow_march,
    to_blocks,
)
from loltracer_tpu.render.vecmath import dot, normalize
from loltracer_tpu.scene import build_scene

H, W = 16, 48
ALL = ["scene.lol", "scene2.lol", "scene3.lol", "scene4.lol"]


@pytest.fixture(scope="module")
def scenes(examples_dir):
    return {
        name: build_scene(parse_scene_file(str(examples_dir / name)))
        for name in ALL
    }


def _march_ref(scene, cfg, h=H, w=W):
    ro, rd = camera_rays(scene.params, h, w, cfg)
    ref = jax.jit(
        lambda p, o, d: march(make_scene_sdf(scene.structure), p, o, d, cfg)
    )(scene.params, ro, rd)
    return ro, rd, ref


def _shadow_inputs(scene, cfg, h=H, w=W):
    """Shadow rays toward the first light from the primary hits, as
    shading.shade builds them."""
    ro, rd, ref = _march_ref(scene, cfg, h, w)
    p = ro + ref.t[..., None] * rd
    to_light = scene.params.light_point[0] - p
    ldir = normalize(to_light)
    return (p + ldir * cfg.shadow_offset, ldir,
            jnp.sqrt(dot(to_light, to_light)))


def _shadow_ref(scene, cfg, so, ld, max_dist):
    """(res, t*) of the jnp scan, unclamped."""
    sdf = make_scene_sdf(scene.structure)

    def body(carry, _):
        r, t, ts, done = carry
        d = sdf(scene.params, so + t[..., None] * ld)
        safe_t = jnp.where(t > 0, t, 1.0)
        val = jnp.where(
            t > 0, cfg.shadow_w * d / safe_t,
            jnp.where(d < 0, -jnp.inf, jnp.inf),
        )
        better = ~done & (val < r)
        nr = jnp.where(done, r, jnp.minimum(r, val))
        ts = jnp.where(better, t, ts)
        nt = jnp.where(done, t, t + d)
        return (nr, nt, ts, done | (nr < -1) | (nt > max_dist)), None

    z = jnp.zeros(max_dist.shape, jnp.float32)
    (res, _, ts, _), _ = jax.jit(
        lambda: lax.scan(body, (z + 1.0, z, z, z > 0), None,
                         length=cfg.shadow_steps)
    )()
    return np.asarray(res), np.asarray(ts)


def _assert_march_close(got, ref):
    for a, b in ((got.t, ref.t), (got.t_query, ref.t_query),
                 (got.t_close, ref.t_close)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)
    fin = np.isfinite(np.asarray(ref.s_min))
    np.testing.assert_array_equal(fin, np.isfinite(np.asarray(got.s_min)))
    np.testing.assert_allclose(
        np.asarray(got.s_min)[fin], np.asarray(ref.s_min)[fin],
        atol=1e-4, rtol=1e-4,
    )


def _assert_shadow_close(got, ref):
    (res, ts), (res_ref, ts_ref) = [tuple(map(np.asarray, x))
                                    for x in (got, ref)]
    fin = np.isfinite(res_ref)
    np.testing.assert_array_equal(fin, np.isfinite(res))
    np.testing.assert_allclose(res[fin], res_ref[fin], atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(ts, ts_ref, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("block", sorted(BLOCK_PATCHES))
def test_march_block_sizes(scenes, block):
    """Every block size gives the jnp values, and exactly the default
    block's values: per-ray results cannot depend on the grouping."""
    scene = scenes["scene4.lol"]
    cfg = RenderConfig()
    ro, rd, ref = _march_ref(scene, cfg)
    got = jax.jit(make_triton_march(scene.structure, cfg, interpret=True,
                                    block=block))(scene.params, ro, rd)
    base = jax.jit(make_triton_march(scene.structure, cfg, interpret=True,
                                     block=DEFAULT_BLOCK))(scene.params, ro, rd)
    _assert_march_close(got, ref)
    for a, b in zip(got, base):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("block", sorted(BLOCK_PATCHES))
def test_shadow_block_sizes(scenes, block):
    scene = scenes["scene3.lol"]
    cfg = RenderConfig()
    so, ld, md = _shadow_inputs(scene, cfg)
    got = jax.jit(make_triton_shadow_march(
        scene.structure, cfg, interpret=True, block=block
    ))(scene.params, so, ld, md)
    base = jax.jit(make_triton_shadow_march(
        scene.structure, cfg, interpret=True, block=DEFAULT_BLOCK
    ))(scene.params, so, ld, md)
    _assert_shadow_close(got, _shadow_ref(scene, cfg, so, ld, md))
    for a, b in zip(got, base):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


ODD_SHAPES = [(1, 1), (7, 33), (13, 150)]


@pytest.mark.parametrize("shape", ODD_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_march_padding(scenes, shape):
    """Sizes that do not divide the pixel patch pad with edge rays and
    crop back."""
    h, w = shape
    scene = scenes["scene.lol"]
    cfg = RenderConfig()
    ro, rd, ref = _march_ref(scene, cfg, h, w)
    got = jax.jit(make_triton_march(scene.structure, cfg, interpret=True))(
        scene.params, ro, rd
    )
    assert got.t.shape == (h, w)
    _assert_march_close(got, ref)


@pytest.mark.parametrize("shape", ODD_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_shadow_padding(scenes, shape):
    h, w = shape
    scene = scenes["scene2.lol"]
    cfg = RenderConfig()
    so, ld, md = _shadow_inputs(scene, cfg, h, w)
    got = jax.jit(make_triton_shadow_march(
        scene.structure, cfg, interpret=True
    ))(scene.params, so, ld, md)
    assert got[0].shape == (h, w) and got[1].shape == (h, w)
    _assert_shadow_close(got, _shadow_ref(scene, cfg, so, ld, md))


@pytest.mark.parametrize(
    "cfg",
    [RenderConfig(max_steps=5), RenderConfig(epsilon=0.5),
     RenderConfig(max_dist=3.0)],
    ids=["max_steps_cap", "large_epsilon", "small_max_dist"],
)
def test_march_config_edges(scenes, cfg):
    """The step cap, a coarse epsilon and a short max_dist stop rays at
    the same step as the jnp loop."""
    scene = scenes["scene4.lol"]
    ro, rd, ref = _march_ref(scene, cfg)
    got = jax.jit(make_triton_march(scene.structure, cfg, interpret=True))(
        scene.params, ro, rd
    )
    _assert_march_close(got, ref)


@pytest.mark.parametrize(
    "cfg",
    [RenderConfig(shadow_steps=3), RenderConfig(shadow_w=5.0),
     RenderConfig(shadow_offset=0.25)],
    ids=["shadow_steps_cap", "soft_w", "short_offset"],
)
def test_shadow_config_edges(scenes, cfg):
    scene = scenes["scene4.lol"]
    so, ld, md = _shadow_inputs(scene, cfg)
    got = jax.jit(make_triton_shadow_march(
        scene.structure, cfg, interpret=True
    ))(scene.params, so, ld, md)
    _assert_shadow_close(got, _shadow_ref(scene, cfg, so, ld, md))


@pytest.mark.parametrize("shape", [(8, 16), (13, 150), (1, 1)],
                         ids=["exact", "odd", "single"])
def test_to_blocks_round_trip(shape):
    h, w = shape
    x = jnp.arange(h * w, dtype=jnp.float32).reshape(h, w)
    ph, pw = BLOCK_PATCHES[DEFAULT_BLOCK]
    flat = to_blocks(x, ph, pw)
    assert flat.shape[0] % (ph * pw) == 0
    np.testing.assert_array_equal(from_blocks(flat, h, w, ph, pw), x)


def test_to_blocks_patch_order():
    """Each run of ph*pw rays is one spatial (ph, pw) pixel patch, so a
    block's rays are neighbours on screen."""
    ph, pw = BLOCK_PATCHES[DEFAULT_BLOCK]
    h, w = 2 * ph, 3 * pw
    rows, cols = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
    r = np.asarray(to_blocks(rows.astype(jnp.float32), ph, pw))
    c = np.asarray(to_blocks(cols.astype(jnp.float32), ph, pw))
    n = ph * pw
    for b in range(r.size // n):
        rb, cb = r[b * n:(b + 1) * n], c[b * n:(b + 1) * n]
        assert rb.max() - rb.min() == ph - 1
        assert cb.max() - cb.min() == pw - 1


def test_kernels_reject_instanced():
    from loltracer_tpu.scenes import instanced_spheres

    st = instanced_spheres(n=8).structure
    with pytest.raises(ValueError, match="instanced"):
        make_triton_march(st, interpret=True)
    with pytest.raises(ValueError, match="instanced"):
        make_triton_shadow_march(st, interpret=True)


def test_kernels_reject_unknown_block(scenes):
    with pytest.raises(ValueError, match="block"):
        make_triton_march(scenes["scene.lol"].structure, interpret=True,
                          block=96)


@pytest.mark.parametrize("name", ALL)
def test_scalar_scene_matches_sdf(scenes, name):
    """The unrolled evaluator the kernels compile equals the batched jnp
    SDF at random points."""
    scene = scenes[name]
    st = scene.structure
    pts = np.random.RandomState(0).uniform(-8, 8, (257, 3)).astype(
        np.float32
    )
    packed = pack_geometry(st, scene.params)
    scn = ScalarScene(st, unpack_geometry(st, lambda i: packed[i]))
    got = scn.dist(pts[:, 0], pts[:, 1], pts[:, 2])
    ref = make_scene_sdf(st)(scene.params, jnp.asarray(pts))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_pack_unpack_round_trip(scenes):
    st = scenes["scene4.lol"].structure
    params = scenes["scene4.lol"].params
    packed = np.asarray(pack_geometry(st, params))
    values = unpack_geometry(st, lambda i: packed[i])
    for f in GEOM_FIELDS:
        want = np.asarray(getattr(params, f), np.float32)
        got = np.asarray(values[f], np.float32).reshape(want.shape)
        np.testing.assert_array_equal(got, want)


def test_march_loop_as_plain_xla(scenes):
    """march_loop outside any kernel, over the whole image as one block,
    is the jnp march."""
    scene = scenes["scene2.lol"]
    cfg = RenderConfig()
    ro, rd, ref = _march_ref(scene, cfg)
    st = scene.structure

    @jax.jit
    def run(params, ro, rd):
        packed = pack_geometry(st, params)
        scn = ScalarScene(st, unpack_geometry(st, lambda i: packed[i]))
        return march_loop(scn, cfg, (ro[0], ro[1], ro[2]),
                          (rd[..., 0], rd[..., 1], rd[..., 2]))

    t, t_query, s_min, t_close = run(scene.params, ro, rd)
    got = ref._replace(t=t, t_query=t_query, s_min=s_min, t_close=t_close)
    _assert_march_close(got, ref)


@pytest.mark.gpu
def test_compiled_kernels_match_jnp(scenes, gpu):
    """The kernels as compiled for the card (no interpreter)."""
    scene = scenes["scene4.lol"]
    cfg = RenderConfig()
    with jax.default_device(gpu):
        ro, rd, ref = _march_ref(scene, cfg, 64, 96)
        got = jax.jit(make_triton_march(scene.structure, cfg))(
            scene.params, ro, rd
        )
        _assert_march_close(got, ref)
