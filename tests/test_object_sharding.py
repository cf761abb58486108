"""Object-axis device sharding (parallel/objects.py): the instanced sphere
SoA sharded over a mesh axis with pmin-combined SDF evaluation must render
the same image as a single device — incl. composed with row sharding on a
2-D (rows, objects) mesh and under the step clamp (SURVEY §2.2 TP row,
§5.7)."""

import numpy as np
import pytest
from jax.sharding import Mesh

import jax

from loltracer_tpu.config import RenderConfig
from loltracer_tpu.parallel.objects import (
    OBJ_AXIS,
    make_object_sharded_renderer,
)
from loltracer_tpu.render.jnp_renderer import make_renderer
from loltracer_tpu.scenes import instanced_spheres

H, W = 24, 32
N = 150  # deliberately not divisible by 4: exercises shard padding


@pytest.fixture(scope="module")
def scene():
    return instanced_spheres(n=N, seed=3)


def _obj_mesh(n):
    return Mesh(np.asarray(jax.devices("cpu")[:n]), (OBJ_AXIS,))


@pytest.mark.parametrize("n_obj", [2, 4])
@pytest.mark.parametrize("clamp", [None, 2.0])
def test_object_sharded_matches_single(scene, n_obj, clamp):
    cfg = RenderConfig(march_backend="jnp", step_clamp=clamp)
    ref = np.asarray(
        make_renderer(scene.structure, H, W, cfg)(scene.params)
    )
    img = np.asarray(
        make_object_sharded_renderer(
            scene.structure, _obj_mesh(n_obj), H, W, cfg
        )(scene.params)
    )
    np.testing.assert_allclose(img, ref, atol=2e-5)


def test_object_plus_row_sharding(scene):
    """2-D mesh: rows over one axis, objects over the other."""
    devs = np.asarray(jax.devices("cpu")[:8]).reshape(2, 4)
    mesh = Mesh(devs, ("rows", OBJ_AXIS))
    cfg = RenderConfig(march_backend="jnp")
    ref = np.asarray(
        make_renderer(scene.structure, H, W, cfg)(scene.params)
    )
    img = np.asarray(
        make_object_sharded_renderer(
            scene.structure, mesh, H, W, cfg, row_axis="rows"
        )(scene.params)
    )
    np.testing.assert_allclose(img, ref, atol=2e-5)


@pytest.mark.parametrize("backend", ["jnp"])
def test_object_sharded_respects_shadow_step_clamp(scene, backend):
    """With a distinct shadow_step_clamp, the object-sharded
    renderer must build a SECOND pmin SDF at the shadow clamp (the
    unsharded oracle does) instead of silently reusing the primary-clamp
    override for shadows."""
    cfg = RenderConfig(
        march_backend=backend, step_clamp=1.0, shadow_step_clamp=8.0
    )
    ref = np.asarray(
        make_renderer(
            scene.structure, H, W,
            RenderConfig(
                march_backend="jnp", step_clamp=1.0, shadow_step_clamp=8.0
            ),
        )(scene.params)
    )
    img = np.asarray(
        make_object_sharded_renderer(
            scene.structure, _obj_mesh(4), H, W, cfg
        )(scene.params)
    )
    np.testing.assert_allclose(img, ref, atol=2e-5)
    # the clamps genuinely diverge on this scene: sharing the primary
    # clamp for shadows would NOT reproduce the oracle
    shared = np.asarray(
        make_renderer(
            scene.structure, H, W,
            RenderConfig(
                march_backend="jnp", step_clamp=1.0, shadow_step_clamp=1.0
            ),
        )(scene.params)
    )
    assert np.abs(shared - ref).max() > 1e-4


def test_render_rays_rejects_override_without_shadow_sdf(scene):
    """render_rays must refuse an sdf override whose shadow clamp differs
    when no shadow_sdf is supplied (the silent-divergence case)."""
    import jax.numpy as jnp

    from loltracer_tpu.render.camera import camera_rays
    from loltracer_tpu.render.jnp_renderer import render_rays
    from loltracer_tpu.render.sdf import make_scene_sdf

    cfg = RenderConfig(
        march_backend="jnp", step_clamp=1.0, shadow_step_clamp=8.0
    )
    ro, rd = camera_rays(scene.params, H, W, cfg)
    sdf = make_scene_sdf(scene.structure, 1.0)
    with pytest.raises(ValueError, match="shadow_sdf"):
        render_rays(
            scene.structure, scene.params, ro, rd, cfg, sdf=sdf
        )


def test_sharded_id_unclamped_argmin_where_cut_wins(scene):
    """When the step-clamp cut wins on EVERY shard, all shards
    tie at d == cut; the id must still be the global unclamped sphere
    argmin (first-wins), not a min over each shard's local argmin."""
    import dataclasses

    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from loltracer_tpu.parallel.objects import (
        _sharded_sdfs,
        pad_spheres_for_sharding,
    )
    from loltracer_tpu.render.sdf import make_scene_sdf_with_id

    n_obj = 4
    mesh = _obj_mesh(n_obj)
    cfg = RenderConfig(march_backend="jnp", step_clamp=0.25)
    st = scene.structure
    ns = st.num_spheres
    ns_pad = ns + ((-ns) % n_obj)
    st_local = dataclasses.replace(st, num_spheres=ns_pad // n_obj,
                                   material_ids=())
    params = pad_spheres_for_sharding(scene.params, n_obj)

    # probe points far from every sphere (several units above the slab):
    # the cut wins everywhere, so the clamped value ties across shards
    pts = np.stack(
        [np.linspace(-30, 30, 16),
         np.full(16, 30.0),
         np.linspace(-60, -10, 16)], axis=-1
    ).astype(np.float32)

    def shard_fn(pp, p):
        _, sdf_id = _sharded_sdfs(st_local, cfg, None, OBJ_AXIS)
        return sdf_id(pp, p)

    sharded = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(dataclasses.replace(
            jax.tree_util.tree_map(lambda _: P(), params),
            sphere_point=P(OBJ_AXIS), sphere_radius=P(OBJ_AXIS)),
            P()),
        out_specs=(P(), P()), check_vma=False,
    )
    d_sh, id_sh = jax.jit(sharded)(params, jnp.asarray(pts))

    # oracle: the UNCLAMPED global argmin (sdf.py docstring rule); restrict
    # to sphere-winning probes (far above the floor, spheres always win)
    d_ref, id_ref = make_scene_sdf_with_id(st, None)(scene.params, pts)
    keep = np.asarray(id_ref) <= ns  # sphere-winning probes only
    assert keep.any()
    np.testing.assert_array_equal(
        np.asarray(id_sh)[keep], np.asarray(id_ref)[keep]
    )
    # and the distances are still the clamped combine: never above the
    # unclamped min, and the cut (= d_bbox ~ 19.4 here) strictly wins at
    # some probes — the regime the id rule above is being tested in
    assert (np.asarray(d_sh) <= np.asarray(d_ref) + 1e-5).all()
    assert (np.asarray(d_sh) < np.asarray(d_ref) - 1e-2).any()
