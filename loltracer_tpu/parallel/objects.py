"""Object-axis sharding for instanced scenes (SURVEY §2.2 TP row, §5.7).

For 10k+ primitive scenes the scene SDF is an argmin-reduction over the
sphere SoA; this module shards that OBJECT axis across a mesh axis the way
tensor parallelism shards a contraction: every device evaluates the
distance min over its local sphere shard and the partial results combine
with a `lax.pmin` (ids via a min-over-winners trick) inside the march.
It pays only when a scene outgrows one device.

Composition: rows can shard over one mesh axis and objects over another
(a (rows, objects) 2-D mesh); forward pixel work is then row-parallel
while each row shard's SDF evaluations are object-parallel. Devices in an
object group run the march in lockstep — every carried quantity derives
from the pmin-combined distance, so the while_loop condition is identical
across the group and the collectives stay aligned.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from loltracer_tpu.config import DEFAULT_CONFIG, RenderConfig
from loltracer_tpu.render.camera import camera_rays_for_rows
from loltracer_tpu.render.jnp_renderer import pixel_radius, render_rays
from loltracer_tpu.render.sdf import make_scene_sdf, make_scene_sdf_with_id
from loltracer_tpu.scene import SceneParams, SceneStructure

OBJ_AXIS = "objects"


def pad_spheres_for_sharding(params: SceneParams, n_shards: int) -> SceneParams:
    """Pad the sphere SoA so the object axis divides evenly over the mesh
    axis; pad spheres have radius -1e30 so they never win a min (the same
    sentinel the instanced SDF's own padding uses, render/sdf.py)."""
    ns = params.sphere_radius.shape[0]
    pad = (-ns) % n_shards
    if pad == 0:
        return params
    return dataclasses.replace(
        params,
        sphere_point=jnp.concatenate(
            [jnp.asarray(params.sphere_point),
             jnp.zeros((pad, 3), jnp.asarray(params.sphere_point).dtype)]
        ),
        sphere_radius=jnp.concatenate(
            [jnp.asarray(params.sphere_radius),
             jnp.full((pad,), -1e30, jnp.asarray(params.sphere_radius).dtype)]
        ),
    )


def _sharded_sdfs(structure: SceneStructure, cfg: RenderConfig,
                  shard_offset, axis: str):
    """(sdf, sdf_id) evaluating the LOCAL sphere shard and combining across
    `axis`: distances with pmin; ids by min-over-winning-devices so the
    first-wins (lowest global id) tie rule survives sharding. The step
    clamp applies to the COMBINED sphere min (then planes), matching the
    unsharded sdf.py order."""
    # Evaluate the full local SDF (local spheres + replicated planes) and
    # pmin-combine. Planes are replicated so every shard computes the same
    # plane distance; pmin of identical values is exact. The step clamp
    # commutes with the combine: min(min(sph_all, c), planes) ==
    # pmin_s(min(sph_s, planes, c)) by associativity of min, so clamping
    # the LOCAL value unconditionally reproduces the unsharded oracle's
    # value bitwise.
    local = make_scene_sdf_with_id(structure, None)
    clamp = cfg.step_clamp

    def _cut(params, p):
        """The unsharded oracle's per-point cut max(clamp, dist to the
        GLOBAL sphere-set bbox): local shard bboxes are smaller, so the
        global AABB corners come from a pmin/pmax over the object axis
        (sentinel-padded spheres excluded)."""
        sg = lax.stop_gradient
        pos = jnp.asarray(params.sphere_point)
        rad = jnp.asarray(params.sphere_radius)
        real = rad > -1e29
        lo = jnp.min(
            jnp.where(real[:, None], pos - rad[:, None], jnp.inf), axis=0
        )
        hi = jnp.max(
            jnp.where(real[:, None], pos + rad[:, None], -jnp.inf), axis=0
        )
        lo = lax.pmin(sg(lo), axis)
        hi = lax.pmax(sg(hi), axis)
        q = jnp.maximum(jnp.maximum(lo - p, p - hi), 0.0)
        s = jnp.sum(q * q, axis=-1)
        d_bbox = jnp.where(s > 0, jnp.sqrt(jnp.where(s > 0, s, 1.0)), 0.0)
        return jnp.maximum(jnp.asarray(clamp, d_bbox.dtype), d_bbox)

    def _local(params, p):
        d_unc, id_loc = local(params, p)
        d_loc = d_unc
        if clamp is not None:
            d_loc = jnp.minimum(d_loc, _cut(params, p))
        return d_loc, id_loc, d_unc

    def _combine(d_loc):
        """pmin with a subgradient: pmin has no JAX differentiation rule,
        and the render pipeline differentiates the SDF (IFT numerator,
        normal taps, penumbra re-attachment, the den JVP). Value = the
        replicated global min; gradient flows through the local value on
        shard(s) attaining it (ties across shards are measure-zero)."""
        sg = lax.stop_gradient
        m = lax.pmin(sg(d_loc), axis)
        return m + jnp.where(sg(d_loc) <= m, d_loc - sg(d_loc), 0.0)

    def sdf_id(params, p):
        d_loc, id_loc, d_unc = _local(params, p)
        # globalize ids: local sphere i on shard s is global sphere
        # s*ns_local + i (object ids are 1-based; plane ids sit after ALL
        # spheres and shift by the global sphere count)
        ns_loc = params.sphere_radius.shape[0]
        n_shards = lax.psum(1, axis)
        idx = lax.axis_index(axis)
        is_sphere = (id_loc >= 1) & (id_loc <= ns_loc)
        gid = jnp.where(
            is_sphere,
            id_loc + idx * ns_loc,
            jnp.where(
                id_loc > ns_loc, id_loc + ns_loc * (n_shards - 1), id_loc
            ),
        )
        d = _combine(d_loc)
        # The winning shard(s) contribute their global id, everyone else a
        # sentinel; min picks the lowest id (first-wins across shards).
        # The winner test runs on the UNCLAMPED distances (a second pmin):
        # the unsharded oracle's id is the unclamped argmin even under
        # step_clamp (sdf.py make_scene_sdf_with_id), and testing the
        # clamped values would tie EVERY shard at d_loc == cut wherever the
        # cut wins, silently replacing the global argmin id with a
        # min-over-local-argmins.
        sg = lax.stop_gradient
        d_unc_glob = lax.pmin(sg(d_unc), axis)
        big = jnp.int32(2**30)
        gid_win = jnp.where(sg(d_unc) <= d_unc_glob, gid, big)
        gid = lax.pmin(gid_win, axis)
        return d, jnp.where(gid == big, 0, gid)

    def sdf(params, p):
        d_loc, _, _ = _local(params, p)
        return _combine(d_loc)

    del shard_offset
    return sdf, sdf_id


def make_object_sharded_renderer(
    structure: SceneStructure,
    mesh: Mesh,
    height: int,
    width: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
    row_axis: Optional[str] = None,
    obj_axis: str = OBJ_AXIS,
) -> Callable[[SceneParams], jnp.ndarray]:
    """Compile `params -> [H, W, 3]` with the instanced sphere SoA sharded
    over `obj_axis` (and rows optionally over `row_axis` of the same
    mesh). Every device in an object group evaluates its sphere shard and
    the march runs on the pmin-combined distance; results are bitwise
    independent of the object-mesh size (only the reduction tree order of
    identical-value pmins differs). The pmin-combined SDF overrides the
    scene's own, so the marches run as jnp loops (render_rays)."""
    if not structure.instanced:
        raise ValueError("object sharding applies to instanced scenes")
    n_obj = mesh.shape[obj_axis]
    cfg = cfg.replace(march_backend="jnp")  # custom sdf -> jnp march loop

    # static shard bookkeeping: spheres pad to a multiple of the object
    # mesh (sentinel radius, never wins); ids stay 1..ns for real spheres
    # (padding sits at the tail), planes shift past the padded count, so
    # the material table must be re-laid-out to the padded numbering
    ns = structure.num_spheres
    ns_pad = ns + ((-ns) % n_obj)
    ns_loc = ns_pad // n_obj
    pad = ns_pad - ns
    mat_ids = structure.material_ids
    padded_mat_ids = (
        mat_ids[: 1 + ns] + (0,) * pad + mat_ids[1 + ns:]
    )
    structure_global = dataclasses.replace(
        structure, num_spheres=ns_pad, material_ids=padded_mat_ids
    )
    structure_local = dataclasses.replace(
        structure, num_spheres=ns_loc, material_ids=()
    )

    if row_axis is not None:
        if height % mesh.shape[row_axis]:
            raise ValueError(
                f"height {height} must divide over {mesh.shape[row_axis]} "
                "row shards"
            )
        row_spec = P(row_axis)
        out_spec = P(row_axis)
    else:
        row_spec = P()
        out_spec = P()

    def render_shard(params: SceneParams, rows):
        sdf, sdf_id = _sharded_sdfs(structure_local, cfg, None, obj_axis)
        # shadow marches under their own clamp need their own pmin SDF —
        # the unsharded oracle builds a second scene SDF at the effective
        # shadow clamp, so the sharded path must too
        shadow_sdf = None
        sclamp = cfg.effective_shadow_clamp()
        shadow_cfg = cfg.replace(
            step_clamp=sclamp, shadow_step_clamp=None
        )
        if sclamp != cfg.step_clamp:
            shadow_sdf, _ = _sharded_sdfs(
                structure_local, shadow_cfg, None, obj_axis
            )
        ro, rd = camera_rays_for_rows(params, rows, height, width, cfg)
        pr = pixel_radius(params, height, cfg) if cfg.antialias else None
        return render_rays(
            structure_global, params, ro, rd, cfg, pixel_rad=pr,
            sdf=sdf, sdf_id=sdf_id, shadow_sdf=shadow_sdf,
        )

    sharded = shard_map(
        render_shard,
        mesh=mesh,
        in_specs=(
            dataclasses.replace(
                _param_specs(structure), sphere_point=P(obj_axis),
                sphere_radius=P(obj_axis),
            ),
            row_spec,
        ),
        out_specs=out_spec,
        check_vma=False,
    )
    rows = jnp.arange(height, dtype=jnp.int32)

    @jax.jit
    def renderer(params: SceneParams) -> jnp.ndarray:
        return sharded(pad_spheres_for_sharding(params, n_obj), rows)

    return renderer


def _param_specs(structure: SceneStructure) -> SceneParams:
    """A SceneParams pytree of replicated PartitionSpecs (shard_map
    in_specs must mirror the input pytree)."""
    import loltracer_tpu.scene as sc

    fields = {f.name: P() for f in dataclasses.fields(sc.SceneParams)}
    return sc.SceneParams(**fields)
