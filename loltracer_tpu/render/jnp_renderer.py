"""The renderer: one differentiable path from scene parameters to pixels.

One jittable function renders the whole image as a [H, W] ray batch through
the full pipeline — camera rays, differentiable march, tetrahedron normals,
per-light soft shadows, Phong shading, gamma — entirely from the scene
parameter pytree, so `jax.grad` of any image loss w.r.t. the scene works out
of the box. Equivalent to the per-pixel worker loop naive_renderer.c:195-240.
The two marches are frozen value passes with pluggable implementations
(`_select_march`, `_select_shadow_march`); gradients are re-attached in jnp.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from loltracer_tpu.config import DEFAULT_CONFIG, RenderConfig
from loltracer_tpu.render.backend import resolve_march_backend
from loltracer_tpu.render.camera import camera_rays, camera_rays_for_rows
from loltracer_tpu.render.march import intersect_aa
from loltracer_tpu.render.sdf import make_scene_sdf, make_scene_sdf_with_id
from loltracer_tpu.render.shading import get_normal, shade
from loltracer_tpu.scene import Scene, SceneParams, SceneStructure


def pixel_radius(params: SceneParams, height: int, cfg: RenderConfig):
    """Angular half-size of a pixel at the view center: the view half-height
    (atan(fov/2), the reference's projection quirk) spans height/2 pixels."""
    half = jnp.arctan(params.cam_fov / 2.0) if cfg.atan_fov else jnp.tan(
        params.cam_fov / 2.0
    )
    return cfg.aa_width * half / height


def gamma_encode(color, gamma: float):
    """color ** gamma (naive_renderer.c:231), with finite gradients at
    color == 0 where d/dc c^g diverges for g < 1 (clipped channels sit
    exactly at 0, so this matters for every black pixel)."""
    positive = color > 0
    safe = jnp.where(positive, color, 1.0)
    return jnp.where(positive, safe**gamma, 0.0)


def _kernel_backend(structure: SceneStructure, rd, cfg: RenderConfig):
    """The kernel backend for this call's value passes, or None for the jnp
    loops. The kernels apply to a compiled scene and an [H, W, 3] f32 ray
    grid; where that does not hold, "auto" falls back to jnp and an
    explicitly requested kernel backend raises."""
    backend = resolve_march_backend(cfg.march_backend)
    if backend == "jnp":
        return None
    applicable = (
        not structure.instanced
        and rd.ndim == 3
        and rd.shape[-1] == 3
        and rd.dtype == jnp.float32
    )
    if not applicable:
        if cfg.march_backend != "auto":
            raise ValueError(
                f"march_backend={cfg.march_backend!r} requires a compiled "
                "scene and an [H, W, 3] f32 ray grid; got instanced="
                f"{structure.instanced}, rd {rd.shape} {rd.dtype}"
            )
        return None
    return backend


def _select_march(structure: SceneStructure, ro, rd, cfg: RenderConfig):
    """The primary-march value pass for this call: the Triton kernel when
    `_kernel_backend` picks it (and the rays share one origin), else None ->
    the jnp while_loop."""
    backend = _kernel_backend(structure, rd, cfg)
    if backend is None:
        return None
    if ro.ndim != 1:
        if cfg.march_backend != "auto":
            raise ValueError(
                f"march_backend={cfg.march_backend!r} requires one ray "
                f"origin [3]; got ro {ro.shape}"
            )
        return None
    from loltracer_tpu.render.triton_march import make_triton_march

    return make_triton_march(
        structure, cfg, interpret=(backend == "triton-interpret")
    )


def _select_shadow_march(structure: SceneStructure, rd, cfg: RenderConfig):
    """The frozen shadow-march value pass for envelope-gradient shadows:
    the Triton kernel under the same rule as `_select_march`, else None ->
    the jnp scan inside shading.soft_shadow."""
    if cfg.shadow_grad != "envelope":
        return None
    backend = _kernel_backend(structure, rd, cfg)
    if backend is None:
        return None
    from loltracer_tpu.render.triton_march import make_triton_shadow_march

    return make_triton_shadow_march(
        structure, cfg, interpret=(backend == "triton-interpret")
    )


def render_rays(
    structure: SceneStructure,
    params: SceneParams,
    ro,
    rd,
    cfg: RenderConfig = DEFAULT_CONFIG,
    pixel_rad=None,
    sdf=None,
    sdf_id=None,
    shadow_sdf=None,
) -> jnp.ndarray:
    """Render arbitrary ray batches: ro [3] or [..., 3], rd [..., 3] ->
    gamma-corrected RGB [..., 3]. With cfg.antialias and a pixel_rad
    (see pixel_radius), silhouettes get soft differentiable coverage.
    `sdf`/`sdf_id`/`shadow_sdf` override the scene SDF (the object-sharded
    path injects pmin-combined SDFs here, parallel/objects.py); overrides
    force the jnp march (the kernels compile the structure's own SDF)."""
    clamp = cfg.step_clamp if structure.instanced else None
    override = sdf is not None
    if sdf is None:
        sdf = make_scene_sdf(structure, clamp)
    if sdf_id is None:
        sdf_id = make_scene_sdf_with_id(structure, clamp)
    # shadow marches may run under their own (larger) step clamp
    # (config.py shadow_step_clamp); an sdf override whose shadow clamp
    # differs must supply its own shadow_sdf — silently reusing the
    # primary-clamp override would diverge from the unsharded oracle
    # (parallel/objects.py threads one)
    shadow_clamp = cfg.effective_shadow_clamp() if structure.instanced else None
    if shadow_sdf is None:
        if shadow_clamp == clamp:
            shadow_sdf = sdf
        elif override:
            raise ValueError(
                "shadow_step_clamp differs from step_clamp but the sdf "
                "override supplies no shadow_sdf"
            )
        else:
            shadow_sdf = make_scene_sdf(structure, shadow_clamp)

    use_aa = cfg.antialias and pixel_rad is not None
    march_fn = None if override else _select_march(structure, ro, rd, cfg)
    shadow_march_fn = (
        None if override else _select_shadow_march(structure, rd, cfg)
    )
    t, obj_id, alpha, hit = intersect_aa(
        sdf, sdf_id, params, ro, rd, cfg, pixel_rad if use_aa else None,
        march_fn=march_fn,
    )
    p = ro + t[..., None] * rd
    n = get_normal(sdf, params, p, t, cfg)
    color = shade(
        structure, params, shadow_sdf, p, n, obj_id, cfg,
        shadow_march_fn=shadow_march_fn,
    )
    if use_aa:
        # blend toward the background (material 0 ambient) in linear space
        bg = jnp.clip(params.ambient_color * params.mat_ambient[0], 0.0, 1.0)
        color = alpha[..., None] * color + (1.0 - alpha[..., None]) * bg
    return gamma_encode(color, cfg.gamma)


def render_image(
    structure: SceneStructure,
    params: SceneParams,
    height: int,
    width: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
    dtype=jnp.float32,
) -> jnp.ndarray:
    """Render the full image: [H, W, 3] float in [0, 1]."""
    ro, rd = camera_rays(params, height, width, cfg, dtype=dtype)
    pr = pixel_radius(params, height, cfg) if cfg.antialias else None
    return render_rays(structure, params, ro, rd, cfg, pixel_rad=pr)


def render_image_banded(
    structure: SceneStructure,
    params: SceneParams,
    height: int,
    width: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
    band_rows: int = 64,
    dtype=jnp.float32,
) -> jnp.ndarray:
    """Render in sequential row bands via lax.map, bounding peak memory to
    one band's intermediates. Required for large images with instanced
    scenes, where each SDF evaluation materializes [pixels, object_block]
    temporaries (SURVEY.md §5.7); also caps backward-scan residual memory
    for full-image gradients."""
    if height % band_rows:
        band_rows = next(
            b for b in range(min(band_rows, height), 0, -1) if height % b == 0
        )
    rows = jnp.arange(height, dtype=jnp.int32).reshape(-1, band_rows)
    pr = pixel_radius(params, height, cfg) if cfg.antialias else None

    # checkpoint per band: without it, reverse-mode through lax.map stacks
    # EVERY band's re-attachment residuals ([nbands, pixels, block] per
    # differentiable SDF eval site) and large-image instanced gradients
    # exceed HBM; remat recomputes a band's forward during its backward so
    # only one band's residuals are ever live
    @jax.checkpoint
    def band(rs):
        ro, rd = camera_rays_for_rows(params, rs, height, width, cfg, dtype)
        return render_rays(structure, params, ro, rd, cfg, pixel_rad=pr)

    img = jax.lax.map(band, rows)  # [nbands, band_rows, W, 3]
    return img.reshape(height, width, 3)


def make_renderer(
    structure: SceneStructure,
    height: int,
    width: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
    dtype=jnp.float32,
) -> Callable[[SceneParams], jnp.ndarray]:
    """Compile a renderer specialized to this scene structure — the analog of
    the reference's render_prepare JIT step (tracing_jit_renderer.dasc:416).
    The returned function maps params -> image and is differentiable."""

    @jax.jit
    def renderer(params: SceneParams) -> jnp.ndarray:
        return render_image(structure, params, height, width, cfg, dtype)

    return renderer


def render_scene(
    scene: Scene,
    height: int,
    width: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
) -> jnp.ndarray:
    """Convenience one-shot render of a compiled scene."""
    return make_renderer(scene.structure, height, width, cfg)(scene.params)
