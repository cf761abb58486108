"""Shadows, normals and Blinn/Phong shading (naive_renderer.c:71-175),
batched and AD-safe.

Soft shadows are iq-style (naive_renderer.c:71-100) with the reference's
quirks kept: the shadow ray starts a full `shadow_offset` unit from the
surface toward the light (naive_renderer.c:97), the first iteration divides
by dist = 0 yielding +/-inf (benign: min(1, +inf) = 1, and -inf trips the
res < -1 early-out into a hard 0), and the loop caps at `shadow_steps` with
sharpness `shadow_w`.

The fixed-trip-count scan replaces the data-dependent break with sticky
per-lane done flags, which makes the whole shadow computation reverse-mode
differentiable; the body is rematerialized so backward memory stays at one
carry per step.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

from loltracer_tpu.config import RenderConfig
from loltracer_tpu.scene import SceneParams, SceneStructure

_NORMAL_KS = ((1.0, -1.0, -1.0), (-1.0, -1.0, 1.0), (-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))

from loltracer_tpu.render.vecmath import dot as _dot, normalize as _normalize


def shadow_march(sdf: Callable, params, ro, rd, max_dist, cfg: RenderConfig):
    """The shadow march of naive_renderer.c:71-90 as a `cfg.shadow_steps`
    scan: (res, t*), the raw (unclamped) running min of w·d/t and the first
    step t at which it was reached."""
    batch = jnp.broadcast_shapes(ro.shape[:-1], rd.shape[:-1], max_dist.shape)
    dtype = rd.dtype
    inf = jnp.asarray(jnp.inf, dtype)

    @jax.checkpoint
    def body(carry, _):
        res, t, t_star, done = carry
        p = ro + t[..., None] * rd
        d = sdf(params, p)
        safe_t = jnp.where(t > 0, t, 1.0)
        # first iteration: w*d/0 -> +/-inf (naive_renderer.c:83); the d == 0
        # corner (NaN in C) is mapped to +inf, a documented measure-zero
        # simplification.
        val = jnp.where(
            t > 0, cfg.shadow_w * d / safe_t, jnp.where(d < 0, -inf, inf)
        )
        better = ~done & (val < res)  # first-wins argmin of the running min
        new_res = jnp.where(done, res, jnp.minimum(res, val))
        t_star = jnp.where(better, t, t_star)
        new_t = jnp.where(done, t, t + d)
        new_done = done | (new_res < -1) | (new_t > max_dist)
        return (new_res, new_t, t_star, new_done), None

    init = (
        jnp.ones(batch, dtype),
        jnp.zeros(batch, dtype),
        jnp.zeros(batch, dtype),
        jnp.zeros(batch, bool),
    )
    with jax.named_scope("lol_shadow_march"):
        (res, _, t_star, _), _ = lax.scan(
            body, init, None, length=cfg.shadow_steps
        )
    return res, t_star


def soft_shadow(
    sdf: Callable,
    params,
    ro,
    rd,
    max_dist,
    cfg: RenderConfig,
    shadow_march_fn: Callable = None,
):
    """softshadow(scene, ro, rd, 128, light_dist, 50) of
    naive_renderer.c:71-90. `ro` is the already-offset origin; `max_dist`
    the per-ray distance to the light.

    Gradient estimator selected by cfg.shadow_grad (config.py):
    "exact" backpropagates through the full rematerialized scan;
    "envelope" freezes the scan (optionally replaced by the Triton shadow
    kernel via `shadow_march_fn(params, ro, rd, max_dist) -> (res, t*)`)
    and re-attaches the gradient via one differentiable SDF evaluation at
    the recorded argmin t* (Danskin's theorem on the penumbra envelope
    min(1, min_t w·f(ro+t·rd)/t)). Forward values are identical either way.
    """
    if cfg.shadow_grad == "exact":
        res, _ = shadow_march(sdf, params, ro, rd, max_dist, cfg)
        return jnp.maximum(res, 0.0)

    if cfg.shadow_grad != "envelope":
        raise ValueError(f"unknown shadow_grad {cfg.shadow_grad!r}")

    sg = lax.stop_gradient
    frozen = shadow_march_fn or partial(shadow_march, sdf, cfg=cfg)
    res0, t_star = jax.tree_util.tree_map(
        sg, frozen(sg(params), sg(ro), sg(rd), sg(max_dist))
    )
    # Re-attach: one differentiable eval of the envelope integrand at the
    # frozen argmin. Gradients flow through params, ro and rd (the shadow
    # origin/direction depend on the hit point and light position); t* is
    # a stationary point of the idealized envelope so its own sensitivity
    # vanishes. Only interior minima (0 < res < 1, t* > 0) carry gradient:
    # res >= 1 is saturated lit, res <= 0 is clamped to hard shadow by the
    # max below exactly as in exact mode.
    valid = (t_star > 0) & (res0 > 0) & (res0 < 1)
    safe_ts = jnp.where(t_star > 0, t_star, 1.0)
    d_star = sdf(params, ro + t_star[..., None] * rd)
    val = cfg.shadow_w * d_star / safe_ts
    res = jnp.where(valid, res0 + (val - sg(val)), res0)
    return jnp.maximum(res, 0.0)


def get_normal(sdf: Callable, params, p, dist, cfg: RenderConfig):
    """Tetrahedron-offset normal estimation with h = dist/100
    (naive_renderer.c:114-125).

    The four taps run as ONE batched SDF call over a leading tap axis —
    single kernel instead of four, and the fused XLA backward of the
    four-separate-calls formulation miscompiled to NaN/garbage gradients on
    XLA:CPU (observed empirically; the batched graph is also what we want on
    the GPU)."""
    with jax.named_scope("lol_normal"):
        ks = jnp.asarray(_NORMAL_KS, p.dtype)  # [4, 3]
        batch_ndim = p.ndim - 1
        ks_b = ks.reshape((4,) + (1,) * batch_ndim + (3,))
        h = (dist * cfg.normal_h_scale)[..., None]  # [..., 1]
        pts = p[None] + ks_b * h[None]  # [4, ..., 3] — tap axis leading
        d = sdf(params, pts)  # [4, ...]
        # an elementwise sum over the taps, not a contraction: a float32
        # dot may run at reduced (TF32) precision on a GPU
        n = sum(d[k][..., None] * ks[k] for k in range(4))  # [..., 3]
        return _normalize(n)


def _safe_pow(base, exponent):
    """base ** exponent for base in [0, 1] with C powf corner semantics
    (powf(0, 0) == 1) and NaN-free gradients at base == 0."""
    positive = base > 0
    safe_base = jnp.where(positive, base, 1.0)
    powv = safe_base**exponent
    return jnp.where(positive, powv, jnp.where(exponent == 0.0, 1.0, 0.0))


def shade(
    structure: SceneStructure,
    params: SceneParams,
    sdf: Callable,
    p,
    n,
    obj_id,
    cfg: RenderConfig,
    shadow_march_fn: Callable = None,
):
    """Phong shading with per-light soft shadows (naive_renderer.c:127-175).

    p: hit points [..., 3]; n: unit normals [..., 3]; obj_id: [...] int32
    (0 = miss -> material 0, the background material). Returns clamped
    linear RGB [..., 3]. `shadow_march_fn` optionally replaces the jnp
    shadow scan for the frozen value pass in envelope mode (soft_shadow).
    """
    with jax.named_scope("lol_shade"):
        mat_ids = jnp.asarray(structure.material_ids, jnp.int32)
        mat = mat_ids[obj_id]
        shininess = params.mat_shininess[mat]
        diffuse = params.mat_diffuse[mat]
        specular = params.mat_specular[mat]
        ambient = params.mat_ambient[mat]

        total = jnp.zeros_like(p)
        cam_pos = params.cam_point

        for li in range(structure.num_lights):
            light_pos = params.light_point[li]
            to_light = light_pos - p
            light_dist = jnp.sqrt(_dot(to_light, to_light))
            light_dir = _normalize(to_light)

            shadow_ro = p + light_dir * cfg.shadow_offset
            shadow = soft_shadow(
                sdf, params, shadow_ro, light_dir, light_dist, cfg,
                shadow_march_fn=shadow_march_fn,
            )

            diffuse_incidence = jnp.clip(_dot(n, light_dir), 0.0, 1.0)
            total = total + (
                params.light_diffuse[li]
                * (shadow * diffuse_incidence)[..., None]
                * diffuse
            )

            reflected = n * (2.0 * _dot(light_dir, n))[..., None] - light_dir
            camera_dir = _normalize(cam_pos - p)
            base = jnp.clip(_dot(reflected, camera_dir), 0.0, 1.0)
            specular_incidence = diffuse_incidence * _safe_pow(base, shininess)
            total = total + (
                params.light_specular[li]
                * (shadow * specular_incidence)[..., None]
                * specular
            )

        total = total + params.ambient_color * ambient
        return jnp.clip(total, 0.0, 1.0)
