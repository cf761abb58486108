"""Sphere-trace march: masked batched loop + differentiable hit distance.

Forward semantics mirror naive_renderer.c:46-69: up to `max_steps`
iterations, each evaluating the full scene SDF at p = ro + t*rd and
accumulating t += d, stopping when d < epsilon or t > max_dist; the hit id is
the argmin id from the *last* SDF evaluation (i.e. at the pre-accumulation
t), and id becomes 0 (miss) when the final t >= max_dist.

Batched, the per-ray `break` becomes lane masking: a single
`lax.while_loop` runs until every ray in the batch is done (or max_steps),
with per-lane done flags freezing converged rays — the wavefront-divergence
model of SURVEY.md §5.7.

Differentiability: the step count is a non-differentiable function of the
scene, so reverse-mode AD through the loop is both unsupported
(while_loop) and wrong (it would differentiate the trajectory, not the hit
point). Instead we use the implicit-function theorem on the hit condition
f(ro + t*rd, theta) = 0: the marched t0 is taken as a constant and
re-attached as

    t = t0 + (corr - stop_grad(corr)),
    corr = -f(ro + sg(t0)*rd, theta) / sg(df/dt at hit)

whose *value* is exactly t0 and whose gradient w.r.t. theta, ro and rd is
the IFT derivative (cf. the reparameterized differentiable-sphere-tracing
literature, PAPERS.md Dr.Jit / reparameterized SDF rendering). Miss rays get
zero gradient. The denominator df/dt = grad f . rd is computed with one
forward-mode JVP along the ray and clamped away from zero to keep grazing-hit
gradients bounded.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from loltracer_tpu.config import RenderConfig

_MIN_DEN = 1e-2  # grazing-hit gradient guard for the IFT denominator


class MarchResult(NamedTuple):
    """Raw (non-differentiable) march outputs, per ray."""

    t: jnp.ndarray  # final accumulated distance
    t_query: jnp.ndarray  # t of the last SDF evaluation (for hit-id lookup)
    s_min: jnp.ndarray  # min over steps of d/t: angular closest approach
    t_close: jnp.ndarray  # t at which s_min was attained


def march(
    sdf: Callable,
    params,
    ro,
    rd,
    cfg: RenderConfig,
) -> MarchResult:
    """Non-differentiable masked march.

    Args:
      sdf: `sdf(params, p[..., 3]) -> dist[...]`.
      ro: ray origins broadcastable to rd's batch, [..., 3].
      rd: unit ray directions [..., 3].

    Besides the reference's outputs, tracks the angular closest approach
    min_i d_i/t_i and where it occurred (iq's soft-shadow quantity applied
    to primary rays) — the ingredient for soft-coverage antialiasing, which
    in turn supplies silhouette gradients for inverse rendering.
    """
    batch = jnp.broadcast_shapes(ro.shape[:-1], rd.shape[:-1])
    dtype = rd.dtype
    t0 = jnp.zeros(batch, dtype)
    done0 = jnp.zeros(batch, bool)
    inf0 = jnp.full(batch, jnp.inf, dtype)

    def cond(carry):
        step, _, _, _, _, done = carry
        return (step < cfg.max_steps) & ~jnp.all(done)

    def body(carry):
        step, t, t_query, s_min, t_close, done = carry
        p = ro + t[..., None] * rd
        d = sdf(params, p)
        new_t = t + d
        track = ~done & (t > 0)
        s = d / jnp.where(t > 0, t, 1.0)
        better = track & (s < s_min)
        s_min = jnp.where(better, s, s_min)
        t_close = jnp.where(better, t, t_close)
        t_query = jnp.where(done, t_query, t)
        t = jnp.where(done, t, new_t)
        done = done | (d < cfg.epsilon) | (new_t > cfg.max_dist)
        return step + 1, t, t_query, s_min, t_close, done

    with jax.named_scope("lol_march"):
        _, t, t_query, s_min, t_close, _ = lax.while_loop(
            cond, body, (0, t0, t0, inf0, t0, done0)
        )
    return MarchResult(t, t_query, s_min, t_close)


def intersect(
    sdf: Callable,
    sdf_with_id: Callable,
    params,
    ro,
    rd,
    cfg: RenderConfig,
    march_fn: Callable = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Differentiable intersection: returns (t [...], id [...] int32).

    The value of t is bitwise the marched distance; its gradient is the IFT
    hit-point derivative (zero for miss rays). id follows
    naive_renderer.c:53-68: the argmin id at the last march query point,
    zeroed when t >= max_dist.
    """
    t, obj_id, _, _ = intersect_aa(
        sdf, sdf_with_id, params, ro, rd, cfg, pixel_rad=None,
        march_fn=march_fn,
    )
    return t, obj_id


def intersect_aa(
    sdf: Callable,
    sdf_with_id: Callable,
    params,
    ro,
    rd,
    cfg: RenderConfig,
    pixel_rad=None,
    march_fn: Callable = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Differentiable intersection with optional soft coverage.

    Returns (t_shade, id_shade, alpha, hit):

    - With pixel_rad=None (reference-parity mode): t_shade/id_shade are the
      plain marched hit distance and id (0 on miss), alpha == 1.
    - With pixel_rad set (the pixel's angular half-size): miss rays that
      passed within `pixel_rad` of a surface get a coverage alpha in (0, 1)
      that is DIFFERENTIABLE w.r.t. the scene — alpha = clamp(1 - s/phi)
      where s = f(closest-approach point)/t is re-evaluated differentiably
      at the frozen closest-approach t. Near-miss rays shade with the id of
      the closest object at that point so edge pixels can borrow the
      occluder's color as alpha -> 1. This reconstructs the silhouette
      (coverage) term of the rendering gradient that pure interior/IFT
      gradients miss — without it, gradient descent on primitive positions
      follows a sawtooth landscape and diverges (see tests/test_aa.py).

    `march_fn(params, ro, rd) -> MarchResult` optionally replaces the jnp
    march for the stop-gradient'd value computation (e.g. the Triton march
    kernel, render/triton_march.py) — gradient semantics are unchanged
    because the march result is frozen either way; inputs are stop-gradient'd
    too so AD never needs a JVP rule for the kernel call.
    """
    sg = lax.stop_gradient
    if march_fn is None:
        res = jax.tree_util.tree_map(sg, march(sdf, params, ro, rd, cfg))
    else:
        res = jax.tree_util.tree_map(
            sg, march_fn(sg(params), sg(ro), sg(rd))
        )
    t0 = res.t
    hit = t0 < cfg.max_dist

    # IFT re-attachment for hit rays.
    fval = sdf(params, ro + t0[..., None] * rd)
    _, den = jax.jvp(
        lambda t: sdf(sg(params), sg(ro) + t[..., None] * sg(rd)),
        (t0,),
        (jnp.ones_like(t0),),
    )
    den = sg(den)
    den = jnp.where(
        jnp.abs(den) < _MIN_DEN, jnp.where(den < 0, -_MIN_DEN, _MIN_DEN), den
    )
    corr = jnp.where(hit, -fval / den, 0.0)
    t_diff = t0 + (corr - sg(corr))

    if pixel_rad is None:
        _, obj_id = sdf_with_id(
            sg(params), sg(ro) + res.t_query[..., None] * sg(rd)
        )
        obj_id = jnp.where(hit, obj_id, 0)
        return t_diff, obj_id, jnp.ones_like(t0), hit

    # Soft coverage: shade miss rays at their (frozen) closest approach and
    # blend by a differentiable edge alpha.
    t_close = jnp.where(hit, res.t_query, res.t_close)
    safe_tc = jnp.where(t_close > 0, t_close, 1.0)
    p_close = sg(ro) + t_close[..., None] * sg(rd)
    f_close, id_close = sdf_with_id(params, p_close)
    s = f_close / safe_tc  # differentiable angular closest approach
    # rays that never tracked a closest approach (t_close == 0) stay alpha 0
    edge_alpha = jnp.where(
        t_close > 0, jnp.clip(1.0 - s / pixel_rad, 0.0, 1.0), 0.0
    )
    alpha = jnp.where(hit, 1.0, edge_alpha)

    t_shade = jnp.where(hit, t_diff, sg(t_close))
    id_shade = sg(id_close)
    return t_shade, id_shade, alpha, hit
