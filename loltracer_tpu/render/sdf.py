"""Batched, differentiable scene-SDF evaluation in jnp.

`make_scene_sdf(structure)` is the XLA analog of the reference's
scene JIT (tracing_jit_renderer.dasc:76-143): it walks the static scene
structure ONCE in Python and returns a closure whose jnp ops are specialized
to that structure when traced by XLA. Parameters stay traced inputs, so the
closure is differentiable w.r.t. every scene number.

Evaluation is struct-of-arrays: one batched distance computation per
primitive *type* over all primitives of that type (top-level and CSG leaves
alike), then per-object expressions assemble their distances from the
precomputed columns, then a first-wins argmin picks the hit object
(naive_renderer.c:30-44; strict `<` tie rule of the naive backend — a
documented decision, since the reference's JIT backend breaks ties the other
way, SURVEY.md §2.1.3).

All ops are plain jnp on arrays shaped [..., ] and work identically inside
kernel bodies.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Tuple

import jax.numpy as jnp

from loltracer_tpu.scene import Node, SceneParams, SceneStructure


def smooth_min(a, b, k):
    """Polynomial smooth-min (float.h:29-33), safe at k == 0 where it
    degenerates to a hard min exactly as the reference's float math does
    (division yields +/-inf, the SSE clamp collapses it; SURVEY golden
    tracer sminf)."""
    safe_k = jnp.where(k == 0.0, 1.0, k)
    h = jnp.clip(0.5 + 0.5 * (b - a) / safe_k, 0.0, 1.0)
    h = jnp.where(k == 0.0, jnp.where(b > a, 1.0, 0.0), h)
    return (b + (a - b) * h) - k * h * (1.0 - h)


def _sphere_dists(params: SceneParams, p):
    """[..., 3] -> [..., Ns]: |p - c| - r for every sphere (sdf.h:8-10)."""
    d = p[..., None, :] - params.sphere_point  # [..., Ns, 3]
    return jnp.sqrt(jnp.sum(d * d, axis=-1)) - params.sphere_radius


def _box_dists(params: SceneParams, p):
    """[..., 3] -> [..., Nb]: rounded-box distance (sdf.h:18-22)."""
    q = jnp.abs(p[..., None, :] - params.box_point) - params.box_half
    cq = jnp.maximum(q, 0.0)
    outside = jnp.sqrt(jnp.sum(cq * cq, axis=-1))
    inside = jnp.minimum(jnp.max(q, axis=-1), 0.0)
    return outside + inside - params.box_radius


def _plane_dists(params: SceneParams, p):
    """[..., 3] -> [..., Np]: p.y - y (naive_renderer.c:19-20)."""
    return p[..., 1:2] - params.plane_y


def make_scene_sdf(
    structure: SceneStructure,
    step_clamp: float = None,
) -> Callable:
    """Build `sdf(params, p[..., 3]) -> dist[...]` for this structure.

    `step_clamp` (instanced structures only; config.py RenderConfig
    docstring) returns the step-clamped distance min(d, step_clamp) — one
    extra op here."""
    if structure.instanced:
        inner = _make_instanced_sdf(structure, step_clamp)
        return lambda params, p: inner(params, p)[0]

    def sdf(params: SceneParams, p):
        dists = _object_dists(structure, params, p)
        return jnp.min(jnp.stack(dists, axis=-1), axis=-1)

    return sdf


def make_scene_sdf_with_id(
    structure: SceneStructure,
    step_clamp: float = None,
) -> Callable:
    """Build `sdf(params, p[..., 3]) -> (dist[...], id[...] int32)`.

    Ids are 1-based file-order object positions; jnp.argmin keeps the first
    minimum, i.e. the naive backend's first-wins tie rule. The id is the
    UNCLAMPED argmin even under step_clamp (ids only matter at hits, where
    the clamp is inactive anyway)."""
    if structure.instanced:
        return _make_instanced_sdf(structure, step_clamp)

    def sdf(params: SceneParams, p):
        dists = jnp.stack(_object_dists(structure, params, p), axis=-1)
        return (
            jnp.min(dists, axis=-1),
            jnp.argmin(dists, axis=-1).astype(jnp.int32) + 1,
        )

    return sdf


def _make_instanced_sdf(
    structure: SceneStructure, step_clamp: float = None
) -> Callable:
    """Instanced (10k+ primitive) scene SDF: a running min+argmin over
    fixed-size blocks of the sphere SoA via lax.fori_loop — BVH-free batched
    evaluation whose peak memory is [...pixels, block] instead of
    [...pixels, N]. Planes (few) are merged afterwards. First-wins on ties
    in SoA id order, matching the unrolled path's rule."""
    block = structure.instanced_block
    ns = structure.num_spheres

    def sdf(params: SceneParams, p):
        import jax

        nblocks = -(-ns // block) if ns else 0
        padded = nblocks * block
        batch = p.shape[:-1]

        if ns:
            pad = padded - ns
            pos = jnp.concatenate(
                [params.sphere_point,
                 jnp.zeros((pad, 3), params.sphere_point.dtype)], axis=0
            )
            rad = jnp.concatenate(
                [params.sphere_radius,
                 jnp.full((pad,), -1e30, params.sphere_radius.dtype)], axis=0
            )

            def body(i, carry):
                dmin, imin = carry
                bpos = jax.lax.dynamic_slice(
                    pos, (i * block, 0), (block, 3)
                )
                brad = jax.lax.dynamic_slice(rad, (i * block,), (block,))
                d = p[..., None, :] - bpos
                dist = jnp.sqrt(jnp.sum(d * d, axis=-1)) - brad
                bd = jnp.min(dist, axis=-1)
                bi = jnp.argmin(dist, axis=-1).astype(jnp.int32) + i * block
                closer = bd < dmin
                return (
                    jnp.where(closer, bd, dmin),
                    jnp.where(closer, bi + 1, imin),
                )

            init = (
                jnp.full(batch, jnp.inf, p.dtype),
                jnp.zeros(batch, jnp.int32),
            )
            dmin, imin = jax.lax.fori_loop(0, nblocks, body, init)
        else:
            dmin = jnp.full(batch, jnp.inf, p.dtype)
            imin = jnp.zeros(batch, jnp.int32)

        # The clamp applies to the SPHERE set only, BEFORE the plane merge,
        # so sky/floor rays keep exact full-size steps — and it relaxes to
        # the distance-to-bounding-box outside the sphere set's AABB
        # (cut = max(clamp, d_bbox), still a true lower bound of every
        # sphere distance), so rays escape empty space at full stride
        # instead of crawling in clamp-sized steps.
        if step_clamp is not None and ns:
            real = rad > -1e29  # object-sharded shards carry sentinel pads
            lo = jnp.min(
                jnp.where(real[:, None], pos - rad[:, None], jnp.inf), axis=0
            )
            hi = jnp.max(
                jnp.where(real[:, None], pos + rad[:, None], -jnp.inf), axis=0
            )
            q = jnp.maximum(jnp.maximum(lo - p, p - hi), 0.0)
            s = jnp.sum(q * q, axis=-1)
            # NaN-safe sqrt: inside the box s == 0 and sqrt's JVP is 0/0,
            # which max's multiplicative gradient rule turns into NaN in
            # the IFT denominator (found the hard way); value unchanged
            d_bbox = jnp.where(s > 0, jnp.sqrt(jnp.where(s > 0, s, 1.0)), 0.0)
            cut = jnp.maximum(jnp.asarray(step_clamp, dmin.dtype), d_bbox)
            dmin = jnp.minimum(dmin, cut)

        if structure.num_planes:
            dpl = _plane_dists(params, p)  # [..., Np]
            bd = jnp.min(dpl, axis=-1)
            bi = jnp.argmin(dpl, axis=-1).astype(jnp.int32) + ns + 1
            closer = bd < dmin
            dmin = jnp.where(closer, bd, dmin)
            imin = jnp.where(closer, bi, imin)

        return dmin, imin

    return sdf


def _object_dists(structure: SceneStructure, params: SceneParams, p):
    """Per-top-level-object distances, each [...], in file order."""
    # Batched per-type distance columns, computed once and shared by every
    # expression that references that type.
    columns: Dict[str, jnp.ndarray] = {}
    if structure.num_spheres:
        columns["sphere"] = _sphere_dists(params, p)
    if structure.num_boxes:
        columns["box"] = _box_dists(params, p)
    if structure.num_planes:
        columns["plane"] = _plane_dists(params, p)

    def eval_node(node: Node):
        kind = node[0]
        if kind == "smin":
            _, k, a, b = node
            return smooth_min(
                eval_node(a), eval_node(b), params.smooth_k[k]
            )
        return columns[kind][..., node[1]]

    return [eval_node(node) for node in structure.objects]
