"""Scene SDF over per-ray vectors with the scene unrolled at trace time.

The value-pass kernels (render/triton_march.py) evaluate the scene one
block of rays at a time: the scene *structure* is walked in Python while
tracing, and every scene *number* is a traced scalar read once per block
from a small packed array (the kernel analog of the reference's scene JIT,
tracing_jit_renderer.dasc:76-143). This module holds that evaluator and the
two loops it drives, written against plain jnp so they run both inside a
kernel and as ordinary XLA code:

- `ScalarScene`: SDF of a compiled (non-instanced) structure from nested
  tuples of scalars;
- `march_loop` / `shadow_loop`: the sphere-trace and soft-shadow loops with
  the exact per-ray semantics of render/march.py `march` and the frozen scan
  in render/shading.py, exiting once every ray of the block is done;
- `pack_geometry` / `unpack_geometry`: the flat f32 layout of the scene
  numbers the kernels read.
"""

from __future__ import annotations

from typing import Dict

import jax.numpy as jnp
from jax import lax

from loltracer_tpu.render.sdf import smooth_min
from loltracer_tpu.scene import SceneStructure

# Scene-parameter fields the SDF reads, in packing order.
GEOM_FIELDS = [
    "sphere_point",
    "sphere_radius",
    "box_point",
    "box_half",
    "box_radius",
    "plane_y",
    "smooth_k",
]


def field_shape(structure: SceneStructure, field: str):
    """Logical shape of a geometry field (scene.py SceneParams)."""
    s = structure
    return {
        "sphere_point": (s.num_spheres, 3),
        "sphere_radius": (s.num_spheres,),
        "box_point": (s.num_boxes, 3),
        "box_half": (s.num_boxes, 3),
        "box_radius": (s.num_boxes,),
        "plane_y": (s.num_planes,),
        "smooth_k": (s.num_unions,),
    }[field]


def pack_geometry(structure: SceneStructure, params) -> jnp.ndarray:
    """Every geometry number of `params` as one flat f32 vector, fields in
    GEOM_FIELDS order, each row-major (the layout `unpack_geometry`
    reads)."""
    parts = [
        jnp.ravel(jnp.asarray(getattr(params, f), jnp.float32))
        for f in GEOM_FIELDS
    ]
    return jnp.concatenate(parts)


def unpack_geometry(structure: SceneStructure, read, offset: int = 0) -> Dict:
    """Nested tuples of scalars mirroring the field shapes, where
    `read(i)` returns element i of the packed vector (a ref load inside a
    kernel, an array index outside). 1-D fields become (s0, s1, ...), [N, 3]
    fields ((x, y, z), ...)."""
    values = {}
    k = offset
    for f in GEOM_FIELDS:
        shape = field_shape(structure, f)
        if len(shape) == 1:
            values[f] = tuple(read(k + i) for i in range(shape[0]))
            k += shape[0]
        else:
            values[f] = tuple(
                tuple(read(k + i * shape[1] + j) for j in range(shape[1]))
                for i in range(shape[0])
            )
            k += shape[0] * shape[1]
    return values


class ScalarScene:
    """The unrolled SDF of a compiled structure from nested tuples of
    scalars (`unpack_geometry`), evaluated on per-ray component vectors."""

    def __init__(self, structure: SceneStructure, values: Dict):
        if structure.instanced:
            raise ValueError("ScalarScene evaluates compiled structures only")
        s = structure
        self.structure = s
        self.sphere = [
            (*values["sphere_point"][i], values["sphere_radius"][i])
            for i in range(s.num_spheres)
        ]
        self.box = [
            (*values["box_point"][i], *values["box_half"][i],
             values["box_radius"][i])
            for i in range(s.num_boxes)
        ]
        self.plane = list(values["plane_y"])
        self.smooth_k = list(values["smooth_k"])

    def node_dist(self, node, px, py, pz):
        kind = node[0]
        if kind == "sphere":
            cx, cy, cz, r = self.sphere[node[1]]
            dx, dy, dz = px - cx, py - cy, pz - cz
            return jnp.sqrt(dx * dx + dy * dy + dz * dz) - r
        if kind == "box":
            cx, cy, cz, bx, by, bz, r = self.box[node[1]]
            qx = jnp.abs(px - cx) - bx
            qy = jnp.abs(py - cy) - by
            qz = jnp.abs(pz - cz) - bz
            ox = jnp.maximum(qx, 0.0)
            oy = jnp.maximum(qy, 0.0)
            oz = jnp.maximum(qz, 0.0)
            outside = jnp.sqrt(ox * ox + oy * oy + oz * oz)
            inside = jnp.minimum(jnp.maximum(qx, jnp.maximum(qy, qz)), 0.0)
            return outside + inside - r
        if kind == "plane":
            return py - self.plane[node[1]]
        if kind == "smin":
            _, k, a, b = node
            return smooth_min(
                self.node_dist(a, px, py, pz),
                self.node_dist(b, px, py, pz),
                self.smooth_k[k],
            )
        raise ValueError(node)

    def dist(self, px, py, pz):
        """Scene distance per ray: the min over top-level objects."""
        d = None
        for node in self.structure.objects:
            nd = self.node_dist(node, px, py, pz)
            d = nd if d is None else jnp.minimum(d, nd)
        if d is None:
            return jnp.full_like(px, jnp.inf)
        return d


def march_loop(scn, cfg, ro, rd):
    """The sphere-trace loop (naive_renderer.c:46-69; render/march.py
    `march`, value for value): per-ray done flags freeze converged rays,
    and the loop exits once every ray of the block is done or after
    cfg.max_steps. Returns (t, t_query, s_min, t_close). `ro`/`rd` are
    component tuples; ro may hold scalars. Done flags are f32, reduced with
    min, because bool reductions and bool loop carries do not lower on
    every kernel route."""
    ro_x, ro_y, ro_z = ro
    rdx, rdy, rdz = rd
    zeros = jnp.zeros_like(rdx)

    def cond(c):
        step, done_f = c[0], c[-1]
        return (step < cfg.max_steps) & (jnp.min(done_f) < 0.5)

    def body(c):
        step, t, t_query, s_min, t_close, done_f = c
        done = done_f > 0.5
        d = scn.dist(ro_x + t * rdx, ro_y + t * rdy, ro_z + t * rdz)
        new_t = t + d
        # angular closest approach min_i d_i/t_i (march.py)
        track = (~done) & (t > 0.0)
        s = d / jnp.where(t > 0.0, t, 1.0)
        better = track & (s < s_min)
        s_min = jnp.where(better, s, s_min)
        t_close = jnp.where(better, t, t_close)
        t_query = jnp.where(done, t_query, t)
        t = jnp.where(done, t, new_t)
        now_done = (d < cfg.epsilon) | (new_t > cfg.max_dist)
        done_f = jnp.maximum(done_f, jnp.where(now_done, 1.0, 0.0))
        return step + 1, t, t_query, s_min, t_close, done_f

    _, t, t_query, s_min, t_close, _ = lax.while_loop(
        cond, body, (0, zeros, zeros, zeros + jnp.inf, zeros, zeros)
    )
    return t, t_query, s_min, t_close


def shadow_loop(scn, cfg, so, ld, max_dist):
    """The soft-shadow loop (naive_renderer.c:71-100, including the
    first-iteration w*d/0 -> +/-inf quirk; the frozen scan of
    render/shading.py, value for value), exiting once every ray of the
    block is done. Returns (res, t_star)."""
    sox, soy, soz = so
    ldx, ldy, ldz = ld
    zeros = jnp.zeros_like(sox)
    inf = zeros + jnp.inf

    def cond(c):
        step, done_f = c[0], c[-1]
        return (step < cfg.shadow_steps) & (jnp.min(done_f) < 0.5)

    def body(c):
        step, res, t, t_star, done_f = c
        done = done_f > 0.5
        d = scn.dist(sox + t * ldx, soy + t * ldy, soz + t * ldz)
        live = t > 0.0
        safe_t = jnp.where(live, t, 1.0)
        val = jnp.where(
            live, cfg.shadow_w * d / safe_t, jnp.where(d < 0.0, -inf, inf)
        )
        better = (~done) & (val < res)
        res = jnp.where(done, res, jnp.minimum(res, val))
        t_star = jnp.where(better, t, t_star)
        t = jnp.where(done, t, t + d)
        now_done = (res < -1.0) | (t > max_dist)
        done_f = jnp.maximum(done_f, jnp.where(now_done, 1.0, 0.0))
        return step + 1, res, t, t_star, done_f

    _, res, _, t_star, _ = lax.while_loop(
        cond, body, (0, zeros + 1.0, zeros, zeros, zeros)
    )
    return res, t_star
