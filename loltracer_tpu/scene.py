"""Scene compilation: AST -> (static structure, differentiable parameters).

This split is the framework's central design move, replacing the reference's
DynASM scene JIT (tracing_jit_renderer.dasc:76-143). The reference walks the
object list once at startup and emits specialized x64 for the whole scene SDF;
here the *structure* (object types, CSG tree shapes, material wiring) becomes
a static, hashable `SceneStructure` that Python control flow unrolls at JAX
trace time, while every number in the scene (positions, radii, half-extents,
smoothness, materials, lights, camera) lives in a struct-of-arrays
`SceneParams` pytree that stays a traced input. XLA then compiles one
specialized program per scene structure — the analog of the JIT — and that
single compile serves every frame *and* every gradient step, because the
parameters being inputs is what makes the renderer differentiable w.r.t. the
scene (the capability the reference lacks).

Primitive storage is struct-of-arrays across *all* primitives, including CSG
leaves: all spheres (top-level and inside smooth-union trees) share one
``sphere_point``/``sphere_radius`` array pair, so distance evaluation is one
batched op per primitive *type* regardless of scene size — the design that
scales to 10k+ instanced primitives without per-object code.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np

from loltracer_tpu.lol.ast import (
    Box,
    ObjectAst,
    Plane,
    SceneAst,
    SmoothUnion,
    Sphere,
)

# --- Static structure ------------------------------------------------------

# A node of a compiled object expression. Leaves index into the SoA primitive
# arrays; 'smin' nodes index into smooth_k and hold child nodes. These are
# plain nested tuples so SceneStructure stays hashable (jit static arg).
#   ('sphere', i) | ('box', i) | ('plane', i) | ('smin', k, a, b)
Node = Union[Tuple[str, int], Tuple[str, int, "Node", "Node"]]


@dataclasses.dataclass(frozen=True)
class SceneStructure:
    """Everything about a scene that is compiled into the program rather than
    passed as data. Hashable; equal structures can share one XLA executable."""

    num_materials: int
    num_lights: int
    num_spheres: int
    num_boxes: int
    num_planes: int
    num_unions: int
    # One compiled expression per top-level object, in file order. Object ids
    # are 1-based positions in this tuple; id 0 = ray miss
    # (naive_renderer.c:32-44).
    objects: Tuple[Node, ...]
    # material_ids[id] = material index for hit id; material_ids[0] = 0, the
    # background material (naive_renderer.c:102-112).
    material_ids: Tuple[int, ...]
    # Instanced mode (the 10k+ primitive configuration): `objects` is empty
    # and the scene is every sphere (ids 1..num_spheres, SoA order) followed
    # by every plane (ids num_spheres+1..). Evaluation is batched over the
    # object axis in fixed-size blocks (SURVEY.md §5.7 object-axis
    # chunking) instead of unrolling per-object expressions.
    instanced: bool = False
    # object-axis block size for instanced evaluation (memory/trace knob)
    instanced_block: int = 512

    @property
    def num_objects(self) -> int:
        if self.instanced:
            return self.num_spheres + self.num_planes
        return len(self.objects)


# --- Differentiable parameters ---------------------------------------------


@dataclasses.dataclass
class SceneParams:
    """Struct-of-arrays scene parameters: the differentiable input pytree.

    Arrays may be numpy (host/golden use) or jax.Array (device use); all
    renderer code treats them read-only. Field shapes:

      mat_shininess [M]      mat_diffuse [M,3]  mat_specular [M,3]
      mat_ambient   [M,3]    ambient_color [3]
      light_point [L,3]      light_diffuse [L,3]  light_specular [L,3]
      cam_point [3]          cam_direction [3]    cam_fov []
      sphere_point [Ns,3]    sphere_radius [Ns]
      box_point [Nb,3]       box_half [Nb,3]      box_radius [Nb]
      plane_y [Np]
      smooth_k [Nu]
    """

    mat_shininess: np.ndarray
    mat_diffuse: np.ndarray
    mat_specular: np.ndarray
    mat_ambient: np.ndarray
    ambient_color: np.ndarray
    light_point: np.ndarray
    light_diffuse: np.ndarray
    light_specular: np.ndarray
    cam_point: np.ndarray
    cam_direction: np.ndarray
    cam_fov: np.ndarray
    sphere_point: np.ndarray
    sphere_radius: np.ndarray
    box_point: np.ndarray
    box_half: np.ndarray
    box_radius: np.ndarray
    plane_y: np.ndarray
    smooth_k: np.ndarray


try:  # register as a JAX pytree (all fields are data)
    import jax

    jax.tree_util.register_dataclass(
        SceneParams,
        data_fields=[f.name for f in dataclasses.fields(SceneParams)],
        meta_fields=[],
    )
except ImportError:  # pragma: no cover - jax is a hard dep in practice
    pass


@dataclasses.dataclass
class Scene:
    """A compiled scene: static structure + parameter pytree."""

    structure: SceneStructure
    params: SceneParams


# --- Builder ---------------------------------------------------------------


class _Collector:
    def __init__(self) -> None:
        self.sphere_point: list = []
        self.sphere_radius: list = []
        self.box_point: list = []
        self.box_half: list = []
        self.box_radius: list = []
        self.plane_y: list = []
        self.smooth_k: list = []

    def collect(self, obj: ObjectAst) -> Node:
        if isinstance(obj, Sphere):
            i = len(self.sphere_radius)
            self.sphere_point.append(obj.point)
            self.sphere_radius.append(obj.radius)
            return ("sphere", i)
        if isinstance(obj, Box):
            i = len(self.box_radius)
            self.box_point.append(obj.point)
            self.box_half.append(obj.point2)
            self.box_radius.append(obj.radius)
            return ("box", i)
        if isinstance(obj, Plane):
            i = len(self.plane_y)
            self.plane_y.append(obj.y)
            return ("plane", i)
        if isinstance(obj, SmoothUnion):
            # Collect children first (depth-first, a then b) so leaf order is
            # deterministic; then allocate the k slot.
            a = self.collect(obj.a)
            b = self.collect(obj.b)
            k = len(self.smooth_k)
            self.smooth_k.append(obj.smoothness)
            return ("smin", k, a, b)
        raise TypeError(f"unknown object {obj!r}")


def build_scene(ast: SceneAst, dtype=np.float32) -> Scene:
    """Compile a parsed scene into structure + SoA parameters."""
    col = _Collector()
    nodes = tuple(col.collect(obj) for obj in ast.objects)

    material_ids = (0,) + tuple(obj.material for obj in ast.objects)

    structure = SceneStructure(
        num_materials=len(ast.materials),
        num_lights=len(ast.lights),
        num_spheres=len(col.sphere_radius),
        num_boxes=len(col.box_radius),
        num_planes=len(col.plane_y),
        num_unions=len(col.smooth_k),
        objects=nodes,
        material_ids=material_ids,
    )

    def arr(values, shape_tail=()):
        a = np.asarray(values, dtype=dtype)
        if a.size == 0:
            a = a.reshape((0,) + shape_tail)
        return a

    params = SceneParams(
        mat_shininess=arr([m.shininess for m in ast.materials]),
        mat_diffuse=arr([m.diffuse for m in ast.materials], (3,)),
        mat_specular=arr([m.specular for m in ast.materials], (3,)),
        mat_ambient=arr([m.ambient for m in ast.materials], (3,)),
        ambient_color=np.asarray(ast.ambient_color, dtype=dtype),
        light_point=arr([l.point for l in ast.lights], (3,)),
        light_diffuse=arr([l.diffuse_intensity for l in ast.lights], (3,)),
        light_specular=arr([l.specular_intensity for l in ast.lights], (3,)),
        cam_point=np.asarray(ast.camera.point, dtype=dtype),
        cam_direction=np.asarray(ast.camera.direction, dtype=dtype),
        cam_fov=np.asarray(ast.camera.fov, dtype=dtype),
        sphere_point=arr(col.sphere_point, (3,)),
        sphere_radius=arr(col.sphere_radius),
        box_point=arr(col.box_point, (3,)),
        box_half=arr(col.box_half, (3,)),
        box_radius=arr(col.box_radius),
        plane_y=arr(col.plane_y),
        smooth_k=arr(col.smooth_k),
    )

    return Scene(structure=structure, params=params)


def params_astype(params: SceneParams, dtype) -> SceneParams:
    """Cast every array field of a SceneParams to dtype (host-side)."""
    return SceneParams(
        **{
            f.name: np.asarray(getattr(params, f.name), dtype=dtype)
            for f in dataclasses.fields(SceneParams)
        }
    )
