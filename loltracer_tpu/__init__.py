"""loltracer: a differentiable sphere-tracing framework for NVIDIA GPUs.

Reproduces the capabilities of the reference `loltracer` (an interactive
C11/SSE CPU ray-marcher with a DynASM x64 scene JIT) as an idiomatic
JAX/XLA/Pallas framework:

- the `.lol` scene DSL parses to a typed AST (`loltracer_tpu.lol`),
- the AST compiles to a struct-of-arrays differentiable scene pytree plus a
  static scene structure (`loltracer_tpu.scene`) — tracing that structure into
  XLA replaces the reference's runtime x64 code generation,
- rendering is a vectorized sphere-trace (`loltracer_tpu.render`) with
  soft shadows, tetrahedron normals and Blinn-Phong shading, forward and
  backward, with Pallas-on-Triton kernels for the two marches,
- images shard over device meshes (`loltracer_tpu.parallel`),
- inverse rendering recovers scene parameters from images
  (`loltracer_tpu.opt`).
"""

from loltracer_tpu.config import RenderConfig
from loltracer_tpu.lol.parser import parse_scene, parse_scene_file
from loltracer_tpu.scene import build_scene, Scene

__all__ = [
    "RenderConfig",
    "parse_scene",
    "parse_scene_file",
    "build_scene",
    "Scene",
]

__version__ = "0.1.0"
