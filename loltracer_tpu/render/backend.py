"""The one place that chooses the march backend.

Names:

- "jnp": the plain XLA loops (render/march.py, render/shading.py);
- "triton": the Pallas-on-Triton value passes (render/triton_march.py),
  compiled for an NVIDIA GPU; asking for it on any other platform raises;
- "triton-interpret": the same kernels in the Pallas interpreter, on any
  platform (CPU tests). Interpret mode runs only when asked for by name;
- "auto": "triton" on a GPU, "jnp" elsewhere.

"auto" resolves from the mesh's devices when a mesh is given (that is
where a shard_map runs), else from the default device.
"""

from __future__ import annotations

from typing import Optional

import jax
from jax.sharding import Mesh

BACKENDS = ("auto", "jnp", "triton", "triton-interpret")


def _platform(mesh: Optional[Mesh]) -> str:
    if mesh is not None:
        return mesh.devices.flat[0].platform
    dev = jax.config.jax_default_device
    if dev is not None and not isinstance(dev, str):
        return dev.platform
    return jax.default_backend()


def resolve_march_backend(backend: str, mesh: Optional[Mesh] = None) -> str:
    """Map "auto" to a concrete backend and validate explicit choices."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown march_backend {backend!r}; expected one of {BACKENDS}"
        )
    if backend in ("jnp", "triton-interpret"):
        return backend
    platform = _platform(mesh)
    if backend == "triton":
        if platform != "gpu":
            raise ValueError(
                f"march_backend='triton' needs a GPU; the platform is "
                f"{platform!r} (use 'triton-interpret' to run the kernels "
                "in the interpreter)"
            )
        return backend
    return "triton" if platform == "gpu" else "jnp"
