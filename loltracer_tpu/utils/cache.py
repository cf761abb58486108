"""Persistent XLA compilation cache.

Scene-renderer graphs (256-step march while_loop + 128-step shadow scan,
forward and backward) take seconds to compile on a GPU and tens of seconds
on CPU. One compile per (scene structure, image shape) is the design — the
cache makes that one-time across processes.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing
is set here. Otherwise the cache lives at the fixed path
`<checkout>/.jax_cache`: the path is part of the cache key, so a directory
that moves never hits.
"""

from __future__ import annotations

import os
import pathlib

DEFAULT_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str | None:
    """The directory `enable_cache` sets, or None when the environment
    already names one."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return str(DEFAULT_CACHE_DIR)


def enable_cache() -> None:
    import jax

    path = cache_dir()
    if path is None:
        return
    pathlib.Path(path).mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
