"""Test configuration: run JAX on CPU with 8 faked devices so sharding tests
exercise a multi-device mesh without a GPU (the standard JAX substitute for
a fake distributed backend; see SURVEY.md §4)."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# tests may build N-device meshes out of the faked CPU devices; production
# launches must NOT get this fallback silently (parallel/mesh.py make_mesh)
os.environ.setdefault("LOLTRACE_CPU_FALLBACK", "1")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pathlib

import jax
import pytest

from loltracer_tpu.utils.cache import enable_cache

# Persist XLA executables across test runs (JAX_COMPILATION_CACHE_DIR when
# set, else <checkout>/.jax_cache); render-graph compiles on CPU take tens
# of seconds and dominate suite time otherwise.
enable_cache()

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"


@pytest.fixture(scope="session")
def examples_dir() -> pathlib.Path:
    return EXAMPLES


@pytest.fixture(
    scope="session", params=["scene.lol", "scene2.lol", "scene3.lol", "scene4.lol"]
)
def example_path(request) -> pathlib.Path:
    return EXAMPLES / request.param


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none. Tests that
    need the card take this fixture and carry the `gpu` marker."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs an NVIDIA GPU (run `python chip_smoke.py` there)")
    return devices[0]
