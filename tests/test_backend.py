"""March-backend choice (render/backend.py) and where it is applied
(jnp_renderer._select_march, the sharded paths): "auto" resolves by the
platform, explicit kernel backends are honoured or raise, and the
interpreter runs only when asked for by name."""

import types

import jax.numpy as jnp
import numpy as np
import pytest

from loltracer_tpu.config import RenderConfig
from loltracer_tpu.lol import parse_scene_file
from loltracer_tpu.render.backend import BACKENDS, resolve_march_backend
from loltracer_tpu.render.jnp_renderer import (
    _select_march,
    _select_shadow_march,
)
from loltracer_tpu.scene import build_scene
from loltracer_tpu.scenes import instanced_spheres


def _mesh_on(platform):
    """A stand-in mesh whose first device reports `platform`."""
    dev = types.SimpleNamespace(platform=platform)
    return types.SimpleNamespace(devices=np.asarray([dev], dtype=object))


@pytest.fixture(scope="module")
def scene(examples_dir):
    return build_scene(parse_scene_file(str(examples_dir / "scene4.lol")))


def _rays(h=4, w=8, dtype=np.float32):
    return np.zeros(3, dtype), np.ones((h, w, 3), dtype)


def test_auto_on_gpu_is_triton():
    assert resolve_march_backend("auto", _mesh_on("gpu")) == "triton"


def test_auto_on_cpu_is_jnp():
    assert resolve_march_backend("auto", _mesh_on("cpu")) == "jnp"
    # this test process runs on the CPU
    assert resolve_march_backend("auto") == "jnp"


def test_explicit_triton_off_gpu_raises():
    with pytest.raises(ValueError, match="needs a GPU"):
        resolve_march_backend("triton")
    with pytest.raises(ValueError, match="needs a GPU"):
        resolve_march_backend("triton", _mesh_on("cpu"))
    assert resolve_march_backend("triton", _mesh_on("gpu")) == "triton"


def test_interpret_only_by_name():
    assert resolve_march_backend("triton-interpret") == "triton-interpret"
    for platform in ("cpu", "gpu"):
        assert resolve_march_backend(
            "auto", _mesh_on(platform)
        ) != "triton-interpret"
    assert set(BACKENDS) == {"auto", "jnp", "triton", "triton-interpret"}


@pytest.mark.parametrize("name", ["pallas", "pallas-interpret", "cuda"])
def test_unknown_backend_raises(name):
    with pytest.raises(ValueError, match="unknown march_backend"):
        resolve_march_backend(name)


def test_auto_keeps_jnp_where_kernels_do_not_apply(scene, monkeypatch):
    """On a GPU, "auto" never raises for inputs the kernels cannot take:
    instanced scenes, f64 rays, per-ray origins."""
    import loltracer_tpu.render.backend as backend

    monkeypatch.setattr(backend, "_platform", lambda mesh: "gpu")
    cfg = RenderConfig(shadow_grad="envelope")
    ro, rd = _rays()
    assert _select_march(scene.structure, ro, rd, cfg) is not None
    inst = instanced_spheres(n=8).structure
    ro, rd = _rays()
    assert _select_march(inst, ro, rd, cfg) is None
    assert _select_shadow_march(inst, rd, cfg) is None
    ro64, rd64 = _rays(dtype=np.float64)
    assert _select_march(scene.structure, ro64, rd64, cfg) is None
    assert _select_march(scene.structure, rd, rd, cfg) is None


def test_explicit_kernel_backend_raises_where_it_does_not_apply(scene):
    cfg = RenderConfig(march_backend="triton-interpret",
                       shadow_grad="envelope")
    inst = instanced_spheres(n=8).structure
    ro, rd = _rays()
    with pytest.raises(ValueError, match="compiled scene"):
        _select_march(inst, ro, rd, cfg)
    with pytest.raises(ValueError, match="compiled scene"):
        _select_shadow_march(inst, rd, cfg)
    with pytest.raises(ValueError, match="one ray origin"):
        _select_march(scene.structure, rd, rd, cfg)


def test_kernel_selected_by_name(scene):
    ro, rd = _rays()
    cfg = RenderConfig(march_backend="triton-interpret")
    assert _select_march(scene.structure, ro, rd, cfg) is not None
    # the shadow kernel serves the envelope estimator only
    assert _select_shadow_march(scene.structure, rd, cfg) is None
    assert _select_shadow_march(
        scene.structure, rd, cfg.replace(shadow_grad="envelope")
    ) is not None
    assert _select_march(scene.structure, ro, rd,
                         cfg.replace(march_backend="jnp")) is None


def test_sharded_auto_resolves_against_the_mesh(scene):
    from loltracer_tpu.parallel.sharded import _resolve_backend

    gpu, cpu = _mesh_on("gpu"), _mesh_on("cpu")
    auto = RenderConfig()
    assert _resolve_backend(auto, gpu, scene.structure,
                            jnp.float32).march_backend == "triton"
    assert _resolve_backend(auto, cpu, scene.structure,
                            jnp.float32).march_backend == "jnp"
    inst = instanced_spheres(n=8).structure
    assert _resolve_backend(auto, gpu, inst,
                            jnp.float32).march_backend == "jnp"
    assert _resolve_backend(auto, gpu, scene.structure,
                            jnp.float64).march_backend == "jnp"
