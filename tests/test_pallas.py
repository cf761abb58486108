"""The kernel route renders what the jnp route renders (interpret mode on
CPU): march_backend="triton-interpret" swaps both march value passes for
the Pallas-on-Triton kernels (render/triton_march.py) inside the same
render path. Per-scene equality is pinned in tests/test_train.py; these
cases cover sizes that do not divide the kernel's pixel patches, and a
non-default loop configuration."""

import numpy as np
import pytest

from loltracer_tpu.config import RenderConfig
from loltracer_tpu.lol import parse_scene_file
from loltracer_tpu.render.jnp_renderer import make_renderer
from loltracer_tpu.scene import build_scene

H, W = 16, 128

KERNEL = "triton-interpret"


@pytest.fixture(scope="module")
def scenes(examples_dir):
    return {
        name: build_scene(parse_scene_file(str(examples_dir / name)))
        for name in ["scene.lol", "scene2.lol"]
    }


def _pair(scene, h, w, cfg):
    ref = np.asarray(
        make_renderer(scene.structure, h, w, cfg.replace(march_backend="jnp"))(
            scene.params
        )
    )
    pal = np.asarray(
        make_renderer(
            scene.structure, h, w,
            cfg.replace(march_backend=KERNEL, shadow_grad="envelope"),
        )(scene.params)
    )
    return pal, ref


def test_pallas_nonaligned_size(scenes):
    """Sizes that don't divide the kernel's pixel patch pad internally and
    crop."""
    h, w = 13, 150
    pal, ref = _pair(scenes["scene.lol"], h, w, RenderConfig())
    assert pal.shape == (h, w, 3)
    np.testing.assert_allclose(pal, ref, atol=5e-5)


def test_pallas_custom_config(scenes):
    cfg = RenderConfig(max_steps=64, shadow_steps=32, gamma=1.0)
    pal, ref = _pair(scenes["scene2.lol"], H, W, cfg)
    np.testing.assert_allclose(pal, ref, atol=5e-5)
