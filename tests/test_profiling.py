"""Observability: march step counts must reflect actual convergence."""

import numpy as np

from loltracer_tpu.config import RenderConfig
from loltracer_tpu.lol import parse_scene_file
from loltracer_tpu.scene import build_scene
from loltracer_tpu.utils.profiling import march_step_counts, march_step_stats


def test_step_counts_bounded_and_varied(examples_dir):
    scene = build_scene(parse_scene_file(str(examples_dir / "scene.lol")))
    steps = march_step_counts(scene.structure, scene.params, 24, 32)
    assert steps.shape == (24, 32)
    assert steps.min() >= 1
    assert steps.max() <= 256
    # the scene has sky, spheres and a near-plane: step counts must differ
    assert steps.max() > steps.min()


def test_stats_summary(examples_dir):
    scene = build_scene(parse_scene_file(str(examples_dir / "scene3.lol")))
    stats = march_step_stats(scene.structure, scene.params, 16, 128)
    assert 1 <= stats["mean_steps"] <= 256
    assert stats["p50_steps"] <= stats["p99_steps"] <= stats["max_steps"]
    assert stats["tile_waste"] >= 1.0


def test_max_steps_config_respected(examples_dir):
    scene = build_scene(parse_scene_file(str(examples_dir / "scene.lol")))
    cfg = RenderConfig(max_steps=16)
    steps = march_step_counts(scene.structure, scene.params, 12, 16, cfg)
    assert steps.max() <= 16


def test_kernel_names_in_lowered_hlo(examples_dir):
    """SURVEY §5.1: the hot-path stages must be identifiable in profiles —
    the analog of the reference's perf-jitdump symbolization of the
    generated `sdf` (jitdump.c:93-120). jax.named_scope names survive into
    the lowered module's debug metadata, which is what xprof displays."""
    import jax

    from loltracer_tpu.render.jnp_renderer import render_image

    scene = build_scene(parse_scene_file(str(examples_dir / "scene.lol")))

    def fn(params):
        return render_image(scene.structure, params, 8, 16)

    txt = jax.jit(fn).lower(scene.params).as_text(debug_info=True)
    for name in ("lol_march", "lol_shadow_march", "lol_normal", "lol_shade"):
        assert name in txt, f"{name} missing from lowered HLO metadata"
