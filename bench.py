"""Benchmark: rays/s on one GPU, forward + backward, scene4 @ 1920x1080.

Prints the device (platform, device_kind, device count) on one line, then
ONE JSON line:
  {"metric": "...", "value": N, "unit": "rays/s", "vs_baseline": N}

Each timed call renders one frame (and its gradient in fwdbwd mode) and
ends in `block_until_ready`; the best of BENCH_REPS calls is reported, after
one compile + warm-up call. It refuses to run anywhere but a GPU.

The reference publishes no numbers (BASELINE.md: `published: {}`), so
`vs_baseline` divides by a CPU baseline: native/cpu_baseline.c transcribes
the scene4 pipeline (naive_renderer.c semantics, statically-compiled SDF —
an upper bound on the reference's DynASM JIT backend) and measured 518,186
rays/s forward-only on both cores of a 2-core host (BASELINE.md). Our
metric is the strictly harder forward+backward.

Env overrides: BENCH_SCENE (path or instanced:N), BENCH_W/BENCH_H,
BENCH_MODE (fwd | fwdbwd), BENCH_REPS, BENCH_SHADOW_GRAD, BENCH_AA,
BENCH_MARCH (march backend, render/backend.py), BENCH_CLAMP (instanced
step clamp), BENCH_BAND (instanced band rows), BENCH_SHADOW_STEPS /
BENCH_MAX_STEPS (loop caps, timing-only decomposition).
"""

import json
import os
import time


def main():
    import jax
    import jax.numpy as jnp

    from loltracer_tpu.utils.cache import enable_cache

    enable_cache()
    dev = jax.devices()[0]
    print(json.dumps({
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }))
    if dev.platform != "gpu":
        raise SystemExit(
            f"bench.py measures a GPU; JAX found {dev.platform!r}"
        )

    from loltracer_tpu.cli import _load_scene
    from loltracer_tpu.config import RenderConfig
    from loltracer_tpu.render.backend import resolve_march_backend
    from loltracer_tpu.render.jnp_renderer import (
        render_image,
        render_image_banded,
    )

    scene_path = os.environ.get("BENCH_SCENE", "examples/scene4.lol")
    width = int(os.environ.get("BENCH_W", 1920))
    height = int(os.environ.get("BENCH_H", 1080))
    mode = os.environ.get("BENCH_MODE", "fwdbwd")
    reps = int(os.environ.get("BENCH_REPS", 5))
    # envelope shadows (config.py shadow_grad): forward values are bitwise
    # identical to "exact"; the backward re-attaches through one SDF eval
    # at the frozen penumbra argmin, and the frozen march runs as a kernel
    shadow_grad = os.environ.get("BENCH_SHADOW_GRAD", "envelope")
    antialias = os.environ.get("BENCH_AA", "0") == "1"
    march_backend = os.environ.get("BENCH_MARCH", "auto")
    clamp_env = os.environ.get("BENCH_CLAMP", "2.0")
    step_clamp = None if clamp_env.lower() in ("", "none", "0") else float(
        clamp_env
    )

    scene = _load_scene(scene_path)
    structure, params = scene.structure, scene.params
    cfg = RenderConfig(
        shadow_grad=shadow_grad,
        antialias=antialias,
        march_backend=march_backend,
        step_clamp=step_clamp if structure.instanced else None,
    )
    if os.environ.get("BENCH_SHADOW_STEPS"):
        cfg = cfg.replace(shadow_steps=int(os.environ["BENCH_SHADOW_STEPS"]))
    if os.environ.get("BENCH_MAX_STEPS"):
        cfg = cfg.replace(max_steps=int(os.environ["BENCH_MAX_STEPS"]))

    if structure.instanced:
        # banded rendering bounds the [pixels, object_block] temporaries
        band_rows = int(os.environ.get("BENCH_BAND", 16))
        backend = "banded-jnp"

        def render(p):
            return render_image_banded(
                structure, p, height, width, cfg, band_rows=band_rows
            )
    else:
        backend = resolve_march_backend(march_backend)

        def render(p):
            return render_image(structure, p, height, width, cfg)

    if mode == "fwd":
        fn = jax.jit(render)
    else:

        def loss(p):
            img = render(p)
            return jnp.mean(img * img)

        fn = jax.jit(jax.value_and_grad(loss))

    jax.block_until_ready(fn(params))  # compile + warm-up
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(params))
        times.append(time.perf_counter() - t0)

    rays_per_s = height * width / min(times)
    tags = ""
    if mode == "fwdbwd":
        tags += f" shadow_grad={shadow_grad}"
    if antialias:
        tags += " aa"
    if structure.instanced and step_clamp is not None:
        tags += f" clamp={step_clamp:g}"
    print(json.dumps({
        "metric": f"rays/s {dev.device_kind} {mode}/{backend} "
        f"{os.path.basename(scene_path)} {width}x{height}{tags}",
        "value": round(rays_per_s, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_s / 518186.3, 3),
    }))


if __name__ == "__main__":
    main()
