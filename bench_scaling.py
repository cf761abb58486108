"""Weak-scaling benchmark: rays/s at 1..N devices with fixed per-device work.

Runs the row-sharded train step (or the sharded forward) on meshes of
1, 2, 4, ... devices up to SCALE_DEVICES (default: every device), with
SCALE_ROWS image rows per device. Forward needs no communication (each
device owns its rows end to end) and the backward all-reduces only the
KB-sized scene-gradient pytree, so weak scaling should stay near 100% until
the all-reduce latency shows. It refuses to run with fewer devices than
SCALE_DEVICES asks for. Every timed call ends in `block_until_ready`.

Prints the device on one line, then one JSON line per device count:
  {"devices": n, "rays_per_s": r, "efficiency": e, ...}

Several hosts: set LOLTRACE_COORDINATOR & co. (parallel/distributed.py) in
each host's single process.
"""

import json
import os
import sys
import time

ROWS_PER_DEVICE = int(os.environ.get("SCALE_ROWS", 128))
WIDTH = int(os.environ.get("SCALE_W", 768))
MODE = os.environ.get("SCALE_MODE", "fwdbwd")
SCENE = os.environ.get("SCALE_SCENE", "examples/scene4.lol")


def main():
    import jax
    import optax

    from loltracer_tpu.utils.cache import enable_cache

    enable_cache()
    from loltracer_tpu.parallel.distributed import maybe_initialize

    if maybe_initialize():
        from loltracer_tpu.parallel.distributed import process_info

        print(json.dumps(process_info()), file=sys.stderr)
    devices = jax.devices()
    wanted = int(os.environ.get("SCALE_DEVICES", len(devices)))
    dev = devices[0]
    print(json.dumps({
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(devices),
    }))
    if len(devices) < wanted:
        raise SystemExit(
            f"SCALE_DEVICES={wanted} but JAX found {len(devices)} devices"
        )

    from loltracer_tpu.cli import _load_scene
    from loltracer_tpu.config import RenderConfig
    from loltracer_tpu.opt import masked_optimizer
    from loltracer_tpu.opt.inverse import DEFAULT_TRAINABLE
    from loltracer_tpu.parallel import make_mesh, make_sharded_train_step
    from loltracer_tpu.parallel.sharded import make_sharded_renderer

    scene = _load_scene(SCENE)
    clamp_env = os.environ.get("SCALE_CLAMP", "2.0")
    clamp = None if clamp_env.lower() in ("", "none", "0") else float(
        clamp_env
    )
    cfg = RenderConfig(
        shadow_grad="envelope",
        step_clamp=clamp if scene.structure.instanced else None,
    )

    counts = []
    n = 1
    while n <= wanted:
        counts.append(n)
        n *= 2
    base = None
    for n in counts:
        mesh = make_mesh(devices, n_devices=n)
        height = ROWS_PER_DEVICE * n  # weak scaling: fixed rows per device
        renderer = make_sharded_renderer(
            scene.structure, mesh, height, WIDTH, cfg,
            balance_params=scene.params,
        )
        if MODE == "fwd":

            def run():
                return renderer(scene.params)
        else:
            optimizer = masked_optimizer(
                optax.adam(1e-3), scene.params, DEFAULT_TRAINABLE
            )
            step = make_sharded_train_step(
                scene.structure, mesh, height, WIDTH, optimizer, cfg,
                balance_params=scene.params,
            )
            target = renderer(scene.params)
            opt_state = optimizer.init(scene.params)

            def run():
                return step(scene.params, opt_state, target)

        jax.block_until_ready(run())  # compile + warm-up
        times = []
        for _ in range(int(os.environ.get("SCALE_REPS", 3))):
            t0 = time.perf_counter()
            jax.block_until_ready(run())
            times.append(time.perf_counter() - t0)
        rps = height * WIDTH / min(times)
        if base is None:
            base = rps  # rays/s at 1 device
        print(json.dumps({
            "devices": n,
            "height": height,
            "rays_per_s": round(rps, 1),
            "efficiency": round(rps / (base * n), 3),
            "mode": MODE,
            "scene": SCENE,
        }))
        sys.stdout.flush()


if __name__ == "__main__":
    main()
