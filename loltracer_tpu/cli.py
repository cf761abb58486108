"""Command-line interface.

The reference's CLI is `./main [num_threads] [scene.lol]` opening an SDL
window (main.c:223-242). Here:

    loltrace render scene.lol --size 640x480 -o out.png [--backend ...]
    loltrace view scene.lol --size 96x72          # interactive terminal
    loltrace fit scene.lol --target target.png    # inverse rendering
    loltrace bench scene.lol --size 1920x1080 --mode fwdbwd
    loltrace info scene.lol                       # parsed scene summary

Render constants that the reference hardcodes (march steps, epsilon, shadow
params, gamma — SURVEY.md §2.1.6) are CLI flags here.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


def _parse_size(s: str):
    w, h = s.lower().split("x")
    return int(w), int(h)


def _build_cfg(args):
    from loltracer_tpu.config import RenderConfig

    kw = {}
    for field in (
        "max_steps",
        "epsilon",
        "max_dist",
        "shadow_steps",
        "shadow_w",
        "gamma",
    ):
        v = getattr(args, field, None)
        if v is not None:
            kw[field] = v
    if getattr(args, "aa", False):
        kw["antialias"] = True
    sc = getattr(args, "step_clamp", None)
    if sc is not None:
        kw["step_clamp"] = None if sc <= 0 else sc
    if getattr(args, "tan_fov", False):
        kw["atan_fov"] = False
    return RenderConfig(**kw)


def _load_scene(path, dtype=None):
    import numpy as np

    from loltracer_tpu.lol import parse_scene_file
    from loltracer_tpu.scene import build_scene

    if str(path).startswith("instanced:"):
        # procedural 10k+ primitive configuration, e.g. `instanced:10000`
        # (BASELINE config 5; scenes.instanced_spheres)
        from loltracer_tpu.scenes import instanced_spheres

        return instanced_spheres(n=int(str(path).split(":")[1]))
    ast = parse_scene_file(path)
    return build_scene(ast, dtype=dtype or np.float32)


def _add_render_flags(p):
    p.add_argument("--size", default="640x480", help="WxH (default 640x480)")
    p.add_argument("--aa", action="store_true", help="soft-coverage antialiasing")
    p.add_argument(
        "--step-clamp", type=float, default=None, dest="step_clamp",
        help="instanced scenes: sphere-set step clamp (config.py "
        "step_clamp; <=0 for exact; default exact)",
    )
    p.add_argument("--tan-fov", action="store_true",
                   help="standard tan() pinhole instead of the reference's atan quirk")
    p.add_argument("--max-steps", type=int, dest="max_steps")
    p.add_argument("--epsilon", type=float)
    p.add_argument("--max-dist", type=float, dest="max_dist")
    p.add_argument("--shadow-steps", type=int, dest="shadow_steps")
    p.add_argument("--shadow-w", type=float, dest="shadow_w")
    p.add_argument("--gamma", type=float)


def cmd_render(args):
    import numpy as np

    from loltracer_tpu.utils.image import write_npy, write_png

    w, h = _parse_size(args.size)
    cfg = _build_cfg(args)
    scene = _load_scene(args.scene)

    t0 = time.perf_counter()
    if args.backend == "golden":
        from loltracer_tpu.golden import render_golden
        from loltracer_tpu.scene import params_astype

        scene.params = params_astype(scene.params, np.float64)
        img = render_golden(scene, w, h, cfg)
    else:
        from loltracer_tpu.render.jnp_renderer import make_renderer

        cfg = cfg.replace(march_backend=args.backend).for_forward()
        img = np.asarray(make_renderer(scene.structure, h, w, cfg)(scene.params))
    dt = time.perf_counter() - t0

    out = args.output or "out.png"
    if out.endswith(".npy"):
        write_npy(out, img)
    else:
        write_png(out, img)
    print(f"rendered {args.scene} {w}x{h} in {dt:.2f}s -> {out}")


def cmd_view(args):
    from loltracer_tpu.interactive import run_viewer

    # no --size: follow the live terminal size every frame (the
    # reference's per-frame surface re-fetch, main.c:182)
    w = h = None
    if args.size:
        w, h = _parse_size(args.size)
    run_viewer(_load_scene(args.scene), w, h, _build_cfg(args))


def cmd_info(args):
    scene = _load_scene(args.scene)
    st = scene.structure
    print(json.dumps(
        {
            "materials": st.num_materials,
            "lights": st.num_lights,
            "objects": st.num_objects,
            "spheres": st.num_spheres,
            "boxes": st.num_boxes,
            "planes": st.num_planes,
            "smooth_unions": st.num_unions,
            "object_exprs": [repr(o) for o in st.objects],
        },
        indent=2,
    ))


def cmd_fit(args):
    import numpy as np

    from loltracer_tpu.opt import fit_scene
    from loltracer_tpu.utils.image import read_png, write_png

    scene = _load_scene(args.scene)
    cfg = _build_cfg(args)

    if args.target.endswith(".npy"):
        target = np.load(args.target)
    else:
        target = read_png(args.target).astype(np.float32) / 255.0

    trainable = tuple(args.trainable.split(",")) if args.trainable else None
    kw = {} if trainable is None else {"trainable": trainable}
    result = fit_scene(
        scene.structure,
        scene.params,
        target,
        steps=args.steps,
        learning_rate=args.lr,
        cfg=cfg,
        checkpoint_path=args.checkpoint,
        log_every=max(1, args.steps // 20),
        **kw,
    )
    print(f"final loss: {result.losses[-1]:.6g}")
    if args.output:
        from loltracer_tpu.render.jnp_renderer import make_renderer

        h, w = target.shape[:2]
        img = np.asarray(
            make_renderer(scene.structure, h, w, cfg.for_forward())(
                result.params
            )
        )
        write_png(args.output, img)
        print(f"fitted render -> {args.output}")


def cmd_stats(args):
    from loltracer_tpu.utils.profiling import march_step_stats

    w, h = _parse_size(args.size)
    cfg = _build_cfg(args)
    scene = _load_scene(args.scene)
    stats = march_step_stats(scene.structure, scene.params, h, w, cfg)
    print(json.dumps(stats, indent=2))


def cmd_bench(args):
    import os

    os.environ.setdefault("BENCH_SCENE", args.scene)
    if args.size:
        w, h = _parse_size(args.size)
        os.environ["BENCH_W"], os.environ["BENCH_H"] = str(w), str(h)
    os.environ.setdefault("BENCH_MODE", args.mode)
    import bench

    bench.main()


def main(argv=None):
    from loltracer_tpu.utils.cache import enable_cache

    enable_cache()
    # Multi-host bootstrap (no-op unless LOLTRACE_COORDINATOR /
    # LOLTRACE_DISTRIBUTED is set): after this, jax.devices() spans every
    # process's devices (parallel/distributed.py).
    from loltracer_tpu.parallel.distributed import maybe_initialize

    maybe_initialize()
    parser = argparse.ArgumentParser(prog="loltrace")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render a scene to PNG/NPY")
    p.add_argument(
        "scene", nargs="?", default="-",
        help=".lol file; '-' or omitted reads stdin (scene-parser.y:200-203)",
    )
    p.add_argument("-o", "--output")
    p.add_argument(
        "--backend",
        choices=["auto", "jnp", "triton", "triton-interpret", "golden"],
        default="auto",
        help="march backend (render/backend.py), or the float64 golden",
    )
    _add_render_flags(p)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("view", help="interactive terminal preview")
    p.add_argument("scene")
    _add_render_flags(p)
    p.set_defaults(fn=cmd_view, size=None)

    p = sub.add_parser("info", help="parsed scene summary")
    p.add_argument("scene", nargs="?", default="-")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("fit", help="inverse rendering toward a target image")
    p.add_argument("scene")
    p.add_argument("--target", required=True, help="target image (.png/.npy)")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--trainable", help="comma-separated param fields")
    p.add_argument("--checkpoint")
    p.add_argument("-o", "--output", help="write fitted render")
    _add_render_flags(p)
    p.set_defaults(fn=cmd_fit, aa=True)

    p = sub.add_parser(
        "stats", help="march-step histogram / block occupancy diagnostics"
    )
    p.add_argument("scene")
    _add_render_flags(p)
    p.set_defaults(fn=cmd_stats, size="320x240")

    p = sub.add_parser("bench", help="throughput benchmark")
    p.add_argument("scene")
    p.add_argument("--size")
    p.add_argument("--mode", choices=["fwd", "fwdbwd"], default="fwdbwd")
    p.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
