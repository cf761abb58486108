"""Smoke test of the main path on an NVIDIA GPU.

    python chip_smoke.py               # one card: phases 1-6
    python chip_smoke.py --four-cards  # four cards: the sharded path only

Run from the repository root, on a machine whose JAX sees a GPU. Every
phase drives the entry points a user calls, at the flagship size (scene4
at 1920x1080), and prints one line with its compile seconds, steady
seconds and device memory. Any failed check ends the run with a non-zero
exit code; no phase's failure is caught. The last line of standard output
is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Phases (one card):
  1. device    — jax.devices(), device_kind, nvidia-smi name and power limit
  2. kernels   — the Triton march and shadow kernels against the jnp loops
  3. forward   — `loltrace render` in-process; jnp vs Triton route; the four
                 example scenes at 320x240 against the float64 golden
  4. fwdbwd    — value_and_grad, envelope shadows, jnp vs Triton route
  5. fit       — 5 Adam steps of fit_scene, checkpoint and resume
  6. instanced — instanced:10000 banded at 1080p; a window vs the golden
With --four-cards: the device phase, then the row-sharded render and train
step (LPT schedule) on four cards against the same on one card.

The float64 golden renders run in worker processes that stay on the CPU,
so only this process uses the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

SCENE4 = "examples/scene4.lol"
EXAMPLES = ("scene.lol", "scene2.lol", "scene3.lol", "scene4.lol")
H, W = 1080, 1920
SMALL_H, SMALL_W = 240, 320
INSTANCED_N = 10000
# the instanced window compared with the golden: (y0, x0, h, w)
WINDOW = (516, 928, 48, 64)

# Tolerances, float32 throughout. Triton's f32 division and sqrt need not
# round like XLA's, so a ray at the epsilon threshold can flip hit/miss.
HIT_AGREE_MIN = 0.999  # share of pixels whose hit/miss agrees
DT_REL = 1e-3  # |dt| <= DT_REL * max(1, t) on agreeing hits
SHADOW_ATOL = 1e-4  # shadow res, clamped to [0, 1] as shading uses it
# Share of penumbra pixels (0 < res < 1, where the envelope gradient is
# taken at the argmin t*) whose t* agrees within DT_REL: a near-tied argmin
# may flip between two compilations, like a hit at the epsilon threshold.
T_STAR_AGREE_MIN = 0.999
# Image vs the float64 golden: the CPU tests' atol (tests/test_jnp_renderer.py,
# tests/test_instanced.py) on all but 0.1 % of the pixels, and 1e-3 on every
# pixel. Those tests render 32x24; at 320x240 a few float32 pixels exceed
# 2e-4 (up to 0.003 % of them, at most 3.7e-4, on the CPU and on an H100
# alike). A float32 matrix product run in TF32 would put 0.4-1.2 % of the
# pixels above 2e-4, up to 1.2e-3, and fails here.
GOLDEN_ATOL = 2e-4
GOLDEN_ATOL_INSTANCED = 3e-4
GOLDEN_OUTLIER_SHARE = 1e-3
GOLDEN_OUTLIER_ATOL = 1e-3
# Image, jnp route vs Triton route: the kernels' hit/miss flips only.
ROUTE_PIXEL_ATOL = 1e-3
ROUTE_OUTLIER_SHARE = 1e-3
# Gradients of the full image, jnp route vs Triton route: per leaf,
# ||g_triton - g_jnp|| / ||g_jnp||. Both routes re-attach the same jnp
# gradient rules at the kernels' frozen values, so this bounds the
# kernels' t and t* where the gradient reads them.
GRAD_REL_L2 = 1e-3

PHASES = ("device", "kernels", "forward", "fwdbwd", "fit", "instanced")
FOUR_CARD_PHASES = ("device", "four_cards")


def select_phases(four_cards: bool):
    return FOUR_CARD_PHASES if four_cards else PHASES


def result_line(platform: str, kind: str, count: int) -> str:
    return json.dumps(
        {"ok": True,
         "device": {"platform": platform, "kind": kind, "count": count}}
    )


def nvidia_smi() -> str:
    """The card's name and power limit, from a child that never imports
    JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def march_agreement(t_ref, t_got, max_dist: float) -> dict:
    """Hit/miss agreement and the largest relative |dt| on pixels both
    call hits."""
    import numpy as np

    t_ref, t_got = np.asarray(t_ref), np.asarray(t_got)
    hit_ref, hit_got = t_ref < max_dist, t_got < max_dist
    agree = hit_ref == hit_got
    both = agree & hit_ref
    rel = np.abs(t_got - t_ref) / np.maximum(1.0, np.abs(t_ref))
    return {
        "agree": float(agree.mean()),
        "mismatched": float(1.0 - agree.mean()),
        "max_rel_dt": float(rel[both].max()) if both.any() else 0.0,
    }


def check_march(stats: dict) -> None:
    if stats["agree"] < HIT_AGREE_MIN:
        raise AssertionError(f"hit/miss agreement {stats['agree']}")
    if stats["max_rel_dt"] > DT_REL:
        raise AssertionError(f"|dt| {stats['max_rel_dt']} > {DT_REL}")


def image_close(img, ref, atol, outlier_share, outlier_atol) -> dict:
    """Pixels within `atol`, except at most `outlier_share` of them, which
    must stay within `outlier_atol`. Raises AssertionError otherwise."""
    import numpy as np

    d = np.abs(np.asarray(img, np.float64) - np.asarray(ref, np.float64))
    per_pixel = d.max(axis=-1)
    share = float((per_pixel > atol).mean())
    stats = {"max_abs": float(per_pixel.max()), "share_over_atol": share}
    if not np.isfinite(np.asarray(img)).all():
        raise AssertionError("non-finite pixels")
    if share > outlier_share or per_pixel.max() > outlier_atol:
        raise AssertionError(f"image mismatch {stats}")
    return stats


def shadow_agreement(res_ref, ts_ref, res_got, ts_got) -> dict:
    """The largest difference of the shadow res, clamped at 0 as shading
    uses it, and on penumbra pixels (0 < res_ref < 1) the share whose t*
    moved by more than DT_REL * max(1, t*)."""
    import numpy as np

    res_ref, ts_ref, res_got, ts_got = (
        np.asarray(a) for a in (res_ref, ts_ref, res_got, ts_got)
    )
    err = np.abs(np.maximum(res_got, 0.0) - np.maximum(res_ref, 0.0))
    pen = (res_ref > 0) & (res_ref < 1)
    rel = np.abs(ts_got - ts_ref) / np.maximum(1.0, np.abs(ts_ref))
    return {
        "max_abs_res": float(err.max()),
        "penumbra_share": float(pen.mean()),
        "t_star_moved": float((pen & (rel > DT_REL)).sum() / max(pen.sum(), 1)),
        "max_rel_dt_star": float(rel[pen].max()) if pen.any() else 0.0,
    }


def check_shadow(stats: dict) -> None:
    if stats["max_abs_res"] > SHADOW_ATOL:
        raise AssertionError(f"shadow res differs by {stats['max_abs_res']}")
    if stats["t_star_moved"] > 1.0 - T_STAR_AGREE_MIN:
        raise AssertionError(
            f"t* moved on {stats['t_star_moved']} of the penumbra pixels"
        )


def grads_rel_l2(g_ref, g_got, tol: float = GRAD_REL_L2) -> dict:
    """||g_got - g_ref|| / ||g_ref|| per leaf, keyed by the leaf's path.
    Raises AssertionError if a leaf is not finite or exceeds `tol`."""
    import jax
    import numpy as np

    out = {}
    got = jax.tree_util.tree_leaves(g_got)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(g_ref)[0],
                            got):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if not np.isfinite(b).all():
            raise AssertionError("non-finite gradient leaf")
        if a.size:
            out[jax.tree_util.keystr(path)] = float(
                np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-30)
            )
    bad = {k: v for k, v in out.items() if v > tol}
    if bad:
        raise AssertionError(f"gradient leaves differ: {bad}")
    return out


def grads_close(g_ref, g_got, tol: float) -> float:
    """Per leaf |g_got - g_ref| <= tol * max|g_ref|; returns the largest
    scaled error."""
    import jax
    import numpy as np

    worst = 0.0
    for a, b in zip(jax.tree_util.tree_leaves(g_ref),
                    jax.tree_util.tree_leaves(g_got)):
        a, b = np.asarray(a), np.asarray(b)
        if not np.isfinite(b).all():
            raise AssertionError("non-finite gradient leaf")
        if a.size == 0:
            continue
        scale = max(float(np.abs(a).max()), 1e-6)
        np.testing.assert_allclose(b, a, atol=tol * scale, rtol=0)
        worst = max(worst, float(np.abs(b - a).max()) / scale)
    return worst


# --- timing -----------------------------------------------------------------


def timed(fn, *args, reps: int = 10):
    """Compile `fn` for `args`, run it once, then `reps` back-to-back timed
    calls, each ending in block_until_ready; steady_s is their minimum.
    Returns (output, info)."""
    import jax
    import numpy as np

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    steady = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        steady.append(time.perf_counter() - t0)
    mem = compiled.memory_analysis()
    info = {
        "compile_s": round(compile_s, 3),
        "steady_s": min(steady),
        "median_s": float(np.median(steady)),
        "temp_bytes": getattr(mem, "temp_size_in_bytes", None),
    }
    return out, info


def peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def report(phase: str, what: str, info: dict | None = None, **extra):
    fields = dict(info or {})
    fields.update(extra)
    fields["peak_bytes_in_use"] = peak_bytes()
    print(f"[{phase}] {what} " + json.dumps(fields), flush=True)


# --- golden renders in CPU-only worker processes ----------------------------


def _worker_init():
    os.environ["JAX_PLATFORMS"] = "cpu"


def _golden_example(name: str, width: int, height: int):
    import numpy as np

    from loltracer_tpu.golden import render_golden
    from loltracer_tpu.lol import parse_scene_file
    from loltracer_tpu.scene import build_scene

    scene = build_scene(
        parse_scene_file(os.path.join("examples", name)), dtype=np.float64
    )
    return render_golden(scene, width, height)


def _golden_instanced_rows(n: int, width: int, height: int, window):
    import numpy as np

    from loltracer_tpu.golden import render_golden
    from loltracer_tpu.scene import Scene, params_astype
    from loltracer_tpu.scenes import instanced_spheres

    scene = instanced_spheres(n=n)
    scene = Scene(structure=scene.structure,
                  params=params_astype(scene.params, np.float64))
    return render_golden(scene, width, height, window=window)


def start_goldens(pool, phases):
    """Submit the golden renders the phases will compare with (AsyncResults
    of a multiprocessing pool)."""
    jobs = {}
    if "forward" in phases:
        jobs["examples"] = {
            n: pool.apply_async(_golden_example, (n, SMALL_W, SMALL_H))
            for n in EXAMPLES
        }
    if "instanced" in phases:
        y0, x0, wh, ww = WINDOW
        rows = max(1, wh // 16)
        jobs["instanced"] = [
            pool.apply_async(
                _golden_instanced_rows,
                (INSTANCED_N, W, H, (y, x0, min(rows, y0 + wh - y), ww)),
            )
            for y in range(y0, y0 + wh, rows)
        ]
    return jobs


# --- phases ------------------------------------------------------------------


def load(path):
    from loltracer_tpu.lol import parse_scene_file
    from loltracer_tpu.scene import build_scene

    return build_scene(parse_scene_file(path))


def phase_device():
    import jax

    devs = jax.devices()
    dev = devs[0]
    print(f"[device] {devs} kind={dev.device_kind!r} count={len(devs)}",
          flush=True)
    if dev.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs an NVIDIA GPU; JAX found {dev.platform!r}"
        )
    print(nvidia_smi(), flush=True)
    return dev, len(devs)


def phase_kernels():
    import jax
    import jax.numpy as jnp

    from loltracer_tpu.config import RenderConfig
    from loltracer_tpu.render.camera import camera_rays
    from loltracer_tpu.render.march import march
    from loltracer_tpu.render.sdf import make_scene_sdf
    from loltracer_tpu.render.shading import shadow_march
    from loltracer_tpu.render.triton_march import (
        make_triton_march,
        make_triton_shadow_march,
    )
    from loltracer_tpu.render.vecmath import dot, normalize

    scene = load(SCENE4)
    st, params = scene.structure, scene.params
    cfg = RenderConfig(shadow_grad="envelope")
    sdf = make_scene_sdf(st)
    ro, rd = jax.jit(lambda p: camera_rays(p, H, W, cfg))(params)

    ref, info = timed(lambda p, o, d: march(sdf, p, o, d, cfg), params, ro, rd)
    report("kernels", "jnp march", info)
    got, info = timed(make_triton_march(st, cfg), params, ro, rd)
    stats = march_agreement(ref.t, got.t, cfg.max_dist)
    report("kernels", "triton march", info, **stats)
    check_march(stats)

    p = ro + ref.t[..., None] * rd
    shadow_fn = make_triton_shadow_march(st, cfg)
    for li in range(st.num_lights):
        to_light = params.light_point[li] - p
        dist = jnp.sqrt(dot(to_light, to_light))
        ldir = normalize(to_light)
        so = p + ldir * cfg.shadow_offset
        (res_j, ts_j), info = timed(
            lambda pp, a, b, c: shadow_march(sdf, pp, a, b, c, cfg),
            params, so, ldir, dist,
        )
        report("kernels", f"jnp shadow scan light {li}", info)
        (res_t, ts_t), info = timed(shadow_fn, params, so, ldir, dist)
        stats = shadow_agreement(res_j, ts_j, res_t, ts_t)
        report("kernels", f"triton shadow light {li}", info, **stats,
               atol=SHADOW_ATOL)
        check_shadow(stats)


def phase_forward(goldens):
    import numpy as np

    from loltracer_tpu import cli
    from loltracer_tpu.config import RenderConfig
    from loltracer_tpu.render.jnp_renderer import make_renderer

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "scene4.npy")
        t0 = time.perf_counter()
        cli.main(["render", SCENE4, "--size", f"{W}x{H}", "-o", out])
        wall = time.perf_counter() - t0
        img = np.load(out)
    if img.shape != (H, W, 3) or not np.isfinite(img).all():
        raise AssertionError(f"CLI render: shape {img.shape}")
    report("forward", f"loltrace render scene4 {W}x{H} (wall, with compile)",
           wall_s=round(wall, 3))

    scene = load(SCENE4)
    imgs = {}
    for backend in ("jnp", "triton"):
        cfg = RenderConfig(march_backend=backend, shadow_grad="envelope")
        r = make_renderer(scene.structure, H, W, cfg)
        imgs[backend], info = timed(r.__wrapped__, scene.params)
        report("forward", f"scene4 {W}x{H} fwd route={backend}", info)
    stats = image_close(imgs["triton"], imgs["jnp"], ROUTE_PIXEL_ATOL,
                        ROUTE_OUTLIER_SHARE, 1.0)
    report("forward", "triton vs jnp image", None, **stats)

    cfg = RenderConfig(shadow_grad="envelope")
    failed = []
    for name in EXAMPLES:
        small = load(os.path.join("examples", name))
        img = np.asarray(
            make_renderer(small.structure, SMALL_H, SMALL_W, cfg)(
                small.params
            )
        )
        gold = goldens["examples"][name].get()
        try:
            stats = image_close(img, gold, GOLDEN_ATOL, GOLDEN_OUTLIER_SHARE,
                                GOLDEN_OUTLIER_ATOL)
        except AssertionError as e:
            failed.append(name)
            stats = {"failed": str(e)}
        report("forward", f"{name} {SMALL_W}x{SMALL_H} vs float64 golden",
               None, atol=GOLDEN_ATOL, outlier_share=GOLDEN_OUTLIER_SHARE,
               outlier_atol=GOLDEN_OUTLIER_ATOL, **stats)
    if failed:
        raise AssertionError(f"golden mismatch: {failed}")


def phase_fwdbwd():
    import jax
    import jax.numpy as jnp

    from loltracer_tpu.config import RenderConfig
    from loltracer_tpu.render.jnp_renderer import render_image

    scene = load(SCENE4)
    out = {}
    for backend in ("jnp", "triton"):
        cfg = RenderConfig(march_backend=backend, shadow_grad="envelope")

        def loss(p, cfg=cfg):
            img = render_image(scene.structure, p, H, W, cfg)
            return jnp.mean(img * img)

        out[backend], info = timed(jax.value_and_grad(loss), scene.params)
        report("fwdbwd", f"scene4 {W}x{H} value_and_grad route={backend}",
               info, loss=float(out[backend][0]))
    (l_j, g_j), (l_t, g_t) = out["jnp"], out["triton"]
    loss_rel = abs(float(l_t) - float(l_j)) / abs(float(l_j))
    rel = grads_rel_l2(g_j, g_t, GRAD_REL_L2)
    report("fwdbwd", "triton vs jnp, full image", None, loss_rel=loss_rel,
           grad_rel_l2=rel, tol=GRAD_REL_L2)
    if loss_rel > 1e-4:
        raise AssertionError(f"loss differs by {loss_rel}")


def phase_fit():
    import dataclasses

    import numpy as np

    from loltracer_tpu.config import RenderConfig
    from loltracer_tpu.opt import fit_scene
    from loltracer_tpu.render.jnp_renderer import make_renderer

    scene = load(SCENE4)
    cfg = RenderConfig(antialias=True, shadow_grad="envelope")
    sp = np.asarray(scene.params.sphere_point).copy()
    sp[:, 0] += 0.1
    perturbed = dataclasses.replace(scene.params, sphere_point=sp)
    target = make_renderer(scene.structure, H, W, cfg)(perturbed)
    with tempfile.TemporaryDirectory() as tmp:
        # the sphere positions were perturbed, so they are what is fitted
        fit_kw = dict(
            cfg=cfg, learning_rate=2e-2, trainable=("sphere_point",),
            checkpoint_path=os.path.join(tmp, "fit.ckpt"),
            checkpoint_every=3,
        )
        t0 = time.perf_counter()
        first = fit_scene(scene.structure, scene.params, target, steps=5,
                          **fit_kw)
        wall = time.perf_counter() - t0
        losses = first.losses
        report("fit", f"5 Adam steps scene4 {W}x{H} (wall, with compile)",
               None, wall_s=round(wall, 3), losses=[float(x) for x in losses])
        if not losses[-1] < losses[0]:
            raise AssertionError(f"loss did not decrease: {losses}")
        t0 = time.perf_counter()
        resumed = fit_scene(scene.structure, scene.params, target, steps=5,
                            **fit_kw)
        wall = time.perf_counter() - t0
    report("fit", "resume from step 3", None, wall_s=round(wall, 3),
           losses=[float(x) for x in resumed.losses])
    np.testing.assert_allclose(resumed.losses, losses[3:], rtol=1e-4)


def phase_instanced(goldens):
    import jax
    import numpy as np

    from loltracer_tpu.config import RenderConfig
    from loltracer_tpu.render.camera import camera_rays
    from loltracer_tpu.render.jnp_renderer import (
        render_image_banded,
        render_rays,
    )
    from loltracer_tpu.scenes import instanced_spheres

    scene = instanced_spheres(n=INSTANCED_N)
    st = scene.structure
    cfg = RenderConfig(step_clamp=2.0)
    img, info = timed(
        lambda p: render_image_banded(st, p, H, W, cfg, band_rows=16),
        scene.params, reps=1,
    )
    if img.shape != (H, W, 3) or not np.isfinite(np.asarray(img)).all():
        raise AssertionError("instanced render not finite")
    report("instanced", f"instanced:{INSTANCED_N} {W}x{H} clamp=2 banded fwd",
           info)

    exact = RenderConfig()
    y0, x0, wh, ww = WINDOW

    def window(p):
        ro, rd = camera_rays(p, H, W, exact)
        return render_rays(st, p, ro, rd[y0:y0 + wh, x0:x0 + ww], exact)

    win, info = timed(window, scene.params, reps=1)
    gold = np.concatenate([f.get() for f in goldens["instanced"]], axis=0)
    stats = image_close(win, gold, GOLDEN_ATOL_INSTANCED,
                        GOLDEN_OUTLIER_SHARE, GOLDEN_OUTLIER_ATOL)
    report("instanced", f"{wh}x{ww} window, exact, vs float64 golden", info,
           atol=GOLDEN_ATOL_INSTANCED, outlier_share=GOLDEN_OUTLIER_SHARE,
           outlier_atol=GOLDEN_OUTLIER_ATOL, **stats)


def phase_four_cards():
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from loltracer_tpu.config import RenderConfig
    from loltracer_tpu.opt import masked_optimizer
    from loltracer_tpu.opt.inverse import DEFAULT_TRAINABLE
    from loltracer_tpu.parallel import (
        make_mesh,
        make_sharded_renderer,
        make_sharded_train_step,
    )
    from loltracer_tpu.parallel.sharded import make_sharded_loss
    from loltracer_tpu.render.jnp_renderer import make_renderer, render_image

    if len(jax.devices()) < 4:
        raise SystemExit(
            f"--four-cards needs 4 GPUs; JAX found {len(jax.devices())}"
        )
    scene = load(SCENE4)
    st, params = scene.structure, scene.params
    cfg = RenderConfig(antialias=True, shadow_grad="envelope")
    mesh = make_mesh(n_devices=4)

    sharded = make_sharded_renderer(st, mesh, H, W, cfg,
                                    balance_params=params)
    img4, info = timed(sharded.__wrapped__, params)
    report("four_cards", f"sharded render 4 cards {W}x{H}", info)
    img1, info = timed(make_renderer(st, H, W, cfg).__wrapped__, params)
    report("four_cards", f"render 1 card {W}x{H}", info)
    stats = image_close(img4, img1, 1e-4, ROUTE_OUTLIER_SHARE, 1.0)
    report("four_cards", "4-card vs 1-card image", None, **stats)

    sp = np.asarray(params.sphere_point).copy()
    sp[:, 0] += 0.1
    target = jnp.asarray(img1)
    start = dataclasses.replace(params, sphere_point=sp)
    loss4 = make_sharded_loss(st, mesh, H, W, cfg, balance_params=params)
    (l4, g4), info = timed(jax.value_and_grad(loss4), start, target)
    report("four_cards", "sharded value_and_grad 4 cards", info)

    def loss1(p, tgt):
        return jnp.mean((render_image(st, p, H, W, cfg) - tgt) ** 2)

    (l1, g1), info = timed(jax.value_and_grad(loss1), start, target)
    report("four_cards", "value_and_grad 1 card", info)
    loss_rel = abs(float(l4) - float(l1)) / abs(float(l1))
    worst = grads_close(g1, g4, tol=1e-3)
    report("four_cards", "4-card vs 1-card loss and gradient", None,
           loss_rel=loss_rel, grad_worst_scaled=worst, tol=1e-3)
    if loss_rel > 1e-5:
        raise AssertionError(f"loss differs by {loss_rel}")

    optimizer = masked_optimizer(optax.adam(1e-2), params, DEFAULT_TRAINABLE)
    step = make_sharded_train_step(st, mesh, H, W, optimizer, cfg,
                                   balance_params=params)
    state = optimizer.init(start)
    (p2, _, loss), info = timed(step.__wrapped__, start, state, target)
    for leaf in jax.tree_util.tree_leaves(p2):
        if not np.isfinite(np.asarray(leaf)).all():
            raise AssertionError("non-finite parameters after the step")
    report("four_cards", "sharded train step 4 cards (LPT rows)", info,
           loss=float(loss))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--four-cards", action="store_true",
        help="run only the sharded path on four cards (and its one-card "
        "comparison)",
    )
    args = parser.parse_args(argv)
    phases = select_phases(args.four_cards)

    from loltracer_tpu.utils.cache import enable_cache

    enable_cache()
    dev, count = phase_device()

    import multiprocessing

    workers = max(1, min(16, (os.cpu_count() or 2) - 1))
    pool = multiprocessing.get_context("spawn").Pool(
        workers, initializer=_worker_init
    )
    try:
        goldens = start_goldens(pool, phases)
        for name in phases[1:]:
            t0 = time.perf_counter()
            if name == "kernels":
                phase_kernels()
            elif name == "forward":
                phase_forward(goldens)
            elif name == "fwdbwd":
                phase_fwdbwd()
            elif name == "fit":
                phase_fit()
            elif name == "instanced":
                phase_instanced(goldens)
            elif name == "four_cards":
                phase_four_cards()
            print(f"[{name}] passed in {time.perf_counter() - t0:.1f}s",
                  flush=True)
    finally:
        pool.terminate()
        pool.join()

    print(result_line(dev.platform, dev.device_kind, count))
    return 0


if __name__ == "__main__":
    sys.exit(main())
