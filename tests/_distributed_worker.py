"""Worker for the two-process jax.distributed loopback test.

Launched twice by tests/test_distributed.py with LOLTRACE_COORDINATOR /
LOLTRACE_NUM_PROCESSES / LOLTRACE_PROCESS_ID pointing at localhost: each
process contributes 4 faked CPU devices, builds the global (hosts, chips)
mesh, runs the row-sharded renderer and one sharded train step, and checks
the results against a purely LOCAL single-device computation — proving the
cross-process collectives (gloo over loopback, standing in for the network
between hosts) change nothing. Prints one JSON line on success."""

import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
).strip()

import numpy as np


def main():
    import jax

    from loltracer_tpu.parallel import maybe_initialize

    assert maybe_initialize(), "worker requires LOLTRACE_COORDINATOR"
    assert jax.process_count() == 2, jax.process_count()

    jax.config.update("jax_default_device", jax.local_devices()[0])
    from loltracer_tpu.utils.cache import enable_cache

    enable_cache()

    import jax.numpy as jnp
    import optax

    from loltracer_tpu.config import RenderConfig
    from loltracer_tpu.lol import parse_scene_file
    from loltracer_tpu.opt import masked_optimizer
    from loltracer_tpu.parallel import make_mesh_2d, make_sharded_train_step
    from loltracer_tpu.parallel.sharded import make_sharded_loss
    from loltracer_tpu.render.jnp_renderer import render_image
    from loltracer_tpu.scene import build_scene

    scene = build_scene(
        parse_scene_file(
            os.path.join(
                os.path.dirname(__file__), "..", "examples", "scene3.lol"
            )
        )
    )
    H, W = 16, 64
    cfg = RenderConfig(antialias=True)

    mesh = make_mesh_2d()
    assert mesh.devices.shape == (2, 4), mesh.devices.shape

    # local single-device reference (no mesh, no collectives)
    target = np.asarray(
        jax.jit(
            lambda p: render_image(scene.structure, p, H, W, cfg)
        )(scene.params)
    )

    # sharded loss across both processes must match the local loss
    loss_fn = make_sharded_loss(scene.structure, mesh, H, W, cfg)
    sharded_loss = float(jax.jit(loss_fn)(scene.params, jnp.zeros_like(
        jnp.asarray(target)
    )))
    local_loss = float(np.mean(target**2))
    assert abs(sharded_loss - local_loss) < 1e-6, (sharded_loss, local_loss)

    # one sharded train step: loss against the rendered target is ~0, and
    # the replicated parameter update must be finite and identical across
    # processes (checked implicitly: both processes assert the same values)
    optimizer = masked_optimizer(
        optax.adam(1e-2), scene.params, ("sphere_point",)
    )
    step = make_sharded_train_step(
        scene.structure, mesh, H, W, optimizer, cfg
    )
    state = optimizer.init(scene.params)
    params2, state, loss0 = step(
        scene.params, state, jnp.asarray(target)
    )
    loss0 = float(loss0)
    assert loss0 < 1e-10, loss0
    leaves = jax.tree_util.tree_leaves(params2)
    assert all(np.isfinite(np.asarray(l)).all() for l in leaves)

    # --- the kernel route across the process-spanning mesh: one train
    # step through make_sharded_train_step with both march value passes on
    # the Triton kernels (in the interpreter here) on scene4, and one on an
    # instanced scene (banded jnp rows), each compared against a local
    # single-device step with the identical loss/optimizer.
    import dataclasses

    from loltracer_tpu.render.jnp_renderer import render_image_banded

    def step_check(structure, params, Hc, Wc, cfg_c, render_single):
        single = lambda p: render_single(structure, p, Hc, Wc, cfg_c)
        target_c = jax.jit(single)(params)
        perturbed = dataclasses.replace(
            params,
            sphere_point=params.sphere_point + np.float32(0.05),
        )
        opt_c = masked_optimizer(
            optax.adam(1e-2), params, ("sphere_point",)
        )
        step_c = make_sharded_train_step(
            structure, mesh, Hc, Wc, opt_c, cfg_c
        )
        p_sh, _, loss_sh = step_c(
            perturbed, opt_c.init(perturbed), target_c
        )

        @jax.jit
        def local_step(p, s, tgt):
            def loss(p):
                return jnp.mean((single(p) - tgt) ** 2)

            l, g = jax.value_and_grad(loss)(p)
            updates, s = opt_c.update(g, s, p)
            return optax.apply_updates(p, updates), s, l

        p_lo, _, loss_lo = local_step(
            perturbed, opt_c.init(perturbed), target_c
        )
        dl = abs(float(loss_sh) - float(loss_lo))
        assert dl < 1e-6, (float(loss_sh), float(loss_lo))
        dp = max(
            float(np.abs(np.asarray(a) - np.asarray(b)).max())
            for a, b in zip(
                jax.tree_util.tree_leaves(p_sh),
                jax.tree_util.tree_leaves(p_lo),
            )
            if np.asarray(a).size
        )
        assert dp < 1e-5, dp
        return float(loss_sh), dl, dp

    scene4 = build_scene(
        parse_scene_file(
            os.path.join(
                os.path.dirname(__file__), "..", "examples", "scene4.lol"
            )
        )
    )
    kernel_loss, kernel_dl, kernel_dp = step_check(
        scene4.structure, scene4.params, 32, 128,
        RenderConfig(
            shadow_grad="envelope", march_backend="triton-interpret"
        ),
        render_image,
    )

    from loltracer_tpu.scenes import instanced_spheres

    inst = instanced_spheres(n=150, seed=8)
    inst_loss, inst_dl, inst_dp = step_check(
        inst.structure, inst.params, 128, 32,
        RenderConfig(shadow_grad="envelope", step_clamp=2.0),
        render_image_banded,
    )

    print(
        json.dumps(
            {
                "process": jax.process_index(),
                "devices": len(jax.devices()),
                "sharded_loss": sharded_loss,
                "local_loss": local_loss,
                "step_loss": loss0,
                "kernel_loss": kernel_loss,
                "kernel_loss_diff": kernel_dl,
                "kernel_param_diff": kernel_dp,
                "instanced_loss": inst_loss,
                "instanced_loss_diff": inst_dl,
                "instanced_param_diff": inst_dp,
                "ok": True,
            }
        )
    )


if __name__ == "__main__":
    main()
