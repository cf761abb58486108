"""THE penumbra-band definition shared by every gradient-equivalence suite
(test_train and test_instanced_fused use one band, not two that drift).

Why a band exists at all: the envelope shadow estimator re-attaches the
gradient at the frozen shadow-march argmin t* (Danskin), and a pixel only
carries that term when its recorded res0 lies strictly inside (0, 1)
(shading.soft_shadow `valid`). Two compilations of the same math (a
kernel and the whole-image XLA graph, or two batch shapes of one XLA
graph) round differently at float epsilon, so near-tied argmins (or the
res==1 lit/penumbra boundary itself) legitimately flip between them — an
O(1)-per-pixel estimator variance, not a bug (FD-validated in
tests/test_shadow_envelope.py; variance quantified in
test_train.test_penumbra_estimator_variance_bounded).

The definition:

- res == 1.0 EXACTLY is fully lit: res = min(1, min_t w*d/t) starts at 1.0
  and only moves by taking a min, so "no sampled step ever dipped below 1"
  reproduces bitwise in any compilation and carries no Danskin term.
- (-0.2, 1.0) is penumbra: an interior minimum exists (in this path), so
  the Danskin term is live and argmin near-ties can flip it.
- res <= -0.2 is deep shadow (the march early-outs below -1): shadow == 0
  on both paths, and max(res, 0) kills the gradient.
- One pixel of spatial DILATION absorbs the boundary cases the band alone
  cannot see: a pixel whose res is exactly 1.0 in THIS path but 1-epsilon
  in the other lies on the lit/penumbra boundary, hence adjacent to a
  detected penumbra pixel (penumbra bands are spatially contiguous).
"""

import jax
import jax.numpy as jnp
import numpy as np

from loltracer_tpu.render.camera import camera_rays
from loltracer_tpu.render.jnp_renderer import pixel_radius
from loltracer_tpu.render.march import intersect_aa
from loltracer_tpu.render.sdf import make_scene_sdf, make_scene_sdf_with_id
from loltracer_tpu.render.shading import shadow_march
from loltracer_tpu.render.vecmath import dot, normalize


def penumbra_pixels(res_planes: np.ndarray) -> np.ndarray:
    """[H, W] bool: pixels whose gradients are penumbra-argmin dependent.
    `res_planes` [L, H, W]: the raw (unclamped) shadow-march res per light."""
    res_planes = np.asarray(res_planes)
    pen = np.zeros(res_planes.shape[-2:], bool)
    for r in res_planes:
        pen |= (r > -0.2) & (r < 1.0)
    return _dilate(pen)


def shadow_res_planes(scene, cfg, height, width, kernel: bool):
    """[L, H, W] raw shadow res at the shaded points, as render_rays
    computes them: through the Triton kernels in the interpreter when
    `kernel`, else through the jnp loops (instanced scenes)."""
    from loltracer_tpu.render.triton_march import (
        make_triton_march,
        make_triton_shadow_march,
    )

    st = scene.structure
    clamp = cfg.step_clamp if st.instanced else None
    sclamp = cfg.effective_shadow_clamp() if st.instanced else None
    sdf = make_scene_sdf(st, clamp)
    sdf_id = make_scene_sdf_with_id(st, clamp)
    shadow_sdf = make_scene_sdf(st, sclamp)

    @jax.jit
    def run(params):
        ro, rd = camera_rays(params, height, width, cfg)
        pr = pixel_radius(params, height, cfg) if cfg.antialias else None
        march_fn = make_triton_march(st, cfg, interpret=True) if kernel \
            else None
        t, _, _, _ = intersect_aa(sdf, sdf_id, params, ro, rd, cfg, pr,
                                  march_fn=march_fn)
        p = ro + t[..., None] * rd
        out = []
        for li in range(st.num_lights):
            to_light = params.light_point[li] - p
            dist = jnp.sqrt(dot(to_light, to_light))
            ldir = normalize(to_light)
            so = p + ldir * cfg.shadow_offset
            if kernel:
                res, _ = make_triton_shadow_march(st, cfg, interpret=True)(
                    params, so, ldir, dist
                )
            else:
                res, _ = shadow_march(shadow_sdf, params, so, ldir, dist,
                                      cfg)
            out.append(res)
        return jnp.stack(out)

    return np.asarray(run(scene.params))


def _dilate(mask: np.ndarray) -> np.ndarray:
    """3x3 binary dilation (one-pixel halo), edge-padded."""
    p = np.pad(mask, 1, mode="edge")
    out = np.zeros_like(mask)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            out |= p[dy:dy + mask.shape[0], dx:dx + mask.shape[1]]
    return out
