"""Pallas-on-Triton value passes: the primary march and the shadow march.

The differentiable render path (render/march.py intersect_aa, and
render/shading.py soft_shadow with shadow_grad="envelope") freezes both
marches and re-attaches gradients in jnp, so each march is a pure value
computation and can run as a kernel with no backward of its own.

The kernels follow the textbook GPU sphere tracer: one ray per thread,
ray state in registers, and an exit per block once every ray of the block
is done. The plain XLA formulation runs one `while_loop` over the whole
image, bound by its worst ray, and carries every ray's state through
device memory on each step; its shadow march never exits early at all.

Layout: rays are taken in compact pixel patches (`BLOCK_PATCHES`) so the
rays of a block, and of a warp, stay coherent, and flattened into 1-D
power-of-two blocks. The scene numbers are packed into one small f32
vector, read once per block before the loop (render/scalar_scene.py).

Per pixel the values match the jnp loops: same update order, same
done-freezing, same closest-approach tracking.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from loltracer_tpu.config import DEFAULT_CONFIG, RenderConfig
from loltracer_tpu.render.march import MarchResult
from loltracer_tpu.render.scalar_scene import (
    ScalarScene,
    march_loop,
    pack_geometry,
    shadow_loop,
    unpack_geometry,
)
from loltracer_tpu.scene import SceneParams, SceneStructure

# Rays per block -> the (rows, cols) pixel patch a block covers.
BLOCK_PATCHES = {
    64: (8, 8),
    128: (8, 16),
    256: (16, 16),
    512: (16, 32),
}
DEFAULT_BLOCK = 128
# warps per program: 4 (128 threads) measured best with 128-ray blocks
NUM_WARPS = 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def to_blocks(plane, ph: int, pw: int):
    """[H, W] -> [N]: edge-pad to whole (ph, pw) patches and flatten patch
    by patch, so each run of ph*pw rays is one spatial patch. Padded rays
    repeat their edge neighbours, so they finish with them."""
    h, w = plane.shape
    gh, gw = _cdiv(h, ph), _cdiv(w, pw)
    if (gh * ph, gw * pw) != (h, w):
        plane = jnp.pad(plane, ((0, gh * ph - h), (0, gw * pw - w)),
                        mode="edge")
    a = plane.reshape(gh, ph, gw, pw).transpose(0, 2, 1, 3)
    return a.reshape(-1)


def from_blocks(flat, h: int, w: int, ph: int, pw: int):
    """Inverse of `to_blocks`, cropped back to [h, w]."""
    gh, gw = _cdiv(h, ph), _cdiv(w, pw)
    a = flat.reshape(gh, gw, ph, pw).transpose(0, 2, 1, 3)
    return a.reshape(gh * ph, gw * pw)[:h, :w]


def _scalar_pack(*parts):
    """Concatenate f32 vectors and pad to a power-of-two length (a kernel
    block must have a power-of-two size)."""
    flat = jnp.concatenate([jnp.ravel(p).astype(jnp.float32) for p in parts])
    n = flat.shape[0]
    size = max(16, _next_pow2(n))
    return jnp.pad(flat, (0, size - n))


def _call(kernel, n_in_planes, n_out, n_rays, block, pack, planes,
          interpret, name):
    """One pallas_call over [N] ray planes on the Triton route."""
    grid = (n_rays // block,)
    ray_spec = pl.BlockSpec((block,), lambda i: (i,))
    in_specs = [pl.BlockSpec(pack.shape, lambda i: (0,))]
    in_specs += [ray_spec] * n_in_planes
    return pl.pallas_call(
        kernel,
        grid=grid,
        in_specs=in_specs,
        out_specs=[ray_spec] * n_out,
        out_shape=[jax.ShapeDtypeStruct((n_rays,), jnp.float32)] * n_out,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1
        ),
        interpret=interpret,
        name=name,
    )(pack, *planes)


def _check_block(block: int):
    if block not in BLOCK_PATCHES:
        raise ValueError(
            f"block must be one of {sorted(BLOCK_PATCHES)}; got {block}"
        )


def _march_kernel(structure, cfg, pack_ref, rdx_ref, rdy_ref, rdz_ref,
                  t_ref, tq_ref, smin_ref, tc_ref):
    ro = (pack_ref[0], pack_ref[1], pack_ref[2])
    scn = ScalarScene(
        structure, unpack_geometry(structure, lambda i: pack_ref[i], 3)
    )
    rd = (rdx_ref[...], rdy_ref[...], rdz_ref[...])
    t, t_query, s_min, t_close = march_loop(scn, cfg, ro, rd)
    t_ref[...] = t
    tq_ref[...] = t_query
    smin_ref[...] = s_min
    tc_ref[...] = t_close


def _shadow_kernel(structure, cfg, pack_ref, sox_ref, soy_ref, soz_ref,
                   ldx_ref, ldy_ref, ldz_ref, maxd_ref, res_ref, ts_ref):
    scn = ScalarScene(
        structure, unpack_geometry(structure, lambda i: pack_ref[i])
    )
    so = (sox_ref[...], soy_ref[...], soz_ref[...])
    ld = (ldx_ref[...], ldy_ref[...], ldz_ref[...])
    res, t_star = shadow_loop(scn, cfg, so, ld, maxd_ref[...])
    res_ref[...] = res
    ts_ref[...] = t_star


def _check_structure(structure: SceneStructure):
    if structure.instanced:
        raise ValueError(
            "the Triton march kernels compile the unrolled SDF of a "
            "compiled scene; instanced scenes use the jnp path"
        )


def make_triton_march(
    structure: SceneStructure,
    cfg: RenderConfig = DEFAULT_CONFIG,
    interpret: bool = False,
    block: int = DEFAULT_BLOCK,
) -> Callable:
    """Build `march_fn(params, ro [3], rd [H, W, 3]) -> MarchResult`, the
    primary march as a Triton kernel (interpret=True runs it in the Pallas
    interpreter). Value-only: the caller stop-gradients inputs and
    outputs."""
    _check_structure(structure)
    _check_block(block)
    ph, pw = BLOCK_PATCHES[block]
    kernel = functools.partial(_march_kernel, structure, cfg)

    def march_fn(params: SceneParams, ro, rd) -> MarchResult:
        h, w = rd.shape[0], rd.shape[1]
        rd = rd.astype(jnp.float32)
        planes = [to_blocks(rd[..., i], ph, pw) for i in range(3)]
        n = planes[0].shape[0]
        pack = _scalar_pack(
            jnp.asarray(ro, jnp.float32), pack_geometry(structure, params)
        )
        outs = _call(kernel, 3, 4, n, block, pack, planes, interpret,
                     "lol_march_triton")
        t, t_query, s_min, t_close = (
            from_blocks(o, h, w, ph, pw) for o in outs
        )
        return MarchResult(t=t, t_query=t_query, s_min=s_min, t_close=t_close)

    return march_fn


def make_triton_shadow_march(
    structure: SceneStructure,
    cfg: RenderConfig = DEFAULT_CONFIG,
    interpret: bool = False,
    block: int = DEFAULT_BLOCK,
) -> Callable:
    """Build `shadow_fn(params, ro [H, W, 3], rd [H, W, 3], max_dist
    [H, W]) -> (res [H, W], t_star [H, W])`: the frozen soft-shadow march
    of the envelope gradient estimator (shading.py soft_shadow) as a Triton
    kernel. Value-only: the caller stop-gradients inputs and outputs."""
    _check_structure(structure)
    _check_block(block)
    ph, pw = BLOCK_PATCHES[block]
    kernel = functools.partial(_shadow_kernel, structure, cfg)

    def shadow_fn(params: SceneParams, ro, rd, max_dist):
        h, w = rd.shape[0], rd.shape[1]
        ro = jnp.broadcast_to(ro, rd.shape).astype(jnp.float32)
        rd = rd.astype(jnp.float32)
        planes = [to_blocks(ro[..., i], ph, pw) for i in range(3)]
        planes += [to_blocks(rd[..., i], ph, pw) for i in range(3)]
        planes.append(
            to_blocks(jnp.broadcast_to(max_dist, (h, w)).astype(jnp.float32),
                      ph, pw)
        )
        n = planes[0].shape[0]
        pack = _scalar_pack(pack_geometry(structure, params))
        res, t_star = _call(kernel, 7, 2, n, block, pack, planes,
                            interpret, "lol_shadow_march_triton")
        return (from_blocks(res, h, w, ph, pw),
                from_blocks(t_star, h, w, ph, pw))

    return shadow_fn
