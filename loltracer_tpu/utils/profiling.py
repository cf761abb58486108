"""Profiling and occupancy observability.

The reference's profiling story is a per-frame ms log (main.c:196-204) and
Linux-perf jitdump symbolication of the generated SDF kernel
(jitdump.c; SURVEY.md §5.1). Here:

- `trace(logdir)`: jax.profiler trace context -> xprof/tensorboard, with the
  scene kernels identifiable via jax.named_scope and the kernel names,
- `march_step_stats`: per-pixel march step counts + histogram — the
  divergence/occupancy metric for block sizing (SURVEY.md §5.5): a kernel
  block runs until its *worst* ray is done, so the step distribution tells
  you how much masked work that wastes,
- `frame_timer`: running min/max/avg frame times like the reference's log.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, Iterator, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from loltracer_tpu.config import DEFAULT_CONFIG, RenderConfig
from loltracer_tpu.render.camera import camera_rays
from loltracer_tpu.render.sdf import make_scene_sdf
from loltracer_tpu.render.triton_march import BLOCK_PATCHES, DEFAULT_BLOCK
from loltracer_tpu.scene import SceneParams, SceneStructure

# The pixel patch one kernel block marches (render/triton_march.py): the
# unit of the worst-ray cost model below.
BLOCK_TILE = BLOCK_PATCHES[DEFAULT_BLOCK]


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """jax.profiler trace context; view with tensorboard/xprof."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def march_step_counts(
    structure: SceneStructure,
    params: SceneParams,
    height: int,
    width: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
) -> np.ndarray:
    """Per-pixel number of march iterations until convergence/miss
    (naive_renderer.c:56-63 loop trips), [H, W] int32."""
    sdf = make_scene_sdf(structure)

    @jax.jit
    def run(params):
        ro, rd = camera_rays(params, height, width, cfg)
        batch = rd.shape[:-1]
        t0 = jnp.zeros(batch, rd.dtype)
        steps0 = jnp.zeros(batch, jnp.int32)
        done0 = jnp.zeros(batch, bool)

        def cond(c):
            i, _, _, done = c
            return (i < cfg.max_steps) & ~jnp.all(done)

        def body(c):
            i, t, steps, done = c
            d = sdf(params, ro + t[..., None] * rd)
            new_t = t + d
            steps = jnp.where(done, steps, steps + 1)
            t = jnp.where(done, t, new_t)
            done = done | (d < cfg.epsilon) | (new_t > cfg.max_dist)
            return i + 1, t, steps, done

        _, _, steps, _ = lax.while_loop(cond, body, (0, t0, steps0, done0))
        return steps

    return np.asarray(run(params))


def march_step_stats(
    structure: SceneStructure,
    params: SceneParams,
    height: int,
    width: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
    tile: Tuple[int, int] = BLOCK_TILE,
) -> Dict[str, float]:
    """Occupancy summary: step distribution plus the masked-work overhead of
    the kernel's block patches — mean tile max over mean step count
    measures how much a block's worst ray makes its converged rays wait."""
    steps = march_step_counts(structure, params, height, width, cfg)

    def waste(th, tw):
        # None (json null) when the image is smaller than the tile —
        # NaN would poison strict-JSON output
        hh = height - height % th
        ww = width - width % tw
        if not hh or not ww:
            return None
        tiles = steps[:hh, :ww].reshape(hh // th, th, ww // tw, tw)
        return float(tiles.max(axis=(1, 3)).mean())

    mean = float(steps.mean())
    th, tw = tile

    def ratio(w):
        return None if w is None else float(w / max(mean, 1e-9))

    return {
        "mean_steps": mean,
        "p50_steps": float(np.percentile(steps, 50)),
        "p99_steps": float(np.percentile(steps, 99)),
        "max_steps": float(steps.max()),
        "tile_waste": ratio(waste(th, tw)),
    }


def shadow_step_counts(
    structure: SceneStructure,
    params: SceneParams,
    height: int,
    width: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
) -> np.ndarray:
    """Per-pixel, per-light shadow-march iteration counts at the primary
    hit (naive_renderer.c:71-100 loop trips), [L, H, W] int32."""
    sdf = make_scene_sdf(structure)

    @jax.jit
    def run(params):
        ro, rd = camera_rays(params, height, width, cfg)
        batch = rd.shape[:-1]

        def march(ro, rd):
            t0 = jnp.zeros(batch, rd.dtype)
            done0 = jnp.zeros(batch, bool)

            def cond(c):
                i, _, done = c
                return (i < cfg.max_steps) & ~jnp.all(done)

            def body(c):
                i, t, done = c
                d = sdf(params, ro + t[..., None] * rd)
                new_t = t + d
                t = jnp.where(done, t, new_t)
                done = done | (d < cfg.epsilon) | (new_t > cfg.max_dist)
                return i + 1, t, done

            _, t, _ = lax.while_loop(cond, body, (0, t0, done0))
            return t

        t = march(ro, rd)
        p = ro + t[..., None] * rd

        def shadow_steps(lp):
            to_light = lp - p
            light_dist = jnp.sqrt(jnp.sum(to_light * to_light, -1))
            ld = to_light / jnp.maximum(light_dist[..., None], 1e-30)
            so = p + ld * cfg.shadow_offset
            res0 = jnp.ones(batch, p.dtype)
            t0 = jnp.zeros(batch, p.dtype)
            steps0 = jnp.zeros(batch, jnp.int32)
            done0 = jnp.zeros(batch, bool)

            def cond(c):
                i, _, _, _, done = c
                return (i < cfg.shadow_steps) & ~jnp.all(done)

            def body(c):
                i, res, t, steps, done = c
                d = sdf(params, so + t[..., None] * ld)
                val = cfg.shadow_w * d / t
                res = jnp.where(done, res, jnp.minimum(res, val))
                t = jnp.where(done, t, t + d)
                steps = jnp.where(done, steps, steps + 1)
                done = done | (res < -1.0) | (t > light_dist)
                return i + 1, res, t, steps, done

            _, _, _, steps, _ = lax.while_loop(
                cond, body, (0, res0, t0, steps0, done0)
            )
            return steps

        return jnp.stack(
            [shadow_steps(params.light_point[li])
             for li in range(structure.num_lights)]
        )

    return np.asarray(run(params))


def band_balance(
    structure: SceneStructure,
    params: SceneParams,
    height: int,
    width: int,
    n_bands: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
    tile: Tuple[int, int] = BLOCK_TILE,
) -> Dict[str, object]:
    """Deterministic per-band cost model for row-sharded SPMD (SURVEY
    §5.7): a band's cost is the sum over its tiles (kernel block patches)
    of the WORST-ray march steps plus per-light worst-ray shadow steps.
    Returns per-band costs and the load-balance efficiency sum / (N * max):
    the fraction of ideal scaling throughput an N-way row shard of THIS
    image can reach, independent of timers. Real collectives add only a
    KB-sized grad psum on top."""
    if height % (n_bands * tile[0]):
        raise ValueError(
            f"height {height} must tile into {n_bands} bands of "
            f"{tile[0]}-row tiles"
        )
    march = march_step_counts(structure, params, height, width, cfg)
    shadow = shadow_step_counts(structure, params, height, width, cfg)
    th, tw = tile
    ww = width - width % tw
    if not ww:
        raise ValueError(f"width {width} smaller than tile width {tw}")

    def tile_cost(plane):  # [H, W] -> summed worst-ray steps per band
        tiles = plane[:, :ww].reshape(height // th, th, ww // tw, tw)
        per_tile = tiles.max(axis=(1, 3))  # [H/th, W/tw]
        bands = per_tile.reshape(n_bands, -1, per_tile.shape[1])
        return bands.sum(axis=(1, 2)).astype(np.float64)

    costs = tile_cost(march)
    for li in range(shadow.shape[0]):
        costs = costs + tile_cost(shadow[li])
    eff = float(costs.sum() / (n_bands * costs.max()))
    return {
        "n_bands": n_bands,
        "band_costs": [float(c) for c in costs],
        "efficiency_balance": eff,
    }


def block_row_costs(
    structure: SceneStructure,
    params: SceneParams,
    height: int,
    width: int,
    G: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
    tile: Tuple[int, int] = BLOCK_TILE,
) -> np.ndarray:
    """Estimated cost per G-row block, [height // G] float64: summed
    worst-ray march + per-light shadow steps over the block's tiles (the
    worst-ray tile cost model). Feeds the cost-aware static schedule
    (parallel/sharded.assign_blocks) — computed ONCE per build from the
    current params, host-side."""
    th = math.gcd(G, tile[0])
    per_row = _tile_row_costs(structure, params, height, width, cfg,
                              (th, tile[1]))
    return per_row.reshape(height // G, G // th).sum(axis=1)


def _tile_row_costs(structure, params, height, width, cfg, tile):
    """Worst-ray march + per-light shadow steps summed over each th-row
    strip of (th, tw) tiles, [height // th] float64."""
    march = march_step_counts(structure, params, height, width, cfg)
    shadow = shadow_step_counts(structure, params, height, width, cfg)
    th, tw = tile
    ww = width - width % tw

    def row_cost(plane):
        tiles = plane[:, :ww].reshape(height // th, th, ww // tw, tw)
        return tiles.max(axis=(1, 3)).sum(axis=1).astype(np.float64)

    per_row = row_cost(march)
    for li in range(shadow.shape[0]):
        per_row = per_row + row_cost(shadow[li])
    return per_row


def shard_balance(
    structure: SceneStructure,
    params: SceneParams,
    height: int,
    width: int,
    n_shards: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
    tile: Tuple[int, int] = BLOCK_TILE,
    cost_aware: bool = True,
) -> Dict[str, object]:
    """Load-balance efficiency of the PRODUCTION row-sharding assignment
    (parallel/sharded.py: cost-aware LPT blocks with cost_aware, snake
    blocks otherwise, contiguous bands when the height doesn't split), on
    the same deterministic worst-ray tile cost model as band_balance.
    This is the quantity that caps weak-scaling efficiency across cards;
    contiguous bands balance poorly on it (sky rows are cheap, ground rows
    expensive), which is why the dealt assignments exist."""
    from loltracer_tpu.parallel.sharded import (
        interleave_rows,
        row_granularity,
    )

    G = row_granularity(structure, height, n_shards)
    th = math.gcd(G, tile[0])
    per_row = _tile_row_costs(structure, params, height, width, cfg,
                              (th, tile[1]))
    bc = None
    if cost_aware and height % G == 0:
        bc = per_row.reshape(height // G, G // th).sum(axis=1)
    pi = interleave_rows(height, n_shards, G, block_costs=bc)
    costs = np.zeros(n_shards)
    if pi is None:
        assignment = "contiguous"
        bands = per_row.reshape(n_shards, -1)
        costs = bands.sum(axis=1)
    else:
        assignment = "lpt" if bc is not None else "interleaved-snake"
        perm = pi[0]
        rows_per = height // n_shards
        for i in range(n_shards):
            rows_i = perm[i * rows_per:(i + 1) * rows_per]
            # tile-row indices this shard's rows fall in (G >= th blocks)
            trows = np.unique(rows_i // th)
            costs[i] = per_row[trows].sum()
    eff = float(costs.sum() / (n_shards * costs.max()))
    return {
        "n_shards": n_shards,
        "assignment": assignment,
        "granularity": G,
        "shard_costs": [float(c) for c in costs],
        "efficiency_balance": eff,
    }


class frame_timer:
    """Running frame-time stats in the spirit of main.c:196-204."""

    def __init__(self) -> None:
        self.frames = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.frames += 1
        self.total += dt
        self.min = min(self.min, dt)
        self.max = max(self.max, dt)
        return False

    @property
    def avg(self) -> float:
        return self.total / max(self.frames, 1)

    def log(self) -> str:
        return (
            f"frame {self.frames} min {self.min*1e3:.1f}ms "
            f"max {self.max*1e3:.1f}ms avg {self.avg*1e3:.1f}ms"
        )
