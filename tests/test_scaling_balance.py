"""Algorithmic (timer-free) scaling efficiency of row sharding.

What row sharding loses across cards is (a) load imbalance across the
per-device row assignments and (b) the KB-sized grad all-reduce, which is
latency-bound and small next to the render. (a) is measurable exactly with
no timers: the deterministic worst-ray tile cost model (utils/profiling,
one tile per kernel block patch) — and it is a property of the ASSIGNMENT.
Contiguous bands balance poorly (sky rows are cheap, ground rows
expensive); the production cost-aware LPT schedule
(parallel/sharded.assign_blocks — per-block costs from the step-count
model, computed once at build time, the static-SPMD answer to the
reference's dynamic scanline stealing, naive_renderer.c:216) clears a
>=90% bar. These tests enforce that; bench_scaling.py measures the same
schedule in wall time on real devices.
"""

import pytest

from loltracer_tpu.config import RenderConfig
from loltracer_tpu.lol import parse_scene_file
from loltracer_tpu.scene import build_scene
from loltracer_tpu.scenes import instanced_spheres
from loltracer_tpu.utils.profiling import shard_balance


@pytest.mark.parametrize("n_shards,height", [(2, 512), (4, 512), (8, 512)])
def test_shard_balance_compiled(examples_dir, n_shards, height):
    scene = build_scene(parse_scene_file(str(examples_dir / "scene4.lol")))
    rec = shard_balance(
        scene.structure, scene.params, height, 128, n_shards, RenderConfig()
    )
    assert rec["assignment"] == "lpt"
    assert len(rec["shard_costs"]) == n_shards
    assert rec["efficiency_balance"] >= 0.9, rec


@pytest.mark.parametrize("n_shards,height", [(2, 512), (4, 512)])
def test_shard_balance_instanced(n_shards, height):
    scene = instanced_spheres(n=150, seed=5)
    rec = shard_balance(
        scene.structure, scene.params, height, 128, n_shards,
        RenderConfig(step_clamp=2.0),
    )
    assert rec["assignment"] == "lpt"
    assert rec["efficiency_balance"] >= 0.9, rec


@pytest.mark.slow
def test_shard_balance_instanced_8(
):
    """The hardest configuration needs ladder-scale height: at 8 shards
    the 16-row patch granularity gives only 4 blocks/shard at H=512
    (LPT 0.71 — a real granularity ceiling, recorded here), but the
    ladder's H=1024 gives 8 blocks/shard and clears the bar."""
    scene = instanced_spheres(n=150, seed=5)
    rec = shard_balance(
        scene.structure, scene.params, 1024, 128, 8,
        RenderConfig(step_clamp=2.0),
    )
    assert rec["efficiency_balance"] >= 0.9, rec


def test_lpt_beats_snake_beats_contiguous():
    """The assignment ladder is ordered as designed: cost-aware LPT >=
    snake dealing >= contiguous bands on the same content."""
    from loltracer_tpu.parallel.sharded import assign_blocks
    import numpy as np

    rng = np.random.default_rng(3)
    # bounded spread (no single block can dominate a shard's ideal load:
    # with one enormous block, ~0.5 efficiency is OPTIMAL for any
    # assignment — sum/(n*max_block) bounds them all)
    costs = rng.uniform(0.5, 2.0, 64) + np.linspace(0, 2, 64)

    def eff(owner, n):
        load = np.zeros(n)
        for b, o in enumerate(owner):
            load[o] += costs[b]
        return load.sum() / (n * load.max())

    n = 8
    lpt = eff(assign_blocks(64, n, costs), n)
    snake = eff(assign_blocks(64, n), n)
    contig = eff(np.repeat(np.arange(n), 64 // n), n)
    assert lpt >= snake - 1e-9
    assert lpt >= contig - 1e-9
    assert lpt >= 0.97, (lpt, snake, contig)
    # equal-count constraint (shard_map static shapes)
    owner = assign_blocks(64, n, costs)
    counts = np.bincount(owner, minlength=n)
    assert (counts == 8).all()
