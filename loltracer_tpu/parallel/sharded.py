"""Pixel-sharded rendering and training over a device mesh.

The image's row axis is statically partitioned over the mesh's 'devices'
axis via shard_map — the SPMD replacement for the reference's dynamic
scanline stealing (naive_renderer.c:216). Forward needs zero communication
(each device owns its rows end-to-end, mirroring the reference's disjoint
scanline writes); backward all-reduces only the KB-sized scene-parameter
gradient pytree via psum, which XLA hands to NCCL (NVLink between the cards
of a host, the network between hosts) and overlaps with the backward
computation. Each shard renders its rows through `render_rays`, so the
march value passes take whatever backend the mesh's devices resolve to
(render/backend.py).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from loltracer_tpu.config import DEFAULT_CONFIG, RenderConfig
from loltracer_tpu.render.backend import resolve_march_backend
from loltracer_tpu.render.camera import camera_rays_for_rows
from loltracer_tpu.render.jnp_renderer import pixel_radius, render_rays
from loltracer_tpu.scene import SceneParams, SceneStructure


def _resolve_backend(cfg: RenderConfig, mesh: Mesh, structure,
                     dtype) -> RenderConfig:
    """Resolve march_backend="auto" FULLY against the mesh's actual devices
    (render/backend.py) so code inside shard_map never consults the global
    default device — the mesh is the single source of truth here. "auto"
    keeps the jnp loops where the kernels do not apply (instanced scenes,
    non-f32 rays); an explicit kernel backend is passed on and raises
    there."""
    backend = resolve_march_backend(cfg.march_backend, mesh)
    if cfg.march_backend == "auto" and (
        structure.instanced or jnp.dtype(dtype) != jnp.float32
    ):
        backend = "jnp"
    return cfg.replace(march_backend=backend)


def _check_divisible(height: int, mesh: Mesh) -> None:
    n = mesh.devices.size
    if height % n != 0:
        raise ValueError(
            f"image height {height} must divide evenly over {n} devices; "
            f"pad the render height (e.g. to {-(-height // n) * n})"
        )


def _row_axes(mesh: Mesh):
    """Every mesh axis, major-to-minor: rows shard over ALL of them. For the
    1-D mesh this is ('devices',); for the 2-D (hosts, chips) mesh the hosts
    axis is major so each host owns a contiguous row block (host-local I/O)
    and reductions combine within a host (NVLink) before crossing the
    network between hosts."""
    return tuple(mesh.axis_names)


# Rows per band of the banded per-shard render of instanced scenes
# (_jnp_row_renderer).
INSTANCED_BAND_ROWS = 16


def row_granularity(structure, height=None, n_shards=None) -> int:
    """Rows per dealt block: one band of the banded instanced render, so a
    band is one contiguous image block; 8 rows for compiled scenes (the
    height of a kernel block's pixel patch, render/triton_march.py). Given
    `height` and `n_shards`, the largest block height up to that which
    deals every shard the same number of blocks (1080 rows over 4 shards:
    6-row blocks)."""
    g = INSTANCED_BAND_ROWS if structure.instanced else 8
    if height is not None and n_shards is not None:
        while g > 1 and height % (n_shards * g):
            g -= 1
    return g


def assign_blocks(n_blocks: int, n_shards: int, block_costs=None):
    """Owner shard per G-row block, every shard owning exactly
    n_blocks / n_shards blocks (shard_map needs equal shapes).

    Without costs: SNAKE dealing (0..N-1, N-1..0, ...) — cancels smooth
    vertical cost trends (sky cheap, ground expensive) but is limited by
    block-cost variance at few blocks per shard. With costs (the
    deterministic step-count model, utils/profiling.block_row_costs):
    capacity-constrained LPT — blocks sorted by estimated cost, each
    assigned to the least-loaded shard with capacity left. That is the
    static-SPMD answer to the reference's DYNAMIC scanline stealing
    (naive_renderer.c:216): compute the schedule host-side once, compile
    a static SPMD program."""
    import numpy as np

    owner = np.empty(n_blocks, np.int64)
    if block_costs is None:
        for b in range(n_blocks):
            r = b % (2 * n_shards)
            owner[b] = r if r < n_shards else 2 * n_shards - 1 - r
        return owner
    costs = np.asarray(block_costs, np.float64)
    if costs.shape != (n_blocks,):
        raise ValueError(
            f"block_costs must have shape ({n_blocks},); got {costs.shape}"
        )
    cap = n_blocks // n_shards
    load = np.zeros(n_shards)
    count = np.zeros(n_shards, np.int64)
    for b in np.argsort(-costs):
        open_shards = np.flatnonzero(count < cap)
        i = open_shards[np.argmin(load[open_shards])]
        owner[b] = i
        load[i] += costs[b]
        count[i] += 1
    return owner


def interleave_rows(height: int, n_shards: int, G: int, block_costs=None):
    """Global row order for BALANCED row sharding: G-row blocks dealt to
    shards (assign_blocks — snake, or cost-aware LPT when block_costs is
    given), each shard's blocks concatenated in image order. Returns
    (perm, inv) int arrays — perm[i] = the image row rendered at sharded
    position i — or None when height does not split into n_shards * G
    blocks (callers fall back to contiguous bands)."""
    import numpy as np

    if height % (n_shards * G):
        return None
    nblocks = height // G
    owner = assign_blocks(nblocks, n_shards, block_costs)
    perm = np.concatenate([
        np.concatenate(
            [np.arange(b * G, (b + 1) * G)
             for b in range(nblocks) if owner[b] == i]
        )
        for i in range(n_shards)
    ])
    inv = np.argsort(perm)
    return perm, inv


def _row_permutation(structure, height, width, mesh, cfg, interleave,
                     balance_params):
    """(perm, inv) for the dealt row order, or None (contiguous). With
    balance_params, per-block costs from the deterministic step-count
    model drive the LPT schedule; else snake dealing."""
    if not interleave:
        return None
    n = mesh.devices.size
    G = row_granularity(structure, height, n)
    bc = None
    if balance_params is not None and height % G == 0:
        from loltracer_tpu.utils.profiling import block_row_costs

        bc = block_row_costs(
            structure, balance_params, height, width, G, cfg
        )
    return interleave_rows(height, n, G, block_costs=bc)


def _jnp_row_renderer(structure, cfg, height, width, dtype,
                      band_rows: int = INSTANCED_BAND_ROWS):
    """The per-shard renderer: `(params, rows) -> [len(rows), W, 3]`
    through `render_rays`, whose march value passes follow
    cfg.march_backend. For INSTANCED scenes the shard renders in sequential
    row BANDS (jax.lax.map + checkpoint, mirroring
    jnp_renderer.render_image_banded): unbanded, every SDF-eval site
    materializes [shard_pixels, object_block] temporaries, which runs out
    of memory at 720p per shard. Compiled scenes render in one shot."""
    def render_rows(params: SceneParams, rows):
        pr = pixel_radius(params, height, cfg) if cfg.antialias else None
        if not structure.instanced or rows.shape[0] <= band_rows:
            ro, rd = camera_rays_for_rows(
                params, rows, height, width, cfg, dtype
            )
            return render_rays(structure, params, ro, rd, cfg, pixel_rad=pr)

        n = rows.shape[0]
        bw = next(b for b in range(band_rows, 0, -1) if n % b == 0)

        @jax.checkpoint
        def band(rs):
            ro, rd = camera_rays_for_rows(
                params, rs, height, width, cfg, dtype
            )
            return render_rays(structure, params, ro, rd, cfg, pixel_rad=pr)

        img = lax.map(band, rows.reshape(-1, bw))
        return img.reshape(n, width, 3)

    return render_rows


def make_sharded_renderer(
    structure: SceneStructure,
    mesh: Mesh,
    height: int,
    width: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
    dtype=jnp.float32,
    interleave: bool = True,
    balance_params: Optional[SceneParams] = None,
) -> Callable[[SceneParams], jnp.ndarray]:
    """Compile `params -> [H, W, 3]` with rows sharded over the mesh and the
    scene parameters replicated. Rows are dealt to devices in interleaved blocks when the height allows
    (`interleave`, see interleave_rows/assign_blocks) — per-pixel values
    are identical either way, only the load balance changes. Passing
    `balance_params` (typically the current scene params) upgrades the
    snake deal to the cost-aware LPT schedule from the step-count model
    (utils/profiling.block_row_costs), computed once at build time."""
    _check_divisible(height, mesh)
    cfg = _resolve_backend(cfg, mesh, structure, dtype)
    axes = _row_axes(mesh)
    render_rows = _jnp_row_renderer(structure, cfg, height, width, dtype)

    sharded = shard_map(
        render_rows,
        mesh=mesh,
        in_specs=(P(), P(axes)),
        out_specs=P(axes),
        check_vma=False,
    )
    pi = _row_permutation(
        structure, height, width, mesh, cfg, interleave, balance_params
    )
    if pi is None:
        rows = jnp.arange(height, dtype=jnp.int32)
        inv = None
    else:
        rows = jnp.asarray(pi[0], jnp.int32)
        inv = jnp.asarray(pi[1], jnp.int32)

    @jax.jit
    def renderer(params: SceneParams) -> jnp.ndarray:
        img = sharded(params, rows)
        return img if inv is None else img[inv]

    return renderer


def make_sharded_loss(
    structure: SceneStructure,
    mesh: Mesh,
    height: int,
    width: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
    dtype=jnp.float32,
    interleave: bool = True,
    balance_params: Optional[SceneParams] = None,
) -> Callable[[SceneParams, jnp.ndarray], jnp.ndarray]:
    """`(params, target [H, W, 3]) -> scalar mean-squared-error`, computed
    with rows sharded and the partial sums all-reduced (the backward pass of
    the psum is where scene-parameter gradients get all-reduced). With
    `interleave`, rows (and the target, identically) are dealt in
    snake blocks; the summed loss is permutation-invariant."""
    _check_divisible(height, mesh)
    cfg = _resolve_backend(cfg, mesh, structure, dtype)
    axes = _row_axes(mesh)
    render_rows = _jnp_row_renderer(structure, cfg, height, width, dtype)

    def local_loss(params: SceneParams, rows, target_rows):
        img = render_rows(params, rows)
        sq = (img - target_rows) ** 2
        return lax.psum(jnp.sum(sq), axes) / (height * width * 3)

    sharded = shard_map(
        local_loss,
        mesh=mesh,
        in_specs=(P(), P(axes), P(axes)),
        out_specs=P(),
        check_vma=False,
    )
    pi = _row_permutation(
        structure, height, width, mesh, cfg, interleave, balance_params
    )
    if pi is None:
        rows = jnp.arange(height, dtype=jnp.int32)
        perm = None
    else:
        rows = jnp.asarray(pi[0], jnp.int32)
        perm = rows

    def loss(params: SceneParams, target: jnp.ndarray) -> jnp.ndarray:
        tgt = target if perm is None else target[perm]
        return sharded(params, rows, tgt)

    return loss


def make_sharded_train_step(
    structure: SceneStructure,
    mesh: Mesh,
    height: int,
    width: int,
    optimizer,
    cfg: RenderConfig = DEFAULT_CONFIG,
    dtype=jnp.float32,
    project: Optional[Callable[[SceneParams], SceneParams]] = None,
    interleave: bool = True,
    balance_params: Optional[SceneParams] = None,
):
    """Build a jitted SPMD training step for inverse rendering:

      (params, opt_state, target) -> (params, opt_state, loss)

    Rendering and the loss are row-sharded; gradients arrive replicated
    (psum'd) so the optimizer update runs identically on every device.
    `project` optionally re-projects params after the update (e.g. radii > 0).
    """
    loss_fn = make_sharded_loss(
        structure, mesh, height, width, cfg, dtype,
        interleave=interleave, balance_params=balance_params,
    )

    @jax.jit
    def step(params: SceneParams, opt_state, target):
        loss, grads = jax.value_and_grad(loss_fn)(params, target)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        if project is not None:
            params = project(params)
        return params, opt_state, loss

    return step
