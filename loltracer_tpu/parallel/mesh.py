"""Device mesh construction.

The reference's "distribution" is one process with N worker threads pulling
scanlines off an atomic counter and meeting at two semaphore barriers per
frame (main.c:145-149,189-194; naive_renderer.c:216). Here it is SPMD over
a jax.sharding.Mesh: rows are statically sharded over the
'devices' axis (tiles big enough to average out per-ray march divergence
replace dynamic stealing), barriers come free from program structure, and the
only cross-device traffic is the scene-gradient psum in backward
(SURVEY.md §5.8).

For several hosts call `jax.distributed.initialize()` before
`make_mesh()`; jax.devices() then spans every host's cards and rows shard
across all of them. XLA hands the gradient all-reduce to NCCL: NVLink
between the cards of a host, the network between hosts. Every card of a
host reaches every other at the same rate, so the mesh follows the
algorithm alone: a 1-D row mesh, or (hosts, chips) across hosts.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

AXIS = "devices"


import os


def make_mesh(
    devices: Optional[Sequence[jax.Device]] = None,
    n_devices: Optional[int] = None,
) -> Mesh:
    """A 1-D mesh over the given (default: all) devices.

    `n_devices` truncates, which is how tests build small meshes out of the
    8 faked CPU devices. When MORE devices are requested than exist, the
    faked-CPU fallback (--xla_force_host_platform_device_count) is applied
    ONLY with LOLTRACE_CPU_FALLBACK=1 (tests/conftest.py sets it): a launch
    that got fewer cards than it asked for must fail loudly, not silently
    "succeed" on host CPUs."""
    if devices is None:
        devices = jax.devices()
        if (
            n_devices is not None
            and len(devices) < n_devices
            and os.environ.get("LOLTRACE_CPU_FALLBACK") == "1"
        ):
            # faked host CPU devices (--xla_force_host_platform_device_count)
            # when the default platform has fewer devices than asked for
            try:
                cpus = jax.devices("cpu")
            except RuntimeError:
                cpus = []
            if len(cpus) >= n_devices:
                devices = cpus
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {len(devices)} "
                "(set LOLTRACE_CPU_FALLBACK=1 to test on faked CPU devices)"
            )
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (AXIS,))


HOSTS_AXIS = "hosts"
CHIPS_AXIS = "chips"


def make_mesh_2d(devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """A 2-D (hosts, chips) mesh: the process axis outer, each host's local
    devices inner (SURVEY §2.2). Image rows shard over BOTH axes with the
    hosts axis major, so each host owns a contiguous block of rows
    (host-local I/O, like the reference's disjoint scanlines) and the
    backward's scene-gradient all-reduce combines over NVLink within a host
    before crossing the network between hosts (SURVEY §5.8)."""
    if devices is None:
        devices = jax.devices()
    by_process: dict = {}
    for d in devices:
        by_process.setdefault(d.process_index, []).append(d)
    counts = {len(v) for v in by_process.values()}
    if len(counts) != 1:
        raise ValueError(
            f"uneven local device counts across processes: "
            f"{ {k: len(v) for k, v in by_process.items()} }"
        )
    rows = [by_process[k] for k in sorted(by_process)]
    return Mesh(np.asarray(rows), (HOSTS_AXIS, CHIPS_AXIS))
