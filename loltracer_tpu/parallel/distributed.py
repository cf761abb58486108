"""Multi-host bootstrap: jax.distributed wiring (SURVEY §4(d), §5.8).

The reference parallelizes inside one process (SDL threads + semaphores,
main.c:145-149); this framework scales across hosts with
`jax.distributed.initialize()` so `jax.devices()` spans every host's cards
and row-sharded rendering + the scene-gradient psum ride NVLink within a
host and the network across hosts.

`maybe_initialize()` is called by the CLI and the scaling benchmark. It is
a no-op unless multi-process coordinates are provided, via either

- the cluster's own auto-detection (LOLTRACE_DISTRIBUTED=1 makes us call
  `jax.distributed.initialize()` bare, which resolves the coordinator from
  the environment a cluster launcher such as SLURM provides), or
- explicit env vars for manual/loopback launches:
    LOLTRACE_COORDINATOR=host:port
    LOLTRACE_NUM_PROCESSES=N
    LOLTRACE_PROCESS_ID=I
    LOLTRACE_LOCAL_DEVICE_IDS=0,1 (optional)

The two-process CPU loopback path (tests/test_distributed.py) uses the
explicit form on localhost, the standard JAX substitute for a multi-host
cluster in unit tests."""

from __future__ import annotations

import os
from typing import Optional


def _already_initialized() -> bool:
    import jax

    is_init = getattr(jax.distributed, "is_initialized", None)
    if is_init is not None:
        return bool(is_init())
    # older jax: probe the global client state
    state = getattr(jax.distributed, "global_state", None)
    return state is not None and getattr(state, "client", None) is not None


def maybe_initialize() -> bool:
    """Initialize jax.distributed from the environment; returns True when a
    multi-process runtime was started (or already is). Safe to call multiple
    times: a second call is a no-op (jax.distributed.initialize itself
    raises on re-initialization, and cli.main + bench_scaling can both run
    in one process)."""
    import jax

    coordinator = os.environ.get("LOLTRACE_COORDINATOR")
    if (coordinator or os.environ.get("LOLTRACE_DISTRIBUTED") == "1") and (
        _already_initialized()
    ):
        return True
    if coordinator:
        num = int(os.environ["LOLTRACE_NUM_PROCESSES"])
        pid = int(os.environ["LOLTRACE_PROCESS_ID"])
        local = os.environ.get("LOLTRACE_LOCAL_DEVICE_IDS")
        kw = {}
        if local:
            kw["local_device_ids"] = [int(x) for x in local.split(",")]
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num,
            process_id=pid,
            **kw,
        )
        return True
    if os.environ.get("LOLTRACE_DISTRIBUTED") == "1":
        jax.distributed.initialize()  # cluster auto-detection
        return True
    return False


def process_info() -> dict:
    """Host/process summary for logs: index, count, local/global devices."""
    import jax

    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
