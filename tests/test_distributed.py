"""Multi-host logic: 2-D (hosts, chips) mesh + a real two-process
jax.distributed loopback run (SURVEY §4(d), §5.8).

The loopback test launches TWO separate Python processes that rendezvous at
a localhost coordinator, each contributing 4 faked CPU devices; the worker
(tests/_distributed_worker.py) builds the global (2, 4) mesh, runs the
row-sharded renderer and one sharded train step, and checks both against
process-local single-device references. This exercises the actual
jax.distributed runtime — cross-process collectives over loopback sockets
standing in for the network between hosts — not just a faked
single-process mesh."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax


def test_mesh_2d_single_process():
    """With one process, the (hosts, chips) mesh is (1, N) and the sharded
    renderer matches the 1-D mesh bit-for-bit."""
    from loltracer_tpu.lol import parse_scene_file
    from loltracer_tpu.parallel import make_mesh, make_mesh_2d
    from loltracer_tpu.parallel.sharded import make_sharded_renderer
    from loltracer_tpu.scene import build_scene

    scene = build_scene(
        parse_scene_file(
            os.path.join(os.path.dirname(__file__), "..", "examples",
                         "scene2.lol")
        )
    )
    cpus = jax.devices("cpu")[:4]
    mesh2d = make_mesh_2d(cpus)
    assert mesh2d.devices.shape == (1, 4)
    assert mesh2d.axis_names == ("hosts", "chips")
    r2 = make_sharded_renderer(scene.structure, mesh2d, 16, 64)
    r1 = make_sharded_renderer(
        scene.structure, make_mesh(devices=cpus), 16, 64
    )
    np.testing.assert_array_equal(
        np.asarray(r2(scene.params)), np.asarray(r1(scene.params))
    )


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_loopback():
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "_distributed_worker.py")

    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(
            LOLTRACE_COORDINATOR=f"127.0.0.1:{port}",
            LOLTRACE_NUM_PROCESSES="2",
            LOLTRACE_PROCESS_ID=str(pid),
            PYTHONPATH=root,
        )
        env.pop("JAX_PLATFORMS", None)  # the worker pins cpu itself
        procs.append(
            subprocess.Popen(
                [sys.executable, worker],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
                cwd=root,
            )
        )

    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        outs.append(out)

    for pid, out in enumerate(outs):
        line = out.strip().splitlines()[-1]
        info = json.loads(line)
        assert info["ok"] is True
        assert info["devices"] == 8
        assert abs(info["sharded_loss"] - info["local_loss"]) < 1e-6
        assert info["step_loss"] < 1e-10
        # the kernel route over the process-spanning mesh: one train step
        # on scene4 with the Triton kernels (interpreter) and one on an
        # instanced scene, matching the local single-device step
        assert info["kernel_loss_diff"] < 1e-6
        assert info["kernel_param_diff"] < 1e-5
        assert info["instanced_loss_diff"] < 1e-6
        assert info["instanced_param_diff"] < 1e-5
        assert info["kernel_loss"] > 0 and info["instanced_loss"] > 0
