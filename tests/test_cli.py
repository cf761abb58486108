"""CLI smoke tests, including stdin scene input (scene-parser.y:200-203)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest


def _run(args, stdin=None, cwd=None):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, "-m", "loltracer_tpu.cli", *args],
        input=stdin,
        capture_output=True,
        text=True,
        timeout=300,
        cwd=cwd,
        env=env,
    )


def test_render_from_stdin(examples_dir, tmp_path):
    """`loltrace render -` reads the scene from stdin like the reference's
    scene_parse(NULL) stdin fallback (scene-parser.y:200-203)."""
    src = (examples_dir / "scene2.lol").read_text()
    out = tmp_path / "out.npy"
    r = _run(["render", "-", "--size", "16x12", "-o", str(out)], stdin=src)
    assert r.returncode == 0, r.stderr
    img = np.load(out)
    assert img.shape == (12, 16, 3)
    assert np.isfinite(img).all()


def test_info_from_stdin(examples_dir):
    src = (examples_dir / "scene3.lol").read_text()
    r = _run(["info"], stdin=src)
    assert r.returncode == 0, r.stderr
    info = json.loads(r.stdout)
    assert info["smooth_unions"] == 1
    assert info["lights"] == 2
