"""The pieces of chip_smoke.py that run without a GPU: it refuses to run
on the CPU and prints no result, its last line has the exact shape, the
four-card option selects only the sharded phase, and its tolerance
helpers accept and reject what they should."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def test_refuses_cpu_platform(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_bare_directory_fails_without_result(tmp_path):
    """Alone, without the package beside it, the script exits non-zero and
    prints no result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_result_line_shape():
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1},
    }
    assert "\n" not in line


def test_four_cards_selects_only_the_sharded_phase():
    assert chip_smoke.select_phases(True) == ("device", "four_cards")
    one = chip_smoke.select_phases(False)
    assert "four_cards" not in one
    assert one == ("device", "kernels", "forward", "fwdbwd", "fit",
                   "instanced")


def test_march_tolerance():
    t = np.array([1.0, 2.0, 50.0, 100.5])
    stats = chip_smoke.march_agreement(t, t * (1 + 1e-4), 100.0)
    assert stats["agree"] == 1.0 and stats["mismatched"] == 0.0
    chip_smoke.check_march(stats)
    flipped = t.copy()
    flipped[0] = 101.0  # a hit turned into a miss: 1 of 4 pixels
    stats = chip_smoke.march_agreement(t, flipped, 100.0)
    assert stats["mismatched"] == 0.25
    with pytest.raises(AssertionError, match="agreement"):
        chip_smoke.check_march(stats)
    with pytest.raises(AssertionError, match="dt"):
        chip_smoke.check_march(
            chip_smoke.march_agreement(t, t * 1.01, 100.0)
        )


def test_image_and_gradient_tolerances():
    ref = np.zeros((100, 100, 3))
    img = ref.copy()
    img[0, 0] = 5e-4  # one outlier pixel in 1e4
    stats = chip_smoke.image_close(img, ref, 2e-4, 1e-4, 1e-3)
    assert stats["share_over_atol"] == 1e-4
    img[0, 1] = 5e-4
    with pytest.raises(AssertionError, match="mismatch"):
        chip_smoke.image_close(img, ref, 2e-4, 1e-4, 1e-3)
    g = {"a": np.array([1.0, -2.0]), "b": np.array([0.5])}
    assert chip_smoke.grads_close(g, {"a": g["a"] * 1.01, "b": g["b"]},
                                  2e-2) < 2e-2
    with pytest.raises(AssertionError):
        chip_smoke.grads_close(g, {"a": g["a"] * 1.2, "b": g["b"]}, 2e-2)


def test_gradient_rel_l2_bound():
    g = {"a": np.array([1.0, -2.0]), "b": np.array([0.5])}
    rel = chip_smoke.grads_rel_l2(g, {"a": g["a"] * (1 + 1e-4), "b": g["b"]})
    assert rel["['a']"] == pytest.approx(1e-4) and rel["['b']"] == 0.0
    with pytest.raises(AssertionError, match=r"\['a'\]"):
        chip_smoke.grads_rel_l2(g, {"a": g["a"] * 1.01, "b": g["b"]})
    with pytest.raises(AssertionError, match="non-finite"):
        chip_smoke.grads_rel_l2(g, {"a": g["a"], "b": np.array([np.nan])})


def test_shadow_tolerance():
    res = np.array([1.0, 0.5, 0.2, -3.0])  # lit, two penumbra, deep shadow
    ts = np.array([0.0, 4.0, 7.0, 2.0])
    stats = chip_smoke.shadow_agreement(res, ts, res, ts)
    assert stats["penumbra_share"] == 0.5 and stats["t_star_moved"] == 0.0
    chip_smoke.check_shadow(stats)
    # t* of a deep-shadow pixel carries no gradient: not checked
    moved = ts.copy()
    moved[3] = 9.0
    chip_smoke.check_shadow(chip_smoke.shadow_agreement(res, ts, res, moved))
    # t* of a penumbra pixel jumped to another step
    moved = ts.copy()
    moved[1] = 5.0
    stats = chip_smoke.shadow_agreement(res, ts, res, moved)
    assert stats["t_star_moved"] == 0.5
    with pytest.raises(AssertionError, match="t\\*"):
        chip_smoke.check_shadow(stats)
    # res below 0 clamps to a hard shadow either way
    other = res.copy()
    other[3] = -1.5
    chip_smoke.check_shadow(chip_smoke.shadow_agreement(res, ts, other, ts))
    other[2] += 1e-3
    with pytest.raises(AssertionError, match="res"):
        chip_smoke.check_shadow(chip_smoke.shadow_agreement(res, ts, other, ts))
