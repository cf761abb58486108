"""Interactive camera controls and terminal preview.

Replaces the reference's SDL window + WASD/arrow fly camera (main.c:26-112,
163-211) with a pure functional camera update and an ANSI half-block
terminal viewer (two pixels per character cell). The camera math replicates
update_camera exactly: translate along direction/right/up-axis by 0.1 per
frame, rotate by nudging the direction along the right/up basis vectors and
renormalizing (main.c:70-112 — including its 'ultra hacky' rotation feel).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Set, Tuple

import numpy as np

from loltracer_tpu.scene import SceneParams

STEP = 0.1  # per-frame movement/rotation step (main.c:78-111)


def _normalize(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def update_camera(
    point: np.ndarray, direction: np.ndarray, keys: Set[str]
) -> Tuple[np.ndarray, np.ndarray]:
    """One frame of camera motion. `keys` holds any of
    w/a/s/d/space/ctrl/up/down/left/right (pressed this frame)."""
    point = np.asarray(point, np.float64).copy()
    direction = np.asarray(direction, np.float64).copy()
    up_guide = np.array([0.0, 1.0, 0.0])
    right_dir = _normalize(np.cross(direction, up_guide))
    up_dir = _normalize(np.cross(right_dir, direction))

    if "w" in keys:
        point += direction * STEP
    if "a" in keys:
        point -= right_dir * STEP
    if "s" in keys:
        point -= direction * STEP
    if "d" in keys:
        point += right_dir * STEP
    if "space" in keys:
        point[1] += STEP
    if "ctrl" in keys:
        point[1] -= STEP
    if "up" in keys:
        direction = _normalize(direction + up_dir * STEP)
    if "down" in keys:
        direction = _normalize(direction - up_dir * STEP)
    if "left" in keys:
        direction = _normalize(direction - right_dir * STEP)
    if "right" in keys:
        direction = _normalize(direction + right_dir * STEP)

    return point, direction


def move_camera(params: SceneParams, keys: Set[str]) -> SceneParams:
    """Functional camera update on the scene pytree."""
    point, direction = update_camera(
        np.asarray(params.cam_point), np.asarray(params.cam_direction), keys
    )
    dtype = np.asarray(params.cam_point).dtype
    return dataclasses.replace(
        params,
        cam_point=point.astype(dtype),
        cam_direction=direction.astype(dtype),
    )


def frame_to_ansi(img: np.ndarray) -> str:
    """[H, W, 3] float -> ANSI truecolor half-block art (2 rows per line)."""
    u8 = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
    h = u8.shape[0] - (u8.shape[0] % 2)
    lines = []
    for y in range(0, h, 2):
        top, bot = u8[y], u8[y + 1]
        line = []
        for x in range(u8.shape[1]):
            tr, tg, tb = top[x]
            br, bg, bb = bot[x]
            line.append(
                f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀"
            )
        lines.append("".join(line) + "\x1b[0m")
    return "\n".join(lines)


_KEYMAP = {
    "w": "w", "a": "a", "s": "s", "d": "d",
    " ": "space", "c": "ctrl",
    "\x1b[A": "up", "\x1b[B": "down", "\x1b[D": "left", "\x1b[C": "right",
}


def terminal_frame_size(term_size=None, reserve_lines: int = 2):
    """Render size (height, width) for the CURRENT terminal: one pixel per
    column, two per text row (half blocks), minus a status-bar reserve —
    re-read every frame like the reference re-fetches its window surface
    (main.c:182, naive_renderer.c:207-213), so a live resize changes the
    next frame's resolution and camera aspect. Height is even (half-block
    pairs); both dims floor at 16."""
    if term_size is None:
        import shutil

        term_size = shutil.get_terminal_size((96, 38))
    cols, lines = term_size
    width = max(16, int(cols))
    height = max(16, 2 * max(int(lines) - reserve_lines, 8))
    return height, width


def resolve_viewer_renderer(scene, height: int, width: int, cfg):
    """The production forward path at this size: `make_renderer`, whose
    march backend follows cfg.march_backend (render/backend.py), with the
    forward-only shadow estimator (RenderConfig.for_forward). Returns a
    jitted params -> [H, W, 3] fn."""
    from loltracer_tpu.render.jnp_renderer import make_renderer

    return make_renderer(scene.structure, height, width, cfg.for_forward())


class SizeAdaptiveRenderer:
    """Per-size renderer cache for the viewer: frame(params, term_size)
    re-resolves the production renderer whenever the terminal size
    changes (the compile is paid once per size; the persistent XLA
    compile cache, utils/cache.py, makes revisits warm). Tracks
    compile-to-first-frame latency per size — the framework's startup
    story vs the reference's millisecond DynASM JIT
    (tracing_jit_renderer.dasc:416-432)."""

    def __init__(self, scene, cfg):
        self.scene = scene
        self.cfg = cfg
        self._renderers = {}
        self.first_frame_s: dict = {}
        self.size = None

    def frame(self, params, term_size=None) -> np.ndarray:
        import time

        self.size = terminal_frame_size(term_size)
        h, w = self.size
        if (h, w) not in self._renderers:
            t0 = time.perf_counter()
            fn = resolve_viewer_renderer(self.scene, h, w, self.cfg)
            img = np.asarray(fn(params))
            self.first_frame_s[(h, w)] = time.perf_counter() - t0
            self._renderers[(h, w)] = fn
            return img
        return np.asarray(self._renderers[(h, w)](params))


def run_viewer(scene, width: int = None, height: int = None, cfg=None) -> None:
    """Terminal render loop: WASD move, arrows rotate, space/c up/down,
    q quits. Frame-time stats printed like main.c:202-204. With no
    explicit size the viewer follows the live terminal size every frame;
    an explicit --size pins it."""
    import termios
    import time
    import tty

    from loltracer_tpu.config import DEFAULT_CONFIG

    cfg = cfg or DEFAULT_CONFIG
    fixed = (height, width) if height and width else None
    adaptive = SizeAdaptiveRenderer(scene, cfg)
    params = scene.params

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    frames = 0
    tmin, tmax, ttot = float("inf"), 0.0, 0.0
    try:
        tty.setcbreak(fd)
        sys.stdout.write("\x1b[2J")  # clear
        while True:
            t0 = time.perf_counter()
            img = adaptive.frame(
                params, term_size=(fixed[1], fixed[0] // 2 + 2) if fixed
                else None
            )
            dt = time.perf_counter() - t0
            frames += 1
            tmin, tmax, ttot = min(tmin, dt), max(tmax, dt), ttot + dt
            h, w = adaptive.size
            first = adaptive.first_frame_s.get((h, w), 0.0)
            sys.stdout.write("\x1b[H" + frame_to_ansi(img) + "\n")
            sys.stdout.write(
                f"{w}x{h}  frame {frames}  time {dt*1e3:.0f}ms  "
                f"min {tmin*1e3:.0f} max {tmax*1e3:.0f} "
                f"avg {ttot/frames*1e3:.0f}  first {first*1e3:.0f}ms   "
                "[wasd move, arrows rotate, space/c up/down, q quit]\x1b[K\n"
            )
            sys.stdout.flush()

            import select

            keys: Set[str] = set()
            while select.select([sys.stdin], [], [], 0.01)[0]:
                ch = sys.stdin.read(1)
                if ch == "q":
                    return
                if ch == "\x1b":
                    ch += sys.stdin.read(2)
                if ch in _KEYMAP:
                    keys.add(_KEYMAP[ch])
            if keys:
                params = move_camera(params, keys)
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
        sys.stdout.write("\x1b[0m\n")
