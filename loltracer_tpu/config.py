"""Render configuration.

The reference hardcodes every render constant at compile time
(march: naive_renderer.c:49-51, shadows: naive_renderer.c:99,
normal h: naive_renderer.c:119, gamma: naive_renderer.c:231).
Here they are a single config dataclass, hashable so it can be a static
argument to jitted renderers.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All render-time constants, defaulting to the reference's values."""

    # Sphere-trace march (naive_renderer.c:49-51)
    max_steps: int = 256
    epsilon: float = 1e-3
    max_dist: float = 100.0

    # Soft shadows (naive_renderer.c:92-100): 128 steps, sharpness w=50,
    # shadow-ray origin offset of a full unit toward the light
    # (naive_renderer.c:97 — a quirk we reproduce by default).
    shadow_steps: int = 128
    shadow_w: float = 50.0
    shadow_offset: float = 1.0
    shadow_epsilon: float = 1e-3  # declared but unused by the reference too

    # Normal estimation: tetrahedron taps at h = dist/100
    # (naive_renderer.c:114-125).
    normal_h_scale: float = 0.01

    # Output (naive_renderer.c:231)
    gamma: float = 1.0 / 2.2

    # Soft-coverage antialiasing (NOT in the reference; off by default for
    # pixel parity). When on, near-miss rays within ~aa_width pixels of a
    # silhouette blend the occluder's color by a differentiable coverage
    # alpha — both an image-quality feature and the source of silhouette
    # gradients for inverse rendering (render/march.py intersect_aa).
    antialias: bool = False
    aa_width: float = 1.0

    # Camera projection: the reference computes the half-height of the view
    # plane as atan(fov/2) instead of the standard tan(fov/2)
    # (naive_renderer.c:183). True reproduces the reference.
    atan_fov: bool = True

    # March backend for the (frozen) value passes of the differentiable
    # render path, the primary march and the envelope shadow march
    # (render/backend.py): "auto" = the Triton kernels on a GPU and the jnp
    # loops elsewhere; "jnp" / "triton" force one; "triton-interpret" runs
    # the kernels in the Pallas interpreter (CPU tests). Gradients are the
    # same across backends: the march results are frozen and re-attached
    # in jnp either way (render/march.py).
    march_backend: str = "auto"

    # Soft-shadow gradient estimator:
    #   "exact"    — reverse-mode AD through the full rematerialized
    #                128-step shadow scan: the exact gradient of the
    #                discretized forward computation (trajectory terms
    #                included). Backward cost: O(shadow_steps) SDF
    #                evaluations per light per pixel.
    #   "envelope" — the shadow march runs frozen (stop-gradient; the
    #                Triton kernel on a GPU) recording the argmin step t*;
    #                the gradient is re-attached via ONE differentiable SDF
    #                evaluation at t* per light. By Danskin's theorem this
    #                is the exact gradient of the idealized penumbra
    #                min(1, min_t w·f(ro+t·rd)/t) — the same
    #                frozen-fixed-point principle as the march's IFT
    #                gradient (render/march.py). Forward values are
    #                bitwise identical to "exact"; backward cost drops
    #                from O(steps) to O(1) SDF evals.
    shadow_grad: str = "exact"

    # Step clamp for INSTANCED scenes (None = exact full SDF): the march
    # evaluates the step-clamped scene distance min(d, step_clamp) instead
    # of d. Semantically simple (one extra min, reproduced identically by
    # the unbanded and banded jnp paths) and conservative: steps never
    # overshoot, hits land on the same surfaces within epsilon, and every
    # quantity that consumes small distances — hit detection, penumbra minima (w*d/t < 1 requires d << clamp),
    # normal taps, coverage alpha (s ~ pixel_rad) — sits in the d <
    # step_clamp regime where the value is EXACT. What changes is only the
    # free-space step SIZE (clamped to step_clamp), i.e. more, shorter
    # steps across empty space. What it buys: a spatial structure only has
    # to search a ball of radius step_clamp around each point, because a
    # sphere farther away can never win min(d, cut) (cut = max(clamp,
    # d_bbox), render/sdf.py). Ignored for compiled (non-instanced)
    # structures.
    step_clamp: float = None

    # Separate step clamp for the per-light SHADOW marches of instanced
    # scenes (None = follow step_clamp). The primary march wants a small
    # clamp (it sets the search radius, see above);
    # shadow marches are LONGER (up to the light distance) and their
    # penumbra values only need exact distances below light_dist/shadow_w
    # (val = w*d/t < 1 requires d < t/w <= light_dist/w, ~2 units at
    # w = 50), so they tolerate a much larger clamp — fewer, bigger steps
    # across the same field. Like step_clamp this is a documented
    # semantics knob reproduced identically by every jnp path (penumbra
    # res/t* depend on the sampled trajectory either way); values below 1
    # are unchanged whenever shadow-march t stays <= shadow_w *
    # min(step_clamp, shadow_step_clamp).
    shadow_step_clamp: float = None

    def effective_shadow_clamp(self):
        return (
            self.shadow_step_clamp
            if self.shadow_step_clamp is not None
            else self.step_clamp
        )

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    def for_forward(self) -> "RenderConfig":
        """The config for a render whose gradient is never taken: envelope
        shadows, whose frozen shadow march can run as the Triton kernel.
        On the jnp loops the image is bitwise that of "exact"."""
        return self.replace(shadow_grad="envelope")


DEFAULT_CONFIG = RenderConfig()
