"""Rendering: the differentiable jnp path, with Pallas-on-Triton kernels
for the frozen march value passes (render/triton_march.py)."""

from loltracer_tpu.render.jnp_renderer import render_image, make_renderer

__all__ = ["render_image", "make_renderer"]
