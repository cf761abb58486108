"""Float64 reference tracer: the correctness oracle for the JAX renderers."""

from loltracer_tpu.golden.tracer import (
    render_golden,
    render_golden_scalar,
    trace_pixel,
)

__all__ = ["render_golden", "render_golden_scalar", "trace_pixel"]
