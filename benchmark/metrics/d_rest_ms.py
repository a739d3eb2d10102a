"""Kernel D's other launches a step: the weight split, dW, the reduce, and
the epilogue (scale + Adam)."""

from benchmark.metrics._shared import kernel_s

D_REST = ("siren_wsplit_kernel", "siren_dw_kernel", "siren_reduce_kernel",
          "siren_scale_kernel", "siren_adam_kernel")


def read(ctx: dict) -> float | None:
    t = kernel_s(ctx, *D_REST)
    return None if t <= 0 else 1e3 * t / ctx["steps"]
