"""Kernel D's sweep (``siren_sweep_kernel``): the forward, cotangent and dx
of every step in the window, as a share of its roofline."""

from benchmark import counts
from benchmark.metrics._shared import roofline


def read(ctx: dict) -> float | None:
    return roofline(ctx, counts.sweep_work(ctx["cfg"], ctx["rows"]),
                    "siren_sweep_kernel")
