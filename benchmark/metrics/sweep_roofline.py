"""Kernel D's sweep (``siren_sweep_kernel``): the forward, cotangent and dx
of every step in the window (of every window's model, in a population), as
a share of its roofline."""

from benchmark import counts
from benchmark.metrics._shared import roofline


def read(ctx: dict) -> float | None:
    return roofline(ctx, counts.sweep_work(ctx["cfg"], ctx["rows"],
                                           ctx.get("windows", 1)),
                    "siren_sweep_kernel")
