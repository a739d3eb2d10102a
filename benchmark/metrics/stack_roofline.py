"""The stack kernel (``siren_stack_*``): the forward of every request in
the window, as a share of its roofline."""

from benchmark import counts
from benchmark.metrics._shared import roofline


def read(ctx: dict) -> float | None:
    return roofline(ctx, counts.forward_work(ctx["cfg"], ctx["rows"]),
                    "siren_stack_")
