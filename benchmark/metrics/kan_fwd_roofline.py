"""Kernel G (``kan_fwd_*`` and the weight split ``kan_split_kernel``): the
KAN's forward of every step in the window, as a share of its roofline."""

from benchmark import counts
from benchmark.metrics._shared import roofline

G = ("kan_fwd_", "kan_split_kernel")


def read(ctx: dict) -> float | None:
    return roofline(ctx, counts.forward_work(ctx["cfg"], ctx["rows"]), *G)
