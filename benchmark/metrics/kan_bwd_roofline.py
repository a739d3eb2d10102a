"""Kernel H (``kan_bwd_*``, ``kan_dx_*``, ``kan_dw_kernel``, the cotangent
split and the reduce): the KAN's dx and dW of every step in the window, as
a share of its roofline."""

from benchmark import counts
from benchmark.metrics._shared import roofline

H = ("kan_bwd_", "kan_dx_", "kan_dw_kernel", "kan_gsplit_kernel",
     "kan_reduce_kernel")


def read(ctx: dict) -> float | None:
    return roofline(ctx, counts.backward_work(ctx["cfg"], ctx["rows"]), *H)
