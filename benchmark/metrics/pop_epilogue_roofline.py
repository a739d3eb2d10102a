"""Kernel D's epilogue over a window population (``siren_scale_kernel``, each
window's clip scale, and ``siren_adam_kernel``, clip, Adam and the best
snapshot) in every step of the window, as a share of its byte bound."""

from benchmark import counts
from benchmark.metrics._shared import roofline


def read(ctx: dict) -> float | None:
    work = counts.epilogue_work(ctx["cfg"], ctx["windows"] * ctx["steps"],
                                ctx["improved"])
    return roofline(ctx, work, "siren_scale_kernel", "siren_adam_kernel")
