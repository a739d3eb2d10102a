"""What the metric readers share: kernel time by name, and a roofline share
from the benchmark's counts.  A reader returns None where the trace holds
nothing for it to read."""

from __future__ import annotations

from benchmark import counts


def kernel_s(ctx: dict, *parts: str) -> float:
    """Device seconds of the traced window's kernels whose name holds one
    of ``parts``."""
    return sum(s for name, s in ctx.get("kernels", {}).items()
               if any(p in name for p in parts))


def roofline(ctx: dict, work: counts.Work, *parts: str) -> float | None:
    """The least time of ``work`` over the kernels' time, in %."""
    t = kernel_s(ctx, *parts)
    return None if t <= 0 else 100.0 * work.least_s() / t


def idle(ctx: dict) -> float | None:
    if not ctx.get("window_s") or "busy_s" not in ctx:
        return None
    return 100.0 * (ctx["window_s"] - ctx["busy_s"]) / ctx["window_s"]


def mfu(ctx: dict, flop: float) -> float | None:
    if not ctx.get("wall_s"):
        return None
    return 100.0 * flop / ctx["wall_s"] / counts.PEAK_TENSOR_FLOP_S
