"""The whole step's model FLOP (MACs only) over the window's wall time, as a
share of the card's dense bf16 peak."""

from benchmark import counts
from benchmark.metrics._shared import mfu


def read(ctx: dict) -> float | None:
    return mfu(ctx, counts.train_step_flop(ctx["cfg"], ctx["rows"]))
