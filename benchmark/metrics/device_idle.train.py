"""The share of the traced fit window in which no operation ran on the
card."""

from benchmark.metrics._shared import idle


def read(ctx: dict) -> float | None:
    return idle(ctx)
