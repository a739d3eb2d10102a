"""A decode request's move of the parameters and coordinates to the card:
the self time of ``inr.decode.prepare`` a request (``inr.decode``)."""

from benchmark.metrics import _program


def read(ctx: dict) -> float | None:
    return _program.per_root_ms("inr.decode", ("inr.decode.prepare",))
