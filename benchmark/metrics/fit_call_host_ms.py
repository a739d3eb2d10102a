"""The host's once-a-call work of ``train.loop.fit``: the self time of
``inr.fit.prologue`` (state to the card, route, step build, flat state,
targets) and ``inr.fit.epilogue`` (unstack, the histories to the host),
the waits for the card (``inr.fit.sync``) left out, a call (``inr.fit``)."""

from benchmark.metrics import _program


def read(ctx: dict) -> float | None:
    return _program.per_root_ms("inr.fit",
                                ("inr.fit.prologue", "inr.fit.epilogue"))
