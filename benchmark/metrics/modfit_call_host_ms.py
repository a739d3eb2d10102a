"""The host's once-a-call work of ``train.modulated.modulated_fit``: the self
time of ``inr.modfit.prologue`` (the init, the targets and coordinates to
the card, the Adam and plateau state) and ``inr.modfit.epilogue`` (the best
snapshot, the history to the host, the all-gather), the waits for the card
(``inr.modfit.sync``) left out, a call (``inr.modfit``)."""

from benchmark.metrics import _program


def read(ctx: dict) -> float | None:
    return _program.per_root_ms("inr.modfit", ("inr.modfit.prologue",
                                               "inr.modfit.epilogue"))
