"""The stack kernel's host side a decode request: the self time of
``inr.stack`` (``fused_siren_train_apply``: its plan, checks and the
autograd function around the wrapper), ``inr.stack.prepare`` (the
wrapper's padding, checks, pointer lists and launch plan) and
``inr.stack.launch`` (the ctypes calls) a request (``inr.decode``)."""

from benchmark.metrics import _program


def read(ctx: dict) -> float | None:
    return _program.per_root_ms(
        "inr.decode", ("inr.stack", "inr.stack.prepare", "inr.stack.launch"))
