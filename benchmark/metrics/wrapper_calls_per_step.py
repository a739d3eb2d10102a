"""Kernel-wrapper calls a step: the change of the ``launches.*`` counters
(``ops/_nvcc.LaunchCounter``, one a call of a wrapper) over the window's
``inr.fit`` spans, over those spans' steps.  A wrapper call launches one
kernel or several (the KAN's G and H launch a split, a kernel per layer
and a reduce): this counts the calls, not the kernels they launch, nor
PyTorch's own kernels."""

from benchmark.metrics import _program


def read(ctx: dict) -> float | None:
    fits = [r for r in _program.spans() or ()
            if r.name == "inr.fit" and "counters" in r.attrs]
    steps = sum(r.attrs.get("steps", 0) for r in fits)
    if not steps:
        return None
    return sum(v for r in fits for k, v in r.attrs["counters"].items()
               if k.startswith("launches.")) / steps
