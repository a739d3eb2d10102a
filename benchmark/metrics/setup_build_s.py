"""The process's seconds in ``ops/_nvcc.build_library``: every library's
nvcc build (``nvcc.build_s.<library>``) and load (``nvcc.load_s.<library>``).
A run that finds the libraries built reads only their loads, so two runs
compare only where both found the build cache in the same state."""

from benchmark.metrics import _program

PARTS = ("nvcc.build_s.", "nvcc.load_s.")


def read(ctx: dict) -> float | None:
    seconds = [v for k, v in (_program.counters() or {}).items()
               if k.startswith(PARTS)]
    return float(sum(seconds)) if seconds else None
