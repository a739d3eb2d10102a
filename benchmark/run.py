"""Run one cell of the port's benchmark on the card and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
which also end standard error.  Exits non-zero, printing no result, when
the card is missing, when the cell's files are not there, or when the
process holds JAX or the JAX package after the window.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "inraudio_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (whole names: ``inraudio_tpu_torch`` is not one)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _finite(x):
    """JSON has no NaN or infinity: a reading that is not finite is
    written as null."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from .harness import find_workload, load_bench, run_cell

    bench = load_bench()
    chips = find_workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); CUDA available: "
              f"{torch.cuda.is_available()}, cards: "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(bench, args.workload, args.seed % (1 << 63),
                   args.seconds, bool(args.trace), torch.device("cuda", 0),
                   T_START)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark runs the "
              "port alone", file=sys.stderr)
        return 3
    out = _finite(out)
    for name, t in out.pop("setup_marks"):
        print(f"setup {name} done at {t:.3f} s", file=sys.stderr)
    checks = out.pop("checks")
    out["checks"] = checks
    for name, row in checks.items():
        print(f"check {name} {row['value']} limit {row['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
