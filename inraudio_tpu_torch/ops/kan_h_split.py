"""Kernel H of each KAN layer split into its launches, timed on one card.

``launch_split`` runs one layer's H (``kan_fused.layer_backward``) on a
library whose every C entry is bracketed by CUDA events on the current
stream, and returns the layer's time and each entry's (the splits of g
and W, the dW pass, the fixed-order reduce, the dx kernel): ms a call,
summed over an entry's launches in the call.  ``chip_smoke.py`` phase 29
calls it on the checkout's tree.  Run alone it times a tree's H at the
runner KAN's widths over the synthetic clip's 308,207 rows, at grid
extension's configs (the wide build of ``csrc/kan.cu``), bf16x3:

    python3 inraudio_tpu_torch/ops/kan_h_split.py ROOT

imports ``inraudio_tpu_torch`` from the tree at ROOT (a parent commit
unpacked beside the checkout with ``git archive``, or ``.``) and prints
one JSON line a config after the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys

# the runner KAN's widths, the synthetic clip's rows, phase 29's configs
LAYERS = (1, 256, 256, 1)
ROWS = 308_207
CONFIGS = ((20, 3), (5, 5), (100, 3), (5, 8))


class _TimedLibrary:
    """A kan.cu library whose C entries record a CUDA event pair around
    each call: ``events`` holds (entry, start, end)."""

    def __init__(self, torch, lib):
        self._torch, self._lib, self.events = torch, lib, []

    def __getattr__(self, name):
        fn = getattr(self._lib, name)

        def call(*args):
            start = self._torch.cuda.Event(enable_timing=True)
            end = self._torch.cuda.Event(enable_timing=True)
            start.record()
            rc = fn(*args)
            end.record()
            self.events.append((name, start, end))
            return rc

        return call


def launch_split(torch, kf, lib, x, grid, g, w_t, s, order, mode, need_dx,
                 iters=3):
    """One layer's H timed whole and launch by launch, ``iters`` calls
    after a warm-up: (ms a call, {entry: (launches a call, ms a call)})."""
    stream = torch.cuda.current_stream().cuda_stream
    kf.layer_backward(lib, x, grid, g, w_t, s, order, mode, stream, need_dx)
    torch.cuda.synchronize()
    timed = _TimedLibrary(torch, lib)
    calls = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        kf.layer_backward(timed, x, grid, g, w_t, s, order, mode, stream,
                          need_dx)
        end.record()
        calls.append((start, end))
    torch.cuda.synchronize()
    total = sum(a.elapsed_time(b) for a, b in calls) / iters
    parts: dict[str, list] = {}
    for name, a, b in timed.events:
        p = parts.setdefault(name, [0, 0.0])
        p[0] += 1
        p[1] += a.elapsed_time(b)
    return total, {k: (n // iters, ms / iters) for k, (n, ms) in
                   parts.items()}


def stack_split(torch, kf, layers, xs, order, mode, iters=3):
    """``launch_split`` of every layer of a stack, each on the cotangent
    ones / n of its width (phase 29's): [(layer, din, dout, ms, parts)]."""
    out = []
    for li, (grid, w_t) in enumerate(layers):
        x = xs[li]
        s = kf._layer_shape(x, grid, w_t, order, li)
        g = torch.ones((s.n, s.dout), device=x.device) / s.n
        lib = kf.kan_library(order, s.nk)()
        ms, parts = launch_split(torch, kf, lib, x, grid, g, w_t, s, order,
                                 mode, li > 0, iters)
        out.append((li, s.din, s.dout, ms, parts))
        del g
    return out


def main(root: str) -> int:
    sys.path.insert(0, root)
    import torch

    from inraudio_tpu_torch.models import KANConfig, build_model
    from inraudio_tpu_torch.ops import kan_fused as kf

    if not torch.cuda.is_available():
        print("needs an NVIDIA card: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"nvidia-smi: {smi}; tree {root}")
    dev = torch.device("cuda")
    kf.KAN_WIDE_LIBRARY()
    coords = torch.linspace(-1, 1, ROWS, device=dev)[:, None]
    mode = kf.kan_dot_mode()
    for grid_size, order in CONFIGS:
        cfg = KANConfig(layers_hidden=LAYERS, grid_size=grid_size,
                        spline_order=order)
        params = build_model("kan", cfg, fused=True).init(
            torch.Generator().manual_seed(0), dev)
        flat = [t.detach().contiguous()
                for t in kf.flatten_kan_params(params)]
        layers = list(zip(flat[0::2], flat[1::2]))
        _, xs = kf.KAN_FWD(layers, coords, order, mode)
        rows = stack_split(torch, kf, layers, xs, order, mode)
        print(json.dumps({"config": f"g{grid_size}o{order}", "mode": mode,
                          "rows": ROWS, "layers": [
                              {"layer": li, "din": di, "dout": do,
                               "ms": ms, "launches": parts}
                              for li, di, do, ms, parts in rows]}))
        del xs, layers, flat, params
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1]))
