"""A KAN step's wall time less G's and H's device time: the autograd glue,
the loss, and the update of ``train/loop._make_update``."""

from benchmark.metrics._shared import kernel_s

GH = ("kan_fwd_", "kan_split_kernel", "kan_bwd_", "kan_dx_",
      "kan_dw_kernel", "kan_gsplit_kernel", "kan_reduce_kernel")


def read(ctx: dict) -> float | None:
    t = kernel_s(ctx, *GH)
    if t <= 0:
        return None
    return 1e3 * (ctx["wall_s"] - t) / ctx["steps"]
