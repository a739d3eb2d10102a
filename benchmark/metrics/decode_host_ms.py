"""A decode request's wall time less its kernels' device time: the copies,
the wrapper and its plan (``eval/decode.decode_dense``)."""

from benchmark.metrics._shared import kernel_s


def read(ctx: dict) -> float | None:
    kernels = kernel_s(ctx, "")
    if kernels <= 0 or not ctx.get("requests"):
        return None
    return 1e3 * (ctx["request_wall_s"] - kernels) / ctx["requests"]
