"""The card's peak allocated memory over the fit window
(``torch.cuda.max_memory_allocated``), in GiB."""


def read(ctx: dict) -> float | None:
    peak = ctx.get("window_peak_bytes")
    return peak / 2 ** 30 if peak else None
