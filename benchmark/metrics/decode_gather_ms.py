"""A decode request's gather of its chunks into one host array
(``torch.cat(...).numpy()``): ``inr.decode.gather`` a request
(``inr.decode``)."""

from benchmark.metrics import _program


def read(ctx: dict) -> float | None:
    return _program.per_root_ms("inr.decode", ("inr.decode.gather",))
