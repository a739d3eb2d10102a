"""The metric readers' only door to the program's own spans and counters
(``inraudio_tpu_torch.utils.observability``), so that a test can stand a
fake in its place.  A program without them (one from before them) reads
as None: its readers return None."""

from __future__ import annotations


def _observability():
    try:
        from inraudio_tpu_torch.utils import observability
    except ImportError:
        return None
    return observability


def spans() -> list | None:
    """The spans the program recorded in the traced window, or None."""
    read = getattr(_observability(), "spans", None)
    return None if read is None else list(read())


def counters() -> dict | None:
    """The program's counters now, or None."""
    read = getattr(_observability(), "counters", None)
    return None if read is None else dict(read())


def per_root_ms(root: str, names: tuple[str, ...]) -> float | None:
    """The self time (duration less the spans opened inside it) of every
    span named one of ``names`` inside a span named ``root``, summed, over
    the number of ``root`` spans, in ms; None where no ``root`` span was
    recorded."""
    records = spans()
    if not records:
        return None
    by_id = {r.id: r for r in records}
    own = {r.id: r.end_ns - r.start_ns for r in records}
    for r in records:
        if r.parent in own:
            own[r.parent] -= r.end_ns - r.start_ns
    roots = sum(r.name == root for r in records)
    if not roots:
        return None
    total = 0
    for r in records:
        if r.name in names and _inside(r, root, by_id):
            total += own[r.id]
    return total / roots / 1e6


def _inside(r, root: str, by_id: dict) -> bool:
    r = by_id.get(r.parent)
    while r is not None:
        if r.name == root:
            return True
        r = by_id.get(r.parent)
    return False
