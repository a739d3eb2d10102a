"""One reader a per-layer metric: ``<metric>.py``, whose ``read(ctx)``
returns the value, or None where the trace holds nothing for it."""
