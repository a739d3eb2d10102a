from .observability import MetricsLogger, read_metrics

__all__ = ["MetricsLogger", "read_metrics"]
