from .observability import MetricsLogger, profile_trace, read_metrics

__all__ = ["MetricsLogger", "profile_trace", "read_metrics"]
