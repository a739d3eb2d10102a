from .observability import (MetricsLogger, StepTimer, profile_trace,
                            read_metrics)

__all__ = ["MetricsLogger", "StepTimer", "profile_trace", "read_metrics"]
