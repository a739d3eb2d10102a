from .snr import calculate_snr

__all__ = ["calculate_snr"]
