from .audio_io import read_wav, write_wav
from .coords import get_coord

__all__ = ["get_coord", "read_wav", "write_wav"]
