from .audio_io import decimate, read_wav, write_wav
from .coords import get_coord
from .fittings import (FittingProblem, waveform_fitting,
                       waveform_fitting_from_array)

__all__ = ["FittingProblem", "decimate", "get_coord", "read_wav",
           "waveform_fitting", "waveform_fitting_from_array", "write_wav"]
