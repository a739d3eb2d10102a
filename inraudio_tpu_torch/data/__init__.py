from .audio_io import decimate, read_wav, write_wav
from .coords import get_coord, grid_coords_2d
from .fittings import (FittingProblem, fft_fitting, mdct_fitting,
                       multi_waveform_fitting, waveform_fitting,
                       waveform_fitting_from_array)

__all__ = ["FittingProblem", "decimate", "fft_fitting", "get_coord",
           "grid_coords_2d", "mdct_fitting", "multi_waveform_fitting",
           "read_wav", "waveform_fitting", "waveform_fitting_from_array",
           "write_wav"]
