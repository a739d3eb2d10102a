from .decode import bwe_coords, decode_dense, decode_problem
from .metrics import (calculate_snr, experiment_record,
                      log_spectral_distance, reconstruction_snr,
                      save_parameters, si_snr)

__all__ = ["bwe_coords", "calculate_snr", "decode_dense", "decode_problem",
           "experiment_record", "log_spectral_distance",
           "reconstruction_snr", "save_parameters", "si_snr"]
