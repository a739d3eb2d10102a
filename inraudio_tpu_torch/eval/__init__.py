from .decode import bwe_coords, decode_dense, decode_problem
from .metrics import experiment_record, reconstruction_snr, save_parameters

__all__ = ["bwe_coords", "decode_dense", "decode_problem",
           "experiment_record", "reconstruction_snr", "save_parameters"]
