from .adaptive import (AdaptivePlan, detect_transients, istmdct_adaptive,
                       plan_blocks, stmdct_adaptive)
from .filters import butter_coeffs, filtfilt, hpfilter, lfilter, lpfilter
from .mdct import imdct, istmdct, mdct, num_stmdct_frames, stmdct
from .psycho import hearing_threshold_mask, intensity, thresh_quiet
from .snr import calculate_snr
from .stft import (frame_signal, griffin_lim, istft, stft, stft_magnitude,
                   stft_real_imag)
from .windows import (hann_window, hann_window_periodic, kbd_window,
                      long_window, rect_window, short_window, sine_window,
                      transition_start_window, transition_stop_window)

__all__ = [
    "sine_window", "hann_window", "hann_window_periodic", "kbd_window",
    "rect_window",
    "long_window", "short_window", "transition_start_window",
    "transition_stop_window",
    "mdct", "imdct", "stmdct", "istmdct", "num_stmdct_frames",
    "AdaptivePlan", "detect_transients", "plan_blocks", "stmdct_adaptive",
    "istmdct_adaptive",
    "calculate_snr",
    "butter_coeffs", "lfilter", "filtfilt", "hpfilter", "lpfilter",
    "stft_magnitude", "frame_signal", "stft", "stft_real_imag", "istft",
    "griffin_lim",
    "thresh_quiet", "intensity", "hearing_threshold_mask",
]
