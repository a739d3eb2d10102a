"""The port's DSP (``inraudio_tpu_torch.dsp``) and spectral metrics held
against the JAX package's on the CPU, on signals made from a numpy seed.

Tolerances, and why:
- windows: host numpy in both packages, so exact;
- MDCT / IMDCT / STMDCT / ISTMDCT and the STFT (basis matmul, and the
  ``use_fft`` oracle): SPEC_RTOL of the largest coefficient; both are
  float32 products of length <= 2048 summed in different orders (XLA's dot,
  torch.matmul, pocketfft), ~1e-7 relative each;
- the round trips: >= ROUND_TRIP_DB (120) between signal and reconstruction
  in the frames' interior, the adaptive banks' >= 100 dB;
- ``filtfilt`` / ``hpfilter``: 1e-5 of the peak against the JAX recurrence
  run in float64 (the JAX package's float32 recurrence diverges to NaN at
  these cutoffs: see ``dsp.filters``);
- ``hearing_threshold_mask``: 1e-6 (float32 pow / exp in both);
- Griffin-Lim: momentum 0.99 amplifies rounding, so after GL_SHORT
  iterations the outputs agree to GL_SHORT_RTOL of the peak, and after 60
  iterations the spectral convergence of both reconstructions agrees within
  GL_SC_MARGIN.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inraudio_tpu import dsp as jdsp
from inraudio_tpu.dsp import adaptive as jadaptive
from inraudio_tpu.eval import metrics as jmetrics
from inraudio_tpu_torch import dsp as tdsp
from inraudio_tpu_torch.dsp import adaptive as tadaptive
from inraudio_tpu_torch.eval import metrics as tmetrics

torch.set_num_threads(1)

SPEC_RTOL = 1e-5
ROUND_TRIP_DB = 120.0
ADAPTIVE_DB = 100.0
FILTER_RTOL = 1e-5
MASK_ATOL = 1e-6
GL_SHORT, GL_SHORT_RTOL = 2, 1e-4
GL_SC_MARGIN = 0.02


def _signal(n=8192, seed=0, sr=16000.0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    x = (np.sin(2 * np.pi * 220 * t) + 0.4 * np.sin(2 * np.pi * 1700 * t)
         + 0.05 * rng.standard_normal(n))
    return (0.8 * x / np.max(np.abs(x))).astype(np.float32)


def _close(out, ref, rtol=SPEC_RTOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=rtol * float(np.abs(ref).max()))


def _snr_db(a, b):
    return 10 * np.log10(np.sum(a.astype(np.float64) ** 2)
                         / np.sum((a.astype(np.float64) - b) ** 2))


@pytest.mark.parametrize("name,args", [
    ("sine_window", (64,)), ("hann_window", (64,)),
    ("hann_window_periodic", (512,)), ("kbd_window", (2048,)),
    ("kbd_window", (256, 6.0)), ("rect_window", (16,)),
    ("long_window", (1024,)), ("short_window", (128,)),
    ("transition_start_window", (2048, 256)),
    ("transition_stop_window", (2048, 256))])
def test_windows_are_exact(name, args):
    a, b = getattr(tdsp, name)(*args), getattr(jdsp, name)(*args)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("use_fft", [False, True], ids=["basis", "fft"])
@pytest.mark.parametrize("a,b", [(512, 512), (1024, 128), (64, 64)])
def test_mdct_imdct_match_jax(a, b, use_fft):
    frames = np.random.default_rng(a + b).standard_normal(
        (5, a + b)).astype(np.float32)
    out = tdsp.mdct(torch.from_numpy(frames), a, b, use_fft=use_fft)
    ref = jdsp.mdct(jnp.asarray(frames), a, b, use_fft=use_fft)
    _close(out.numpy(), ref)
    # the FFT form is the oracle of the basis form
    _close(out.numpy(), tdsp.mdct(torch.from_numpy(frames), a, b,
                                   use_fft=not use_fft).numpy())
    coeffs = np.array(ref)
    back = tdsp.imdct(torch.from_numpy(coeffs), a, b, use_fft=use_fft)
    _close(back.numpy(), jdsp.imdct(jnp.asarray(coeffs), a, b,
                                     use_fft=use_fft))


@pytest.mark.parametrize("use_fft", [False, True], ids=["basis", "fft"])
@pytest.mark.parametrize("n,length", [(2048, 20000), (1024, 8192)])
def test_stmdct_istmdct_match_jax_and_round_trip(n, length, use_fft):
    x = _signal(length)
    assert tdsp.num_stmdct_frames(length, n) == jdsp.num_stmdct_frames(
        length, n)
    spec = tdsp.stmdct(torch.from_numpy(x), n=n, use_fft=use_fft)
    ref = jdsp.stmdct(jnp.asarray(x), n=n, use_fft=use_fft)
    assert spec.shape == (n // 2, length // (n // 2))
    _close(spec.numpy(), ref)
    rec = tdsp.istmdct(spec, n=n, use_fft=use_fft).numpy()
    _close(rec, jdsp.istmdct(ref, n=n, use_fft=use_fft))
    half = n // 2
    interior = slice(half, len(rec) - half)
    assert _snr_db(x[interior], rec[interior]) >= ROUND_TRIP_DB


@pytest.mark.parametrize("use_fft", [False, True], ids=["basis", "fft"])
@pytest.mark.parametrize("n_fft,hop", [(1024, 256), (512, 50), (256, None)])
def test_stft_matches_jax_and_torch_stft(n_fft, hop, use_fft):
    x = _signal(6000, seed=1)
    window = tdsp.hann_window_periodic(n_fft)
    re, im = tdsp.stft_real_imag(torch.from_numpy(x), n_fft, hop,
                                 torch.from_numpy(window), use_fft=use_fft)
    jre, jim = jdsp.stft_real_imag(jnp.asarray(x), n_fft, hop,
                                   jnp.asarray(window))
    scale = float(np.max(np.hypot(np.asarray(jre), np.asarray(jim))))
    for a, b in ((re, jre), (im, jim)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=SPEC_RTOL * scale)
    ref = torch.stft(torch.from_numpy(x), n_fft, hop, window=torch.from_numpy(
        window), center=True, pad_mode="reflect", return_complex=True)
    np.testing.assert_allclose(re.numpy(), ref.real.numpy(), rtol=0,
                               atol=SPEC_RTOL * scale)
    mag = tdsp.stft_magnitude(torch.from_numpy(x), n_fft, hop,
                              torch.from_numpy(window), eps=1e-8,
                              use_fft=use_fft)
    _close(mag.numpy(), jdsp.stft_magnitude(jnp.asarray(x), n_fft, hop,
                                            jnp.asarray(window), eps=1e-8))
    hop_ = hop or n_fft // 4
    if n_fft % hop_ == 0:  # an overlap-add that covers every sample
        back = tdsp.istft(re, im, n_fft, hop, torch.from_numpy(window),
                          length=len(x), use_fft=use_fft)
        jback = jdsp.istft(jre, jim, n_fft, hop, jnp.asarray(window),
                           length=len(x))
        _close(back.numpy(), jback)
        covered = (re.shape[1] - 1) * hop_  # past it: zeros, as torch.istft
        assert _snr_db(x[:covered], back.numpy()[:covered]) >= ROUND_TRIP_DB


def test_stft_frames_raise_like_jax():
    for fn in (tdsp.frame_signal, jdsp.frame_signal):
        with pytest.raises(ValueError, match="too short for reflect"):
            fn(np.zeros(100, np.float32) if fn is jdsp.frame_signal
               else torch.zeros(100), 256, 64)
    with pytest.raises(ValueError, match="shorter than frame_length"):
        tdsp.frame_signal(torch.zeros(100), 256, 64, center=False)


def _spectral_convergence(mag, x, n_fft):
    w = torch.from_numpy(tdsp.hann_window_periodic(n_fft))
    est = tdsp.stft_magnitude(torch.as_tensor(x), n_fft, n_fft // 4, w)
    est = est[:, :mag.shape[1]].numpy()
    return float(np.linalg.norm(mag - est) / np.linalg.norm(mag))


def test_griffin_lim_matches_jax():
    n_fft = 512
    x = _signal(8000, seed=2)
    w = tdsp.hann_window_periodic(n_fft)
    mag = np.array(jdsp.stft_magnitude(jnp.asarray(x), n_fft, n_fft // 4,
                                         jnp.asarray(w)))
    kw = dict(n_fft=n_fft, hop=n_fft // 4, length=len(x))
    short = tdsp.griffin_lim(torch.from_numpy(mag), window=torch.from_numpy(w),
                             n_iters=GL_SHORT, **kw)
    jshort = jdsp.griffin_lim(jnp.asarray(mag), window=jnp.asarray(w),
                              n_iters=GL_SHORT, **kw)
    _close(short.numpy(), jshort, GL_SHORT_RTOL)
    full = tdsp.griffin_lim(torch.from_numpy(mag), window=torch.from_numpy(w),
                            **kw).numpy()
    jfull = np.asarray(jdsp.griffin_lim(jnp.asarray(mag),
                                        window=jnp.asarray(w), **kw))
    sc, jsc = (_spectral_convergence(mag, y, n_fft) for y in (full, jfull))
    assert np.isfinite(full).all() and sc < 0.5
    assert abs(sc - jsc) <= GL_SC_MARGIN, (sc, jsc)
    # the FFT form of the same iteration
    fft = tdsp.griffin_lim(torch.from_numpy(mag), window=torch.from_numpy(w),
                           use_fft=True, **kw).numpy()
    assert abs(_spectral_convergence(mag, fft, n_fft) - sc) <= GL_SC_MARGIN


@pytest.mark.parametrize("btype,cutoff", [("lowpass", 1000.0),
                                          ("highpass", 100.0),
                                          ("highpass", 150.0)])
def test_filters_match_jax(btype, cutoff):
    sr = 44100.0
    x = _signal(30000, seed=3, sr=sr)
    b, a = tdsp.butter_coeffs(5, cutoff, btype, sr)
    jb, ja = jdsp.butter_coeffs(5, cutoff, btype, sr)
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(a, ja)
    x64 = jnp.asarray(x, jnp.float64)
    ref = np.asarray(jdsp.filtfilt(jb, ja, x64))
    out = tdsp.filtfilt(b, a, torch.from_numpy(x))
    assert out.dtype == torch.float32
    _close(out.numpy(), ref, FILTER_RTOL)
    lf = tdsp.lfilter(b, a, x)
    _close(lf, np.asarray(jdsp.lfilter(jb, ja, x64)), FILTER_RTOL)
    fn = tdsp.hpfilter if btype == "highpass" else tdsp.lpfilter
    jfn = jdsp.hpfilter if btype == "highpass" else jdsp.lpfilter
    _close(fn(x, cutoff, sr), np.asarray(jfn(x64, cutoff, sr)), FILTER_RTOL)


def test_filtfilt_short_signal_raises_like_jax():
    b, a = tdsp.butter_coeffs(5, 100.0, "highpass", 44100.0)
    for short in (np.zeros(18, np.float32), np.zeros(5, np.float32)):
        with pytest.raises(ValueError, match="padlen"):
            tdsp.filtfilt(b, a, short)
        with pytest.raises(ValueError, match="padlen"):
            jdsp.filtfilt(b, a, jnp.asarray(short))


@pytest.mark.parametrize("n,sr,frames", [(2048, 44100.0, 300),
                                         (512, 16000.0, 7)])
def test_hearing_threshold_mask_matches_jax(n, sr, frames):
    out = tdsp.hearing_threshold_mask(n, sr, frames)
    ref = jdsp.hearing_threshold_mask(n, sr, frames)
    assert out.shape == ref.shape == (n // 2 * frames, 1)
    assert out.dtype == ref.dtype
    np.testing.assert_allclose(out, ref, rtol=0, atol=MASK_ATOL)
    f = np.array([10.0, 100.0, 3300.0, 15000.0])
    np.testing.assert_allclose(tdsp.thresh_quiet(f).numpy(),
                               np.asarray(jdsp.thresh_quiet(f)), rtol=1e-6)
    np.testing.assert_allclose(tdsp.intensity(torch.tensor([60.0])).numpy(),
                               np.asarray(jdsp.intensity(60.0)), rtol=1e-6)


def _clicks(n=40000, seed=4):
    rng = np.random.default_rng(seed)
    x = 0.01 * rng.standard_normal(n)
    for pos in (5000, 21000, 33000):
        x[pos:pos + 40] += 0.9
    return x.astype(np.float32)


@pytest.mark.parametrize("n_long,n_short", [(2048, 256), (1024, 128)])
def test_adaptive_matches_jax_and_round_trips(n_long, n_short):
    x = _clicks()
    flags = tdsp.detect_transients(x, n_long, n_short)
    np.testing.assert_array_equal(flags, jdsp.detect_transients(
        x, n_long, n_short))
    assert flags.any()
    plan = tdsp.plan_blocks(len(x), flags, n_long, n_short)
    jplan = jdsp.plan_blocks(len(x), flags, n_long, n_short)
    assert (plan.kinds, plan.offsets, plan.total_coeffs) == (
        jplan.kinds, jplan.offsets, jplan.total_coeffs)
    banks = tdsp.stmdct_adaptive(torch.from_numpy(x), plan)
    jbanks = jdsp.stmdct_adaptive(jnp.asarray(x), jplan)
    assert banks.keys() == jbanks.keys()
    for k in banks:
        _close(banks[k].numpy(), jbanks[k])
    rec = tdsp.istmdct_adaptive(banks, plan).numpy()
    _close(rec, jdsp.istmdct_adaptive(jbanks, jplan))
    interior = slice(n_long, plan.num_samples - n_long)
    assert _snr_db(x[interior], rec[interior]) >= ADAPTIVE_DB
    assert tadaptive.KINDS == jadaptive.KINDS


def test_adaptive_rejects_sizes_like_jax():
    for fn in (tdsp.plan_blocks, jdsp.plan_blocks):
        with pytest.raises(ValueError, match="must divide"):
            fn(10000, np.zeros(9, bool), 2048, 384)
        with pytest.raises(ValueError, match="must be even"):
            fn(10000, np.zeros(9, bool), 2047, 256)


def test_spectral_metrics_match_jax():
    x = _signal(9000, seed=5)
    y = (1.7 * x + 0.01 * np.random.default_rng(6).standard_normal(
        len(x))).astype(np.float32)
    np.testing.assert_allclose(tmetrics.si_snr(x, y), jmetrics.si_snr(x, y),
                               rtol=1e-5)
    np.testing.assert_allclose(tmetrics.log_spectral_distance(x, y[:8000]),
                               jmetrics.log_spectral_distance(x, y[:8000]),
                               rtol=1e-4)
    np.testing.assert_allclose(tmetrics.calculate_snr(x, y).item(),
                               float(jmetrics.calculate_snr(x, y)), rtol=1e-5)


def test_dsp_exports_match_jax():
    assert sorted(tdsp.__all__) == sorted(jdsp.__all__)
