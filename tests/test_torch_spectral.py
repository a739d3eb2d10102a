"""The port's spectral fits held against the JAX package on the CPU: the
fitting-problem builders (multi, fft, mdct with the perceptual mask, the
highpass, the shifted log and block switching), ``decode_problem`` of every
method with parameters carried across by ``params_from_jax``, the runner's
``train`` of each method on a small model with ``parameters.json``'s keys
and knobs against the JAX runner's, and the ``fit`` CLI's mdct fit with the
perceptual mask through kernel D's weighted plain version.  The clips are
synthesised into ``tmp_path`` from a numpy seed.

Tolerances, and why:
- coordinates: host numpy in both, exact;
- targets: TARGET_RTOL of the largest target (float32 transforms summed in
  other orders, ~1e-7 relative), loss weights MASK_ATOL;
- decode contracts: the same keys and every non-float value equal; the
  floats (peak, scale, mean, shift) to TARGET_RTOL of the scale;
- decodes: DECODE_RTOL of the largest sample (the model's apply differs by
  ~1e-6 relative between the packages; the ISTMDCT is linear, the shifted
  log's exp amplifies by the scale); the fft decode runs 60 Griffin-Lim
  iterations with momentum 0.99, which amplify rounding, so it is held by
  spectral convergence within GL_SC_MARGIN, and its amplitude (Griffin-Lim
  is linear in the magnitude, so a scale dropped or misapplied moves it by
  that factor) by its RMS within GL_RMS_RTOL of JAX's (measured 6e-9).

Two reference faults are not copied (``dsp.filters``, ``data.fittings``):
the JAX highpass diverges to NaN in float32, so the highpass builders are
held to the JAX filter run in float64; where the JAX shifted log is -inf
(a loud tone), the port's is held to the intended formula.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inraudio_tpu import dsp as jdsp
from inraudio_tpu.data import fittings as jfittings
from inraudio_tpu.eval import decode as jdecode
from inraudio_tpu.experiments import runner as jrunner
from inraudio_tpu.models import SirenSnakeTanhConfig as JaxConfig
from inraudio_tpu.models import build_model as jax_build_model
from inraudio_tpu_torch import dsp as tdsp
from inraudio_tpu_torch.__main__ import main as port_main
from inraudio_tpu_torch.data import fittings as tfittings
from inraudio_tpu_torch.data import write_wav
from inraudio_tpu_torch.eval import decode as tdecode
from inraudio_tpu_torch.experiments import runner as trunner
from inraudio_tpu_torch.models import (SirenSnakeTanhConfig, build_model,
                                       params_from_jax)
from inraudio_tpu_torch.ops import siren_step as ss

torch.set_num_threads(1)

FS = 16000
TARGET_RTOL = 1e-5
MASK_ATOL = 1e-6
DECODE_RTOL = 1e-5
GL_SC_MARGIN = 0.02
GL_RMS_RTOL = 1e-4
MLP = dict(hidden_features=32, first_omega_0=300.0, num_sine=1, num_snake=1)


def _clip(seconds=1.0, seed=0):
    """Two channels: partials, noise and a few clicks (transients)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * FS)) / FS
    a = (np.sin(2 * np.pi * 220 * t) + 0.4 * np.sin(2 * np.pi * 1900 * t)
         + 0.03 * rng.standard_normal(len(t)))
    b = 0.5 * np.sin(2 * np.pi * 330 * t) + 0.03 * rng.standard_normal(len(t))
    for pos in (3000, 9500):
        b[pos:pos + 30] += 1.5
    return (0.5 * np.stack([a, b], 1)).astype(np.float32)


@pytest.fixture
def wav(tmp_path):
    path = str(tmp_path / "clip.wav")
    write_wav(path, FS, _clip())
    return path


@pytest.fixture
def jax_hp64(monkeypatch):
    """The JAX builders' highpass run in float64 (their float32 recurrence
    diverges to NaN at 100 / 150 Hz)."""
    monkeypatch.setattr(jfittings, "hpfilter", lambda d, c, fs: np.asarray(
        jdsp.hpfilter(jnp.asarray(d, jnp.float64), c, fs), np.float32))


def _check_problem(tp, jp):
    np.testing.assert_array_equal(tp.coords, jp.coords)
    assert tp.targets.dtype == np.float32 and tp.targets.shape == \
        jp.targets.shape
    np.testing.assert_allclose(tp.targets, jp.targets, rtol=0,
                               atol=TARGET_RTOL * float(
                                   np.abs(jp.targets).max()))
    for field in ("sample_rate", "original_sample_rate", "height", "width",
                  "method"):
        assert getattr(tp, field) == getattr(jp, field), field
    assert tp.decode.keys() == jp.decode.keys()
    scale = abs(float(jp.decode.get("scale", jp.decode.get("peak", 1.0))))
    for k, v in jp.decode.items():
        if isinstance(v, float):
            assert abs(tp.decode[k] - v) <= TARGET_RTOL * max(scale, abs(v)), k
        else:
            assert tp.decode[k] == v, k
    if jp.loss_weight is None:
        assert tp.loss_weight is None
    else:
        assert tp.loss_weight.dtype == np.float32
        np.testing.assert_allclose(tp.loss_weight, jp.loss_weight, rtol=0,
                                   atol=MASK_ATOL)


@pytest.mark.parametrize("kw", [
    dict(n=2048), dict(n=1024, perceptual_mask=True),
    dict(n=512, adaptive=True), dict(n=1024, highpass=True),
    dict(n=2048, adaptive=True, highpass=True, perceptual_mask=True)],
    ids=["n2048", "mask", "adaptive", "highpass", "adaptive_hp"])
def test_mdct_builder_matches_jax(wav, jax_hp64, kw):
    _check_problem(tfittings.mdct_fitting(wav, 0.9, device="cpu", **kw),
                   jfittings.mdct_fitting(wav, 0.9, **kw))


@pytest.mark.parametrize("adaptive", [False, True])
def test_mdct_takelog_builder(wav, tmp_path, adaptive):
    """The shifted log: on a clip whose smallest coefficient is small the
    JAX builder's values; where the float32 sum min + (|min| + 1e-8)
    rounds to 0 (a loud pure tone), the JAX builder's targets are NaN and
    the port's take log(1e-8) at that coefficient, the rest as JAX
    computes them."""
    kw = dict(n=512, takelog=True, adaptive=adaptive)
    _check_problem(tfittings.mdct_fitting(wav, 0.9, device="cpu", **kw),
                   jfittings.mdct_fitting(wav, 0.9, **kw))
    loud = str(tmp_path / "tone.wav")
    t = np.arange(FS) / FS
    write_wav(loud, FS, (0.9 * np.sin(2 * np.pi * 440 * t)).astype(
        np.float32))
    p = tfittings.mdct_fitting(loud, 0.9, device="cpu", **kw)
    jlog = jfittings.mdct_fitting(loud, 0.9, **kw)
    assert not np.isfinite(jlog.targets).any()  # the reference's fault
    jraw = jfittings.mdct_fitting(loud, 0.9, n=512, adaptive=adaptive)
    raw = (jraw.targets[:, 0] * jraw.decode["scale"]
           + jraw.decode["mean"]).astype(np.float32)
    shift = float(np.abs(raw.min())) + 1e-8
    arg = raw + shift
    assert (arg <= 0).sum() >= 1
    logged = np.log(np.where(arg > 0, arg, np.float32(1e-8)))
    mean = float(logged.mean())
    scale = float(np.max(np.abs(logged - mean)))
    assert np.isfinite(p.targets).all() and p.decode["takelog"] is True
    np.testing.assert_allclose(p.targets[:, 0], (logged - mean) / scale,
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(p.decode["shift"], shift, rtol=1e-5)


@pytest.mark.parametrize("kw", [dict(n_fft=1024), dict(n_fft=512),
                                dict(n_fft=512, highpass=True)],
                         ids=["1024", "512", "highpass"])
def test_fft_builder_matches_jax(wav, jax_hp64, kw):
    _check_problem(tfittings.fft_fitting(wav, 0.9, device="cpu", **kw),
                   jfittings.fft_fitting(wav, 0.9, **kw))


def test_spectral_builders_default_to_the_card(wav, monkeypatch):
    """Like every entry point, the builders run their transforms on the card
    unless asked for the CPU, and raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (tfittings.mdct_fitting, tfittings.fft_fitting):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build(wav, 0.5)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trunner.build_problem("mdct", wav, 0.5)


@pytest.mark.parametrize("channels", [1, 2])
def test_multi_builder_matches_jax(wav, channels):
    _check_problem(tfittings.multi_waveform_fitting(wav, 0.5, channels),
                   jfittings.multi_waveform_fitting(wav, 0.5, channels))
    np.testing.assert_array_equal(tfittings.hann_window_torch(256),
                                  jfittings.hann_window_torch(256))


def _mirror(tp):
    """The port's problem as a JAX FittingProblem (same arrays and
    contract), so that both decodes invert one contract."""
    return jfittings.FittingProblem(**{
        f.name: getattr(tp, f.name)
        for f in dataclasses.fields(jfittings.FittingProblem)})


def _decode_both(problem, d):
    cfg = dict(MLP, in_features=d)
    jm = jax_build_model("mlp", JaxConfig(**cfg))
    tm = build_model("mlp", SirenSnakeTanhConfig(**cfg))
    jparams = jm.init(jax.random.PRNGKey(7))
    tw, trate = tdecode.decode_problem(
        tm, params_from_jax(jax.tree.map(np.asarray, jparams)), problem,
        device="cpu")
    jw, jrate = jdecode.decode_problem(jm, jparams, _mirror(problem))
    assert trate == jrate and tw.dtype == np.float32
    assert tw.shape == np.asarray(jw).shape and np.isfinite(tw).all()
    return tw, np.asarray(jw)


@pytest.mark.parametrize("kw", [dict(), dict(takelog=True),
                                dict(adaptive=True),
                                dict(adaptive=True, takelog=True)],
                         ids=["plain", "takelog", "adaptive",
                              "adaptive_takelog"])
def test_decode_mdct_matches_jax(wav, kw):
    p = tfittings.mdct_fitting(wav, 0.9, n=512, device="cpu", **kw)
    tw, jw = _decode_both(p, 2)
    np.testing.assert_allclose(tw, jw, rtol=0,
                               atol=DECODE_RTOL * float(np.abs(jw).max()))


def test_decode_fft_matches_jax(wav):
    p = tfittings.fft_fitting(wav, 0.5, n_fft=256, device="cpu")
    tw, jw = _decode_both(p, 2)
    assert len(tw) == p.decode["length"]
    w = torch.from_numpy(tdsp.hann_window_periodic(256))
    mag = torch.from_numpy(p.targets[:, 0].reshape(p.height, p.width))

    def sc(y):  # against the magnitude the model decodes, up to its scale
        est = tdsp.stft_magnitude(torch.from_numpy(y), 256, 64, w)
        est = est[:, :p.width] / float(est.max())
        return float(torch.linalg.vector_norm(mag - est)
                     / torch.linalg.vector_norm(mag))

    assert abs(sc(tw) - sc(jw)) <= GL_SC_MARGIN

    def rms(y):
        return float(np.sqrt(np.mean(np.square(y.astype(np.float64)))))

    assert abs(rms(tw) / rms(jw) - 1.0) <= GL_RMS_RTOL, (rms(tw), rms(jw))


@pytest.mark.parametrize("channels", [1, 2])
def test_decode_multi_matches_jax(wav, channels):
    p = tfittings.multi_waveform_fitting(wav, 0.3, channels)
    tw, jw = _decode_both(p, 2)
    np.testing.assert_allclose(tw, jw, rtol=0,
                               atol=DECODE_RTOL * float(np.abs(jw).max()))


RUNS = {"mdct_mask": dict(method="mdct", n=512, perceptual_mask=True),
        "mdct_adaptive": dict(method="mdct", n=512, adaptive=True),
        "fft_mae": dict(method="fft", n_fft=256, loss_mode="mae"),
        "multi": dict(method="multi", num_channels=2),
        "wave_stft": dict(method="wave", alpha=0.5,
                          multi_resolution_stft=True)}


@pytest.mark.parametrize("name", list(RUNS))
def test_train_each_method_matches_the_jax_runner(tmp_path, wav, name):
    """``train`` of each method on a small model: the artefacts, and
    ``parameters.json`` with the JAX runner's keys in its order and its
    knobs' values."""
    kw = dict(hidden=32, num_sine=1, num_snake=1, omega=300.0,
              total_steps=3, **RUNS[name])
    jrunner.train(str(tmp_path), "jax", duration=0.4, filename=wav,
                  make_plots=False, **kw)
    ckpt = trunner.train(str(tmp_path), "port", wav, 0.4, device="cpu", **kw)
    with open(tmp_path / "jax" / "parameters.json") as f:
        jrec = json.load(f)
    with open(tmp_path / "port" / "parameters.json") as f:
        trec = json.load(f)
    assert list(trec) == list(jrec)
    skip = ("tag", "SNR", "best_loss", "steps_per_sec",
            "total_trainig_time(min)", "best_iter")
    assert {k: v for k, v in trec.items() if k not in skip} == \
        {k: v for k, v in jrec.items() if k not in skip}
    assert ckpt == str(tmp_path / "port" / "saved_ckpt.npz")
    for f in ("output.wav", "metrics.jsonl", "saved_ckpt.npz"):
        assert (tmp_path / "port" / f).exists()
    assert np.isfinite(trec["SNR"]) and np.isfinite(trec["best_loss"])


def test_cli_mdct_perceptual_mask_runs_weighted_d(tmp_path, wav, capsys,
                                                  monkeypatch):
    """``fit --method mdct --perceptual-mask --fused --device cpu``: every
    step is kernel D's plain version with the mask as its weight."""
    weights = []
    plain = ss.step_plain
    monkeypatch.setattr(ss, "step_plain", lambda *a, **k: (
        weights.append(a[16] if len(a) > 16 else k.get("weight")),
        plain(*a, **k))[1])
    rc = port_main(["fit", "--device", "cpu", "--fused", "--method", "mdct",
                    "--perceptual-mask", "--n", "512", "--hidden", "32",
                    "--total-steps", "4", "--filename", wav, "--duration",
                    "0.4", "--experiment-path", str(tmp_path), "--tag",
                    "cli"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert os.path.exists(out["ckpt"])
    with open(tmp_path / "cli" / "parameters.json") as f:
        rec = json.load(f)
    assert (rec["method"], rec["perceptual_mask"], rec["N"]) == ("mdct",
                                                                 True, 512)
    assert len(weights) == 4 and all(w is not None for w in weights)
    mask = tfittings.mdct_fitting(wav, 0.4, n=512, perceptual_mask=True,
                                  device="cpu").loss_weight
    np.testing.assert_allclose(weights[0][0].numpy(),
                               mask[:, 0] * (len(mask) / mask.sum()),
                               rtol=1e-6)


def test_cli_spectral_flags_parse(tmp_path, wav):
    for flags in (["--method", "fft", "--loss-mode", "snr", "--alpha", "0.3",
                   "--n-fft", "256", "--highpass"],
                  ["--method", "mdct", "--takelog", "--adaptive", "--n",
                   "512"]):
        assert port_main(["fit", "--device", "cpu", "--hidden", "8",
                          "--total-steps", "1", "--filename", wav,
                          "--duration", "0.3", "--experiment-path",
                          str(tmp_path), "--tag", "f", *flags]) == 0
    with pytest.raises(SystemExit):
        port_main(["fit", "--filename", wav, "--method", "wavelet"])
