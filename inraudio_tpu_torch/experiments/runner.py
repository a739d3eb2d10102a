"""Experiment runner with the reference ``train(...)`` surface (port of
``inraudio_tpu/experiments/runner.py``): the wave, multi, mdct and fft
methods, every loss mode of ``train.losses.mix_loss``, and the mdct
target's per-row loss weight.

Build the fitting problem, build the model (with an optional input
encoding), optionally warm-start from a checkpoint, fit, decode (with
bandwidth extension), score the SNR, and write the artefacts: ``output.wav``,
the checkpoint, ``metrics.jsonl``, ``parameters.json`` with the JAX
package's schema, and with ``make_plots`` (the default, as in the JAX
runner; matplotlib) ``loss.png``, ``spec_ref.png``, ``spec.png`` and
``wave.png``.  ``visualization`` adds ``landscape.png``, the loss over a
random plane through the fitted parameters (``utils.landscape``), and
``profile`` a ``torch.profiler`` trace of one round of the fit in
``<experiment>/trace``.  ``train`` takes a wav file and returns the checkpoint
path; ``train_from_signal`` takes an in-memory signal (coords in
[-coord_scale, coord_scale]) and returns the reconstruction and residual.

Every fit runs on ``device`` (default the card; it raises without one),
or on the ranks of ``mesh`` (``parallel.make_mesh(device)`` when None, so
``torchrun --nproc-per-node N -m inraudio_tpu_torch fit ...`` shards the
rows over N ranks, with every loss mode: the snr loss and the STFT term
gather the whole clip's prediction on every rank; a device given beside a
mesh must be its own); only rank 0 decodes and writes the artefacts.
With ``num_freq``, the mlp owns its RFF encoding, as in the JAX runner: raw
coordinates go to the fit and the decode, and a fused mlp folds the
encoding into its kernels' layer 0.  Every other encoding (the NeRF
posenc, and RFF for the KAN) is computed once on the device and handed to
the model as its input features.  A fused mlp with the NeRF posenc or the
scaled-sine first layer (``scaled_first``) raises: the kernels have neither
layer 0 (the JAX runner silently unfuses both).
A spectral target's SNR is taken against the peak-normalised clip with
1024 samples trimmed at each end (the fft decode's phase is Griffin-Lim's,
so its SNR is phase-limited).
"""

from __future__ import annotations

import os
import time
from typing import Any

import numpy as np
import torch

from ..data.audio_io import decimate as decimate_signal
from ..data.audio_io import read_wav, write_wav
from ..data.fittings import (FittingProblem, fft_fitting, mdct_fitting,
                             multi_waveform_fitting, waveform_fitting,
                             waveform_fitting_from_array)
from ..eval.decode import decode_problem
from ..eval.metrics import (experiment_record, reconstruction_snr,
                            save_parameters)
from ..eval.plots import (plot_loss_history, plot_waveform_comparison,
                          plotspec)
from ..models import (INRModel, KANConfig, SirenSnakeTanhConfig, build_model,
                      posenc_nerf, posenc_output_dim, rff_apply, rff_init)
from ..parallel.mesh import Mesh, resolve_mesh
from ..train.checkpoint import load_checkpoint, save_checkpoint
from ..train.loop import TrainConfig, fit, init_train_state
from ..utils.observability import MetricsLogger

# generator seeds apart from the init's: the RFF projection's, and the
# landscape's random directions (the JAX runner's fold_in(key, 1) and (2))
_RFF_SEED_OFFSET = 1 << 31
_LANDSCAPE_SEED_OFFSET = 1 << 32


def make_experiment_folder(experiment_path: str, tag: str) -> str:
    """``<experiment_path>/<tag>``, with "(2)" appended while it exists."""
    folder = os.path.join(experiment_path, tag)
    while os.path.exists(folder):
        folder = folder + "(2)"
    os.makedirs(folder)
    return folder


def build_problem(method: str, filename: str, duration: float,
                  decimation: int = 1, n: int = 2048, takelog: bool = False,
                  num_channels: int = 1, perceptual_mask: bool = False,
                  n_fft: int = 1024, highpass: bool = False,
                  adaptive: bool = False,
                  device: torch.device | str = "cuda") -> FittingProblem:
    """Method dispatch: wave | mdct | fft | multi.  ``n_fft`` and
    ``highpass`` reach the fft builder; ``n``, ``takelog``, ``highpass``,
    ``perceptual_mask`` and ``adaptive`` the mdct builder; the transforms
    run on ``device`` (default the card; it raises without one)."""
    if method == "wave":
        return waveform_fitting(filename, duration, decimation)
    if method == "mdct":
        return mdct_fitting(filename, duration, n=n, takelog=takelog,
                            highpass=highpass,
                            perceptual_mask=perceptual_mask,
                            adaptive=adaptive, device=device)
    if method == "fft":
        return fft_fitting(filename, duration, n_fft=n_fft,
                           highpass=highpass, device=device)
    if method == "multi":
        return multi_waveform_fitting(filename, duration, num_channels)
    raise ValueError(f"unknown method {method!r}")


def build_arch(arch: str, in_features: int, hidden: int, num_sine: int,
               num_snake: int, num_tanh: int, omega: float,
               hidden_omega: float, a_initial: float | None,
               first_linear: bool = False, last_linear: bool = True,
               fused: bool = False, rff_b: torch.Tensor | None = None,
               scaled_first: bool = False) -> INRModel:
    """'mlp' -> SirenWithSnakeTanh (fused: the stack kernels and kernel D,
    widths 32/64/128/256, raw coordinates or the model's own RFF encoding
    ``rff_b``; ``scaled_first``: the scaled-sine first layer, unfused
    only); 'kan' -> KAN([in, hidden, hidden, 1]) (fused: kernels G and
    H)."""
    if arch == "mlp":
        return build_model("mlp", SirenSnakeTanhConfig(
            in_features=in_features, hidden_features=hidden,
            num_sine=num_sine, num_snake=num_snake, num_tanh=num_tanh,
            first_linear=first_linear, last_linear=last_linear,
            scaled_first=scaled_first,
            first_omega_0=omega, hidden_omega_0=hidden_omega,
            a_initial=a_initial), fused=fused, approx_sin=fused,
            rff_b=rff_b)
    if arch == "kan":
        return build_model("kan", KANConfig(
            layers_hidden=(in_features, hidden, hidden, 1)), fused=fused)
    raise ValueError(f"unknown arch {arch!r}")


def _encoding(problem: FittingProblem, num_freq: int | None, sigma: float,
              encoding: str, seed: int, dev: torch.device, arch: str):
    """(encode: raw coords tensor -> features, or None; in_features; the
    RFF projection an mlp owns, or None)."""
    if not num_freq:
        return None, problem.in_features, None
    if encoding == "nerf":
        return (lambda c: posenc_nerf(c, num_freq),
                posenc_output_dim(problem.in_features, num_freq), None)
    if encoding != "rff":
        raise ValueError(f"unknown encoding {encoding!r}")
    b = rff_init(torch.Generator().manual_seed(_RFF_SEED_OFFSET + seed),
                 problem.in_features, num_freq, sigma=sigma, device=dev)
    if arch == "mlp":
        # the model owns the encoding: raw coordinates reach the fit and
        # the decode, and the fused kernels compute the features in layer 0
        return None, 2 * num_freq, b
    return (lambda c: rff_apply(b, c)), 2 * num_freq, None


def _scalars(d: dict[str, Any]) -> dict[str, Any]:
    return {k: v for k, v in d.items()
            if isinstance(v, (int, float, str, bool, type(None)))}


def _run_experiment(
    problem: FittingProblem, experiment_folder: str,
    reference_signal: np.ndarray, reference_rate: int, *,
    arch: str, hidden: int, num_sine: int, num_snake: int, num_tanh: int,
    omega: float, hidden_omega: float, a_initial: float | None,
    num_freq: int | None, sigma: float, total_steps: int,
    learning_rate: float, min_learning_rate: float, bwe: bool,
    loss_mode: str = "mse", alpha: float = 0.0,
    multi_resolution_stft: bool = False,
    prev_ckpt_path: str | None, seed: int, track_best: bool,
    hparams: dict[str, Any], fused: bool = False, first_linear: bool = False,
    last_linear: bool = True, grad_clip_norm: float = 0.0,
    plateau_factor: float = 0.8, plateau_patience: int = 200,
    update_grid_every: int = 0, encoding: str = "rff",
    scaled_first: bool = False, make_plots: bool = True,
    visualization: bool = False, profile: bool = False,
    device: torch.device | str | None = None,
    mesh: Mesh | None = None) -> dict[str, Any]:
    """The engine behind ``train`` and ``train_from_signal``.  On ranks
    other than 0 (``experiment_folder`` None there) it fits and returns
    the result without decoding or writing anything."""
    mesh = resolve_mesh(mesh, device)
    dev = mesh.device
    if fused and arch == "mlp" and num_freq and encoding == "nerf":
        raise NotImplementedError(
            "a fused mlp has no NeRF posenc layer 0 in its kernels; fit it "
            "with encoding='rff' or fused=False")
    encode, in_features, rff_b = _encoding(problem, num_freq, sigma,
                                           encoding, seed, dev, arch)
    coords = torch.from_numpy(problem.coords).to(dev)
    enc_coords = encode(coords) if encode is not None else coords
    model = build_arch(arch, in_features, hidden, num_sine, num_snake,
                       num_tanh, omega, hidden_omega, a_initial,
                       first_linear=first_linear, last_linear=last_linear,
                       fused=fused, rff_b=rff_b, scaled_first=scaled_first)
    cfg = TrainConfig(total_steps=total_steps, learning_rate=learning_rate,
                      min_learning_rate=min_learning_rate,
                      loss_mode=loss_mode, alpha=alpha,
                      multi_resolution_stft=multi_resolution_stft,
                      track_best=track_best, grad_clip_norm=grad_clip_norm,
                      plateau_factor=plateau_factor,
                      plateau_patience=plateau_patience,
                      update_grid_every=update_grid_every)
    generator = torch.Generator().manual_seed(seed)

    state = None
    if prev_ckpt_path:
        template = init_train_state(model, generator, cfg, dev)
        state = load_checkpoint(prev_ckpt_path, template)

    metrics = None
    if mesh.rank == 0:
        metrics = MetricsLogger(os.path.join(experiment_folder,
                                             "metrics.jsonl"))
        metrics.log({"event": "config", "hparams": _scalars(hparams)})
    t0 = time.time()
    trace_dir = (os.path.join(experiment_folder, "trace")
                 if profile and mesh.rank == 0 else None)
    result = fit(model, enc_coords, problem.targets, cfg, generator=generator,
                 state=state, metrics=metrics, mesh=mesh,
                 weight=problem.loss_weight, profile_dir=trace_dir)
    train_time = time.time() - t0
    if mesh.rank != 0:
        return {"ckpt": None, "result": result, "model": model,
                "problem": problem}

    # an mse fit's own quality estimate gates a fused mlp's decode tier
    fit_snr_est = None
    if loss_mode == "mse" and np.isfinite(result.best_loss) \
            and result.best_loss > 0:
        sig_pow = float(np.mean(np.square(problem.targets)))
        if sig_pow > 0:
            fit_snr_est = 10.0 * float(np.log10(sig_pow / result.best_loss))
    recovered, out_rate = decode_problem(model, result.params, problem,
                                         bwe=bwe, encode=encode,
                                         fit_snr_db=fit_snr_est, device=dev)
    write_wav(os.path.join(experiment_folder, "output.wav"), out_rate,
              recovered)

    ref = reference_signal
    if bwe:
        ref_cmp, rate_cmp = ref, reference_rate
    else:
        q = reference_rate // problem.sample_rate
        ref_cmp = decimate_signal(ref, q) if q > 1 else ref
        rate_cmp = problem.sample_rate
    spectral = problem.method in ("mdct", "fft")
    if spectral:  # the spectral targets fit the peak-normalised clip
        ref_cmp = ref_cmp / float(np.max(np.abs(ref_cmp)))
    snr = reconstruction_snr(ref_cmp, recovered, trim=1024 if spectral else 0)

    ckpt_path = save_checkpoint(
        os.path.join(experiment_folder, "saved_ckpt"), result.state,
        extra={"arch": arch, "hparams": _scalars(hparams)})
    if visualization:
        from ..train.losses import mix_loss
        from ..utils.landscape import plot_landscape, random_plane
        targets_d = torch.from_numpy(
            np.asarray(problem.targets, np.float32)).to(dev)
        surface = random_plane(
            lambda p: mix_loss(model.apply(p, enc_coords), targets_d,
                               loss_mode=loss_mode),
            result.params, torch.Generator().manual_seed(
                _LANDSCAPE_SEED_OFFSET + seed))
        plot_landscape(surface, os.path.join(experiment_folder,
                                             "landscape.png"))
    if make_plots:
        plot_loss_history(result.loss_history, result.lr_history,
                          os.path.join(experiment_folder, "loss.png"),
                          title=f"time {train_time / 60:.2f} min")
        plotspec(ref_cmp, rate_cmp,
                 os.path.join(experiment_folder, "spec_ref.png"))
        plotspec(recovered, out_rate,
                 os.path.join(experiment_folder, "spec.png"))
        plot_waveform_comparison(ref_cmp, recovered, out_rate,
                                 os.path.join(experiment_folder, "wave.png"))
    record = experiment_record(hparams, result.params, train_time, snr)
    record["best_iter"] = result.best_iter
    record["best_loss"] = result.best_loss
    record["steps_per_sec"] = result.steps_per_sec
    save_parameters(experiment_folder, record)
    metrics.log({"event": "final", "snr_db": snr,
                 "best_loss": result.best_loss,
                 "best_iter": result.best_iter,
                 "train_time_s": round(train_time, 3),
                 "steps_per_sec": round(result.steps_per_sec, 2)})
    metrics.close()
    return {"ckpt": ckpt_path, "ref": ref_cmp, "rec": recovered,
            "res": ref_cmp[: len(recovered)] - recovered[: len(ref_cmp)],
            "snr": snr, "rate": out_rate, "result": result, "model": model,
            "problem": problem, "record": record}


def train(experiment_path: str, tag: str, filename: str | None = None,
          duration: float = 10.0, *, inst: str | None = None,
          method: str = "wave",
          arch: str = "mlp", loss_mode: str = "mse", alpha: float = 0.0,
          total_steps: int = 20000, learning_rate: float = 1e-3,
          min_learning_rate: float = 1e-6, num_sine: int = 2,
          num_snake: int = 2, num_tanh: int = 0, hidden: int = 256,
          omega: float = 22000.0, hidden_omega: float = 30.0,
          a_initial: float | None = 0.5, num_freq: int | None = None,
          sigma: float = 10.0, decimation: int = 1, bwe: bool = False,
          prev_ckpt_path: str | None = None, seed: int = 0,
          track_best: bool = True, fused: bool = False,
          first_linear: bool = False, last_linear: bool = True,
          grad_clip_norm: float = 0.0, plateau_factor: float = 0.8,
          plateau_patience: int = 200, update_grid_every: int = 0,
          encoding: str = "rff", takelog: bool = False, n: int = 2048,
          num_channels: int = 1, multi_resolution_stft: bool = False,
          n_fft: int = 1024, highpass: bool = False,
          perceptual_mask: bool = False, adaptive: bool = False,
          scaled_first: bool = False, make_plots: bool = True,
          visualization: bool = False, profile: bool = False,
          device: torch.device | str | None = None,
          mesh: Mesh | None = None) -> str | None:
    """File-based experiment -> the checkpoint path (None on ranks other
    than 0).  Defaults are the reference runner's.  ``inst`` names
    ``data/<inst>.wav`` when ``filename`` is None (the JAX runner's rule);
    either way it is recorded.  ``method`` picks the target
    (``build_problem``); the spectral methods read channel 1 of a stereo
    file, wave and multi channel 0."""
    if filename is None:
        if inst is None:
            raise ValueError("need inst or filename")
        filename = os.path.join("data", f"{inst}.wav")
    mesh = resolve_mesh(mesh, device)
    folder = (make_experiment_folder(experiment_path, tag) if mesh.rank == 0
              else None)
    problem = build_problem(method, filename, duration,
                            decimation=decimation, n=n, takelog=takelog,
                            num_channels=num_channels,
                            perceptual_mask=perceptual_mask, n_fft=n_fft,
                            highpass=highpass, adaptive=adaptive,
                            device=mesh.device)
    ref_rate, ref = read_wav(filename, channel=0 if method in ("wave",
                                                               "multi")
                             else 1)
    ref = ref[: int(duration * ref_rate)]
    hparams = dict(
        tag=tag, inst=inst, filename=filename, duration=duration,
        method=method, arch=arch, loss_mode=loss_mode,
        total_steps=total_steps, learning_rate=learning_rate,
        min_learning_rate=min_learning_rate, num_sine=num_sine,
        num_snake=num_snake, num_tanh=num_tanh, hidden=hidden, omega=omega,
        hidden_omega=hidden_omega, a_initial=a_initial, num_freq=num_freq,
        alpha=alpha, decimation=decimation, bwe=bwe, takelog=takelog, N=n,
        prev_ckpt_path=prev_ckpt_path, seed=seed, num_channels=num_channels,
        first_linear=first_linear, last_linear=last_linear,
        grad_clip_norm=grad_clip_norm, plateau_factor=plateau_factor,
        plateau_patience=plateau_patience,
        multi_resolution_stft=multi_resolution_stft, n_fft=n_fft,
        highpass=highpass, perceptual_mask=perceptual_mask,
        adaptive=adaptive, update_grid_every=update_grid_every,
        scaled_first=scaled_first, encoding=encoding)
    out = _run_experiment(
        problem, folder, ref, ref_rate, arch=arch, hidden=hidden,
        num_sine=num_sine, num_snake=num_snake, num_tanh=num_tanh,
        omega=omega, hidden_omega=hidden_omega, a_initial=a_initial,
        num_freq=num_freq, sigma=sigma, total_steps=total_steps,
        learning_rate=learning_rate, min_learning_rate=min_learning_rate,
        bwe=bwe, loss_mode=loss_mode, alpha=alpha,
        multi_resolution_stft=multi_resolution_stft,
        prev_ckpt_path=prev_ckpt_path, seed=seed,
        track_best=track_best, hparams=hparams, fused=fused,
        first_linear=first_linear, last_linear=last_linear,
        grad_clip_norm=grad_clip_norm, plateau_factor=plateau_factor,
        plateau_patience=plateau_patience,
        update_grid_every=update_grid_every, encoding=encoding,
        scaled_first=scaled_first, make_plots=make_plots,
        visualization=visualization, profile=profile, mesh=mesh)
    return out["ckpt"]


def train_from_signal(experiment_path: str, tag: str,
                      input_signal: np.ndarray, input_fs: int, *,
                      coord_scale: float = 100.0, arch: str = "mlp",
                      loss_mode: str = "mse", alpha: float = 0.0,
                      multi_resolution_stft: bool = False,
                      total_steps: int = 20000, learning_rate: float = 1e-3,
                      min_learning_rate: float = 1e-6, num_sine: int = 2,
                      num_snake: int = 2, num_tanh: int = 0,
                      hidden: int = 256, omega: float = 22000.0,
                      hidden_omega: float = 30.0,
                      a_initial: float | None = 0.5,
                      num_freq: int | None = None, sigma: float = 10.0,
                      decimation: int = 1, bwe: bool = False,
                      prev_ckpt_path: str | None = None, seed: int = 0,
                      track_best: bool = True, fused: bool = False,
                      first_linear: bool = False, last_linear: bool = True,
                      grad_clip_norm: float = 0.0,
                      plateau_factor: float = 0.8,
                      plateau_patience: int = 200,
                      update_grid_every: int = 0, encoding: str = "rff",
                      scaled_first: bool = False, make_plots: bool = True,
                      visualization: bool = False, profile: bool = False,
                      device: torch.device | str | None = None,
                      mesh: Mesh | None = None) -> dict[str, Any]:
    """In-memory experiment: coords span [-coord_scale, coord_scale], the
    decode is de-normalised by the stored peak, and the residual
    ``input - recovered`` is returned for band-split chaining (on rank 0;
    other ranks of ``mesh`` get the fit's result only)."""
    mesh = resolve_mesh(mesh, device)
    folder = (make_experiment_folder(experiment_path, tag) if mesh.rank == 0
              else None)
    problem = waveform_fitting_from_array(input_signal, input_fs,
                                          decimation=decimation,
                                          coord_scale=coord_scale)
    hparams = dict(
        tag=tag, duration=len(input_signal) / input_fs, method="wave",
        arch=arch, loss_mode=loss_mode, total_steps=total_steps,
        learning_rate=learning_rate, min_learning_rate=min_learning_rate,
        num_sine=num_sine, num_snake=num_snake, num_tanh=num_tanh,
        hidden=hidden, omega=omega, hidden_omega=hidden_omega,
        a_initial=a_initial, num_freq=num_freq, alpha=alpha,
        decimation=decimation, bwe=bwe, coord_scale=coord_scale,
        prev_ckpt_path=prev_ckpt_path, seed=seed,
        first_linear=first_linear, last_linear=last_linear,
        grad_clip_norm=grad_clip_norm, plateau_factor=plateau_factor,
        plateau_patience=plateau_patience,
        multi_resolution_stft=multi_resolution_stft,
        update_grid_every=update_grid_every, scaled_first=scaled_first,
        encoding=encoding)
    return _run_experiment(
        problem, folder, np.asarray(input_signal, dtype=np.float32),
        input_fs, arch=arch, hidden=hidden, num_sine=num_sine,
        num_snake=num_snake, num_tanh=num_tanh, omega=omega,
        hidden_omega=hidden_omega, a_initial=a_initial, num_freq=num_freq,
        sigma=sigma, total_steps=total_steps, learning_rate=learning_rate,
        min_learning_rate=min_learning_rate, bwe=bwe, loss_mode=loss_mode,
        alpha=alpha, multi_resolution_stft=multi_resolution_stft,
        prev_ckpt_path=prev_ckpt_path, seed=seed, track_best=track_best,
        hparams=hparams, fused=fused, first_linear=first_linear,
        last_linear=last_linear, grad_clip_norm=grad_clip_norm,
        plateau_factor=plateau_factor, plateau_patience=plateau_patience,
        update_grid_every=update_grid_every, encoding=encoding,
        scaled_first=scaled_first, make_plots=make_plots,
        visualization=visualization, profile=profile, mesh=mesh)
