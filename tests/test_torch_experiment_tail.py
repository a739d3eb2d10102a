"""The runner's tail held against the JAX package on the CPU: the loss
landscape (``_filter_normalize`` on the same directions, ``random_plane``'s
grid), the pipelines (the decimation curriculum and the band split, end to
end), the plots, the profiler (``profile_trace``, ``fit(profile_dir=)``),
and the ``fit`` CLI's ``--inst``, ``--no-plots``, ``--profile``,
``--scaled-first`` and ``--visualization`` beside the JAX CLI's.  Signals
are synthesised; the port runs on the CPU (its plain versions), the JAX
package unfused.

Tolerance: ``_filter_normalize`` is a norm and a scale per row, the same
float32 expressions in both packages (reductions in another order):
NORM_RTOL.  Losses on the landscape are compared with the port's own
``loss_fn`` at the same parameters, bit for bit."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inraudio_tpu.__main__ import main as jax_main
from inraudio_tpu.experiments import pipelines as jpipelines
from inraudio_tpu.utils import landscape as jlandscape
from inraudio_tpu_torch.__main__ import main as port_main
from inraudio_tpu_torch.data import write_wav
from inraudio_tpu_torch.eval import plots
from inraudio_tpu_torch.experiments import (band_split_train,
                                            procedural_train)
from inraudio_tpu_torch.experiments import runner as trunner
from inraudio_tpu_torch.models import (SirenSnakeTanhConfig, build_model,
                                       params_from_jax)
from inraudio_tpu_torch.train import loop as tloop
from inraudio_tpu_torch.train.losses import mix_loss
from inraudio_tpu_torch.tree import tree_leaves, tree_map
from inraudio_tpu_torch.utils import profile_trace
from inraudio_tpu_torch.utils import landscape as tlandscape

torch.set_num_threads(1)

NORM_RTOL = 2e-6
FS = 8000
PLOTS = ("loss.png", "spec_ref.png", "spec.png", "wave.png")


def _signal(n=1600):
    t = np.arange(n) / FS
    return (0.5 * np.sin(2 * np.pi * 220 * t)
            + 0.2 * np.sin(2 * np.pi * 2500 * t)).astype(np.float32)


def _small_mlp():
    return build_model("mlp", SirenSnakeTanhConfig(
        hidden_features=16, first_omega_0=60.0, num_sine=1, num_snake=1))


# ---------------------------------------------------------------------------
# The loss landscape
# ---------------------------------------------------------------------------

def test_filter_normalize_matches_jax():
    rng = np.random.default_rng(0)
    params = {"layers": [{"w": rng.standard_normal((3, 8)).astype(np.float32),
                          "b": rng.standard_normal(8).astype(np.float32)},
                         {"w": rng.standard_normal((8, 1)).astype(np.float32),
                          "b": rng.standard_normal(1).astype(np.float32)}]}
    direction = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    ref = jlandscape._filter_normalize(jax.tree.map(jnp.asarray, direction),
                                       jax.tree.map(jnp.asarray, params))
    out = tlandscape._filter_normalize(params_from_jax(direction),
                                       params_from_jax(params))
    for a, b in zip(jax.tree.leaves(ref), tree_leaves(out)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=NORM_RTOL,
                                   atol=0)
    # each row of a matrix leaf takes its parameter row's norm
    w = out["layers"][0]["w"]
    np.testing.assert_allclose(torch.linalg.vector_norm(w, dim=-1).numpy(),
                               np.linalg.norm(params["layers"][0]["w"],
                                              axis=-1), rtol=NORM_RTOL)


@pytest.mark.parametrize("batch", [1, 4, 7])
def test_random_plane_grid(batch):
    """(steps, steps) losses; the centre of an odd grid is the loss at the
    parameters bit for bit; the batching changes no value; the directions
    come from the generator alone."""
    model = _small_mlp()
    params = model.init(torch.Generator().manual_seed(0))
    x = torch.linspace(-1, 1, 200)[:, None]
    y = torch.sin(3 * x)
    calls = []

    def loss_fn(p):
        calls.append(1)
        return mix_loss(model.apply(p, x), y, loss_mode="mse")

    steps = 5
    surf = tlandscape.random_plane(loss_fn, params,
                                   torch.Generator().manual_seed(2),
                                   distance=1.0, steps=steps,
                                   points_per_batch=batch)
    assert surf.shape == (steps, steps) and surf.dtype == np.float32
    assert len(calls) == steps * steps and np.isfinite(surf).all()
    assert surf[2, 2] == float(loss_fn(params))
    ref = tlandscape.random_plane(loss_fn, params,
                                  torch.Generator().manual_seed(2),
                                  distance=1.0, steps=steps,
                                  points_per_batch=4)
    np.testing.assert_array_equal(surf, ref)
    assert surf.std() > 0


# ---------------------------------------------------------------------------
# The pipelines
# ---------------------------------------------------------------------------

def test_procedural_train_chains_checkpoints(tmp_path):
    """d4 -> d2 -> d1, each phase from the previous one's checkpoint, the
    folders and records the JAX pipeline writes."""
    wav = str(tmp_path / "in.wav")
    write_wav(wav, FS, _signal())
    kw = dict(filename=wav, duration=0.2, hidden=16, omega=60.0,
              total_steps=4, make_plots=False)
    ck = procedural_train(str(tmp_path / "port"), "p", decimations=(4, 2, 1),
                          device="cpu", **kw)
    jck = jpipelines.procedural_train(str(tmp_path / "jax"), "p",
                                      decimations=(4, 2, 1), **kw)
    assert ck == str(tmp_path / "port" / "p_d1" / "saved_ckpt.npz")
    assert os.path.basename(os.path.dirname(jck)) == "p_d1"
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax")) == ["p_d1", "p_d2", "p_d4"]
    prev = None
    for d in (4, 2, 1):
        with open(tmp_path / "port" / f"p_d{d}" / "parameters.json") as f:
            rec = json.load(f)
        with open(tmp_path / "jax" / f"p_d{d}" / "parameters.json") as f:
            jrec = json.load(f)
        assert list(rec) == list(jrec)
        assert rec["decimation"] == jrec["decimation"] == d
        assert rec["prev_ckpt_path"] == prev
        prev = str(tmp_path / "port" / f"p_d{d}" / "saved_ckpt.npz")


def test_band_split_train_sums_two_bands(tmp_path):
    """The low and high band each fitted, the reconstructions summed; the
    split is the JAX pipeline's (order-5 Butterworth at the cutoff, zero
    phase), computed in float64."""
    sig = _signal()
    out = band_split_train(str(tmp_path), "b", sig, FS, cutoff=1000.0,
                           hidden=16, omega=60.0, total_steps=5,
                           make_plots=False, device="cpu",
                           hp_kwargs=dict(omega=200.0))
    assert sorted(os.listdir(tmp_path)) == ["b_hp", "b_lp"]
    n = min(len(out["lp"]["rec"]), len(out["hp"]["rec"]))
    np.testing.assert_array_equal(out["rec"],
                                  out["lp"]["rec"][:n] + out["hp"]["rec"][:n])
    assert np.isfinite(out["snr"])
    with open(tmp_path / "b_hp" / "parameters.json") as f:
        assert json.load(f)["omega"] == 200.0
    # the bands the models fitted: the JAX filters on float64 input
    from inraudio_tpu.dsp import filters as jfilters
    low = np.asarray(jfilters.lpfilter(np.asarray(sig, np.float64), 1000.0,
                                       FS))
    np.testing.assert_allclose(out["lp"]["ref"], low.astype(np.float32),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# Plots, the profiler
# ---------------------------------------------------------------------------

def test_plots_write_their_files(tmp_path):
    sig = _signal()
    plots.plotspec(sig, FS, str(tmp_path / "spec.png"), n_fft=256,
                   noverlap=64)
    plots.plot_waveform_comparison(sig, 0.9 * sig, FS,
                                   str(tmp_path / "wave.png"),
                                   window=(0.0, 0.1))
    plots.plot_loss_history(np.geomspace(1, 1e-4, 50),
                            np.full(50, 1e-3), str(tmp_path / "loss.png"),
                            title="t")
    plots.visualizer(np.random.default_rng(0).standard_normal((16, 9)),
                     str(tmp_path / "mdct.png"))
    tlandscape.plot_landscape(np.random.default_rng(1).random((5, 5)),
                              str(tmp_path / "landscape.png"))
    for name in ("spec.png", "wave.png", "loss.png", "mdct.png",
                 "landscape.png"):
        with open(tmp_path / name, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n", name


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path / "tr")):
        torch.matmul(torch.ones(64, 64), torch.ones(64, 64))
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "tr" / files[0]) as f:
        trace = json.load(f)
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    with profile_trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not (tmp_path / "off").exists()
    with pytest.raises(ZeroDivisionError):
        with profile_trace(str(tmp_path / "err")):
            1 / 0


@pytest.mark.parametrize("total,chunk,want", [(6, 2, 1), (4, 4, 0),
                                              (9, 4, 1)])
def test_fit_profiles_the_round_jax_profiles(tmp_path, monkeypatch, total,
                                             chunk, want):
    """Round min(1, rounds - 1) (the JAX fit's, loop.py:432-438) is traced,
    and only it."""
    seen = []
    real = tloop.profile_trace

    def recording(log_dir, enabled=True):
        seen.append(enabled)
        return real(log_dir, enabled)

    monkeypatch.setattr(tloop, "profile_trace", recording)
    x = np.linspace(-1, 1, 100, dtype=np.float32)[:, None]
    tloop.fit(_small_mlp(), x, np.sin(3 * x), tloop.TrainConfig(
        total_steps=total, scan_chunk=chunk), device="cpu",
        profile_dir=str(tmp_path / "trace"))
    rounds = -(-total // chunk)
    assert seen == [r == want for r in range(rounds)]
    assert len(os.listdir(tmp_path / "trace")) == 1


def test_fused_step_switch_takes_the_autograd_step(monkeypatch):
    """INRAUDIO_FUSED_STEP=0 sends a fused mlp's mse fit to the autograd
    step over B and C, as the JAX switch does."""
    model = build_model("mlp", SirenSnakeTanhConfig(
        hidden_features=32, first_omega_0=60.0, num_sine=1, num_snake=1),
        fused=True, approx_sin=True)
    tc = tloop.TrainConfig(total_steps=2)
    assert tloop.fused_step_plan(model, tc, 100) == 256
    monkeypatch.setenv("INRAUDIO_FUSED_STEP", "0")
    assert tloop.fused_step_plan(model, tc, 100) is None
    called = []
    real = tloop.make_train_step
    monkeypatch.setattr(tloop, "make_train_step",
                        lambda m, c: called.append(1) or real(m, c))
    x = np.linspace(-1, 1, 100, dtype=np.float32)[:, None]
    res = tloop.fit(model, x, np.sin(3 * x), tc, device="cpu")
    assert called == [1] and np.isfinite(res.loss_history).all()


# ---------------------------------------------------------------------------
# The fit CLI's new flags, beside the JAX CLI
# ---------------------------------------------------------------------------

def _cli(main, tmp_path, tag, wav, extra, device=()):
    rc = main(["fit", *device, "--filename", wav, "--duration", "0.2",
               "--hidden", "16", "--omega", "60", "--total-steps", "4",
               "--experiment-path", str(tmp_path), "--tag", tag, *extra])
    assert rc in (0, None)
    with open(tmp_path / tag / "parameters.json") as f:
        return json.load(f), set(os.listdir(tmp_path / tag))


@pytest.mark.parametrize("extra", [
    ["--inst", "cello", "--no-plots"],
    ["--scaled-first", "--no-plots"],
    [],
    ["--no-plots", "--profile"],
    ["--no-plots", "--visualization"]],
    ids=["inst", "scaled_first", "plots", "profile", "visualization"])
def test_cli_flags_match_jax(tmp_path, capsys, extra):
    """The same flags through both CLIs: the records agree on every knob
    (inst and scaled_first as given), and the folders hold the same
    artefacts (the plots, trace/, landscape.png)."""
    wav = str(tmp_path / "in.wav")
    write_wav(wav, FS, _signal())
    trec, tfiles = _cli(port_main, tmp_path, "port", wav, extra,
                        ("--device", "cpu"))
    jrec, jfiles = _cli(jax_main, tmp_path, "jax", wav, extra)
    skip = ("tag", "SNR", "best_loss", "steps_per_sec",
            "total_trainig_time(min)")
    assert list(trec) == list(jrec)
    assert {k: v for k, v in trec.items() if k not in skip} == \
        {k: v for k, v in jrec.items() if k not in skip}
    assert tfiles == jfiles
    if "--inst" in extra:
        assert trec["inst"] == "cello"
    if "--scaled-first" in extra:
        assert trec["scaled_first"] is True
    assert (set(PLOTS) <= tfiles) == ("--no-plots" not in extra)
    assert ("trace" in tfiles) == ("--profile" in extra)
    assert ("landscape.png" in tfiles) == ("--visualization" in extra)
    if "--profile" in extra:
        assert os.listdir(tmp_path / "port" / "trace")


def test_train_resolves_inst(tmp_path, monkeypatch):
    """``inst`` without a filename names data/<inst>.wav (the JAX runner's
    rule); neither raises."""
    monkeypatch.chdir(tmp_path)
    os.makedirs("data")
    write_wav(os.path.join("data", "flute.wav"), FS, _signal())
    ck = trunner.train(str(tmp_path / "res"), "i", inst="flute",
                       duration=0.2, hidden=16, omega=60.0, total_steps=2,
                       make_plots=False, device="cpu")
    with open(tmp_path / "res" / "i" / "parameters.json") as f:
        rec = json.load(f)
    assert rec["inst"] == "flute"
    assert rec["filename"] == os.path.join("data", "flute.wav")
    assert os.path.exists(ck)
    with pytest.raises(ValueError, match="need inst or filename"):
        trunner.train(str(tmp_path / "res"), "j", device="cpu")


def test_fused_scaled_first_fit_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="scaled-sine"):
        trunner.train_from_signal(str(tmp_path), "x", _signal(), FS,
                                  hidden=32, fused=True, scaled_first=True,
                                  total_steps=1, device="cpu")
    assert not any(os.scandir(tmp_path / "x"))
    # the JAX runner unfuses it instead; the port fits it unfused
    out = trunner.train_from_signal(str(tmp_path), "y", _signal(), FS,
                                    hidden=16, scaled_first=True,
                                    total_steps=2, make_plots=False,
                                    device="cpu")
    assert np.isfinite(out["rec"]).all()
    assert tree_map(lambda t: t, out["result"].params)["layers"][0][
        "omega_scale"].shape == (16,)
