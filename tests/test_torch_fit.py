"""The port's single-model fit slice held against the JAX package on the
CPU: ``train.loop.fit`` (KAN with a grid refresh between rounds, the
unfused mlp, the fused mlp through kernel D as a one-window population),
its checkpoints, metrics and best-params bookkeeping, checkpoints crossing
the packages both ways, the runner's ``parameters.json`` schema and the
``fit`` CLI.  Both packages start from one state, drawn by the JAX package
and carried across as numpy arrays; the JAX fits run on a one-device mesh
(the test session's eight virtual devices would shard the rows).  Also the
device rule of the entry points: without a card the default raises."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from inraudio_tpu.data import audio_io as jaudio
from inraudio_tpu.data import fittings as jfittings
from inraudio_tpu.eval import decode as jdecode
from inraudio_tpu.experiments import runner as jrunner
from inraudio_tpu.models import encodings as jenc
from inraudio_tpu.models import KANConfig as JaxKANConfig
from inraudio_tpu.models import SirenSnakeTanhConfig as JaxSirenConfig
from inraudio_tpu.models import build_model as jax_build_model
from inraudio_tpu.parallel.mesh import make_mesh
from inraudio_tpu.train import checkpoint as jckpt
from inraudio_tpu.train import loop as jloop
from inraudio_tpu_torch.__main__ import main as port_main
from inraudio_tpu_torch.data import audio_io as taudio
from inraudio_tpu_torch.data import fittings as tfittings
from inraudio_tpu_torch.data import write_wav
from inraudio_tpu_torch.eval import decode as tdecode
from inraudio_tpu_torch.experiments import runner as trunner
from inraudio_tpu_torch.models import (KANConfig, SirenSnakeTanhConfig,
                                       build_model, params_from_jax)
from inraudio_tpu_torch.models import encodings as tenc
from inraudio_tpu_torch.train import checkpoint as tckpt
from inraudio_tpu_torch.train import loop as tloop
from inraudio_tpu_torch.train import multi_inr as tmulti
from inraudio_tpu_torch.tree import tree_leaves
from inraudio_tpu_torch.utils import MetricsLogger, read_metrics

torch.set_num_threads(1)

N = 400  # rows of the fits
KAN = dict(layers_hidden=(1, 16, 16, 1))
MLP = dict(hidden_features=32, first_omega_0=300.0, num_sine=1, num_snake=1)
# loss histories: the two packages' f32 products sum in different orders
LOSS_RTOL = 1e-5
# final parameters after 20 steps at lr 1e-3: each element moves by up to
# 20 lr; summation-order noise of ~1e-7 relative per step stays far below
P_ATOL, P_RTOL = 2e-5, 1e-4


def _problem(n=N):
    x = np.linspace(-1, 1, n, dtype=np.float32).reshape(-1, 1)
    return x, (0.6 * np.sin(2 * np.pi * 2 * x)).astype(np.float32)


def _one_device():
    return make_mesh(jax.devices()[:1])


def _fit_both(jm, tm, jc, tc, seed=3):
    """One JAX init state, fitted by both packages -> (JAX, port) results."""
    js = jloop.init_train_state(jm, jax.random.PRNGKey(seed), jc)
    ts = tloop.train_state_from_jax(jax.tree.map(np.asarray, js))
    x, y = _problem()
    jres = jloop.fit(jm, x, y, jc, state=js, mesh=_one_device())
    tres = tloop.fit(tm, x, y, tc, state=ts, device="cpu")
    return jres, tres


def _assert_fits_close(jres, tres):
    np.testing.assert_allclose(tres.loss_history, jres.loss_history,
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(tres.lr_history, jres.lr_history, rtol=1e-6)
    assert tres.best_iter == jres.best_iter
    for group in ("params", "best_params"):
        for a, b in zip(jax.tree.leaves(getattr(jres.state, group)),
                        tree_leaves(getattr(tres.state, group))):
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       atol=P_ATOL, rtol=P_RTOL)


@pytest.mark.parametrize("fused", [False, True], ids=["kan", "kan_fused"])
def test_kan_fit_matches_jax(fused):
    """20 steps in rounds of 5 with a grid refresh every 10: the refresh
    runs between rounds (at step 10), from the same state; the fused KAN
    is G and H's plain versions against the JAX kernels in interpret
    mode."""
    jm = jax_build_model("kan", JaxKANConfig(**KAN), fused=fused,
                         interpret=True)
    tm = build_model("kan", KANConfig(**KAN), fused=fused)
    kw = dict(total_steps=20, scan_chunk=5, update_grid_every=10)
    jres, tres = _fit_both(jm, tm, jloop.TrainConfig(**kw),
                           tloop.TrainConfig(**kw))
    _assert_fits_close(jres, tres)
    # the refresh moved the knots of every layer
    init = build_model("kan", KANConfig(**KAN)).init(
        torch.Generator().manual_seed(0))
    for p, q in zip(tres.state.params["layers"], init["layers"]):
        assert not torch.equal(p["grid"], q["grid"])


def test_mlp_fit_matches_jax():
    jm = jax_build_model("mlp", JaxSirenConfig(**MLP))
    tm = build_model("mlp", SirenSnakeTanhConfig(**MLP))
    kw = dict(total_steps=20, scan_chunk=5, grad_clip_norm=1.0)
    _assert_fits_close(*_fit_both(jm, tm, jloop.TrainConfig(**kw),
                                  tloop.TrainConfig(**kw)))


@pytest.fixture
def inherit_grad_tier(monkeypatch):
    """The backward products in the forward's f32 tier (the JAX kernels
    read the env var while tracing, so drop their caches)."""
    monkeypatch.setenv("INRAUDIO_GRAD_PRECISION", "inherit")
    jax.clear_caches()
    yield
    jax.clear_caches()


def test_fused_mlp_fit_runs_kernel_d_as_one_window(inherit_grad_tier):
    """The fused mlp's fit goes through the whole-step kernel's arithmetic
    (D's plain version here) as a population of one window, against the
    JAX fit's single-device fused branch (kernel D in interpret mode)."""
    jm = jax_build_model("mlp", JaxSirenConfig(**MLP), fused=True,
                         interpret=True, approx_sin=True)
    tm = build_model("mlp", SirenSnakeTanhConfig(**MLP), fused=True,
                     approx_sin=True)
    calls = []
    step = tm.fused_step_ctx["step"]

    def counting_step(params, *args, **kw):
        calls.append(params.shape[0])
        return step(params, *args, **kw)

    tm = dataclasses.replace(tm, fused_step_ctx={**tm.fused_step_ctx,
                                                 "step": counting_step})
    kw = dict(total_steps=10, scan_chunk=5, grad_clip_norm=1.0)
    jres, tres = _fit_both(jm, tm, jloop.TrainConfig(**kw),
                           tloop.TrainConfig(**kw))
    assert calls == [1] * 10
    _assert_fits_close(jres, tres)


def test_fit_checkpoints_metrics_and_best(tmp_path):
    model = build_model("kan", KANConfig(**KAN))
    x, y = _problem()
    cfg = tloop.TrainConfig(total_steps=20, scan_chunk=5,
                            learning_rate=2e-2)
    ckpt = str(tmp_path / "ck")
    with MetricsLogger(str(tmp_path / "m.jsonl")) as log:
        res = tloop.fit(model, x, y, cfg, state=None, checkpoint_every=10,
                        checkpoint_path=ckpt, metrics=log, device="cpu")
    rounds = [r for r in read_metrics(str(tmp_path / "m.jsonl"))
              if r["event"] == "round"]
    assert [r["step"] for r in rounds] == [5, 10, 15, 20]
    np.testing.assert_allclose([r["loss"] for r in rounds],
                               res.loss_history[4::5], rtol=1e-7)
    # saved once, at step 10 (never at the last step)
    assert tckpt.checkpoint_extra(ckpt + ".npz") == {"steps_done": 10}
    # track_best: the decode params are the snapshot of the best step
    assert res.best_iter == int(np.argmin(res.loss_history))
    assert res.best_loss == pytest.approx(float(np.min(res.loss_history)))
    for a, b in zip(tree_leaves(res.params),
                    tree_leaves(res.state.best_params)):
        assert a is b
    # resuming the step-10 checkpoint for 10 steps lands on the 20-step
    # fit exactly
    template = tloop.init_train_state(model, torch.Generator(), cfg)
    mid = tckpt.load_checkpoint(ckpt + ".npz", template)
    assert int(mid.opt.step) == 10
    again = tloop.fit(model, x, y, dataclasses.replace(cfg, total_steps=10),
                      state=mid, device="cpu")
    for a, b in zip(tree_leaves(res.state), tree_leaves(again.state)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(again.loss_history, res.loss_history[10:])
    # track_best=False keeps the initial params as the "best" and decodes
    # the final ones
    init = tloop.init_train_state(model, torch.Generator().manual_seed(4),
                                  cfg)
    plain = tloop.fit(model, x, y, dataclasses.replace(cfg,
                                                       track_best=False),
                      state=init, device="cpu")
    for a, b in zip(tree_leaves(plain.state.best_params),
                    tree_leaves(init.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(plain.params),
                    tree_leaves(plain.state.params)):
        assert a is b


def test_checkpoints_cross_both_ways(tmp_path):
    jm = jax_build_model("kan", JaxKANConfig(**KAN))
    tm = build_model("kan", KANConfig(**KAN))
    cfg_kw = dict(total_steps=3, scan_chunk=3)
    x, y = _problem()
    js = jloop.fit(jm, x, y, jloop.TrainConfig(**cfg_kw),
                   key=jax.random.PRNGKey(5), mesh=_one_device()).state
    jpath = jckpt.save_checkpoint(str(tmp_path / "jax"), js,
                                  extra={"arch": "kan"})
    template = tloop.init_train_state(tm, torch.Generator().manual_seed(1),
                                      tloop.TrainConfig(**cfg_kw))
    loaded = tckpt.load_checkpoint(jpath, template)
    jl, tl = jax.tree.leaves(js), tree_leaves(loaded)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert tckpt.checkpoint_extra(jpath) == {"arch": "kan"}

    ts = tloop.fit(tm, x, y, tloop.TrainConfig(**cfg_kw), device="cpu").state
    tpath = tckpt.save_checkpoint(str(tmp_path / "port"), ts,
                                  extra={"steps_done": 3})
    jtemplate = jloop.init_train_state(jm, jax.random.PRNGKey(0),
                                       jloop.TrainConfig(**cfg_kw))
    back = jckpt.load_checkpoint(tpath, jtemplate)
    for a, b in zip(jax.tree.leaves(back), tree_leaves(ts)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert jckpt.checkpoint_extra(tpath) == {"steps_done": 3}
    with pytest.raises(ValueError, match="architecture mismatch"):
        tckpt.load_checkpoint(tpath, tloop.init_train_state(
            build_model("kan", KANConfig(layers_hidden=(1, 8, 1))),
            torch.Generator(), tloop.TrainConfig()))


def _signal(fs=4000, seconds=0.2):
    t = np.arange(int(fs * seconds)) / fs
    rng = np.random.default_rng(9)
    return (0.5 * np.sin(2 * np.pi * 30 * t)
            + 0.01 * rng.standard_normal(t.shape)).astype(np.float32), fs


def _assert_problems_equal(jp, tp):
    for key in ("coords", "targets"):
        np.testing.assert_array_equal(getattr(tp, key), getattr(jp, key))
    for key in ("sample_rate", "original_sample_rate", "height", "width",
                "method", "decode"):
        assert getattr(tp, key) == getattr(jp, key), key


@pytest.mark.parametrize("decimation", [1, 4])
def test_wave_fittings_match_jax(tmp_path, decimation):
    """numpy and scipy on both sides: bit-equal problems, decimate too."""
    sig, fs = _signal()
    wav = str(tmp_path / "in.wav")
    write_wav(wav, fs, sig)
    np.testing.assert_array_equal(taudio.decimate(sig, decimation),
                                  jaudio.decimate(sig, decimation))
    _assert_problems_equal(
        jfittings.waveform_fitting(wav, 0.15, decimation),
        tfittings.waveform_fitting(wav, 0.15, decimation))
    _assert_problems_equal(
        jfittings.waveform_fitting_from_array(sig, fs, decimation, 50.0),
        tfittings.waveform_fitting_from_array(sig, fs, decimation, 50.0))
    silent = tfittings.waveform_fitting_from_array(np.zeros(64), fs)
    assert silent.decode["peak"] == 1e-9 and not silent.targets.any()


def test_encodings_match_jax():
    x = np.linspace(-1, 1, 300, dtype=np.float32).reshape(-1, 2)
    b = np.random.default_rng(4).normal(0, 10, (16, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tenc.rff_apply(torch.from_numpy(b), torch.from_numpy(x)).numpy(),
        np.asarray(jenc.rff_apply(jax.numpy.asarray(b), x)), atol=2e-5)
    np.testing.assert_allclose(
        tenc.posenc_nerf(torch.from_numpy(x), 6).numpy(),
        np.asarray(jenc.posenc_nerf(x, 6)), atol=2e-5)
    assert tenc.posenc_output_dim(2, 6) == jenc.posenc_output_dim(2, 6)
    assert tenc.rff_output_dim(16) == jenc.rff_output_dim(16)
    for n in (2, 100, 308_207):
        assert tenc.num_frequencies_nyquist(n) == \
            jenc.num_frequencies_nyquist(n)
    # the projection: a different generator, the same N(0, sigma^2)
    draw = tenc.rff_init(torch.Generator().manual_seed(0), 1, 4096,
                         sigma=1500.0)
    assert draw.shape == (4096, 1)
    assert abs(float(draw.std()) / 1500.0 - 1.0) < 0.05
    assert abs(float(draw.mean())) < 0.1 * 1500.0


@pytest.mark.parametrize("bwe", [False, True])
def test_decode_problem_matches_jax(bwe):
    """A decimated fit's decode (and its bandwidth extension on the
    original-rate grid) from the same params, through an RFF encoding."""
    sig, fs = _signal()
    jprob = jfittings.waveform_fitting_from_array(sig, fs, 2, 1.0)
    tprob = tfittings.waveform_fitting_from_array(sig, fs, 2, 1.0)
    np.testing.assert_array_equal(
        tdecode.bwe_coords(tprob, 1.0), jdecode.bwe_coords(jprob, 1.0))
    cfg = dict(MLP, in_features=8)
    jm = jax_build_model("mlp", JaxSirenConfig(**cfg))
    tm = build_model("mlp", SirenSnakeTanhConfig(**cfg))
    jp = jm.init(jax.random.PRNGKey(2))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    b = np.random.default_rng(5).normal(0, 3, (4, 1)).astype(np.float32)
    jw, jrate = jdecode.decode_problem(
        jm, jp, jprob, bwe=bwe,
        encode=lambda c: jenc.rff_apply(jax.numpy.asarray(b), c))
    tw, trate = tdecode.decode_problem(
        tm, tp, tprob, bwe=bwe,
        encode=lambda c: tenc.rff_apply(torch.from_numpy(b), c),
        device="cpu")
    assert trate == jrate == (fs if bwe else fs // 2)
    assert tw.dtype == np.float32 and tw.shape == jw.shape
    np.testing.assert_allclose(tw, jw, atol=2e-5)


@pytest.mark.parametrize("arch", ["kan", "mlp"])
def test_train_from_signal_record_matches_jax(tmp_path, arch):
    sig, fs = _signal()
    kw = dict(arch=arch, hidden=8, total_steps=5, omega=60.0)
    jout = jrunner.train_from_signal(str(tmp_path), "jax", sig, fs,
                                     make_plots=False, **kw)
    tout = trunner.train_from_signal(str(tmp_path), "port", sig, fs,
                                     device="cpu", **kw)
    with open(tmp_path / "jax" / "parameters.json") as f:
        jrec = json.load(f)
    with open(tmp_path / "port" / "parameters.json") as f:
        trec = json.load(f)
    assert list(trec) == list(jrec)
    skip = ("tag", "SNR", "best_loss", "steps_per_sec",
            "total_trainig_time(min)")
    assert {k: v for k, v in trec.items() if k not in skip} == \
        {k: v for k, v in jrec.items() if k not in skip}
    for name in ("output.wav", "metrics.jsonl", "saved_ckpt.npz"):
        assert (tmp_path / "port" / name).exists()
    assert tout["rec"].shape == jout["rec"].shape == sig.shape
    assert np.isfinite(tout["snr"])
    events = [r["event"] for r in read_metrics(
        str(tmp_path / "port" / "metrics.jsonl"))]
    assert events == ["config", "round", "final"]


def test_runner_refuses_what_it_does_not_port(tmp_path):
    sig, fs = _signal()
    with pytest.raises(NotImplementedError, match="NeRF posenc"):
        trunner.train_from_signal(str(tmp_path), "x", sig, fs, arch="mlp",
                                  hidden=32, num_freq=4, fused=True,
                                  encoding="nerf", total_steps=1,
                                  device="cpu")
    # h = 48 runs padded to the kernel width 64; wider than 256 raises
    with pytest.raises(ValueError, match="hidden widths"):
        trunner.train_from_signal(str(tmp_path), "y", sig, fs, arch="mlp",
                                  hidden=320, fused=True, total_steps=1,
                                  device="cpu")
    # every method of the JAX runner is ported; an unknown one raises
    with pytest.raises(ValueError, match="unknown method"):
        trunner.build_problem("wavelet", "x.wav", 1.0)


def test_cli_fit_kan(tmp_path, capsys):
    sig, fs = _signal()
    wav = str(tmp_path / "in.wav")
    write_wav(wav, fs, sig)
    rc = port_main(["fit", "--device", "cpu", "--arch", "kan", "--fused",
                    "--hidden", "8", "--total-steps", "6", "--num-freq", "4",
                    "--sigma", "3", "--filename", wav, "--duration", "0.2",
                    "--experiment-path", str(tmp_path), "--tag", "cli"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ckpt"] == os.path.join(str(tmp_path), "cli", "saved_ckpt.npz")
    assert os.path.exists(out["ckpt"])
    with open(tmp_path / "cli" / "parameters.json") as f:
        rec = json.load(f)
    assert rec["arch"] == "kan" and rec["num_freq"] == 4
    # KAN(8, 8, 8, 1) on the RFF features, checkpointed whole
    extra = tckpt.checkpoint_extra(out["ckpt"])
    assert extra["arch"] == "kan"
    with np.load(out["ckpt"]) as f:
        assert f["leaf_00000"].shape == (8, 8)     # layer 0 base_w


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _trained(*_a, **_k):
    raise AssertionError("trained on the CPU")


ENTRY_POINTS = ["multi_inr_fit", "multi_inr_fit_many", "fit",
                "train_from_signal", "decode_dense"]


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_points_default_to_the_card(monkeypatch, tmp_path, entry):
    """Without a card the default device raises RuntimeError before any
    work; nothing trains on the CPU in its place."""
    _no_card(monkeypatch)
    monkeypatch.setattr(tmulti, "_fit_chunks", _trained)
    monkeypatch.setattr(tloop, "make_train_step", _trained)
    monkeypatch.setattr(trunner, "fit", _trained)
    mlp = build_model("mlp", SirenSnakeTanhConfig(**MLP))
    sig, fs = _signal()
    calls = {
        "multi_inr_fit": lambda: tmulti.multi_inr_fit(mlp, sig, fs),
        "multi_inr_fit_many": lambda: tmulti.multi_inr_fit_many(
            mlp, [sig], fs),
        "fit": lambda: tloop.fit(mlp, *_problem()),
        "train_from_signal": lambda: trunner.train_from_signal(
            str(tmp_path), "t", sig, fs),
        "decode_dense": lambda: tdecode.decode_dense(
            dataclasses.replace(mlp, apply=_trained), {}, _problem()[0]),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
    assert not (tmp_path / "t").exists()
