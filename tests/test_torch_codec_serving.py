"""The rest of the codec held against the JAX package on the CPU: the
modulated family's payloads in both directions (INRA and npz; int8 with a
float16 backbone, segmented int16, FiLM float16, stereo), the rate tables
and planners, ``decode_many`` and ``decode_stream`` against ``decode``,
the multi-INR fit's metrics hook and the CLI's ``encode --modulated`` /
``--target-bps``, multi-input ``decode``, ``info`` and ``fit-multi``.

The JAX side stays on ``fused=False`` (its auto route is TPU-only).  A
trained payload's decode agrees to TRAINED_ATOL (tests/test_torch_decode.py:
summation order times the hidden sines' omega).  ``decode_many`` is
element-equal to ``decode``: a window's forward does not depend on which
windows share its call.  ``decode_stream`` evaluates the same windows as
the full decode, so its blocks agree to STREAM_ATOL."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from inraudio_tpu import codec as jcodec
from inraudio_tpu_torch import codec as tcodec
from inraudio_tpu_torch.__main__ import main as port_main
from inraudio_tpu_torch.data import read_wav, write_wav
from inraudio_tpu_torch.models import (SirenSnakeTanhConfig, build_model,
                                       params_from_jax)
from inraudio_tpu_torch.train import multi_inr as tmulti
from inraudio_tpu_torch.train.loop import TrainConfig
from inraudio_tpu_torch.utils.observability import (MetricsLogger,
                                                    read_metrics)
from test_torch_codec import assert_same_payload, jax_payload
from test_torch_cuda import run_thread_ranks

torch.set_num_threads(1)

FS = 4000
TRAINED_ATOL = 3e-5
STREAM_ATOL = 1e-7
MOD = dict(chunk_seconds=0.05, hidden_features=16, first_omega_0=100.0,
           total_steps=30, learning_rate=2e-3)
KINDS = {
    "int8": dict(quantize_mods="int8"),
    "seg-int16": dict(quantize_mods="int16", segment_s=0.1,
                      shared_fp16=False),
    "film-f16": dict(quantize_mods="float16", film_scale=True),
    "f32-refit-f16": dict(quantize_mods="float16", shared_fp16=False,
                          refit_backbone_steps=10, mods_lr_mult=5.0),
}


def _sig(seconds=0.3, f=220.0, stereo=False):
    t = np.arange(int(seconds * FS)) / FS
    s = 0.7 * np.sin(2 * np.pi * f * t) + 0.2 * np.sin(2 * np.pi * 3 * f * t)
    if stereo:
        s = np.stack([s, 0.5 * np.sin(2 * np.pi * 347.0 * t)], axis=1)
    return s.astype(np.float32)


def _cfg(pkg, kind):
    return pkg.ModulatedCodecConfig(**MOD, **KINDS.get(kind, KINDS["int8"]))


@pytest.fixture(scope="module")
def jax_mod_payloads():
    """One JAX encode per kind (plus a stereo int8 one), shared read-only."""
    out = {k: jcodec.encode_modulated(_sig(), FS, _cfg(jcodec, k))
           for k in KINDS}
    out["stereo"] = jcodec.encode_modulated(_sig(stereo=True), FS,
                                            _cfg(jcodec, "int8"))
    return out


@pytest.fixture(scope="module")
def port_mod_payloads():
    out = {k: tcodec.encode_modulated(_sig(), FS, _cfg(tcodec, k),
                                      device="cpu") for k in KINDS}
    out["stereo"] = tcodec.encode_modulated(_sig(stereo=True), FS,
                                            _cfg(tcodec, "int8"),
                                            device="cpu")
    return out


def _snr(ref, rec):
    return 10 * np.log10(np.sum(ref ** 2) / np.sum((ref - rec) ** 2))


@pytest.mark.parametrize("container", ["p.inra", "p.npz"])
@pytest.mark.parametrize("kind", [*KINDS, "stereo"])
def test_jax_modulated_payload_decodes_in_port(tmp_path, jax_mod_payloads,
                                               kind, container):
    jp = jax_mod_payloads[kind]
    path = jcodec.save_inr(str(tmp_path / container), jp)
    tp = tcodec.load_inr(path)
    assert_same_payload(jcodec.load_inr(path), tp)
    _, ref = jcodec.decode(jp, fused=False)
    fs, out = tcodec.decode(tp, "cpu")
    assert fs == FS and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=TRAINED_ATOL, rtol=0)
    _, ref2 = jcodec.decode(jp, fused=False, upsample=2)
    _, out2 = tcodec.decode(tp, "cpu", upsample=2)
    np.testing.assert_allclose(out2, ref2, atol=TRAINED_ATOL, rtol=0)
    _, rref = jcodec.decode_range(jp, 0.07, 0.23)
    _, rout = tcodec.decode_range(tp, 0.07, 0.23, "cpu")
    np.testing.assert_allclose(rout, rref, atol=TRAINED_ATOL, rtol=0)
    np.testing.assert_allclose(rout, out[280:920], atol=STREAM_ATOL, rtol=0)


@pytest.mark.parametrize("kind", [*KINDS, "stereo"])
def test_port_modulated_payload_decodes_in_jax(tmp_path, jax_mod_payloads,
                                               port_mod_payloads, kind):
    tp = port_mod_payloads[kind]
    # the header is the JAX package's, key for key
    assert tp["meta"] == jax_mod_payloads[kind]["meta"]
    path = tcodec.save_inr(str(tmp_path / "p.inra"), tp)
    jp = jcodec.load_inr(path)
    assert_same_payload(jp, tp)
    _, ref = tcodec.decode(tp, "cpu")
    _, out = jcodec.decode(jp, fused=False)
    np.testing.assert_allclose(out, ref, atol=TRAINED_ATOL, rtol=0)
    assert ref.shape == _sig(stereo=kind == "stereo").shape
    npz = tcodec.save_inr(str(tmp_path / "p.npz"), tp)
    assert_same_payload(jcodec.load_inr(npz), tcodec.load_inr(npz))


def test_modulated_payload_costs_and_segment_layout(port_mod_payloads):
    p = port_mod_payloads["int8"]
    mods = p["params"]["mods"]
    assert mods["q"].dtype == torch.int8
    assert mods["scale"].shape == (1, p["meta"]["mod_dim"])
    per_window = mods["q"].numel() / p["meta"]["num_chunks"]
    assert per_window < tcodec.param_bytes(p["params"]["shared"]) / 10
    layers = p["params"]["shared"]["layers"]
    assert layers[0]["w"].dtype == torch.float32
    assert all(v.dtype == torch.float16 for layer in layers[1:]
               for v in layer.values())
    seg = port_mod_payloads["seg-int16"]
    n_seg = seg["meta"]["num_segments"]
    assert n_seg == 3 and len(seg["meta"]["segment_bounds"]) == n_seg + 1
    assert all(v.shape[0] == n_seg and v.dtype == torch.float32
               for layer in seg["params"]["shared"]["layers"]
               for v in layer.values())
    assert seg["params"]["mods"]["q"].dtype == torch.int16


def test_estimate_modulated_bps_is_the_payload_size():
    sig = _sig(0.6)
    for quant, seg in ((None, None), ("float16", None), ("int8", None),
                       ("int16", 0.25)):
        cfg = tcodec.ModulatedCodecConfig(
            **{**MOD, "total_steps": 2}, quantize_mods=quant, segment_s=seg)
        st = tcodec.compression_stats(tcodec.encode_modulated(
            sig, FS, cfg, device="cpu"))
        est = tcodec.estimate_modulated_bps(cfg, len(sig), FS)
        assert abs(est - st["bits_per_sample"]) < 1e-9, (quant, seg)


def test_encode_modulated_validation():
    cfg = tcodec.ModulatedCodecConfig(total_steps=2)
    with pytest.raises(ValueError, match="empty"):
        tcodec.encode_modulated(np.zeros((0, 2), np.float32), FS, cfg,
                                device="cpu")
    for kw, match in ((dict(quantize_mods="int4"), "quantize_mods"),
                      (dict(segment_s=0.0), "segment_s"),
                      (dict(quantize_mods=None, refit_backbone_steps=3),
                       "refit_backbone_steps")):
        with pytest.raises(ValueError, match=match):
            tcodec.encode_modulated(_sig(0.1), FS, dataclasses.replace(
                cfg, **kw), device="cpu")


def test_auto_mod_tier_rule_and_e2e():
    for args in (([1e-4], [0.1], [10]), ([1e-9], [0.1], [10]),
                 ([1e-4, 1e-9], [0.1, 0.1], [100, 1]),
                 ([1e-4, 1e-9], [0.1, 0.1], [1, 1000]),
                 ([1e-6, 1e-9], [0.1, 0.1], [1, 1000])):
        assert tcodec._auto_mod_tier(*args) == jcodec._auto_mod_tier(*args)
    p = tcodec.encode_modulated(_sig(0.2), FS, tcodec.ModulatedCodecConfig(
        **{**MOD, "total_steps": 20}, quantize_mods="auto"), device="cpu")
    assert p["meta"]["quantize"] == "float16"
    assert p["params"]["mods"].dtype == torch.float16


def _asdict(cfg):
    return type(cfg).__name__, dataclasses.asdict(cfg)


TARGETS = [0.5, 1.0, 1.5, 1.7, 1.9, 2.2, 3.2, 4.0, 4.5, 7.0, 9.0, 30.0, 50.0,
           60.0, 95.0, 120.0, 240.0, 300.0, 500.0, 1000.0]


def test_config_for_bitrate_matches_jax():
    base_t = tcodec.CodecConfig(fused=True, seed=7, max_chunks_per_batch=16)
    base_j = jcodec.CodecConfig(fused=True, seed=7, max_chunks_per_batch=16)
    for b in TARGETS:
        assert (dataclasses.asdict(tcodec.config_for_bitrate(b))
                == dataclasses.asdict(jcodec.config_for_bitrate(b))), b
        assert (dataclasses.asdict(tcodec.config_for_bitrate(b, base_t))
                == dataclasses.asdict(jcodec.config_for_bitrate(b, base_j)))


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("seconds", [7, 60])
def test_plan_for_bitrate_matches_jax(seconds, channels):
    n = seconds * 44100 + 7
    pts = (("m", 90.0, dict(chunk_seconds=0.05, hidden_features=64,
                            quantize_mods="int8")),
           ("u", None, dict(hidden_features=32)),
           ("s", 50.0, dict(hidden_features=128, segment_s=1.0,
                            quantize_mods="float16", film_scale=True)))
    for b in TARGETS:
        for override in (None, pts):
            tk, tc = tcodec.plan_for_bitrate(b, n, 44100, channels,
                                             _mod_points=override)
            jk, jc = jcodec.plan_for_bitrate(b, n, 44100, channels,
                                             _mod_points=override)
            assert (tk, _asdict(tc)) == (jk, _asdict(jc)), (b, override)
    for name, _snr_db, knobs in tcodec._MOD_RD_POINTS + pts:
        for quant in (None, "float16", "int8", "int16", "auto"):
            cfg = dict(knobs, quantize_mods=quant)
            assert tcodec.estimate_modulated_bps(
                tcodec.ModulatedCodecConfig(**cfg), n, 44100, channels) == \
                jcodec.estimate_modulated_bps(
                    jcodec.ModulatedCodecConfig(**cfg), n, 44100, channels)


def test_plan_for_bitrate_families_on_the_calibration_clip():
    """The JAX package's planning on its 7 s calibration shape: ultra-low
    and mid targets plan the modulated family, the rest per-window."""
    n = 308207
    for target, kind, h in ((1.0, "modulated", 48), (1.5, "modulated", 48),
                            (1.7, "modulated", 48), (1.9, "per_chunk", 32),
                            (4.0, "per_chunk", 48), (30.0, "modulated", 128),
                            (120.0, "per_chunk", 128)):
        k, cfg = tcodec.plan_for_bitrate(target, n, 44100)
        assert (k, cfg.hidden_features) == (kind, h), target


def _per_window_payloads():
    """Per-window payloads (tests/test_torch_codec.py's layout, k = 5): an
    exact f32 one, an int8 one and a fused-trained int4 one with the same
    recipe, and a float16 one at another width."""
    return [_port_payload(jax_payload(**kw)) for kw in (
        dict(quantize=None, seed=0), dict(quantize="int8", seed=1),
        dict(quantize="int4", per_row=True, seed=2,
             trained_forward="fused_approx", fit_snr_db=60.0),
        dict(quantize="float16", seed=3, h=16))]


def _port_payload(jp):
    return {**jp, "params": params_from_jax(jp["params"])}


@pytest.mark.parametrize("fused", [None, True, False])
def test_decode_many_equals_decode(port_mod_payloads, fused):
    payloads = _per_window_payloads() + [port_mod_payloads["seg-int16"],
                                         port_mod_payloads["stereo"]]
    payloads.insert(2, payloads[0])  # a payload twice in one group
    many = tcodec.decode_many(payloads, "cpu", fused=fused)
    assert len(many) == len(payloads)
    for p, (fs, out) in zip(payloads, many):
        fs1, one = tcodec.decode(p, "cpu", fused=fused)
        assert fs == fs1 and np.array_equal(out, one)
    # in batches: the CPU's matmul rounds a batch of one window apart from
    # a batch of several, so a window batched otherwise may move by an ulp
    many = tcodec.decode_many(payloads, "cpu", fused=fused,
                              max_chunks_per_batch=2)
    for p, (fs, out) in zip(payloads, many):
        _, one = tcodec.decode(p, "cpu", fused=fused, max_chunks_per_batch=2)
        np.testing.assert_allclose(out, one, atol=STREAM_ATOL, rtol=0)
    up = tcodec.decode_many(payloads[:2], "cpu", fused=fused, upsample=2)
    for p, (fs, out) in zip(payloads[:2], up):
        assert np.array_equal(out, tcodec.decode(p, "cpu", fused=fused,
                                                 upsample=2)[1])


def test_decode_many_groups_one_call_per_group(monkeypatch):
    payloads = _per_window_payloads()
    calls = []
    real = tmulti.batched_chunk_eval

    def counting(fn, params, k, kb):
        calls.append(k)
        return real(fn, params, k, kb)

    monkeypatch.setattr(tcodec, "batched_chunk_eval", counting)
    tcodec.decode_many(payloads, "cpu")
    # the first three share recipe, window length and route (the
    # fused-trained one goes to the exact apply on the CPU as well); the
    # last has another width
    assert sorted(calls) == [5, 3 * 5]


@pytest.mark.parametrize("which", ["per-window", "fused", "modulated",
                                   "stereo"])
def test_decode_stream_equals_decode(port_mod_payloads, which):
    p = {"per-window": lambda: _per_window_payloads()[1],
         "fused": lambda: _per_window_payloads()[2],
         "modulated": lambda: port_mod_payloads["seg-int16"],
         "stereo": lambda: port_mod_payloads["stereo"]}[which]()
    fused = True if which == "fused" else None
    _, full = tcodec.decode(p, "cpu", fused=fused)
    blocks = list(tcodec.decode_stream(p, "cpu", block_s=0.037, fused=fused))
    assert blocks[0][0] == 0
    assert [a for a, _ in blocks] == list(range(0, len(full), 148))
    np.testing.assert_allclose(np.concatenate([b for _, b in blocks]), full,
                               atol=STREAM_ATOL, rtol=0)


def _fit_records(tmp_path, name, **kw):
    sig = _sig(0.2)
    model = build_model("mlp", SirenSnakeTanhConfig(
        hidden_features=16, first_omega_0=115.0, num_sine=1, num_snake=1),
        fused=True, approx_sin=True)
    path = str(tmp_path / f"{name}.jsonl")
    with MetricsLogger(path) as m:
        res = tmulti.multi_inr_fit(
            model, sig, FS, tmulti.MultiINRConfig(chunk_seconds=0.02,
                                                  overlap_fraction=0.1),
            TrainConfig(total_steps=7, grad_clip_norm=1.0, scan_chunk=3),
            metrics=m, **kw)
    return res, read_metrics(path)


def test_multi_inr_fit_metrics_one_record_a_round(tmp_path):
    res, recs = _fit_records(tmp_path, "one", device="cpu")
    assert [r["step"] for r in recs] == [3, 6, 7]
    for r, step in zip(recs, (3, 6, 7)):
        assert r["event"] == "round"
        last = res.loss_history[step - 1]
        assert r["loss"] == pytest.approx(float(np.mean(last)), rel=1e-6)
        assert r["worst_chunk_loss"] == pytest.approx(float(np.max(last)),
                                                      rel=1e-6)
        assert r["elapsed_s"] >= 0 and r["steps_per_sec"] > 0
    # batched: each batch's rounds, windows of that batch
    _, brecs = _fit_records(tmp_path, "batched", device="cpu",
                            max_chunks_per_batch=5)
    assert res.num_chunks == 11  # batches of 5, 5 and 1 windows
    assert [r["step"] for r in brecs] == [3, 6, 7] * 3
    # sharded over two ranks: the same records, all windows
    ranks = run_thread_ranks(2, lambda mesh: _fit_records(
        tmp_path, f"rank{mesh.rank}", mesh=mesh), device="cpu",
        timeout_s=60.0)
    for _, rrecs in ranks:
        assert [r["step"] for r in rrecs] == [3, 6, 7]
        for a, b in zip(rrecs, recs):
            assert a["loss"] == pytest.approx(b["loss"], rel=1e-6)
            assert a["worst_chunk_loss"] == pytest.approx(
                b["worst_chunk_loss"], rel=1e-6)


ENC = ["encode", "--input", "missing.wav", "--output", "y"]


@pytest.mark.parametrize("extra", [
    ["--modulated", "--target-bps", "4.5"],
    ["--modulated", "--quantize", "int4"],
    ["--modulated", "--quantize", "bfloat16"],
    ["--modulated", "--quantize", "none", "--refit-steps", "100"],
    ["--modulated", "--fused"],
    ["--modulated", "--per-row-scales"],
    ["--film-scale"], ["--segment-s", "1.0"], ["--mods-lr-mult", "5"],
    ["--quantize", "auto"]])
def test_cli_encode_flag_conflicts(capsys, extra):
    """Each conflict fails before any file is read (the input is absent)."""
    with pytest.raises(SystemExit) as e:
        port_main(ENC + extra + ["--device", "cpu"])
    assert e.value.code == 2
    assert "error:" in capsys.readouterr().err


def test_cli_encode_modulated_and_target_bps(tmp_path, capsys, monkeypatch):
    wav = str(tmp_path / "x.wav")
    write_wav(wav, FS, _sig(0.3))
    out = str(tmp_path / "m.inra")
    assert port_main(["encode", "--input", wav, "--output", out, "--device",
                      "cpu", "--modulated", "--chunk-s", "0.05", "--hidden",
                      "16", "--omega", "200", "--total-steps", "20",
                      "--quantize", "int16", "--segment-s", "0.1",
                      "--film-scale", "--refit-steps", "5"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    p = tcodec.load_inr(rec["path"])
    assert rec["codec"] == "modulated" and p["meta"]["num_segments"] == 3
    assert p["meta"]["film_scale"] and p["meta"]["quantize"] == "int16"
    _, jref = jcodec.decode(jcodec.load_inr(rec["path"]), fused=False)
    np.testing.assert_allclose(tcodec.decode(p, "cpu")[1], jref,
                               atol=TRAINED_ATOL, rtol=0)
    # --target-bps encodes the family the planner picks: per-window at 4
    # bps (the 3.98 point, h=48 int8), modulated when a calibrated
    # modulated point fits with the higher SNR
    base = ["encode", "--input", wav, "--device", "cpu", "--total-steps",
            "3", "--seed", "2"]
    assert port_main(base + ["--output", str(tmp_path / "a"),
                             "--target-bps", "4"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    meta = tcodec.load_inr(rec["path"])["meta"]
    assert rec["codec"] == "per_chunk"
    assert (meta["model"]["hidden_features"], meta["quantize"]) == (48, "int8")
    monkeypatch.setattr(tcodec, "_MOD_RD_POINTS", (("tiny", 200.0, dict(
        chunk_seconds=0.05, hidden_features=8, quantize_mods="int8",
        refit_backbone_steps=2)),))
    assert port_main(base + ["--output", str(tmp_path / "b"),
                             "--target-bps", "1000"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    meta = tcodec.load_inr(rec["path"])["meta"]
    assert rec["codec"] == "modulated"
    assert (meta["model"]["hidden_features"], meta["quantize"]) == (8, "int8")


def test_cli_decode_many_and_info(tmp_path, capsys, port_mod_payloads):
    pa = tcodec.save_inr(str(tmp_path / "a.inra"),
                         _per_window_payloads()[1])
    pb = tcodec.save_inr(str(tmp_path / "b.inra"),
                         port_mod_payloads["seg-int16"])
    oa, ob = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    assert port_main(["decode", "--device", "cpu", "--input", pa, pb,
                      "--output", oa, ob]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(x)["path"] for x in lines] == [oa, ob]
    for wav, path in ((oa, pa), (ob, pb)):
        fs, data = read_wav(wav)
        fs1, ref = tcodec.decode(tcodec.load_inr(path), "cpu")
        assert fs == fs1 and np.array_equal(data, ref)
    for bad in (["--output", oa], ["--output", oa, ob, "--start", "0",
                                   "--stop", "0.1"]):
        with pytest.raises(SystemExit):
            port_main(["decode", "--device", "cpu", "--input", pa, pb] + bad)
    capsys.readouterr()
    assert port_main(["info", "--input", pb]) == 0
    text = capsys.readouterr().out
    assert "codec: modulated" in text and "segments: 3" in text
    assert f"mod_dim: {port_mod_payloads['seg-int16']['meta']['mod_dim']}" \
        in text
    assert port_main(["info", "--input", pb, "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == jcodec.payload_info(pb)


def test_cli_fit_multi_metrics(tmp_path, capsys):
    wav = str(tmp_path / "x.wav")
    write_wav(wav, FS, _sig(0.2))
    out, metrics = str(tmp_path / "y.wav"), str(tmp_path / "m.jsonl")
    assert port_main(["fit-multi", "--device", "cpu", "--input", wav,
                      "--output", out, "--hidden", "16", "--total-steps",
                      "520", "--fused", "--metrics", metrics]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec) == {"path", "snr_db", "num_chunks", "train_time_s"}
    assert rec["path"] == out and rec["num_chunks"] == tmulti.chunk_signal(
        _sig(0.2), FS, tmulti.MultiINRConfig(0.01161, 0.1))[0].shape[0]
    recs = read_metrics(metrics)
    assert [r["step"] for r in recs] == [500, 520]
    assert all(r["event"] == "round" for r in recs)
    fs, data = read_wav(out)
    assert fs == FS and data.shape == (800,)
    assert rec["snr_db"] == pytest.approx(_snr(_sig(0.2), data), abs=1e-3)


def test_new_entry_points_raise_without_a_card(tmp_path, port_mod_payloads):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    p = port_mod_payloads["int8"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcodec.encode_modulated(_sig(0.1), FS, _cfg(tcodec, "int8"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcodec.decode_many([p], "cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(tcodec.decode_stream(p, "cuda"))
    wav = str(tmp_path / "x.wav")
    write_wav(wav, FS, _sig(0.1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["fit-multi", "--input", wav, "--output",
                   str(tmp_path / "y.wav")])
