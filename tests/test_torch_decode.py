"""The port's decode slice end to end (load_inr -> decode / decode_range ->
stitched waveform, and the CLI) held against the JAX package on the CPU."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inraudio_tpu import codec as jcodec
from inraudio_tpu.ops import pallas_siren as jps
from inraudio_tpu.train.multi_inr import stitch_chunks as jax_stitch
from inraudio_tpu_torch import codec as tcodec
from inraudio_tpu_torch.__main__ import main as port_main
from inraudio_tpu_torch.data import read_wav

from test_torch_codec import FS, LENGTH, jax_payload

torch.set_num_threads(1)

# exact route: true-f32 forward on both sides, outputs scaled by <= 0.9 and
# overlap-added in float64; matmul order and libm sin differ by ~1e-7
EXACT_ATOL = 1e-5
# a trained payload's hidden pre-activations are larger than init's, so a
# one-ulp summation-order difference becomes ~1e-5 rad after the x30 sine
# (measured 1.004e-5 max on the 20-step encode below)
TRAINED_ATOL = 3e-5


def _port(path):
    return tcodec.load_inr(path)


@pytest.mark.parametrize("layout", [dict(quantize=None),
                                    dict(quantize="int8", side=True),
                                    dict(quantize="int4", per_row=True,
                                         trained_forward="fused_approx")],
                         ids=["f32", "int8", "int4-fused-trained"])
def test_exact_route_matches_jax_decode(tmp_path, layout):
    jp = jax_payload(**layout)
    path = jcodec.save_inr(str(tmp_path / "p.inra"), jp)
    tp = _port(path)
    # on the CPU both packages auto-route to the exact apply
    fs, ref = jcodec.decode(jcodec.load_inr(path), fused=False)
    tfs, out = tcodec.decode(tp, "cpu")
    assert tfs == fs == FS and out.shape == ref.shape == (LENGTH,)
    np.testing.assert_allclose(out, ref, atol=EXACT_ATOL, rtol=0)
    # bandwidth-extension grid
    fs2, ref2 = jcodec.decode(jcodec.load_inr(path), fused=False, upsample=2)
    tfs2, out2 = tcodec.decode(tp, "cpu", upsample=2)
    assert tfs2 == fs2 == 2 * FS and out2.shape == ref2.shape
    np.testing.assert_allclose(out2, ref2, atol=EXACT_ATOL, rtol=0)
    # random access, and the windows-in-batches bound
    _, rref = jcodec.decode_range(jcodec.load_inr(path), 0.03, 0.1,
                                  fused=False)
    _, rout = tcodec.decode_range(tp, 0.03, 0.1, "cpu")
    np.testing.assert_allclose(rout, rref, atol=EXACT_ATOL, rtol=0)
    np.testing.assert_allclose(rout, out[120:400], atol=1e-7, rtol=0)
    _, bout = tcodec.decode(tp, "cpu", max_chunks_per_batch=2)
    np.testing.assert_allclose(bout, out, atol=1e-7, rtol=0)


def _jax_fused_pipeline(jp, chunks_per_step=8):
    """The JAX package's fused decode assembled by hand (its auto route is
    TPU-only): the stacked kernel in interpret mode at the header's tier,
    then the per-window scale and the crossfade stitch."""
    meta = jp["meta"]
    params = jcodec.dequantize_inr_params(jp["params"])
    cfg = jcodec._model_cfg_from_meta(meta)
    kw = jps.auto_decode_kwargs(jcodec._routing_fit_snr(meta),
                                first_omega_0=cfg.first_omega_0)
    coords = jnp.asarray(jcodec._decode_grid(meta["chunk_length"], 1))
    outs = np.asarray(jps.fused_siren_apply_stacked(
        params, cfg, coords, chunks_per_step=chunks_per_step, interpret=True,
        **kw))
    outs = outs[:, :, 0] * jp["scales"][:, None]
    return kw, jax_stitch(outs, meta["hop"], meta["signal_length"])


@pytest.mark.parametrize("fit,atol", [(60.0, 1e-5), (130.0, 1e-5),
                                      (20.0, None)],
                         ids=["deg9", "exact-sin", "bf16-deg7"])
def test_fused_route_matches_jax_kernel_pipeline(tmp_path, fit, atol):
    jp = jax_payload(quantize="float16", trained_forward="fused_approx",
                     fit_snr_db=fit)
    path = jcodec.save_inr(str(tmp_path / "p.inra"), jp)
    kw, ref = _jax_fused_pipeline(jcodec.load_inr(path))
    _, out = tcodec.decode(_port(path), "cpu", fused=True)
    assert out.shape == ref.shape == (LENGTH,)
    err = np.abs(out - ref)
    if atol is not None:
        assert err.max() <= atol, (kw, err.max())
    else:
        # bf16 tier: isolated rounding-boundary flips (see test_torch_ops)
        assert kw.get("compute_dtype") == jnp.bfloat16
        assert err.max() <= 3e-4 and np.mean(err <= 2e-6) >= 0.95, err.max()


def test_real_encode_decodes_in_both_packages(tmp_path):
    # a genuine (short) JAX encode: trained int8 weights + a real fit SNR
    t = np.arange(int(0.2 * FS)) / FS
    sig = (0.6 * np.sin(2 * np.pi * 180.0 * t)
           + 0.2 * np.sin(2 * np.pi * 410.0 * t)).astype(np.float32)
    cfg = jcodec.CodecConfig(chunk_seconds=0.05, hidden_features=32,
                             first_omega_0=200.0, total_steps=20,
                             learning_rate=1e-3, quantize="int8")
    jp = jcodec.encode(sig, FS, cfg)
    assert jp["meta"].get("fit_snr_db") is not None
    tp = tcodec.load_inr(jcodec.save_inr(str(tmp_path / "enc.inra"), jp))
    _, ref = jcodec.decode(jp, fused=False)
    _, out = tcodec.decode(tp, "cpu")
    np.testing.assert_allclose(out, ref, atol=TRAINED_ATOL, rtol=0)
    # fused route at the header's tier (a 20-step fit lands on a bf16 tier:
    # under trained weights one rounding-boundary flip moves an output by
    # up to ~1e-3, measured 1.02e-3 -- inside that tier's own ~43 dB floor)
    kw, fref = _jax_fused_pipeline(jp, chunks_per_step=16)
    _, fout = tcodec.decode(tp, "cpu", fused=True)
    err = np.abs(fout - fref)
    assert kw.get("compute_dtype") == jnp.bfloat16 or kw.get("mixed_matmul")
    assert err.max() <= 2e-3 and np.mean(err <= 2e-6) >= 0.95, err.max()
    # and at the f32-class deg-9 tier, where no flips happen
    hi = {**jp, "meta": {**jp["meta"], "fit_snr_db": 60.0}}
    thi = {**tp, "meta": hi["meta"]}
    kw, fref = _jax_fused_pipeline(hi, chunks_per_step=16)
    assert kw == dict(approx_sin=True, sin_poly_degree=9)
    _, fout = tcodec.decode(thi, "cpu", fused=True)
    np.testing.assert_allclose(fout, fref, atol=TRAINED_ATOL, rtol=0)


def test_cli_decode_and_info(tmp_path, capsys):
    path = jcodec.save_inr(str(tmp_path / "p.inra"),
                           jax_payload(quantize="float16"))
    wav = str(tmp_path / "out.wav")
    assert port_main(["decode", "--input", path, "--output", wav,
                      "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["samples"] == LENGTH and rec["sample_rate"] == FS
    fs, data = read_wav(wav)
    _, ref = tcodec.decode(tcodec.load_inr(path), "cpu")
    assert fs == FS and np.array_equal(data, ref)
    wav2 = str(tmp_path / "range.wav")
    assert port_main(["decode", "--input", path, "--output", wav2,
                      "--device", "cpu", "--start", "0.03", "--stop",
                      "0.1", "--fused", "on", "--max-chunks", "2"]) == 0
    assert read_wav(wav2)[1].shape == (280,)
    capsys.readouterr()
    assert port_main(["info", "--input", path, "--json"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info == jcodec.payload_info(path)
    assert port_main(["info", "--input", path]) == 0
    assert "INRA container" in capsys.readouterr().out


def test_cuda_requests_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the kernel route runs")
    path = jcodec.save_inr(str(tmp_path / "p.inra"),
                           jax_payload(trained_forward="fused_approx"))
    tp = tcodec.load_inr(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcodec.decode(tp, "cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcodec.decode_range(tp, 0.0, 0.1, "cuda", fused=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["decode", "--input", path, "--output",
                   str(tmp_path / "x.wav")])  # --device defaults to cuda
