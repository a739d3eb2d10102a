"""Payload files cross between the packages: the JAX package writes and the
port reads, the port writes and the JAX package reads, leaves bit-equal, in
both containers (INRA and legacy npz) and every quantization layout."""

import jax
import numpy as np
import pytest
import torch

from inraudio_tpu import codec as jcodec
from inraudio_tpu.models import SirenSnakeTanhConfig as JaxConfig
from inraudio_tpu.models import build_model as jax_build_model
from inraudio_tpu_torch import codec as tcodec
from inraudio_tpu_torch.models import params_from_jax
from inraudio_tpu_torch.tree import tree_leaves

torch.set_num_threads(1)

FS = 4000
N, HOP, K, LENGTH = 128, 115, 5, 560  # 0.032 s windows, overlap 0.1


def jax_payload(quantize=None, side=True, trained_forward="exact",
                fit_snr_db=40.0, h=32, omega=200.0, per_row=False, seed=0):
    """A payload dict as the JAX codec's encode builds it, without training:
    JAX init per window, random peak scales, the meta schema of
    codec.encode."""
    cfg = JaxConfig(hidden_features=h, first_omega_0=omega)
    params = jax.vmap(jax_build_model("mlp", cfg).init)(
        jax.random.split(jax.random.PRNGKey(seed), K))
    stored = (jcodec.quantize_inr_params(params, quantize, per_row=per_row,
                                         side=side)
              if quantize else params)
    scales = np.random.default_rng(seed).uniform(0.2, 0.9, K).astype(
        np.float32)
    meta = {"format": jcodec._FORMAT, "sample_rate": FS,
            "signal_length": LENGTH, "chunk_length": N, "hop": HOP,
            "num_chunks": K, "num_channels": 1, "quantize": quantize,
            "per_row_scales": per_row,
            "side_quantized": bool(quantize and side),
            "trained_forward": trained_forward, "fit_snr_db": fit_snr_db,
            "model": {"hidden_features": h, "num_sine": 2, "num_snake": 2,
                      "first_omega_0": omega, "hidden_omega_0": 30.0}}
    return {"meta": meta, "scales": scales,
            "params": jax.tree.map(np.asarray, stored)}


def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def assert_same_payload(jp, tp):
    assert jp["meta"] == tp["meta"]
    assert np.array_equal(np.asarray(jp["scales"]), np.asarray(tp["scales"]))
    jl = jax.tree_util.tree_leaves(jp["params"])
    tl = tree_leaves(tp["params"])
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a, b = _bits(a), _bits(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


LAYOUTS = [
    dict(quantize=None, trained_forward="exact"),
    dict(quantize=None, trained_forward="fused_approx"),
    dict(quantize="float16", side=True),
    dict(quantize="float16", side=False, trained_forward="fused_approx"),
    dict(quantize="bfloat16", side=True),
    dict(quantize="int8", side=True),
    dict(quantize="int8", side=False),
    dict(quantize="int16", side=True, per_row=True),
    dict(quantize="int4", side=True, per_row=True),
    dict(quantize="int4", side=False, per_row=True),
]
LAYOUT_IDS = ["f32-exact", "f32-fused", "f16-side", "f16-noside-fused",
              "bf16-side", "int8-side", "int8-noside", "int16-row",
              "int4-row-side", "int4-row-noside"]


@pytest.mark.parametrize("ext", [".inra", ".npz"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
def test_jax_writes_port_reads(tmp_path, layout, ext):
    jp = jax_payload(**layout)
    path = jcodec.save_inr(str(tmp_path / ("p" + ext)), jp)
    assert_same_payload(jcodec.load_inr(path), tcodec.load_inr(path))


@pytest.mark.parametrize("ext", [".inra", ".npz"])
@pytest.mark.parametrize("layout", LAYOUTS[::2] + LAYOUTS[5:6],
                         ids=LAYOUT_IDS[::2] + LAYOUT_IDS[5:6])
def test_port_writes_jax_reads(tmp_path, layout, ext):
    # the port quantizes the same float32 params itself and writes; the JAX
    # package reads leaves bit-equal to what its own quantizer makes
    jp = jax_payload(**layout)
    raw = jax_payload(**{**layout, "quantize": None})
    tparams = params_from_jax(raw["params"])
    if layout.get("quantize"):
        tparams = tcodec.quantize_inr_params(
            tparams, layout["quantize"], per_row=layout.get("per_row", False),
            side=layout.get("side", True))
    tp = {"meta": jp["meta"], "scales": jp["scales"], "params": tparams}
    path = tcodec.save_inr(str(tmp_path / ("p" + ext)), tp)
    back = jcodec.load_inr(path)
    assert_same_payload(back, tp)
    assert_same_payload(jp, tp)
    if ext == ".inra":
        # same candidate codings, same winner: the files are byte-identical
        jpath = jcodec.save_inr(str(tmp_path / "j.inra"), jp)
        with open(path, "rb") as a, open(jpath, "rb") as b:
            assert a.read() == b.read()


def test_load_resolves_suffix_and_rejects_bad_payloads(tmp_path):
    jp = jax_payload(quantize="int8")
    path = jcodec.save_inr(str(tmp_path / "q"), jp)  # appends .inra
    assert path.endswith(".inra")
    assert_same_payload(jp, tcodec.load_inr(str(tmp_path / "q")))
    bad = dict(jp, meta={**jp["meta"], "format": "inraudio_tpu.inr.v1"})
    jcodec.save_inr(str(tmp_path / "old.inra"), bad)
    with pytest.raises(ValueError, match="unsupported payload format"):
        tcodec.load_inr(str(tmp_path / "old.inra"))
    # int8 weights are {q, scale} pairs: a header claiming float32 leaves
    # expects fewer leaves than the file holds
    wrong = dict(jp, meta={**jp["meta"], "quantize": None})
    jcodec.save_inr(str(tmp_path / "wrong.inra"), wrong)
    with pytest.raises(ValueError, match="leaf count"):
        tcodec.load_inr(str(tmp_path / "wrong.inra"))


@pytest.mark.parametrize("ext", [".inra", ".npz"])
def test_payload_info_matches_jax(tmp_path, ext):
    path = jcodec.save_inr(str(tmp_path / ("p" + ext)),
                           jax_payload(quantize="int4", per_row=True))
    assert tcodec.payload_info(path) == jcodec.payload_info(path)


def test_dequantize_on_device_matches_jax():
    jp = jax_payload(quantize="int4", per_row=True)
    tp = {**jp, "params": params_from_jax(jp["params"])}
    ref = jax.tree.map(np.asarray,
                       jcodec.dequantize_inr_params(jp["params"]))
    out = tcodec.dequantize_inr_params(tp["params"], "cpu")
    for a, b in zip(jax.tree_util.tree_leaves(ref), tree_leaves(out)):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(a.astype(np.float32), b.numpy())
