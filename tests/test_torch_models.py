"""The port's model, quantization, coordinate, audio-I/O and SNR modules held
against the JAX package on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inraudio_tpu.data import audio_io as jax_audio_io
from inraudio_tpu.data.coords import get_coord as jax_get_coord
from inraudio_tpu.dsp import calculate_snr as jax_snr
from inraudio_tpu.models import SirenSnakeTanhConfig as JaxConfig
from inraudio_tpu.models import build_model as jax_build_model
from inraudio_tpu.models import activations as jax_act
from inraudio_tpu.models import quantize as jax_quant
from inraudio_tpu_torch.data import get_coord, read_wav, write_wav
from inraudio_tpu_torch.dsp import calculate_snr
from inraudio_tpu_torch.models import (SirenSnakeTanhConfig, build_model,
                                       dequantize_params, params_from_jax,
                                       params_to_numpy, quantize_params,
                                       snake_apply)
from inraudio_tpu_torch.tree import tree_leaves

torch.set_num_threads(1)

RECIPES = [
    dict(hidden_features=32, first_omega_0=115.0),
    dict(hidden_features=32, first_omega_0=1800.0, num_tanh=1),
    dict(hidden_features=16, first_linear=True, num_sine=1),
    dict(hidden_features=16, last_linear=False, num_snake=1),
]


def _jax_population(cfg_kw, k, seed=0):
    params = jax.vmap(jax_build_model("mlp", JaxConfig(**cfg_kw)).init)(
        jax.random.split(jax.random.PRNGKey(seed), k))
    return params, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("cfg_kw", RECIPES,
                         ids=["prod", "tanh", "first-linear", "sine-head"])
def test_exact_apply_matches_jax(cfg_kw):
    # true-f32 forward on both sides; only matmul summation order and the
    # libm sin differ (~1e-7), well inside 1e-5 after omega amplification
    params, host = _jax_population(cfg_kw, 3)
    coords = np.linspace(-1, 1, 150, dtype=np.float32)[:, None]
    jcfg = JaxConfig(**cfg_kw)
    ref = np.asarray(jax.vmap(lambda p: jax_build_model("mlp", jcfg).apply(
        p, jnp.asarray(coords)))(params), np.float32)
    tparams = params_from_jax(host)
    model = build_model("mlp", SirenSnakeTanhConfig(**cfg_kw))
    out = model.apply(tparams, torch.from_numpy(coords)).numpy()
    assert out.shape == ref.shape == (3, 150, 1)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    # unstacked params give the single-model shape, same numbers
    one = {"layers": [{k: v[2] for k, v in p.items()}
                      for p in tparams["layers"]]}
    np.testing.assert_allclose(model.apply(one, torch.from_numpy(coords)),
                               ref[2], atol=1e-5, rtol=0)


def test_init_bounds_and_structure():
    cfg = SirenSnakeTanhConfig(hidden_features=64, first_omega_0=115.0)
    g = torch.Generator().manual_seed(0)
    p = build_model("mlp", cfg).init(g, "cpu", windows=5)
    jp = jax_build_model("mlp", JaxConfig(hidden_features=64)).init(
        jax.random.PRNGKey(0))
    # same tree, same per-window shapes and dtypes as the JAX init
    assert [sorted(l) for l in p["layers"]] == [sorted(l)
                                                for l in jp["layers"]]
    for tl, jl in zip(p["layers"], jp["layers"]):
        for key in jl:
            assert tuple(tl[key].shape) == (5,) + jl[key].shape
            assert tl[key].dtype == torch.float32
    h, om = 64, 30.0
    bounds = [1.0, np.sqrt(6 / h) / om, np.sqrt(6 / h) / om,
              1 / np.sqrt(h), 1 / np.sqrt(h), np.sqrt(6 / h) / om]
    for layer, bound in zip(p["layers"], bounds):
        w = layer["w"]
        assert float(w.abs().max()) <= bound
        # a uniform draw fills its range: the max is within 5% of the bound
        assert float(w.abs().max()) >= 0.95 * bound
    assert torch.all(p["layers"][3]["snake_a"] == 0.5)
    # the generator makes init reproducible
    q = build_model("mlp", cfg).init(torch.Generator().manual_seed(0), "cpu",
                                     windows=5)
    assert torch.equal(p["layers"][2]["w"], q["layers"][2]["w"])


def test_params_cross_both_ways():
    params, host = _jax_population(dict(hidden_features=16), 2)
    t = params_from_jax(host)
    back = params_to_numpy(t)
    for a, b in zip(jax.tree.leaves(host), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    bf = params_from_jax(jax.tree.map(
        lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)), host))
    assert bf["layers"][1]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        bf["layers"][1]["w"].float().numpy(),
        np.asarray(jnp.asarray(host["layers"][1]["w"], jnp.bfloat16),
                   np.float32))


QUANT_CASES = [
    ("float16", {}), ("bfloat16", {}), ("int8", {}),
    ("int8", dict(per_leading_axis=True)),
    ("int16", dict(per_leading_axis=True, per_row=True)),
    ("int4", dict(per_leading_axis=True)),
    ("int4", dict(per_leading_axis=True, per_row=True)),
]


def _leaf_bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("mode,kw", QUANT_CASES,
                         ids=[f"{m}-{'-'.join(k) or 'tensor'}"
                              for m, k in QUANT_CASES])
def test_quantize_bit_identical_to_jax(mode, kw):
    rng = np.random.default_rng(1)
    tree = {"w": (rng.standard_normal((3, 5, 7)) * 0.1).astype(np.float32),
            "b": rng.standard_normal((3, 7)).astype(np.float32)}
    jq = jax_quant.quantize_params(jax.tree.map(jnp.asarray, tree), mode, **kw)
    tq = quantize_params(params_from_jax(tree), mode, **kw)
    jl = jax.tree_util.tree_leaves(jq)
    tl = tree_leaves(tq)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert np.array_equal(_leaf_bits(a), _leaf_bits(b))
    np.testing.assert_array_equal(
        jax.tree.map(np.asarray, jax_quant.dequantize_params(jq))["w"],
        dequantize_params(tq)["w"].numpy())


def test_snake_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((50, 8)).astype(np.float32) * 3
    a = rng.uniform(0.2, 2.0, 8).astype(np.float32)
    np.testing.assert_allclose(
        snake_apply(torch.from_numpy(a), torch.from_numpy(x)).numpy(),
        np.asarray(jax_act.snake_apply(jnp.asarray(a), jnp.asarray(x))),
        atol=2e-6, rtol=0)


@pytest.mark.parametrize("sidelen,dim", [(512, 1), (11025, 1), (7, 2)])
def test_get_coord_identical(sidelen, dim):
    np.testing.assert_array_equal(get_coord(sidelen, dim),
                                  jax_get_coord(sidelen, dim))


def test_wav_io_and_snr_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    sig = (0.5 * rng.standard_normal(4000)).astype(np.float32)
    noisy = sig + 1e-3 * rng.standard_normal(4000).astype(np.float32)
    path = str(tmp_path / "x.wav")
    write_wav(path, 16000, sig)
    fs, back = read_wav(path)
    jfs, jback = jax_audio_io.read_wav(path)
    assert fs == jfs == 16000 and np.array_equal(back, jback)
    np.testing.assert_array_equal(back, sig)
    # float32 means of squares summed in different orders: ~1e-5 dB apart
    np.testing.assert_allclose(float(calculate_snr(sig, noisy)),
                               float(jax_snr(sig, noisy)), atol=1e-3)
