"""The rest of the model zoo held against the JAX package on the CPU: the
classic SIREN, the leaky-ReLU MLP (slope 0.01, and 1.0: the reference's
deep-linear bug), SirenWithSnakeTanh with the scaled-sine first layer, the
layers and ``sine_activation``, applied with the JAX package's parameters
(carried across as numpy arrays); the inits by their distribution bounds;
the activation dictionaries; ``build_model`` for every arch; and the
routes the port refuses (a fused scaled-first mlp, fused or RFF siren /
relu).

Tolerance: both packages evaluate the same float32 expressions; XLA's dot
and torch.matmul sum the hidden products in other orders (~1e-7 relative),
which the sine layers multiply by omega (30 here): APPLY_ATOL on outputs
of magnitude ~1.  A pre-activation dictionary entry is held relative to
its own largest value (ACT_RTOL)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inraudio_tpu import models as jmodels
from inraudio_tpu_torch import models as tmodels
from inraudio_tpu_torch.models import params_from_jax
from inraudio_tpu_torch.train import loop as tloop
from inraudio_tpu_torch.tree import tree_leaves

torch.set_num_threads(1)

APPLY_ATOL = 2e-5
ACT_RTOL = 2e-6


def _coords(n=256, d=1, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, d)).astype(
        np.float32)


def _jax_params(model, seed=0):
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed)))


def _close(out, ref, atol=APPLY_ATOL):
    np.testing.assert_allclose(np.asarray(out.detach(), np.float32),
                               np.asarray(ref, np.float32), rtol=0,
                               atol=atol)


CASES = {
    "siren": ("siren", dict(hidden_features=32, hidden_layers=2)),
    "siren_sine_head": ("siren", dict(hidden_features=32, hidden_layers=1,
                                      outermost_linear=False,
                                      first_omega_0=60.0)),
    "relu": ("relu", dict(hidden_features=32, hidden_layers=2)),
    "relu_deep_linear": ("relu", dict(hidden_features=32, hidden_layers=2,
                                      negative_slope=1.0)),
    "mlp_scaled_first": ("mlp", dict(hidden_features=32, num_sine=1,
                                     num_snake=1, scaled_first=True,
                                     first_omega_0=3000.0)),
    "mlp_scaled_first_tanh": ("mlp", dict(hidden_features=32, num_sine=1,
                                          num_snake=1, num_tanh=1,
                                          scaled_first=True,
                                          last_linear=False)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_apply_matches_jax(case):
    arch, kw = CASES[case]
    jm = jmodels.build_model(arch, **kw)
    tm = tmodels.build_model(arch, **kw)
    assert tm.name == jm.name
    jp = _jax_params(jm)
    x = _coords()
    ref = jm.apply(jp, jnp.asarray(x))
    out = tm.apply(params_from_jax(jp), torch.from_numpy(x))
    assert out.shape == ref.shape
    _close(out, ref)


def test_deep_linear_relu_is_linear():
    """Slope 1.0: the network is affine in its input (the reference's
    bug): f(a x + (1 - a) y) = a f(x) + (1 - a) f(y)."""
    tm = tmodels.build_model("relu", hidden_features=16, negative_slope=1.0)
    p = tm.init(torch.Generator().manual_seed(1))
    x, y = torch.from_numpy(_coords(8)), torch.from_numpy(_coords(8, seed=1))
    lhs = tm.apply(p, 0.3 * x + 0.7 * y)
    torch.testing.assert_close(lhs, 0.3 * tm.apply(p, x)
                               + 0.7 * tm.apply(p, y), rtol=0, atol=1e-6)


def test_layers_and_sine_activation_match_jax():
    x = _coords(64, 3)
    jl = jax.tree.map(np.asarray, jmodels.sine_layer_init(
        jax.random.PRNGKey(2), 3, 16, omega0=30.0))
    _close(tmodels.sine_layer_apply(params_from_jax(jl), torch.from_numpy(x),
                                    30.0),
           jmodels.sine_layer_apply(jl, jnp.asarray(x), 30.0))
    js = jax.tree.map(np.asarray, jmodels.scaled_sine_layer_init(
        jax.random.PRNGKey(3), 3, 16, is_first=True, omega0=500.0))
    ts = tmodels.scaled_sine_layer_init(torch.Generator().manual_seed(3), 3,
                                        16, is_first=True, omega0=500.0)
    np.testing.assert_array_equal(ts["omega_scale"].numpy(),
                                  js["omega_scale"])
    _close(tmodels.scaled_sine_layer_apply(params_from_jax(js),
                                           torch.from_numpy(x)),
           jmodels.scaled_sine_layer_apply(js, jnp.asarray(x)))
    v = np.linspace(-3, 3, 101, dtype=np.float32)
    np.testing.assert_allclose(
        tmodels.sine_activation(torch.from_numpy(v), 7.0).numpy(),
        np.asarray(jmodels.sine_activation(jnp.asarray(v), 7.0)), atol=1e-6)


def _bounds_hold(t: torch.Tensor, bound: float) -> bool:
    """Every value inside [-bound, bound], and, over 64 draws or more, the
    draws fill it (the largest |value| past 0.9 bound)."""
    a = float(t.abs().max())
    return a <= bound and (a >= 0.9 * bound or t.numel() < 64)


@pytest.mark.parametrize("windows", [None, 3])
def test_inits_follow_their_bounds(windows):
    g = torch.Generator().manual_seed(4)
    h = 64
    sp = tmodels.siren_init(g, tmodels.SirenConfig(hidden_features=h,
                                                   hidden_layers=2,
                                                   first_omega_0=40.0),
                            windows=windows)
    lay = sp["layers"]
    assert len(lay) == 4
    assert _bounds_hold(lay[0]["w"], 1.0) and _bounds_hold(lay[0]["b"], 1.0)
    for p in lay[1:]:
        assert _bounds_hold(p["w"], math.sqrt(6.0 / h) / 30.0)
        assert _bounds_hold(p["b"], 1.0 / math.sqrt(h))
    lead = () if windows is None else (windows,)
    assert lay[1]["w"].shape == (*lead, h, h)
    assert lay[-1]["w"].shape == (*lead, h, 1)
    rp = tmodels.relu_mlp_init(g, tmodels.ReluMLPConfig(hidden_features=h,
                                                        hidden_layers=1),
                               windows=windows)
    assert [p["w"].shape[-2:] for p in rp["layers"]] == [(1, h), (h, h),
                                                         (h, 1)]
    for p in rp["layers"]:
        fan_in = p["w"].shape[-2]
        assert _bounds_hold(p["w"], 1.0 / math.sqrt(fan_in))
    cfg = tmodels.SirenSnakeTanhConfig(hidden_features=h, scaled_first=True,
                                       first_omega_0=2000.0)
    mp = tmodels.siren_snake_tanh_init(g, cfg, windows=windows)
    first = mp["layers"][0]
    assert _bounds_hold(first["w"], 1.0)
    scale = np.linspace(0, 1, h, dtype=np.float32) / h * np.float32(2000.0)
    np.testing.assert_array_equal(first["omega_scale"].numpy(),
                                  np.broadcast_to(scale, (*lead, h)))
    assert cfg.layer_kinds[0] == "scaled_sine_first"


def test_scaled_first_params_cross_from_jax_and_get_no_gradient():
    """The JAX package's scaled-first params carry omega_scale; the port
    applies them, and autograd gives omega_scale a zero gradient (it is a
    constant, as under jax.lax.stop_gradient), so a fit leaves it alone."""
    kw = dict(hidden_features=16, num_sine=1, num_snake=1, scaled_first=True)
    jm, tm = jmodels.build_model("mlp", **kw), tmodels.build_model("mlp", **kw)
    jp = _jax_params(jm, seed=5)
    assert sorted(jp["layers"][0]) == ["b", "omega_scale", "w"]
    tp = params_from_jax(jp)
    leaves = [v.requires_grad_(True) for p in tp["layers"]
              for v in p.values()]
    out = tm.apply(tp, torch.from_numpy(_coords(50)))
    grads = torch.autograd.grad(out.square().mean(), leaves,
                                allow_unused=True)
    names = [k for p in tp["layers"] for k in p]
    for name, g in zip(names, grads):
        assert (g is None or not g.any()) == (name == "omega_scale"), name
    x = _coords(200)
    y = np.sin(3 * x).astype(np.float32)
    res = tloop.fit(tm, x, y, tloop.TrainConfig(total_steps=5, scan_chunk=5),
                    device="cpu", state=tloop.init_train_state(
                        tm, torch.Generator().manual_seed(0),
                        tloop.TrainConfig(), "cpu")._replace(
                        params=params_from_jax(jp),
                        best_params=params_from_jax(jp)))
    np.testing.assert_array_equal(
        res.final_params["layers"][0]["omega_scale"].numpy(),
        jp["layers"][0]["omega_scale"])
    assert np.isfinite(res.loss_history).all()


@pytest.mark.parametrize("arch,kw", [
    ("siren", dict(hidden_features=16, hidden_layers=1)),
    ("mlp", dict(hidden_features=16, num_sine=1, num_snake=1, num_tanh=1,
                 scaled_first=True)),
    ("mlp", dict(hidden_features=16, num_sine=1, num_snake=1,
                 first_linear=True))])
def test_activations_match_jax(arch, kw):
    jm = jmodels.build_model(arch, **kw)
    tm = tmodels.build_model(arch, **kw)
    jp = _jax_params(jm, seed=6)
    x = _coords(64)
    if arch == "siren":
        ja = jmodels.siren_activations(jp, jm.config, jnp.asarray(x))
        ta = tmodels.siren_activations(params_from_jax(jp), tm.config,
                                       torch.from_numpy(x))
    else:
        ja = jmodels.siren_snake_tanh_activations(jp, jm.config,
                                                  jnp.asarray(x))
        ta = tmodels.siren_snake_tanh_activations(params_from_jax(jp),
                                                  tm.config,
                                                  torch.from_numpy(x))
    assert list(ta) == list(ja)
    for key, ref in ja.items():
        ref = np.asarray(ref, np.float32)
        scale = max(1.0, float(np.abs(ref).max()))
        atol = ACT_RTOL * scale if key.endswith("_pre") else APPLY_ATOL
        _close(ta[key], ref, atol=max(atol, APPLY_ATOL * (key != "input")))


@pytest.mark.parametrize("arch", ["mlp", "siren", "kan", "relu"])
def test_build_model_every_arch(arch):
    """Each arch at its config's defaults: the JAX package's name and
    config, params whose leaves line up with the JAX init's, an apply of
    (n, 1) on the CPU."""
    jm, tm = jmodels.build_model(arch), tmodels.build_model(arch)
    assert tm.name == jm.name
    assert type(tm.config).__name__ == type(jm.config).__name__
    for field in type(jm.config).__dataclass_fields__:
        assert getattr(tm.config, field) == getattr(jm.config, field), field
    tp = tm.init(torch.Generator().manual_seed(0))
    jp = jm.init(jax.random.PRNGKey(0))
    assert [tuple(t.shape) for t in tree_leaves(tp)] == \
        [tuple(np.shape(a)) for a in jax.tree.leaves(jp)]
    assert tm.apply(tp, torch.zeros(7, 1)).shape == (7, 1)


def test_refused_routes():
    """A fused scaled-first mlp raises (the JAX package unfuses it); the
    classic SIREN and the ReLU MLP have no kernels and own no encoding."""
    cfg = tmodels.SirenSnakeTanhConfig(hidden_features=32, scaled_first=True)
    with pytest.raises(NotImplementedError, match="scaled-sine"):
        tmodels.build_model("mlp", cfg, fused=True)
    assert tmodels.build_model("mlp", cfg).fused_step_ctx is None
    for arch in ("siren", "relu"):
        with pytest.raises(ValueError, match="no kernels"):
            tmodels.build_model(arch, fused=True)
        with pytest.raises(ValueError, match="no kernels"):
            tmodels.build_model(arch, rff_b=torch.zeros(2, 1))
    with pytest.raises(ValueError, match="unknown arch"):
        tmodels.build_model("resnet")


def test_scaled_first_leaves_payload_headers_alone(tmp_path):
    """The new config field reaches no payload header: a port encode's
    model header holds the fields it held before (no scaled_first), and
    the JAX package loads and decodes it."""
    from inraudio_tpu import codec as jcodec
    from inraudio_tpu_torch import codec as tcodec
    fs = 8000
    sig = (0.5 * np.sin(2 * np.pi * 220 * np.arange(4000) / fs)).astype(
        np.float32)
    cfg = tcodec.CodecConfig(chunk_seconds=0.25, hidden_features=16,
                             total_steps=3, quantize=None)
    payload = tcodec.encode(sig, fs, cfg, device="cpu")
    assert set(payload["meta"]["model"]) == {
        "hidden_features", "num_sine", "num_snake", "first_omega_0",
        "hidden_omega_0"}
    path = tcodec.save_inr(str(tmp_path / "x.inra"), payload)
    _, ours = tcodec.decode(tcodec.load_inr(path), "cpu")
    _, theirs = jcodec.decode(jcodec.load_inr(path))
    np.testing.assert_allclose(ours, theirs, atol=1e-5)
