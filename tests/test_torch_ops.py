"""The port's stack-forward module (inraudio_tpu_torch/ops/siren_fused.py)
held against the JAX package's Pallas kernels, run in interpret mode on the
CPU.  On the CPU the port's wrappers run the kernel's plain PyTorch version;
the CUDA kernel itself is checked on the card (test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inraudio_tpu.models import SirenSnakeTanhConfig as JaxConfig
from inraudio_tpu.models import build_model as jax_build_model
from inraudio_tpu.ops import pallas_siren as jps
from inraudio_tpu_torch.models import SirenSnakeTanhConfig, params_from_jax
from inraudio_tpu_torch.ops import siren_fused as sf

torch.set_num_threads(1)

CFG = dict(hidden_features=32, first_omega_0=115.0)
TIERS = [kw for _, _, kw in jps._DECODE_TIERS] + [dict(approx_sin=False)]
TIER_IDS = ["bf16-deg7", "mixed-bf16x2-deg7", "deg9", "deg11", "exact"]

# f32-class tiers: both packages evaluate the same f32 expressions; only the
# matmul summation order differs (XLA's dot vs torch.matmul), ~1e-7 here.
F32_ATOL = 1e-5
# bf16-class tiers: an activation within one f32 ulp of a bf16 rounding
# boundary can round to a different bf16 value when the two packages sum in
# a different order; one such flip moves an h=32 output by up to ~1.2e-4
# (measured: 14 of 800 outputs beyond 1e-5).  So the max is bounded loosely
# and the bulk tightly: a systematic slip would move every output.
BF16_MAX_ATOL = 3e-4
BF16_BULK_ATOL, BF16_BULK_SHARE = 2e-6, 0.95


def _is_bf16_tier(kw):
    return kw.get("compute_dtype") == "bfloat16" or kw.get("mixed_matmul")


def _jax_kw(kw):
    kw = dict(kw)
    if kw.get("compute_dtype") == "bfloat16":
        kw["compute_dtype"] = jnp.bfloat16
    return kw


def _assert_tier_close(out, ref, kw):
    err = np.abs(np.asarray(out, np.float32) - np.asarray(ref, np.float32))
    if _is_bf16_tier(kw):
        assert err.max() <= BF16_MAX_ATOL, err.max()
        assert np.mean(err <= BF16_BULK_ATOL) >= BF16_BULK_SHARE, \
            np.mean(err <= BF16_BULK_ATOL)
    else:
        assert err.max() <= F32_ATOL, err.max()


@pytest.fixture(scope="module")
def population():
    """4 windows of the h=32 production recipe, JAX init, both layouts."""
    jcfg = JaxConfig(**CFG)
    params = jax.vmap(jax_build_model("mlp", jcfg).init)(
        jax.random.split(jax.random.PRNGKey(3), 4))
    host = jax.tree.map(np.asarray, params)
    return jcfg, params, params_from_jax(host)


@pytest.mark.parametrize("degree", [7, 9, 11])
def test_fast_sin_cos_match_jax(degree):
    # first-layer arguments reach omega0 * |coord| ~ 2e4; same f32 ops in the
    # same order on both sides, so 1e-6 is far above the expected ~0
    x = np.random.default_rng(degree).uniform(-2.5e4, 2.5e4,
                                              20000).astype(np.float32)
    x[:4] = [0.0, np.pi, -np.pi / 2, 2.5e4]
    t = torch.from_numpy(x)
    np.testing.assert_allclose(sf._fast_sin(t, degree).numpy(),
                               np.asarray(jps._fast_sin(jnp.asarray(x), degree)),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(sf._fast_cos(t, degree).numpy(),
                               np.asarray(jps._fast_cos(jnp.asarray(x), degree)),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("kw", TIERS, ids=TIER_IDS)
def test_stacked_forward_matches_jax_kernel(population, kw):
    jcfg, jparams, tparams = population
    coords = np.linspace(-1, 1, 200, dtype=np.float32)[:, None]
    ref = jps.fused_siren_apply_stacked(jparams, jcfg, jnp.asarray(coords),
                                        chunks_per_step=4, interpret=True,
                                        **_jax_kw(kw))
    out = sf.fused_siren_apply_stacked(tparams, SirenSnakeTanhConfig(**CFG),
                                       torch.from_numpy(coords), **kw)
    assert out.shape == (4, 200, 1) and out.dtype == torch.float32
    _assert_tier_close(out.numpy(), ref, kw)


@pytest.mark.parametrize("kw", [dict(approx_sin=True, sin_poly_degree=11),
                                dict(approx_sin=True, sin_poly_degree=7,
                                     compute_dtype="bfloat16")],
                         ids=["deg11", "bf16-deg7"])
def test_single_model_matches_jax_kernel(population, kw):
    # n=300 with 128-row blocks: three tiles, the last one ragged
    jcfg, jparams, tparams = population
    p0 = jax.tree.map(lambda x: x[1], jparams)
    t0 = {"layers": [{k: v[1] for k, v in p.items()}
                     for p in tparams["layers"]]}
    coords = np.linspace(-1, 1, 300, dtype=np.float32)[:, None]
    ref = jps.fused_siren_apply(p0, jcfg, jnp.asarray(coords), block_rows=128,
                                interpret=True, **_jax_kw(kw))
    out = sf.fused_siren_apply(t0, SirenSnakeTanhConfig(**CFG),
                               torch.from_numpy(coords), **kw)
    assert out.shape == (300, 1)
    _assert_tier_close(out.numpy(), ref, kw)


@pytest.mark.parametrize("fit", [0.0, 25.0, 30.0, 45.0, 80.0, 120.0, 140.0])
@pytest.mark.parametrize("omega", [115.0, 1800.0, 22000.0])
def test_auto_decode_kwargs_matches_jax(fit, omega, monkeypatch):
    # the JAX package's gate over the port's table: the tiers' kwargs are
    # the JAX package's, and so is every floor but the one measured lower
    # on the card (test_decode_tier_floors_differ_only_where_measured)
    monkeypatch.setattr(jps, "_DECODE_TIERS", tuple(
        (floor, high, jkw) for (floor, high, _), (_, _, jkw)
        in zip(sf._DECODE_TIERS, jps._DECODE_TIERS)))
    j = jps.auto_decode_kwargs(fit, first_omega_0=omega)
    t = sf.auto_decode_kwargs(fit, first_omega_0=omega)
    norm = {k: ("bfloat16" if v in (jnp.bfloat16, torch.bfloat16) else v)
            for k, v in j.items()}
    assert {k: ("bfloat16" if v == torch.bfloat16 else v)
            for k, v in t.items()} == norm


def test_decode_tier_floors_differ_only_where_measured():
    """The port's routing table is the JAX package's (measured on a TPU)
    except deg 11's moderate floor, lowered to the reading on an H100
    (chip_smoke.py phase 19: 110.51 dB against the exact apply)."""
    assert len(sf._DECODE_TIERS) == len(jps._DECODE_TIERS)
    for i, ((f, hf, kw), (jf, jhf, jkw)) in enumerate(zip(
            sf._DECODE_TIERS, jps._DECODE_TIERS)):
        assert kw == jkw and hf == jhf
        assert f == (110.51 if i == 3 else jf) and f <= jf
    assert sf._HIGH_PHASE_OMEGA == jps._HIGH_PHASE_OMEGA


def test_stack_plan_modes_follow_run_layers():
    cfg = SirenSnakeTanhConfig(hidden_features=32, num_tanh=1)
    plan = sf.stack_plan(cfg, approx_sin=True, sin_poly_degree=9,
                         mixed_matmul=True, f32_mode="bf16x2",
                         exact_first_sin=True)
    assert plan.kinds == ("sine_first", "sine", "sine", "linear_snake",
                          "linear_snake", "linear_tanh", "linear_last")
    assert plan.modes == (None, "bf16x2", "bf16x2", "bf16", "bf16", "bf16",
                          "bf16")
    assert plan.degrees == (0, 9, 9, 9, 9, 9, 9)
    assert sf.stack_plan(cfg, compute_dtype=torch.bfloat16).modes[1:] == \
        ("bf16",) * 6
    # default f32 tier is bf16x3, as INRAUDIO_F32_PRECISION's default
    assert sf.stack_plan(cfg).modes[1] == "bf16x3"
    assert sf.stack_plan(cfg, f32_mode="highest").modes[1] == "highest"


def test_kernel_route_raises_off_the_cpu(population):
    # a non-CPU tensor never falls back to the plain version: a device the
    # kernel does not serve raises, and the kernel itself cannot be built or
    # launched on a host without nvcc and a card
    _, _, tparams = population
    cfg = SirenSnakeTanhConfig(**CFG)
    meta = {"layers": [{k: v.to("meta") for k, v in p.items()}
                       for p in tparams["layers"]]}
    with pytest.raises(ValueError, match="no fused stack"):
        sf.fused_siren_apply_stacked(meta, cfg,
                                     torch.zeros(8, 1, device="meta"))
    # CPU coords do not pull parameters that lie elsewhere onto the plain path
    with pytest.raises(ValueError, match="coords on cpu"):
        sf.fused_siren_apply_stacked(meta, cfg, torch.zeros(8, 1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            sf.SIREN_STACK(tparams, sf.stack_plan(cfg),
                           torch.zeros(8, 1))


def test_kernel_wrapper_validates_shapes(population):
    _, _, tparams = population
    cfg = SirenSnakeTanhConfig(**CFG)
    bad = {"layers": [dict(p) for p in tparams["layers"]]}
    bad["layers"][2] = {**bad["layers"][2],
                        "w": bad["layers"][2]["w"].transpose(1, 2)}
    with pytest.raises(ValueError, match="contiguous"):
        sf.SIREN_STACK(bad, sf.stack_plan(cfg), torch.zeros(8, 1))
    half = {"layers": [{k: v.half() for k, v in p.items()}
                       for p in tparams["layers"]]}
    with pytest.raises(ValueError, match="float32"):
        sf.SIREN_STACK(half, sf.stack_plan(cfg), torch.zeros(8, 1))
    with pytest.raises(ValueError, match="raw input"):
        sf.SIREN_STACK(tparams, sf.stack_plan(cfg), torch.zeros(8, 9))
