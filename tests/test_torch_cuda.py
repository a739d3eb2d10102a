"""Card-only checks of the CUDA stack kernel (csrc/siren_stack.cu) against
its plain PyTorch version on the same card.

Every test here needs an NVIDIA card and skips without one.  This file
imports no JAX, so the card's machine runs it without the tests' conftest:
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_cuda.py`` (``python3 chip_smoke.py`` does)."""

import numpy as np
import pytest
import torch

from inraudio_tpu_torch import codec
from inraudio_tpu_torch.models import SirenSnakeTanhConfig, build_model
from inraudio_tpu_torch.ops import siren_fused as sf

pytestmark = pytest.mark.cuda

TIERS = [kw for _, _, kw in sf._DECODE_TIERS] + [dict(approx_sin=False)]
TIER_IDS = ["bf16-deg7", "mixed-bf16x2-deg7", "deg9", "deg11", "exact"]

# kernel vs plain on one card, both float32: the kernel sums each dot
# product in its own order (sequential fmaf over the hidden axis), the
# plain version through cuBLAS; ~1e-7 relative per pre-activation,
# amplified x30 through the sine layers.
F32_ATOL = 2e-5
# bf16-class tiers: a pre-activation within an f32 ulp of a bf16 rounding
# boundary may round the other way (see tests/test_torch_ops.py); bound the
# max loosely and the bulk tightly.
BF16_MAX_ATOL = 1e-3
BF16_BULK_ATOL, BF16_BULK_SHARE = 5e-6, 0.95


def is_bf16_tier(kw) -> bool:
    return sf._is_bf16(kw.get("compute_dtype")) or bool(
        kw.get("mixed_matmul"))


def check_close(out: torch.Tensor, ref: torch.Tensor, kw) -> float:
    """Assert the tier's tolerance; returns the max abs difference."""
    assert out.shape == ref.shape
    assert torch.isfinite(out).all()
    err = (out - ref).abs()
    worst = float(err.max())
    if is_bf16_tier(kw):
        assert worst <= BF16_MAX_ATOL, (kw, worst)
        share = float((err <= BF16_BULK_ATOL).float().mean())
        assert share >= BF16_BULK_SHARE, (kw, share)
    else:
        assert worst <= F32_ATOL, (kw, worst)
    return worst


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA is not available")
    return torch.device("cuda")


def _population(cfg, k, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    return build_model("mlp", cfg).init(g, dev, windows=k)


@pytest.mark.parametrize("kw", TIERS, ids=TIER_IDS)
@pytest.mark.parametrize("h", [32, 64, 128])
def test_kernel_matches_plain(dev, h, kw):
    cfg = SirenSnakeTanhConfig(hidden_features=h, first_omega_0=1800.0)
    params = _population(cfg, 3, dev)
    coords = torch.linspace(-1, 1, 300, device=dev)[:, None]  # ragged tile
    out = sf.fused_siren_apply_stacked(params, cfg, coords, **kw)
    ref = sf.stack_forward_plain(params, sf.stack_plan(cfg, **kw), coords)
    check_close(out, ref, kw)


@pytest.mark.parametrize("cfg_kw,kw", [
    (dict(num_tanh=1), dict(approx_sin=True, f32_mode="highest")),
    (dict(first_linear=True), dict(approx_sin=True, sin_poly_degree=9)),
    (dict(last_linear=False, num_snake=1), dict(approx_sin=False)),
    (dict(in_features=2), dict(approx_sin=True, exact_first_sin=True)),
    (dict(num_sine=0, num_snake=0), dict(approx_sin=True, f32_mode="bf16")),
], ids=["tanh-highest", "first-linear", "sine-head", "2d-coords",
        "no-hidden"])
def test_kernel_recipe_variants(dev, cfg_kw, kw):
    cfg = SirenSnakeTanhConfig(hidden_features=64, first_omega_0=300.0,
                               **cfg_kw)
    params = _population(cfg, 2, dev, seed=1)
    coords = torch.rand(257, cfg.in_features, device=dev) * 2 - 1
    out = sf.fused_siren_apply_stacked(params, cfg, coords, **kw)
    ref = sf.stack_forward_plain(params, sf.stack_plan(cfg, **kw), coords)
    check_close(out, ref, kw)


def test_single_model_is_the_k1_call(dev):
    cfg = SirenSnakeTanhConfig(hidden_features=128, first_omega_0=115.0)
    params = _population(cfg, 4, dev)
    coords = torch.linspace(-1, 1, 1000, device=dev)[:, None]
    many = sf.fused_siren_apply_stacked(params, cfg, coords, approx_sin=True)
    for i in (0, 3):
        one = sf.fused_siren_apply(
            {"layers": [{k: v[i] for k, v in p.items()}
                        for p in params["layers"]]}, cfg, coords,
            approx_sin=True)
        # the same kernel on the same window: bit-identical
        assert torch.equal(one, many[i])


def test_counts_launches_and_validates(dev):
    cfg = SirenSnakeTanhConfig(hidden_features=32, first_omega_0=115.0)
    params = _population(cfg, 2, dev)
    coords = torch.linspace(-1, 1, 64, device=dev)[:, None]
    before = sf.SIREN_STACK.launches
    sf.fused_siren_apply_stacked(params, cfg, coords)
    sf.fused_siren_apply_stacked(params, cfg, coords)
    assert sf.SIREN_STACK.launches == before + 2
    with pytest.raises(ValueError, match="coords on"):
        sf.fused_siren_apply_stacked(params, cfg, coords.cpu())
    wide = SirenSnakeTanhConfig(hidden_features=256)
    with pytest.raises(ValueError, match="hidden width"):
        sf.fused_siren_apply_stacked(_population(wide, 1, dev), wide, coords)
    assert sf.SIREN_STACK.launches == before + 2


def test_decode_range_equals_full_decode_slice(dev):
    cfg = SirenSnakeTanhConfig(hidden_features=64, first_omega_0=1800.0)
    k, n, hop, length, fs = 9, 400, 360, 3200, 8000
    params = _population(cfg, k, "cpu", seed=2)
    meta = {"format": codec._FORMAT, "sample_rate": fs,
            "signal_length": length, "chunk_length": n, "hop": hop,
            "num_chunks": k, "num_channels": 1, "quantize": "float16",
            "per_row_scales": False, "side_quantized": True,
            "trained_forward": "fused_approx", "fit_snr_db": 60.0,
            "model": {"hidden_features": 64, "num_sine": 2, "num_snake": 2,
                      "first_omega_0": 1800.0, "hidden_omega_0": 30.0}}
    payload = {"meta": meta,
               "scales": np.linspace(0.3, 0.9, k).astype(np.float32),
               "params": codec.quantize_inr_params(params, "float16")}
    before = sf.SIREN_STACK.launches
    _, full = codec.decode(payload, dev)
    assert sf.SIREN_STACK.launches > before  # auto-routed to the kernel
    for a, b in ((0.0, 0.05), (0.123, 0.2), (0.39, 0.4)):
        _, part = codec.decode_range(payload, a, b, dev)
        assert np.array_equal(part, full[round(a * fs):round(b * fs)])
    # the plain version on the CPU serves the same request within the
    # tier's f32 tolerance
    _, cpu = codec.decode_range(payload, 0.123, 0.2, "cpu", fused=True)
    np.testing.assert_allclose(cpu, full[984:1600], atol=F32_ATOL, rtol=0)
