"""Card-only checks of the CUDA kernels (csrc/siren_stack.cu, the backward,
whole-step and row-shard kernels of csrc/siren_train.cu, each at widths 32
to 256 and with an RFF layer 0, the whole-step and row-shard kernels with
the per-row loss weight and on the precision schedule's cheap tier, and
the KAN forward and backward kernels of
csrc/kan.cu) against their plain PyTorch versions on the same card, a step
of the row-sharded fit on two ranks sharing the card, the decode serving
paths (``decode_many``, ``decode_stream``) against ``decode``, and the
modulated codec's decode and fit against the CPU's.  It also holds
``run_thread_ranks``, the thread ranks that tests/test_torch_shard.py and
chip_smoke.py run the sharded fits on.

Every test here needs an NVIDIA card and skips without one.  This file
imports no JAX, so the card's machine runs it without the tests' conftest:
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_cuda.py`` (``python3 chip_smoke.py`` does)."""

import ctypes
import datetime
import hashlib
import threading
from typing import Any, Callable

import numpy as np
import pytest
import torch
import torch.distributed as dist

from inraudio_tpu_torch import codec
from inraudio_tpu_torch.models import (KANConfig, SirenSnakeTanhConfig,
                                       build_model, rff_init)
from inraudio_tpu_torch.ops import kan_fused as kf
from inraudio_tpu_torch.ops import siren_fused as sf
from inraudio_tpu_torch.ops import siren_step as ss
from inraudio_tpu_torch.ops import siren_train as st
from inraudio_tpu_torch.parallel import Mesh, make_mesh
from inraudio_tpu_torch.train import loop as tloop
from inraudio_tpu_torch.tree import tree_leaves
from inraudio_tpu_torch.utils.observability import counter

pytestmark = pytest.mark.cuda


def run_thread_ranks(size: int, fn: Callable[[Mesh], Any],
                     device: torch.device | str = "cuda",
                     timeout_s: float = 300.0) -> list:
    """Run ``fn(mesh)`` on ``size`` ranks, one thread each in this process,
    every rank on ``device`` with its own gloo group over the loopback
    (ranks that share one card, or CPU ranks).  Returns the ranks' results
    in rank order; re-raises the first rank's exception.  A rank that
    fails leaves the others waiting in their next collective until
    ``timeout_s``, when gloo raises there."""
    store = dist.HashStore()
    results: list = [None] * size
    errors: list = [None] * size

    def rank_main(rank: int) -> None:
        try:
            opts = dist.ProcessGroupGloo._Options()
            opts._timeout = datetime.timedelta(seconds=timeout_s)
            opts._devices = [dist.ProcessGroupGloo.create_device(
                hostname="127.0.0.1")]
            pg = dist.ProcessGroupGloo(dist.PrefixStore("ranks", store), rank,
                                       size, opts)
            results[rank] = fn(make_mesh(device, group=pg))
        except BaseException as e:  # re-raised in the caller's thread
            errors[rank] = e

    threads = [threading.Thread(target=rank_main, args=(r,), daemon=True)
               for r in range(size)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for e in errors:
        if e is not None:
            raise e
    return results


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
@pytest.mark.parametrize("h", [32, 64, 128, 256, 36, 40, 48])
def test_kernel_matches_plain(dev, h, kw):
    # 36, 40 and 48 (the codec's rate points) run zero-padded to 64
    cfg = SirenSnakeTanhConfig(hidden_features=h, first_omega_0=1800.0)
    params = _population(cfg, 3, dev)
    coords = torch.linspace(-1, 1, 300, device=dev)[:, None]  # ragged tile
    plan = sf.stack_plan(cfg, **kw)
    # every tier here is bf16-class: the tensor-core route
    assert sf.stack_launch(plan, sf.kernel_width(h), 300).route == "tc"
    out = sf.fused_siren_apply_stacked(params, cfg, coords, **kw)
    ref = sf.stack_forward_plain(params, plan, coords)
    check_close(out, ref, kw)


def test_stack_forward_is_deterministic(dev):
    """Two calls from one input are bit-equal on both routes (no float
    atomics; every output is summed by one mma fragment or one thread in a
    fixed order), raw and RFF, at a multi-pass and a streamed width."""
    for h, kw in ((128, dict(approx_sin=True)), (256, dict(approx_sin=True)),
                  (64, dict(approx_sin=True, f32_mode="highest"))):
        cfg = SirenSnakeTanhConfig(hidden_features=h, first_omega_0=300.0)
        params = _population(cfg, 3, dev)
        coords = torch.linspace(-1, 1, 700, device=dev)[:, None]
        a = sf.fused_siren_apply_stacked(params, cfg, coords, **kw)
        b = sf.fused_siren_apply_stacked(params, cfg, coords, **kw)
        torch.cuda.synchronize()
        assert torch.equal(a, b), (h, kw)
    cfg, params, b, _ = _rff_model(256, 64, dev)
    coords = torch.rand(900, 1, device=dev) * 2 - 1
    one = sf.fused_siren_apply(params, cfg, coords, rff_b=b, approx_sin=True)
    two = sf.fused_siren_apply(params, cfg, coords, rff_b=b, approx_sin=True)
    torch.cuda.synchronize()
    assert torch.equal(one, two)


@pytest.mark.parametrize("h", [32, 64, 128, 256])
def test_stack_highest_keeps_the_fma_route(dev, h):
    """A plan with a `highest` layer runs the FMA kernel (exact f32
    products, which no bf16 tensor-core pass gives); the tensor-core entry
    refuses it."""
    cfg = SirenSnakeTanhConfig(hidden_features=h, first_omega_0=300.0)
    params = _population(cfg, 2, dev)
    coords = torch.linspace(-1, 1, 300, device=dev)[:, None]
    kw = dict(approx_sin=True, f32_mode="highest")
    plan = sf.stack_plan(cfg, **kw)
    assert sf.stack_launch(plan, h, 300).route == "fma"
    out = sf.fused_siren_apply_stacked(params, cfg, coords, **kw)
    check_close(out, sf.stack_forward_plain(params, plan, coords), kw)
    # the mixed tier with highest sine layers keeps it too
    mixed = sf.stack_plan(cfg, mixed_matmul=True, f32_mode="highest")
    assert sf.stack_launch(mixed, h, 300).route == "fma"
    lib = sf.SIREN_STACK.library()
    layers = params["layers"]
    ptrs = (ctypes.c_uint64 * (3 * len(layers)))(*[
        v for p in layers for v in (p["w"].data_ptr(), p["b"].data_ptr(),
                                    p["snake_a"].data_ptr()
                                    if "snake_a" in p else 0)])
    ints = (ctypes.c_int32 * (3 * len(layers)))(*[
        v for li, kind in enumerate(plan.kinds)
        for v in (sf._KIND_CODE[kind], sf._MODE_CODE[plan.modes[li] or
                                                    "highest"],
                  plan.degrees[li])])
    omegas = (ctypes.c_float * len(layers))(*plan.omegas)
    out2 = torch.empty((2, 300), device=dev)
    planes = torch.empty(sf.tc_plane_elems(plan, h, 2, 0),
                         dtype=torch.bfloat16, device=dev)
    rc = lib.siren_stack_forward_tc(
        coords.data_ptr(), out2.data_ptr(), ctypes.addressof(ptrs),
        ctypes.addressof(ints), ctypes.addressof(omegas), len(layers), 2,
        300, 1, h, None, 0, 0, None, planes.data_ptr(), planes.numel(),
        sf._TC_PASS_ROWS[h], torch.cuda.current_stream().cuda_stream)
    assert rc != 0


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
    # widths up to 256 run (padded between the kernel widths); wider raises
    wide = SirenSnakeTanhConfig(hidden_features=320)
    with pytest.raises(ValueError, match="hidden width"):
        sf.fused_siren_apply_stacked(_population(wide, 1, dev), wide, coords)
    assert sf.SIREN_STACK.launches == before + 2


def _rff_model(h, f, dev, d=1, omega=300.0, seed=0, sigma=10.0):
    """(cfg, params (one model), B (f, d), 2 pi B^T) of an RFF mlp."""
    cfg = SirenSnakeTanhConfig(in_features=2 * f, hidden_features=h,
                               first_omega_0=omega)
    params = build_model("mlp", cfg).init(torch.Generator().manual_seed(seed),
                                          dev)
    b = rff_init(torch.Generator().manual_seed(seed + 1), d, f, sigma=sigma,
                 device=dev)
    return cfg, params, b, sf._prep_rff_bt(b)


def stacked(params):
    """One model's params as a population of one window."""
    return {"layers": [{k: v.unsqueeze(0).contiguous() for k, v in p.items()}
                       for p in params["layers"]]}


# An RFF layer 0 sums a 2F-deep tiered product: kernel and plain version
# sum it in different orders.  Its pre-activation is held to a few ulps of
# its largest value; the features themselves are computed op by op alike.
# The output carries that gap times omega0 through layer 0's sine, so it is
# held to RFF_CTRL_X times a control: the plain version with layer 0's W
# and b one ulp off (the bias survives a bf16 tier's rounding), or to the
# tier's tolerance, whichever is larger; no bulk rule in the bf16 tiers.
RFF_PRE_RTOL = 2e-6
RFF_CTRL_X = 10.0


def perturb_layer0(params):
    """``params`` with layer 0's W and b one ulp up (times 1 + 2^-23)."""
    layers = [dict(p) for p in params["layers"]]
    layers[0] = {k: (v * (1.0 + 2.0 ** -23) if k in ("w", "b") else v)
                 for k, v in layers[0].items()}
    return {"layers": layers}


@pytest.mark.parametrize("kw", TIERS, ids=TIER_IDS)
@pytest.mark.parametrize("h,f,d", [(32, 4, 1), (64, 37, 2), (256, 256, 1)])
def test_rff_kernel_matches_plain(dev, h, f, d, kw):
    cfg, params, b, bt = _rff_model(h, f, dev, d=d)
    coords = torch.rand(1000, d, device=dev) * 2 - 1  # ragged tile
    before = sf.SIREN_STACK.launches
    out = sf.fused_siren_apply(params, cfg, coords, rff_b=b, **kw)
    assert sf.SIREN_STACK.launches == before + 1
    plan = sf.stack_plan(cfg, rff=True, **kw)
    assert sf.stack_launch(plan, h, 1000).route == "tc"
    ref = sf.stack_forward_plain(params, plan, coords, bt)
    ctrl = sf.stack_forward_plain(perturb_layer0(params), plan, coords, bt)
    assert torch.isfinite(out).all()
    floor = BF16_MAX_ATOL if is_bf16_tier(kw) else F32_ATOL
    assert float((out - ref).abs().max()) <= max(
        RFF_CTRL_X * float((ctrl - ref).abs().max()), floor)
    pre0 = torch.empty(1, 1000, h, device=dev)
    sf.SIREN_STACK(stacked(params), plan, coords, bt, pre0=pre0)
    _, saved = st.fwd_pres_plain(params, plan, coords, bt)
    torch.cuda.synchronize()
    pre_ref = saved[0][1]
    assert float((pre0[0] - pre_ref).abs().max()) <= \
        RFF_PRE_RTOL * float(pre_ref.abs().max())


def test_rff_stacked_is_refused(dev):
    cfg, params, b, _ = _rff_model(32, 8, dev)
    with pytest.raises(ValueError, match="raw coordinates"):
        sf.fused_siren_apply_stacked(stacked(params), cfg,
                                     torch.zeros(10, 1, device=dev))
    model = build_model("mlp", cfg, fused=True, rff_b=b)
    assert model.apply_stacked is None and model.decode_apply_stacked is None
    with pytest.raises(ValueError, match="2\\*F"):
        sf.fused_siren_apply(params, cfg, torch.zeros(10, 1, device=dev),
                             rff_b=b[:4])


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


def _fused_payload(k, n=400, hop=360, h=64, omega=1800.0, seed=0,
                   fit=60.0):
    """A fused-trained per-window payload of k random windows."""
    cfg = SirenSnakeTanhConfig(hidden_features=h, first_omega_0=omega)
    meta = {"format": codec._FORMAT, "sample_rate": 8000,
            "signal_length": (k - 1) * hop + n - 17, "chunk_length": n,
            "hop": hop, "num_chunks": k, "num_channels": 1,
            "quantize": "float16", "per_row_scales": False,
            "side_quantized": True, "trained_forward": "fused_approx",
            "fit_snr_db": fit,
            "model": {"hidden_features": h, "num_sine": 2, "num_snake": 2,
                      "first_omega_0": omega, "hidden_omega_0": 30.0}}
    return {"meta": meta,
            "scales": np.linspace(0.3, 0.9, k).astype(np.float32),
            "params": codec.quantize_inr_params(
                _population(cfg, k, "cpu", seed=seed), "float16")}


def test_decode_many_and_stream_equal_decode(dev):
    """A window's kernel output does not depend on the window count of its
    call: decode_many (one stack-kernel call per group) and decode_stream
    give decode's samples bit for bit."""
    payloads = [_fused_payload(9), _fused_payload(4, seed=1),
                _fused_payload(6, n=300, hop=270, seed=2),
                _fused_payload(9, seed=3)]
    singles = [codec.decode(p, dev) for p in payloads]
    before = sf.SIREN_STACK.launches
    many = codec.decode_many(payloads, dev)
    assert sf.SIREN_STACK.launches - before == 2  # two groups
    for (fs, a), (fs1, b) in zip(many, singles):
        assert fs == fs1 and np.array_equal(a, b)
    for p, (_, full) in zip(payloads[:3], singles):
        blocks = [b for _, b in codec.decode_stream(p, dev, block_s=0.03)]
        assert np.array_equal(np.concatenate(blocks), full)


def test_fused_multi_inr_fit_decodes_through_the_stack_kernel(dev):
    """A fused fit's states are views into its flat buffers; the decode
    hands the stack kernel contiguous leaves."""
    from inraudio_tpu_torch.train import multi_inr as tmulti
    cfg = SirenSnakeTanhConfig(hidden_features=32, first_omega_0=115.0)
    model = build_model("mlp", cfg, fused=True, approx_sin=True)
    t = np.arange(3000) / 8000
    sig = (0.6 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    res = tmulti.multi_inr_fit(
        model, sig, 8000, tmulti.MultiINRConfig(chunk_seconds=0.05,
                                                overlap_fraction=0.1),
        tloop.TrainConfig(total_steps=3), device=dev)
    before = sf.SIREN_STACK.launches
    rec = tmulti.multi_inr_decode(model, res)
    part = tmulti.multi_inr_decode_range(model, res, 500, 900)
    assert sf.SIREN_STACK.launches - before == 2
    assert rec.shape == sig.shape and np.isfinite(rec).all()
    assert np.array_equal(part, rec[500:900])


def _modulated_payload(**kw):
    t = np.arange(2400) / 8000
    sig = (0.6 * np.sin(2 * np.pi * 220 * t)
           + 0.2 * np.sin(2 * np.pi * 700 * t)).astype(np.float32)
    return codec.encode_modulated(sig, 8000, codec.ModulatedCodecConfig(
        chunk_seconds=0.05, hidden_features=32, first_omega_0=100.0,
        total_steps=20, **kw), device="cpu")


@pytest.mark.parametrize("kw", [dict(quantize_mods="int8"),
                                dict(quantize_mods="int16", segment_s=0.1,
                                     film_scale=True, shared_fp16=False)],
                         ids=["int8", "segmented-film"])
def test_modulated_decode_on_the_card(dev, kw):
    """The modulated forward is PyTorch ops (no kernel, as in the JAX
    package): the card's decode agrees with the CPU's to the trained
    payloads' cross-implementation bound (tests/test_torch_decode.py), and
    a range equals the full decode's slice to cuBLAS's summation order."""
    p = _modulated_payload(**kw)
    _, cpu = codec.decode(p, "cpu")
    _, full = codec.decode(p, dev)
    np.testing.assert_allclose(full, cpu, atol=3e-5, rtol=0)
    for a, b in ((0.0, 0.04), (0.11, 0.2), (0.29, 0.3)):
        _, part = codec.decode_range(p, a, b, dev)
        np.testing.assert_allclose(part, full[round(a * 8000):round(b * 8000)],
                                   atol=1e-6, rtol=0)
    blocks = [b for _, b in codec.decode_stream(p, dev, block_s=0.07)]
    np.testing.assert_allclose(np.concatenate(blocks), full, atol=1e-6,
                               rtol=0)


def test_modulated_fit_on_the_card_matches_cpu(dev):
    from inraudio_tpu_torch.train.modulated import modulated_fit
    cfg = SirenSnakeTanhConfig(hidden_features=32, first_omega_0=100.0)
    coords = np.linspace(-1, 1, 300, dtype=np.float32)[:, None]
    t = (0.7 * np.sin(2 * np.pi * np.arange(1, 7)[:, None] * coords[:, 0])
         ).astype(np.float32)[..., None]
    tc = tloop.TrainConfig(total_steps=8, grad_clip_norm=1.0, scan_chunk=3)
    runs = [modulated_fit(cfg, t, coords, tc, mods_lr_mult=5.0, device=d,
                          generator=torch.Generator().manual_seed(1))
            for d in ("cpu", dev)]
    np.testing.assert_allclose(runs[1].loss_history, runs[0].loss_history,
                               rtol=1e-5)
    np.testing.assert_allclose(runs[1].mods.cpu().numpy(),
                               runs[0].mods.numpy(), rtol=3e-5, atol=3e-6)


# ---------------------------------------------------------------------------
# Training kernels: C (backward) and D (whole step)
# ---------------------------------------------------------------------------

# C against its plain version, relative to the largest gradient of the
# population.  f32-class grad tiers: only the summation order differs.  The
# bf16-class tiers round x_in and gpre, and an operand within an f32 ulp of
# a rounding boundary rounds the other way when the forward sums in another
# order (measured at h = 128: 9e-5 of the largest gradient); bound the max
# loosely and the bulk tightly.
GRAD_F32_RTOL = 2e-6
GRAD_BF16_MAX_RTOL, GRAD_BF16_BULK_RTOL, GRAD_BULK_SHARE = 1e-3, 1e-5, 0.99
# D against its plain version.  First the arithmetic: the first step's
# gradients (mu = 0.1 g after one step) meet C's criterion above.  Then the
# state after a few steps, in units of an Adam step (lr): Adam divides each
# gradient by its own magnitude, so a rounding-boundary flip (bf16-class
# grad tiers) or a gradient that cancels to ~1e-8 moves small-gradient
# elements' updates, and later gradients follow the slightly different
# parameters.  Measured on an H100 at the headline shape after 3 steps:
# bf16x2 grads, 99.99% of parameters within 0.1 lr, max 3.9 lr (an element
# can move (1 - b1) / sqrt(1 - b2) = 3.16 lr per step); bf16x3 grads,
# 99.995% within 0.01 lr, max 0.3 lr.
STEP_BULK_SHARE = 0.999
STEP_F32_BULK_LR, STEP_F32_MAX_LR = 1e-2, 1.0
STEP_BF16_BULK_LR, STEP_BF16_MAX_LR = 1e-1, 10.0
MOMENT_MAX_RTOL, MOMENT_BULK_RTOL, MOMENT_BULK_SHARE = 5e-2, 1e-3, 0.99
# The first step's loss comes from one state: only the summation order
# differs.  Later losses follow the parameters that moved apart as above
# (measured on an H100 at the headline shape, bf16x2 grads, third step:
# 6 of 669 windows beyond 1e-5, the worst 3.3e-5 relative).
LOSS_RTOL, LOSS_DRIFT_RTOL = 1e-5, 3e-4


def is_bf16_grad(gmode: str) -> bool:
    return gmode in ("bf16x2", "bf16")


def check_grads(out: torch.Tensor, ref: torch.Tensor, gmode: str) -> float:
    """Assert the grad tier's tolerance on flat (k, P) gradients; returns
    the max abs difference."""
    assert torch.isfinite(out).all()
    err = (out - ref).abs()
    scale = float(ref.abs().max())
    if is_bf16_grad(gmode):
        assert float(err.max()) <= GRAD_BF16_MAX_RTOL * scale, err.max()
        share = float((err <= GRAD_BF16_BULK_RTOL * scale).float().mean())
        assert share >= GRAD_BULK_SHARE, share
    else:
        assert float(err.max()) <= GRAD_F32_RTOL * scale, (gmode, err.max())
    return float(err.max())


def check_state(out, ref, lr: float, gmode: str) -> dict[str, float]:
    """Assert D's tolerance on two FlatTrainStates a few steps from one
    state; returns the max abs difference per group."""
    bulk, top = ((STEP_BF16_BULK_LR, STEP_BF16_MAX_LR) if is_bf16_grad(gmode)
                 else (STEP_F32_BULK_LR, STEP_F32_MAX_LR))
    errs = {}
    for name in ("params", "best_params"):
        a, b = getattr(out, name), getattr(ref, name)
        err = (a - b).abs()
        assert torch.isfinite(a).all()
        assert float(err.max()) <= top * lr, (name, err.max())
        share = float((err <= bulk * lr).float().mean())
        assert share >= STEP_BULK_SHARE, (name, share)
        errs[name] = float(err.max())
    for name in ("mu", "nu"):
        a, b = getattr(out, name), getattr(ref, name)
        err = (a - b).abs()
        scale = float(b.abs().max())
        assert float(err.max()) <= MOMENT_MAX_RTOL * scale, (name, err.max())
        share = float((err <= MOMENT_BULK_RTOL * scale).float().mean())
        assert share >= MOMENT_BULK_SHARE, (name, share)
        errs[name] = float(err.max())
    for name in ("step", "lr", "best_iter", "plateau_bad"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
    torch.testing.assert_close(out.best_loss, ref.best_loss,
                               rtol=LOSS_DRIFT_RTOL, atol=0)
    return errs


def steps_kernel_vs_plain(cfg, tc, coords, targets, fs0, steps=3):
    """``steps`` kernel steps and plain steps from one flat state, at the
    grad tier of INRAUDIO_GRAD_PRECISION: checks each step's loss and the
    first step's gradients; returns (kernel state, plain state, first-step
    gradient error)."""
    n = coords.shape[0]
    kstep = ss.make_fused_mse_train_step(cfg, tc, n, approx_sin=True)
    pstep = ss.make_fused_mse_train_step(cfg, tc, n, approx_sin=True,
                                         step_call=ss.step_plain)
    a, b = clone_state(fs0), clone_state(fs0)
    gmode = st.grad_dot_mode()
    for i in range(steps):
        a, (la, _) = kstep(a, coords, targets)
        b, (lb, _) = pstep(b, coords, targets)
        torch.testing.assert_close(la, lb, atol=0,
                                   rtol=LOSS_DRIFT_RTOL if i else LOSS_RTOL)
        if i == 0:  # mu = 0.1 g: the kernel's gradients
            gerr = check_grads(a.mu, b.mu, gmode)
    return a, b, gerr


def clone_state(state):
    return type(state)(*(t.clone() for t in state))


def _gap(a, b) -> float:
    return float((a - b).abs().max())


def check_rff_backward(params, cfg, plan, gmode, coords, cot, bt):
    """Kernel C of an RFF model against its plain version, held to
    RFF_CTRL_X times the control (the plain backward with layer 0 one ulp
    off) or to the grad tier's max tolerance; returns (error, control,
    limit, max |grad|)."""
    out = st.flatten_params(st.SIREN_BWD(params, cfg, plan, gmode, coords,
                                         cot, bt), cfg)
    ref = st.flatten_params(st.backward_plain(params, plan, gmode, coords,
                                              cot, bt), cfg)
    ctl = st.flatten_params(st.backward_plain(perturb_layer0(params), plan,
                                              gmode, coords, cot, bt), cfg)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    err, c = _gap(out, ref), _gap(ctl, ref)
    tol = (GRAD_BF16_MAX_RTOL if is_bf16_grad(gmode) else GRAD_F32_RTOL)
    limit = max(RFF_CTRL_X * c, tol * scale)
    assert torch.isfinite(out).all() and err <= limit, (err, c, limit)
    return err, c, limit, scale


def check_rff_steps(cfg, tc, coords, targets, state, rff_b, steps=3,
                    weight=None, tier=None):
    """``steps`` kernel steps, plain steps, and plain steps from layer 0
    one ulp off (the control), from one stacked TrainState of an RFF (or
    raw, rff_b None) model, with the per-row loss ``weight`` (k, n) or
    None, both steps built with ``tier`` (None: the environment's).  Each
    loss, the first step's gradients (mu = 0.1 g) and the final
    parameters (in lr) are held to RFF_CTRL_X times the control's gap or to
    the raw-model tolerances above; returns (the kernel's FlatTrainState, a
    dict of the gaps)."""
    n, lr = coords.shape[0], tc.learning_rate
    gmode = ss.tier_plan(cfg, True, rff_b is not None, tier)[1]
    kstep = ss.make_fused_mse_train_step(cfg, tc, n, approx_sin=True,
                                         rff_b=rff_b, tier=tier)
    pstep = ss.make_fused_mse_train_step(cfg, tc, n, approx_sin=True,
                                         step_call=ss.step_plain, rff_b=rff_b,
                                         tier=tier)
    a = ss.flat_state_from_train_state(state, cfg)
    p = clone_state(a)
    u = ss.flat_state_from_train_state(
        state._replace(params=perturb_layer0(state.params)), cfg)
    gaps = {"loss": [], "loss_ctrl": []}
    for i in range(steps):
        a, (la, _) = kstep(a, coords, targets, weight)
        p, (lp, _) = pstep(p, coords, targets, weight)
        u, (lu, _) = pstep(u, coords, targets, weight)
        torch.cuda.synchronize()
        scale = float(lp.abs().max())
        gaps["loss"].append(_gap(la, lp) / scale)
        gaps["loss_ctrl"].append(_gap(lu, lp) / scale)
        assert gaps["loss"][-1] <= max(RFF_CTRL_X * gaps["loss_ctrl"][-1],
                                       LOSS_DRIFT_RTOL if i else LOSS_RTOL), \
            gaps
        if i == 0:  # mu = 0.1 g
            tol = (GRAD_BF16_MAX_RTOL if is_bf16_grad(gmode)
                   else GRAD_F32_RTOL) * float(p.mu.abs().max())
            gaps.update(grad=_gap(a.mu, p.mu), grad_ctrl=_gap(u.mu, p.mu),
                        grad_scale=float(p.mu.abs().max()), grad_tol=tol)
            assert gaps["grad"] <= max(RFF_CTRL_X * gaps["grad_ctrl"], tol), \
                gaps
    top = STEP_BF16_MAX_LR if is_bf16_grad(gmode) else STEP_F32_MAX_LR
    gaps.update(params=_gap(a.params, p.params) / lr,
                params_ctrl=_gap(u.params, p.params) / lr, params_top=top)
    assert torch.isfinite(a.params).all(), gaps
    assert gaps["params"] <= max(RFF_CTRL_X * gaps["params_ctrl"], top), gaps
    return a, gaps


def _train_setup(h, k, n, dev, seed=0, lr=1e-3):
    cfg = SirenSnakeTanhConfig(hidden_features=h, first_omega_0=300.0)
    model = build_model("mlp", cfg, fused=True, approx_sin=True)
    tc = tloop.TrainConfig(learning_rate=lr, grad_clip_norm=1.0,
                           plateau_patience=35)
    state = tloop.init_train_state(model, torch.Generator().manual_seed(seed),
                                   tc, dev, windows=k)
    coords = torch.linspace(-1, 1, n, device=dev)[:, None]
    freqs = torch.arange(1, k + 1, device=dev, dtype=torch.float32)[:, None]
    targets = 0.8 * torch.sin(3.0 * freqs * torch.pi * coords[:, 0])
    return cfg, model, tc, state, coords, targets


# (h, rows, RFF frequencies) of C, D and E against their plain versions:
# 300 rows (a ragged tile) at every width; 1300 rows at the kernel widths,
# whose slices at h = 128 and 256 hold odd numbers of tiles (the sweep's
# last group of two tiles part-filled: 3-4 tiles a slice at h = 128, 13-14
# at h = 256), raw and with an RFF layer 0 of 16 frequencies
SWEEP_CASES = ([(h, 300, 0) for h in (32, 64, 128, 256, 36, 40, 48)]
               + [(h, 1300, f) for f in (0, 16) for h in (32, 64, 128, 256)])
SWEEP_IDS = [f"{h}-{n}" + (f"-rff{f}" if f else "") for h, n, f in SWEEP_CASES]


@pytest.mark.parametrize("gmode", ["bf16x2", "highest", "bf16", "bf16x3"])
@pytest.mark.parametrize("h,rows,f", SWEEP_CASES, ids=SWEEP_IDS)
def test_backward_kernel_matches_plain(dev, h, rows, f, gmode):
    before = st.SIREN_BWD.launches
    if f:
        cfg, params, b, bt = _rff_model(h, f, dev)
        plan = sf.stack_plan(cfg, approx_sin=True, rff=True)
        coords = torch.rand(rows, 1, device=dev,
                            generator=torch.Generator(dev).manual_seed(2))
        cot = torch.randn(1, rows, 1, device=dev,
                          generator=torch.Generator(dev).manual_seed(1))
        check_rff_backward(stacked(params), cfg, plan, gmode, 2 * coords - 1,
                           cot, bt)
        assert st.SIREN_BWD.launches == before + 1
        return
    cfg = SirenSnakeTanhConfig(hidden_features=h, first_omega_0=1800.0)
    params = _population(cfg, 3, dev)
    plan = sf.stack_plan(cfg, approx_sin=True)
    coords = torch.linspace(-1, 1, rows, device=dev)[:, None]
    cot = torch.randn(3, rows, 1, device=dev,
                      generator=torch.Generator(dev).manual_seed(1))
    out = st.SIREN_BWD(params, cfg, plan, gmode, coords, cot)
    assert st.SIREN_BWD.launches == before + 1
    ref = st.backward_plain(params, plan, gmode, coords, cot)
    check_grads(st.flatten_params(out, cfg), st.flatten_params(ref, cfg),
                gmode)


@pytest.mark.parametrize("gmode", ["bf16x2", "highest", "bf16", "bf16x3"])
@pytest.mark.parametrize("h,f,d", [(32, 4, 1), (64, 37, 2), (256, 256, 1)])
def test_rff_backward_kernel_matches_plain(dev, h, f, d, gmode):
    cfg, params, b, bt = _rff_model(h, f, dev, d=d)
    params = stacked(params)
    plan = sf.stack_plan(cfg, approx_sin=True, rff=True)
    coords = torch.rand(1000, d, device=dev) * 2 - 1
    cot = torch.randn(1, 1000, 1, device=dev,
                      generator=torch.Generator(dev).manual_seed(1))
    before = st.SIREN_BWD.launches
    check_rff_backward(params, cfg, plan, gmode, coords, cot, bt)
    assert st.SIREN_BWD.launches == before + 1


def test_rff_autograd_runs_both_kernels(dev):
    cfg, params, b, _ = _rff_model(64, 16, dev)
    leaves = [v.requires_grad_(True) for p in params["layers"]
              for v in p.values()]
    coords = torch.linspace(-1, 1, 700, device=dev)[:, None]
    f0, b0 = sf.SIREN_STACK.launches, st.SIREN_BWD.launches
    out = st.fused_siren_train_apply(params, cfg, coords, approx_sin=True,
                                     rff_b=b)
    grads = torch.autograd.grad(torch.mean(out ** 2), leaves)
    assert (sf.SIREN_STACK.launches, st.SIREN_BWD.launches) == (f0 + 1,
                                                                b0 + 1)
    assert all(torch.isfinite(g).all() and g.any() for g in grads)


STEP_CASES = ([(h, 300, "raw") for h in (32, 64, 128, 256)]
              + [(h, 1300, v) for v in ("raw", "rff", "weighted")
                 for h in (32, 64, 128, 256)])


@pytest.mark.parametrize("gmode", ["bf16x2", "bf16x3", "bf16", "highest"])
@pytest.mark.parametrize("h,rows,variant", STEP_CASES,
                         ids=[f"{h}-{n}-{v}" for h, n, v in STEP_CASES])
def test_step_kernel_matches_plain(dev, h, rows, variant, gmode, monkeypatch):
    """Three D steps against the plain step: raw at 300 rows; at 1300 rows
    (odd tiles a slice at h = 128 and 256) raw, with an RFF layer 0 of 16
    frequencies (one window) and with a per-row loss weight."""
    monkeypatch.setenv("INRAUDIO_GRAD_PRECISION", gmode)
    before = ss.SIREN_STEP.launches
    if variant == "rff":
        cfg, model, tc, state, coords, targets, b = _rff_train_setup(
            h, 16, 1, rows, dev)
        check_rff_steps(cfg, tc, coords, targets, state, b)
    elif variant == "weighted":
        cfg, tc, fs, coords, targets, w = weighted_setup(h, 3, rows, dev)
        weighted_steps_vs_plain(cfg, tc, fs, coords, targets, w, gmode)
    else:
        cfg, model, tc, state, coords, targets = _train_setup(h, 3, rows,
                                                              dev)
        a, b, _ = steps_kernel_vs_plain(
            cfg, tc, coords, targets,
            ss.flat_state_from_train_state(state, cfg))
        check_state(a, b, tc.learning_rate, gmode)
    assert ss.SIREN_STEP.launches == before + 3


def bits_digest(tensors) -> str:
    """SHA-256 of the tensors' float32 bytes, one after another."""
    digest = hashlib.sha256()
    for t in tensors:
        digest.update(t.detach().float().contiguous().cpu().numpy().tobytes())
    return digest.hexdigest()


# SHA-256 of D's state after three steps from _train_setup's state, in the
# default bf16x3 forward and each grad tier: params, mu, nu and best, then
# the three steps' losses, as float32 bytes.  Recorded on an NVIDIA H100
# 80GB HBM3 from the build of commit e61b326, whose sweep carried one row
# tile a CTA; the sweep's grouping of tiles must leave every bit as it was.
SWEEP_SHAPES = {"runner": (256, 1, 70_000), "headline": (128, 669, 512)}
SWEEP_STATE_DIGESTS = {
    ("runner", "bf16x2"):
        "8a96d762a884d5edbbe69a3908e6fbee57a8fd8973ec75bbf56e6435c16f2dea",
    ("runner", "bf16x3"):
        "1f704967036a7b344df87e961c21924fdf47acf800359844531d7215c7ca867a",
    ("headline", "bf16x2"):
        "e61b5943ceebeb10518ff5efefcbe25975c176840db17ea642a678b0cc9bcd2a",
    ("headline", "bf16x3"):
        "419b41cad9ff212d0f83bcf47d127853794877f6de62324d67a5d8c64b2ed71d",
}


@pytest.mark.parametrize("gmode", ["bf16x2", "bf16x3"])
@pytest.mark.parametrize("shape", list(SWEEP_SHAPES))
def test_sweep_states_match_recorded_bits(dev, shape, gmode):
    """D's state after 3 steps at the runner's width (h = 256, 70,000 rows:
    137 slices of 15-16 tiles) and at the headline encode's shape (h = 128,
    669 windows of 512 rows) against the digests recorded above."""
    h, k, n = SWEEP_SHAPES[shape]
    cfg, model, tc, state, coords, targets = _train_setup(h, k, n, dev)
    step = ss.make_fused_mse_train_step(cfg, tc, n, approx_sin=True,
                                        tier={"grad_mode": gmode})
    fs = ss.flat_state_from_train_state(state, cfg)
    losses = []
    for _ in range(3):
        fs, (loss, _) = step(fs, coords, targets)
        losses.append(loss)
    assert bits_digest((fs.params, fs.mu, fs.nu, fs.best_params,
                        *losses)) == SWEEP_STATE_DIGESTS[shape, gmode]


def test_sweep_counter_reads_its_group(dev):
    """A D step at the runner's width advances ``sweep.launches.g<G>`` by
    the sweep launches of its plan, with G the row tiles a sweep CTA
    carries: two at h = 256."""
    n = 70_000
    cfg, model, tc, state, coords, targets = _train_setup(256, 1, n, dev)
    fs = ss.flat_state_from_train_state(state, cfg)
    g = st.validate_grad_launch(fs.params, cfg,
                                sf.stack_plan(cfg, approx_sin=True), coords)
    tp = st.tc_plan(g, st.grad_dot_mode())
    assert tp.group == st.sweep_group(256) >= 2
    sweeps = sum(tp.chunks * len(st.tc_passes(min(tp.windows, g.k - w0)
                                              * tp.slices, tp.units))
                 for w0 in range(0, g.k, tp.windows))
    launches = counter(f"sweep.launches.g{tp.group}")
    before = launches.value
    ss.make_fused_mse_train_step(cfg, tc, n, approx_sin=True)(fs, coords,
                                                              targets)
    torch.cuda.synchronize()
    assert sweeps >= 1 and launches.value == before + sweeps


def padded_slots(cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """(every padded slot, the padded snake a slots) of the flat layout of
    a model between the kernel widths, as (P,) masks."""
    layout = st.flat_layout(cfg)
    h, L = cfg.hidden_features, len(cfg.layer_kinds)
    pad = torch.zeros(layout.size, dtype=torch.bool)
    snake = torch.zeros(layout.size, dtype=torch.bool)
    for li, key, off, shape in layout.leaves:
        real = torch.zeros(shape, dtype=torch.bool)
        idx = [slice(None)] * len(shape)
        for dim in sf._hidden_dims(key, li, L):
            idx[dim] = slice(0, h)
        real[tuple(idx)] = True
        pad[off:off + real.numel()] = ~real.reshape(-1)
        if key == "snake_a":
            snake[off:off + real.numel()] = ~real.reshape(-1)
    return pad, snake


@pytest.mark.parametrize("gmode", ["bf16x2", "bf16x3", "highest"])
@pytest.mark.parametrize("h", [36, 40, 48])
def test_step_kernel_at_padded_widths(dev, h, gmode, monkeypatch):
    # D on a model between the kernel widths, padded to 64 once per fit,
    # with its own width passed to the kernel: 3 steps against the plain
    # step, and every padded slot bit-zero (snake a bit-one) after them
    monkeypatch.setenv("INRAUDIO_GRAD_PRECISION", gmode)
    cfg, model, tc, state, coords, targets = _train_setup(h, 3, 300, dev)
    fs0 = ss.flat_state_from_train_state(state, cfg)
    before = ss.SIREN_STEP.launches
    a, b, _ = steps_kernel_vs_plain(cfg, tc, coords, targets, fs0)
    assert ss.SIREN_STEP.launches == before + 3
    check_state(a, b, tc.learning_rate, gmode)
    pad, snake = padded_slots(cfg)
    assert pad.any() and snake.any()
    pad, snake = pad.to(dev), snake.to(dev)
    for group in (a.params, a.best_params):
        assert torch.all(group[:, pad & ~snake] == 0)
        assert torch.all(group[:, snake] == 1.0)
    for group in (a.mu, a.nu):
        assert torch.all(group[:, pad] == 0)
    # and back at the model's own width
    out = ss.train_state_from_flat(a, cfg)
    assert out.params["layers"][1]["w"].shape == (3, h, h)


@pytest.mark.parametrize("gmode", ["bf16x2", "bf16x3", "bf16"])
@pytest.mark.parametrize("h,f", [(32, 4), (256, 256)])
def test_rff_step_kernel_matches_plain(dev, h, f, gmode, monkeypatch):
    monkeypatch.setenv("INRAUDIO_GRAD_PRECISION", gmode)
    cfg, model, tc, state, coords, targets, b = _rff_train_setup(h, f, 1,
                                                                 2000, dev)
    before = ss.SIREN_STEP.launches
    check_rff_steps(cfg, tc, coords, targets, state, b)
    assert ss.SIREN_STEP.launches == before + 3


def _rff_train_setup(h, f, k, n, dev, seed=0):
    """_train_setup's recipe with an RFF layer 0 of f frequencies."""
    cfg = SirenSnakeTanhConfig(in_features=2 * f, hidden_features=h,
                               first_omega_0=300.0)
    b = rff_init(torch.Generator().manual_seed(seed + 1), 1, f, sigma=10.0,
                 device=dev)
    model = build_model("mlp", cfg, fused=True, approx_sin=True, rff_b=b)
    tc = tloop.TrainConfig(learning_rate=1e-3, grad_clip_norm=1.0,
                           plateau_patience=35)
    state = tloop.init_train_state(model, torch.Generator().manual_seed(seed),
                                   tc, dev, windows=k)
    coords = torch.linspace(-1, 1, n, device=dev)[:, None]
    freqs = torch.arange(1, k + 1, device=dev, dtype=torch.float32)[:, None]
    targets = 0.8 * torch.sin(3.0 * freqs * torch.pi * coords[:, 0])
    return cfg, model, tc, state, coords, targets, b


def test_rff_step_over_row_slices_is_deterministic_and_budget_free(
        dev, monkeypatch):
    """One window of more row tiles than MAX_SLICES (h = 256, RFF): its
    tiles go through MAX_SLICES slices.  Two steps from one state are
    bit-equal, and a scratch budget too small for one window changes
    nothing: D's state and C's grads stay bit-equal."""
    n = 12000  # 375 row tiles of 32
    cfg, model, tc, state, coords, targets, b = _rff_train_setup(
        256, 64, 2, n, dev)
    step = ss.make_fused_mse_train_step(cfg, tc, n, approx_sin=True, rff_b=b)
    s0 = ss.flat_state_from_train_state(state, cfg)
    s0, _ = step(s0, coords, targets)  # non-zero moments
    plan = sf.stack_plan(cfg, approx_sin=True, rff=True)
    bt = sf._prep_rff_bt(b)
    g = st.validate_grad_launch(s0.params, cfg, plan, coords, bt)
    assert g.tiles == 375 and g.slices == st.MAX_SLICES
    assert st.window_group(g) == 2
    params = st.unflatten_params(s0.params.clone(), cfg)
    cot = torch.randn(2, n, 1, device=dev,
                      generator=torch.Generator(dev).manual_seed(3))
    one, (l1, _) = step(clone_state(s0), coords, targets)
    again, (l2, _) = step(clone_state(s0), coords, targets)
    g1 = st.SIREN_BWD(params, cfg, plan, "bf16x2", coords, cot, bt)
    monkeypatch.setattr(st, "SCRATCH_BYTES", 1)
    monkeypatch.setattr(st, "PLANE_BYTES", 1)
    assert st.window_group(g) == 1 and g.slices == st.MAX_SLICES
    tp = st.tc_plan(g, "bf16x2")
    assert (tp.windows, tp.units) == (1, 1)  # every unit its own pass
    small, (l3, _) = step(clone_state(s0), coords, targets)
    g2 = st.SIREN_BWD(params, cfg, plan, "bf16x2", coords, cot, bt)
    assert torch.equal(l1, l2) and torch.equal(l1, l3)
    for x, y, z in zip(one, again, small):
        assert torch.equal(x, y) and torch.equal(x, z)
    for x, y in zip(st.flatten_params(g1, cfg), st.flatten_params(g2, cfg)):
        assert torch.equal(x, y)


def test_step_kernel_is_deterministic(dev):
    cfg, model, tc, state, coords, targets = _train_setup(128, 4, 700, dev)
    step = ss.make_fused_mse_train_step(cfg, tc, 700, approx_sin=True)
    s0 = ss.flat_state_from_train_state(state, cfg)
    s0, _ = step(s0, coords, targets)  # non-zero moments
    a, (la, _) = step(clone_state(s0), coords, targets)
    b, (lb, _) = step(clone_state(s0), coords, targets)
    assert torch.equal(la, lb)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("h", [32, 128])
def test_window_groups_leave_results_bit_equal(dev, h, monkeypatch):
    # long windows: a small scratch budget sends the population through
    # grad + reduce in groups; every window's result is that of one group
    cfg, model, tc, state, coords, targets = _train_setup(h, 5, 1500, dev)
    step = ss.make_fused_mse_train_step(cfg, tc, 1500, approx_sin=True)
    s0 = ss.flat_state_from_train_state(state, cfg)
    s0, _ = step(s0, coords, targets)  # non-zero moments
    plan = sf.stack_plan(cfg, approx_sin=True)
    params = st.unflatten_params(s0.params.clone(), cfg)
    cot = torch.randn(5, 1500, 1, device=dev,
                      generator=torch.Generator(dev).manual_seed(3))
    one, (l1, _) = step(clone_state(s0), coords, targets)
    g1 = st.SIREN_BWD(params, cfg, plan, "bf16x2", coords, cot)
    g = st.validate_grad_launch(s0.params, cfg, plan, coords)
    assert st.window_group(g) == 5
    per_window = 4 * g.tiles * (g.layout.size + len(plan.kinds)
                                * st.TILE_FLOATS)
    monkeypatch.setattr(st, "SCRATCH_BYTES", 2 * per_window)
    assert st.window_group(g) == 2  # groups of 2, 2, 1
    # the tensor-core route (this step's bf16x2 grads): groups of windows
    # within SCRATCH_BYTES and passes of 3 units within PLANE_BYTES
    tp = st.tc_plan(g, "bf16x2")
    group, _ = tp.scratch_bytes(g.layout.size, len(plan.kinds))
    monkeypatch.setattr(st, "SCRATCH_BYTES", 2 * group // tp.windows)
    monkeypatch.setattr(st, "PLANE_BYTES", tp.scratch_bytes(
        g.layout.size, len(plan.kinds))[1] // tp.units * 3)
    tp = st.tc_plan(g, "bf16x2")
    assert (tp.windows, tp.units) == (2, 3) and tp.slices > 1
    two, (l2, _) = step(clone_state(s0), coords, targets)
    g2 = st.SIREN_BWD(params, cfg, plan, "bf16x2", coords, cot)
    assert torch.equal(l1, l2)
    for x, y in zip(one, two):
        assert torch.equal(x, y)
    for x, y in zip(st.flatten_params(g1, cfg), st.flatten_params(g2, cfg)):
        assert torch.equal(x, y)


def test_training_kernels_validate(dev):
    cfg, model, tc, state, coords, targets = _train_setup(32, 2, 64, dev)
    wide = SirenSnakeTanhConfig(hidden_features=320)
    with pytest.raises(ValueError, match="hidden widths 1..256"):
        tloop.fused_step_plan(build_model("mlp", wide, fused=True), tc, 64)
    with pytest.raises(ValueError, match="hidden widths"):
        st.fused_siren_train_apply(_population(wide, 1, dev), wide, coords)
    fs = ss.flat_state_from_train_state(state, cfg)
    before = ss.SIREN_STEP.launches
    with pytest.raises(ValueError, match="coords on"):
        ss.make_fused_mse_train_step(cfg, tc, 64)(fs, coords.cpu(),
                                                  targets.cpu())
    assert ss.SIREN_STEP.launches == before


# ---------------------------------------------------------------------------
# The row-sharded fit: E (one shard's loss and grads) and F (clip + Adam +
# best on all-reduced grads)
# ---------------------------------------------------------------------------

# F against adam_epilogue_plain on one buffer: the same elementwise
# expressions op by op (-fmad=false); only the norm's summation order
# differs, which moves the clip scale by an ulp or so.
ADAM_RTOL = 1e-6


def shard_setup(h, f, n, dev, seed=0):
    """(cfg, plan, bt, flat state (k = 1), coords (n, 1), targets (1, n))
    of a raw (f = 0) or RFF (f frequencies) mlp, one step into its fit
    (non-zero moments)."""
    if f:
        cfg, model, tc, state, coords, targets, b = _rff_train_setup(
            h, f, 1, n, dev, seed)
    else:
        cfg, model, tc, state, coords, targets = _train_setup(h, 1, n, dev,
                                                              seed)
        b = None
    fs = ss.flat_state_from_train_state(state, cfg)
    fs, _ = ss.make_fused_mse_train_step(cfg, tc, n, approx_sin=True,
                                         rff_b=b)(fs, coords, targets)
    plan = sf.stack_plan(cfg, approx_sin=True, rff=b is not None)
    bt = None if b is None else sf._prep_rff_bt(b)
    return cfg, plan, bt, fs, coords, targets


def _limit(rows, dev):
    return torch.tensor([rows], dtype=torch.int32, device=dev)


def check_grad_shard(fs, coords, targets, limit, n_valid, cfg, plan, gmode,
                     bt, weight=None):
    """Kernel E against its plain version on one shard, with the per-row
    loss ``weight`` or None: the loss to LOSS_RTOL, the grads to the grad
    tier's tolerance or, with an RFF layer 0, to RFF_CTRL_X times the
    control (the plain version with layer 0 one ulp off).  Returns (kernel
    buffer, grad error, control gap)."""
    P = fs.params.shape[1]
    out = ss.SIREN_GRAD(fs.params, coords, targets, limit, n_valid, cfg,
                        plan, gmode, bt, weight=weight)
    ref = ss.grad_plain(fs.params, coords, targets, limit, n_valid, cfg,
                        plan, gmode, bt, weight=weight)
    pert = st.flatten_params(perturb_layer0(st.unflatten_params(
        fs.params, cfg)), cfg)
    ctl = ss.grad_plain(pert, coords, targets, limit, n_valid, cfg, plan,
                        gmode, bt, weight=weight)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[P], ref[P], rtol=LOSS_RTOL, atol=0)
    assert torch.equal(out[P + 1:], torch.zeros(3, device=out.device))
    err, c = _gap(out[:P], ref[:P]), _gap(ctl[:P], ref[:P])
    if bt is None:
        check_grads(out[None, :P], ref[None, :P], gmode)
    else:
        tol = (GRAD_BF16_MAX_RTOL if is_bf16_grad(gmode) else GRAD_F32_RTOL)
        assert err <= max(RFF_CTRL_X * c, tol * float(ref[:P].abs().max())), \
            (err, c)
    return out, err, c


GRAD_CASES = ([(h, f, 1000, False) for h, f in
               ((32, 0), (64, 0), (128, 0), (256, 0), (32, 4), (256, 256),
                (40, 0))]
              + [(h, f, 2700, wt) for h, f, wt in
                 ((32, 0, False), (64, 0, False), (128, 0, False),
                  (256, 0, False), (128, 16, False), (256, 16, False),
                  (64, 0, True), (128, 0, True), (256, 0, True))])


@pytest.mark.parametrize("gmode", ["bf16x2", "highest", "bf16", "bf16x3"])
@pytest.mark.parametrize("h,f,rows,weighted", GRAD_CASES,
                         ids=[f"{h}-{f}-{n}" + ("-weighted" if w else "")
                              for h, f, n, w in GRAD_CASES])
def test_grad_kernel_matches_plain(dev, h, f, rows, weighted, gmode):
    """E on a tail shard: ``rows`` rows of which all but the last 300 are
    real, the loss normalised by a whole clip of 2500 rows (3000 past 1000
    rows).  At 2700 rows the slices at h = 128 and 256 hold odd numbers of
    tiles; raw, with an RFF layer 0, or with a per-row loss weight."""
    if weighted:
        cfg, tc, fs, coords, targets, w = weighted_setup(h, 1, rows, dev)
        plan, bt = sf.stack_plan(cfg, approx_sin=True), None
    else:
        cfg, plan, bt, fs, coords, targets = shard_setup(h, f, rows, dev)
        w = None
    before = ss.SIREN_GRAD.launches
    check_grad_shard(fs, coords, targets, _limit(rows - 300, dev),
                     2500 if rows <= 1000 else 3000, cfg, plan, gmode, bt,
                     weight=w)
    assert ss.SIREN_GRAD.launches == before + 1


@pytest.mark.parametrize("gmode", ["bf16x2", "highest"])
@pytest.mark.parametrize("h,f", [(32, 0), (256, 256)])
def test_grad_kernel_empty_shard_and_repeat(dev, h, f, gmode):
    """A shard with limit 0 gives exact zeros; over a shard of more row
    tiles than MAX_SLICES two calls are bit-equal (both routes)."""
    cfg, plan, bt, fs, coords, targets = shard_setup(h, f, 12000, dev)
    empty = ss.SIREN_GRAD(fs.params, coords, targets, _limit(0, dev), 24000,
                          cfg, plan, gmode, bt)
    a = ss.SIREN_GRAD(fs.params, coords, targets, _limit(11000, dev), 24000,
                      cfg, plan, gmode, bt)
    b = ss.SIREN_GRAD(fs.params, coords, targets, _limit(11000, dev), 24000,
                      cfg, plan, gmode, bt)
    torch.cuda.synchronize()
    assert not empty.any()
    assert torch.equal(a, b) and a.any()


@pytest.mark.parametrize("gmode", ["bf16", "bf16x2", "bf16x3", "highest"])
@pytest.mark.parametrize("kernel", ["C", "D", "E"])
def test_repeat_calls_are_bit_equal(dev, kernel, gmode, monkeypatch):
    """Two calls of C, D or E from one state give bit-equal results, on
    both routes (RFF, h = 256, a window of 375 row tiles)."""
    monkeypatch.setenv("INRAUDIO_GRAD_PRECISION", gmode)
    cfg, plan, bt, fs, coords, targets = shard_setup(256, 64, 12000, dev)
    if kernel == "C":
        params = st.unflatten_params(fs.params, cfg)
        cot = torch.randn(1, 12000, 1, device=dev,
                          generator=torch.Generator(dev).manual_seed(4))
        runs = [st.flatten_params(st.SIREN_BWD(params, cfg, plan, gmode,
                                               coords, cot, bt), cfg)
                for _ in range(2)]
    elif kernel == "D":
        runs = []
        for _ in range(2):
            state = clone_state(fs)
            loss = ss.SIREN_STEP(state.params, state.mu, state.nu,
                                 state.best_params, coords, targets,
                                 state.lr, torch.full_like(state.lr, 0.19),
                                 torch.full_like(state.lr, 0.002),
                                 state.best_loss, cfg, plan, gmode, 1.0, bt)
            runs.append(torch.cat([loss, *[t.reshape(-1).float()
                                           for t in state]]))
    else:
        runs = [ss.SIREN_GRAD(fs.params, coords, targets,
                              _limit(11000, dev), 24000, cfg, plan, gmode,
                              bt) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.isfinite(runs[0]).all() and runs[0].any()
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("gmode", ["bf16x2", "bf16x3"])
def test_row_chunks_match_plain_and_are_budget_free(dev, gmode, monkeypatch):
    """A window of more row tiles than MAX_SLICES whose slices go through
    row chunks (CHUNK_TILES cut to 4: 24 slices of 15-16 tiles in 4
    chunks): C, D and E against their plain versions, and each bit-equal
    whatever the passes (PLANE_BYTES) and groups (SCRATCH_BYTES)."""
    monkeypatch.setenv("INRAUDIO_GRAD_PRECISION", gmode)
    monkeypatch.setattr(st, "CHUNK_TILES", 4)
    n = 12000  # 375 row tiles of 32
    cfg, model, tc, state, coords, targets, b = _rff_train_setup(
        256, 64, 2, n, dev)
    plan = sf.stack_plan(cfg, approx_sin=True, rff=True)
    bt = sf._prep_rff_bt(b)
    fs = ss.flat_state_from_train_state(state, cfg)
    g = st.validate_grad_launch(fs.params, cfg, plan, coords, bt)
    tp = st.tc_plan(g, gmode)
    assert g.tiles == 375 > st.MAX_SLICES
    assert (tp.slices, tp.chunks) == (24, 4)
    params = st.unflatten_params(fs.params, cfg)
    cot = torch.randn(2, n, 1, device=dev,
                      generator=torch.Generator(dev).manual_seed(3))
    check_rff_backward(params, cfg, plan, gmode, coords, cot, bt)
    check_rff_steps(cfg, tc, coords, targets, state, b)
    one = fs.params[:1].clone()
    check_grad_shard(fs._replace(params=one), coords, targets[:1],
                     _limit(n - 500, dev), n, cfg, plan, gmode, bt)
    step = ss.make_fused_mse_train_step(cfg, tc, n, approx_sin=True, rff_b=b)
    a, (la, _) = step(clone_state(fs), coords, targets)
    ga = st.SIREN_BWD(params, cfg, plan, gmode, coords, cot, bt)
    ea = ss.SIREN_GRAD(one, coords, targets[:1], _limit(n - 500, dev), n,
                       cfg, plan, gmode, bt)
    monkeypatch.setattr(st, "SCRATCH_BYTES", 1)
    monkeypatch.setattr(st, "PLANE_BYTES", 1)
    assert (st.tc_plan(g, gmode).windows, st.tc_plan(g, gmode).units) == \
        (1, 1)
    b2, (lb, _) = step(clone_state(fs), coords, targets)
    gb = st.SIREN_BWD(params, cfg, plan, gmode, coords, cot, bt)
    eb = ss.SIREN_GRAD(one, coords, targets[:1], _limit(n - 500, dev), n,
                       cfg, plan, gmode, bt)
    assert torch.equal(la, lb) and torch.equal(ea, eb)
    for x, y in zip(a, b2):
        assert torch.equal(x, y)
    for x, y in zip(st.flatten_params(ga, cfg), st.flatten_params(gb, cfg)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("h,f", [(64, 0), (256, 256)])
def test_grad_shards_sum_to_the_whole_clip(dev, h, f):
    """Two shards' E buffers summed (what the all-reduce forms) against
    the grad accumulation of D over the whole clip: each row's arithmetic
    is the same, only the order of the sums over rows differs."""
    n = 5000
    cfg, plan, bt, fs, coords, targets = shard_setup(h, f, n, dev)
    gmode = st.grad_dot_mode()
    tm = st.tile_rows(h)
    rows = -(-n // (2 * tm)) * tm  # each shard whole row tiles
    total = 0
    for r in range(2):
        cs = torch.zeros(rows, 1, device=dev)
        ts = torch.zeros(1, rows, device=dev)
        valid = min(rows, n - r * rows)
        cs[:valid] = coords[r * rows:r * rows + valid]
        ts[0, :valid] = targets[0, r * rows:r * rows + valid]
        total = total + ss.SIREN_GRAD(fs.params, cs, ts, _limit(valid, dev),
                                      n, cfg, plan, gmode, bt)
    g = st.validate_grad_launch(fs.params, cfg, plan, coords, bt)
    with torch.cuda.device(dev):
        grads, _, loss_part = st.grad_reduce(
            st.TRAIN_LIBRARY(), g, coords, fs.params,
            torch.cuda.current_stream(dev).cuda_stream, targets=targets,
            gmode=gmode)
    torch.cuda.synchronize()
    P = g.layout.size
    torch.testing.assert_close(total[P], loss_part.sum(), rtol=LOSS_RTOL,
                               atol=0)
    assert _gap(total[None, :P], grads) <= \
        GRAD_F32_RTOL * float(grads.abs().max())


@pytest.mark.parametrize("clip", [0.0, 1.0])
@pytest.mark.parametrize("track_best", [True, False])
def test_adam_kernel_matches_plain(dev, clip, track_best):
    """F against adam_epilogue_plain on one all-reduced buffer, from a
    state with non-zero moments, its loss below and above best_loss."""
    cfg, plan, bt, fs, coords, targets = shard_setup(256, 0, 500, dev)
    P = fs.params.shape[1]
    gen = torch.Generator(dev).manual_seed(5)
    for loss in (0.5 * float(fs.best_loss), 2.0 * float(fs.best_loss)):
        buf = torch.zeros(P + 4, device=dev)
        buf[:P] = torch.randn(P, device=dev, generator=gen) * 1e-2
        buf[P] = loss
        a, b = clone_state(fs), clone_state(fs)
        c1 = torch.full((1,), 0.19, device=dev)  # t = 2
        c2 = torch.full((1,), 1.0 - 0.999 ** 2, device=dev)
        before = ss.SIREN_ADAM.launches
        la = ss.SIREN_ADAM(a.params, a.mu, a.nu,
                           a.best_params if track_best else None, buf, a.lr,
                           c1, c2, a.best_loss, clip)
        assert ss.SIREN_ADAM.launches == before + 1
        ss.adam_epilogue_plain(b.params, b.mu, b.nu,
                               b.best_params if track_best else None,
                               buf[:P].view(1, P), b.lr, c1, c2, buf[P:P + 1],
                               b.best_loss, clip)
        torch.cuda.synchronize()
        assert float(la) == loss
        for name in ("params", "mu", "nu", "best_params"):
            torch.testing.assert_close(getattr(a, name), getattr(b, name),
                                       rtol=ADAM_RTOL, atol=1e-12)
        assert torch.equal(a.best_params, fs.best_params) != (
            track_best and loss < float(fs.best_loss))


def _epilogue_inputs(dev, k=3, P=13_700, slices=2):
    """D's epilogue inputs for k windows of P floats (three 4096-float
    spans and a ragged one): the reduce's grads and chunk sums of squares
    from random slice partials, window norms 3.0, 0.4 and 1.7 (the first
    and last above a clip of 1.0), loss slices that make windows 0 and 2
    improve on best_loss and window 1 not, and each window's own lr, c1,
    c2."""
    gen = torch.Generator(dev).manual_seed(9)
    rnd = lambda *shape: torch.randn(*shape, device=dev,  # noqa: E731
                                     generator=gen)
    vec = lambda *v: torch.tensor(v, device=dev)  # noqa: E731
    norms = vec(3.0, 0.4, 1.7)
    partial = (rnd(k, slices, P) * (norms / P ** 0.5 / 2)[:, None, None]
               ).reshape(k * slices, P)
    grads = torch.empty(k, P, device=dev)
    sq_part = torch.empty(k, -(-P // st.CHUNK_FLOATS), device=dev)
    rc = st.TRAIN_LIBRARY().siren_reduce(
        partial.data_ptr(), grads.data_ptr(), sq_part.data_ptr(), 0, 0, k,
        slices, P, torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    state = (0.1 * rnd(k, P), 1e-3 * rnd(k, P), 1e-6 * rnd(k, P) ** 2,
             0.1 * rnd(k, P))
    scal = dict(lr=vec(1e-3, 2e-3, 5e-4), c1=vec(0.1, 0.19, 0.271),
                c2=vec(1e-3, 1.999e-3, 2.997e-3),
                best_loss=vec(0.5, 0.6, 0.2))
    loss_part = vec(0.1, 0.2, 0.4, 0.5, 0.05, 0.05)
    return grads, sq_part, loss_part, state, scal


def _run_epilogue(grads, sq_part, loss_part, state, scal, clip):
    """D's epilogue kernels on a copy of ``state`` -> (p, mu, nu, best,
    loss)."""
    p, mu, nu, best = (t.clone() for t in state)
    k = p.shape[0]
    loss = torch.empty(k, device=p.device)
    ss.launch_adam(st.TRAIN_LIBRARY(), grads, sq_part, loss_part, p, mu, nu,
                   best, loss, torch.empty(k, device=p.device), scal["lr"],
                   scal["c1"], scal["c2"], scal["best_loss"], clip,
                   torch.cuda.current_stream().cuda_stream)
    return p, mu, nu, best, loss


@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_d_epilogue_matches_plain_at_three_windows(dev, clip):
    """D's epilogue (the scale and Adam kernels) on three windows with
    their own lr, c1, c2, loss and best_loss, norms above and below the
    clip, against adam_epilogue_plain on the reduce's grads: each group to
    ADAM_RTOL of its largest element (as phase 14 of chip_smoke.py holds F:
    the norm's summation order moves the scale by an ulp, which an element
    where 0.9 mu and 0.1 g nearly cancel carries), the loss exact, best
    written for the improving windows only."""
    grads, sq_part, loss_part, state, scal = _epilogue_inputs(dev)
    got = _run_epilogue(grads, sq_part, loss_part, state, scal, clip)
    p, mu, nu, best = (t.clone() for t in state)
    loss = loss_part.view(3, 2).sum(1)
    ss.adam_epilogue_plain(p, mu, nu, best, grads, scal["lr"], scal["c1"],
                           scal["c2"], loss, scal["best_loss"], clip)
    torch.cuda.synchronize()
    norms = grads.square().sum(1).sqrt()
    assert norms[0] > 1.0 > norms[1] and norms[2] > 1.0
    assert torch.equal(got[4], loss)
    for a, b in zip(got[:4], (p, mu, nu, best)):
        assert _gap(a, b) <= ADAM_RTOL * float(b.abs().max())
    assert torch.equal(got[3][1], state[3][1])
    assert not torch.equal(got[3][0], state[3][0])
    assert not torch.equal(got[3][2], state[3][2])


def test_adam_kernels_are_deterministic(dev):
    """D's epilogue and F, each twice from cloned states: bit-equal."""
    grads, sq_part, loss_part, state, scal = _epilogue_inputs(dev)
    one = _run_epilogue(grads, sq_part, loss_part, state, scal, 1.0)
    two = _run_epilogue(grads, sq_part, loss_part, state, scal, 1.0)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    cfg, plan, bt, fs, coords, targets = shard_setup(256, 0, 500, dev)
    P = fs.params.shape[1]
    buf = torch.zeros(P + 4, device=dev)
    buf[:P] = torch.randn(P, device=dev,
                          generator=torch.Generator(dev).manual_seed(6))
    buf[P] = 0.5 * float(fs.best_loss)
    c1 = torch.full((1,), 0.19, device=dev)
    c2 = torch.full((1,), 1.0 - 0.999 ** 2, device=dev)
    outs = []
    for _ in range(2):
        a = clone_state(fs)
        loss = ss.SIREN_ADAM(a.params, a.mu, a.nu, a.best_params, buf, a.lr,
                             c1, c2, a.best_loss, 1.0)
        outs.append((a.params, a.mu, a.nu, a.best_params, loss))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_f_entry_launches_once_per_call(dev, monkeypatch):
    """Each SIREN_ADAM call calls the library once, through its one
    cooperative entry, and adds one to ``launches``."""
    lib = st.TRAIN_LIBRARY()
    calls = []

    class Counting:
        def __getattr__(self, name):
            fn = getattr(lib, name)
            if not name.startswith("siren_"):
                return fn
            return lambda *args: calls.append(name) or fn(*args)

    monkeypatch.setattr(ss, "TRAIN_LIBRARY", Counting)
    cfg, plan, bt, fs, coords, targets = shard_setup(128, 0, 300, dev)
    P = fs.params.shape[1]
    buf = torch.zeros(P + 4, device=dev)
    c = torch.full((1,), 0.5, device=dev)
    for clip in (0.0, 1.0, 1.0):
        before, n = ss.SIREN_ADAM.launches, len(calls)
        ss.SIREN_ADAM(fs.params, fs.mu, fs.nu, fs.best_params, buf, fs.lr, c,
                      c, fs.best_loss, clip)
        assert ss.SIREN_ADAM.launches == before + 1
        assert [x for x in calls[n:] if x != "siren_adam_global_cap"] == [
            "siren_adam_global"]
    torch.cuda.synchronize()


def test_sharded_step_on_two_ranks_matches_d(dev):
    """One step of the row-sharded fit on two thread ranks of one card
    (gloo, staged through host memory) against the one-rank D step from
    the same state: the loss to LOSS_RTOL, the state to D's tolerance; the
    ranks bit-equal; E and F launched on each rank, D not at all."""
    from inraudio_tpu_torch.parallel import shard_problem_arrays
    n, h = 3000, 128
    cfg, model, tc, state, coords, targets = _train_setup(h, 1, n, dev)
    fs0 = ss.flat_state_from_train_state(state, cfg)
    a, (la, _) = ss.make_fused_mse_train_step(cfg, tc, n, approx_sin=True)(
        clone_state(fs0), coords, targets)
    x, y = coords.cpu().numpy(), targets[0].cpu().numpy()

    def rank(mesh):
        cs, ts, _, sh = shard_problem_arrays(mesh, x, y, st.tile_rows(h))
        step = ss.make_sharded_fused_mse_train_step(
            cfg, tc, n, mesh, _limit(sh.valid, dev), approx_sin=True)
        s, (loss, _) = step(clone_state(fs0), cs, ts.reshape(1, -1))
        torch.cuda.synchronize()
        return s, loss

    counts = (ss.SIREN_GRAD.launches, ss.SIREN_ADAM.launches,
              ss.SIREN_STEP.launches)
    (s0, l0), (s1, l1) = run_thread_ranks(2, rank, device=dev)
    assert (ss.SIREN_GRAD.launches, ss.SIREN_ADAM.launches,
            ss.SIREN_STEP.launches) == (counts[0] + 2, counts[1] + 2,
                                        counts[2])
    assert torch.equal(l0, l1)
    assert all(torch.equal(p, q) for p, q in zip(s0, s1))
    torch.testing.assert_close(l0, la, rtol=LOSS_RTOL, atol=0)
    check_state(s0, a, tc.learning_rate, st.grad_dot_mode())


# ---------------------------------------------------------------------------
# D and E with the per-row loss weight
# ---------------------------------------------------------------------------

def weighted_setup(h, k, n, dev, d=1, seed=0):
    """(cfg, tc, flat state, coords (n, d), targets (k, n), weight (k, n))
    of a fused mlp on a d-column grid; the weight is hearing-threshold-like
    (0.8..1.0, every 37th row 0), mean 1 over each window's rows."""
    cfg = SirenSnakeTanhConfig(in_features=d, hidden_features=h,
                               first_omega_0=300.0)
    model = build_model("mlp", cfg, fused=True, approx_sin=True)
    tc = tloop.TrainConfig(learning_rate=1e-3, grad_clip_norm=1.0,
                           plateau_patience=35)
    state = tloop.init_train_state(model, torch.Generator().manual_seed(seed),
                                   tc, dev, windows=k)
    g = torch.Generator().manual_seed(seed + 1)
    coords = (2 * torch.rand(n, d, generator=g) - 1).to(dev)
    freqs = torch.arange(1, k + 1, dtype=torch.float32)[:, None].to(dev)
    targets = 0.8 * torch.sin(3.0 * freqs * torch.pi * coords[None, :, 0])
    w = 0.8 + 0.2 * torch.rand(k, n, generator=g)
    w[:, ::37] = 0.0
    w = (w * (n / w.sum(dim=1, keepdim=True))).to(dev)
    return (cfg, tc, ss.flat_state_from_train_state(state, cfg), coords,
            targets.contiguous(), w.contiguous())


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("gmode", ["bf16x2", "highest"])
@pytest.mark.parametrize("h", [32, 128, 256])
def test_weighted_step_kernel_matches_plain(dev, h, gmode, d, monkeypatch):
    """Three weighted D steps against ``step_plain`` with the weight, on
    the tensor-core route (bf16x2) and the highest tier's FMA kernel, with
    one and two coordinate columns."""
    monkeypatch.setenv("INRAUDIO_GRAD_PRECISION", gmode)
    cfg, tc, fs, coords, targets, w = weighted_setup(h, 3, 700, dev, d)
    before = ss.SIREN_STEP.launches
    weighted_steps_vs_plain(cfg, tc, fs, coords, targets, w, gmode)
    assert ss.SIREN_STEP.launches == before + 3


def weighted_steps_vs_plain(cfg, tc, fs, coords, targets, w, gmode):
    """Three weighted D steps against ``step_plain`` with the weight: each
    loss, the first step's gradients and the final state."""
    n = coords.shape[0]
    kstep = ss.make_fused_mse_train_step(cfg, tc, n, approx_sin=True)
    pstep = ss.make_fused_mse_train_step(cfg, tc, n, approx_sin=True,
                                         step_call=ss.step_plain)
    a, b = clone_state(fs), clone_state(fs)
    for i in range(3):
        a, (la, _) = kstep(a, coords, targets, w)
        b, (lb, _) = pstep(b, coords, targets, w)
        torch.testing.assert_close(la, lb, atol=0,
                                   rtol=LOSS_DRIFT_RTOL if i else LOSS_RTOL)
        if i == 0:
            check_grads(a.mu, b.mu, gmode)
    check_state(a, b, tc.learning_rate, gmode)


@pytest.mark.parametrize("gmode", ["bf16x2", "bf16x3", "highest"])
def test_ones_weight_gives_the_unweighted_bits(dev, gmode, monkeypatch):
    """A weight of ones multiplies by 1.0f in the plain version's order,
    so D's loss, params, mu, nu and best and E's buffer equal the
    unweighted calls' bit for bit, on both routes."""
    monkeypatch.setenv("INRAUDIO_GRAD_PRECISION", gmode)
    cfg, tc, fs, coords, targets, _ = weighted_setup(128, 2, 900, dev, 2)
    n = coords.shape[0]
    step = ss.make_fused_mse_train_step(cfg, tc, n, approx_sin=True)
    a, (la, _) = step(clone_state(fs), coords, targets)
    b, (lb, _) = step(clone_state(fs), coords, targets,
                      torch.ones_like(targets))
    torch.cuda.synchronize()
    assert torch.equal(la, lb)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    plan = sf.stack_plan(cfg, approx_sin=True)
    e = [ss.SIREN_GRAD(fs.params[:1].contiguous(), coords, targets[:1],
                       _limit(800, dev), n, cfg, plan, gmode, weight=wt)
         for wt in (None, torch.ones_like(targets[:1]))]
    torch.cuda.synchronize()
    assert torch.equal(e[0], e[1])


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("gmode", ["bf16x2", "highest"])
@pytest.mark.parametrize("h", [64, 256])
def test_weighted_grad_kernel_matches_plain(dev, h, gmode, d):
    """Weighted E on a tail shard (1000 rows, 700 real, normalised by a
    clip of 2500 rows) against ``grad_plain`` with the same weight."""
    cfg, tc, fs, coords, targets, w = weighted_setup(h, 1, 1000, dev, d)
    plan = sf.stack_plan(cfg, approx_sin=True)
    P = fs.params.shape[1]
    out = ss.SIREN_GRAD(fs.params, coords, targets, _limit(700, dev), 2500,
                        cfg, plan, gmode, weight=w)
    ref = ss.grad_plain(fs.params, coords, targets, _limit(700, dev), 2500,
                        cfg, plan, gmode, weight=w)
    torch.cuda.synchronize()
    torch.testing.assert_close(out[P], ref[P], rtol=LOSS_RTOL, atol=0)
    check_grads(out[None, :P], ref[None, :P], gmode)
    assert not out[P + 1:].any()


@pytest.mark.parametrize("gmode", ["bf16x2", "highest"])
def test_weighted_grad_shards_sum_to_weighted_d(dev, gmode):
    """Two shards' weighted E buffers (the weight normalised over the whole
    clip, then split) summed against D's weighted grad accumulation over
    the clip; a shard with limit 0 gives exact zeros."""
    n, h = 5000, 128
    cfg, tc, fs, coords, targets, w = weighted_setup(h, 1, n, dev, 2)
    plan = sf.stack_plan(cfg, approx_sin=True)
    tm = st.tile_rows(h)
    rows = -(-n // (2 * tm)) * tm
    total = 0
    for r in range(2):
        valid = min(rows, n - r * rows)
        cs = torch.zeros(rows, 2, device=dev)
        ts, ws = (torch.zeros(1, rows, device=dev) for _ in range(2))
        cs[:valid] = coords[r * rows:r * rows + valid]
        ts[0, :valid] = targets[0, r * rows:r * rows + valid]
        ws[0, :valid] = w[0, r * rows:r * rows + valid]
        total = total + ss.SIREN_GRAD(fs.params, cs, ts, _limit(valid, dev),
                                      n, cfg, plan, gmode, weight=ws)
        empty = ss.SIREN_GRAD(fs.params, cs, ts, _limit(0, dev), n, cfg,
                              plan, gmode, weight=ws)
        assert not empty.any()
    g = st.validate_grad_launch(fs.params, cfg, plan, coords)
    with torch.cuda.device(dev):
        grads, _, loss_part = st.grad_reduce(
            st.TRAIN_LIBRARY(), g, coords, fs.params,
            torch.cuda.current_stream(dev).cuda_stream, targets=targets,
            gmode=gmode, weight=w)
    torch.cuda.synchronize()
    P = g.layout.size
    torch.testing.assert_close(total[P], loss_part.sum(), rtol=LOSS_RTOL,
                               atol=0)
    assert _gap(total[None, :P], grads) <= \
        GRAD_F32_RTOL * float(grads.abs().max())


def test_weight_is_validated(dev):
    cfg, tc, fs, coords, targets, w = weighted_setup(32, 2, 300, dev)
    plan = sf.stack_plan(cfg, approx_sin=True)
    with pytest.raises(ValueError, match="weight"):
        ss.SIREN_STEP(fs.params, fs.mu, fs.nu, fs.best_params, coords,
                      targets, fs.lr, fs.lr, fs.lr, fs.best_loss, cfg, plan,
                      "bf16x2", 1.0, weight=w[:1])
    with pytest.raises(ValueError, match="weight"):
        ss.SIREN_GRAD(fs.params[:1], coords, targets[:1], _limit(300, dev),
                      300, cfg, plan, "bf16x2", weight=w[:1].double())


# ---------------------------------------------------------------------------
# The precision schedule's cheap tier: bf16x2 forward, bf16 grads, degree 7
# ---------------------------------------------------------------------------

CHEAP = dict(f32_mode="bf16x2", grad_mode="bf16", sin_degree=7)


def check_grad_shard_ctrl(fs, coords, targets, limit, n_valid, cfg, plan,
                          gmode, bt):
    """Kernel E against its plain version on one shard, the loss and the
    grads held to RFF_CTRL_X times the control (the plain version with
    layer 0 one ulp off) or to LOSS_RTOL / the grad tier's max tolerance:
    a bf16-rounded forward (bf16x2) can flip a rounding under the other
    summation order.  Returns (kernel buffer, grad error, control gap)."""
    P = fs.params.shape[1]
    out = ss.SIREN_GRAD(fs.params, coords, targets, limit, n_valid, cfg,
                        plan, gmode, bt)
    ref = ss.grad_plain(fs.params, coords, targets, limit, n_valid, cfg,
                        plan, gmode, bt)
    pert = st.flatten_params(perturb_layer0(st.unflatten_params(
        fs.params, cfg)), cfg)
    ctl = ss.grad_plain(pert, coords, targets, limit, n_valid, cfg, plan,
                        gmode, bt)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    lerr = abs(float(out[P] - ref[P])) / float(ref[P])
    lctl = abs(float(ctl[P] - ref[P])) / float(ref[P])
    assert lerr <= max(RFF_CTRL_X * lctl, LOSS_RTOL), (lerr, lctl)
    err, c = _gap(out[:P], ref[:P]), _gap(ctl[:P], ref[:P])
    tol = GRAD_BF16_MAX_RTOL if is_bf16_grad(gmode) else GRAD_F32_RTOL
    assert err <= max(RFF_CTRL_X * c, tol * float(ref[:P].abs().max())), \
        (err, c)
    return out, err, c


@pytest.mark.parametrize("f", [0, 64], ids=["raw", "rff"])
@pytest.mark.parametrize("h", [64, 128, 256])
def test_cheap_tier_step_kernel_matches_plain(dev, h, f):
    """D on the cheap tier against ``step_plain`` on the same tier, three
    steps from one state, beside the 1-ulp control."""
    if f:
        cfg, model, tc, state, coords, targets, b = _rff_train_setup(
            h, f, 1, 2000, dev)
    else:
        cfg, model, tc, state, coords, targets = _train_setup(h, 3, 300, dev)
        b = None
    before = ss.SIREN_STEP.launches
    check_rff_steps(cfg, tc, coords, targets, state, b, tier=CHEAP)
    assert ss.SIREN_STEP.launches == before + 3


@pytest.mark.parametrize("f", [0, 64], ids=["raw", "rff"])
@pytest.mark.parametrize("h", [64, 128, 256])
def test_cheap_tier_grad_kernel_matches_plain(dev, h, f):
    """E on the cheap tier on a tail shard (1000 rows, 700 real, a clip of
    2500) against ``grad_plain`` on the same tier."""
    cfg, _, bt, fs, coords, targets = shard_setup(h, f, 1000, dev)
    plan, gmode = ss.tier_plan(cfg, True, f > 0, CHEAP)
    assert gmode == "bf16" and set(plan.degrees) == {7}
    before = ss.SIREN_GRAD.launches
    check_grad_shard_ctrl(fs, coords, targets, _limit(700, dev), 2500, cfg,
                          plan, gmode, bt)
    assert ss.SIREN_GRAD.launches == before + 1


@pytest.mark.parametrize("f", [0, 64], ids=["raw", "rff"])
@pytest.mark.parametrize("h", [64, 128, 256])
def test_cheap_tier_backward_kernel_matches_plain(dev, h, f):
    """C with the cheap tier's plan (bf16x2 forward, degree 7) and bf16
    grads against ``backward_plain``, beside the 1-ulp control."""
    if f:
        cfg, params, _, bt = _rff_model(h, f, dev)
        params, d, k = stacked(params), 1, 1
    else:
        cfg = SirenSnakeTanhConfig(hidden_features=h, first_omega_0=1800.0)
        params, bt, d, k = _population(cfg, 3, dev), None, 1, 3
    plan, gmode = ss.tier_plan(cfg, True, f > 0, CHEAP)
    coords = torch.rand(1000, d, device=dev,
                        generator=torch.Generator(dev).manual_seed(2)) * 2 - 1
    cot = torch.randn(k, 1000, 1, device=dev,
                      generator=torch.Generator(dev).manual_seed(1))
    before = st.SIREN_BWD.launches
    check_rff_backward(params, cfg, plan, gmode, coords, cot, bt)
    assert st.SIREN_BWD.launches == before + 1


@pytest.mark.parametrize("f", [0, 64], ids=["raw", "rff"])
def test_tier_switch_mid_fit_is_a_fresh_full_step(dev, f):
    """Two cheap steps, then a full step, on one carry: the full step is
    bit-equal to a full step freshly built and run on a copy of the same
    carry (the flat state does not depend on the tier); repeat cheap
    steps are bit-equal."""
    if f:
        cfg, model, tc, state, coords, targets, b = _rff_train_setup(
            256, f, 1, 3000, dev)
    else:
        cfg, model, tc, state, coords, targets = _train_setup(256, 2, 3000,
                                                              dev)
        b = None
    n = coords.shape[0]
    build = lambda tier: ss.make_fused_mse_train_step(  # noqa: E731
        cfg, tc, n, approx_sin=True, rff_b=b, tier=tier)
    cheap, full = build(CHEAP), build(None)
    fs = ss.flat_state_from_train_state(state, cfg)
    for _ in range(2):
        fs, _ = cheap(fs, coords, targets)
    c1, (l1, _) = cheap(clone_state(fs), coords, targets)
    c2, (l2, _) = cheap(clone_state(fs), coords, targets)
    fresh, (lf, _) = build(None)(clone_state(fs), coords, targets)
    fs, (ls, _) = full(fs, coords, targets)
    torch.cuda.synchronize()
    assert torch.isfinite(fs.params).all()
    assert torch.equal(l1, l2) and all(torch.equal(p, q)
                                       for p, q in zip(c1, c2))
    assert torch.equal(ls, lf)
    assert all(torch.equal(p, q) for p, q in zip(fs, fresh))


# ---------------------------------------------------------------------------
# KAN forward (G) and backward (H)
# ---------------------------------------------------------------------------

# kernel vs plain, both in the bf16x3 or highest tier: the kernel sums
# each row's K = in * J products in its own order (sequential fmaf chains,
# or 16 at a time on the tensor cores), the plain version through cuBLAS,
# and expf differs from torch.exp by an ulp.  A layer output is bounded
# relative to its term scale, max over rows of sum_k |A_k| |W_k| (outputs
# that cancel to well below their terms carry the terms' rounding); a
# gradient relative to its largest |value|.  On the H100 at the runner
# shape over the full clip (chip_smoke.py phase 8): 2.7e-7 of the term
# scale with G's products as FMA chains, 1.09e-6 on the tensor cores;
# 7.7e-6 of max |dW|.
KAN_RTOL = 2e-5
KAN_GRAD_RTOL = 1e-4
# one-pass bf16 roundings of A flip with an ulp of silu or a basis: a
# wiring check only in the bf16 and bf16x2 tiers
KAN_BF16_RTOL = 1e-2
KAN_CONFIGS = [dict(layers_hidden=(1, 32, 32, 1)),
               dict(layers_hidden=(2, 16, 1)),
               dict(layers_hidden=(1, 16, 16, 16, 1)),
               dict(layers_hidden=(1, 16, 3)),
               dict(layers_hidden=(1, 16, 1), grid_size=8, spline_order=2),
               dict(layers_hidden=(2, 32, 3), grid_size=6, spline_order=2),
               dict(layers_hidden=(1, 256, 256, 1)),
               dict(layers_hidden=(512, 128, 128, 1)),
               # dout > 256: dW over several tensor-core column tiles, then
               # layer 1's dx on the tensor-core dx kernel
               dict(layers_hidden=(1, 320, 320, 1)),
               # the wide library (kan.cu with KAN_WIDE): grid extension's
               # sizes and orders up to 8; at J > 64 (grid 100) H's
               # tensor-core K tiles cut through features and dx runs on
               # the tensor-core dx kernel; G's builder and mma warps keep
               # a 256-column tile at every J
               dict(layers_hidden=(1, 16, 1), grid_size=20, spline_order=3),
               dict(layers_hidden=(1, 16, 1), grid_size=100, spline_order=3),
               dict(layers_hidden=(1, 16, 1), grid_size=5, spline_order=5),
               dict(layers_hidden=(1, 16, 1), grid_size=5, spline_order=8),
               dict(layers_hidden=(1, 64, 64, 1), grid_size=20,
                    spline_order=3),
               dict(layers_hidden=(1, 64, 64, 1), grid_size=100,
                    spline_order=8),
               # a narrow head of 5 outputs (8 held) at J = 104: the wide
               # narrow H's bins at their largest per feature
               dict(layers_hidden=(1, 64, 5), grid_size=100,
                    spline_order=3),
               # knots from update_grid: non-uniform, searched per row
               dict(layers_hidden=(1, 64, 64, 1), grid_size=20,
                    spline_order=3, refresh=True)]
KAN_IDS = ["x".join(map(str, c["layers_hidden"]))
           + f"-g{c.get('grid_size', 5)}o{c.get('spline_order', 3)}"
           + ("-refreshed" if c.get("refresh") else "")
           for c in KAN_CONFIGS]


def kan_config(cfg_kw) -> KANConfig:
    """The KANConfig of a KAN_CONFIGS entry (``refresh`` is the setup's)."""
    return KANConfig(**{k: v for k, v in cfg_kw.items() if k != "refresh"})


def check_kan(out: torch.Tensor, ref: torch.Tensor, rtol: float,
              scale: float | None = None) -> float:
    """Assert max |out - ref| <= rtol * scale (default max |ref|); returns
    the max abs difference."""
    assert out.shape == ref.shape
    assert torch.isfinite(out).all()
    worst = float((out - ref).abs().max())
    scale = float(ref.abs().max()) if scale is None else scale
    assert worst <= rtol * scale, (worst, rtol, scale)
    return worst


def kan_term_scale(x, grid, w_t, order) -> float:
    """max over rows of sum_k |A_k(x)| |W_k|: the scale of a layer output's
    terms."""
    a = kf._features_plain(x, grid, order).abs()
    return float((a @ w_t.abs().T).max())


def check_kan_outputs(layers, xs, out, xs_ref, ref, order, rtol=KAN_RTOL):
    """Every layer's output (the next layer's input, then the stack's)
    against the plain version's, each at its term scale; returns (the
    largest max abs difference, the largest ratio of one to its scale)."""
    worst, ratio = 0.0, 0.0
    for li, (grid, w_t) in enumerate(layers):
        o, r = ((xs[li + 1], xs_ref[li + 1]) if li + 1 < len(layers)
                else (out, ref))
        scale = kan_term_scale(xs_ref[li], grid, w_t, order)
        err = check_kan(o, r, rtol, scale)
        worst, ratio = max(worst, err), max(ratio, err / scale)
    return worst, ratio


def kan_setup(cfg_kw, n, dev, seed=0):
    """(layers [(grid, W^T)], coords (n, d), cotangent (n, out)) for a
    KAN drawn from ``seed``, coords a little past the grid range; with
    ``refresh`` the knots of every layer come from ``update_grid`` on a
    skewed sample (non-uniform)."""
    cfg = kan_config(cfg_kw)
    model = build_model("kan", cfg)
    params = model.init(torch.Generator().manual_seed(seed), dev)
    if cfg_kw.get("refresh"):
        skew = torch.linspace(-0.9, 1.0, 512, device=dev)[:, None] ** 3
        params = model.update_grid(params, skew.repeat(
            1, cfg.layers_hidden[0]))
    flat = [t.detach().contiguous() for t in kf.flatten_kan_params(params)]
    g = torch.Generator(dev).manual_seed(seed + 1)
    d, out = cfg.layers_hidden[0], cfg.layers_hidden[-1]
    coords = torch.rand(n, d, device=dev, generator=g) * 2.2 - 1.1
    cot = torch.randn(n, out, device=dev, generator=g) / n
    return list(zip(flat[0::2], flat[1::2])), coords, cot


def kan_fwd_routes(layers, mode) -> list[str]:
    """G's route of each layer (kf.fwd_plan) in the tier."""
    return [kf.fwd_plan(grid.shape[0], w_t.shape[0],
                        w_t.shape[1] // grid.shape[0], mode).route
            for grid, w_t in layers]


@pytest.mark.parametrize("cfg_kw", KAN_CONFIGS, ids=KAN_IDS)
def test_kan_kernels_match_plain(dev, cfg_kw):
    order = kan_config(cfg_kw).spline_order
    layers, coords, cot = kan_setup(cfg_kw, 3001, dev)
    # 3001 rows: a part tile on both routes (64 rows a tensor-core tile,
    # 256 a narrow CTA); every config has a tensor-core layer, and a head
    # with dout < 8 takes the narrow route
    heads = [w_t.shape[0] for _, w_t in layers]
    assert kan_fwd_routes(layers, "bf16x3") == [
        "tc" if d >= 8 else "narrow" for d in heads]
    out, xs = kf.KAN_FWD(layers, coords, order, "bf16x3")
    ref, xs_ref = kf.kan_forward_plain(layers, coords, order, "bf16x3")
    gk = kf.KAN_BWD(layers, xs_ref, cot, order, "bf16x3")
    gp = kf.kan_backward_plain(layers, xs_ref, cot, order, "bf16x3")
    torch.cuda.synchronize()
    check_kan_outputs(layers, xs, out, xs_ref, ref, order)
    for a, b in zip(gk, gp):
        check_kan(a, b, KAN_GRAD_RTOL)


@pytest.mark.parametrize("cfg_kw", KAN_CONFIGS, ids=KAN_IDS)
@pytest.mark.parametrize("mode", ["highest", "bf16x2", "bf16"])
def test_kan_kernels_every_tier(dev, mode, cfg_kw):
    order = kan_config(cfg_kw).spline_order
    layers, coords, cot = kan_setup(cfg_kw, 2000, dev)
    exact = mode == "highest"
    out, xs = kf.KAN_FWD(layers, coords, order, mode)
    ref, xs_ref = kf.kan_forward_plain(layers, coords, order, mode)
    gk = kf.KAN_BWD(layers, xs_ref, cot, order, mode)
    gp = kf.kan_backward_plain(layers, xs_ref, cot, order, mode)
    torch.cuda.synchronize()
    check_kan_outputs(layers, xs, out, xs_ref, ref, order,
                      KAN_RTOL if exact else KAN_BF16_RTOL)
    for a, b in zip(gk, gp):
        check_kan(a, b, KAN_GRAD_RTOL if exact else KAN_BF16_RTOL)


def test_kan_forward_is_deterministic(dev):
    """Two G calls from one input are bit-equal on both routes (no float
    atomics; every output element is summed by one thread or one mma
    fragment in a fixed order), including a layer of two column tiles."""
    for cfg_kw in (dict(layers_hidden=(1, 256, 256, 1)),
                   dict(layers_hidden=(1, 320, 320, 3))):
        layers, coords, _ = kan_setup(cfg_kw, 6000, dev)
        a, xa = kf.KAN_FWD(layers, coords, 3, "bf16x3")
        b, xb = kf.KAN_FWD(layers, coords, 3, "bf16x3")
        torch.cuda.synchronize()
        assert torch.equal(a, b)
        assert all(torch.equal(p, q) for p, q in zip(xa, xb))


def test_kan_forward_highest_keeps_the_fma_route(dev):
    """The highest tier's G is the FMA kernel (tile_gemm), exact f32
    products in k order; its C entry takes that tier only."""
    cfg_kw = dict(layers_hidden=(2, 32, 32, 3))
    layers, coords, _ = kan_setup(cfg_kw, 1000, dev)
    assert kan_fwd_routes(layers, "highest") == ["fma"] * 3
    out, xs = kf.KAN_FWD(layers, coords, 3, "highest")
    ref, xs_ref = kf.kan_forward_plain(layers, coords, 3, "highest")
    torch.cuda.synchronize()
    check_kan_outputs(layers, xs, out, xs_ref, ref, 3)
    lib = kf.KAN_LIBRARY()
    grid, w_t = layers[0]
    s = kf._layer_shape(coords, grid, w_t, 3, 0)
    plan = kf.fwd_plan(s.din, s.dout, s.J, "highest")
    stream = torch.cuda.current_stream().cuda_stream
    whi, wlo = kf._split(lib, w_t, s, kf._MODE_CODE["bf16x3"], stream,
                         rows=True)
    y = torch.empty((s.n, s.dout), device=dev)
    assert lib.kan_forward(coords.data_ptr(), grid.data_ptr(),
                           whi.data_ptr(), wlo.data_ptr(), y.data_ptr(),
                           s.n, s.din, s.dout, s.nk, 3,
                           kf._MODE_CODE["bf16x3"], plan.tile, plan.fc,
                           stream) != 0


def test_kan_backward_is_deterministic_and_budget_free(dev, monkeypatch):
    """Two H calls from one state are bit-equal, and so are calls whose dW
    slices go through a small scratch in several launch groups."""
    layers, coords, cot = kan_setup(dict(layers_hidden=(1, 256, 256, 1)),
                                    6000, dev)
    _, xs = kf.KAN_FWD(layers, coords, 3, "bf16x3")
    a = kf.KAN_BWD(layers, xs, cot, 3, "bf16x3")
    b = kf.KAN_BWD(layers, xs, cot, 3, "bf16x3")
    plan = kf.dw_plan(6000, 256, 256, 9)
    assert plan.slices >= 4 and kf.dw_group(plan, 256, 256 * 9) == \
        plan.slices
    monkeypatch.setattr(kf, "SCRATCH_BYTES", 3 * 4 * 256 * 256 * 9)
    assert kf.dw_group(plan, 256, 256 * 9) == 3
    c = kf.KAN_BWD(layers, xs, cot, 3, "bf16x3")
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)


# H's tensor-core pass with dx fused (kan_bwd_ws_kernel), one layer (din,
# dout, grid_size, order, n): the runner's layer 1 over a row count that is
# no multiple of the 32-row chunk; the wide build's grid 20 / order 3 (J
# 24) and grid 5 / order 8 (J 14); rows so few that a slice is shorter than
# one chunk (one slice of 20 rows; four slices, the last of 4 rows); 8
# outputs (a 32-column tile)
KAN_WS_CASES = [(256, 256, 5, 3, 30_011), (64, 256, 20, 3, 9_001),
                (48, 256, 5, 8, 9_001), (256, 256, 5, 3, 20),
                (256, 256, 5, 3, 100), (24, 8, 5, 3, 3_001)]
KAN_WS_IDS = [f"{di}x{do}-g{g}o{o}-n{n}" for di, do, g, o, n in KAN_WS_CASES]
# bits_digest of (dW, dx) of each case in each bf16 tier, and of the
# runner's layer 1 over 6,000 rows in three launch groups (bf16x3).
# Recorded on an NVIDIA H100 80GB HBM3 from the build of commit 6c2a33b,
# where every one was bit-equal to the design the builder warps replaced
# (one role of warps running each chunk's GX, build and dW in series).
KAN_WS_DIGESTS = {
    ("256x256-g5o3-n30011", "bf16"):
        "1a056a8db9b89ce34a23615f918724bad7b65c4e90ff9fb0a410dbed2d37ecb7",
    ("256x256-g5o3-n30011", "bf16x2"):
        "3679799b68f70af143f4ed66bf5d48e94e736e453474d8cdf164b88b9127363e",
    ("256x256-g5o3-n30011", "bf16x3"):
        "3183e7468c74f8d084e4bd75da54407c182f909969dfe565a0df091aa3748285",
    ("64x256-g20o3-n9001", "bf16"):
        "d2d1af2c89a7ba02a0295f7bd5bc62e91949a7571e697e8b4e09419315af57f3",
    ("64x256-g20o3-n9001", "bf16x2"):
        "6302921c6881c4e5767fd5dfbee24bba159442b89bf66be78676b5edb43d660e",
    ("64x256-g20o3-n9001", "bf16x3"):
        "08ef0db07cad0f917c77de81be7a357bc9ed2a7571c0fb8fccbeb081049bea90",
    ("48x256-g5o8-n9001", "bf16"):
        "8e7d3d4f635739b9df6f4ca068781098cce590429cbca5c54ef1a32f3419d9e8",
    ("48x256-g5o8-n9001", "bf16x2"):
        "3ba2f592cccd77b95412074dea02743c95f9a1b549176d90d51b80b241ac935a",
    ("48x256-g5o8-n9001", "bf16x3"):
        "8e95dae0762e2786d9aecb1613e8339e77c0d215a3217d7842dc97d420c2f5c8",
    ("256x256-g5o3-n20", "bf16"):
        "869cd3f852687a8c740b91f26817dec1992c99903ccab114698638801ac7a8a3",
    ("256x256-g5o3-n20", "bf16x2"):
        "a52679d34e7693b8069b09a25e3c7efa86502ff60f8a59c5db3925b5842dfb01",
    ("256x256-g5o3-n20", "bf16x3"):
        "6914fb6d9b09bf5859d96f381f21ca6957d8133280ff5106aa78e4d216b35733",
    ("256x256-g5o3-n100", "bf16"):
        "610d0a2aaecdd0ef62c6de329a7966e715eef819d2ec056a6d77e8bfc260a37a",
    ("256x256-g5o3-n100", "bf16x2"):
        "3add3ed5f1a1ac561742abc0203f32a9d0d2ee5613317410d0a12b4095953569",
    ("256x256-g5o3-n100", "bf16x3"):
        "15609906e8df156745b57510403c1adef4d6165f9f4bd6b0c8a2894341cda96d",
    ("24x8-g5o3-n3001", "bf16"):
        "74503c96c82aac4b77da0e75009fa29dd7fee37f38749f76c5d20e4b83e55c3b",
    ("24x8-g5o3-n3001", "bf16x2"):
        "7200544cf7998c0bbd5c2baa03f8f2df15777ade94f72ad536b0efca54e8a98b",
    ("24x8-g5o3-n3001", "bf16x3"):
        "0e8048dba6f469fb604ac5bcf2773a64d8fcf5be388c31d1d7ee5b25e2745495",
}
KAN_WS_GROUPS_DIGEST = (
    "e749e70b55830059cd63cd5768762dfaa0ac437f5b0badb56cb207d5faec495b")


def kan_ws_layer(din, dout, grid_size, order, n, mode, dev):
    """One layer of KAN_WS_CASES (inputs uniform over the knots, every
    third row past them) with its cotangent: (args of
    ``kf.layer_backward`` before the stream, its dW plan)."""
    grid, w_t, x = kan_wide_layer(din, dout, grid_size, order, n, "outside",
                                  dev)
    g = torch.randn((n, dout), device=dev,
                    generator=torch.Generator(dev).manual_seed(7)) / n
    s = kf._layer_shape(x, grid, w_t, order, 1)
    plan = kf.dw_plan(s.n, s.din, s.dout, s.J, mode, s.ks, s.wide)
    assert kf.bwd_pass(plan, kf.dx_fused(dout, mode, s.J)) == "ws"
    return (x, grid, g, w_t, s, order, mode), plan


def kan_ws_backward(args, dev):
    """One layer's H on the route: ((dW, dx), its count of
    ``kan_bwd.launches.ws``), both finite."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    launches = counter("kan_bwd.launches.ws")
    before = launches.value
    got = kf.layer_backward(kf.kan_library(args[5], args[4].nk)(), *args,
                            stream, need_dx=True)
    counted = launches.value - before
    torch.cuda.synchronize()
    assert all(torch.isfinite(t).all() for t in got)
    return got, counted


@pytest.mark.parametrize("mode", ["bf16", "bf16x2", "bf16x3"])
@pytest.mark.parametrize("din,dout,grid_size,order,n", KAN_WS_CASES,
                         ids=KAN_WS_IDS)
def test_kan_fused_pass_matches_recorded_bits(dev, mode, din, dout,
                                              grid_size, order, n):
    """The fused pass's builder and product warps give dW and dx whose
    digest is the one recorded above in every bf16 tier, and count one
    launch a layer call."""
    args, plan = kan_ws_layer(din, dout, grid_size, order, n, mode, dev)
    assert kf.dw_group(plan, dout, args[4].K) == plan.slices
    got, counted = kan_ws_backward(args, dev)
    assert counted == 1
    case = f"{din}x{dout}-g{grid_size}o{order}-n{n}"
    assert bits_digest(got) == KAN_WS_DIGESTS[case, mode]


def test_kan_fused_pass_in_launch_groups(dev, monkeypatch):
    """More slices than the scratch holds: the fused pass in three launch
    groups, bit-equal to itself in one group and to the digest recorded
    above, one count a launch."""
    args, plan = kan_ws_layer(256, 256, 5, 3, 6_000, "bf16x3", dev)
    whole, _ = kan_ws_backward(args, dev)
    K = args[4].K
    monkeypatch.setattr(kf, "SCRATCH_BYTES", 3 * 4 * 256 * K)
    assert kf.dw_group(plan, 256, K) == 3 and plan.slices > 6
    parts, counted = kan_ws_backward(args, dev)
    assert counted == -(-plan.slices // 3)
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(whole, parts))
    assert bits_digest(parts) == KAN_WS_GROUPS_DIGEST


def test_kan_autograd_counts_launches(dev):
    cfg = KANConfig(layers_hidden=(1, 32, 32, 1))
    model = build_model("kan", cfg, fused=True)
    params = model.init(torch.Generator().manual_seed(0), dev)
    leaves = [v.requires_grad_(True) for p in params["layers"]
              for v in p.values()]
    coords = torch.linspace(-1, 1, 500, device=dev)[:, None]
    f0, b0 = kf.KAN_FWD.launches, kf.KAN_BWD.launches
    loss = torch.mean(model.apply(params, coords) ** 2)
    grads = torch.autograd.grad(loss, leaves)
    assert kf.KAN_FWD.launches == f0 + 1 and kf.KAN_BWD.launches == b0 + 1
    names = [k for p in params["layers"] for k in p]
    for name, gr in zip(names, grads):
        assert torch.isfinite(gr).all()
        assert (not gr.any()) if name == "grid" else bool(gr.any())
    with torch.no_grad():
        model.apply(params, coords)
    assert kf.KAN_FWD.launches == f0 + 2


def test_kan_kernels_validate(dev):
    layers, coords, cot = kan_setup(dict(layers_hidden=(1, 16, 1)), 100, dev)
    before = kf.KAN_FWD.launches
    # past the kernels' bound (orders 1..8)
    with pytest.raises(ValueError, match="spline_order"):
        kf.KAN_FWD(layers, coords, 9, "bf16x3")
    with pytest.raises(ValueError, match="is on"):
        kf.KAN_FWD(layers, coords.cpu(), 3, "bf16x3")
    assert kf.KAN_FWD.launches == before


@pytest.mark.parametrize("cfg_kw", [
    dict(layers_hidden=(1, 64, 64, 1), grid_size=100),
    dict(layers_hidden=(1, 64, 64, 1), grid_size=5, spline_order=8),
    dict(layers_hidden=(1, 64, 320, 1), grid_size=20),
    dict(layers_hidden=(1, 48, 256, 1), grid_size=5, spline_order=5)],
    ids=["64-g100o3", "64-g5o8", "320-g20o3", "256-g5o5"])
def test_kan_wide_kernels_are_deterministic(dev, cfg_kw):
    """The wide library's G and H, repeated from one state, bit-equal: at
    grid 100 (H's K tiles cut through features, its dx on the tensor-core
    dx kernel), at orders 5 and 8, and at 320 outputs (G's two column
    tiles, H's dx after its dW pass)."""
    order = kan_config(cfg_kw).spline_order
    layers, coords, cot = kan_setup(cfg_kw, 4000, dev)
    a, xa = kf.KAN_FWD(layers, coords, order, "bf16x3")
    b, xb = kf.KAN_FWD(layers, coords, order, "bf16x3")
    ga = kf.KAN_BWD(layers, xa, cot, order, "bf16x3")
    gb = kf.KAN_BWD(layers, xa, cot, order, "bf16x3")
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert all(torch.equal(p, q) for p, q in zip(xa, xb))
    assert all(torch.equal(p, q) for p, q in zip(ga, gb))


# the wide build's tensor-core G at grid extension's J (grid / order): 24,
# 104, 11 and 14
KAN_WIDE_G = [(20, 3), (100, 3), (5, 5), (5, 8)]
KAN_WIDE_G_IDS = [f"g{g}o{o}" for g, o in KAN_WIDE_G]


def kan_wide_layer(din, dout, grid_size, order, n, inputs, dev, seed=0):
    """One wide layer's (grid, W^T) drawn from ``seed`` and n inputs:
    'smooth' (each feature a smooth function of the row, as a hidden
    layer's inputs along a clip: most k16 blocks of a 64-row tile are
    zero and skipped), 'random' (uniform over the knots: none is skipped)
    or 'outside' (every third row past the knots: interval -1, silu
    alone)."""
    cfg = KANConfig(layers_hidden=(din, dout), grid_size=grid_size,
                    spline_order=order)
    params = build_model("kan", cfg).init(torch.Generator().manual_seed(seed),
                                          dev)
    grid, w_t = [t.detach().contiguous()
                 for t in kf.flatten_kan_params(params)]
    g = torch.Generator(dev).manual_seed(seed + 1)
    if inputs == "smooth":
        t = torch.linspace(-1, 1, n, device=dev)[:, None]
        phase = torch.rand(1, din, device=dev, generator=g) * 6
        x = 0.9 * torch.sin(2.1 * t + phase)
    else:
        x = torch.rand(n, din, device=dev, generator=g) * 2.2 - 1.1
        if inputs == "outside":
            x[::3] *= 5.0
    return grid, w_t, x.contiguous()


@pytest.mark.parametrize("inputs", ["smooth", "random", "outside"])
@pytest.mark.parametrize("dout", [8, 64, 256, 320])
@pytest.mark.parametrize("grid_size,order", KAN_WIDE_G, ids=KAN_WIDE_G_IDS)
def test_kan_wide_forward_matches_plain(dev, grid_size, order, dout,
                                        inputs):
    """The wide build's tensor-core G (builder warps, W streamed in k16
    blocks, the blocks zero in every row of a tile skipped, a 256-column
    tile: two at 320 outputs) against the plain version on 3001 rows (a
    part tile), at the layer's term scale; a repeat bit-equal."""
    grid, w_t, x = kan_wide_layer(24, dout, grid_size, order, 3001, inputs,
                                  dev)
    nk = grid.shape[1]
    plan = kf.fwd_plan(24, dout, nk - order, "bf16x3", nk, wide=True)
    assert plan.route == "tc" and plan.tile == min(256, max(64, dout))
    out, xs = kf.KAN_FWD([(grid, w_t)], x, order, "bf16x3")
    ref, xs_ref = kf.kan_forward_plain([(grid, w_t)], x, order, "bf16x3")
    again, _ = kf.KAN_FWD([(grid, w_t)], x, order, "bf16x3")
    torch.cuda.synchronize()
    check_kan_outputs([(grid, w_t)], xs, out, xs_ref, ref, order)
    assert torch.equal(out, again)


# bits_digest of the wide build's tensor-core G output at one tile and
# chunk of features (24 -> 64, 3001 rows) for each KAN_WIDE_G config and
# input kind.  Recorded on an NVIDIA H100 80GB HBM3 from the build of
# commit 6c2a33b, where each was bit-equal to the chunked design built wide
# (the default build's G, one role of warps, chunks of whole features).
KAN_WIDE_G_DIGESTS = {
    ("g20o3", "smooth"):
        "c8c1aaa7848461ea712ab4909059d3e10ce94810f52f9a0b7f3fb68dda9961ab",
    ("g20o3", "random"):
        "fd0e886dc7ee80fceaa7f50c2e791b1a3228d9df4e5039783ad19197044c831c",
    ("g100o3", "smooth"):
        "b50f91dcbccbec21c8466cdde29ff00dd50e0a058f21f806ceb29d02c6a13353",
    ("g100o3", "random"):
        "d6887c233340a5a15d4d3a695089d3cd7b88ad9c19f471886de07f46dadd1279",
    ("g5o5", "smooth"):
        "5a45e92715f3add6cb4bf73d8b04bb1dc9d3237f1f9f40a77772e18df3ab7fac",
    ("g5o5", "random"):
        "96b8b71ab77522fc295c813e6c43d6c7ab3bfc26f22d9cf6f3505344ca653b39",
    ("g5o8", "smooth"):
        "7b671a2b57b6c3e9f38fbcca3d5352eeb974513a1678c6a984092f09c67f78a5",
    ("g5o8", "random"):
        "918bc4258e20cf787381559194409e1e134d1ebfec8071d130ff68c62c6be67c",
}


@pytest.mark.parametrize("inputs", ["smooth", "random"])
@pytest.mark.parametrize("grid_size,order", KAN_WIDE_G, ids=KAN_WIDE_G_IDS)
def test_kan_wide_forward_matches_recorded_bits(dev, grid_size, order,
                                                inputs):
    """At one tile and chunk of features (the default build's plan of the
    layer), the wide build's tensor-core G gives the outputs whose digest
    is recorded above: the same bases, the same k16 blocks in the same
    order, the skipped ones zero in every row."""
    grid, w_t, x = kan_wide_layer(24, 64, grid_size, order, 3001, inputs,
                                  dev)
    nk = grid.shape[1]
    plan = kf.fwd_plan(24, 64, nk - order, "bf16x3", nk)
    s = kf._layer_shape(x, grid, w_t, order, 0)
    lib = kf.kan_library(order, nk)()
    code = kf._MODE_CODE["bf16x3"]
    stream = torch.cuda.current_stream().cuda_stream
    whi, wlo = kf.split_w_bf16(lib, w_t, s, 64, code, stream)
    y = torch.full((s.n, s.dout), float("nan"), device=dev)
    assert lib.kan_forward_tc(
        x.data_ptr(), grid.data_ptr(), whi.data_ptr(), wlo.data_ptr(), 64,
        y.data_ptr(), s.n, s.din, s.dout, s.nk, order, code, plan.tile,
        plan.fc, stream) == 0
    torch.cuda.synchronize()
    assert bits_digest([y]) == KAN_WIDE_G_DIGESTS[f"g{grid_size}o{order}",
                                                  inputs]


@pytest.mark.parametrize("grid_size,order", KAN_WIDE_G, ids=KAN_WIDE_G_IDS)
def test_kan_wide_forward_rows_are_independent(dev, grid_size, order):
    """A row's G output does not depend on the other rows of its 64-row
    tile: the k16 blocks skipped are zero in every row, so changing one
    row's input (here moving it to another knot interval, which marks
    other blocks) leaves every other row of the tile bit-equal."""
    grid, w_t, x = kan_wide_layer(48, 256, grid_size, order, 1000, "smooth",
                                  dev)
    a, _ = kf.KAN_FWD([(grid, w_t)], x, order, "bf16x3")
    x2 = x.clone()
    x2[70] = 0.37 - 0.9 * x2[70]   # row 70 of the tile of rows 64..127
    b, _ = kf.KAN_FWD([(grid, w_t)], x2, order, "bf16x3")
    torch.cuda.synchronize()
    keep = torch.ones(1000, dtype=torch.bool, device=dev)
    keep[70] = False
    assert torch.equal(a[keep], b[keep])
    assert not torch.equal(a[70], b[70])


@pytest.mark.parametrize("mode", ["bf16x3", "bf16x2", "bf16"])
@pytest.mark.parametrize("cfg_kw", [
    dict(layers_hidden=(1, 256, 256, 1)),
    dict(layers_hidden=(1, 64, 64, 1), grid_size=20),
    dict(layers_hidden=(1, 48, 40, 1), grid_size=5, spline_order=8)],
    ids=["256-g5o3", "64-g20o3", "40-g5o8"])
def test_kan_dx_tc_matches_the_fused_dx(dev, mode, cfg_kw):
    """The tensor-core dx kernel (kan_dx_tc_kernel, run past J = 64 and
    dout = 256) forms GX from the same bf16 planes in the same order as
    the dW pass's fused dx, and contracts it with the same window: where
    both take a layer (J <= 64, dout <= 256) their dx are bit-equal, at 64
    and at 32 rows a CTA, with several row tiles a CTA (the persistent
    grid has one CTA an SM)."""
    cfg = kan_config(cfg_kw)
    order = cfg.spline_order
    layers, coords, _ = kan_setup(cfg_kw, 12001, dev)
    _, xs = kf.KAN_FWD(layers, coords, order, mode)
    grid, w_t = layers[1]
    x = xs[1]
    s = kf._layer_shape(x, grid, w_t, order, 1)
    g = torch.randn(s.n, s.dout, device=dev,
                    generator=torch.Generator(dev).manual_seed(9)) / s.n
    lib = kf.kan_library(order, s.nk)()
    stream = torch.cuda.current_stream().cuda_stream
    assert kf.dx_fused(s.dout, mode, s.J)
    _, fused = kf.layer_backward(lib, x, grid, g, w_t, s, order, mode,
                                 stream, need_dx=True)
    plan = kf.dw_plan(s.n, s.din, s.dout, s.J, mode, s.ks, s.wide)
    code = kf._MODE_CODE[mode]
    ghi, glo = kf.split_g(lib, g, s, plan, stream)
    whi, wlo = kf.split_w_bf16(lib, w_t, s, ghi.shape[1], code, stream)
    xp = kf.dx_plan(s.din, s.dout, s.J, mode, s.ks)
    assert xp.route == "tc" and xp.tm == 64
    for tm, fc, nc in ((64, xp.fc, xp.inner),
                       (32, 1, -(-s.J // 32) * 32)):
        dx = torch.full_like(fused, float("nan"))
        assert lib.kan_dx_tc(
            x.data_ptr(), grid.data_ptr(), ghi.data_ptr(), glo.data_ptr(),
            whi.data_ptr(), wlo.data_ptr(), ghi.shape[1], dx.data_ptr(),
            s.n, s.din, s.dout, s.nk, order, code, tm, fc, nc, stream) == 0
        torch.cuda.synchronize()
        assert torch.equal(dx, fused), (tm, float((dx - fused).abs().max()))


# The narrow H (dout < 8): the runner's head (256 -> 1, grid 5 / order 3)
# over 30,011 rows (every third row past the knots); 2, 3 and 5 outputs of
# 64 features (2, 4 and 8 held); rows fewer than a slice's 8 row groups
# (one slice of 5 rows); the wide build's heads at J = 24, 14 and 104; the
# runner's head with one feature's knot row and inputs scaled by 2^-64,
# where every spacing fails den_ok and '/' forms that feature's values
KAN_NARROW_CASES = {
    "head-n30011": (256, 1, 5, 3, 30_011), "dout2": (64, 2, 5, 3, 5_001),
    "dout3": (64, 3, 5, 3, 5_001), "dout5": (64, 5, 5, 3, 5_001),
    "head-n5": (256, 1, 5, 3, 5), "g20o3": (256, 1, 20, 3, 9_001),
    "g5o8": (256, 1, 5, 8, 9_001), "g100o3": (256, 1, 100, 3, 9_001),
    "fallback": (256, 1, 5, 3, 9_001)}
# bits_digest of (dW, dx) of each case in each bf16 tier, recorded on an
# NVIDIA H100 80GB HBM3 from the build of commit 1445cb8, whose narrow H
# formed every A value of a (row, feature) by '/' and summed all J of them
# (the default build), or its non-zero ones into bins (the wide build)
KAN_NARROW_DIGESTS = {
    ("head-n30011", "bf16"):
        "f88afb31f3ece2fd6f96c0a429fb621a7bcbd60b8708ce2a8a6dfe0bc3078f73",
    ("head-n30011", "bf16x2"):
        "110dd7344ec94aa1fa8dfd212d06348ee4fe324d0018ff660c89f39199c0b402",
    ("head-n30011", "bf16x3"):
        "4a381fa20aa3da49ed7ebd0044357265fa70125f9e897594bdf0c329c22bd3fd",
    ("dout2", "bf16"):
        "96b1fd0b2de1b6f5b1c163b9839fdd1c10853de7949ff8fd28f5c475f0f574f3",
    ("dout2", "bf16x2"):
        "8b93943e561dcb1869b29cbe6a2ec23645d4bea4cf176584fad9167e01fb004b",
    ("dout2", "bf16x3"):
        "a7a1972d98ef9a7f444b80aceef1a4944f9f3205b1f16ee08a59876d43f58d44",
    ("dout3", "bf16"):
        "911fd37576ee4b3379b55889052410847154584d1f7e17368212622d6439d226",
    ("dout3", "bf16x2"):
        "fe807e79ebb7fcfc79e530110a517997e4fffbbd41415a1be127abdca95032da",
    ("dout3", "bf16x3"):
        "bc7999c3549bafa3ccfe3a76558042756e8d772c56d1315b338e7897b1cf4ae8",
    ("dout5", "bf16"):
        "4f0331d97801d46b7b472096e57baee4bf9896fe2ef43281edde57fe86c4b9b7",
    ("dout5", "bf16x2"):
        "054bfbf1e5fc5f610111a612207f6e2e364a932132d75f9445958a7b40bc5562",
    ("dout5", "bf16x3"):
        "57acca28b9d7f94ab05c12e6d6cdbc4d42c4ed7dddebfcc2173b3540f366090b",
    ("head-n5", "bf16"):
        "cebc51fc0bc64d2331766994b551d68441336837ca1fadd2ff61736a44984520",
    ("head-n5", "bf16x2"):
        "42f0005eb8e44a125d5b9ecd11b2069283aa4a18c9cd62a404a6c93d2d34fe1a",
    ("head-n5", "bf16x3"):
        "f790f8f6fda71f78d209eebd44f575f7ae831ed56a81963d8bdf61cbdd971933",
    ("g20o3", "bf16"):
        "cf99d4c8a4d51b57ebb76bf7326b0921c4e11de66fa0dc476e786e78b86472e0",
    ("g20o3", "bf16x2"):
        "3515b6d9441d30412146923d8763067af27eaaaf76b56d84f57198ae7f8b7a7d",
    ("g20o3", "bf16x3"):
        "baa5db8419e07dc82f8e1052ae56aee0af173e593482d1a5f1d1a3b6e71edf6f",
    ("g5o8", "bf16"):
        "e7ca62e44656c98cd7cc66b1539455536f249070d4011d47104ec117be2921c1",
    ("g5o8", "bf16x2"):
        "a3f99e8bba624901007998932216a31b69c1e81eb690b6a080a6eb72ff4ae2f6",
    ("g5o8", "bf16x3"):
        "5360e7b887dfa04fc37a2ca6d22f06f498c2a7cfb3fba12bdd96cad0e293aa9f",
    ("g100o3", "bf16"):
        "cf2b079cfd0fc110ffe5132314961de6d798b366e0bf488464dbe8ca8aae1758",
    ("g100o3", "bf16x2"):
        "f066ea5e6ab4e85d1b063451ae0dfee24d476bfcf8b3fe9940e473af4b039e70",
    ("g100o3", "bf16x3"):
        "828e43ea8cb06c816c56c0606322c17fa49ed6da1ce977db178374cbbe5b7e6a",
    ("fallback", "bf16"):
        "801e784b24248c56c0022473715e4d2410f8e41e7c0999da407feed2a0d3ca7c",
    ("fallback", "bf16x2"):
        "8b1b95c6eed0de8937a3bfa47c5951dd6eaf27a13a8d3df355eafd304a5e1e64",
    ("fallback", "bf16x3"):
        "a78e035eefb133767cb902a8a3487c2d339493a16808b4932904ef2a1755eda3",
}


def kan_narrow_layer(case, mode, dev):
    """One layer of KAN_NARROW_CASES with its cotangent: (args of
    ``kf.layer_backward`` before the stream, its dW plan)."""
    din, dout, grid_size, order, n = KAN_NARROW_CASES[case]
    grid, w_t, x = kan_wide_layer(din, dout, grid_size, order, n, "outside",
                                  dev)
    if case == "fallback":
        grid[0] *= 2.0 ** -64
        x[:, 0] *= 2.0 ** -64
    g = torch.randn((n, dout), device=dev,
                    generator=torch.Generator(dev).manual_seed(7)) / n
    s = kf._layer_shape(x, grid, w_t, order, 1)
    plan = kf.dw_plan(s.n, s.din, s.dout, s.J, mode, s.ks, s.wide)
    assert kf.bwd_pass(plan, kf.dx_fused(dout, mode, s.J)) == "narrow"
    return (x, grid, g, w_t, s, order, mode), plan


@pytest.mark.parametrize("mode", ["bf16", "bf16x2", "bf16x3"])
@pytest.mark.parametrize("case", list(KAN_NARROW_CASES))
def test_kan_narrow_pass_matches_recorded_bits(dev, case, mode, monkeypatch):
    """The narrow H gives dW and dx whose digest is the one recorded above
    in every bf16 tier, one launch a layer call on
    ``kan_bwd.launches.narrow``; at grid 5 / order 3, which both builds of
    kan.cu take, the wide build's too (its knot rows of 12 floats, and its
    CTAs' features from its own plan)."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    launches = counter("kan_bwd.launches.narrow")
    is_wide = kf.is_wide
    builds = [is_wide] + ([lambda o, nk: True]
                          if KAN_NARROW_CASES[case][2:4] == (5, 3) else [])
    for build in builds:
        monkeypatch.setattr(kf, "is_wide", build)
        args, plan = kan_narrow_layer(case, mode, dev)
        assert kf.dw_group(plan, args[4].dout, args[4].K) == plan.slices
        before = launches.value
        got = kf.layer_backward(kf.kan_library(args[5], args[4].nk)(), *args,
                                stream, need_dx=True)
        assert launches.value - before == 1
        torch.cuda.synchronize()
        assert all(torch.isfinite(t).all() for t in got)
        assert bits_digest(got) == KAN_NARROW_DIGESTS[case, mode], (
            case, mode, args[4].wide)


# ---------------------------------------------------------------------------
# A window population's other losses, and the whole-signal losses on a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["mae", "snr"])
def test_population_losses_run_a_and_c(dev, mode):
    """A window population's mae / snr step (``make_train_step``: every
    window's own loss) launches the stack kernel (A) once and kernel C
    once; its losses are those of the plain forward, and C on the step's
    own cotangent meets the grad tier's tolerance against its plain
    version."""
    from inraudio_tpu_torch.train.losses import mix_loss
    cfg = SirenSnakeTanhConfig(hidden_features=64, first_omega_0=115.0)
    model = build_model("mlp", cfg, fused=True, approx_sin=True)
    k, n = 6, 512
    tc = tloop.TrainConfig(loss_mode=mode, grad_clip_norm=1.0)
    state = tloop.init_train_state(model, torch.Generator().manual_seed(4),
                                   tc, dev, windows=k)
    coords = torch.linspace(-1, 1, n, device=dev)[:, None]
    freq = torch.arange(1, k + 1, device=dev, dtype=torch.float32)
    targets = (0.7 * torch.sin(3.1 * freq[:, None] * coords[None, :, 0])
               )[..., None]
    plan = sf.stack_plan(cfg, approx_sin=True)
    gmode = st.grad_dot_mode()
    ref = sf.stack_forward_plain(state.params, plan, coords)
    a0, c0 = sf.SIREN_STACK.launches, st.SIREN_BWD.launches
    step = tloop.make_train_step(model, tc)
    _, (loss, _) = step(state, coords, targets)
    torch.cuda.synchronize()
    assert sf.SIREN_STACK.launches == a0 + 1
    assert st.SIREN_BWD.launches == c0 + 1
    assert loss.shape == (k,)
    # the forward's bf16x3 sums against the plain version's (F32_ATOL a
    # sample): about 1e-5 relative in mae, 1e-4 dB in snr
    torch.testing.assert_close(loss, mix_loss(ref, targets, loss_mode=mode,
                                              windows=True),
                               rtol=1e-5, atol=1e-4)
    pred = st.fused_siren_train_apply(state.params, cfg, coords,
                                      approx_sin=True).detach()
    pred.requires_grad_(True)
    (cot,) = torch.autograd.grad(mix_loss(pred, targets, loss_mode=mode,
                                          windows=True).sum(), pred)
    out = st.flatten_params(st.SIREN_BWD(state.params, cfg, plan, gmode,
                                         coords, cot), cfg)
    exp = st.flatten_params(st.backward_plain(state.params, plan, gmode,
                                              coords, cot), cfg)
    torch.cuda.synchronize()
    check_grads(out, exp, gmode)


def test_sharded_snr_step_is_bit_equal_across_repeats(dev):
    """The snr fit on two thread ranks sharing the card (each gathers the
    whole clip's prediction; B forward and C backward on its shard, one
    all-reduce): both ranks' states and histories bit-equal, and a second
    run from the same state repeats the first bit for bit; B and C launch
    once a step on each rank."""
    cfg = SirenSnakeTanhConfig(hidden_features=64, first_omega_0=300.0)
    model = build_model("mlp", cfg, fused=True, approx_sin=True)
    n = 3001  # not a multiple of the ranks: one padded row
    x = torch.linspace(-1, 1, n)[:, None].numpy()
    y = (0.6 * np.sin(2 * np.pi * 5 * x)).astype(np.float32)
    tc = tloop.TrainConfig(total_steps=4, scan_chunk=2, loss_mode="snr",
                           alpha=0.0)
    state = tloop.init_train_state(model, torch.Generator().manual_seed(2),
                                   tc, dev)
    b0, c0 = sf.SIREN_STACK.launches, st.SIREN_BWD.launches
    runs = [run_thread_ranks(2, lambda m: tloop.fit(model, x, y, tc,
                                                    state=state, mesh=m),
                             device=dev) for _ in range(2)]
    torch.cuda.synchronize()
    assert sf.SIREN_STACK.launches - b0 == 2 * 2 * 4
    assert st.SIREN_BWD.launches - c0 == 2 * 2 * 4
    first = runs[0][0]
    assert np.isfinite(first.loss_history).all()
    for res in runs:
        for r in res:
            np.testing.assert_array_equal(r.loss_history,
                                          first.loss_history)
            for p, q in zip(tree_leaves(r.state), tree_leaves(first.state)):
                assert torch.equal(p, q)
