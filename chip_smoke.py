#!/usr/bin/env python3
"""Smoke run of the PyTorch port's decode path on one NVIDIA card.

    python3 chip_smoke.py

Drives ``inraudio_tpu_torch`` (never JAX) through its user entry points at
the production width (SirenWithSnakeTanh, h=128, 2 sine + 2 snake layers,
random weights from a fixed torch.Generator seed) on two payloads built from
a synthesised 7 s, 44.1 kHz clip:

- headline shape: 512-row windows, overlap 0.1 (hop 461), k=669,
  omega0=115, float32 leaves, legacy npz container;
- codec default shape: 0.25 s windows (11,025 rows), k=31, omega0=1800,
  float16 weights, INRA container.

Phases, each of which fails the run:
0. build the CUDA kernel from csrc/ (nvcc), print ptxas's report;
1. per shape and per decode tier, the kernel against its plain PyTorch
   version on the card, max-abs within the stated tolerance;
2. serving: full decode, three decode_range seeks (must equal the full
   decode's slice), an upsample=2 decode and a CLI subprocess, with the
   kernel's launch count read around the in-process requests; the decode is
   checked against the exact apply on the card and against the CPU plain
   path on a small range;
3. the card-only pytest file (tests/test_torch_cuda.py);
4. timings with CUDA events: kernel vs plain, and the stitched decode.

Exits non-zero, printing no result, without CUDA or outside the repo.  The
last line is the JSON result; the line before it lists the kernels.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, "build", "chip_smoke")
SEED = 0
FS = 44100
CLIP_SAMPLES = 308_207
SHAPES = {
    "headline": dict(chunk_seconds=512 / FS, overlap=0.1, omega=115.0,
                     quantize=None, fit_snr_db=110.0, file="headline.npz",
                     expect=(512, 461, 669)),
    "codec_default": dict(chunk_seconds=0.25, overlap=0.1, omega=1800.0,
                          quantize="float16", fit_snr_db=60.0,
                          file="codec_default.inra",
                          expect=(11025, 9923, 31)),
}
# decode tiers selected through the header's fit_snr_db (auto_decode_kwargs
# adds 6 dB routing slack and a 9 dB margin)
TIER_FITS = {"bf16-deg7": 20.0, "mixed-bf16x2-deg7": 30.0, "deg9": 60.0,
             "deg11": 100.0, "exact": 130.0}


def log(*args):
    print(*args, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def synth_clip(np):
    """A 7 s clip: three partials plus a little noise, peak 0.8."""
    rng = np.random.default_rng(SEED)
    t = np.arange(CLIP_SAMPLES) / FS
    sig = (np.sin(2 * np.pi * 220.0 * t) + 0.5 * np.sin(2 * np.pi * 1330.0 * t)
           + 0.25 * np.sin(2 * np.pi * 5100.0 * t)
           + 0.05 * rng.standard_normal(CLIP_SAMPLES))
    return (0.8 * sig / np.max(np.abs(sig))).astype(np.float32)


def make_payload(name, spec, clip, torch, np, codec, build_model,
                 SirenSnakeTanhConfig, MultiINRConfig, chunk_signal):
    mcfg = MultiINRConfig(chunk_seconds=spec["chunk_seconds"],
                          overlap_fraction=spec["overlap"])
    chunks, n, hop = chunk_signal(clip, FS, mcfg)
    k = chunks.shape[0]
    if (n, hop, k) != spec["expect"]:
        raise AssertionError(f"{name}: windows (n, hop, k) = {(n, hop, k)}, "
                             f"expected {spec['expect']}")
    cfg = SirenSnakeTanhConfig(hidden_features=128, num_sine=2, num_snake=2,
                               first_omega_0=spec["omega"],
                               hidden_omega_0=30.0)
    g = torch.Generator().manual_seed(SEED)
    params = build_model("mlp", cfg).init(g, "cpu", windows=k)
    n_params = sum(v.numel() for layer in params["layers"]
                   for v in layer.values())
    if spec["quantize"]:
        params = codec.quantize_inr_params(params, spec["quantize"],
                                           side=True)
    meta = {"format": codec._FORMAT, "sample_rate": FS,
            "signal_length": CLIP_SAMPLES, "chunk_length": n, "hop": hop,
            "num_chunks": k, "num_channels": 1, "quantize": spec["quantize"],
            "per_row_scales": False,
            "side_quantized": bool(spec["quantize"]),
            "trained_forward": "fused_approx",
            "fit_snr_db": spec["fit_snr_db"],
            "model": {"hidden_features": 128, "num_sine": 2, "num_snake": 2,
                      "first_omega_0": spec["omega"],
                      "hidden_omega_0": 30.0}}
    scales = np.maximum(np.max(np.abs(chunks), axis=1), 1e-9)
    payload = {"meta": meta, "scales": scales.astype(np.float32),
               "params": params}
    t0 = time.perf_counter()
    path = codec.save_inr(os.path.join(WORK, spec["file"]), payload)
    t1 = time.perf_counter()
    loaded = codec.load_inr(path)
    t2 = time.perf_counter()
    log(f"payload {name}: k={k} n={n} hop={hop} omega0={spec['omega']} "
        f"quantize={spec['quantize']} params={n_params} "
        f"({n_params * 4 / 1e6:.1f} MB as float32) file="
        f"{os.path.getsize(path)} B save {t1 - t0:.2f} s load {t2 - t1:.2f} s")
    return path, loaded, cfg


def cuda_ms(torch, fn, iters):
    """Mean ms per call over ``iters`` calls after a warm-up, CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "inraudio_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (no "
              "inraudio_tpu_torch/ beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from inraudio_tpu_torch import codec
    from inraudio_tpu_torch.models import SirenSnakeTanhConfig, build_model
    from inraudio_tpu_torch.ops import siren_fused as sf
    from inraudio_tpu_torch.ops._nvcc import library_path
    from inraudio_tpu_torch.train.multi_inr import (MultiINRConfig,
                                                    chunk_eval_fn,
                                                    chunk_signal)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from test_torch_cuda import (BF16_BULK_ATOL, BF16_BULK_SHARE,
                                 BF16_MAX_ATOL, F32_ATOL, check_close)

    smi = nvidia_smi()
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    log(f"tf32 matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"float32 matmul precision {torch.get_float32_matmul_precision()}")
    dev = torch.device("cuda")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    # ---- phase 0: build ----
    t0 = time.perf_counter()
    sf.SIREN_STACK.library()
    build_s = time.perf_counter() - t0
    lib = library_path("siren_stack", ["siren_stack.cu"])
    report = (lib.parent / "build.log").read_text()
    log(f"build: siren_stack.cu -> {lib.relative_to(HERE)} in "
        f"{build_s:.1f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")

    clip = synth_clip(np)
    payloads = {}
    for name, spec in SHAPES.items():
        payloads[name] = make_payload(name, spec, clip, torch, np, codec,
                                      build_model, SirenSnakeTanhConfig,
                                      MultiINRConfig, chunk_signal)

    def tier_kwargs(tier, cfg):
        """The decode's tier for a header with TIER_FITS[tier] as fit."""
        return sf.auto_decode_kwargs(
            TIER_FITS[tier] + codec._FIT_EST_SLACK_DB,
            first_omega_0=cfg.first_omega_0)

    # ---- phase 1: kernel vs plain per tier, both shapes ----
    log(f"tolerances: f32 tiers max-abs <= {F32_ATOL}; bf16 tiers max-abs "
        f"<= {BF16_MAX_ATOL} and >= {BF16_BULK_SHARE:.0%} of outputs within "
        f"{BF16_BULK_ATOL}")
    errs = {}
    for name, (path, payload, cfg) in payloads.items():
        params = codec.dequantize_inr_params(payload["params"], dev)
        coords = torch.from_numpy(
            codec._decode_grid(payload["meta"]["chunk_length"], 1)).to(dev)
        for tier in TIER_FITS:
            kw = tier_kwargs(tier, cfg)
            out = sf.fused_siren_apply_stacked(params, cfg, coords, **kw)
            ref = sf.stack_forward_plain(params, sf.stack_plan(cfg, **kw),
                                         coords)
            torch.cuda.synchronize()
            err = check_close(out, ref, kw)
            errs[(name, tier)] = err
            log(f"phase1 {name} tier={tier} kwargs={kw} max_abs_err={err:.3e}"
                f" out_absmax={float(ref.abs().max()):.4f}")
        del params

    # ---- phase 2: serving through the entry points ----
    sf.SIREN_STACK.launches = 0
    served = {}
    for name, (path, payload, cfg) in payloads.items():
        served_tier = sf.auto_decode_kwargs(
            codec._routing_fit_snr(payload["meta"]),
            first_omega_0=cfg.first_omega_0)
        t0 = time.perf_counter()
        fs, full = codec.decode(payload, dev)
        t1 = time.perf_counter()
        if fs != FS or full.shape != (CLIP_SAMPLES,) or \
                not np.isfinite(full).all():
            raise AssertionError(f"{name}: bad full decode {fs} {full.shape}")
        seeks = ((0.5, 0.75), (3.0, 3.2), (6.9, 7.0))
        for a, b in seeks:
            _, part = codec.decode_range(payload, a, b, dev)
            if not np.array_equal(part, full[round(a * FS):round(b * FS)]):
                raise AssertionError(f"{name}: decode_range [{a}, {b}) != "
                                     "full decode slice")
        fs2, up = codec.decode(payload, dev, upsample=2)
        if fs2 != 2 * FS or up.shape != (2 * CLIP_SAMPLES,) or \
                not np.isfinite(up).all():
            raise AssertionError(f"{name}: bad upsample=2 decode")
        served[name] = full
        log(f"phase2 {name}: full decode {CLIP_SAMPLES} samples in "
            f"{(t1 - t0) * 1e3:.1f} ms (first call), 3 seeks equal to the "
            f"full slice, upsample=2 -> {up.shape[0]} samples, "
            f"tier={served_tier}")
    launches = sf.SIREN_STACK.launches
    log(f"phase2 kernel launches in the served requests: {launches}")
    if launches < 2 * 5:
        raise AssertionError(f"served decodes launched the kernel {launches}"
                             " times, expected at least 10")
    # the served output against the exact apply on the card, and against
    # the CPU plain path on a small range
    for name, (path, payload, cfg) in payloads.items():
        _, exact = codec.decode(payload, dev, fused=False)
        noise = float(np.mean((served[name] - exact) ** 2))
        snr = 10 * np.log10(float(np.mean(exact ** 2)) / max(noise, 1e-30))
        _, cpu = codec.decode_range(payload, 3.0, 3.01, "cpu", fused=True)
        cpu_err = float(np.max(np.abs(cpu - served[name][132300:132741])))
        log(f"phase2 {name}: kernel decode vs exact apply SNR {snr:.1f} dB; "
            f"vs CPU plain path on [3.0, 3.01) s max_abs_err {cpu_err:.3e}")
        if snr < 60.0 or cpu_err > F32_ATOL:
            raise AssertionError(f"{name}: served decode disagrees with "
                                 "its references")
    wav = os.path.join(WORK, "cli.wav")
    proc = subprocess.run(
        [sys.executable, "-m", "inraudio_tpu_torch", "decode", "--device",
         "cuda", "--input", payloads["codec_default"][0], "--output", wav],
        cwd=HERE, capture_output=True, text=True, timeout=300)
    log(f"phase2 CLI rc={proc.returncode} {proc.stdout.strip()}")
    if proc.returncode != 0:
        raise AssertionError(f"CLI decode failed:\n{proc.stderr}")
    from inraudio_tpu_torch.data import read_wav
    sr, data = read_wav(wav)
    if sr != FS or not np.array_equal(data, served["codec_default"]):
        raise AssertionError("CLI decode differs from the in-process decode")

    # ---- phase 3: card-only tests ----
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q",
         "-p", "no:cacheprovider", "-m", "cuda", "tests/test_torch_cuda.py"],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    log(f"phase3 pytest tests/test_torch_cuda.py rc={proc.returncode} "
        f"{tail[0]}")
    if proc.returncode != 0:
        raise AssertionError(f"card tests failed:\n{proc.stdout[-4000:]}")

    # ---- phase 4: timings ----
    timing = {}
    for name, (path, payload, cfg) in payloads.items():
        params = codec.dequantize_inr_params(payload["params"], dev)
        coords = torch.from_numpy(
            codec._decode_grid(payload["meta"]["chunk_length"], 1)).to(dev)
        samples = payload["meta"]["num_chunks"] * coords.shape[0]
        for tier in ("deg11", "exact"):
            kw = tier_kwargs(tier, cfg)
            plan = sf.stack_plan(cfg, **kw)
            ms = cuda_ms(torch, lambda: sf.fused_siren_apply_stacked(
                params, cfg, coords, **kw), 20)
            plain_ms = cuda_ms(torch, lambda: sf.stack_forward_plain(
                params, plan, coords), 20)
            ms2 = cuda_ms(torch, lambda: sf.fused_siren_apply_stacked(
                params, cfg, coords, **kw), 20)
            timing[(name, tier)] = (min(ms, ms2), plain_ms)
            log(f"phase4 {name} tier={tier}: kernel {ms:.3f}/{ms2:.3f} ms "
                f"({samples / min(ms, ms2) / 1e3:.1f} Msamples/s), plain "
                f"{plain_ms:.3f} ms ({samples / plain_ms / 1e3:.1f} "
                f"Msamples/s), {samples} window-samples")
        del params
        on_dev = codec.to_device(payload, dev)
        for label, pl in (("params resident", on_dev), ("from host", payload)):
            codec.decode(pl, dev)
            reps = 5
            t0 = time.perf_counter()
            for _ in range(reps):
                codec.decode(pl, dev)
            wall = (time.perf_counter() - t0) / reps
            log(f"phase4 {name} stitched decode ({label}): "
                f"{wall * 1e3:.2f} ms -> {CLIP_SAMPLES / wall / 1e6:.2f} "
                f"Msamples/s")
        # where a resident decode's wall time goes, layer by layer (host
        # clock, synchronised after each device step)
        parts = dict.fromkeys(("dequantize", "forward", "copy to host",
                               "stitch"), 0.0)
        reps = 5
        for _ in range(reps):
            t0 = time.perf_counter()
            meta, model, params = codec._payload_model_params(on_dev, None,
                                                              dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            coords = torch.from_numpy(
                codec._decode_grid(meta["chunk_length"], 1)).to(dev)
            out = chunk_eval_fn(model, coords,
                                codec._routing_fit_snr(meta))(params)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            host = out.cpu().numpy()
            t3 = time.perf_counter()
            codec._stitch_outs(on_dev, host, 1)
            t4 = time.perf_counter()
            for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                parts[key] += dt * 1e3 / reps
        log(f"phase4 {name} resident decode breakdown (ms): " + ", ".join(
            f"{k} {v:.2f}" for k, v in parts.items()))
        del on_dev, params, out

    shutil.rmtree(WORK, ignore_errors=True)
    ms, plain_ms = timing[("headline", "deg11")]
    kernels = {"kernels": [{
        "name": "siren_stack",
        "route": "cuda",
        "source": "inraudio_tpu_torch/csrc/siren_stack.cu",
        "replaces": "inraudio_tpu/ops/pallas_siren.py:428",
        "also_replaces": "inraudio_tpu/ops/pallas_siren.py:288",
        "launches": launches,
        "max_abs_err": max(errs.values()),
        "ms": ms,
        "plain_ms": plain_ms,
        "shape": "headline k=669 n=512 h=128, deg11 tier",
    }]}
    log(f"nvidia-smi: {nvidia_smi()}")
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
