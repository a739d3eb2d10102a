"""CLI: ``python -m inraudio_tpu_torch fit|encode|decode|info|fit-multi ...``.

Port of every subcommand of ``inraudio_tpu``'s CLI: ``fit`` (the runner's
``train``: the wave, mdct, fft and multi methods, every loss mode; the
flags it honours, with the JAX package's names), ``encode`` (both codec families: per-window, ``--modulated``, and
``--target-bps`` planning across them), ``decode`` (one payload, or several
through ``decode_many``), ``info`` and ``fit-multi`` (the multi-INR fit of
the headline recipe), plus ``--device`` (default ``cuda``; it raises when
there is no card rather than running on the CPU).

``fit``, the per-window ``encode`` and ``fit-multi`` run on several ranks
under ``torchrun --nproc-per-node N -m inraudio_tpu_torch ...``: ``fit``
shards the clip's rows, ``encode`` and ``fit-multi`` the windows
(``parallel.make_mesh``: NCCL when every rank has a card of its own, gloo
when ranks share one).  Only rank 0 writes the outputs and prints the
result line.  The modulated encode runs on one rank.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="inraudio_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    fit = sub.add_parser("fit", help="fit an INR to an audio file")
    fit.add_argument("--experiment-path", default="results")
    fit.add_argument("--tag", default="exp")
    fit.add_argument("--filename", required=True)
    fit.add_argument("--inst", default=None,
                     help="instrument name, recorded in parameters.json")
    fit.add_argument("--duration", type=float, default=10.0)
    fit.add_argument("--device", default="cuda",
                     help="torch device to train on (default cuda; 'cpu' "
                          "runs the plain PyTorch versions)")
    fit.add_argument("--method", default="wave",
                     choices=["wave", "mdct", "fft", "multi"])
    fit.add_argument("--arch", default="mlp", choices=["mlp", "kan"])
    fit.add_argument("--loss-mode", default="mse",
                     choices=["mse", "mae", "snr"])
    fit.add_argument("--alpha", type=float, default=0.0,
                     help="weight of the STFT loss term mixed into the "
                          "base loss")
    fit.add_argument("--multi-resolution-stft", action="store_true",
                     help="the STFT term at three resolutions (auraloss's "
                          "MultiResolutionSTFTLoss)")
    fit.add_argument("--n", type=int, default=2048,
                     help="MDCT frame length for method=mdct")
    fit.add_argument("--takelog", action="store_true",
                     help="method=mdct: fit the shifted log of the "
                          "coefficients")
    fit.add_argument("--n-fft", type=int, default=1024,
                     help="STFT size for method=fft")
    fit.add_argument("--highpass", action="store_true",
                     help="pre-filter for fft (100 Hz) / mdct (150 Hz) "
                          "targets")
    fit.add_argument("--perceptual-mask", action="store_true",
                     help="hearing-threshold loss weighting for "
                          "method=mdct (a per-row weight; the fused mlp "
                          "takes it in its whole-step kernel)")
    fit.add_argument("--adaptive", action="store_true",
                     help="block-switching STMDCT target for method=mdct")
    fit.add_argument("--num-channels", type=int, default=1,
                     help="channels for method=multi")
    fit.add_argument("--total-steps", type=int, default=20000)
    fit.add_argument("--learning-rate", type=float, default=1e-3)
    fit.add_argument("--min-learning-rate", type=float, default=1e-6)
    fit.add_argument("--num-sine", type=int, default=2)
    fit.add_argument("--num-snake", type=int, default=2)
    fit.add_argument("--num-tanh", type=int, default=0)
    fit.add_argument("--hidden", type=int, default=256)
    fit.add_argument("--omega", type=float, default=22000.0)
    fit.add_argument("--hidden-omega", type=float, default=30.0)
    fit.add_argument("--a-initial", type=float, default=0.5)
    fit.add_argument("--first-linear", action="store_true",
                     help="mlp: first layer Linear+Snake instead of a sine "
                          "layer")
    fit.add_argument("--no-last-linear", dest="last_linear",
                     action="store_false",
                     help="mlp: final layer a sine layer instead of a "
                          "linear head")
    fit.add_argument("--num-freq", type=int, default=None,
                     help="input encoding with this many frequencies")
    fit.add_argument("--sigma", type=float, default=10.0,
                     help="RFF projection scale")
    fit.add_argument("--encoding", default="rff", choices=["rff", "nerf"],
                     help="input featurisation used with --num-freq")
    fit.add_argument("--grad-clip-norm", type=float, default=0.0,
                     help="global-norm gradient clipping (0 = off)")
    fit.add_argument("--plateau-factor", type=float, default=0.8)
    fit.add_argument("--plateau-patience", type=int, default=200)
    fit.add_argument("--decimation", type=int, default=1)
    fit.add_argument("--bwe", action="store_true",
                     help="decode at the original rate (bandwidth "
                          "extension of a decimated fit)")
    fit.add_argument("--prev-ckpt-path", default=None)
    fit.add_argument("--seed", type=int, default=0)
    fit.add_argument("--fused", action="store_true",
                     help="train through the CUDA kernels: mlp (widths 32, "
                          "64, 128, 256; raw coordinates, or with --num-freq "
                          "its RFF encoding folded into layer 0) the stack "
                          "and whole-step kernels; kan the KAN forward and "
                          "backward kernels")
    fit.add_argument("--update-grid-every", type=int, default=0,
                     help="KAN data-adaptive grid refresh period in steps "
                          "(0 = never)")
    fit.add_argument("--scaled-first", action="store_true",
                     help="mlp: first layer a scaled sine layer (per-unit "
                          "omega linspace); unfused only")
    fit.add_argument("--no-plots", action="store_true",
                     help="write no PNGs (loss, spectrograms, waveform); "
                          "the plots need matplotlib")
    fit.add_argument("--visualization", action="store_true",
                     help="write landscape.png, the loss over a random "
                          "plane through the fitted parameters")
    fit.add_argument("--profile", action="store_true",
                     help="record a torch.profiler trace of one round of "
                          "the fit into <experiment>/trace/")

    enc = sub.add_parser(
        "encode", help="compress a wav into an INRA payload (multi-INR "
                       "codec; .npz output paths select the legacy "
                       "container)")
    enc.add_argument("--input", required=True)
    enc.add_argument("--output", required=True)
    enc.add_argument("--device", default="cuda",
                     help="torch device to train on (default cuda; 'cpu' "
                          "runs the plain PyTorch versions)")
    enc.add_argument("--chunk-s", type=float, default=0.25)
    enc.add_argument("--overlap", type=float, default=0.1)
    enc.add_argument("--hidden", type=int, default=128)
    enc.add_argument("--omega", type=float, default=1800.0)
    enc.add_argument("--learning-rate", type=float, default=7e-4)
    enc.add_argument("--total-steps", type=int, default=3000)
    enc.add_argument("--quantize", default="float16",
                     choices=["none", "float16", "bfloat16", "int8", "int16",
                              "int4", "auto"])
    enc.add_argument("--per-row-scales", action="store_true",
                     help="int modes: one quantization scale per (window, "
                          "output unit)")
    enc.add_argument("--fused", action="store_true",
                     help="train through the CUDA kernels (the whole-step "
                          "kernel, and the backward kernel in the refit) "
                          "with the polynomial sin; hidden width 32, 64, "
                          "128 or 256")
    enc.add_argument("--refit-steps", type=int, default=0,
                     help="quantization-aware refit: fine-tune the float32 "
                          "leaves around the frozen quantized weights")
    enc.add_argument("--max-chunks", type=int, default=0,
                     help="train the window population in batches of this "
                          "size (bounds device memory; 0 = all at once)")
    enc.add_argument("--all-channels", action="store_true",
                     help="encode every channel of a multichannel file as "
                          "one population; default keeps channel 0")
    enc.add_argument("--side-quantize", choices=["auto", "on", "off"],
                     default="auto",
                     help="float16 storage for the layers-1+ biases and "
                          "snake a: 'auto' only below ~70 dB estimated fit")
    enc.add_argument("--plateau-patience", type=int, default=None,
                     help="ReduceLROnPlateau patience in steps (default "
                          "200)")
    enc.add_argument("--seed", type=int, default=0,
                     help="seed of the initial parameters")
    enc.add_argument("--target-bps", type=float, default=None,
                     help="pick the calibrated operating point, per-window "
                          "or modulated, that fits this bits/sample budget "
                          "(the JAX package's tables, calibrated on a TPU). "
                          "It pins every calibrated knob; --total-steps, "
                          "--fused, --max-chunks, --seed and --device pass "
                          "through")
    enc.add_argument("--modulated", action="store_true",
                     help="shared-backbone codec: one network for the clip "
                          "and a modulation vector per window (--quantize "
                          "applies to the modulations: none, float16, int8, "
                          "int16 or auto; --refit-steps refits the backbone "
                          "around them)")
    enc.add_argument("--film-scale", action="store_true",
                     help="with --modulated: per-unit gains as well as "
                          "shifts")
    enc.add_argument("--mods-lr-mult", type=float, default=1.0,
                     help="with --modulated: the modulations' learning "
                          "rate as a multiple of the backbone's")
    enc.add_argument("--segment-s", type=float, default=None,
                     help="with --modulated: one backbone per this many "
                          "seconds instead of one for the clip")

    dec = sub.add_parser("decode",
                         help="decode an INRA/npz payload back to wav")
    dec.add_argument("--input", required=True, nargs="+",
                     help="payload path(s); several decode through "
                          "decode_many (compatible payloads' windows in one "
                          "stacked evaluation)")
    dec.add_argument("--output", required=True, nargs="+",
                     help="one wav path per input")
    dec.add_argument("--device", default="cuda",
                     help="torch device to decode on (default cuda; "
                          "'cpu' runs the plain PyTorch versions)")
    dec.add_argument("--fused", choices=["auto", "on", "off"], default="auto",
                     help="stack kernel: auto (when the payload was "
                          "fused-trained and the device is a card), on "
                          "(force it), off (force the exact apply)")
    dec.add_argument("--max-chunks", type=int, default=0,
                     help="decode the window population in batches of this "
                          "size (bounds device memory; 0 = all at once)")
    dec.add_argument("--upsample", type=int, default=1,
                     help="decode on an N-times denser grid")
    dec.add_argument("--start", type=float, default=None,
                     help="random-access decode: range start in seconds")
    dec.add_argument("--stop", type=float, default=None,
                     help="random-access decode: range stop in seconds")

    info = sub.add_parser("info", help="inspect a payload without decoding")
    info.add_argument("--input", required=True)
    info.add_argument("--json", action="store_true",
                      help="emit the full machine-readable record")

    fm = sub.add_parser(
        "fit-multi",
        help="multi-INR fit of a wav (the headline recipe): fit every "
             "window at once, stitch, report the SNR, write the "
             "reconstruction")
    fm.add_argument("--input", required=True)
    fm.add_argument("--output", required=True)
    fm.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; 'cpu' "
                         "runs the plain PyTorch versions)")
    fm.add_argument("--chunk-s", type=float, default=0.01161)
    fm.add_argument("--overlap", type=float, default=0.1)
    fm.add_argument("--hidden", type=int, default=128)
    fm.add_argument("--omega", type=float, default=115.0)
    fm.add_argument("--learning-rate", type=float, default=1e-3)
    fm.add_argument("--grad-clip", type=float, default=1.0)
    fm.add_argument("--total-steps", type=int, default=3000)
    fm.add_argument("--fused", action="store_true",
                    help="train through the whole-step kernel and decode "
                         "through the stack kernel, with the polynomial sin")
    fm.add_argument("--metrics", default=None,
                    help="stream one JSONL record a round to this path")
    fm.add_argument("--max-chunks", type=int, default=0,
                    help="train in batches of this many windows (bounds "
                         "device memory; 0 = all at once)")

    args = ap.parse_args(argv)
    if args.cmd == "fit":
        from .experiments import train
        kw = {k: v for k, v in vars(args).items()
              if k not in ("cmd", "experiment_path", "tag", "filename",
                           "duration", "no_plots")}
        kw["make_plots"] = not args.no_plots
        ckpt = train(args.experiment_path, args.tag, args.filename,
                     args.duration, **kw)
        if ckpt is not None:  # rank 0
            print(json.dumps({"ckpt": ckpt}))
    elif args.cmd == "encode":
        # flag conflicts fail before any file I/O or training
        if args.modulated:
            for flag, on in (("--target-bps", args.target_bps is not None),
                             ("--per-row-scales", args.per_row_scales),
                             ("--fused", args.fused),
                             ("--max-chunks", bool(args.max_chunks))):
                if on:
                    ap.error(f"{flag} does not apply to --modulated")
            if args.quantize in ("bfloat16", "int4"):
                ap.error("--modulated quantizes the modulations: use "
                         "none, float16, int8, int16 or auto")
            if args.refit_steps > 0 and args.quantize == "none":
                ap.error("--refit-steps with --modulated needs quantized "
                         "modulations (--quantize float16/int8/int16)")
        elif args.film_scale:
            ap.error("--film-scale requires --modulated")
        elif args.segment_s is not None:
            ap.error("--segment-s requires --modulated")
        elif args.mods_lr_mult != 1.0:
            ap.error("--mods-lr-mult requires --modulated")
        elif args.quantize == "auto":
            ap.error("--quantize auto requires --modulated (the fp16/int16 "
                     "switch is a modulation-tier rule)")
        import resource
        import time

        import numpy as np

        from .codec import (CodecConfig, ModulatedCodecConfig,
                            compression_stats, decode, encode,
                            encode_modulated, plan_for_bitrate, save_inr)
        from .data.audio_io import read_wav
        from .dsp import calculate_snr
        from .parallel import make_mesh
        fs, sig = read_wav(args.input,
                           channel=None if args.all_channels else 0)
        sig = sig.astype(np.float32)
        quantize = None if args.quantize == "none" else args.quantize
        patience = ({"plateau_patience": args.plateau_patience}
                    if args.plateau_patience is not None else {})
        kind = "modulated" if args.modulated else "per_chunk"
        if args.modulated:
            cfg = ModulatedCodecConfig(
                chunk_seconds=args.chunk_s, overlap_fraction=args.overlap,
                hidden_features=args.hidden, first_omega_0=args.omega,
                learning_rate=args.learning_rate,
                total_steps=args.total_steps, quantize_mods=quantize,
                film_scale=args.film_scale, mods_lr_mult=args.mods_lr_mult,
                segment_s=args.segment_s,
                # --refit-steps is the quantization-aware refit in both
                # families: the float leaves there, the backbone here
                refit_backbone_steps=args.refit_steps, seed=args.seed,
                **patience)
        else:
            cfg = CodecConfig(
                chunk_seconds=args.chunk_s, overlap_fraction=args.overlap,
                hidden_features=args.hidden, first_omega_0=args.omega,
                learning_rate=args.learning_rate,
                total_steps=args.total_steps, quantize=quantize,
                per_row_scales=args.per_row_scales, fused=args.fused,
                refit_steps=args.refit_steps,
                max_chunks_per_batch=args.max_chunks or None,
                side_quantize={"auto": "auto", "on": True,
                               "off": False}[args.side_quantize],
                seed=args.seed, **patience)
            if args.target_bps is not None:
                kind, cfg = plan_for_bitrate(
                    args.target_bps, sig.shape[0], fs,
                    channels=1 if sig.ndim == 1 else sig.shape[1], base=cfg,
                    mod_base=ModulatedCodecConfig(
                        total_steps=args.total_steps, seed=args.seed))
        mesh = make_mesh(args.device)
        t0 = time.time()
        if kind == "modulated":
            if mesh.size > 1:
                ap.error("the modulated encode runs on one rank")
            payload = encode_modulated(sig, fs, cfg, device=mesh.device)
        else:
            payload = encode(sig, fs, cfg, mesh=mesh)
        enc_s = time.time() - t0
        if mesh.rank != 0:
            return _shutdown()
        path = save_inr(args.output, payload)
        _, rec = decode(payload, mesh.device)
        stats = compression_stats(payload, path)
        stats["snr_db"] = round(float(calculate_snr(sig, rec)), 3)
        stats["path"] = path
        stats["codec"] = payload["meta"].get("codec", "per_chunk")
        stats["encode_s"] = round(enc_s, 2)
        stats["audio_s"] = round(len(sig) / fs, 3)
        stats["peak_host_rss_mb"] = round(resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1024, 1)
        print(json.dumps(stats))
    elif args.cmd == "decode":
        from .codec import decode, decode_many, decode_range, load_inr
        from .data.audio_io import write_wav
        if len(args.input) != len(args.output):
            ap.error("--input and --output must list the same number of "
                     "paths")
        if (args.start is None) != (args.stop is None):
            ap.error("--start and --stop must be given together")
        fused = {"auto": None, "on": True, "off": False}[args.fused]
        kb = args.max_chunks or None
        if args.start is not None:
            if args.upsample != 1:
                ap.error("--start/--stop do not compose with --upsample")
            if len(args.input) != 1:
                ap.error("--start/--stop decode one payload at a time")
            outs = [decode_range(load_inr(args.input[0]), args.start,
                                 args.stop, args.device, fused=fused,
                                 max_chunks_per_batch=kb)]
        elif len(args.input) == 1:
            outs = [decode(load_inr(args.input[0]), args.device, fused=fused,
                           upsample=args.upsample, max_chunks_per_batch=kb)]
        else:
            outs = decode_many([load_inr(p) for p in args.input],
                               args.device, fused=fused,
                               upsample=args.upsample,
                               max_chunks_per_batch=kb)
        for path, (fs, rec) in zip(args.output, outs):
            write_wav(path, fs, rec)
            print(json.dumps({"path": path, "sample_rate": fs,
                              "samples": int(len(rec)),
                              "device": args.device}))
    elif args.cmd == "info":
        from .codec import payload_info
        rec = payload_info(args.input)
        if args.json:
            print(json.dumps(rec))
        else:
            m = rec["meta"]
            mdl = m["model"]
            dur = m["signal_length"] / m["sample_rate"]
            print(f"{args.input}: {rec['container'].upper()} container, "
                  f"{rec['file_bytes']} bytes")
            line = (f"  codec: {m.get('codec', 'per-chunk')}  "
                    f"quantize: {m.get('quantize') or 'float32'}  "
                    f"model: h={mdl['hidden_features']} "
                    f"omega0={mdl['first_omega_0']}")
            if m.get("codec") == "modulated":
                line += (f"  segments: {m.get('num_segments', 1)}  "
                         f"mod_dim: {m['mod_dim']}")
            print(line)
            print(f"  signal: {dur:.2f}s @ {m['sample_rate']} Hz x "
                  f"{m.get('num_channels', 1)} ch, "
                  f"{m['num_chunks']} chunks of {m['chunk_length']} samples")
            print(f"  rate: {rec['bits_per_sample']:.2f} bits/sample "
                  f"({rec['ratio_vs_pcm16']:.2f}x vs 16-bit PCM)")
            for e in rec["leaves"]:
                shape = "x".join(str(s) for s in e["shape"])
                print(f"  {e['name']:>10} {e['dtype']:>8} {shape:>14} "
                      f"{e['enc']:>10} {e['stored_bytes']:>9} B "
                      f"({e['stored_bytes'] / max(e['raw_bytes'], 1):.2f} raw)")
    elif args.cmd == "fit-multi":
        import os

        import numpy as np

        from .data.audio_io import read_wav, write_wav
        from .dsp import calculate_snr
        from .models import SirenSnakeTanhConfig, build_model
        from .parallel import make_mesh
        from .train.loop import TrainConfig
        from .train.multi_inr import (MultiINRConfig, multi_inr_decode,
                                      multi_inr_fit)
        from .utils.observability import MetricsLogger
        fs, sig = read_wav(args.input, channel=0)
        sig = sig.astype(np.float32)
        model = build_model("mlp", SirenSnakeTanhConfig(
            first_omega_0=args.omega, hidden_features=args.hidden),
            fused=args.fused, approx_sin=args.fused)
        mesh = make_mesh(args.device)
        # every rank takes part in the round's gather; rank 0 writes
        metrics = (MetricsLogger(args.metrics if mesh.rank == 0
                                 else os.devnull)
                   if args.metrics else None)
        try:
            res = multi_inr_fit(
                model, sig, fs,
                MultiINRConfig(chunk_seconds=args.chunk_s,
                               overlap_fraction=args.overlap),
                TrainConfig(total_steps=args.total_steps,
                            learning_rate=args.learning_rate,
                            grad_clip_norm=args.grad_clip),
                max_chunks_per_batch=args.max_chunks or None, mesh=mesh,
                metrics=metrics)
        finally:
            if metrics is not None:
                metrics.close()
        if mesh.rank != 0:
            return _shutdown()
        rec = multi_inr_decode(model, res,
                               max_chunks_per_batch=args.max_chunks or None)
        write_wav(args.output, fs, rec)
        print(json.dumps({
            "path": args.output,
            "snr_db": round(float(calculate_snr(sig, rec)), 3),
            "num_chunks": res.num_chunks,
            "train_time_s": round(res.train_time_s, 2),
        }))
    return _shutdown()


def _shutdown() -> int:
    """Tear down the default process group a ``torchrun`` mesh set up."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
