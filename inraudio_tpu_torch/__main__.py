"""CLI: ``python -m inraudio_tpu_torch fit|encode|decode|info ...``.

Port of the ``fit`` (the runner's ``train``, wave method, mse; the flags
it honours, with the JAX package's names), ``encode`` (per-window codec;
the modulated family and ``--target-bps`` are not ported yet), ``decode``
and ``info`` subcommands of ``inraudio_tpu``'s CLI, plus ``--device``
(default ``cuda``; it raises when there is no card rather than running on
the CPU).  ``fit-multi`` and multi-input decode are not ported yet.

``fit`` and ``encode`` run on several ranks under ``torchrun
--nproc-per-node N -m inraudio_tpu_torch ...``: ``fit`` shards the clip's
rows, ``encode`` its windows (``parallel.make_mesh``: NCCL when every rank
has a card of its own, gloo when ranks share one).  Only rank 0 writes the
outputs and prints the result line.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="inraudio_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    fit = sub.add_parser("fit", help="fit an INR to an audio file (wave "
                                     "method, mse)")
    fit.add_argument("--experiment-path", default="results")
    fit.add_argument("--tag", default="exp")
    fit.add_argument("--filename", required=True)
    fit.add_argument("--duration", type=float, default=10.0)
    fit.add_argument("--device", default="cuda",
                     help="torch device to train on (default cuda; 'cpu' "
                          "runs the plain PyTorch versions)")
    fit.add_argument("--arch", default="mlp", choices=["mlp", "kan"])
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
                              "int4"])
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

    dec = sub.add_parser("decode",
                         help="decode an INRA/npz payload back to wav")
    dec.add_argument("--input", required=True, help="payload path")
    dec.add_argument("--output", required=True, help="wav path")
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

    args = ap.parse_args(argv)
    if args.cmd == "fit":
        from .experiments import train
        kw = {k: v for k, v in vars(args).items()
              if k not in ("cmd", "experiment_path", "tag", "filename",
                           "duration")}
        ckpt = train(args.experiment_path, args.tag, args.filename,
                     args.duration, **kw)
        if ckpt is not None:  # rank 0
            print(json.dumps({"ckpt": ckpt}))
    elif args.cmd == "encode":
        import resource
        import time

        import numpy as np

        from .codec import (CodecConfig, compression_stats, decode, encode,
                            save_inr)
        from .data.audio_io import read_wav
        from .dsp import calculate_snr
        from .parallel import make_mesh
        fs, sig = read_wav(args.input,
                           channel=None if args.all_channels else 0)
        sig = sig.astype(np.float32)
        cfg = CodecConfig(
            chunk_seconds=args.chunk_s, overlap_fraction=args.overlap,
            hidden_features=args.hidden, first_omega_0=args.omega,
            learning_rate=args.learning_rate, total_steps=args.total_steps,
            quantize=None if args.quantize == "none" else args.quantize,
            per_row_scales=args.per_row_scales, fused=args.fused,
            refit_steps=args.refit_steps,
            max_chunks_per_batch=args.max_chunks or None,
            side_quantize={"auto": "auto", "on": True,
                           "off": False}[args.side_quantize],
            **({"plateau_patience": args.plateau_patience}
               if args.plateau_patience is not None else {}))
        mesh = make_mesh(args.device)
        t0 = time.time()
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
        from .codec import decode, decode_range, load_inr
        from .data.audio_io import write_wav
        if (args.start is None) != (args.stop is None):
            ap.error("--start and --stop must be given together")
        fused = {"auto": None, "on": True, "off": False}[args.fused]
        kb = args.max_chunks or None
        payload = load_inr(args.input)
        if args.start is not None:
            if args.upsample != 1:
                ap.error("--start/--stop do not compose with --upsample")
            fs, rec = decode_range(payload, args.start, args.stop,
                                   args.device, fused=fused,
                                   max_chunks_per_batch=kb)
        else:
            fs, rec = decode(payload, args.device, fused=fused,
                             upsample=args.upsample, max_chunks_per_batch=kb)
        write_wav(args.output, fs, rec)
        print(json.dumps({"path": args.output, "sample_rate": fs,
                          "samples": int(len(rec)), "device": args.device}))
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
            print(f"  codec: {m.get('codec', 'per-chunk')}  "
                  f"quantize: {m.get('quantize') or 'float32'}  "
                  f"model: h={mdl['hidden_features']} "
                  f"omega0={mdl['first_omega_0']}")
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
    return _shutdown()


def _shutdown() -> int:
    """Tear down the default process group a ``torchrun`` mesh set up."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
