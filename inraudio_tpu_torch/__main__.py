"""CLI: ``python -m inraudio_tpu_torch decode --input x.inra --output y.wav``.

Port of the ``decode`` and ``info`` subcommands of ``inraudio_tpu``'s CLI,
plus ``--device`` (default ``cuda``; it raises when there is no card rather
than running on the CPU).  ``encode``, ``fit``, ``fit-multi`` and
multi-input decode are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="inraudio_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

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
    if args.cmd == "decode":
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
