"""INR payload -> audio: the codec's decode half and its container (port of
``inraudio_tpu/codec.py``).

A payload is ``{"meta": dict, "scales": (k,) float32 numpy, "params":
tree}``: the header the JAX package writes (format ``inraudio_tpu.inr.v2``),
the per-window peak scales, and the stacked per-window parameters in the
JAX layout as CPU tensors (quantized leaves as stored).  Files written by
either package load in the other: the INRA container and the legacy
``.npz`` keep the JAX package's leaf order (dict keys sorted, as
``jax.tree_util`` flattens them) and its per-leaf codings.

``decode`` / ``decode_range`` dequantize on the target device, evaluate the
window population through the stack kernel (fused-trained payloads on a
card) or the exact apply, and overlap-add on the host.  Encoding is not
ported yet; the modulated codec family neither.
"""

from __future__ import annotations

import json
import lzma
import os
import zlib
from typing import Any

import numpy as np
import torch

from .data.coords import get_coord
from .models import (SirenSnakeTanhConfig, build_model, dequantize_params,
                     quantize_params)
from .models.siren import tensor_from_numpy
from .train.multi_inr import (batched_chunk_eval, chunk_eval_fn,
                              decode_chunk_range, stitch_chunks)
from .tree import tree_leaves, tree_map, tree_unflatten

# v2: layer-0 weights/biases stay float32 under quantization
_FORMAT = "inraudio_tpu.inr.v2"

# the side leaves (biases, snake a) of layers 1+ are stored at this tier
_SIDE_MODE = {"float16": "float16", "bfloat16": "bfloat16",
              "int8": "float16", "int16": "float16", "int4": "float16"}

# The header's fit_snr_db is an estimate, bounded to +-6 dB of the measured
# reconstruction by the JAX package's tests; routing inflates it by that
# bound so an underestimate cannot land a fit on a tier whose floor sits at
# its true quality.
_FIT_EST_SLACK_DB = 6.0


def _check_format(meta: dict[str, Any]) -> None:
    if meta.get("format") != _FORMAT:
        raise ValueError(
            f"unsupported payload format {meta.get('format')!r}: this build "
            f"reads {_FORMAT} only (older payloads must be re-encoded from "
            "the source audio)")


def _model_cfg_from_meta(meta: dict[str, Any]) -> SirenSnakeTanhConfig:
    """meta['model'] -> SirenSnakeTanhConfig."""
    m = meta["model"]
    return SirenSnakeTanhConfig(
        hidden_features=m["hidden_features"], num_sine=m["num_sine"],
        num_snake=m["num_snake"], first_omega_0=m["first_omega_0"],
        hidden_omega_0=m["hidden_omega_0"])


# ---------------------------------------------------------------------------
# Quantization of the stacked window parameters
# ---------------------------------------------------------------------------

def quantize_inr_params(params: Any, mode: str, per_row: bool = False,
                        side: bool = True) -> Any:
    """Sensitivity-aware quantization: layer 0 stays float32 (it sits
    inside sin(omega0 * .)), layers 1+ weights quantize at ``mode`` with
    per-window scales, and with ``side`` their biases and snake ``a`` are
    stored at ``_SIDE_MODE``.  Bit-identical to the JAX package."""
    out_layers = []
    for li, layer in enumerate(params["layers"]):
        new = dict(layer)
        if li > 0:
            new["w"] = quantize_params(layer["w"], mode,
                                       per_leading_axis=True, per_row=per_row)
        out_layers.append(new)
    out = {"layers": out_layers}
    return _quantize_sides(out, mode) if side else out


def _quantize_sides(params: Any, mode: str) -> Any:
    out_layers = []
    for li, layer in enumerate(params["layers"]):
        new = dict(layer)
        if li > 0:
            for k, v in layer.items():
                if k != "w" and not isinstance(v, dict):
                    new[k] = quantize_params(v, _SIDE_MODE[mode],
                                             per_leading_axis=True)
        out_layers.append(new)
    return {"layers": out_layers}


def dequantize_inr_params(params: Any,
                          device: torch.device | str | None = None) -> Any:
    """Inverse of ``quantize_inr_params`` -> float32 leaves on ``device``."""
    return dequantize_params(params, device)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _resolve_device(device: torch.device | str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev


def _routing_fit_snr(meta: dict[str, Any]) -> float | None:
    fit = meta.get("fit_snr_db")
    return None if fit is None else float(fit) + _FIT_EST_SLACK_DB


def _decode_grid(n0: int, u: int) -> np.ndarray:
    """Per-window decode grid; ``u`` > 1 subdivides the training grid
    (step 2/(n0-1)) u times, so every u-th sample sits on a training
    coordinate."""
    if u == 1:
        return np.asarray(get_coord(n0, dim=1), np.float32)
    j = np.arange(n0 * u, dtype=np.float64)
    return (-1.0 + 2.0 * j / (u * (n0 - 1)))[:, None].astype(np.float32)


def _stitch_outs(payload: dict[str, Any], outs: np.ndarray, upsample: int
                 ) -> tuple[int, np.ndarray]:
    """Scale + overlap-add one payload's raw (c*k, n, 1) window evals."""
    meta = payload["meta"]
    u = max(1, int(upsample))
    hop = meta["hop"] * u
    c = int(meta.get("num_channels", 1))
    k = meta["num_chunks"]
    outs = np.asarray(outs)[:, :, 0] * payload["scales"][:, None]
    length = meta["signal_length"] * u
    if c == 1:
        return meta["sample_rate"] * u, stitch_chunks(outs, hop, length)
    wav = np.stack([stitch_chunks(outs[j * k:(j + 1) * k], hop, length)
                    for j in range(c)], axis=1)
    return meta["sample_rate"] * u, wav


def _payload_model_params(payload: dict[str, Any], fused: bool | None,
                          device: torch.device):
    """Validate the header and rebuild (meta, model, float32 params on
    ``device``).

    ``fused=None`` routes through the stack kernel when the payload was
    trained under the fused forward (``trained_forward ==
    'fused_approx'``) and the device is a card; otherwise the exact apply.
    ``fused=True`` on the CPU runs the kernel's plain PyTorch version."""
    meta = payload["meta"]
    _check_format(meta)
    if meta.get("codec") == "modulated":
        raise NotImplementedError("the modulated codec is not ported yet")
    if fused is None:
        fused = (meta.get("trained_forward") == "fused_approx"
                 and device.type == "cuda")
    model = build_model("mlp", _model_cfg_from_meta(meta), fused=fused,
                        approx_sin=fused)
    return meta, model, dequantize_inr_params(payload["params"], device)


def decode(payload: dict[str, Any], device: torch.device | str,
           fused: bool | None = None, upsample: int = 1,
           max_chunks_per_batch: int | None = None) -> tuple[int, np.ndarray]:
    """Payload -> (sample_rate, waveform), evaluated on ``device``.

    ``upsample`` > 1 evaluates every window on a grid that many times
    denser (bandwidth-extension decode) and returns the upsampled rate.
    ``max_chunks_per_batch`` bounds device memory for long clips."""
    dev = _resolve_device(device)
    meta, model, params = _payload_model_params(payload, fused, dev)
    u = max(1, int(upsample))
    coords = torch.from_numpy(_decode_grid(meta["chunk_length"], u)).to(dev)
    fn = chunk_eval_fn(model, coords, _routing_fit_snr(meta))
    ck = int(meta.get("num_channels", 1)) * meta["num_chunks"]
    outs = batched_chunk_eval(fn, params, ck, max_chunks_per_batch)
    return _stitch_outs(payload, outs, upsample)


def decode_range(payload: dict[str, Any], start_s: float, stop_s: float,
                 device: torch.device | str, fused: bool | None = None,
                 max_chunks_per_batch: int | None = None
                 ) -> tuple[int, np.ndarray]:
    """Random-access decode of ``[start_s, stop_s)`` seconds: only the
    windows overlapping the range are evaluated (O(range) work).  Equals the
    corresponding slice of ``decode`` (exactly on the kernel route)."""
    dev = _resolve_device(device)
    meta, model, params = _payload_model_params(payload, fused, dev)
    coords = torch.from_numpy(_decode_grid(meta["chunk_length"], 1)).to(dev)
    fn = chunk_eval_fn(model, coords, _routing_fit_snr(meta))
    sr = meta["sample_rate"]
    c = int(meta.get("num_channels", 1))
    k = meta["num_chunks"]
    scales = np.asarray(payload["scales"], np.float32)
    a, b = int(round(start_s * sr)), int(round(stop_s * sr))

    def channel(j):
        return tree_map(lambda x: x[j * k:(j + 1) * k], params)

    chans = [decode_chunk_range(
        fn, channel(j), scales[j * k:(j + 1) * k], meta["chunk_length"],
        meta["hop"], k, meta["signal_length"], a, b, max_chunks_per_batch)
        for j in range(c)]
    return sr, (chans[0] if c == 1 else np.stack(chans, axis=1))


def to_device(payload: dict[str, Any],
              device: torch.device | str) -> dict[str, Any]:
    """A new payload whose (still quantized) parameter leaves live on
    ``device``: a server that keeps it decodes without re-uploading the
    parameters per request.  The input payload is left as it is."""
    dev = _resolve_device(device)
    return {**payload, "params": tree_map(lambda x: x.to(dev),
                                          payload["params"])}


# ---------------------------------------------------------------------------
# Containers
# ---------------------------------------------------------------------------

def _quantized_leaf_template(mode: str):
    if mode in ("float16", "bfloat16"):
        return mode
    if mode in ("int8", "int16"):
        return {"q": mode, "scale": "float32"}
    if mode == "int4":
        return {"q4": "uint8", "scale": "float32", "shape": "int32"}
    raise ValueError(f"unknown quantization mode {mode!r}")


def _params_template(meta: dict[str, Any]) -> dict[str, Any]:
    """The stored parameter tree's structure, leaves = stored dtype names —
    what ``quantize_inr_params`` makes of ``build_model(...).init``."""
    cfg = _model_cfg_from_meta(meta)
    mode = meta.get("quantize")
    side = bool(meta.get("side_quantized", False))
    layers = []
    for li, kind in enumerate(cfg.layer_kinds):
        layer: dict[str, Any] = {"w": "float32", "b": "float32"}
        if kind == "linear_snake":
            layer["snake_a"] = "float32"
        if mode and li > 0:
            for key in layer:
                if key == "w":
                    layer[key] = _quantized_leaf_template(mode)
                elif side:
                    layer[key] = _SIDE_MODE[mode]
        layers.append(layer)
    return {"layers": layers}


def _leaf_bits(leaf) -> tuple[str, np.ndarray]:
    """A stored leaf -> (dtype name, numpy array of its bits); bfloat16
    travels as its uint16 bit pattern."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy().view(np.uint16)
        a = t.numpy()
    else:
        a = np.ascontiguousarray(np.asarray(leaf))
    return a.dtype.name, a


def _flatten_payload(payload: dict[str, Any]) -> dict[str, np.ndarray]:
    arrays = {"__meta__": np.frombuffer(
        json.dumps(payload["meta"]).encode("utf-8"), dtype=np.uint8),
        "scales": payload["scales"]}
    leaves = tree_leaves(payload["params"])
    arrays["__nleaves__"] = np.asarray(len(leaves))
    for i, leaf in enumerate(leaves):
        arrays[f"leaf_{i:05d}"] = _leaf_bits(leaf)[1]
    return arrays


# ---- INRA container: per-leaf best-of lossless entropy coding ----------

_INRA_MAGIC = b"INRA1\x00"
_LZMA_FILTERS = ({"id": lzma.FILTER_LZMA2, "preset": 6},)


def _lzma_c(b: bytes) -> bytes:
    return lzma.compress(b, format=lzma.FORMAT_RAW,
                         filters=list(_LZMA_FILTERS))


def _lzma_d(b: bytes) -> bytes:
    return lzma.decompress(b, format=lzma.FORMAT_RAW,
                           filters=list(_LZMA_FILTERS))


def _byte_shuffle(b: bytes, itemsize: int) -> bytes:
    a = np.frombuffer(b, np.uint8).reshape(-1, itemsize)
    return np.ascontiguousarray(a.T).tobytes()


def _byte_unshuffle(b: bytes, itemsize: int) -> bytes:
    a = np.frombuffer(b, np.uint8).reshape(itemsize, -1)
    return np.ascontiguousarray(a.T).tobytes()


def _encode_leaf(leaf) -> tuple[dict[str, Any], bytes]:
    """-> (spec, blob).  Lossless; keeps the smallest applicable coding of
    the same candidate set as the JAX package, so both write equal files."""
    dtype, bits = _leaf_bits(leaf)
    raw = bits.tobytes()
    cands: dict[str, bytes] = {"raw": raw}
    if len(raw) >= 256:
        cands["zlib"] = zlib.compress(raw, 9)
        cands["lzma"] = _lzma_c(raw)
        if bits.dtype.itemsize > 1:
            sh = _byte_shuffle(raw, bits.dtype.itemsize)
            cands["shuf+zlib"] = zlib.compress(sh, 9)
            cands["shuf+lzma"] = _lzma_c(sh)
        if bits.dtype.itemsize == 1 and bits.ndim >= 2 and bits.shape[0] > 1:
            t = np.ascontiguousarray(np.moveaxis(bits, 0, -1)).tobytes()
            cands["T+lzma"] = _lzma_c(t)
    enc = min(cands, key=lambda k: len(cands[k]))
    blob = cands[enc]
    return {"dtype": dtype, "shape": [int(s) for s in bits.shape],
            "enc": enc, "n": len(blob)}, blob


def _decode_leaf(spec: dict[str, Any], blob: bytes) -> np.ndarray:
    """-> numpy array of the stored bits (uint16 for bfloat16 leaves)."""
    store_dt = np.dtype(np.uint16 if spec["dtype"] == "bfloat16"
                        else spec["dtype"])
    shape = tuple(spec["shape"])
    enc = spec["enc"]
    if enc == "raw":
        b = blob
    elif enc == "zlib":
        b = zlib.decompress(blob)
    elif enc == "lzma":
        b = _lzma_d(blob)
    elif enc == "shuf+zlib":
        b = _byte_unshuffle(zlib.decompress(blob), store_dt.itemsize)
    elif enc == "shuf+lzma":
        b = _byte_unshuffle(_lzma_d(blob), store_dt.itemsize)
    elif enc == "T+lzma":
        t = np.frombuffer(_lzma_d(blob), store_dt)
        t = t.reshape(shape[1:] + shape[:1])
        return np.ascontiguousarray(np.moveaxis(t, -1, 0))
    else:
        raise ValueError(f"unknown leaf coding {enc!r} — payload written "
                         "by a newer build?")
    return np.frombuffer(b, store_dt).reshape(shape)


def _write_inra(path: str, payload: dict[str, Any]) -> None:
    leaves = tree_leaves(payload["params"])
    entries, blobs = [], []
    for name, arr in ([("scales", payload["scales"])]
                      + [(f"leaf_{i:05d}", l) for i, l in enumerate(leaves)]):
        spec, blob = _encode_leaf(arr)
        spec["name"] = name
        entries.append(spec)
        blobs.append(blob)
    header = json.dumps({"meta": payload["meta"], "entries": entries,
                         "nleaves": len(leaves)}).encode("utf-8")
    with open(path, "wb") as f:
        f.write(_INRA_MAGIC)
        f.write(len(header).to_bytes(4, "little"))
        f.write(header)
        for blob in blobs:
            f.write(blob)


def _read_inra_header(f) -> dict[str, Any]:
    if f.read(len(_INRA_MAGIC)) != _INRA_MAGIC:
        raise ValueError(f"{f.name}: not an INRA payload")
    hlen = int.from_bytes(f.read(4), "little")
    return json.loads(f.read(hlen).decode("utf-8"))


def _read_inra(path: str):
    """-> (meta, scales, [(bits, dtype name)] per leaf)."""
    with open(path, "rb") as f:
        header = _read_inra_header(f)
        arrays = {spec["name"]: (_decode_leaf(spec, f.read(spec["n"])),
                                 spec["dtype"])
                  for spec in header["entries"]}
    leaves = [arrays[f"leaf_{i:05d}"] for i in range(header["nleaves"])]
    return header["meta"], arrays["scales"][0], leaves


def save_inr(path: str, payload: dict[str, Any]) -> str:
    """Write the payload as one file; returns the path.  INRA by default
    (``.inra`` appended when missing); a path ending in ``.npz`` selects the
    legacy npz container."""
    if path.endswith(".npz"):
        np.savez_compressed(path, **_flatten_payload(payload))
        return path
    if not path.endswith(".inra"):
        path = path + ".inra"
    _write_inra(path, payload)
    return path


def _resolve_payload_path(path: str) -> str:
    """Accept the path given to ``save_inr`` even if it appended .inra."""
    if not os.path.exists(path) and os.path.exists(path + ".inra"):
        return path + ".inra"
    return path


def _is_inra(path: str) -> bool:
    with open(path, "rb") as fh:
        return fh.read(len(_INRA_MAGIC)) == _INRA_MAGIC


def load_inr(path: str) -> dict[str, Any]:
    """Read a payload written by either package's ``save_inr`` (INRA or
    legacy npz, told apart by magic bytes).  The parameter tree is rebuilt
    from the stored model config and quantization header."""
    path = _resolve_payload_path(path)
    if _is_inra(path):
        meta, scales, stored = _read_inra(path)
    else:
        with np.load(path, allow_pickle=False) as f:
            meta = json.loads(bytes(f["__meta__"]).decode("utf-8"))
            scales = f["scales"]
            stored = [(f[f"leaf_{i:05d}"], None)
                      for i in range(int(f["__nleaves__"]))]
    _check_format(meta)
    if meta.get("codec") == "modulated":
        raise NotImplementedError("the modulated codec is not ported yet")
    template = _params_template(meta)
    t_leaves = tree_leaves(template)
    if len(t_leaves) != len(stored):
        raise ValueError("leaf count mismatch — corrupted payload")
    # npz stores bfloat16 as raw uint16 bits with no dtype record: the
    # template says which leaves they are
    leaves = [tensor_from_numpy(a, bfloat16_bits=(dt or tl) == "bfloat16")
              for tl, (a, dt) in zip(t_leaves, stored)]
    return {"meta": meta, "scales": np.asarray(scales),
            "params": tree_unflatten(template, leaves)}


def payload_info(path: str) -> dict[str, Any]:
    """Inspect a saved payload without decoding audio: container, header,
    per-leaf storage table and on-disk totals."""
    import zipfile

    path = _resolve_payload_path(path)
    entries: list[dict[str, Any]] = []
    if _is_inra(path):
        with open(path, "rb") as f:
            header = _read_inra_header(f)
        meta = header["meta"]
        for spec in header["entries"]:
            dt = np.dtype(np.uint16 if spec["dtype"] == "bfloat16"
                          else spec["dtype"])
            raw = int(np.prod(spec["shape"], dtype=np.int64)) * dt.itemsize
            entries.append({"name": spec["name"], "dtype": spec["dtype"],
                            "shape": list(spec["shape"]), "enc": spec["enc"],
                            "stored_bytes": int(spec["n"]),
                            "raw_bytes": raw})
        container = "inra"
    else:
        with zipfile.ZipFile(path) as zf:
            sizes = {i.filename: i.compress_size for i in zf.infolist()}
        with np.load(path, allow_pickle=False) as f:
            meta = json.loads(bytes(f["__meta__"]).decode("utf-8"))
            for name in f.files:
                if name.startswith("__"):
                    continue
                a = f[name]
                entries.append({
                    "name": name, "dtype": a.dtype.name,
                    "shape": list(a.shape), "enc": "zip-deflate",
                    "stored_bytes": int(sizes.get(name + ".npy", a.nbytes)),
                    "raw_bytes": int(a.nbytes)})
        container = "npz"
    file_bytes = os.path.getsize(path)
    n = int(meta["signal_length"]) * int(meta.get("num_channels", 1))
    return {"container": container,
            "file_bytes": int(file_bytes),
            "bits_per_sample": 8.0 * file_bytes / n,
            "ratio_vs_pcm16": (2 * n) / file_bytes,
            "meta": meta,
            "leaves": entries,
            "stored_leaf_bytes": int(sum(e["stored_bytes"] for e in entries)),
            "raw_leaf_bytes": int(sum(e["raw_bytes"] for e in entries))}
