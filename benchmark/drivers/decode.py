"""Driver ``decode``: one caller decodes ranges of the clip's grid through the
port's public entry ``eval.decode.decode_dense``, each request sent when
the last one's samples are on the host (a closed loop; the library has no
queue of its own).

Requests come from the seed: in each block of ``strata`` requests the
lengths are the block's fixed set, evenly spaced from ``min_seconds`` to
``max_seconds`` of audio, in an order drawn from the seed, and each start
is drawn uniformly with the whole range inside the clip.  So every seed
asks for the same work, in another order and at other places.  The
weights, made from the seed, stay on the card.  Set-up decodes one whole
block of another order (every length the window sends).  After the window
the reference decodes a sample of ``sample_requests`` of the window's
requests, drawn from the seed (reservoir sampling), and the longest one.

Mix keys: ``min_seconds``, ``max_seconds``, ``strata``,
``sample_requests``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import calibrate, check, port
from ..clip import synth_clip, wave_problem
from ..reference.common import forward_blocks
from ..trace import span


class Requests:
    """The seed's endless stream of (start, length) over a clip of
    ``n`` samples."""

    def __init__(self, mix: dict, n: int, fs: int, rng: np.random.Generator):
        lo, hi = mix["min_seconds"] * fs, mix["max_seconds"] * fs
        k = mix["strata"]
        self.lengths = np.rint(lo + (np.arange(k) + 0.5) / k * (hi - lo)
                               ).astype(np.int64)
        self.n = n
        self.rng = rng
        self.block: list[tuple[int, int]] = []

    def __next__(self) -> tuple[int, int]:
        if not self.block:
            lengths = self.rng.permutation(self.lengths)
            starts = self.rng.integers(0, self.n - lengths + 1)
            self.block = list(zip(starts.tolist(), lengths.tolist()))[::-1]
        return self.block.pop()


class Driver:
    door = "decode_dense"
    # the cases read the answers of a window's sample of requests
    cases_after_window = True

    def __init__(self, cell):
        self.cell = cell
        self.cfg = cell.cfg
        self.mix = cell.mix
        self.dev = cell.device

    def _decode(self, start: int, length: int) -> np.ndarray:
        return port.door(self.door)(self.model, self.params,
                                    self.coords[start:start + length],
                                    device=self.dev)

    def setup(self) -> None:
        cfg, dev, seed = self.cfg, self.dev, self.cell.seed
        # the grid of the clip, and the clip's length
        coords, _ = wave_problem(
            synth_clip(seed, cfg["samples"], cfg["sample_rate"]))
        self.coords = torch.from_numpy(coords).to(dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.params = self.cell.ref.init(cfg, gen, dev)
        self.tree0 = {"layers": [{k: v.clone() for k, v in layer.items()}
                                 for layer in self.params["layers"]]}
        self.model = port.build_model(cfg)
        self.cell.mark("inputs")
        n, fs = coords.shape[0], cfg["sample_rate"]
        warm = Requests(self.mix, n, fs, np.random.default_rng([seed, 1]))
        self._decode(*next(warm))
        self.cell.mark("first_request")
        for _ in range(self.mix["strata"] - 1):
            self._decode(*next(warm))
        self.cell.mark("warmup")
        self.requests = Requests(self.mix, n, fs,
                                 np.random.default_rng([seed, 2]))
        self.sampler = np.random.default_rng([seed, 3])

    def window(self, seconds: float, tracing: bool) -> dict:
        keep = self.mix["sample_requests"]
        sample: list[tuple[int, int, np.ndarray]] = []
        longest = None
        latencies: list[float] = []
        rows = failed = 0
        deadline = time.perf_counter() + seconds
        while True:
            start, length = next(self.requests)
            t0 = time.perf_counter()
            with span("bench.request", tracing):
                out = self._decode(start, length)
            t1 = time.perf_counter()
            latencies.append(t1 - t0)
            rows += length
            if out.shape != (length, 1):
                failed += 1
            item = (start, length, out)
            i = len(latencies) - 1
            if i < keep:
                sample.append(item)
            else:
                j = int(self.sampler.integers(0, i + 1))
                if j < keep:
                    sample[j] = item
            if longest is None or length > longest[1]:
                longest = item
            if t1 >= deadline:
                break
        if all(s[:2] != longest[:2] for s in sample):
            sample.append(longest)
        self.sample = sample
        return {"requests": len(latencies), "attempted": len(latencies),
                "failed": failed, "rows": rows,
                "request_wall_s": float(np.sum(latencies)),
                "latencies": latencies}

    def metrics(self, run: dict, wall_s: float) -> dict[str, float]:
        return {"decode_rate": run["rows"] / wall_s / 1e6,
                "decode_p95_ms": float(np.percentile(run["latencies"], 95))
                * 1e3}

    def reference(self, tf32: bool = False) -> list[torch.Tensor]:
        """The reference over each sampled request's range (``tf32``: the
        control)."""
        cfg, ref = self.cfg, self.cell.ref
        return [forward_blocks(lambda p, x: ref.forward(p, cfg, x, tf32),
                               self.tree0, self.coords[start:start + length],
                               cfg["reference_block_rows"])
                for start, length, _ in self.sample]

    def answers(self) -> list[torch.Tensor]:
        return [torch.from_numpy(np.asarray(out)) for _, _, out in self.sample]

    def readings(self) -> dict[str, float]:
        """The sampled answers against the reference's, after the
        program's state is gone."""
        self.model = self.params = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return check.decode_readings(list(zip(self.answers(),
                                              self.reference())))

    def cases(self) -> dict[str, dict[str, float]]:
        return calibrate.decode_cases(self)

    def fault(self, kind: str):
        """The door with the timed path broken: ``unchanged`` (the answer's
        buffer never written), ``half_batch`` (the second half of each
        answer left out), ``altered`` (one sample shifted by the answer's
        RMS)."""
        real = port.door(self.door)

        def decode_dense(model, params, coords, device=None):
            out = real(model, params, coords, device=device).copy()
            if kind == "unchanged":
                out[:] = 0
            elif kind == "half_batch":
                out[out.shape[0] // 2:] = 0
            else:
                out[out.shape[0] // 3] += float((out ** 2).mean() ** 0.5)
            return out
        return decode_dense
