"""Adaptive STMDCT with block switching (port of
``inraudio_tpu/dsp/adaptive.py``).

A transient detector over the short-hop energy envelope picks the long
slots that switch to short blocks; a host plan maps the signal to frames
``long ... long, start, shorts, stop, long ...``, where a flagged pair of
long slots becomes start + (n_long / n_short - 1) shorts + stop, critically
sampled.  The transforms run batched per kind of frame (one matmul for
every long frame, one for the shorts, ...) on the signal's device.  Every
overlap pairs the rising and falling halves of one power-complementary
window (KBD at long boundaries, sine at short ones) and every frame's MDCT
uses its own half-lengths (a, b), so the aliasing cancels.  Frame i, of
halves (a_i, b_i), is followed by frame i + 1 at offset_i + a_i, with
a_{i+1} == b_i.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .mdct import imdct, mdct
from .windows import (long_window, short_window, transition_start_window,
                      transition_stop_window)

KINDS = ("long", "start", "short", "stop")


@dataclasses.dataclass(frozen=True)
class AdaptivePlan:
    """Host-side frame plan: each frame's kind and start offset."""

    n_long: int
    n_short: int
    kinds: tuple[str, ...]
    offsets: tuple[int, ...]
    num_samples: int

    def halves(self, kind: str) -> tuple[int, int]:
        nl2, ns2 = self.n_long // 2, self.n_short // 2
        return {"long": (nl2, nl2), "start": (nl2, ns2),
                "short": (ns2, ns2), "stop": (ns2, nl2)}[kind]

    def window(self, kind: str) -> np.ndarray:
        return {"long": long_window(self.n_long),
                "start": transition_start_window(self.n_long, self.n_short),
                "short": short_window(self.n_short),
                "stop": transition_stop_window(self.n_long, self.n_short),
                }[kind]

    @property
    def total_coeffs(self) -> int:
        return sum(sum(self.halves(k)) // 2 for k in self.kinds)

    def starts(self, kind: str) -> np.ndarray:
        """Start offsets of the frames of ``kind``, in plan order."""
        return np.asarray([o for k, o in zip(self.kinds, self.offsets)
                           if k == kind], dtype=np.int64)

    @property
    def end(self) -> int:
        """One past the last sample any frame covers."""
        return max(o + sum(self.halves(k))
                   for k, o in zip(self.kinds, self.offsets))


def _validate_sizes(n_long: int, n_short: int) -> None:
    """The long and short grids must nest (n_short divides n_long, both
    even): otherwise the frame chain breaks and the aliasing does not
    cancel."""
    if n_long % 2 or n_short % 2:
        raise ValueError(f"n_long and n_short must be even, got "
                         f"{n_long}/{n_short}")
    if n_short <= 0 or n_long % n_short:
        raise ValueError(
            f"n_short must divide n_long for critical sampling across a "
            f"window switch, got n_long={n_long}, n_short={n_short}")


def detect_transients(data, n_long: int = 2048, n_short: int = 256,
                      threshold: float = 8.0) -> np.ndarray:
    """Bool flags over the len(data) // (n_long // 2) long slots: a slot is
    transient when its peak short-hop energy exceeds ``threshold`` times
    the previous slot's mean (slot 0's: the median slot mean)."""
    _validate_sizes(n_long, n_short)
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu().numpy()
    data = np.asarray(data, dtype=np.float64)
    hop_s, hop_l = n_short // 2, n_long // 2
    n_slots = len(data) // hop_l
    env = (data[:n_slots * hop_l].reshape(-1, hop_s) ** 2).sum(axis=1)
    per_slot = env.reshape(n_slots, hop_l // hop_s)
    peak = per_slot.max(axis=1)
    mean = np.maximum(per_slot.mean(axis=1), 1e-12)
    floor0 = max(float(np.median(mean)), 1e-12)
    prev_mean = np.concatenate([[floor0], mean[:-1]])
    return peak > threshold * np.maximum(prev_mean, 1e-12)


def plan_blocks(num_samples: int, transients, n_long: int = 2048,
                n_short: int = 256) -> AdaptivePlan:
    """The frame plan over the long-slot grid: a flagged slot and the next
    become start + (hop_l - hop_s) / hop_s shorts + stop, advancing two
    long hops; every other slot is a long frame."""
    _validate_sizes(n_long, n_short)
    hop_l, hop_s = n_long // 2, n_short // 2
    n_slots = max(1, num_samples // hop_l)
    flags = np.zeros(n_slots, dtype=bool)
    t = np.asarray(transients, dtype=bool)
    flags[: min(len(t), n_slots)] = t[:n_slots]
    k_short = (hop_l - hop_s) // hop_s
    kinds: list[str] = []
    offsets: list[int] = []
    pos = slot = 0
    while slot < n_slots:
        if flags[slot] and slot + 1 < n_slots:
            group = [("start", hop_l)] + [("short", hop_s)] * k_short + [
                ("stop", hop_s)]
            slot += 2
        else:
            group = [("long", hop_l)]
            slot += 1
        for kind, step in group:
            kinds.append(kind)
            offsets.append(pos)
            pos += step
    return AdaptivePlan(n_long=n_long, n_short=n_short, kinds=tuple(kinds),
                        offsets=tuple(offsets), num_samples=num_samples)


def _frame_index(plan: AdaptivePlan, kind: str,
                 device: torch.device) -> torch.Tensor:
    length = sum(plan.halves(kind))
    idx = plan.starts(kind)[:, None] + np.arange(length)[None, :]
    return torch.from_numpy(idx).to(device)


def _window(plan: AdaptivePlan, kind: str,
            device: torch.device) -> torch.Tensor:
    return torch.as_tensor(plan.window(kind), dtype=torch.float32,
                           device=device)


def stmdct_adaptive(data, plan: AdaptivePlan) -> dict[str, torch.Tensor]:
    """Per-kind coefficient banks {kind: (frames of the kind, (a+b)//2)},
    each one windowed batched MDCT, on the signal's device."""
    x = torch.as_tensor(data, dtype=torch.float32)
    x = torch.nn.functional.pad(x, (0, max(0, plan.end - x.shape[0])))
    out: dict[str, torch.Tensor] = {}
    for kind in KINDS:
        if kind not in plan.kinds:
            continue
        frames = x[_frame_index(plan, kind, x.device)] * _window(
            plan, kind, x.device)
        out[kind] = mdct(frames, *plan.halves(kind))
    return out


def istmdct_adaptive(coeffs: dict[str, torch.Tensor],
                     plan: AdaptivePlan) -> torch.Tensor:
    """Inverse: per-kind batched IMDCT, the synthesis window, overlap-add
    at the plan's offsets, trimmed to the signal's length."""
    dev = next(iter(coeffs.values())).device
    acc = torch.zeros((plan.end,), dtype=torch.float32, device=dev)
    for kind in KINDS:
        if kind not in coeffs:
            continue
        frames = imdct(coeffs[kind], *plan.halves(kind)) * _window(
            plan, kind, dev)
        acc.index_add_(0, _frame_index(plan, kind, dev).reshape(-1),
                       frames.reshape(-1))
    return acc[: plan.num_samples]
