"""The comparison that decides ``correct``: the numbers read from the
program's output against the plain reference's, each held to its limit.
A cell's ``limits/<cell>.json`` names the numbers it compares.

A training cell reads the first steps that the window's own call drove
(``train_readings``):

- ``loss_gap``: the largest relative gap of a step's loss; ``loss1_gap``
  the first step's;
- ``grad_gap``: the first gradient as the optimizer got it (Adam's first
  moment after one step over 1 - beta1), by the worst leaf: the gap between
  the program's norm of the leaf and the reference's, over the larger of
  the reference's norm of that leaf and of the median leaf;
- ``grad_err``: the same gradient by the median leaf: the norm of the
  difference over the gradient's scale (the larger of that leaf's and the
  median leaf's), the reference's gradient with every row's residual given
  a random sign of its own, whose norm is the size of a sum of the rows'
  rounding errors.  The gradient itself is a sum that cancels, by a share
  that differs from seed to seed, and the rounding errors do not cancel
  with it; the median leaf is steadier from seed to seed than the worst;
- ``change_gap``: as ``grad_gap``, of the parameters' change after the
  steps and of the best snapshot's change.

Leaves whose reference gradient is under a thousandth of the median leaf's
(a buffer such as the KAN's knot grid) are left out.

A population cell (one model a window, every leaf with a leading window
axis) reads ``loss_gap``, ``loss1_gap``, ``grad_gap`` and ``change_gap``
window by window, each as above with a window's leaves for the model's,
and reports the worst window (``population_readings``): one window gone
wrong shows, however many agree.

A decode cell compares the answers of a sample of its requests
(``decode_readings``): ``decode_err`` is the largest |program - reference|
of a sample over the reference's RMS over that request.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

BETA1 = 0.9


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gaps(prog: dict[str, torch.Tensor], ref: dict[str, torch.Tensor],
              names: list[str], diff: bool = False,
              scale: dict[str, torch.Tensor] | None = None
              ) -> dict[str, float]:
    """Each leaf's gap of norms (``diff``: the norm of the difference) over
    the larger of its reference norm and the median leaf's (or of the norms
    of ``scale``'s leaves)."""
    norms = {n: _norm((ref if scale is None else scale)[n]) for n in names}
    med = statistics.median(norms.values())
    out = {}
    for n in names:
        p = prog[n].to(ref[n].device)
        gap = (_norm(p - ref[n]) if diff
               else abs(_norm(p) - _norm(ref[n])))
        out[n] = gap / max(norms[n], med, 1e-30)
    return out


def _worst_leaf(prog: dict[str, torch.Tensor], ref: dict[str, torch.Tensor],
                names: list[str]) -> float:
    worst = 0.0
    for gap in leaf_gaps(prog, ref, names).values():
        worst = _worse(worst, gap)
    return worst


def _median_leaf(prog: dict[str, torch.Tensor], ref: dict[str, torch.Tensor],
                 names: list[str], scale: dict[str, torch.Tensor]) -> float:
    gaps = list(leaf_gaps(prog, ref, names, True, scale).values())
    if not all(math.isfinite(g) for g in gaps):
        return math.inf
    return statistics.median(gaps)


def _worse(a: float, b: float) -> float:
    """max that a NaN does not get past."""
    return math.inf if not (math.isfinite(a) and math.isfinite(b)) \
        else max(a, b)


def counted_leaves(ref_grad: dict[str, torch.Tensor]) -> list[str]:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    norms = {n: _norm(g) for n, g in ref_grad.items()}
    med = statistics.median(norms.values())
    return [n for n, v in norms.items() if v >= 1e-3 * med]


def train_readings(prog: dict, ref: dict,
                   params0: dict[str, torch.Tensor]) -> dict[str, float]:
    """``prog`` and ``ref``: {"loss": [..], "grad": {leaf: first gradient},
    "params", "best_params": {leaf: after the steps}}; ``params0`` the
    parameters both started from."""
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])]
    loss_gap = 0.0
    for gap in gaps:
        loss_gap = _worse(loss_gap, gap)
    if len(prog["loss"]) != len(ref["loss"]):
        loss_gap = math.inf
    names = counted_leaves(ref["grad"])
    change = {}
    for key in ("params", "best_params"):
        d_p = {n: prog[key][n].to(params0[n].device) - params0[n]
               for n in names}
        d_r = {n: ref[key][n] - params0[n] for n in names}
        change[key] = _worst_leaf(d_p, d_r, names)
    return {"loss_gap": loss_gap,
            "loss1_gap": _worse(gaps[0], 0.0) if gaps else math.inf,
            "grad_gap": _worst_leaf(prog["grad"], ref["grad"], names),
            "grad_err": _median_leaf(prog["grad"], ref["grad"], names,
                                     ref["grad_scale"]),
            "change_gap": _worse(*change.values())}


def _window_norms(tree: dict[str, torch.Tensor], names: list[str],
                  device: torch.device) -> np.ndarray:
    """(windows, leaves) float64: each window's norm of each leaf."""
    return torch.stack([torch.linalg.vector_norm(
        tree[n].to(device).double().reshape(tree[n].shape[0], -1), dim=1)
        for n in names], dim=1).cpu().numpy()


def population_readings(prog: dict, ref: dict,
                        params0: dict[str, torch.Tensor]) -> dict[str, float]:
    """``prog`` and ``ref`` as for ``train_readings``, with each loss a
    window's ((steps, windows) arrays) and each leaf stacked on a leading
    window axis; the worst window of each number."""
    names = list(params0)
    dev = params0[names[0]].device
    p_loss = np.asarray(prog["loss"], np.float64)
    r_loss = np.asarray(ref["loss"], np.float64)
    if p_loss.shape != r_loss.shape:
        return dict.fromkeys(("loss_gap", "loss1_gap", "grad_gap",
                              "change_gap"), math.inf)
    gaps = np.abs(p_loss - r_loss) / np.abs(r_loss)
    ref_grad = _window_norms(ref["grad"], names, dev)
    counted = ref_grad >= 1e-3 * np.median(ref_grad, axis=1, keepdims=True)

    def worst(p: np.ndarray, r: np.ndarray) -> float:
        """The worst window's worst counted leaf: the gap of norms over the
        larger of the leaf's reference norm and the window's median."""
        out = 0.0
        for w in range(r.shape[0]):
            c = counted[w]
            scale = np.maximum(r[w, c], max(np.median(r[w, c]), 1e-30))
            out = _worse(out, float(np.max(np.abs(p[w, c] - r[w, c])
                                           / scale)))
        return out

    change = 0.0
    for key in ("params", "best_params"):
        d = lambda tree: {n: tree[key][n].to(dev) - params0[n]  # noqa
                          for n in names}
        change = _worse(change, worst(_window_norms(d(prog), names, dev),
                                      _window_norms(d(ref), names, dev)))
    return {"loss_gap": _worse(float(np.max(gaps)), 0.0),
            "loss1_gap": _worse(float(np.max(gaps[0])), 0.0),
            "grad_gap": worst(_window_norms(prog["grad"], names, dev),
                              ref_grad),
            "change_gap": change}


def decode_readings(pairs: list[tuple[torch.Tensor, torch.Tensor]]
                    ) -> dict[str, float]:
    """``pairs``: (program's answer, reference's answer) of each request
    compared."""
    worst = 0.0
    for prog, ref in pairs:
        if prog.numel() != ref.numel():
            return {"decode_err": math.inf}
        prog = prog.to(ref.device).reshape(ref.shape)
        rms = float(torch.sqrt(torch.mean(torch.square(ref.double()))))
        err = float(torch.max(torch.abs(prog.double() - ref.double())))
        worst = _worse(worst, err / max(rms, 1e-30))
    return {"decode_err": worst if pairs else math.inf}


def judge(readings: dict[str, float], limits: dict[str, float]
          ) -> tuple[bool, dict[str, dict[str, float]]]:
    """(every reading within its limit, {name: {"value", "limit"}}); a
    reading that is not finite fails, and so does a limit with no
    reading."""
    table = {}
    ok = True
    for name, limit in limits.items():
        value = readings.get(name, math.inf)
        table[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, table
