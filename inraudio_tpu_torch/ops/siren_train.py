"""Differentiable SirenWithSnakeTanh stack: the stack kernel forward and a
backward kernel, with their plain PyTorch versions.

Port of ``inraudio_tpu/ops/pallas_siren_train.py``: ``_fwd_pres`` and
``_bwd_sweep`` become ``fwd_pres_plain`` / ``bwd_sweep_plain`` (the plain
versions), the backward kernel ``_bwd_kernel`` becomes ``SIREN_BWD``
(``csrc/siren_train.cu``), and ``fused_siren_train_apply`` is a
``torch.autograd.Function`` whose forward is the stack kernel
(``ops.siren_fused``) and whose backward is ``SIREN_BWD``.

The backward recomputes the forward per row tile and accumulates dW, db and
the snake's da for each window.  Its matmul tiers follow the JAX package:
the forward products take ``f32_mode`` (``INRAUDIO_F32_PRECISION``, default
bf16x3); both backward products take the grad tier
(``INRAUDIO_GRAD_PRECISION``, default bf16x2, 'inherit' = the f32 tier):
dW = x_in^T gpre rounds x_in and splits gpre, dgrad = gpre W^T rounds gpre
and splits W.  A raw layer 0's forward stays exact f32 multiply-adds; its
dW is a grad-tier product of the raw coordinates, as in the reference.  An
RFF layer 0 (``rff_b``) takes its features (cos v, sin v) in the forward
tier, and its dW is the grad-tier product [cos v; sin v]^T gpre, with the
features on the rounded side; B gets no gradient.

Two routes compute a window's gradient (``grad_reduce``).  The bf16 tiers
(every product's tier bf16, bf16x2 or bf16x3: ``tc_route``) run on the
tensor cores: a sweep kernel per (window, row slice) does the forward
recompute, the cotangent and the dgrad sweep and writes dW's operands once
as bf16 planes, then a dW kernel forms each layer's x_in^T gpre over the
slice's rows in registers and writes it once; ``tc_plan`` fixes the slices,
row chunks and passes from the shapes.  The highest tier (an exact f32
product) runs the FMA kernel, each CTA walking its slice's row tiles into
one slab of partial grads.  Both bound their scratch per window whatever
the clip's length: at most ``MAX_SLICES`` row slices, and planes for at
most ``CHUNK_TILES`` row tiles of each.

Parameters cross the kernel in one flat (k, P) float32 buffer per window
population (``flat_layout``): each leaf at a 16-byte-aligned offset, zero
between leaves.  The whole-step kernel (``ops.siren_step``) keeps its train
state in this layout.

The wrappers run the plain version for CPU tensors only; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
from typing import Any

import torch

from ..models.siren import SirenSnakeTanhConfig
from ..utils.observability import counter, span
from ._nvcc import LaunchCounter, build_library
from .siren_fused import (_KERNEL_MAX_LAYERS, _KIND_CODE, _MAX_SMALL_IN,
                          _MODE_CODE, SIREN_STACK, StackPlan,
                          _check_rff_model, _check_rff_plan, _check_tensor,
                          _cos, _f32_dot_mode, _kernel_dot, _prep_rff_bt,
                          _sin, kernel_width, pad_params, rff_features_plain,
                          rff_pre_plain, stack_forward_plain, stack_plan,
                          unpad_params)

Params = dict[str, Any]

# rows per CTA of the training kernels: a (TM, h) tile is 8192 floats at
# every supported width (csrc/siren_train.cu, TILE_FLOATS)
TILE_FLOATS = 8192
# floats per CTA of the reduce kernel, whose sums of squares the clip
# norm adds up chunk by chunk (csrc/siren_train.cu, kChunk)
CHUNK_FLOATS = 1024
# device memory for one grad launch's partial grads and saved
# pre-activations; larger populations go through in groups of windows
SCRATCH_BYTES = 1 << 30
# row slices of a window of more row tiles than this (two waves of CTAs on
# the H100's 132 SMs at one model): each slice's CTA walks its tiles in
# order into one slab, so a window's scratch stays at most MAX_SLICES slabs
# whatever its length.  Windows of fewer tiles keep one tile per slice.
MAX_SLICES = 264


# the tensor-core route: the planes and pres of one pass of units (window,
# row slice) stay within PLANE_BYTES; a slice's planes cover at most
# CHUNK_TILES row tiles at a time (a longer slice goes through row chunks
# whose dW add up in chunk order)
TC_MODES = ("bf16x3", "bf16x2", "bf16")
PLANE_BYTES = 2 << 30
CHUNK_TILES = 128


def tile_rows(h: int) -> int:
    return TILE_FLOATS // h


def row_slices(tiles: int) -> int:
    """Row slices of a window of ``tiles`` row tiles: a function of the
    shapes only, never of SCRATCH_BYTES, so the grouping of windows leaves
    every result bit-equal."""
    return min(tiles, MAX_SLICES)


def tc_route(plan: StackPlan, gmode: str) -> bool:
    """Whether the tensor-core kernels take this step: the grad tier and
    the forward tier of every product (layers 1+, and an RFF layer 0) in
    bf16, bf16x2 or bf16x3.  The highest tier, an exact f32 product, keeps
    the FMA kernel."""
    modes = [m for li, m in enumerate(plan.modes) if li > 0 or m is not None]
    return gmode in TC_MODES and all(m in TC_MODES for m in modes)


def tc_slices(tiles: int, h: int) -> int:
    """Row slices of a window on the tensor-core route: at least h^2 / 4096
    row tiles (2h rows) a slice, so that a slice's slab (P floats, written
    once) stays small beside the planes of its rows, and at most
    MAX_SLICES.  A function of the shapes only."""
    return min(MAX_SLICES, tiles, -(-tiles // max(1, h * h // 4096)))


def sweep_group(h: int) -> int:
    """Row tiles the sweep kernel carries at once at width h (csrc/
    siren_train.cu, ``Sw<H>::G``, which refuses another): two at h = 128
    and 256, so each W slab in shared memory serves 128 / 64 rows; one at
    h = 32 and 64, whose tiles are 256 / 128 rows already.  Its pre
    scratch holds that many tiles a unit."""
    return 2 if h >= 128 else 1


def tc_unit_planes(n_layers: int, gmode: str, rff: bool) -> int:
    """bf16 planes of h values a row that the sweep saves for the dW
    kernel: per h x h layer x_in's hi (and lo in bf16x3) and gpre's hi (and
    lo in bf16x2 / bf16x3); an RFF model's gpre0 planes after them."""
    x = 2 if gmode == "bf16x3" else 1
    gp = 1 if gmode == "bf16" else 2
    return (n_layers - 2) * (x + gp) + (gp if rff else 0)


@dataclasses.dataclass(frozen=True)
class TcPlan:
    """The tensor-core route's structure for one grad launch: ``slices`` a
    window, its row chunks (``chunks`` of at most ``chunk_tiles`` tiles,
    ``rows_cap`` rows of planes a unit), a unit's planes (``unit_elems``
    bf16), the weight planes a window (``wq`` bf16 each of hi and lo: the
    h x h layers' W, an RFF W0, and the h x h W transposed), the windows of
    a launch group, the units of a pass, and the row tiles a sweep CTA
    carries at once (``group``, ``sweep_group``)."""

    slices: int
    chunk_tiles: int
    chunks: int
    rows_cap: int
    unit_elems: int
    wq: int
    windows: int
    units: int
    group: int

    def scratch_bytes(self, P: int, n_layers: int) -> tuple[int, int]:
        """(bytes of a launch group's slabs, losses and weight planes,
        bytes of a pass's planes and pres)."""
        group = self.windows * (self.slices * (4 * P + 4) + 4 * self.wq)
        unit = 2 * self.unit_elems + 4 * n_layers * TILE_FLOATS * self.group
        return group, self.units * unit


def tc_plan(g: "GradLaunch", gmode: str) -> TcPlan:
    """Slices and chunks from the shapes alone; windows a group within
    SCRATCH_BYTES (slabs and weight planes) and units a pass within
    PLANE_BYTES (planes and pres), at least one of each.  Neither grouping
    changes a result: every unit's rows are its own, its chunks run in
    order, and the reduce sums the slices in order."""
    h, L = g.h, len(g.plan.kinds)
    n_freq = 0 if g.bt is None else g.bt.shape[1]
    slices = tc_slices(g.tiles, h)
    per_slice = -(-g.tiles // slices)
    chunks = -(-per_slice // CHUNK_TILES)
    rows_cap = min(CHUNK_TILES, per_slice) * tile_rows(h)
    unit_elems = (tc_unit_planes(L, gmode, n_freq > 0) * rows_cap * h)
    wq = 2 * (L - 2) * h * h + 2 * n_freq * h
    per_window = slices * (4 * g.layout.size + 4) + 4 * wq
    windows = max(1, min(g.k, SCRATCH_BYTES // per_window))
    group = sweep_group(h)
    per_unit = 2 * unit_elems + 4 * L * TILE_FLOATS * group
    units = max(1, min(windows * slices, PLANE_BYTES // per_unit))
    return TcPlan(slices, CHUNK_TILES, chunks, rows_cap, unit_elems, wq,
                  windows, units, group)


def tc_traffic(g: "GradLaunch", gmode: str) -> dict[str, int]:
    """Device-memory bytes a step of the tensor-core route moves through
    its scratch: ``planes``, dW's operands written by the sweep and read by
    the dW kernel, and ``slabs``, each unit's slab written once a chunk and
    read by the reduce.  ``fma_slabs`` is the FMA route's slab traffic at
    the same shapes: a tile's dW added into its slice's slab (P floats read
    and written) on every row tile."""
    tp = tc_plan(g, gmode)
    n_freq = 0 if g.bt is None else g.bt.shape[1]
    rows = g.tiles * tile_rows(g.h)
    per_row = 2 * g.h * tc_unit_planes(len(g.plan.kinds), gmode, n_freq > 0)
    P4 = 4 * g.layout.size
    return {"planes": 2 * g.k * rows * per_row,
            "slabs": g.k * tp.slices * (tp.chunks + 1) * P4,
            "fma_slabs": g.k * 2 * g.tiles * P4}


def tc_passes(units: int, per_pass: int) -> list[tuple[int, int]]:
    """(first unit, units) of each pass over ``units`` units, at most
    ``per_pass`` a pass, in passes of equal size (the last may be
    smaller)."""
    passes = -(-units // per_pass)
    size = -(-units // passes)
    return [(u0, min(size, units - u0)) for u0 in range(0, units, size)]


def grad_dot_mode() -> str:
    """The backward matmul tier: INRAUDIO_GRAD_PRECISION (default bf16x2;
    'inherit' or '' = the f32 tier), resolved as ``stack_plan`` resolves
    the forward's: anything but bf16x3 / bf16x2 / bf16 is 'highest'."""
    mode = os.environ.get("INRAUDIO_GRAD_PRECISION", "bf16x2")
    if mode in ("", "inherit"):
        mode = _f32_dot_mode()
    return mode if mode in ("bf16x3", "bf16x2", "bf16") else "highest"


def check_kernel_width(cfg: SirenSnakeTanhConfig) -> None:
    """The fused kernels take every h up to 256 (a width between the
    kernel widths runs zero-padded to the next one); wider raises rather
    than routing elsewhere."""
    if not 1 <= cfg.hidden_features <= 256:
        raise ValueError(
            f"the fused kernels take hidden widths 1..256, got "
            f"{cfg.hidden_features}: train this width with fused=False")


# ---------------------------------------------------------------------------
# Flat parameter layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Where each leaf lives in a window's flat float32 vector:
    ``leaves[i] = (layer, key, offset, shape)``, offsets multiples of 4;
    ``size`` (P) a multiple of 4.  The shapes are at the kernel width
    ``h``; a narrower model is zero-padded to it."""

    leaves: tuple[tuple[int, str, int, tuple[int, ...]], ...]
    size: int
    h: int

    def offsets(self, n_layers: int) -> list[int]:
        """[w, b, a] offsets per layer (a = -1 where there is none)."""
        out = [-1] * (3 * n_layers)
        slot = {"w": 0, "b": 1, "snake_a": 2}
        for li, key, off, _ in self.leaves:
            out[3 * li + slot[key]] = off
        return out


def _round4(x: int) -> int:
    return (x + 3) // 4 * 4


def flat_layout(cfg: SirenSnakeTanhConfig) -> FlatLayout:
    kinds = cfg.layer_kinds
    h = kernel_width(cfg.hidden_features)
    leaves, off = [], 0
    for li, kind in enumerate(kinds):
        in_f = cfg.in_features if li == 0 else h
        out_f = cfg.out_features if li == len(kinds) - 1 else h
        shapes = [("w", (in_f, out_f)), ("b", (out_f,))]
        if kind == "linear_snake":
            shapes.append(("snake_a", (out_f,)))
        for key, shape in shapes:
            leaves.append((li, key, off, shape))
            size = 1
            for s in shape:
                size *= s
            off = _round4(off + size)
    return FlatLayout(tuple(leaves), off, h)


def flatten_params(params: Params, cfg: SirenSnakeTanhConfig,
                   a_fill: float = 1.0) -> torch.Tensor:
    """Stacked params (leading window axis k) -> a new contiguous (k, P)
    float32 tensor, zero between leaves.  A tree at the model's own width
    is padded to the layout's kernel width (``pad_params``; ``a_fill`` the
    padded snake a: 1.0 for parameters, 0.0 for moments)."""
    layout = flat_layout(cfg)
    params = pad_params(params, layout.h, a_fill)
    first = params["layers"][0]["w"]
    k = first.shape[0]
    flat = torch.zeros((k, layout.size), dtype=torch.float32,
                       device=first.device)
    for li, key, off, shape in layout.leaves:
        v = params["layers"][li][key]
        n = v[0].numel()
        flat[:, off:off + n] = v.reshape(k, n)
    return flat


def unflatten_params(flat: torch.Tensor, cfg: SirenSnakeTanhConfig) -> Params:
    """(k, P) -> stacked params at the layout's kernel width, whose leaves
    are views into ``flat`` (``unpad_params`` gives the model's own)."""
    layout = flat_layout(cfg)
    k = flat.shape[0]
    layers: list[Params] = [{} for _ in cfg.layer_kinds]
    for li, key, off, shape in layout.leaves:
        n = 1
        for s in shape:
            n *= s
        layers[li][key] = flat[:, off:off + n].reshape(k, *shape)
    return {"layers": layers}


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU; the reference the kernels are held to)
# ---------------------------------------------------------------------------

def fwd_pres_plain(params: Params, plan: StackPlan, coords: torch.Tensor,
                   bt: torch.Tensor | None = None):
    """The stack forward keeping each layer's (input, pre-activation, snake
    a) -> (out, saved).  Same arithmetic as ``stack_forward_plain``; an RFF
    layer 0's saved input is its feature pair (cos v, sin v)."""
    _check_rff_plan(plan, bt)
    x0 = coords.to(torch.float32)
    x = x0
    saved = []
    for li, p in enumerate(params["layers"]):
        w, b = p["w"], p["b"].unsqueeze(-2)
        if li == 0 and bt is not None:
            x = rff_features_plain(x0, bt, plan.feature_degree)
            pre = rff_pre_plain(x, w, plan.modes[0]) + b
        elif li == 0:
            pre = b
            for d in range(x0.shape[1]):
                pre = pre + x0[:, d:d + 1] * w[..., d:d + 1, :]
        else:
            pre = _kernel_dot(x, w, plan.modes[li]) + b
        kind, deg, a = plan.kinds[li], plan.degrees[li], None
        if kind in ("sine_first", "sine"):
            out = _sin(plan.omegas[li] * pre, deg)
        elif kind == "linear_snake":
            a = p["snake_a"].unsqueeze(-2)
            out = pre + (0.5 / a) * (1.0 - _cos(2.0 * a * pre, deg))
        elif kind == "linear_tanh":
            out = torch.tanh(pre)
        else:
            out = pre
        if li < len(plan.kinds) - 1 and plan.width < out.shape[-1]:
            # a model padded to a kernel width: its padded units output
            # exactly 0, as in the kernel
            out = torch.nn.functional.pad(
                out[..., :plan.width], (0, out.shape[-1] - plan.width))
        saved.append((x, pre, a))
        x = out
    return x, saved


def bwd_sweep_plain(g: torch.Tensor, saved, params: Params, plan: StackPlan,
                    gmode: str) -> Params:
    """Reverse walk over the stack: backprop the output cotangent ``g``
    ((k, n, out) or (n, out)) through the saved (input, pre) pairs ->
    gradients in the params' layout.  Port of ``_bwd_sweep`` (explicit
    tier-emulated products, not autograd, so the grad tier matches)."""
    layers: list[Params] = [{} for _ in plan.kinds]
    for li in range(len(plan.kinds) - 1, -1, -1):
        kind, om, deg = plan.kinds[li], plan.omegas[li], plan.degrees[li]
        x_in, pre, a = saved[li]
        if kind in ("sine_first", "sine"):
            gpre = g * (om * _cos(om * pre, deg))
        elif kind == "linear_snake":
            s2 = _sin(2.0 * a * pre, deg)
            c2 = _cos(2.0 * a * pre, deg)
            gpre = g * (1.0 + s2)
            ga = (-(0.5 / (a * a)) * (1.0 - c2) + (pre / a) * s2) * g
            layers[li]["snake_a"] = ga.sum(dim=-2)
        elif kind == "linear_tanh":
            t = torch.tanh(pre)
            gpre = g * (1.0 - t * t)
        else:
            gpre = g
        if isinstance(x_in, tuple):  # RFF features: no gradient for B
            layers[li]["w"] = torch.cat(
                [_kernel_dot(f.transpose(-1, -2), gpre, gmode)
                 for f in x_in], dim=-2)
        else:
            layers[li]["w"] = _kernel_dot(x_in.transpose(-1, -2), gpre,
                                          gmode)
        layers[li]["b"] = gpre.sum(dim=-2)
        if li > 0:
            w = params["layers"][li]["w"]
            g = _kernel_dot(gpre, w.transpose(-1, -2), gmode)
    return {"layers": layers}


def backward_plain(params: Params, plan: StackPlan, gmode: str,
                   coords: torch.Tensor, cot: torch.Tensor,
                   bt: torch.Tensor | None = None) -> Params:
    """Gradients of <cot, stack(params, coords)> w.r.t. params."""
    _, saved = fwd_pres_plain(params, plan, coords, bt)
    return bwd_sweep_plain(cot, saved, params, plan, gmode)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/siren_train.cu)
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong


class _TrainLibrary:
    """``csrc/siren_train.cu`` built once per process (at first use), with
    extra ``-D`` flags ``defines`` (none on every route)."""

    def __init__(self, defines: tuple[str, ...] = ()):
        self._lib = None
        self.defines = defines

    def __call__(self):
        if self._lib is None:
            lib = build_library("siren_train", ["siren_train.cu"],
                                self.defines)
            lib.siren_grad.argtypes = ([_P] * 10 + [_I] * 8 + [_F, _F, _P]
                                       + [_I] * 3 + [_P, _P, _P])
            lib.siren_reduce.argtypes = [_P] * 5 + [_I, _I, _I, _P]
            lib.siren_adam.argtypes = [_P] * 13 + [_I] * 4 + [_F, _P]
            lib.siren_adam_global_cap.argtypes = []
            lib.siren_adam_global.argtypes = [_P] * 11 + [_I, _I, _F, _P]
            lib.siren_wsplit.argtypes = [_P] * 6 + [_I] * 5 + [_P]
            lib.siren_sweep.argtypes = ([_P] * 13 + [_I] * 7 + [_F, _F, _P]
                                        + [_I] * 8 + [_L, _I, _P, _P, _P])
            lib.siren_dw.argtypes = ([_P] * 6 + [_I] * 6 + [_P] + [_I] * 8
                                     + [_L, _P])
            for fn in (lib.siren_grad, lib.siren_reduce, lib.siren_adam,
                       lib.siren_adam_global_cap, lib.siren_adam_global,
                       lib.siren_wsplit, lib.siren_sweep, lib.siren_dw):
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib


TRAIN_LIBRARY = _TrainLibrary()


def _check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


@dataclasses.dataclass
class GradLaunch:
    """Validated arguments of one grad-accumulation launch (``bt``: an RFF
    model's 2 pi B^T, (d, F))."""

    k: int
    n: int
    d: int
    h: int         # the kernel width (the model's own is plan.width)
    tiles: int
    layout: FlatLayout
    plan: StackPlan
    bt: torch.Tensor | None = None

    @property
    def slices(self) -> int:
        return row_slices(self.tiles)


def validate_grad_launch(flat: torch.Tensor, cfg: SirenSnakeTanhConfig,
                         plan: StackPlan, coords: torch.Tensor,
                         bt: torch.Tensor | None = None) -> GradLaunch:
    """Shape / dtype / device checks shared by the C and D wrappers."""
    dev = coords.device
    n, d = coords.shape
    check_kernel_width(cfg)
    _check_rff_plan(plan, bt)
    layout = flat_layout(cfg)
    h = layout.h
    if not 1 <= plan.width <= h:
        raise ValueError(f"the plan's width {plan.width} is not within the "
                         f"kernel width {h}")
    L = len(plan.kinds)
    _check_tensor("coords", coords, dev, (n, d))
    in_f = cfg.in_features if bt is None else d
    if not 1 <= d <= _MAX_SMALL_IN or d != in_f:
        raise ValueError(f"kernel takes 1..{_MAX_SMALL_IN} raw input columns "
                         f"matching the config, got {d}")
    if bt is not None:
        _check_tensor("bt", bt, dev, (d, bt.shape[1]))
        if cfg.in_features != 2 * bt.shape[1]:
            raise ValueError(f"cfg.in_features ({cfg.in_features}) != 2*F "
                             f"({2 * bt.shape[1]})")
    if cfg.out_features != 1:
        raise ValueError("the training kernels take out_features == 1")
    if not 2 <= L <= _KERNEL_MAX_LAYERS:
        raise ValueError(f"kernel takes 2..{_KERNEL_MAX_LAYERS} layers, "
                         f"got {L}")
    k = flat.shape[0]
    _check_tensor("params", flat, dev, (k, layout.size), aligned=True)
    if n < 1 or k < 1:
        raise ValueError("kernel takes at least one window and one row")
    return GradLaunch(k, n, d, h, -(-n // tile_rows(h)), layout, plan, bt)


def window_group(g: GradLaunch) -> int:
    """Windows per grad + reduce launch of the FMA route (the highest
    tier; ``tc_plan`` groups the tensor-core route's): as many as
    ``SCRATCH_BYTES`` of
    partial grads and saved pre-activations hold, at least one.  A window
    takes at most ``MAX_SLICES`` slabs (row slices), so the scratch of a
    step is bounded whatever the clip's length."""
    per_window = g.slices * (g.layout.size + len(g.plan.kinds) * TILE_FLOATS)
    return max(1, min(g.k, SCRATCH_BYTES // (4 * per_window)))


def launch_grad(lib, g: GradLaunch, coords, flat, stream, partial, pre,
                loss_part, w0: int, kn: int, *, targets=None, cot=None,
                gmode: str, limit=None, n_valid: int | None = None,
                weight=None) -> None:
    """Grad-accumulation kernel over windows [w0, w0 + kn): each (window,
    row slice)'s partial grads into ``partial`` (kn * slices, P), its loss
    into ``loss_part`` (k * slices) at the window's place.  ``limit``: a
    device int32 (1,) row limit (rows at or past it carry no loss; None:
    every row); ``n_valid``: the loss's normaliser rows (None: n);
    ``weight``: the MSE's per-row weight (k, n), or None."""
    offs, ints, om = _layer_arrays(g)
    row = lambda t, width: 0 if t is None else t.data_ptr() + 4 * w0 * width
    n_freq = 0 if g.bt is None else g.bt.shape[1]
    inv_n = 1.0 / float(g.n if n_valid is None else n_valid)
    rc = lib.siren_grad(
        coords.data_ptr(), row(flat, g.layout.size), partial.data_ptr(),
        row(loss_part, g.slices), pre.data_ptr(), row(targets, g.n),
        row(cot, g.n), ctypes.addressof(offs), ctypes.addressof(ints),
        ctypes.addressof(om), len(g.plan.kinds), kn, g.n, g.d, g.h,
        g.plan.width, g.layout.size, _MODE_CODE[gmode], inv_n, 2.0 * inv_n,
        row(g.bt, 0), n_freq, g.plan.feature_degree, g.slices, row(limit, 0),
        row(weight, g.n), stream)
    _check_rc("siren_grad", rc)


def _layer_arrays(g: GradLaunch):
    """The kernels' per-layer host arrays: int32 [w, b, a offsets] and
    int32 [kind, forward mode, degree] per layer, and float omegas."""
    L = len(g.plan.kinds)
    offs = g.layout.offsets(L)
    ints = []
    for li in range(L):
        ints += [_KIND_CODE[g.plan.kinds[li]],
                 _MODE_CODE[g.plan.modes[li] or "highest"],
                 g.plan.degrees[li]]
    return ((ctypes.c_int32 * len(offs))(*offs),
            (ctypes.c_int32 * len(ints))(*ints),
            (ctypes.c_float * L)(*g.plan.omegas))


def launch_reduce(lib, g: GradLaunch, partial, grads, sq_part, w0: int,
                  kn: int, stream, loss_part=None, loss_out=None,
                  slices: int | None = None) -> None:
    """Sum windows [w0, w0 + kn)'s row-slice partials (``slices`` a window,
    default the FMA route's) in a fixed order into their rows of ``grads``
    (k, P), and their per-chunk sums of squares into ``sq_part`` (k,
    chunks).  With ``loss_out`` (kernel E), also each window's loss, its
    slices of ``loss_part`` (k * slices) summed in order, into ``loss_out``
    (k)."""
    slices = g.slices if slices is None else slices
    rc = lib.siren_reduce(
        partial.data_ptr(), grads.data_ptr() + 4 * w0 * g.layout.size,
        sq_part.data_ptr() + 4 * w0 * sq_part.shape[1],
        0 if loss_out is None else loss_part.data_ptr() + 4 * w0 * slices,
        0 if loss_out is None else loss_out.data_ptr() + 4 * w0, kn,
        slices, g.layout.size, stream)
    _check_rc("siren_reduce", rc)


def tc_launches(lib, g: GradLaunch, coords, flat, stream, *, targets=None,
                cot=None, gmode: str, limit=None, n_valid: int | None = None,
                grads=None, loss_out=None, weight=None):
    """The tensor-core route of ``grad_reduce`` (``tc_plan``) as its
    launches in order: per launch group the weights' bf16 planes
    (``siren_wsplit``), then per row chunk and pass of units the sweep and
    the dW kernel, then the reduce.  Each sweep launch adds one to the
    counter ``sweep.launches.g<G>``, G its row tiles a CTA
    (``sweep_group``).  Returns ([(kernel name, launch)],
    (grads, sq_part, loss_part), scratch): the outputs are filled once
    every launch has run, and the caller holds ``scratch`` (the buffers
    and host arrays the launches point at) while they run."""
    dev = coords.device
    f32 = dict(dtype=torch.float32, device=dev)
    bf16 = dict(dtype=torch.bfloat16, device=dev)
    tp = tc_plan(g, gmode)
    S, kg, L, P = tp.slices, tp.windows, len(g.plan.kinds), g.layout.size
    partial = torch.empty((kg * S, P), **f32)
    pre = torch.empty((tp.units, L, tp.group * TILE_FLOATS), **f32)
    planes = torch.empty((tp.units, max(1, tp.unit_elems)), **bf16)
    whi = torch.empty((kg, max(1, tp.wq)), **bf16)
    wlo = torch.empty_like(whi)
    if grads is None:
        grads = torch.empty((g.k, P), **f32)
    sq_part = torch.empty((g.k, -(-P // CHUNK_FLOATS)), **f32)
    loss_part = torch.empty((g.k * S,), **f32)
    arrays = _layer_arrays(g)
    n_freq = 0 if g.bt is None else g.bt.shape[1]
    inv_n = 1.0 / float(g.n if n_valid is None else n_valid)
    bt = 0 if g.bt is None else g.bt.data_ptr()
    lim = 0 if limit is None else limit.data_ptr()
    gm = _MODE_CODE[gmode]
    ptrs = [ctypes.addressof(a) for a in arrays]
    launches = []
    sweeps = counter(f"sweep.launches.g{tp.group}")

    def call(name, *args, count=None):
        def run():
            _check_rc(name, getattr(lib, name)(*args))
            if count is not None:
                count.add()
        launches.append((name, run))

    for w0 in range(0, g.k, kg):
        kn = min(kg, g.k - w0)
        row = lambda t, width: 0 if t is None else (t.data_ptr()
                                                    + 4 * w0 * width)
        call("siren_wsplit", row(flat, P), whi.data_ptr(), wlo.data_ptr(),
             *ptrs, L, kn, g.h, P, n_freq, stream)
        for chunk in range(tp.chunks):
            for u0, nu in tc_passes(kn * S, tp.units):
                call("siren_sweep", coords.data_ptr(), row(flat, P),
                     whi.data_ptr(), wlo.data_ptr(), partial.data_ptr(),
                     row(loss_part, S), pre.data_ptr(), planes.data_ptr(),
                     row(targets, g.n), row(cot, g.n), *ptrs, L, g.n, g.d,
                     g.h, g.plan.width, P, gm, inv_n, 2.0 * inv_n, bt, n_freq,
                     g.plan.feature_degree, S, u0, nu, chunk, tp.chunk_tiles,
                     tp.rows_cap, tp.unit_elems, tp.group, lim,
                     row(weight, g.n), stream, count=sweeps)
                call("siren_dw", coords.data_ptr(), partial.data_ptr(),
                     planes.data_ptr(), *ptrs, L, g.n, g.d, g.h, P, gm, bt,
                     n_freq, g.plan.feature_degree, S, u0, nu, chunk,
                     tp.chunk_tiles, tp.rows_cap, tp.unit_elems, stream)
        launches.append(("siren_reduce", lambda w0=w0, kn=kn: launch_reduce(
            lib, g, partial, grads, sq_part, w0, kn, stream, loss_part,
            loss_out, slices=S)))
    scratch = (partial, pre, planes, whi, wlo, arrays)
    return launches, (grads, sq_part, loss_part), scratch


def grad_reduce(lib, g: GradLaunch, coords, flat, stream, *, targets=None,
                cot=None, gmode: str, limit=None, n_valid: int | None = None,
                grads=None, loss_out=None, weight=None):
    """Each window's gradient -> (grads (k, P), sq_part (k, chunks),
    loss_part (k * slices)).  All on the current stream, no host sync.
    Kernel E passes its row ``limit``, the whole clip's ``n_valid``, and
    ``grads`` / ``loss_out`` views of its packed buffer, which receive each
    window's gradient and loss.  D and E may pass the MSE's per-row
    ``weight`` (k, n).  The bf16 tiers take the tensor-core route
    (``tc_route``); the highest tier the FMA kernel, over groups of
    ``window_group`` windows that share one scratch."""
    if tc_route(g.plan, gmode):
        launches, out, scratch = tc_launches(
            lib, g, coords, flat, stream, targets=targets, cot=cot,
            gmode=gmode, limit=limit, n_valid=n_valid, grads=grads,
            loss_out=loss_out, weight=weight)
        for _, run in launches:
            run()
        del scratch  # the stream orders its reuse after these launches
        return out
    dev = coords.device
    f32 = dict(dtype=torch.float32, device=dev)
    kg = window_group(g)
    partial = torch.empty((kg * g.slices, g.layout.size), **f32)
    pre = torch.empty((kg * g.slices, len(g.plan.kinds), TILE_FLOATS), **f32)
    if grads is None:
        grads = torch.empty((g.k, g.layout.size), **f32)
    sq_part = torch.empty((g.k, -(-g.layout.size // CHUNK_FLOATS)), **f32)
    loss_part = torch.empty((g.k * g.slices,), **f32)
    for w0 in range(0, g.k, kg):
        kn = min(kg, g.k - w0)
        launch_grad(lib, g, coords, flat, stream, partial, pre, loss_part,
                    w0, kn, targets=targets, cot=cot, gmode=gmode,
                    limit=limit, n_valid=n_valid, weight=weight)
        launch_reduce(lib, g, partial, grads, sq_part, w0, kn, stream,
                      loss_part, loss_out)
    return grads, sq_part, loss_part


class _SirenBwdKernel(LaunchCounter):
    """Kernel C: the backward of the stack for a supplied cotangent
    (grad accumulation + the fixed-order reduce).  ``launches`` rises by
    one per backward launched, nowhere else."""

    def __call__(self, params: Params, cfg: SirenSnakeTanhConfig,
                 plan: StackPlan, gmode: str, coords: torch.Tensor,
                 cot: torch.Tensor, bt: torch.Tensor | None = None) -> Params:
        """Stacked params (k, ...) on one CUDA device, coords (n, d),
        cotangent (k, n, 1) -> stacked grads (views into one (k, P)), at
        the params' width (the model's own, or padded to the kernel
        width).  ``bt``: an RFF model's 2 pi B^T (d, F)."""
        flat = flatten_params(params, cfg)
        g = validate_grad_launch(flat, cfg, plan, coords, bt)
        cot = cot.reshape(g.k, g.n)
        _check_tensor("cotangent", cot, coords.device, (g.k, g.n))
        lib = TRAIN_LIBRARY()
        with torch.cuda.device(coords.device):
            stream = torch.cuda.current_stream(coords.device).cuda_stream
            grads, _, _ = grad_reduce(lib, g, coords, flat, stream, cot=cot,
                                      gmode=gmode)
        self.count()
        grads = unflatten_params(grads, cfg)
        h = params["layers"][0]["w"].shape[-1]
        return grads if h == g.h else unpad_params(grads, h)


SIREN_BWD = _SirenBwdKernel("siren_bwd")


def siren_backward(params: Params, cfg: SirenSnakeTanhConfig, plan: StackPlan,
                   gmode: str, coords: torch.Tensor, cot: torch.Tensor,
                   bt: torch.Tensor | None = None) -> Params:
    """Gradients of the stacked stack for cotangent ``cot`` (k, n, 1): the
    plain version for CPU tensors, kernel C for CUDA ones."""
    if coords.device.type == "cpu":
        return backward_plain(params, plan, gmode, coords, cot, bt)
    if coords.device.type != "cuda":
        raise ValueError(f"no fused backward for device {coords.device}")
    return SIREN_BWD(params, cfg, plan, gmode, coords, cot.contiguous(), bt)


class _FusedStack(torch.autograd.Function):
    """Forward: the stack kernel; backward: kernel C (plain versions on the
    CPU).  Port of the JAX package's ``_fused_stack`` custom VJP.  ``bt``
    (an RFF model's 2 pi B^T, or None) is a constant: no gradient."""

    @staticmethod
    def forward(ctx, cfg, plan, coords, bt, *leaves):
        params = _tree_from_leaves(leaves, plan)
        if coords.device.type == "cpu":
            out = stack_forward_plain(params, plan, coords, bt)
        elif coords.device.type == "cuda":
            out = SIREN_STACK(params, plan, coords, bt)
        else:
            raise ValueError(f"no fused stack for device {coords.device}")
        ctx.cfg, ctx.plan, ctx.bt = cfg, plan, bt
        ctx.gmode = grad_dot_mode()
        ctx.save_for_backward(coords, *leaves)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        coords, *leaves = ctx.saved_tensors
        params = _tree_from_leaves(leaves, ctx.plan)
        grads = siren_backward(params, ctx.cfg, ctx.plan, ctx.gmode, coords,
                               grad_out, ctx.bt)
        out = [grads["layers"][li][key]
               for li, key in _leaf_keys(ctx.plan)]
        return (None, None, None, None, *out)


def _leaf_keys(plan: StackPlan) -> list[tuple[int, str]]:
    keys = []
    for li, kind in enumerate(plan.kinds):
        keys += [(li, "w"), (li, "b")]
        if kind == "linear_snake":
            keys.append((li, "snake_a"))
    return keys


def _tree_from_leaves(leaves, plan: StackPlan) -> Params:
    layers: list[Params] = [{} for _ in plan.kinds]
    for (li, key), v in zip(_leaf_keys(plan), leaves):
        layers[li][key] = v
    return {"layers": layers}


def fused_siren_train_apply(params: Params, cfg: SirenSnakeTanhConfig,
                            coords: torch.Tensor, approx_sin: bool = False,
                            rff_b: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Differentiable fused forward: params with or without a leading
    window axis, coords (n, d) -> (k, n, 1) or (n, 1).  Drop-in for
    ``siren_snake_tanh_apply`` under autograd; its backward is kernel C on
    a card.  Unlike the TPU kernels, any n and k are taken as they are.
    ``rff_b`` (F, d) folds the model's Gaussian Fourier encoding into both
    kernels (``coords`` raw, ``cfg.in_features`` = 2F); B is fixed, so it
    gets no gradient, as under ``rff_apply``.  The call is the span
    ``inr.stack`` (``utils.observability.span``)."""
    with span("inr.stack"):
        check_kernel_width(cfg)
        _check_rff_model(cfg, rff_b)
        plan = stack_plan(cfg, approx_sin=approx_sin, rff=rff_b is not None)
        bt = None if rff_b is None else _prep_rff_bt(rff_b)
        stacked = params["layers"][0]["w"].dim() == 3
        if not stacked:
            params = {"layers": [{k: v.unsqueeze(0) for k, v in p.items()}
                                 for p in params["layers"]]}
        for li, layer in enumerate(params["layers"]):
            for key, v in layer.items():
                if v.device != coords.device:
                    raise ValueError(f"layers[{li}].{key} is on {v.device}, "
                                     f"coords on {coords.device}")
        leaves = [params["layers"][li][key].contiguous()
                  for li, key in _leaf_keys(plan)]
        out = _FusedStack.apply(cfg, plan, coords.contiguous(), bt, *leaves)
        return out if stacked else out[0]
