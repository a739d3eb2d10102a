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

The grad kernel's scratch is bounded per window: a window of more row
tiles than ``MAX_SLICES`` goes through ``MAX_SLICES`` row slices, each CTA
walking its slice's tiles in order into one slab of partial grads.

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
# floats per CTA of the reduce / Adam kernels
CHUNK_FLOATS = 1024
# device memory for one grad launch's partial grads and saved
# pre-activations; larger populations go through in groups of windows
SCRATCH_BYTES = 1 << 30
# row slices of a window of more row tiles than this (two waves of CTAs on
# the H100's 132 SMs at one model): each slice's CTA walks its tiles in
# order into one slab, so a window's scratch stays at most MAX_SLICES slabs
# whatever its length.  Windows of fewer tiles keep one tile per slice.
MAX_SLICES = 264


def tile_rows(h: int) -> int:
    return TILE_FLOATS // h


def row_slices(tiles: int) -> int:
    """Row slices of a window of ``tiles`` row tiles: a function of the
    shapes only, never of SCRATCH_BYTES, so the grouping of windows leaves
    every result bit-equal."""
    return min(tiles, MAX_SLICES)


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


class _TrainLibrary:
    """``csrc/siren_train.cu`` built once per process (at first use)."""

    def __init__(self):
        self._lib = None

    def __call__(self):
        if self._lib is None:
            lib = build_library("siren_train", ["siren_train.cu"])
            lib.siren_grad.argtypes = ([_P] * 10 + [_I] * 8 + [_F, _F, _P]
                                       + [_I] * 3 + [_P, _P])
            lib.siren_reduce.argtypes = [_P] * 5 + [_I, _I, _I, _P]
            lib.siren_adam.argtypes = [_P] * 12 + [_I, _I, _I, _F, _P]
            lib.siren_adam_global.argtypes = [_P] * 11 + [_I, _F, _P]
            for fn in (lib.siren_grad, lib.siren_reduce, lib.siren_adam,
                       lib.siren_adam_global):
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
    """Windows per grad + reduce launch: as many as ``SCRATCH_BYTES`` of
    partial grads and saved pre-activations hold, at least one.  A window
    takes at most ``MAX_SLICES`` slabs (row slices), so the scratch of a
    step is bounded whatever the clip's length."""
    per_window = g.slices * (g.layout.size + len(g.plan.kinds) * TILE_FLOATS)
    return max(1, min(g.k, SCRATCH_BYTES // (4 * per_window)))


def launch_grad(lib, g: GradLaunch, coords, flat, stream, partial, pre,
                loss_part, w0: int, kn: int, *, targets=None, cot=None,
                gmode: str, limit=None, n_valid: int | None = None) -> None:
    """Grad-accumulation kernel over windows [w0, w0 + kn): each (window,
    row slice)'s partial grads into ``partial`` (kn * slices, P), its loss
    into ``loss_part`` (k * slices) at the window's place.  ``limit``: a
    device int32 (1,) row limit (rows at or past it carry no loss; None:
    every row); ``n_valid``: the loss's normaliser rows (None: n)."""
    L = len(g.plan.kinds)
    offs = g.layout.offsets(L)
    ints = []
    for li in range(L):
        ints += [_KIND_CODE[g.plan.kinds[li]],
                 _MODE_CODE[g.plan.modes[li] or "highest"],
                 g.plan.degrees[li]]
    c_offs = (ctypes.c_int32 * len(offs))(*offs)
    c_ints = (ctypes.c_int32 * len(ints))(*ints)
    c_om = (ctypes.c_float * L)(*g.plan.omegas)
    row = lambda t, width: 0 if t is None else t.data_ptr() + 4 * w0 * width
    n_freq = 0 if g.bt is None else g.bt.shape[1]
    inv_n = 1.0 / float(g.n if n_valid is None else n_valid)
    rc = lib.siren_grad(
        coords.data_ptr(), row(flat, g.layout.size), partial.data_ptr(),
        row(loss_part, g.slices), pre.data_ptr(), row(targets, g.n),
        row(cot, g.n), ctypes.addressof(c_offs), ctypes.addressof(c_ints),
        ctypes.addressof(c_om), L, kn, g.n, g.d, g.h, g.plan.width,
        g.layout.size, _MODE_CODE[gmode], inv_n, 2.0 * inv_n, row(g.bt, 0),
        n_freq,
        g.plan.feature_degree, g.slices, row(limit, 0), stream)
    _check_rc("siren_grad", rc)


def launch_reduce(lib, g: GradLaunch, partial, grads, sq_part, w0: int,
                  kn: int, stream, loss_part=None, loss_out=None) -> None:
    """Sum windows [w0, w0 + kn)'s row-slice partials in a fixed order into
    their rows of ``grads`` (k, P), and their per-chunk sums of squares
    into ``sq_part`` (k, chunks).  With ``loss_out`` (kernel E), also each
    window's loss, its slices of ``loss_part`` (k * slices) summed in
    order, into ``loss_out`` (k)."""
    rc = lib.siren_reduce(
        partial.data_ptr(), grads.data_ptr() + 4 * w0 * g.layout.size,
        sq_part.data_ptr() + 4 * w0 * sq_part.shape[1],
        0 if loss_out is None else loss_part.data_ptr() + 4 * w0 * g.slices,
        0 if loss_out is None else loss_out.data_ptr() + 4 * w0, kn,
        g.slices, g.layout.size, stream)
    _check_rc("siren_reduce", rc)


def grad_reduce(lib, g: GradLaunch, coords, flat, stream, *, targets=None,
                cot=None, gmode: str, limit=None, n_valid: int | None = None,
                grads=None, loss_out=None):
    """Each window's gradient, over groups of ``window_group`` windows that
    share one scratch -> (grads (k, P), sq_part (k, chunks), loss_part
    (k * slices)).  All on the current stream, no host sync.  Kernel E
    passes its row ``limit``, the whole clip's ``n_valid``, and ``grads``
    / ``loss_out`` views of its packed buffer, which receive each window's
    gradient and loss."""
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
                    limit=limit, n_valid=n_valid)
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


SIREN_BWD = _SirenBwdKernel()


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
    gets no gradient, as under ``rff_apply``."""
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
