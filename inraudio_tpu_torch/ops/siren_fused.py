"""SirenWithSnakeTanh stack forward: the CUDA kernel and its plain version.

Port of ``inraudio_tpu/ops/pallas_siren.py``'s two forward kernels:
``_stack_kernel_multi`` (k windows on one shared coordinate grid, the
multi-INR decode) and ``_stack_kernel`` (one model over row tiles), with
the latter's RFF layer 0 (``_rff_features_in_kernel``).  On Hopper both are
the same computation, so one CUDA kernel (``csrc/siren_stack.cu``) serves
both; ``fused_siren_apply`` is its k = 1 call, and ``rff_b`` folds the
Gaussian Fourier encoding into its layer 0.  The TPU layout artefacts
(8-row bias bands, lane padding, packed (., 128) outputs, VMEM tile
pickers) are not ported.

Every quality tier of the reference is kept, with the same meaning
(``_run_layers``):

- ``approx_sin`` / ``sin_poly_degree`` in {7, 9, 11}: Cody-Waite reduction
  plus an odd polynomial instead of exact sin/cos;
- ``exact_first_sin``: layer 0 keeps exact sin under ``approx_sin``;
- ``compute_dtype`` bfloat16: every hidden matmul takes one bf16 pass;
- ``mixed_matmul``: snake, tanh and head layers take one bf16 pass, sine
  layers ``f32_mode``;
- ``f32_mode`` in {bf16, bf16x2, bf16x3 (default), highest}: the f32 matmul
  emulation ladder (``INRAUDIO_F32_PRECISION`` when None).

The wrappers run the plain PyTorch version only for tensors on the CPU; a
CUDA tensor launches the kernel or raises.  There is no fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import os
from typing import Any

import torch

from ..models.siren import SirenSnakeTanhConfig
from ..utils.observability import span
from ._nvcc import LaunchCounter, build_library

Params = dict[str, Any]

_MAX_SMALL_IN = 8
_KERNEL_WIDTHS = (32, 64, 128, 256)
_KERNEL_MAX_LAYERS = 16


def kernel_width(h: int) -> int:
    """The kernel width a model of hidden width ``h`` runs at: the smallest
    of ``_KERNEL_WIDTHS`` that holds it.  Wider than 256 raises."""
    for width in _KERNEL_WIDTHS:
        if h <= width:
            return width
    raise ValueError(f"the fused kernels take hidden widths up to "
                     f"{_KERNEL_WIDTHS[-1]}, got {h}")


def _pad_to(v: torch.Tensor, dims: tuple[int, ...], width: int,
            value: float) -> torch.Tensor:
    """``v`` with each of its trailing ``dims`` (negative axes) grown to
    ``width`` by ``value``."""
    pad = [0] * (2 * max((-d for d in dims), default=0))
    for d in dims:
        pad[2 * (-d - 1) + 1] = width - v.shape[d]
    if not any(pad):
        return v
    return torch.nn.functional.pad(v, pad, value=value)


def _hidden_dims(key: str, li: int, n_layers: int) -> tuple[int, ...]:
    """The trailing axes of leaf ``key`` of layer ``li`` that run over
    hidden units."""
    last = li == n_layers - 1
    if key == "w":
        return tuple(d for d, hidden in ((-1, not last), (-2, li > 0))
                     if hidden)
    return () if last else (-1,)


def pad_params(params: Params, width: int, a_fill: float = 1.0) -> Params:
    """A parameter tree (any leading window axes) zero-padded in its hidden
    units to ``width``: padded weight rows and columns and biases are 0,
    padded ``snake_a`` is ``a_fill`` (1.0 for parameters, where 0 would
    divide by zero in the snake; 0.0 for Adam moments and gradients).  A
    tree already at ``width`` comes back as it is."""
    L = len(params["layers"])
    return {"layers": [
        {key: _pad_to(v, _hidden_dims(key, li, L), width,
                      a_fill if key == "snake_a" else 0.0)
         for key, v in layer.items()}
        for li, layer in enumerate(params["layers"])]}


def unpad_params(params: Params, h: int) -> Params:
    """Views of a padded tree's first ``h`` hidden units: the inverse of
    ``pad_params``."""
    L = len(params["layers"])
    out = []
    for li, layer in enumerate(params["layers"]):
        new = {}
        for key, v in layer.items():
            for d in _hidden_dims(key, li, L):
                v = v.narrow(d, 0, h)
            new[key] = v
        out.append(new)
    return {"layers": out}


# Odd least-squares polynomials for sin on [-pi, pi], copied verbatim from
# the JAX package (max abs error: deg 11 3.05e-07, deg 9 1.7e-05, deg 7
# 6.6e-04).
_SIN_C = (0.99999970695822715, -0.16666577198087604, 0.0083325579983740631,
          -0.00019812572237557381, 2.7040473313016951e-06,
          -2.0534080047784251e-08)
_SIN_C9 = (0.9999845934510802, -0.16663259376823747, 0.008312388279692877,
           -0.00019316269888602924, 2.1732569600486186e-06)
_SIN_C7 = (0.999450173058242, -0.1658384294768091, 0.007998575320167381,
           -0.0001477404380785241)
_SIN_COEFFS = {11: _SIN_C, 9: _SIN_C9, 7: _SIN_C7}
_INV_TWO_PI = 0.15915494309189535
_HALF_PI = 1.5707963267948966
# Cody-Waite split of 2*pi: HI has a 5-bit mantissa, so k*HI is exact in
# f32 for |k| < 2^18; LO carries the rest.
_TWO_PI_HI = 6.28125
_TWO_PI_LO = 1.9353071795864769e-03


def _sin_poly(r: torch.Tensor, degree: int = 11) -> torch.Tensor:
    cs = _SIN_COEFFS[degree]
    r2 = r * r
    p = cs[-1]
    for c in cs[-2::-1]:
        p = p * r2 + c
    return r * p


def _fast_sin(x: torch.Tensor, degree: int = 11) -> torch.Tensor:
    """sin via Cody-Waite range reduction + odd polynomial.  torch.round
    rounds half to even, as jnp.round does."""
    k = torch.round(x * _INV_TWO_PI)
    r = (x - k * _TWO_PI_HI) - k * _TWO_PI_LO
    return _sin_poly(r, degree)


def _fast_cos(x: torch.Tensor, degree: int = 11) -> torch.Tensor:
    """cos(x) = sin(x + pi/2), the pi/2 shift applied to the reduced
    residual."""
    k = torch.round(x * _INV_TWO_PI + 0.25)
    r = (x - k * _TWO_PI_HI) - k * _TWO_PI_LO + _HALF_PI
    return _sin_poly(r, degree)


def _f32_dot_mode() -> str:
    """Default f32 matmul tier of the kernels: 'bf16x3', as in the JAX
    package (INRAUDIO_F32_PRECISION overrides)."""
    return os.environ.get("INRAUDIO_F32_PRECISION", "bf16x3")


# ---------------------------------------------------------------------------
# The per-layer plan shared by the kernel and its plain version
# ---------------------------------------------------------------------------

_KIND_CODE = {"sine_first": 1, "sine": 1, "linear_snake": 2, "linear_tanh": 3,
              "linear_last": 0}
_MODE_CODE = {"highest": 0, "bf16": 1, "bf16x2": 2, "bf16x3": 3}
_BF16_PASS_KINDS = ("linear_snake", "linear_tanh", "linear_last")


@dataclasses.dataclass(frozen=True)
class StackPlan:
    """Static per-layer recipe: kind, omega, matmul tier (None for a raw
    layer 0's exact multiply-adds; an RFF layer 0's features take the
    forward tier) and trig degree (0 = exact sin/cos), and the trig degree
    of an RFF model's features (layer 0's: ``exact_first_sin`` covers
    them, as in the JAX package)."""

    kinds: tuple[str, ...]
    omegas: tuple[float, ...]
    modes: tuple[str | None, ...]
    degrees: tuple[int, ...]
    # the model's own hidden width; a model zero-padded to a kernel width
    # keeps its units from here on at exactly 0 in the training kernels
    # and their plain versions
    width: int
    feature_degree: int = 0

    @property
    def rff(self) -> bool:
        return self.modes[0] is not None


def _is_bf16(dtype) -> bool:
    return dtype in (torch.bfloat16, "bfloat16")


def stack_plan(cfg: SirenSnakeTanhConfig, compute_dtype=torch.float32,
               approx_sin: bool = False, sin_poly_degree: int = 11,
               mixed_matmul: bool = False, f32_mode: str | None = None,
               exact_first_sin: bool = False, rff: bool = False) -> StackPlan:
    """The per-layer recipe of the forward tier given by the arguments;
    ``rff`` for a model whose layer 0 takes RFF features (its product in
    the forward tier: bf16 under a bfloat16 ``compute_dtype``, else
    ``f32_mode``; ``mixed_matmul`` does not reach it)."""
    kinds = cfg.layer_kinds
    if approx_sin and sin_poly_degree not in _SIN_COEFFS:
        raise ValueError(f"sin_poly_degree must be one of 7, 9, 11, got "
                         f"{sin_poly_degree}")
    f32 = f32_mode or _f32_dot_mode()
    f32 = f32 if f32 in ("bf16x3", "bf16x2", "bf16") else "highest"
    omegas, modes, degrees = [], [], []
    hidden_deg = sin_poly_degree if approx_sin else 0
    for li, kind in enumerate(kinds):
        omegas.append(float(cfg.first_omega_0 if kind == "sine_first" else
                            cfg.hidden_omega_0 if kind == "sine" else 0.0))
        if li == 0:
            modes.append(("bf16" if _is_bf16(compute_dtype) else f32)
                         if rff else None)
        elif _is_bf16(compute_dtype) or (mixed_matmul
                                         and kind in _BF16_PASS_KINDS):
            modes.append("bf16")
        else:
            modes.append(f32)
        degrees.append(0 if kind == "sine_first" and exact_first_sin
                       else hidden_deg)
    return StackPlan(kinds, tuple(omegas), tuple(modes), tuple(degrees),
                     cfg.hidden_features,
                     0 if exact_first_sin else hidden_deg)


# ---------------------------------------------------------------------------
# Plain PyTorch version (CPU tests; the reference the kernel is held to)
# ---------------------------------------------------------------------------

def _bf16r(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def _kernel_dot(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """x @ w in the given tier; bf16 operands emulated by rounding casts
    (a product of two bf16 values is exact in f32, so a true-f32 matmul of
    the rounded operands is the bf16 pass with f32 accumulation)."""
    if mode == "highest":
        return torch.matmul(x, w)
    xh, wh = _bf16r(x), _bf16r(w)
    if mode == "bf16":
        return torch.matmul(xh, wh)
    wl = _bf16r(w - wh)
    if mode == "bf16x2":
        return torch.matmul(xh, wh) + torch.matmul(xh, wl)
    xl = _bf16r(x - xh)
    return torch.matmul(xh, wh) + (torch.matmul(xh, wl)
                                   + torch.matmul(xl, wh))


def _sin(x, deg):
    return torch.sin(x) if deg == 0 else _fast_sin(x, deg)


def _cos(x, deg):
    return torch.cos(x) if deg == 0 else _fast_cos(x, deg)


def rff_features_plain(coords: torch.Tensor, bt: torch.Tensor,
                       deg: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos v, sin v), v = coords . bt by exact f32 multiply-adds over the
    d raw columns (``_rff_features_in_kernel``'s order): (n, d), (d, F) ->
    two (n, F)."""
    x = coords.to(torch.float32)
    v = x[:, 0:1] * bt[0:1]
    for d in range(1, x.shape[1]):
        v = v + x[:, d:d + 1] * bt[d:d + 1]
    return _cos(v, deg), _sin(v, deg)


def rff_pre_plain(feats, w: torch.Tensor, mode: str) -> torch.Tensor:
    """[cos v, sin v] @ W0 in the tier, as the JAX package sums it:
    cos v @ W0[:F] + sin v @ W0[F:] (the bias is added after)."""
    cv, sv = feats
    f = cv.shape[-1]
    return (_kernel_dot(cv, w[..., :f, :], mode)
            + _kernel_dot(sv, w[..., f:, :], mode))


def stack_forward_plain(params: Params, plan: StackPlan,
                        coords: torch.Tensor,
                        bt: torch.Tensor | None = None) -> torch.Tensor:
    """The fused forward in plain PyTorch: params with or without a leading
    window axis k, coords (n, d) -> (k, n, out) or (n, out).  ``bt`` (d,
    F) = 2 pi B^T of an RFF model (``_prep_rff_bt``), whose plan has
    ``rff``."""
    _check_rff_plan(plan, bt)
    x0 = coords.to(torch.float32)
    x = x0
    for li, p in enumerate(params["layers"]):
        w, b = p["w"], p["b"].unsqueeze(-2)
        if li == 0 and bt is not None:
            pre = rff_pre_plain(rff_features_plain(x0, bt,
                                                   plan.feature_degree),
                                w, plan.modes[0]) + b
        elif li == 0:
            # tiny-in first layer: exact f32 multiply-adds, never a rounded
            # matmul pass (omega0 * coord is the delicate product)
            pre = b
            for d in range(x0.shape[1]):
                pre = pre + x0[:, d:d + 1] * w[..., d:d + 1, :]
        else:
            pre = _kernel_dot(x, w, plan.modes[li]) + b
        kind, deg = plan.kinds[li], plan.degrees[li]
        if kind in ("sine_first", "sine"):
            x = _sin(plan.omegas[li] * pre, deg)
        elif kind == "linear_snake":
            a = p["snake_a"].unsqueeze(-2)
            x = pre + (0.5 / a) * (1.0 - _cos(2.0 * a * pre, deg))
        elif kind == "linear_tanh":
            x = torch.tanh(pre)
        else:  # linear_last
            x = pre
    return x


def _check_rff_plan(plan: StackPlan, bt) -> None:
    if plan.rff != (bt is not None):
        raise ValueError("an RFF layer 0 needs both an rff plan and bt "
                         "(stack_plan(rff=True), _prep_rff_bt)")


def _prep_rff_bt(rff_b: torch.Tensor) -> torch.Tensor:
    """(F, d) Gaussian projection -> 2 pi B^T, a contiguous (d, F) float32
    tensor on B's device: the same product as the JAX package's
    ``_prep_rff_bt`` (without its padding to 8 rows)."""
    if rff_b.dim() != 2 or not 1 <= rff_b.shape[1] <= _MAX_SMALL_IN:
        raise ValueError(f"RFF projection must be (F, d) with d <= "
                         f"{_MAX_SMALL_IN}, got {tuple(rff_b.shape)}")
    return (2.0 * math.pi * rff_b.detach().T.to(torch.float32)).contiguous()


def _check_rff_model(cfg: SirenSnakeTanhConfig, rff_b) -> None:
    """An RFF model's in_features are its 2F features; a raw one takes at
    most 8 coordinate columns."""
    if rff_b is None:
        if cfg.in_features > _MAX_SMALL_IN:
            raise ValueError(
                f"the fused kernels take in_features <= {_MAX_SMALL_IN} (raw "
                "coordinates): pass rff_b to fold an RFF encoding in")
    elif cfg.in_features != 2 * rff_b.shape[0]:
        raise ValueError(f"cfg.in_features ({cfg.in_features}) != 2*F "
                         f"({2 * rff_b.shape[0]})")


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

_TC_MODES = ("bf16", "bf16x2", "bf16x3")
# the tensor-core kernel's shapes per kernel width (csrc/siren_stack.cu:
# Tc<H>): rows a pass (16 warps of 32 x 32 blocks, H / 32 of them across a
# row), the most rows a CTA holds, and W's rows a shared-memory slab (the
# whole W up to 128; two stages of 64 rows at 256)
_TC_PASS_ROWS = {32: 512, 64: 256, 128: 128, 256: 64}
_TC_MAX_ROWS = {32: 512, 64: 256, 128: 256, 256: 64}


@dataclasses.dataclass(frozen=True)
class StackLaunch:
    """How the stack kernel runs a plan at a width: ``route`` "tc" (the
    tensor-core kernel, every product layer in a bf16 tier) or "fma" (the
    FMA kernel), ``rows`` of a window a CTA covers, ``slab`` rows of W a
    shared-memory stage holds, ``smem`` bytes of shared memory a CTA
    takes."""

    route: str
    rows: int
    slab: int
    smem: int


def stack_launch(plan: StackPlan, h: int, n: int) -> StackLaunch:
    """The route and tile of a stack call from the plan, the kernel width
    ``h`` (32, 64, 128 or 256) and the rows ``n`` alone: never from the
    window count, so that a k = 1 call is window i of a stacked call bit
    for bit.  The tensor-core route holds up to 256 rows (512 at h = 32,
    64 at h = 256), fewer where n needs fewer passes."""
    if h not in _KERNEL_WIDTHS:
        raise ValueError(f"kernel widths are {_KERNEL_WIDTHS}, got {h}")
    products = plan.modes[1:] + ((plan.modes[0],) if plan.rff else ())
    if all(m in _TC_MODES for m in products):
        step = _TC_PASS_ROWS[h]
        rows = min(_TC_MAX_ROWS[h], -(-max(n, 1) // step) * step)
        slab, stages = (h, 1) if h <= 128 else (64, 2)
        smem = (2 * rows * (h + 8) * 2 + stages * 2 * slab * (h + 8) * 2
                + (4 * h + rows * _MAX_SMALL_IN) * 4)
        return StackLaunch("tc", rows, slab, smem)
    rows, slab = 8192 // h, (h if h <= 128 else 64)
    smem = (2 * slab * h + 2 * rows * (h + 4) + 2 * h
            + rows * _MAX_SMALL_IN) * 4
    return StackLaunch("fma", rows, slab, smem)


def tc_plane_elems(plan: StackPlan, h: int, k: int, n_freq: int) -> int:
    """bf16 elements of the tensor-core route's weight planes for k
    windows: hi and lo of each hidden layer's (h, h) W and of an RFF
    layer 0's (2F, h)."""
    return k * 2 * h * (2 * n_freq + (len(plan.kinds) - 2) * h)


class _SirenStackKernel(LaunchCounter):
    """The built ``siren_stack`` library and its launch count (``launches``
    rises by one per call that launches the kernel, nowhere else; a
    tensor-core call launches the weight split before it)."""

    def __init__(self, name: str):
        super().__init__(name)
        self._lib = None

    def library(self):
        if self._lib is None:
            lib = build_library("siren_stack", ["siren_stack.cu"])
            fn = lib.siren_stack_forward
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p] + [ctypes.c_int] * 2
                           + [ctypes.c_void_p] * 2)
            fn.restype = ctypes.c_int
            fn = lib.siren_stack_forward_tc
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p] + [ctypes.c_int] * 2
                           + [ctypes.c_void_p] * 2
                           + [ctypes.c_longlong, ctypes.c_int,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def __call__(self, params: Params, plan: StackPlan,
                 coords: torch.Tensor, bt: torch.Tensor | None = None,
                 pre0: torch.Tensor | None = None) -> torch.Tensor:
        """Stacked params (k, ...) on one CUDA device, coords (n, d) ->
        (k, n, 1) float32, launched on the current stream.  ``bt`` (d, F):
        an RFF model's 2 pi B^T (layer 0's w is then (k, 2F, h)).  ``pre0``
        (k, n, h) float32, if given, receives layer 0's pre-activation.  A
        model whose h is not a kernel width is zero-padded to the next one
        (``pad_params``): its output is the unpadded model's, since every
        padded unit's outgoing weights are 0.  The route is
        ``stack_launch``'s.  The host's work up to the launch is the span
        ``inr.stack.prepare``, the ctypes calls ``inr.stack.launch``."""
        with span("inr.stack.prepare"):
            _check_rff_plan(plan, bt)
            dev = coords.device
            n, d = coords.shape
            h = kernel_width(params["layers"][0]["w"].shape[-1])
            params = pad_params(params, h)
            layers = params["layers"]
            k = layers[0]["w"].shape[0]
            L = len(layers)
            n_freq = 0 if bt is None else bt.shape[1]
            _check_tensor("coords", coords, dev, (n, d))
            if bt is not None:
                _check_tensor("bt", bt, dev, (d, n_freq))
            if pre0 is not None:
                _check_tensor("pre0", pre0, dev, (k, n, h), aligned=True)
            if not 1 <= d <= _MAX_SMALL_IN:
                raise ValueError(f"kernel takes 1..{_MAX_SMALL_IN} raw "
                                 f"input columns, got {d}")
            if not 2 <= L <= _KERNEL_MAX_LAYERS or len(plan.kinds) != L:
                raise ValueError(f"kernel takes 2..{_KERNEL_MAX_LAYERS} "
                                 f"layers matching the plan, got {L}")
            ptrs, ints = [], []
            for li, p in enumerate(layers):
                in_f = (2 * n_freq if n_freq else d) if li == 0 else h
                out_f = 1 if li == L - 1 else h
                # the kernel reads an RFF layer 0's and layers 1+ weights
                # as 16-byte vectors
                _check_tensor(f"layers[{li}].w", p["w"], dev,
                              (k, in_f, out_f), aligned=li > 0 or n_freq > 0)
                _check_tensor(f"layers[{li}].b", p["b"], dev, (k, out_f))
                a = p.get("snake_a")
                if plan.kinds[li] == "linear_snake":
                    _check_tensor(f"layers[{li}].snake_a", a, dev,
                                  (k, out_f))
                ptrs += [p["w"].data_ptr(), p["b"].data_ptr(),
                         a.data_ptr() if plan.kinds[li] == "linear_snake"
                         else 0]
                ints += [_KIND_CODE[plan.kinds[li]],
                         _MODE_CODE[plan.modes[li] or "highest"],
                         plan.degrees[li]]
            out = torch.empty((k, n), dtype=torch.float32, device=dev)
            ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
            if k == 0 or n == 0:
                return out.unsqueeze(-1)
            c_ptrs = (ctypes.c_uint64 * len(ptrs))(*ptrs)
            c_ints = (ctypes.c_int32 * len(ints))(*ints)
            c_omegas = (ctypes.c_float * L)(*plan.omegas)
            lib = self.library()
            launch = stack_launch(plan, h, n)
            args = (coords.data_ptr(), out.data_ptr(),
                    ctypes.addressof(c_ptrs), ctypes.addressof(c_ints),
                    ctypes.addressof(c_omegas), L, k, n, d, h, ptr(bt),
                    n_freq, plan.feature_degree, ptr(pre0))
        with span("inr.stack.launch"):
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                if launch.route == "tc":
                    planes = torch.empty(tc_plane_elems(plan, h, k, n_freq),
                                         dtype=torch.bfloat16, device=dev)
                    rc = lib.siren_stack_forward_tc(
                        *args, planes.data_ptr(), planes.numel(),
                        launch.rows, stream)
                else:
                    rc = lib.siren_stack_forward(*args, stream)
            if rc != 0:
                raise RuntimeError("siren_stack launch failed: cudaError "
                                   f"{rc}")
            self.count()
        return out.unsqueeze(-1)


def _check_tensor(name: str, t, device: torch.device, shape,
                  aligned: bool = False) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, coords on {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: kernel takes float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel takes contiguous tensors")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name}: kernel takes a 16-byte-aligned tensor")


SIREN_STACK = _SirenStackKernel("siren_stack")


def _run(params: Params, plan: StackPlan, coords: torch.Tensor,
         stacked: bool, bt: torch.Tensor | None = None) -> torch.Tensor:
    for li, layer in enumerate(params["layers"]):
        for key, v in layer.items():
            if v.device != coords.device:
                raise ValueError(f"layers[{li}].{key} is on {v.device}, "
                                 f"coords on {coords.device}")
    if bt is not None and bt.device != coords.device:
        raise ValueError(f"rff_b is on {bt.device}, coords on "
                         f"{coords.device}")
    if coords.device.type == "cpu":
        return stack_forward_plain(params, plan, coords, bt)
    if coords.device.type != "cuda":
        raise ValueError(f"no fused stack for device {coords.device}")
    if not stacked:
        params = {"layers": [{k: v.unsqueeze(0) for k, v in p.items()}
                             for p in params["layers"]]}
    out = SIREN_STACK(params, plan, coords, bt)
    return out if stacked else out[0]


def fused_siren_apply_stacked(params: Params, cfg: SirenSnakeTanhConfig,
                              coords: torch.Tensor,
                              compute_dtype=torch.float32,
                              approx_sin: bool = False,
                              sin_poly_degree: int = 11,
                              mixed_matmul: bool = False,
                              f32_mode: str | None = None,
                              exact_first_sin: bool = False) -> torch.Tensor:
    """A stacked window population (leading k axis on every leaf) on one
    shared (n, d) grid -> (k, n, out).  Replaces the JAX package's
    ``fused_siren_apply_stacked`` (``_stack_kernel_multi``).  Raw
    coordinates only: an RFF model has no stacked path, as in the JAX
    package."""
    if cfg.in_features > _MAX_SMALL_IN:
        raise ValueError(
            f"stacked populations take raw coordinates (in_features <= "
            f"{_MAX_SMALL_IN}); an RFF model decodes one model at a time")
    plan = stack_plan(cfg, compute_dtype, approx_sin, sin_poly_degree,
                      mixed_matmul, f32_mode, exact_first_sin)
    return _run(params, plan, coords, stacked=True)


def fused_siren_apply(params: Params, cfg: SirenSnakeTanhConfig,
                      coords: torch.Tensor, compute_dtype=torch.float32,
                      approx_sin: bool = False, sin_poly_degree: int = 11,
                      mixed_matmul: bool = False, f32_mode: str | None = None,
                      exact_first_sin: bool = False,
                      rff_b: torch.Tensor | None = None) -> torch.Tensor:
    """One model over (n, d) coords -> (n, out): the k = 1 call of the same
    kernel.  Replaces ``fused_siren_apply`` (``_stack_kernel``).  ``rff_b``
    (F, d): the model owns a Gaussian Fourier encoding, folded into layer
    0; ``coords`` are then the raw coordinates and ``cfg.in_features`` is
    2F."""
    _check_rff_model(cfg, rff_b)
    plan = stack_plan(cfg, compute_dtype, approx_sin, sin_poly_degree,
                      mixed_matmul, f32_mode, exact_first_sin,
                      rff=rff_b is not None)
    bt = None if rff_b is None else _prep_rff_bt(rff_b)
    return _run(params, plan, coords, stacked=False, bt=bt)


# ---------------------------------------------------------------------------
# Quality-gated decode tiers
# ---------------------------------------------------------------------------

# Per-tier (moderate_floor_db, high_phase_floor_db, kwargs), copied from the
# JAX package (measured there on a TPU) except deg 11's moderate floor.  On an
# H100 (chip_smoke.py phase 19: each tier's decode against the exact apply on
# the trained headline, omega0 115, and codec-default, omega0 1800,
# payloads) the moderate readings were bf16-deg7 58.2 / 55.5 dB, mixed 60.6 /
# 58.5, deg9 106.5 / 103.5, all above the copied floors, and deg11 113.1 /
# 110.5 dB, below the copied 134: its floor is the lower reading.  The
# high-phase column (omega0 >= 2000) is not measured on the card.
_DECODE_TIERS = (
    (43.0, 43.0, dict(approx_sin=True, sin_poly_degree=7,
                      compute_dtype="bfloat16")),
    (50.0, 46.0, dict(approx_sin=True, sin_poly_degree=7, mixed_matmul=True,
                      f32_mode="bf16x2")),
    (90.0, 85.0, dict(approx_sin=True, sin_poly_degree=9)),
    (110.51, 87.0, dict(approx_sin=True, sin_poly_degree=11)),
)

# Above this first-layer omega0 the high-phase floor column applies (copied
# from the JAX package).
_HIGH_PHASE_OMEGA = 2000.0


def auto_decode_kwargs(fit_snr_db: float, margin_db: float = 9.0,
                       first_omega_0: float | None = None) -> dict[str, Any]:
    """The fastest tier whose noise floor sits ``margin_db`` above the
    model's fit SNR; exact sin when none does.  The JAX package's
    ``auto_decode_kwargs`` over this module's table (``_DECODE_TIERS``)."""
    need = fit_snr_db + margin_db
    high_phase = (first_omega_0 is not None
                  and first_omega_0 >= _HIGH_PHASE_OMEGA)
    for floor, high_floor, kw in _DECODE_TIERS:
        if high_phase:
            floor = high_floor
        if need <= floor:
            kw = dict(kw)
            if kw.get("compute_dtype") == "bfloat16":
                kw["compute_dtype"] = torch.bfloat16
            return kw
    return dict(approx_sin=False)
