"""SirenWithSnakeTanh stack forward: the CUDA kernel and its plain version.

Port of ``inraudio_tpu/ops/pallas_siren.py``'s two forward kernels:
``_stack_kernel_multi`` (k windows on one shared coordinate grid, the
multi-INR decode) and ``_stack_kernel`` (one model over row tiles).  On
Hopper both are the same computation, so one CUDA kernel
(``csrc/siren_stack.cu``) serves both; ``fused_siren_apply`` is its k = 1
call.  The TPU layout artefacts (8-row bias bands, lane padding, packed
(., 128) outputs, VMEM tile pickers) are not ported.

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
import os
from typing import Any

import torch

from ..models.siren import SirenSnakeTanhConfig
from ._nvcc import build_library

Params = dict[str, Any]

_MAX_SMALL_IN = 8
_KERNEL_WIDTHS = (32, 64, 128)
_KERNEL_MAX_LAYERS = 16

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
    """Static per-layer recipe: kind, omega, matmul tier (None for layer
    0's exact multiply-adds) and trig degree (0 = exact sin/cos)."""

    kinds: tuple[str, ...]
    omegas: tuple[float, ...]
    modes: tuple[str | None, ...]
    degrees: tuple[int, ...]


def _is_bf16(dtype) -> bool:
    return dtype in (torch.bfloat16, "bfloat16")


def stack_plan(cfg: SirenSnakeTanhConfig, compute_dtype=torch.float32,
               approx_sin: bool = False, sin_poly_degree: int = 11,
               mixed_matmul: bool = False, f32_mode: str | None = None,
               exact_first_sin: bool = False) -> StackPlan:
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
            modes.append(None)
        elif _is_bf16(compute_dtype) or (mixed_matmul
                                         and kind in _BF16_PASS_KINDS):
            modes.append("bf16")
        else:
            modes.append(f32)
        degrees.append(0 if kind == "sine_first" and exact_first_sin
                       else hidden_deg)
    return StackPlan(kinds, tuple(omegas), tuple(modes), tuple(degrees))


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


def stack_forward_plain(params: Params, plan: StackPlan,
                        coords: torch.Tensor) -> torch.Tensor:
    """The fused forward in plain PyTorch: params with or without a leading
    window axis k, coords (n, d) -> (k, n, out) or (n, out)."""
    x0 = coords.to(torch.float32)
    x = x0
    for li, p in enumerate(params["layers"]):
        w, b = p["w"], p["b"].unsqueeze(-2)
        if li == 0:
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


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

class _SirenStackKernel:
    """The built ``siren_stack`` library and its launch count (``launches``
    rises by one per kernel launch, nowhere else)."""

    def __init__(self):
        self._lib = None
        self.launches = 0

    def library(self):
        if self._lib is None:
            lib = build_library("siren_stack", ["siren_stack.cu"])
            fn = lib.siren_stack_forward
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def __call__(self, params: Params, plan: StackPlan,
                 coords: torch.Tensor) -> torch.Tensor:
        """Stacked params (k, ...) on one CUDA device, coords (n, d) ->
        (k, n, 1) float32, launched on the current stream."""
        dev = coords.device
        n, d = coords.shape
        layers = params["layers"]
        k = layers[0]["w"].shape[0]
        h = layers[0]["w"].shape[-1]
        L = len(layers)
        _check_tensor("coords", coords, dev, (n, d))
        if not 1 <= d <= _MAX_SMALL_IN:
            raise ValueError(f"kernel takes 1..{_MAX_SMALL_IN} raw input "
                             f"columns, got {d}")
        if h not in _KERNEL_WIDTHS:
            raise ValueError(f"kernel hidden width must be one of "
                             f"{_KERNEL_WIDTHS}, got {h}")
        if not 2 <= L <= _KERNEL_MAX_LAYERS or len(plan.kinds) != L:
            raise ValueError(f"kernel takes 2..{_KERNEL_MAX_LAYERS} layers "
                             f"matching the plan, got {L}")
        ptrs, ints = [], []
        for li, p in enumerate(layers):
            in_f = d if li == 0 else h
            out_f = 1 if li == L - 1 else h
            # the kernel reads layers 1+ weights as 16-byte vectors
            _check_tensor(f"layers[{li}].w", p["w"], dev, (k, in_f, out_f),
                          aligned=li > 0)
            _check_tensor(f"layers[{li}].b", p["b"], dev, (k, out_f))
            a = p.get("snake_a")
            if plan.kinds[li] == "linear_snake":
                _check_tensor(f"layers[{li}].snake_a", a, dev, (k, out_f))
            ptrs += [p["w"].data_ptr(), p["b"].data_ptr(),
                     a.data_ptr() if plan.kinds[li] == "linear_snake" else 0]
            ints += [_KIND_CODE[plan.kinds[li]],
                     _MODE_CODE[plan.modes[li] or "highest"],
                     plan.degrees[li]]
        out = torch.empty((k, n), dtype=torch.float32, device=dev)
        if k == 0 or n == 0:
            return out.unsqueeze(-1)
        c_ptrs = (ctypes.c_uint64 * len(ptrs))(*ptrs)
        c_ints = (ctypes.c_int32 * len(ints))(*ints)
        c_omegas = (ctypes.c_float * L)(*plan.omegas)
        lib = self.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.siren_stack_forward(
                coords.data_ptr(), out.data_ptr(), ctypes.addressof(c_ptrs),
                ctypes.addressof(c_ints), ctypes.addressof(c_omegas), L, k, n,
                d, h, stream)
        if rc != 0:
            raise RuntimeError(f"siren_stack launch failed: cudaError {rc}")
        self.launches += 1
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


SIREN_STACK = _SirenStackKernel()


def _run(params: Params, plan: StackPlan, coords: torch.Tensor,
         stacked: bool) -> torch.Tensor:
    for li, layer in enumerate(params["layers"]):
        for key, v in layer.items():
            if v.device != coords.device:
                raise ValueError(f"layers[{li}].{key} is on {v.device}, "
                                 f"coords on {coords.device}")
    if coords.device.type == "cpu":
        return stack_forward_plain(params, plan, coords)
    if coords.device.type != "cuda":
        raise ValueError(f"no fused stack for device {coords.device}")
    if not stacked:
        params = {"layers": [{k: v.unsqueeze(0) for k, v in p.items()}
                             for p in params["layers"]]}
    out = SIREN_STACK(params, plan, coords)
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
    ``fused_siren_apply_stacked`` (``_stack_kernel_multi``)."""
    plan = stack_plan(cfg, compute_dtype, approx_sin, sin_poly_degree,
                      mixed_matmul, f32_mode, exact_first_sin)
    return _run(params, plan, coords, stacked=True)


def fused_siren_apply(params: Params, cfg: SirenSnakeTanhConfig,
                      coords: torch.Tensor, compute_dtype=torch.float32,
                      approx_sin: bool = False, sin_poly_degree: int = 11,
                      mixed_matmul: bool = False, f32_mode: str | None = None,
                      exact_first_sin: bool = False) -> torch.Tensor:
    """One model over (n, d) coords -> (n, out): the k = 1 call of the same
    kernel.  Replaces ``fused_siren_apply`` (``_stack_kernel``) without its
    RFF layer 0."""
    plan = stack_plan(cfg, compute_dtype, approx_sin, sin_poly_degree,
                      mixed_matmul, f32_mode, exact_first_sin)
    return _run(params, plan, coords, stacked=False)


# ---------------------------------------------------------------------------
# Quality-gated decode tiers
# ---------------------------------------------------------------------------

# Per-tier (moderate_floor_db, high_phase_floor_db, kwargs).  The floors are
# copied from the JAX package, where they were measured on a TPU; they are
# NOT yet measured on the CUDA kernel.  The tier semantics are identical, so
# they are expected to carry over, but no card measurement backs them yet.
_DECODE_TIERS = (
    (43.0, 43.0, dict(approx_sin=True, sin_poly_degree=7,
                      compute_dtype="bfloat16")),
    (50.0, 46.0, dict(approx_sin=True, sin_poly_degree=7, mixed_matmul=True,
                      f32_mode="bf16x2")),
    (90.0, 85.0, dict(approx_sin=True, sin_poly_degree=9)),
    (134.0, 87.0, dict(approx_sin=True, sin_poly_degree=11)),
)

# Above this first-layer omega0 the high-phase floor column applies (copied
# from the JAX package, not yet measured on the card).
_HIGH_PHASE_OMEGA = 2000.0


def auto_decode_kwargs(fit_snr_db: float, margin_db: float = 9.0,
                       first_omega_0: float | None = None) -> dict[str, Any]:
    """The fastest tier whose noise floor sits ``margin_db`` above the
    model's fit SNR; exact sin when none does.  The same gate as the JAX
    package's ``auto_decode_kwargs``."""
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
