"""Whole MSE train step for a window population: forward recompute, masked
MSE, backward, per-window global-norm clip, torch-parity Adam and the
best-params snapshot, in place.

Port of ``inraudio_tpu/ops/pallas_siren_step.py``: the TPU kernel
``_step_kernel`` becomes ``SIREN_STEP`` (``csrc/siren_train.cu``: the grad
accumulation of ``ops.siren_train``, a fixed-order reduce over row tiles,
then the clip + Adam + best epilogue), with ``step_plain`` as its plain
PyTorch version.  The train state stays in the flat (k, P) layout of
``ops.siren_train.flat_layout`` for the whole fit (``FlatTrainState``).
The plateau scheduler and the best_loss / best_iter bookkeeping are torch
ops on (k,) tensors, as the JAX package keeps them in XLA.

No VMEM gate, padding or row-tile picker is ported: the kernels take any
window count and row count and mask the ragged tile themselves, so the
step also takes the RFF model at h = 256, which the JAX package's VMEM
gate sends to the two-kernel autodiff step (the same step up to rounding).
An RFF model (``rff_b``) folds its Gaussian Fourier encoding into layer 0.
D and E take an optional per-row loss weight (the JAX kernels'
``has_weight``: the mdct target's hearing-threshold mask), streamed beside
the targets: loss = sum(err^2 w) / n and g = err (w 2 / n).

The row-sharded fit (``train.loop.fit`` on a mesh of more than one rank)
splits the step at the collective, as the JAX package's
``make_sharded_fused_mse_train_step`` does: TPU kernel ``_grad_kernel``
becomes ``SIREN_GRAD`` (kernel E: one shard's masked loss and grads, with
a device row limit and the whole clip's 1 / n_valid), and ``_adam_kernel``
becomes ``SIREN_ADAM`` (kernel F: clip by the norm of the all-reduced
grads, Adam and the best snapshot, in place), with ``grad_plain`` and
``adam_epilogue_plain`` as their plain versions.  E writes one buffer
[grads (P) | loss | pad (3)]; the mesh all-reduces it, and F reads both the
grads and the loss from it, so one collective serves a step.

A step is built for one numerical tier (``tier_plan``): the forward's
matmul tier, the backward's and the sin polynomial's degree, from the
environment ladder by default or from a ``tier`` dict per call, as the JAX
builders take it (the precision schedule's cheap tier,
``train.loop.schedule_tiers``).  The tier reaches the kernels as launch
arguments (``TrainArgs``' per-layer ``mode`` / ``deg`` and ``gmode``), so
the cheap and the full step share one flat state.

The optimizer epilogue (D's last two launches and F) is bound by bytes.
D's runs ``siren_scale_kernel`` (each window's norm and loss, once) and
``siren_adam_kernel`` over (window, span) CTAs (``adam_spans``); F is one
cooperative launch of ``adam_global_grid`` CTAs (chunk sums of squares, a
grid-wide sync, the norm, the update).  Both keep the numbers of the
reference's order bit for bit.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from ..models.siren import SirenSnakeTanhConfig
from ._nvcc import LaunchCounter
from .siren_fused import (_KERNEL_MAX_LAYERS, _MAX_SMALL_IN, StackPlan,
                          _check_tensor, _f32_dot_mode, _prep_rff_bt,
                          kernel_width, stack_plan, unpad_params)
from .siren_train import (CHUNK_FLOATS, TC_MODES, TRAIN_LIBRARY, _check_rc,
                          bwd_sweep_plain, flatten_params, fwd_pres_plain,
                          grad_dot_mode, grad_reduce, tile_rows,
                          unflatten_params, validate_grad_launch)

__all__ = ["ADAM_SPAN_FLOATS", "FlatTrainState", "SIREN_ADAM", "SIREN_GRAD",
           "SIREN_STEP", "adam_epilogue_plain", "adam_global_args",
           "adam_global_grid", "adam_spans",
           "flat_state_from_train_state", "fused_adam_call",
           "fused_mse_grad_call", "fused_mse_step_call", "grad_plain",
           "launch_adam", "make_fused_mse_train_step",
           "make_sharded_fused_mse_train_step", "sharded_step_call",
           "step_block_rows", "step_plain", "step_supported", "tier_plan",
           "train_state_from_flat"]

# Adam constants (torch.optim.Adam defaults, as train.optim.AdamConfig)
_B1, _B2, _EPS = 0.9, 0.999, 1e-8
# floats after the grads in kernel E's buffer: the loss, then zeros, so the
# buffer stays a multiple of 16 bytes
_BUF_TAIL = 4
# D's Adam pass (csrc/siren_train.cu, siren_adam_kernel): 256 threads a CTA,
# each with ADAM_VEC float4 in flight, so a CTA updates a span of 4096
# floats of one window
ADAM_VEC = 4
ADAM_SPAN_FLOATS = 256 * ADAM_VEC * 4


def step_supported(cfg: SirenSnakeTanhConfig, n_rows: int = 1,
                   rff_b=None) -> bool:
    """Whether the whole-step kernel takes this model: one output, at most
    8 raw input columns (an RFF model's ``rff_b`` (F, d): d <= 8 and
    in_features 2F), h <= 256 (padded to the next kernel width) and 2..16
    layers."""
    if rff_b is None:
        inputs_ok = 1 <= cfg.in_features <= _MAX_SMALL_IN
    else:
        f, d = rff_b.shape
        inputs_ok = 1 <= d <= _MAX_SMALL_IN and cfg.in_features == 2 * f
    return (cfg.out_features == 1 and inputs_ok
            and 1 <= cfg.hidden_features <= 256
            and 2 <= len(cfg.layer_kinds) <= _KERNEL_MAX_LAYERS
            and n_rows >= 1)


def step_block_rows(cfg: SirenSnakeTanhConfig, n_rows: int,
                    rff_b=None) -> int | None:
    """Rows per CTA of the step kernel (8192 / h at the kernel width h:
    one (rows, h) tile is 32 KB at every width), or None when the kernel
    does not take it."""
    if not step_supported(cfg, n_rows, rff_b):
        return None
    return tile_rows(kernel_width(cfg.hidden_features))


class FlatTrainState(NamedTuple):
    """A window population's TrainState with params / moments / best in the
    flat (k, P) layout for the whole fit (flattened, and a model between
    the kernel widths zero-padded, once per fit)."""
    params: torch.Tensor        # (k, P) float32
    mu: torch.Tensor
    nu: torch.Tensor
    best_params: torch.Tensor
    step: torch.Tensor          # (k,) int32, Adam t
    lr: torch.Tensor            # (k,) float32
    plateau_best: torch.Tensor
    plateau_bad: torch.Tensor
    best_loss: torch.Tensor
    best_iter: torch.Tensor


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def adam_epilogue_plain(params, mu, nu, best, grads, lr, c1, c2, loss,
                        best_loss, clip_norm: float) -> None:
    """Per-window clip + Adam + best snapshot on (k, P) tensors, in place
    (the kernel epilogue's arithmetic, op by op)."""
    col = lambda x: x.reshape(-1, 1)
    g = grads
    if clip_norm > 0:
        norm = torch.sqrt(torch.sum(g * g, dim=1))
        scale = torch.clamp(clip_norm / torch.clamp(norm, min=1e-20), max=1.0)
        g = g * col(scale)
    p_old = params.clone()
    if best is not None:
        best.copy_(torch.where(col(loss < best_loss), p_old, best))
    m = _B1 * mu + (1.0 - _B1) * g
    v = _B2 * nu + (1.0 - _B2) * g * g
    mu.copy_(m)
    nu.copy_(v)
    params.copy_(p_old - col(lr) * (m / col(c1))
                 / (torch.sqrt(v / col(c2)) + _EPS))


def _mse_cotangent(err: torch.Tensor, weight, inv_n: float):
    """(per-window loss, cotangent) of the (weighted) MSE of ``err`` (k,
    n): sum(err err w) / n and err (w 2/n), in the kernels' order; no
    weight is w = 1, which gives the unweighted bits."""
    w = 1.0 if weight is None else weight
    return torch.sum(err * err * w, dim=1) * inv_n, err * (w * (2.0 * inv_n))


def step_plain(params, mu, nu, best, coords, targets, lr, c1, c2, best_loss,
               cfg: SirenSnakeTanhConfig, plan: StackPlan, gmode: str,
               n_valid: int, clip_norm: float, bt=None,
               weight=None) -> torch.Tensor:
    """The whole step in plain PyTorch: (k, P) state groups updated in
    place, returns the per-window loss (k,).  Same arguments as
    ``fused_mse_step_call``."""
    inv_n = 1.0 / float(n_valid)
    leaves = unflatten_params(params, cfg)
    out, saved = fwd_pres_plain(leaves, plan, coords, bt)
    loss, g = _mse_cotangent(out[..., 0] - targets, weight, inv_n)  # (k, n)
    grads = bwd_sweep_plain(g.unsqueeze(-1), saved, leaves, plan, gmode)
    adam_epilogue_plain(params, mu, nu, best, flatten_params(grads, cfg), lr,
                        c1, c2, loss, best_loss, clip_norm)
    return loss


def grad_plain(params, coords, targets, limit, n_valid: int,
               cfg: SirenSnakeTanhConfig, plan: StackPlan, gmode: str,
               bt=None, weight=None) -> torch.Tensor:
    """Kernel E in plain PyTorch: one shard's loss and gradient -> the
    (P + 4,) buffer [grads | loss | 0 0 0].  ``params`` (1, P), ``coords``
    (rows, d), ``targets`` (1, rows); rows at or past ``limit`` (an int32
    (1,) tensor) carry no loss; the loss and its gradient are normalised by
    the whole clip's ``n_valid``.  Same arguments as
    ``fused_mse_grad_call``."""
    inv_n = 1.0 / float(n_valid)
    leaves = unflatten_params(params, cfg)
    out, saved = fwd_pres_plain(leaves, plan, coords, bt)
    rows = torch.arange(coords.shape[0], device=coords.device)
    mask = (rows < limit.to(rows.dtype)).to(torch.float32)
    loss, g = _mse_cotangent((out[..., 0] - targets) * mask, weight,
                             inv_n)                          # (1, rows)
    grads = bwd_sweep_plain(g.unsqueeze(-1), saved, leaves, plan, gmode)
    buf = torch.zeros(params.shape[1] + _BUF_TAIL, dtype=torch.float32,
                      device=coords.device)
    buf[:params.shape[1]] = flatten_params(grads, cfg)[0]
    buf[params.shape[1]] = loss[0]
    return buf


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

def _check_same_device(ref_name: str, ref: torch.Tensor, **tensors) -> None:
    for name, t in tensors.items():
        if t is not None and t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, {ref_name} on "
                             f"{ref.device}")


def adam_spans(P: int) -> int:
    """CTAs a window of D's Adam pass (ADAM_SPAN_FLOATS of its P floats
    each, the last one ragged): it launches k * adam_spans(P) CTAs."""
    return -(-P // ADAM_SPAN_FLOATS)


def adam_global_grid(P: int, cap: int) -> int:
    """F's cooperative grid: one CTA a CHUNK_FLOATS chunk of the P grads,
    at most ``cap`` (the CTAs the card holds at once); each CTA takes the
    chunks b, b + grid, ... in both halves of the kernel."""
    if cap < 1:
        raise ValueError(f"F's grid cap must be positive, got {cap}")
    return min(cap, -(-P // CHUNK_FLOATS))


_GRID_CAP: dict[int, int] = {}


def _adam_global_cap(lib, dev: torch.device) -> int:
    """siren_adam_global_cap of ``dev`` (the current device), read once a
    device."""
    if dev.index not in _GRID_CAP:
        cap = lib.siren_adam_global_cap()
        if cap < 1:
            raise RuntimeError("kernel F cannot be launched cooperatively on "
                               f"{dev}: cudaError {-cap}")
        _GRID_CAP[dev.index] = cap
    return _GRID_CAP[dev.index]


def launch_adam(lib, grads, sq_part, loss_part, params, mu, nu, best, loss,
                scale, lr, c1, c2, best_loss, clip_norm: float,
                stream) -> None:
    """D's epilogue on the reduce's outputs (``grads`` (k, P), ``sq_part``
    (k, chunks), ``loss_part`` (k * slices)): the scale kernel writes each
    window's clip scale into ``scale`` (k,) and its loss into ``loss`` (k,),
    then the Adam pass updates params / mu / nu / best (k, P; best None
    leaves it alone) in place.  Two launches on ``stream``, no host sync."""
    k, P = params.shape
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    rc = lib.siren_adam(
        grads.data_ptr(), sq_part.data_ptr(), loss_part.data_ptr(),
        params.data_ptr(), mu.data_ptr(), nu.data_ptr(), ptr(best),
        loss.data_ptr(), scale.data_ptr(), lr.data_ptr(), c1.data_ptr(),
        c2.data_ptr(), best_loss.data_ptr(), k, loss_part.shape[0] // k, P,
        adam_spans(P), float(clip_norm), stream)
    _check_rc("siren_adam", rc)


def adam_global_args(lib, params, mu, nu, best, buf, lr, c1, c2, best_loss,
                     loss, sq, clip_norm: float, stream) -> tuple:
    """``siren_adam_global``'s arguments (F on one model, ``sq`` its
    (chunks,) scratch), with the grid from the card's cap, for
    ``lib.siren_adam_global(*args)``."""
    P = params.shape[-1]
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    grid = adam_global_grid(P, _adam_global_cap(lib, buf.device))
    return (buf.data_ptr(), sq.data_ptr(), params.data_ptr(), mu.data_ptr(),
            nu.data_ptr(), ptr(best), loss.data_ptr(), lr.data_ptr(),
            c1.data_ptr(), c2.data_ptr(), best_loss.data_ptr(), P, grid,
            float(clip_norm), stream)


class _SirenStepKernel(LaunchCounter):
    """Kernel D: one whole train step for the population (grad
    accumulation, reduce, then the clip + Adam + best epilogue: the scale
    and Adam kernels, on the current stream, no host sync).  ``launches``
    rises by one per step launched, nowhere else."""

    def __call__(self, params, mu, nu, best, coords, targets, lr, c1, c2,
                 best_loss, cfg: SirenSnakeTanhConfig, plan: StackPlan,
                 gmode: str, clip_norm: float, bt=None,
                 weight=None) -> torch.Tensor:
        dev = coords.device
        g = validate_grad_launch(params, cfg, plan, coords, bt)
        shape = (g.k, g.layout.size)
        groups = [("mu", mu), ("nu", nu)]
        if best is not None:
            groups.append(("best_params", best))
        for name, t in groups:
            _check_tensor(name, t, dev, shape, aligned=True)
        _check_tensor("targets", targets, dev, (g.k, g.n))
        if weight is not None:
            _check_tensor("weight", weight, dev, (g.k, g.n))
        for name, t in (("lr", lr), ("c1", c1), ("c2", c2),
                        ("best_loss", best_loss)):
            _check_tensor(name, t, dev, (g.k,))
        lib = TRAIN_LIBRARY()
        loss = torch.empty((g.k,), dtype=torch.float32, device=dev)
        scale = torch.empty((g.k,), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            grads, sq_part, loss_part = grad_reduce(
                lib, g, coords, params, stream, targets=targets, gmode=gmode,
                weight=weight)
            launch_adam(lib, grads, sq_part, loss_part, params, mu, nu, best,
                        loss, scale, lr, c1, c2, best_loss, clip_norm,
                        stream)
        self.count()
        return loss


SIREN_STEP = _SirenStepKernel("siren_step")


def fused_mse_step_call(params, mu, nu, best, coords, targets, lr, c1, c2,
                        best_loss, cfg: SirenSnakeTanhConfig, plan: StackPlan,
                        gmode: str, n_valid: int, clip_norm: float,
                        bt=None, weight=None) -> torch.Tensor:
    """One whole step on (k, P) state groups, in place -> loss (k,).  CPU
    tensors take the plain version; CUDA tensors the kernel.  ``best``
    None leaves the best snapshot alone.  ``bt``: an RFF model's 2 pi B^T
    (d, F), with an rff plan.  ``weight`` (k, n): the MSE's per-row
    weight, or None."""
    _check_same_device("coords", coords, params=params, mu=mu, nu=nu,
                       best_params=best, targets=targets, lr=lr, c1=c1,
                       c2=c2, best_loss=best_loss, rff_b=bt, weight=weight)
    if coords.device.type == "cpu":
        return step_plain(params, mu, nu, best, coords, targets, lr, c1, c2,
                          best_loss, cfg, plan, gmode, n_valid, clip_norm, bt,
                          weight)
    if coords.device.type != "cuda":
        raise ValueError(f"no fused step for device {coords.device}")
    if n_valid != coords.shape[0]:
        raise ValueError("the step kernel masks rows past coords.shape[0]; "
                         f"n_valid={n_valid} must equal it")
    return SIREN_STEP(params, mu, nu, best, coords, targets, lr, c1, c2,
                      best_loss, cfg, plan, gmode, clip_norm, bt, weight)


class _SirenGradKernel(LaunchCounter):
    """Kernel E: one row shard's masked MSE loss and gradient (grad
    accumulation with a device row limit, then the reduce, which also sums
    the shard's loss into the buffer: two launches, no host sync).
    ``launches`` rises by one per shard launched, nowhere else."""

    def __call__(self, params, coords, targets, limit, n_valid: int,
                 cfg: SirenSnakeTanhConfig, plan: StackPlan, gmode: str,
                 bt=None, weight=None) -> torch.Tensor:
        dev = coords.device
        g = validate_grad_launch(params, cfg, plan, coords, bt)
        if g.k != 1:
            raise ValueError(f"kernel E takes one model, got {g.k} windows")
        _check_tensor("targets", targets, dev, (1, g.n))
        if weight is not None:
            _check_tensor("weight", weight, dev, (1, g.n))
        if not (isinstance(limit, torch.Tensor) and limit.device == dev
                and limit.dtype == torch.int32 and limit.shape == (1,)):
            raise ValueError("limit: expected an int32 (1,) tensor on "
                             f"{dev}")
        if n_valid < 1:
            raise ValueError(f"n_valid must be positive, got {n_valid}")
        lib = TRAIN_LIBRARY()
        P = g.layout.size
        buf = torch.empty((P + _BUF_TAIL,), dtype=torch.float32, device=dev)
        buf[P + 1:].zero_()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            grad_reduce(lib, g, coords, params, stream, targets=targets,
                        gmode=gmode, limit=limit, n_valid=n_valid,
                        grads=buf[:P].view(1, P), loss_out=buf[P:P + 1],
                        weight=weight)
        self.count()
        return buf


SIREN_GRAD = _SirenGradKernel("siren_grad")


def fused_mse_grad_call(params, coords, targets, limit, n_valid: int,
                        cfg: SirenSnakeTanhConfig, plan: StackPlan,
                        gmode: str, bt=None, weight=None) -> torch.Tensor:
    """One row shard's partial loss and gradient -> the (P + 4,) buffer
    [grads (P) | loss | 0 0 0], the layout the mesh all-reduces and
    ``fused_adam_call`` reads.  ``params`` (1, P) flat, ``coords`` (rows,
    d) and ``targets`` (1, rows) the shard's (padded) rows, ``limit`` an
    int32 (1,) tensor of its valid rows (0: an empty shard, whose buffer is
    zero), ``n_valid`` the whole clip's valid rows, ``weight`` (1, rows)
    the shard's per-row loss weight or None.  CPU tensors take the plain
    version; CUDA tensors kernel E."""
    _check_same_device("coords", coords, params=params, targets=targets,
                       limit=limit, rff_b=bt, weight=weight)
    if coords.device.type == "cpu":
        return grad_plain(params, coords, targets, limit, n_valid, cfg, plan,
                          gmode, bt, weight)
    if coords.device.type != "cuda":
        raise ValueError(f"no fused grad for device {coords.device}")
    return SIREN_GRAD(params, coords, targets, limit, n_valid, cfg, plan,
                      gmode, bt, weight)


class _SirenAdamKernel(LaunchCounter):
    """Kernel F: the sum of squares of the all-reduced grads (fixed order),
    then clip + Adam + best on one model's state, in place (one cooperative
    launch, no host sync).  Its (chunks,) scratch is kept per (device,
    stream, P), so a call allocates only the loss it returns.  ``launches``
    rises by one per update launched, nowhere else."""

    def __init__(self, name: str):
        super().__init__(name)
        self._scratch: dict = {}
        self._scratch_lock = threading.Lock()

    def scratch(self, dev: torch.device, stream: int, P: int) -> torch.Tensor:
        """F's chunk sums of squares, one buffer per (device, stream, P):
        launches on one stream run in order, so they may share it."""
        key = (dev, stream, P)
        with self._scratch_lock:
            if key not in self._scratch:
                self._scratch[key] = torch.empty(
                    (-(-P // CHUNK_FLOATS),), dtype=torch.float32, device=dev)
            return self._scratch[key]

    def __call__(self, params, mu, nu, best, buf, lr, c1, c2, best_loss,
                 clip_norm: float) -> torch.Tensor:
        dev = buf.device
        P = params.shape[-1]
        _check_tensor("buf", buf, dev, (P + _BUF_TAIL,), aligned=True)
        for name, t in (("params", params), ("mu", mu), ("nu", nu),
                        ("best_params", best)):
            if t is not None:
                _check_tensor(name, t, dev, (1, P), aligned=True)
        for name, t in (("lr", lr), ("c1", c1), ("c2", c2),
                        ("best_loss", best_loss)):
            _check_tensor(name, t, dev, (1,))
        if P % 4:
            raise ValueError(f"kernel F takes P a multiple of 4, got {P}")
        lib = TRAIN_LIBRARY()
        loss = torch.empty((1,), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.siren_adam_global(*adam_global_args(
                lib, params, mu, nu, best, buf, lr, c1, c2, best_loss, loss,
                self.scratch(dev, stream, P), clip_norm, stream))
            _check_rc("siren_adam_global", rc)
        self.count()
        return loss


SIREN_ADAM = _SirenAdamKernel("siren_adam")


def fused_adam_call(params, mu, nu, best, buf, lr, c1, c2, best_loss,
                    clip_norm: float) -> torch.Tensor:
    """Clip + Adam + best of one model from an all-reduced E buffer ``buf``
    (P + 4,): ``params`` / ``mu`` / ``nu`` / ``best`` (1, P) updated in
    place (``best`` None leaves the snapshot alone); the norm is that of
    ``buf``'s grads and the best snapshot is taken when its loss is below
    ``best_loss``.  Returns the loss (1,).  CPU tensors take the plain
    version (``adam_epilogue_plain``); CUDA tensors kernel F."""
    _check_same_device("buf", buf, params=params, mu=mu, nu=nu,
                       best_params=best, lr=lr, c1=c1, c2=c2,
                       best_loss=best_loss)
    if buf.device.type == "cpu":
        P = params.shape[-1]
        loss = buf[P:P + 1].clone()
        adam_epilogue_plain(params, mu, nu, best, buf[:P].view(1, P), lr, c1,
                            c2, loss, best_loss, clip_norm)
        return loss
    if buf.device.type != "cuda":
        raise ValueError(f"no fused Adam for device {buf.device}")
    return SIREN_ADAM(params, mu, nu, best, buf, lr, c1, c2, best_loss,
                      clip_norm)


_TIER_KEYS = ("f32_mode", "grad_mode", "sin_degree")


def tier_plan(cfg: SirenSnakeTanhConfig, approx_sin: bool, rff: bool,
              tier: dict | None = None) -> tuple[StackPlan, str]:
    """(StackPlan, grad tier) of a step built with ``tier`` = {f32_mode,
    grad_mode, sin_degree}, each key optional, as the JAX step builders
    read it: a missing ``f32_mode`` is INRAUDIO_F32_PRECISION's, a missing
    ``grad_mode`` INRAUDIO_GRAD_PRECISION's (``grad_dot_mode``; None is the
    environment's f32 tier, the JAX kernels' ``mode=None``), a missing
    ``sin_degree`` 11.  The degree reaches every polynomial sine, layer 0
    and an RFF model's features included, as the JAX step kernel feeds it
    to ``_fwd_pres``; it has no effect without ``approx_sin``.  A key
    outside the three raises."""
    tier = dict(tier or {})
    unknown = set(tier) - set(_TIER_KEYS)
    if unknown:
        raise ValueError(f"unknown tier keys {sorted(unknown)}; a tier "
                         f"takes {_TIER_KEYS}")
    plan = stack_plan(cfg, approx_sin=approx_sin,
                      sin_poly_degree=tier.get("sin_degree", 11),
                      f32_mode=tier.get("f32_mode"), rff=rff)
    gm = tier.get("grad_mode", "env")
    if gm == "env":
        return plan, grad_dot_mode()
    gm = gm or _f32_dot_mode()
    return plan, gm if gm in TC_MODES else "highest"


def make_fused_mse_train_step(cfg: SirenSnakeTanhConfig, train_cfg,
                              n_valid: int, approx_sin: bool = False,
                              step_call=fused_mse_step_call, rff_b=None,
                              tier: dict | None = None):
    """Build step(state: FlatTrainState, coords, targets, weight=None) ->
    (state, (loss, lr)): the semantics of ``train.loop.make_train_step``
    for loss_mode 'mse', alpha 0, per window, with the compute in kernel D.

    ``coords`` (n, d) is shared by the windows, ``targets`` is (k, n),
    ``weight`` (k, n) the per-row loss weight or None.  The
    step updates the state's (k, P) groups in place and returns new (k,)
    scalars.  ``step_call`` does the arithmetic of one step
    (``fused_mse_step_call``; a caller that holds the kernel against its
    plain version passes ``step_plain``, which takes the same arguments).
    ``tier`` ({f32_mode, grad_mode, sin_degree}, ``tier_plan``) fixes the
    step's numerical tier; None reads the environment when the step is
    built.  ``rff_b`` (F, d): the model's RFF projection, folded into
    layer 0; ``coords`` are then the raw (n, d) coordinates."""
    from ..train.optim import PlateauConfig, PlateauState, plateau_update

    plateau_cfg = PlateauConfig(factor=train_cfg.plateau_factor,
                                patience=train_cfg.plateau_patience,
                                min_lr=train_cfg.min_learning_rate)
    plan, gmode = tier_plan(cfg, approx_sin, rff_b is not None, tier)
    bt = None if rff_b is None else _prep_rff_bt(rff_b)
    clip = float(train_cfg.grad_clip_norm)
    track_best = train_cfg.track_best

    def step(state: FlatTrainState, coords, targets, weight=None):
        t = state.step + 1
        tf = t.to(torch.float32)
        c1 = 1.0 - _B1 ** tf
        c2 = 1.0 - _B2 ** tf
        loss = step_call(
            state.params, state.mu, state.nu,
            state.best_params if track_best else None, coords, targets,
            state.lr, c1, c2, state.best_loss, cfg, plan, gmode, n_valid,
            clip, bt, weight=weight)
        pl_state, new_lr = plateau_update(
            PlateauState(best=state.plateau_best, num_bad=state.plateau_bad),
            loss, state.lr, plateau_cfg)
        improved = loss < state.best_loss
        new_state = state._replace(
            step=t, lr=new_lr, plateau_best=pl_state.best,
            plateau_bad=pl_state.num_bad,
            best_loss=torch.where(improved, loss, state.best_loss),
            best_iter=torch.where(improved, t - 1, state.best_iter))
        return new_state, (loss, new_lr)

    return step


def sharded_step_call(mesh, limit):
    """A ``step_call`` for ``make_fused_mse_train_step`` on one rank of a
    row-sharded fit: kernel E on this rank's rows (``limit``, an int32 (1,)
    tensor, its valid rows; ``n_valid`` the whole clip's), the mesh's
    all-reduce of E's buffer, then kernel F on the replicated result.
    Every rank holds the same state (k = 1) and applies the same update, so
    the ranks stay bit-equal."""
    def call(params, mu, nu, best, coords, targets, lr, c1, c2, best_loss,
             cfg, plan, gmode, n_valid, clip_norm, bt=None, weight=None):
        buf = fused_mse_grad_call(params, coords, targets, limit, n_valid,
                                  cfg, plan, gmode, bt, weight)
        mesh.all_reduce_(buf)
        return fused_adam_call(params, mu, nu, best, buf, lr, c1, c2,
                               best_loss, clip_norm)

    return call


def make_sharded_fused_mse_train_step(cfg: SirenSnakeTanhConfig, train_cfg,
                                      n_valid: int, mesh, limit,
                                      approx_sin: bool = False, rff_b=None,
                                      tier: dict | None = None):
    """Build step(state: FlatTrainState, coords, targets, weight=None) ->
    (state, (loss, lr)) for one rank of a row-sharded fit of one model
    (``coords`` (rows, d), ``targets`` and ``weight`` (1, rows) this rank's
    rows, ``limit`` their valid count): ``make_fused_mse_train_step`` with
    ``sharded_step_call``, so
    the plateau and best bookkeeping run on the all-reduced loss; ``tier``
    as there (E's tier: F has none).  Port of the JAX package's
    ``make_sharded_fused_mse_train_step``."""
    return make_fused_mse_train_step(cfg, train_cfg, n_valid, approx_sin,
                                     step_call=sharded_step_call(mesh, limit),
                                     rff_b=rff_b, tier=tier)


def flat_state_from_train_state(state, cfg: SirenSnakeTanhConfig
                                ) -> FlatTrainState:
    """train.loop.TrainState (stacked) -> FlatTrainState (new buffers),
    padded to the kernel width: padded snake a is 1 in params and best, 0
    in the moments."""
    flat = lambda p, a_fill=1.0: flatten_params(p, cfg, a_fill)
    return FlatTrainState(
        params=flat(state.params), mu=flat(state.opt.mu, 0.0),
        nu=flat(state.opt.nu, 0.0), best_params=flat(state.best_params),
        step=state.opt.step, lr=state.opt.lr,
        plateau_best=state.plateau.best, plateau_bad=state.plateau.num_bad,
        best_loss=state.best_loss, best_iter=state.best_iter)


def train_state_from_flat(fstate: FlatTrainState, cfg: SirenSnakeTanhConfig):
    """FlatTrainState -> train.loop.TrainState at the model's own width
    (leaves are views into the flat buffers)."""
    from ..train.loop import TrainState
    from ..train.optim import AdamState, PlateauState
    unf = lambda flat: unpad_params(unflatten_params(flat, cfg),
                                    cfg.hidden_features)
    return TrainState(
        params=unf(fstate.params),
        opt=AdamState(step=fstate.step, mu=unf(fstate.mu),
                      nu=unf(fstate.nu), lr=fstate.lr),
        plateau=PlateauState(best=fstate.plateau_best,
                             num_bad=fstate.plateau_bad),
        best_params=unf(fstate.best_params),
        best_loss=fstate.best_loss, best_iter=fstate.best_iter)

