"""Training step, state and the full-batch fit (port of
``inraudio_tpu/train/loop.py``).

``TrainState`` keeps the JAX package's fields.  For a window population
every leaf carries a leading window axis k and every scalar is a (k,)
tensor: each window has its own Adam step, learning rate, plateau state,
best snapshot and best loss, as under the JAX package's ``vmap``.

Two steps:
- ``make_train_step``: autograd of the model's apply through
  ``losses.mix_loss`` (mse, mae or snr, the STFT term at alpha > 0, an
  optional per-row weight); for a window population the per-window
  ``mix_loss`` of the same config (the JAX package's ``vmap``), so the
  gradient of the summed loss is each window's own; clip, Adam, plateau
  and best per window.  With a fused mlp its backward is kernel C, with a
  fused KAN kernel H.
- the whole-step kernel D (``ops.siren_step``), wired for a population by
  ``make_vmapped_fused_step`` when ``fused_step_plan`` admits the model
  (mse at alpha 0, weighted or not).

``fit`` trains one model on full-batch (coords, targets) in rounds of
``scan_chunk`` steps; a fused mlp's mse fit goes through kernel D as a
one-window population (with the per-row weight, when given), every other
fit through ``make_train_step``.  ``INRAUDIO_FUSED_STEP=0`` sends the fused
mlp's mse fit to the autograd step over kernels B and C instead (the JAX
package's A/B switch).  With ``TrainConfig.precision_schedule`` a fit
through D (or E + F) starts on the cheap tier of ``schedule_tiers`` and
escalates to the full tier for good once a round's last loss crosses
``schedule_db``.  On a mesh of more than one rank
(``parallel.make_mesh``) the rows are sharded: a fused mlp's mse fit takes
kernel E on each shard, one all-reduce and kernel F
(``ops.siren_step.make_sharded_fused_mse_train_step``), every other fit an
autograd step whose gradients are all-reduced in one buffer
(``make_sharded_train_step``).  mse and mae are sums over rows: the local
loss is normalised by the whole clip's rows.  The snr loss and the STFT
term need the whole signal: every rank gathers the prediction of every
shard, computes the loss of the whole padded clip as the JAX package's
partitioner does, and backpropagates its own rows' part of the loss's
cotangent through its shard.

Best-params semantics as the JAX package: ``track_best=True`` snapshots the
parameters that produced the best loss; False keeps the initial ones.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from ..models import INRModel
from ..models.siren import params_from_jax, params_to_numpy
from ..parallel.mesh import (Mesh, normalise_weight, resolve_mesh,
                             shard_array, shard_problem_arrays, shard_rows,
                             whole_signal_arrays)
from ..tree import tree_leaves, tree_map, tree_unflatten
from ..utils.observability import profile_trace, span
from .losses import mix_loss
from .optim import (AdamConfig, AdamState, PlateauConfig, PlateauState,
                    adam_init, adam_update, clip_by_global_norm,
                    plateau_init, plateau_update)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX package's knobs, with its names and defaults: loss_mode in
    {mse, mae, snr}, alpha mixes in the STFT term (multi-resolution with
    ``multi_resolution_stft``), and the precision schedule
    (``precision_schedule``, ``schedule_db``; ``schedule_tiers``)."""

    total_steps: int = 20000
    learning_rate: float = 1e-3
    min_learning_rate: float = 1e-6
    loss_mode: str = "mse"
    alpha: float = 0.0
    multi_resolution_stft: bool = False
    track_best: bool = True
    plateau_factor: float = 0.8
    plateau_patience: int = 200
    grad_clip_norm: float = 0.0
    # history stride applied after the fit (1 = every step)
    log_every: int = 1
    # every N steps, between rounds, call the model's data-adaptive refresh
    # (INRModel.update_grid, the KAN grid update); 0 = never
    update_grid_every: int = 0
    # rows of the refresh batch: an evenly strided subsample of the coords
    # (the unreduced spline output is (batch, in, out))
    update_grid_batch: int = 4096
    # steps per round: the fit reads nothing back from the device inside a
    # round (the JAX package's lax.scan length)
    scan_chunk: int = 500
    # quality-scheduled precision (a fit through kernel D, or E + F on a
    # mesh): rounds start on the cheap tier of schedule_tiers and move to
    # the full tier for good once a round's last loss is below
    # mean(targets^2) / 10^(schedule_db / 10); a no-op on every other route
    precision_schedule: bool = False
    schedule_db: float = 45.0


class TrainState(NamedTuple):
    params: Any
    opt: AdamState
    plateau: PlateauState
    best_params: Any
    best_loss: torch.Tensor
    best_iter: torch.Tensor


def init_train_state(model: INRModel, generator: torch.Generator,
                     cfg: TrainConfig, device: torch.device | str = "cpu",
                     windows: int | None = None) -> TrainState:
    """Fresh state: ``model.init`` drawn from ``generator``; ``windows``
    stacks a population with per-window scalars."""
    params = model.init(generator, device, windows=windows)
    shape = () if windows is None else (int(windows),)
    dev = tree_leaves(params)[0].device
    return TrainState(
        params=params,
        opt=adam_init(params, AdamConfig(lr=cfg.learning_rate), windows),
        plateau=plateau_init(windows, dev),
        best_params=tree_map(torch.clone, params),
        best_loss=torch.full(shape, float("inf"), dtype=torch.float32,
                             device=dev),
        best_iter=torch.zeros(shape, dtype=torch.int32, device=dev))


def _is_mse(cfg: TrainConfig) -> bool:
    return cfg.loss_mode == "mse" and cfg.alpha == 0.0


def make_train_step(model: INRModel, cfg: TrainConfig):
    """One full-batch step: (state, coords, targets, weight=None) ->
    (state, (loss, lr)), the loss ``losses.mix_loss`` of the config with
    the per-row ``weight`` (n, 1) (mean 1 over the real rows) or None.
    With stacked state (leading k) ``targets`` is (k, n, out), ``weight``
    (k, n) or None, and every window's loss (``mix_loss`` over its own
    rows, the STFT terms on its own signal), clip, Adam, plateau and best
    are its own."""

    def loss_fn(params, coords, targets, weight):
        pred = model.apply(params, coords)
        return mix_loss(pred, targets, loss_mode=cfg.loss_mode,
                        alpha=cfg.alpha, weight=weight,
                        multi_resolution=cfg.multi_resolution_stft,
                        windows=pred.dim() == 3)

    update = _make_update(cfg)

    def train_step(state: TrainState, coords, targets, weight=None):
        loss, grads = _loss_and_grads(
            state, lambda p: loss_fn(p, coords, targets, weight))
        return update(state, loss, grads)

    return train_step


def _loss_and_grads(state: TrainState, loss_fn):
    """Autograd of ``loss_fn(params)`` (one loss, or one per window) at the
    state's params -> (loss, grads tree)."""
    leaves = [p.detach().requires_grad_(True)
              for p in tree_leaves(state.params)]
    params = tree_unflatten(state.params, leaves)
    with torch.enable_grad():
        losses = loss_fn(params)
        # a leaf the apply does not reach (a KAN's knot grid) gets a zero
        # gradient, as under jax.grad
        grads = torch.autograd.grad(losses.sum(), leaves, allow_unused=True,
                                    materialize_grads=True)
    return (losses.detach().to(torch.float32),
            tree_unflatten(state.params, list(grads)))


def _make_update(cfg: TrainConfig):
    """(state, loss, grads) -> (state, (loss, lr)): clip, Adam, plateau and
    the best snapshot, per window when the loss has a window axis."""
    adam_cfg = AdamConfig(lr=cfg.learning_rate)
    plateau_cfg = PlateauConfig(factor=cfg.plateau_factor,
                                patience=cfg.plateau_patience,
                                min_lr=cfg.min_learning_rate)

    def update(state: TrainState, loss, grads):
        windows = loss.dim() == 1
        if cfg.grad_clip_norm > 0:
            grads = clip_by_global_norm(grads, cfg.grad_clip_norm, windows)
        new_params, opt = adam_update(state.opt, grads, state.params,
                                      adam_cfg)
        plateau, new_lr = plateau_update(state.plateau, loss, opt.lr,
                                         plateau_cfg)
        opt = opt._replace(lr=new_lr)
        improved = loss < state.best_loss
        if cfg.track_best:
            best_params = tree_map(
                lambda b, p: torch.where(_col(improved, p), p, b),
                state.best_params, state.params)
        else:
            best_params = state.best_params
        new_state = TrainState(
            params=new_params, opt=opt, plateau=plateau,
            best_params=best_params,
            best_loss=torch.where(improved, loss, state.best_loss),
            best_iter=torch.where(improved, opt.step - 1, state.best_iter))
        return new_state, (loss, new_lr)

    return update


def make_sharded_train_step(model: INRModel, cfg: TrainConfig, mesh: Mesh,
                            coords: np.ndarray, targets: np.ndarray,
                            weight: np.ndarray | None = None, mark=None):
    """One rank's autograd step of a row-sharded fit of one model on the
    whole clip (host arrays: ``coords`` (n, d), ``targets`` (n, out), the
    per-row ``weight`` (n,) or (n, 1) or None): step(state) -> (state,
    (loss, lr)), over this rank's rows (``parallel.shard_rows``).

    mse and mae: the local loss is sum(err^2 w) or sum(|err| w) over the
    rank's real rows, divided by n (w the weight, mean 1 over the clip's
    real rows, or 1); its gradients and the loss go through one all-reduce
    as one buffer.

    snr and alpha > 0: every rank holds the whole padded clip's targets and
    loss weight (``parallel.whole_signal_arrays``), gathers the detached
    prediction of every shard (the clip in rank order, padded as the JAX
    package pads it to a multiple of its devices), computes ``mix_loss`` of
    the whole clip and its cotangent, and backpropagates its own rows'
    slice of that cotangent through its shard; the gradients go through one
    all-reduce.  Every rank computes the same loss from the same gathered
    clip.  ``mark(part)``, when given, is called after each part of this
    step (forward, gather, loss, backward, all-reduce), for a caller that
    times them.

    Then clip, Adam, plateau and best run on the replicated values, as
    XLA's partitioner runs the JAX package's sharded step."""
    update = _make_update(cfg)
    n = coords.shape[0]
    if cfg.loss_mode in ("mse", "mae") and cfg.alpha == 0.0:  # row sums
        cs, ts, ws, sh = shard_problem_arrays(mesh, coords, targets,
                                              weight=weight)
        return _row_sum_step(model, cfg, mesh, n, sh.valid, update, cs, ts,
                             ws)
    sh = shard_rows(mesh, n)
    cs = shard_array(mesh, sh, coords)
    targets_all, weight_all = whole_signal_arrays(mesh, targets, weight)
    own = slice(sh.start, sh.start + sh.rows)
    mark = mark or (lambda part: None)

    def train_step(state: TrainState):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(state.params)]
        params = tree_unflatten(state.params, leaves)
        with torch.enable_grad():
            pred = model.apply(params, cs)
            mark("forward")
            clip = mesh.all_gather(pred.detach()).requires_grad_(True)
            mark("gather")
            loss = mix_loss(clip, targets_all, loss_mode=cfg.loss_mode,
                            alpha=cfg.alpha, weight=weight_all,
                            multi_resolution=cfg.multi_resolution_stft)
            (cot,) = torch.autograd.grad(loss, clip)
            mark("loss")
            grads = torch.autograd.grad(pred, leaves, cot[own],
                                        allow_unused=True,
                                        materialize_grads=True)
            mark("backward")
        buf = torch.cat([g.reshape(-1) for g in grads])
        mesh.all_reduce_(buf)
        mark("all-reduce")
        parts = torch.split(buf, [g.numel() for g in grads])
        grads = tree_unflatten(state.params, [p.view_as(g)
                                              for p, g in zip(parts, grads)])
        return update(state, loss.detach().to(torch.float32), grads)

    return train_step


def _row_sum_step(model: INRModel, cfg: TrainConfig, mesh: Mesh,
                  n_valid: int, valid: int, update, coords, targets, weight):
    """The mse / mae step of ``make_sharded_train_step`` on this rank's
    (padded) rows, of which the first ``valid`` are real."""
    inv_n = 1.0 / float(n_valid)
    term = torch.square if cfg.loss_mode == "mse" else torch.abs

    def loss_fn(params):
        per_row = term(model.apply(params, coords) - targets)
        if weight is not None:
            per_row = per_row * weight
        return torch.sum(per_row[:valid]) * inv_n

    def train_step(state: TrainState):
        loss, grads = _loss_and_grads(state, loss_fn)
        leaves = tree_leaves(grads)
        buf = torch.cat([g.reshape(-1) for g in leaves] + [loss.reshape(1)])
        mesh.all_reduce_(buf)
        parts = torch.split(buf, [g.numel() for g in leaves] + [1])
        grads = tree_unflatten(grads, [p.view_as(g)
                                       for p, g in zip(parts, leaves)])
        return update(state, parts[-1].reshape(()), grads)

    return train_step


def _col(x: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape + (1,) * (leaf.dim() - x.dim()))


def fused_step_plan(model: INRModel, cfg: TrainConfig,
                    n_rows: int) -> int | None:
    """Row tile of the whole-step kernel, or None when the fit cannot route
    through it (non-mse loss, a grid refresh, a model without the fused
    step, or ``INRAUDIO_FUSED_STEP=0``: the JAX package's A/B switch, which
    sends a fused mlp's mse fit to the autograd step over kernels B and
    C).  A weighted mse fit keeps the kernel: D and E stream the per-row
    weight beside the targets.  A fused model at a width the kernels do not
    take raises ``ValueError`` (it is not sent elsewhere silently)."""
    ctx = model.fused_step_ctx
    if ctx is None:
        return None
    from ..ops.siren_step import step_block_rows
    from ..ops.siren_train import check_kernel_width
    check_kernel_width(ctx["cfg"])
    if not _is_mse(cfg) or cfg.update_grid_every:
        return None
    if os.environ.get("INRAUDIO_FUSED_STEP", "1") == "0":
        return None
    return step_block_rows(ctx["cfg"], n_rows, ctx["rff_b"])


def make_vmapped_fused_step(model: INRModel, cfg: TrainConfig,
                            coords: torch.Tensor, tier: dict | None = None):
    """Wire kernel D for a window population on one shared grid (a model
    that ``fused_step_plan`` admits).

    Returns ``(vstep, to_flat, from_flat, prep_targets)``:
    ``vstep(states, targets, weight=None)`` the population step (coords
    bound; ``weight`` (k, n) the per-row loss weight), ``to_flat`` /
    ``from_flat`` stacked TrainState <-> FlatTrainState, ``prep_targets(t)``
    (k, n, 1) targets (or weights) -> the kernel's (k, n) tensor on the
    coords' device.  The kernel masks the ragged row tile itself, so
    nothing is padded.  The step's arithmetic is the model's
    ``fused_step_ctx["step"]``; an RFF model's projection
    (``fused_step_ctx["rff_b"]``) goes to the step, and ``coords`` are its
    raw coordinates.  ``tier`` ({f32_mode, grad_mode, sin_degree}, as
    ``ops.siren_step.tier_plan`` reads it) fixes the step's numerical tier;
    None is the environment's."""
    from ..ops.siren_step import (flat_state_from_train_state,
                                  make_fused_mse_train_step,
                                  train_state_from_flat)
    ctx = model.fused_step_ctx
    mcfg = ctx["cfg"]
    fstep = make_fused_mse_train_step(mcfg, cfg, coords.shape[0],
                                      approx_sin=ctx["approx_sin"],
                                      step_call=ctx["step"],
                                      rff_b=ctx["rff_b"], tier=tier)

    def vstep(states, targets, weight=None):
        return fstep(states, coords, targets, weight)

    def prep_targets(targets) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(targets, np.float32))
        return t.reshape(t.shape[0], -1).to(coords.device).contiguous()

    return (vstep, lambda s: flat_state_from_train_state(s, mcfg),
            lambda s: train_state_from_flat(s, mcfg), prep_targets)


# ---------------------------------------------------------------------------
# The full-batch fit
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FitResult:
    params: Any            # parameters used for decode (best or final)
    final_params: Any
    state: TrainState
    loss_history: np.ndarray
    lr_history: np.ndarray
    best_loss: float
    best_iter: int
    steps: int
    train_time_s: float
    steps_per_sec: float


def schedule_tiers() -> tuple[dict, None]:
    """The precision schedule's ladder (cheap, full), as in the JAX
    package: cheap = bf16x2 forward products, one bf16 pass for both
    backward products, the degree-7 sin polynomial; full = None, the
    environment's tiers (bf16x3 forward, INRAUDIO_GRAD_PRECISION's
    backward, degree 11).  The flat train state does not depend on the
    tier, so ``fit`` switches between the two steps on one carry."""
    return dict(f32_mode="bf16x2", grad_mode="bf16", sin_degree=7), None


def _one_window_step(model: INRModel, cfg: TrainConfig, state: TrainState,
                     coords: torch.Tensor, targets: np.ndarray,
                     weight: np.ndarray | None, tiers=(None,)):
    """Kernel D for one model: the state as a population of one window,
    with the normalised per-row ``weight`` (n, 1) or None.  Returns (carry,
    [step(carry) -> (carry, (loss, lr)) for each of ``tiers``], carry ->
    TrainState); the steps share the carry."""
    steps = []
    for tier in tiers:
        vstep, to_flat, from_flat, prep_targets = make_vmapped_fused_step(
            model, cfg, coords, tier)
        steps.append(vstep)
    targets_k = prep_targets(np.asarray(targets, np.float32)[None])
    weight_k = None if weight is None else prep_targets(weight[None])
    carry = to_flat(tree_map(lambda t: t.unsqueeze(0), state))

    def one(vstep):
        def step(carry):
            carry, (loss, lr) = vstep(carry, targets_k, weight_k)
            return carry, (loss[0], lr[0])
        return step

    return (carry, [one(v) for v in steps],
            lambda c: tree_map(lambda t: t[0], from_flat(c)))


def _sharded_step(model: INRModel, cfg: TrainConfig, state: TrainState,
                  coords: np.ndarray, targets: np.ndarray, mesh: Mesh,
                  weight: np.ndarray | None, tiers=(None,)):
    """One rank of a row-sharded fit: kernels E + F for a model that
    ``fused_step_plan`` admits (rows padded to whole row tiles per rank, as
    the JAX fit pads them), one step a tier of ``tiers`` sharing the carry;
    the sharded autograd step (``make_sharded_train_step``) otherwise (one
    step, whatever ``tiers``).
    The per-row ``weight`` (n,) or (n, 1) is normalised over the whole
    clip, then split with the rows, 0 on padding.  Returns (carry, [step
    (carry) -> (carry, (loss, lr))], carry -> TrainState)."""
    n = coords.shape[0]
    block = fused_step_plan(model, cfg, -(-n // mesh.size))
    if block is None:
        return (state, [make_sharded_train_step(model, cfg, mesh, coords,
                                                targets, weight)],
                lambda c: c)
    from ..ops.siren_step import (flat_state_from_train_state,
                                  make_sharded_fused_mse_train_step,
                                  train_state_from_flat)
    ctx = model.fused_step_ctx
    mcfg = ctx["cfg"]
    cs, ts, ws, sh = shard_problem_arrays(mesh, coords, targets, block,
                                          weight=weight)
    ts = ts.reshape(1, -1)
    ws = None if ws is None else ws.reshape(1, -1)
    limit = torch.tensor([sh.valid], dtype=torch.int32, device=mesh.device)
    carry = flat_state_from_train_state(
        tree_map(lambda t: t.unsqueeze(0), state), mcfg)

    def one(tier):
        sstep = make_sharded_fused_mse_train_step(
            mcfg, cfg, n, mesh, limit, approx_sin=ctx["approx_sin"],
            rff_b=ctx["rff_b"], tier=tier)

        def step(carry):
            carry, (loss, lr) = sstep(carry, cs, ts, ws)
            return carry, (loss[0], lr[0])
        return step

    return (carry, [one(t) for t in tiers],
            lambda c: tree_map(lambda t: t[0], train_state_from_flat(c, mcfg)))


def fit(model: INRModel, coords, targets, cfg: TrainConfig | None = None,
        generator: torch.Generator | None = None,
        state: TrainState | None = None, checkpoint_every: int = 0,
        checkpoint_path: str | None = None, metrics=None,
        device: torch.device | str | None = None,
        mesh: Mesh | None = None, weight=None,
        profile_dir: str | None = None) -> FitResult:
    """Fit one model to full-batch (coords (n, d), targets (n, out)) on
    ``device`` (default the card; without one it raises), with the loss of
    ``cfg`` (``losses.mix_loss``) and an optional per-row loss ``weight``
    (n,) or (n, 1), normalised to mean 1 over the rows before any padding
    (``normalise_weight``).

    ``mesh`` (``parallel.make_mesh(device)`` when None: a world of one,
    or every rank under ``torchrun``) places the fit: it runs on
    ``mesh.device``, and a ``device`` given beside it must be that one
    (``parallel.resolve_mesh``).  A mesh of one takes the single-device routes
    (kernel D for a fused mlp's mse fit, weighted or not; autograd
    otherwise).  On more ranks each rank holds an equal shard of the rows
    (and of the weight) and a copy of the state: a fused mlp's mse fit
    steps through kernel E on its shard, one all-reduce and kernel F; every
    other fit (the KAN with kernels G and H included) through the sharded
    autograd step, which gathers the prediction of the whole clip for the
    snr loss and the STFT term.  Every rank gets the same ``FitResult`` (its
    ``train_time_s`` from the first rank's start to the last rank's end);
    only rank 0 writes checkpoints.

    ``cfg.precision_schedule``: a fit through D (or E + F) builds the cheap
    step of ``schedule_tiers`` beside the full one on the same carry;
    rounds start on the cheap step, and after the first round whose last
    loss is below mean(targets^2) / 10^(schedule_db / 10) every round takes
    the full step (the JAX package's rule; on a mesh every rank reads the
    same all-reduced loss, so all escalate at one round).  Every other
    route ignores it, as in the JAX package.

    Rounds of ``scan_chunk`` steps read nothing back from the device.
    Between rounds: the grid refresh (``update_grid_every`` /
    ``update_grid_batch``, Adam moments kept, from a strided subsample of
    the whole clip on every rank), a ``metrics`` JSONL record (a
    ``utils.observability.MetricsLogger``), and a checkpoint of the
    whole TrainState to ``checkpoint_path`` about every
    ``checkpoint_every`` steps.  ``profile_dir`` records a
    ``torch.profiler`` trace of round min(1, rounds - 1) into that
    directory, on rank 0 (``utils.observability.profile_trace``; the card is
    synchronised before the trace closes).  ``state`` warm-starts;
    otherwise the state is drawn from ``generator`` (seed 0 when None).

    Under a ``torch.profiler`` session the call is the span ``inr.fit``
    (attrs ``steps``, ``route``), holding ``inr.fit.prologue``, each
    round's ``inr.fit.round`` (``steps``, ``tier``) and
    ``inr.fit.between_rounds``, and ``inr.fit.epilogue``; the two waits
    for the card are ``inr.fit.sync`` (``utils.observability.span``)."""
    cfg = cfg or TrainConfig()
    with span("inr.fit", steps=cfg.total_steps) as call:
        with span("inr.fit.prologue"):
            mesh = resolve_mesh(mesh, device)
            dev = mesh.device
            if state is None:
                state = init_train_state(
                    model, generator or torch.Generator().manual_seed(0),
                    cfg, dev)
            else:
                state = tree_map(lambda t: t.to(dev), state)
            coords_d = torch.as_tensor(coords, dtype=torch.float32).to(dev)
            targets_np = np.asarray(targets, np.float32)
            weight_n = None if weight is None else normalise_weight(weight)
            tiers = ((None, schedule_tiers()[0]) if cfg.precision_schedule
                     else (None,))

            if mesh.size > 1:
                # shard_problem_arrays normalises the weight over the whole
                # clip, then splits it
                carry, steps, unstack = _sharded_step(
                    model, cfg, state, coords_d.cpu().numpy(), targets_np,
                    mesh, weight, tiers)
                # the autograd step carries the TrainState, E + F a flat one
                route = ("sharded_autograd" if isinstance(carry, TrainState)
                         else "kernels_ef")
            elif fused_step_plan(model, cfg, coords_d.shape[0]) is not None:
                carry, steps, unstack = _one_window_step(
                    model, cfg, state, coords_d, targets, weight_n, tiers)
                route = "kernel_d"
            else:
                train_step = make_train_step(model, cfg)
                targets_d = torch.from_numpy(targets_np).to(dev)
                weight_d = (None if weight_n is None
                            else torch.from_numpy(weight_n).to(dev))
                carry, unstack = state, (lambda c: c)
                steps = [lambda c: train_step(c, coords_d, targets_d,
                                              weight_d)]
                route = "autograd"
            call.set(route=route)
            full_step = steps[0]
            cheap_step = steps[1] if len(steps) > 1 else None
            sched_thr = float("inf")
            if cheap_step is not None:
                power = float(np.mean(targets_np ** 2))
                sched_thr = power / 10.0 ** (cfg.schedule_db / 10.0)

            sync = (torch.cuda.synchronize if dev.type == "cuda"
                    else (lambda: None))
            chunk = max(1, min(cfg.scan_chunk, cfg.total_steps))
            n_rounds = -(-cfg.total_steps // chunk)
            with span("inr.fit.sync"):
                sync()
        t0 = time.time()
        loss_chunks, lr_chunks = [], []
        done = last_ckpt = last_grid_update = rounds = 0
        while done < cfg.total_steps:
            m = min(chunk, cfg.total_steps - done)
            step = cheap_step if cheap_step is not None else full_step
            losses, lrs = [], []
            # the trace holds a round after the first (its steps warm)
            profiled = (profile_dir is not None and mesh.rank == 0
                        and rounds == min(1, n_rounds - 1))
            with profile_trace(profile_dir, enabled=profiled):
                with span("inr.fit.round", steps=m,
                          tier="full" if step is full_step else "cheap"):
                    for _ in range(m):
                        carry, (loss, lr) = step(carry)
                        losses.append(loss)
                        lrs.append(lr)
                    if profiled:
                        sync()
            with span("inr.fit.between_rounds"):
                loss_chunks.append(torch.stack(losses))
                lr_chunks.append(torch.stack(lrs))
                if (cheap_step is not None
                        and float(loss_chunks[-1][-1]) < sched_thr):
                    cheap_step = None  # escalated for good
                done += m
                rounds += 1
                if (cfg.update_grid_every and model.update_grid is not None
                        and done - last_grid_update >= cfg.update_grid_every
                        and done < cfg.total_steps):
                    n_rows = coords_d.shape[0]
                    grid_x = coords_d
                    if n_rows > cfg.update_grid_batch:
                        grid_x = coords_d[
                            ::-(-n_rows // cfg.update_grid_batch)]
                    carry = carry._replace(
                        params=model.update_grid(carry.params, grid_x))
                    last_grid_update = done
                if metrics is not None:
                    elapsed = time.time() - t0
                    metrics.log({"event": "round", "step": done,
                                 "loss": float(loss_chunks[-1][-1]),
                                 "lr": float(lr_chunks[-1][-1]),
                                 "elapsed_s": round(elapsed, 3),
                                 "steps_per_sec": round(
                                     done / max(elapsed, 1e-9), 2)})
                if (checkpoint_every and checkpoint_path
                        and done - last_ckpt >= checkpoint_every
                        and done < cfg.total_steps):
                    if mesh.rank == 0:
                        from .checkpoint import save_checkpoint
                        save_checkpoint(checkpoint_path, unstack(carry),
                                        extra={"steps_done": done})
                    last_ckpt = done
        with span("inr.fit.epilogue"):
            # the card's queue drains in its own span: the epilogue's self
            # time is the host's
            with span("inr.fit.sync"):
                sync()
            train_time = mesh.span(t0, time.time())
            state = unstack(carry)
            cat = lambda xs: (torch.cat(xs).cpu().numpy()  # noqa: E731
                              if xs else np.zeros((0,), np.float32))
            loss_hist, lr_hist = cat(loss_chunks), cat(lr_chunks)
            if cfg.log_every > 1:
                loss_hist = loss_hist[::cfg.log_every]
                lr_hist = lr_hist[::cfg.log_every]
            return FitResult(
                params=state.best_params if cfg.track_best else state.params,
                final_params=state.params, state=state,
                loss_history=loss_hist, lr_history=lr_hist,
                best_loss=float(state.best_loss),
                best_iter=int(state.best_iter), steps=cfg.total_steps,
                train_time_s=train_time,
                steps_per_sec=cfg.total_steps / max(train_time, 1e-9))


# ---------------------------------------------------------------------------
# Carrying a TrainState across the packages (numpy in between)
# ---------------------------------------------------------------------------

def train_state_from_jax(state, device: torch.device | str = "cpu"
                         ) -> TrainState:
    """A JAX ``TrainState`` whose leaves are numpy arrays (e.g.
    ``jax.tree.map(np.asarray, state)``; any object with the same fields)
    -> the port's TrainState on ``device``: params, moments, best params,
    step, lr, plateau state, best_loss and best_iter."""
    conv = lambda t: params_from_jax(t, device)
    return TrainState(
        params=conv(state.params),
        opt=AdamState(step=conv(state.opt.step), mu=conv(state.opt.mu),
                      nu=conv(state.opt.nu), lr=conv(state.opt.lr)),
        plateau=PlateauState(best=conv(state.plateau.best),
                             num_bad=conv(state.plateau.num_bad)),
        best_params=conv(state.best_params),
        best_loss=conv(state.best_loss), best_iter=conv(state.best_iter))


def train_state_to_numpy(state: TrainState) -> TrainState:
    """The port's TrainState -> the same structure of host numpy arrays
    (field for field what the JAX package's TrainState holds)."""
    return TrainState(
        params=params_to_numpy(state.params),
        opt=AdamState(*(params_to_numpy(x) for x in state.opt)),
        plateau=PlateauState(*(params_to_numpy(x) for x in state.plateau)),
        best_params=params_to_numpy(state.best_params),
        best_loss=params_to_numpy(state.best_loss),
        best_iter=params_to_numpy(state.best_iter))
