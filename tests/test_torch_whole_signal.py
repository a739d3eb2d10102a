"""The losses that need more than a row at a time, held against the JAX
package on the CPU: ``fit`` on a mesh with the snr loss or the STFT term
(alpha > 0, one or several resolutions, weighted or not) against the JAX
``fit`` on as many of conftest's virtual devices (GSPMD computes the loss
of the whole padded clip there) and against the port's one rank; and the
per-window losses of a window population (``make_train_step`` with mae,
snr or alpha > 0) against the JAX package's vmapped step, with the
512-row window that the STFT term refuses in both packages.

The port's ranks are threads of this process, each with its own gloo group
(``run_thread_ranks`` of tests/test_torch_cuda.py).  Inputs come from numpy
with a seed; the JAX package draws the initial states and they cross as
numpy arrays.

Tolerances: those of tests/test_torch_shard.py for fits on a mesh (the
packages sum their f32 products and the whole clip's energies in different
orders: losses to LOSS_RTOL, parameters a few steps on to PARAM_ATOL /
PARAM_RTOL), and those of tests/test_torch_train.py for population steps
(STEP_RTOL on the per-window losses, the state to its P_* / MU_* bounds);
a loss with the STFT term to the loss zoo's VALUE_RTOL.
The snr loss is a difference of logs that starts near 0 dB, so its
history is also held to LOSS_ATOL_DB absolutely.  The STFT term's gradient
agrees between the packages only to ~3e-4 of its largest element (the log
magnitude's 1 / |X| in quiet bins, tests/test_torch_losses.py), and Adam's
first steps move every parameter by about the learning rate whatever its
gradient's size, so a fit a few steps on is held beside a control: the
JAX fit from the initial parameters times 1 + 2^-22, whose distance from
the JAX fit, times CTRL_X, bounds the port's (or LOSS_RTOL / PARAM_ATOL,
whichever is larger).  The sharded step's gradient itself is held to the
JAX gradient of the whole padded clip's loss at GRAD_RTOL of its largest
element, the loss zoo's bound."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inraudio_tpu.models import SirenSnakeTanhConfig as JaxConfig
from inraudio_tpu.models import build_model as jax_build_model
from inraudio_tpu.parallel import mesh as jmesh
from inraudio_tpu.train import losses as jlosses
from inraudio_tpu.train import loop as jloop
from inraudio_tpu_torch.data import write_wav
from inraudio_tpu_torch.models import SirenSnakeTanhConfig, build_model
from inraudio_tpu_torch.parallel import Mesh, whole_signal_arrays
from inraudio_tpu_torch.train import loop as tloop
from inraudio_tpu_torch.train import losses as tlosses
from inraudio_tpu_torch.train.multi_inr import MultiINRConfig, multi_inr_fit
from inraudio_tpu_torch.tree import tree_leaves
from test_torch_cuda import run_thread_ranks

torch.set_num_threads(1)

MLP = dict(hidden_features=16, first_omega_0=300.0, num_sine=1, num_snake=1)
LOSS_RTOL, LOSS_ATOL_DB = 1e-5, 1e-5
PARAM_ATOL = 2e-5
GRAD_RTOL = 1e-3
CTRL_X = 10.0
ULP = 1.0 + 2.0 ** -22
STEP_RTOL = 1e-6
VALUE_RTOL = 2e-5  # a loss with the STFT term (tests/test_torch_losses.py)
P_RTOL, P_ATOL = 3e-5, 3e-6
MU_RTOL, MU_ATOL = 1e-3, 1e-6
RANK_TIMEOUT_S = 60.0


@pytest.fixture
def inherit_grad_tier(monkeypatch):
    """The backward products in the forward's f32 tier.  The JAX kernels
    read the env var while tracing, so drop their caches."""
    monkeypatch.setenv("INRAUDIO_GRAD_PRECISION", "inherit")
    jax.clear_caches()
    yield
    jax.clear_caches()


def _clip(n, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(-1, 1, n, dtype=np.float32).reshape(-1, 1)
    y = (0.6 * np.sin(2 * np.pi * 3 * x) + 0.2 * np.sin(2 * np.pi * 11 * x)
         + 0.05 * rng.standard_normal((n, 1))).astype(np.float32)
    w = rng.uniform(0.8, 1.0, n).astype(np.float32)
    w[::41] = 0.0
    return x, y, w[:, None]


def _states(jm, tc_kw, seed=3):
    js = jloop.init_train_state(jm, jax.random.PRNGKey(seed),
                                jloop.TrainConfig(**tc_kw))
    return js, tloop.train_state_from_jax(jax.tree.map(np.asarray, js))


def _assert_trees_close(jtree, ttree, atol, rtol):
    for a, b in zip(jax.tree.leaves(jtree), tree_leaves(ttree)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a, np.float32),
                                   atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# Whole-signal losses on a mesh
# ---------------------------------------------------------------------------

# (loss config, weighted, ranks, rows): n = 1001 and 1201 are not
# multiples of their ranks (the JAX package pads and masks), 1200 is
MESH_CASES = {
    "snr_2": (dict(loss_mode="snr"), False, 2, 1200),
    "snr_weighted_3": (dict(loss_mode="snr"), True, 3, 1001),
    "alpha_2_padded": (dict(alpha=0.5), False, 2, 1201),
    "alpha_weighted_3": (dict(alpha=0.5, loss_mode="mae"), True, 3, 1200),
    "mrstft_3_padded": (dict(alpha=0.5, multi_resolution_stft=True), False,
                        3, 1201),
    "mrstft_snr_weighted_2": (dict(alpha=0.3, loss_mode="snr",
                                   multi_resolution_stft=True), True, 2,
                              1201),
}


def _perturbed(js):
    """The 1-ulp control's initial state, in buffers of its own (a JAX
    fit donates its state)."""
    c = jax.tree.map(lambda v: jnp.array(v, copy=True), js)
    p = jax.tree.map(lambda v: v * np.float32(ULP), c.params)
    return c._replace(params=p,
                      best_params=jax.tree.map(jnp.copy, p))


def _assert_beside_control(got, ref, ctrl, floor):
    """max |got - ref| within CTRL_X times the control's max distance from
    ref, or ``floor``."""
    got, ref, ctrl = (np.asarray(a, np.float64) for a in (got, ref, ctrl))
    limit = max(CTRL_X * float(np.max(np.abs(ctrl - ref))), floor)
    assert float(np.max(np.abs(got - ref))) <= limit


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_whole_signal_fit_on_a_mesh_matches_jax(case):
    """``fit`` of the mlp on thread ranks against the JAX ``fit`` on as
    many devices, from one state: the first loss to LOSS_RTOL, the loss
    history and the parameters beside the 1-ulp control, the lr history
    and the best step equal; the ranks' states bit-equal; where no row was
    padded, the port's one-rank fit too (a padded clip's STFT frames
    differ from the unpadded clip's, in JAX as here)."""
    kw, weighted, ranks, n = MESH_CASES[case]
    kw = dict(total_steps=3, scan_chunk=3, grad_clip_norm=1.0, **kw)
    jm = jax_build_model("mlp", JaxConfig(**MLP))
    tm = build_model("mlp", SirenSnakeTanhConfig(**MLP))
    js, ts = _states(jm, kw)
    x, y, w = _clip(n)
    w = w if weighted else None
    jtc = jloop.TrainConfig(**kw)
    mesh = jmesh.make_mesh(jax.devices()[:ranks])
    js_ctrl = _perturbed(js)
    jres = jloop.fit(jm, x, y, jtc, state=js, weight=w, mesh=mesh)
    jctrl = jloop.fit(jm, x, y, jtc, state=js_ctrl, weight=w, mesh=mesh)
    tc = tloop.TrainConfig(**kw)
    res = run_thread_ranks(ranks, lambda m: tloop.fit(
        tm, x, y, tc, state=ts, weight=w, mesh=m), device="cpu",
        timeout_s=RANK_TIMEOUT_S)
    for r in res[1:]:
        np.testing.assert_array_equal(r.loss_history, res[0].loss_history)
        for a, b in zip(tree_leaves(r.state), tree_leaves(res[0].state)):
            assert torch.equal(a, b)
    t = res[0]
    np.testing.assert_allclose(t.loss_history[0], jres.loss_history[0],
                               rtol=LOSS_RTOL, atol=LOSS_ATOL_DB)
    _assert_beside_control(t.loss_history, jres.loss_history,
                           jctrl.loss_history,
                           LOSS_RTOL * float(np.abs(jres.loss_history).max()))
    np.testing.assert_allclose(t.lr_history, jres.lr_history, rtol=1e-6)
    assert t.best_iter == jres.best_iter
    for a, b, c in zip(jax.tree.leaves(jres.state.params),
                       tree_leaves(t.state.params),
                       jax.tree.leaves(jctrl.state.params)):
        _assert_beside_control(b.numpy(), a, c, PARAM_ATOL)
    if n % ranks == 0:
        one = tloop.fit(tm, x, y, tc, state=ts, weight=w, device="cpu")
        np.testing.assert_allclose(t.loss_history[0], one.loss_history[0],
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL_DB)
        _assert_beside_control(t.loss_history, one.loss_history,
                               jctrl.loss_history - jres.loss_history
                               + one.loss_history,
                               LOSS_RTOL * float(np.abs(
                                   one.loss_history).max()))


@pytest.mark.parametrize("case", ["snr_weighted_3", "alpha_2_padded"])
def test_sharded_step_gradient_is_the_whole_clip_s(case, monkeypatch):
    """One sharded step's all-reduced gradient (captured where clip and
    Adam take it) against ``jax.grad`` of the JAX ``mix_loss`` over the
    whole padded clip with its padding mask: the cotangent of every rank's
    rows goes back through that rank's shard, and the sum is the whole
    clip's gradient."""
    kw, weighted, ranks, n = MESH_CASES[case]
    jm = jax_build_model("mlp", JaxConfig(**MLP))
    tm = build_model("mlp", SirenSnakeTanhConfig(**MLP))
    js, ts = _states(jm, kw)
    x, y, w = _clip(n)
    w = w if weighted else None
    mesh = jmesh.make_mesh(jax.devices()[:ranks])
    cp, tp, wp, _ = jmesh.shard_problem_arrays(mesh, x, y, w)
    jcfg = jloop.TrainConfig(**kw)

    def jloss(p):
        return jlosses.mix_loss(jm.apply(p, cp), tp, loss_mode=jcfg.loss_mode,
                                alpha=jcfg.alpha, weight=wp,
                                multi_resolution=jcfg.multi_resolution_stft)

    jval, jgrad = jax.value_and_grad(jloss)(js.params)
    seen = []
    make_update = tloop._make_update

    def capture(cfg):
        update = make_update(cfg)

        def run(state, loss, grads):
            seen.append((loss, grads))
            return update(state, loss, grads)
        return run

    monkeypatch.setattr(tloop, "_make_update", capture)
    tc = tloop.TrainConfig(total_steps=1, **kw)
    run_thread_ranks(ranks, lambda m: tloop.fit(tm, x, y, tc, state=ts,
                                                weight=w, mesh=m),
                     device="cpu", timeout_s=RANK_TIMEOUT_S)
    assert len(seen) == ranks
    loss, grads = seen[0]
    np.testing.assert_allclose(float(loss), float(jval), rtol=LOSS_RTOL,
                               atol=LOSS_ATOL_DB)
    for a, g in zip(jax.tree.leaves(jgrad), tree_leaves(grads)):
        a = np.asarray(a, np.float32)
        np.testing.assert_allclose(g.numpy(), a, rtol=0,
                                   atol=GRAD_RTOL * float(np.abs(a).max()))


@pytest.mark.parametrize("n,ranks,weighted", [(1000, 2, False),
                                              (1001, 3, False),
                                              (1001, 3, True)],
                         ids=["even", "padded", "padded_weighted"])
def test_whole_signal_arrays_are_the_jax_padded_batch(n, ranks, weighted):
    """The whole clip every rank sees: targets zero-padded to a multiple
    of the ranks, the weight (ones when rows were padded) normalised to
    mean 1 over the padded batch, 0 on padding: the JAX package's
    ``shard_problem_arrays`` before it shards."""
    x, y, w = _clip(n)
    w = w if weighted else None
    jmesh_ = jmesh.make_mesh(jax.devices()[:ranks])
    _, jt, jw, _ = jmesh.shard_problem_arrays(jmesh_, x, y, w)
    t, tw = whole_signal_arrays(Mesh(None, 0, ranks, torch.device("cpu")),
                                y, w)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    if jw is None:
        assert tw is None
    else:
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-7)


# ---------------------------------------------------------------------------
# Per-window losses of a window population
# ---------------------------------------------------------------------------

def _population(jm, tc, k, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), k)
    return jax.vmap(lambda kk: jloop.init_train_state(jm, kk, tc))(keys)


def _windows(n, k=2):
    coords = np.linspace(-1, 1, n, dtype=np.float32).reshape(-1, 1)
    t = np.sin(2 * np.pi * np.array([3.0, 5.0, 7.0])[:k, None]
               * coords[None, :, 0])
    return coords, (0.8 * t).astype(np.float32)[..., None]


# (loss config, rows, fused): the multi-resolution term needs windows
# longer than 1024 rows, where the JAX kernels' interpret mode is slow, so
# that case runs both packages' unfused mlp
POP_CASES = {
    "mae": (dict(loss_mode="mae"), 300, True),
    "snr": (dict(loss_mode="snr"), 300, True),
    "alpha": (dict(alpha=0.5), 600, True),
    "mrstft_snr": (dict(alpha=0.5, loss_mode="snr",
                        multi_resolution_stft=True), 1100, False),
}


@pytest.mark.parametrize("case", list(POP_CASES))
def test_population_losses_match_jax_vmapped_step(inherit_grad_tier, case):
    """The port's population step (the fused mlp: A's and C's plain
    versions, every window's own ``mix_loss``) against the JAX package's
    ``vmap(make_train_step)`` (its fused forward and kernel C in interpret
    mode), three steps from one state."""
    kw, n, fused = POP_CASES[case]
    kw = dict(grad_clip_norm=1.0, plateau_patience=1, **kw)
    jm = jax_build_model("mlp", JaxConfig(**MLP), fused=fused,
                         interpret=True, approx_sin=fused)
    tm = build_model("mlp", SirenSnakeTanhConfig(**MLP), fused=fused,
                     approx_sin=fused)
    jtc, ttc = jloop.TrainConfig(**kw), tloop.TrainConfig(**kw)
    assert tloop.fused_step_plan(tm, ttc, n) is None
    coords, targets = _windows(n)
    js = _population(jm, jtc, 2, seed=4)
    jstep = jax.jit(jax.vmap(jloop.make_train_step(jm, jtc),
                             in_axes=(0, None, 0)))
    tstep = tloop.make_train_step(tm, ttc)
    s, c = js, _perturbed(js)
    t = tloop.train_state_from_jax(jax.tree.map(np.asarray, js))
    xs, ys = jnp.asarray(coords), jnp.asarray(targets)
    for i in range(3):
        s, (jl, jlr) = jstep(s, xs, ys)
        c, (cl, _) = jstep(c, xs, ys)
        t, (tl, tlr) = tstep(t, torch.from_numpy(coords),
                             torch.from_numpy(targets))
        assert tl.shape == (2,)
        if "alpha" not in kw:
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       rtol=STEP_RTOL, atol=LOSS_ATOL_DB)
        elif i == 0:
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       rtol=VALUE_RTOL)
        else:
            _assert_beside_control(tl.numpy(), jl, cl,
                                   STEP_RTOL * float(np.abs(jl).max()))
        np.testing.assert_array_equal(tlr.numpy(), np.asarray(jlr))
    if "alpha" not in kw:
        for group in ("params", "best_params"):
            _assert_trees_close(getattr(s, group), getattr(t, group),
                                P_ATOL, P_RTOL)
        _assert_trees_close(s.opt.mu, t.opt.mu, MU_ATOL, MU_RTOL)
        return
    for a, b, cc in zip(jax.tree.leaves(s.params), tree_leaves(t.params),
                        jax.tree.leaves(c.params)):
        _assert_beside_control(b.numpy(), a, cc, P_ATOL)


def test_population_loss_is_each_window_s_own():
    """``mix_loss(windows=True)`` is each window's single-signal loss, the
    STFT term framed per window, for every mode and with a weight."""
    rng = np.random.default_rng(1)
    pred = torch.from_numpy(rng.standard_normal((3, 700, 1))
                            .astype(np.float32))
    tgt = torch.from_numpy(rng.standard_normal((3, 700, 1))
                           .astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 1.5, (3, 700)).astype(np.float32))
    for kw in (dict(loss_mode="mse"), dict(loss_mode="mae"),
               dict(loss_mode="snr"), dict(alpha=0.4),
               dict(loss_mode="snr", alpha=0.4, weight=w)):
        out = tlosses.mix_loss(pred, tgt, windows=True, **kw)
        assert out.shape == (3,)
        for i in range(3):
            one = dict(kw)
            if "weight" in one:
                one["weight"] = w[i]
            ref = tlosses.mix_loss(pred[i], tgt[i], **one)
            torch.testing.assert_close(out[i], ref, rtol=1e-6, atol=1e-7)


def test_alpha_at_512_row_windows_raises_in_both_packages():
    """n_fft 1024 reflect-pads by 512 samples: a 512-row window is too
    short, and both packages raise the same ValueError (nothing is padded
    silently)."""
    coords, targets = _windows(512)
    kw = dict(alpha=0.5)
    jm = jax_build_model("mlp", JaxConfig(**MLP))
    tm = build_model("mlp", SirenSnakeTanhConfig(**MLP))
    js = _population(jm, jloop.TrainConfig(**kw), 2, seed=0)
    with pytest.raises(ValueError, match="too short for reflect padding"):
        jax.vmap(jloop.make_train_step(jm, jloop.TrainConfig(**kw)),
                 in_axes=(0, None, 0))(js, jnp.asarray(coords),
                                       jnp.asarray(targets))
    t = tloop.train_state_from_jax(jax.tree.map(np.asarray, js))
    with pytest.raises(ValueError, match="too short for reflect padding"):
        tloop.make_train_step(tm, tloop.TrainConfig(**kw))(
            t, torch.from_numpy(coords), torch.from_numpy(targets))


@pytest.mark.parametrize("ranks", [1, 2])
def test_multi_inr_fit_takes_every_loss(ranks):
    """``multi_inr_fit`` with snr and the STFT term at 0.02 s windows
    (882 rows), on one rank and window-sharded on two: every window's
    history finite, and the two ranks' histories the one rank's (a
    window's loss needs no collective)."""
    fs = 44_100
    sig = (0.5 * np.sin(2 * np.pi * 440 * np.arange(4000) / fs)
           ).astype(np.float32)
    tm = build_model("mlp", SirenSnakeTanhConfig(**MLP))
    tc = tloop.TrainConfig(total_steps=2, scan_chunk=2, loss_mode="snr",
                           alpha=0.3)
    cfg = MultiINRConfig(chunk_seconds=0.02, overlap_fraction=0.1)
    one = multi_inr_fit(tm, sig, fs, cfg, tc, device="cpu")
    assert one.loss_history.shape == (2, one.num_chunks)
    assert np.isfinite(one.loss_history).all()
    if ranks == 1:
        return
    res = run_thread_ranks(ranks, lambda m: multi_inr_fit(
        tm, sig, fs, cfg, tc, mesh=m), device="cpu",
        timeout_s=RANK_TIMEOUT_S)
    np.testing.assert_allclose(res[0].loss_history, one.loss_history,
                               rtol=LOSS_RTOL, atol=LOSS_ATOL_DB)


def test_torchrun_cli_fit_with_snr_and_alpha(tmp_path):
    """``torchrun --nproc-per-node 2 -m inraudio_tpu_torch fit --loss-mode
    snr --alpha 0.3`` on two CPU ranks: the fit runs (it raised before the
    whole-signal losses took a mesh), rank 0 writes the outputs."""
    fs = 4000
    t = np.arange(int(0.2 * fs)) / fs
    wav = str(tmp_path / "in.wav")
    write_wav(wav, fs, (0.5 * np.sin(2 * np.pi * 30 * t)).astype(np.float32))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": repo, "OMP_NUM_THREADS": "1"}
    env.pop("WORLD_SIZE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "inraudio_tpu_torch", "fit",
         "--device", "cpu", "--arch", "mlp", "--fused", "--hidden", "16",
         "--omega", "300", "--filename", wav, "--duration", "0.2",
         "--total-steps", "3", "--loss-mode", "snr", "--alpha", "0.3",
         "--no-plots", "--experiment-path", str(tmp_path / "res"),
         "--tag", "ws"], cwd=repo, env=env, capture_output=True, text=True,
        timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "backend gloo" in proc.stderr
    with open(tmp_path / "res" / "ws" / "parameters.json") as f:
        rec = json.load(f)
    assert rec["total_steps"] == 3 and np.isfinite(rec["best_loss"])
