"""The port's sharded fits held against the JAX package on the CPU: kernel
E's plain version (``grad_plain``) against ``fused_mse_grad_call`` and F's
(``adam_epilogue_plain`` behind ``fused_adam_call``) against the JAX
``fused_adam_call``, both Pallas kernels in interpret mode; the row-sharded
step on four ranks against ``make_sharded_fused_mse_train_step`` under
``jax.shard_map`` on four of conftest's eight virtual devices; ``fit``
on a mesh against the JAX ``fit`` on the same number of devices (the fused
mlp, and the KAN's autograd step); the window-sharded multi-INR fit on two
ranks against one; the row layout helpers; and ``torchrun`` driving the
``fit`` CLI on two CPU ranks.

The port's ranks are threads of this process, each with its own gloo group
(``run_thread_ranks`` of tests/test_torch_cuda.py).  Inputs come from numpy
with a seed; the JAX package draws the initial states and they cross as
numpy arrays.

Tolerances: the two packages sum their f32 products in different orders
(XLA's dot, torch.matmul, and the all-reduce against the psum), so losses
agree to LOSS_RTOL and gradients to GRAD_RTOL of their largest element, in
the forward's f32 tier (``INRAUDIO_GRAD_PRECISION=inherit``); with an RFF
layer 0 the MSE cotangent carries the 2F-deep layer-0 sums' order times
omega0 through the sine, so E's RFF gradients get GRAD_RTOL_RFF (measured:
2.2e-5 of the largest at F = 8, omega0 = 300).  F is the same elementwise
arithmetic; XLA may contract a product and a sum into one fused
multiply-add, and the global norm sums in another order, so F's outputs
agree to ADAM_RTOL of each leaf's largest element (where 0.9 mu and 0.1 g
nearly cancel, the moment carries its terms' rounding).  Parameters a few
steps on: PARAM_ATOL / PARAM_RTOL (tests/test_torch_fit.py's bound).
Within the port, ranks hold bit-equal states, and a fused window's
arithmetic does not depend on which windows share its launch, so the
window-sharded fit repeats one rank's histories bit for bit; the autograd
step's batched products may round differently with the batch size
(LOSS_RTOL)."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from inraudio_tpu.models import KANConfig as JaxKANConfig
from inraudio_tpu.models import SirenSnakeTanhConfig as JaxConfig
from inraudio_tpu.models import build_model as jax_build_model
from inraudio_tpu.ops import pallas_siren as jps
from inraudio_tpu.ops import pallas_siren_step as jstep
from inraudio_tpu.parallel import mesh as jmesh
from inraudio_tpu.train import loop as jloop
from inraudio_tpu_torch.data import write_wav
from inraudio_tpu_torch.models import (KANConfig, SirenSnakeTanhConfig,
                                       build_model)
from inraudio_tpu_torch.ops import siren_fused as sf
from inraudio_tpu_torch.ops import siren_step as ss
from inraudio_tpu_torch.ops import siren_train as st
from inraudio_tpu_torch.parallel import (Mesh, make_mesh, pad_to_multiple,
                                         shard_rows)
from inraudio_tpu_torch.train import loop as tloop
from inraudio_tpu_torch.train.multi_inr import MultiINRConfig, multi_inr_fit
from inraudio_tpu_torch.tree import tree_leaves, tree_map
from test_torch_cuda import run_thread_ranks

torch.set_num_threads(1)

N = 600  # rows of the clip
MLP = dict(hidden_features=32, first_omega_0=300.0, num_sine=1, num_snake=1)
KAN = dict(layers_hidden=(1, 8, 8, 1))
LOSS_RTOL = 1e-5
GRAD_RTOL = 2e-5
GRAD_RTOL_RFF = 1e-4
ADAM_RTOL = 1e-6
PARAM_ATOL, PARAM_RTOL = 2e-5, 1e-4
# a rank that fails leaves the others in a collective until gloo's timeout
RANK_TIMEOUT_S = 60.0


@pytest.fixture
def inherit_grad_tier(monkeypatch):
    """The backward products in the forward's f32 tier.  The JAX kernels
    read the env var while tracing, so drop their caches."""
    monkeypatch.setenv("INRAUDIO_GRAD_PRECISION", "inherit")
    jax.clear_caches()
    yield
    jax.clear_caches()


def _problem(n=N):
    x = np.linspace(-1, 1, n, dtype=np.float32).reshape(-1, 1)
    return x, (0.6 * np.sin(2 * np.pi * 3 * x)).astype(np.float32)


def _mlps(f=0, seed=9):
    """(JAX model, port model, JAX cfg, port cfg, B or None) of the fused
    mlp, raw (f = 0) or with an RFF layer 0 of f frequencies."""
    kw, b = dict(MLP), None
    if f:
        kw["in_features"] = 2 * f
        b = (3.0 * np.random.default_rng(seed).standard_normal((f, 1))
             ).astype(np.float32)
    jcfg, tcfg = JaxConfig(**kw), SirenSnakeTanhConfig(**kw)
    jm = jax_build_model("mlp", jcfg, fused=True, interpret=True,
                         approx_sin=True,
                         rff_b=None if b is None else jnp.asarray(b))
    tm = build_model("mlp", tcfg, fused=True, approx_sin=True,
                     rff_b=None if b is None else torch.from_numpy(b))
    return jm, tm, jcfg, tcfg, b


def _states(jm, tc_kw, seed=3):
    js = jloop.init_train_state(jm, jax.random.PRNGKey(seed),
                                jloop.TrainConfig(**tc_kw))
    return js, tloop.train_state_from_jax(jax.tree.map(np.asarray, js))


def _assert_trees_close(jtree, ttree, atol, rtol):
    for a, b in zip(jax.tree.leaves(jtree), tree_leaves(ttree)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a, np.float32),
                                   atol=atol, rtol=rtol)


def _assert_ranks_equal(results):
    for r in results[1:]:
        for a, b in zip(tree_leaves(results[0]), tree_leaves(r)):
            assert torch.equal(a, b)


def _ranks(n, fn):
    """fn(mesh) on n CPU thread ranks -> their results."""
    return run_thread_ranks(n, fn, device="cpu", timeout_s=RANK_TIMEOUT_S)


def _fake_mesh(rank, size):
    return Mesh(None, rank, size, torch.device("cpu"))


# ---------------------------------------------------------------------------
# Row layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,multiple", [(10, 4), (12, 4), (1, 3), (669, 2)])
def test_pad_to_multiple_matches_jax(n, multiple):
    x = np.random.default_rng(n).standard_normal((n, 3)).astype(np.float32)
    a, na = pad_to_multiple(x, multiple, pad_value=-1.0)
    b, nb = jmesh.pad_to_multiple(x, multiple, pad_value=-1.0)
    assert na == nb == n
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,block,size", [(600, 256, 4), (308207, 32, 2),
                                          (5, 1, 4), (1000, 64, 3)])
def test_shard_rows_match_the_jax_fit(n, block, size):
    """Each rank's rows as the JAX fit lays them out: padded to block *
    n_dev (pad_step_inputs), equal shards, and the step's local valid
    count clip(n_valid - idx * shard_rows, 0, shard_rows)."""
    cp, _, n_valid = jstep.pad_step_inputs(np.zeros((n, 1), np.float32),
                                           np.zeros((n, 1), np.float32),
                                           block * size)
    rows = cp.shape[0] // size
    for rank in range(size):
        sh = shard_rows(_fake_mesh(rank, size), n, block)
        assert sh == (rank * rows, rows,
                      int(np.clip(n_valid - rank * rows, 0, rows)))


# ---------------------------------------------------------------------------
# Kernels E and F: plain versions against the JAX kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shard", ["middle", "tail", "empty"])
@pytest.mark.parametrize("f", [0, 8], ids=["raw", "rff"])
def test_grad_plain_matches_jax_grad_kernel(inherit_grad_tier, f, shard):
    """E's plain version on one of four shards (the JAX fit's layout: 600
    rows padded to 4 x 256) against ``fused_mse_grad_call``: a full shard,
    the shard holding the clip's end, and a shard past it."""
    jm, tm, jcfg, tcfg, b = _mlps(f)
    js, ts = _states(jm, {})
    x, y = _problem()
    jtc = jloop.TrainConfig()
    block = jloop.fused_step_plan(jm, jtc, -(-N // 4))
    cp, tp, n_valid = jstep.pad_step_inputs(x, y, block * 4)
    idx = {"middle": 1, "tail": 2, "empty": 3}[shard]
    sh = shard_rows(_fake_mesh(idx, 4), N, block)
    assert sh.rows == cp.shape[0] // 4 and (sh.valid > 0) == (shard != "empty")
    assert (0 < sh.valid < sh.rows) == (shard == "tail")
    sl = slice(sh.start, sh.start + sh.rows)
    gscal = np.zeros((1, 128), np.float32)
    gscal[0, 0] = sh.valid
    jflat = jstep.flat_state_from_train_state(js, jcfg, rff=f > 0).params
    jloss, jgrads = jstep.fused_mse_grad_call(
        list(jflat), jnp.asarray(cp[sl]), jnp.asarray(tp[sl]),
        jnp.asarray(gscal), jcfg, block, n_valid, 1, interpret=True,
        approx_sin=True, bt=None if b is None else jps._prep_rff_bt(
            jnp.asarray(b)))
    jtree = jstep.unflatten_params(jgrads, jcfg)

    flat = st.flatten_params(
        {"layers": [{k: v[None] for k, v in p.items()}
                    for p in ts.params["layers"]]}, tcfg)
    plan = sf.stack_plan(tcfg, approx_sin=True, rff=f > 0)
    buf = ss.fused_mse_grad_call(
        flat, torch.from_numpy(np.ascontiguousarray(cp[sl, :1])),
        torch.from_numpy(np.ascontiguousarray(tp[sl, 0][None])),
        torch.tensor([sh.valid], dtype=torch.int32), N, tcfg, plan,
        st.grad_dot_mode(), None if b is None else sf._prep_rff_bt(
            torch.from_numpy(b)))
    P = flat.shape[1]
    assert buf.shape == (P + 4,) and not buf[P + 1:].any()
    if shard == "empty":
        assert not buf.any() and float(jloss) == 0.0
        assert not any(np.asarray(g).any() for g in jgrads)
        return
    np.testing.assert_allclose(float(buf[P]), float(jloss), rtol=LOSS_RTOL)
    ttree = st.unflatten_params(buf[:P][None], tcfg)
    rtol = GRAD_RTOL_RFF if f else GRAD_RTOL
    for a, g in zip(jax.tree.leaves(jtree), tree_leaves(ttree)):
        a = np.asarray(a, np.float32)
        np.testing.assert_allclose(g[0].numpy(), a, rtol=0,
                                   atol=rtol * float(np.abs(a).max()))


@pytest.mark.parametrize("clip", [0.0, 1.0])
@pytest.mark.parametrize("track_best", [True, False])
def test_adam_plain_in_f_role_matches_jax_adam_kernel(clip, track_best):
    """``fused_adam_call`` (F's plain version on CPU tensors) against the
    JAX ``fused_adam_call`` on one set of all-reduced grads, with the loss
    below and above best_loss."""
    jm, tm, jcfg, tcfg, _ = _mlps()
    rng = np.random.default_rng(4)
    trees = [jax.tree.map(
        lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32),
        jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1))))
        for scale in (0.3, 1e-3, 1e-3, 0.3, 1e-2)]  # p, mu, nu, best, g
    trees[2] = jax.tree.map(np.square, trees[2])
    to_port = lambda t: st.flatten_params(  # noqa: E731
        {"layers": [{k: torch.from_numpy(v)[None] for k, v in p.items()}
                    for p in t["layers"]]}, tcfg)
    P = to_port(trees[0]).shape[1]
    lr, c1, c2, best_loss = 1e-3, 1.0 - 0.9 ** 3, 1.0 - 0.999 ** 3, 0.25
    for loss in (0.2, 0.3):
        jflat = [jps._flatten_params(jax.tree.map(jnp.asarray, t), jcfg)
                 for t in trees]
        scal = np.zeros((1, 128), np.float32)
        scal[0, :5] = (lr, c1, c2, best_loss, loss)
        out = jstep.fused_adam_call(
            jflat[0], jflat[1], jflat[2], jflat[4], jnp.asarray(scal), clip,
            flat_best=jflat[3] if track_best else None, interpret=True)
        p, mu, nu, best, g = (to_port(t) for t in trees)
        buf = torch.zeros(P + 4)
        buf[:P], buf[P] = g[0], loss
        one = lambda v: torch.tensor([v], dtype=torch.float32)  # noqa: E731
        got = ss.fused_adam_call(p, mu, nu, best if track_best else None,
                                 buf, one(lr), one(c1), one(c2),
                                 one(best_loss), clip)
        assert float(got) == np.float32(loss)
        groups = [p, mu, nu] + ([best] if track_best else [])
        for jg, tg in zip(out, groups):
            for a, b in zip(
                    jax.tree.leaves(jstep.unflatten_params(list(jg), jcfg)),
                    tree_leaves(st.unflatten_params(tg, tcfg))):
                a = np.asarray(a, np.float32)
                np.testing.assert_allclose(
                    b[0].numpy(), a, rtol=0,
                    atol=ADAM_RTOL * float(np.abs(a).max()))
        if not track_best:
            assert torch.equal(best, to_port(trees[3]))


# ---------------------------------------------------------------------------
# The row-sharded step and fit
# ---------------------------------------------------------------------------

def test_sharded_step_matches_jax_shard_map(inherit_grad_tier):
    """Three steps of the port's sharded step on four thread ranks (E's
    plain version, the gloo all-reduce, F's plain version) against
    ``make_sharded_fused_mse_train_step`` under ``jax.shard_map`` on four
    devices, on the JAX fit's row layout."""
    jm, tm, jcfg, tcfg, _ = _mlps()
    kw = dict(grad_clip_norm=1.0, plateau_patience=1)
    js, ts = _states(jm, kw)
    x, y = _problem()
    jtc, ttc = jloop.TrainConfig(**kw), tloop.TrainConfig(**kw)
    block = jloop.fused_step_plan(jm, jtc, -(-N // 4))
    cp, tp, n_valid = jstep.pad_step_inputs(x, y, block * 4)
    mesh = jmesh.make_mesh(jax.devices()[:4])
    sstep = jstep.make_sharded_fused_mse_train_step(
        jcfg, jtc, n_valid, block, cp.shape[0] // 4, approx_sin=True,
        interpret=True)
    sm = jax.jit(jax.shard_map(sstep, mesh=mesh,
                               in_specs=(JP(), JP("data"), JP("data")),
                               out_specs=(JP(), (JP(), JP())),
                               check_vma=False))
    carry = jstep.flat_state_from_train_state(js, jcfg)
    cd = jax.device_put(jnp.asarray(cp), jmesh.coord_sharding(mesh))
    td = jax.device_put(jnp.asarray(tp), jmesh.coord_sharding(mesh))
    jlosses = []
    for _ in range(3):
        carry, (loss, _) = sm(carry, cd, td)
        jlosses.append(float(loss))
    jfinal = jstep.train_state_from_flat(carry, jcfg)

    def rank(m):
        sh = shard_rows(m, N, block)
        cs = torch.from_numpy(np.ascontiguousarray(cp[sh.start:sh.start
                                                      + sh.rows, :1]))
        tgt = torch.from_numpy(np.ascontiguousarray(
            tp[sh.start:sh.start + sh.rows, 0][None]))
        limit = torch.tensor([sh.valid], dtype=torch.int32)
        step = ss.make_sharded_fused_mse_train_step(tcfg, ttc, N, m, limit,
                                                    approx_sin=True)
        fs = ss.flat_state_from_train_state(tree_map(lambda t: t[None], ts),
                                            tcfg)
        losses = []
        for _ in range(3):
            fs, (loss, _) = step(fs, cs, tgt)
            losses.append(float(loss[0]))
        return fs, losses

    results = _ranks(4, rank)
    _assert_ranks_equal([r[0] for r in results])
    np.testing.assert_allclose(results[0][1], jlosses, rtol=LOSS_RTOL)
    final = ss.train_state_from_flat(results[0][0], tcfg)
    _assert_trees_close(jfinal.params, tree_map(lambda t: t[0], final.params),
                        PARAM_ATOL, PARAM_RTOL)
    assert int(final.best_iter[0]) == int(jfinal.best_iter)
    np.testing.assert_allclose(final.opt.lr[0].item(),
                               float(jfinal.opt.lr), rtol=1e-6)


def test_sharded_fit_matches_jax_and_one_rank(inherit_grad_tier):
    """``fit`` of the fused mlp on four ranks (E + all-reduce + F) against
    the JAX ``fit`` on a four-device mesh (its sharded fused branch), and
    its first step against the port's one-rank fit (kernel D's route)."""
    jm, tm, jcfg, tcfg, _ = _mlps()
    kw = dict(total_steps=8, scan_chunk=4, grad_clip_norm=1.0)
    js, ts = _states(jm, kw)
    x, y = _problem()
    jres = jloop.fit(jm, x, y, jloop.TrainConfig(**kw), state=js,
                     mesh=jmesh.make_mesh(jax.devices()[:4]))
    tc = tloop.TrainConfig(**kw)
    res = _ranks(4, lambda m: tloop.fit(tm, x, y, tc, state=ts, mesh=m))
    one = tloop.fit(tm, x, y, tc, state=ts, device="cpu")
    _assert_ranks_equal([r.state for r in res])
    for r in res[1:]:
        np.testing.assert_array_equal(r.loss_history, res[0].loss_history)
        assert r.train_time_s == res[0].train_time_s
    np.testing.assert_allclose(res[0].loss_history, jres.loss_history,
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(res[0].lr_history, jres.lr_history, rtol=1e-6)
    assert res[0].best_iter == jres.best_iter
    _assert_trees_close(jres.state.params, res[0].state.params, PARAM_ATOL,
                        PARAM_RTOL)
    np.testing.assert_allclose(res[0].loss_history[0], one.loss_history[0],
                               rtol=LOSS_RTOL)
    _assert_trees_close(tree_map(lambda t: t.numpy(), one.state.params),
                        res[0].state.params, PARAM_ATOL, PARAM_RTOL)


def test_sharded_fit_routes(monkeypatch):
    """On more than one rank a fused mlp goes through E and F (never D's
    step) and an unfused one through the sharded autograd step; a mesh of
    one keeps the single-device routes and results bit for bit."""
    _, tm, _, tcfg, _ = _mlps()
    x, y = _problem(300)
    tc = tloop.TrainConfig(total_steps=3, scan_chunk=3)
    calls = []
    for name in ("grad_plain", "step_plain"):
        fn = getattr(ss, name)
        monkeypatch.setattr(ss, name, lambda *a, _f=fn, _n=name: (
            calls.append(_n), _f(*a))[1])
    _ranks(2, lambda m: tloop.fit(tm, x, y, tc, mesh=m))
    assert calls == ["grad_plain"] * 6
    calls.clear()
    a = tloop.fit(tm, x, y, tc, device="cpu")
    b = tloop.fit(tm, x, y, tc, mesh=make_mesh("cpu"))
    assert calls == ["step_plain"] * 6
    np.testing.assert_array_equal(a.loss_history, b.loss_history)
    for p, q in zip(tree_leaves(a.state), tree_leaves(b.state)):
        assert torch.equal(p, q)
    plain = build_model("mlp", tcfg)
    res = _ranks(3, lambda m: tloop.fit(plain, x, y, tc, mesh=m))
    one = tloop.fit(plain, x, y, tc, device="cpu")
    _assert_ranks_equal([r.state for r in res])
    np.testing.assert_allclose(res[0].loss_history, one.loss_history,
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("fused", [False, True], ids=["mlp", "mlp_fused"])
def test_ranks_stay_bit_equal(fused):
    """Five steps on three ranks: every rank's state is the same, bit for
    bit (the all-reduce hands every rank the same sums)."""
    model = build_model("mlp", SirenSnakeTanhConfig(**MLP), fused=fused,
                        approx_sin=fused)
    x, y = _problem(500)
    tc = tloop.TrainConfig(total_steps=5, scan_chunk=2, grad_clip_norm=1.0)
    res = _ranks(3, lambda m: tloop.fit(model, x, y, tc, mesh=m))
    _assert_ranks_equal([r.state for r in res])
    assert all(np.array_equal(r.loss_history, res[0].loss_history)
               for r in res)


def test_sharded_kan_fit_matches_jax():
    """The KAN's autograd fit on two ranks (gradients all-reduced in one
    buffer, the grid refreshed from a strided subsample of the whole clip
    on every rank) against the JAX fit on two devices, from one state."""
    kw = dict(total_steps=6, scan_chunk=3, update_grid_every=3,
              update_grid_batch=100)
    jm = jax_build_model("kan", JaxKANConfig(**KAN))
    tm = build_model("kan", KANConfig(**KAN))
    js, ts = _states(jm, kw)
    x, y = _problem(401)
    jres = jloop.fit(jm, x, y, jloop.TrainConfig(**kw), state=js,
                     mesh=jmesh.make_mesh(jax.devices()[:2]))
    res = _ranks(2, lambda m: tloop.fit(
        tm, x, y, tloop.TrainConfig(**kw), state=ts, mesh=m))
    _assert_ranks_equal([r.state for r in res])
    np.testing.assert_allclose(res[0].loss_history, jres.loss_history,
                               rtol=LOSS_RTOL)
    _assert_trees_close(jres.state.params, res[0].state.params, PARAM_ATOL,
                        PARAM_RTOL)


# ---------------------------------------------------------------------------
# The window-sharded multi-INR fit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False], ids=["fused", "autograd"])
def test_window_sharded_multi_inr_fit(fused):
    """11 windows on two ranks (padded to 12) against one rank: the fused
    step repeats every window's history and state bit for bit; every rank
    gets the whole result."""
    fs = 4000
    t = np.arange(int(0.5 * fs)) / fs
    sig = (0.5 * np.sin(2 * np.pi * 30 * t)
           + 0.2 * np.sin(2 * np.pi * 170 * t)).astype(np.float32)
    mc = MultiINRConfig(chunk_seconds=0.05, overlap_fraction=0.1)
    model = build_model("mlp", SirenSnakeTanhConfig(
        hidden_features=32, first_omega_0=100.0, num_sine=1, num_snake=1),
        fused=fused, approx_sin=fused)
    tc = tloop.TrainConfig(total_steps=6, scan_chunk=4, grad_clip_norm=1.0)
    one = multi_inr_fit(model, sig, fs, mc, tc, seed=0, device="cpu")
    res = _ranks(2, lambda m: multi_inr_fit(
        model, sig, fs, mc, tc, seed=0, mesh=m))
    assert one.num_chunks == 11
    for r in res:
        assert r.loss_history.shape == one.loss_history.shape == (6, 11)
        assert r.states.params["layers"][0]["w"].shape[0] == 11
        np.testing.assert_array_equal(r.chunk_scales, one.chunk_scales)
    _assert_ranks_equal([r.states for r in res])
    if fused:
        np.testing.assert_array_equal(res[0].loss_history, one.loss_history)
        _assert_ranks_equal([one.states, res[0].states])
    else:
        np.testing.assert_allclose(res[0].loss_history, one.loss_history,
                                   rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["fit", "multi_inr_fit", "encode",
                                   "runner"])
def test_device_beside_a_mesh_must_be_its_own(entry, tmp_path):
    """A mesh places the run: a ``device`` given beside it that is not the
    mesh's raises before any work, and the mesh's own device passes."""
    from inraudio_tpu_torch import codec
    from inraudio_tpu_torch.experiments import runner as trunner
    from inraudio_tpu_torch.parallel import resolve_mesh
    mesh = _fake_mesh(0, 1)
    assert resolve_mesh(mesh, None) is mesh
    assert resolve_mesh(mesh, "cpu") is mesh
    _, tm, _, _, _ = _mlps()
    x, y = _problem(300)
    sig = y[:, 0]
    run = {"fit": lambda **kw: tloop.fit(tm, x, y, **kw),
           "multi_inr_fit": lambda **kw: multi_inr_fit(tm, sig, 4000, **kw),
           "encode": lambda **kw: codec.encode(sig, 4000, **kw),
           "runner": lambda **kw: trunner.train_from_signal(
               str(tmp_path), "t", sig, 4000, **kw)}[entry]
    with pytest.raises(ValueError, match="mesh's device"):
        run(device="cuda:1", mesh=mesh)


def test_runner_writes_on_rank_zero_only(tmp_path):
    from inraudio_tpu_torch.experiments import runner as trunner
    fs = 4000
    t = np.arange(int(0.2 * fs)) / fs
    wav = str(tmp_path / "in.wav")
    write_wav(wav, fs, (0.5 * np.sin(2 * np.pi * 30 * t)).astype(np.float32))
    out = _ranks(2, lambda m: trunner.train(
        str(tmp_path / "res"), "sh", wav, 0.2, arch="mlp", hidden=32,
        omega=300.0, total_steps=4, fused=True, mesh=m))
    assert out[0] == str(tmp_path / "res" / "sh" / "saved_ckpt.npz")
    assert out[1] is None
    assert sorted(os.listdir(tmp_path / "res")) == ["sh"]
    assert {"output.wav", "parameters.json", "metrics.jsonl",
            "saved_ckpt.npz"} <= set(os.listdir(tmp_path / "res" / "sh"))


def test_torchrun_cli_fit_on_two_cpu_ranks(tmp_path):
    """``torchrun --nproc-per-node 2 -m inraudio_tpu_torch fit --device
    cpu``: the rows shard over two gloo ranks, rank 0 alone writes the
    outputs and prints the result line."""
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
         "--device", "cpu", "--arch", "mlp", "--fused", "--hidden", "32",
         "--omega", "300", "--filename", wav, "--duration", "0.2",
         "--total-steps", "4", "--experiment-path", str(tmp_path / "res"),
         "--tag", "tr"], cwd=repo, env=env, capture_output=True, text=True,
        timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    assert lines == [{"ckpt": str(tmp_path / "res" / "tr" /
                                  "saved_ckpt.npz")}]
    assert "backend gloo" in proc.stderr
    assert sorted(os.listdir(tmp_path / "res")) == ["tr"]
    with open(tmp_path / "res" / "tr" / "parameters.json") as f:
        rec = json.load(f)
    assert rec["total_steps"] == 4 and np.isfinite(rec["best_loss"])
