"""The per-row loss weight held against the JAX package on the CPU: kernel
D's plain version (``step_plain``) with a weight against the JAX
``make_fused_mse_train_step`` (``_step_kernel`` with ``has_weight``), kernel
E's (``grad_plain``) against ``fused_mse_grad_call`` (``_grad_kernel`` with
``has_weight``), both Pallas kernels in interpret mode; ``fit(weight=)`` on
one rank (D, and the autograd step) and on two thread ranks (E + F, and the
sharded autograd step) against the JAX ``fit(weight=)`` on as many devices;
and the rules the weight brings: an all-ones weight gives the unweighted
bits, and the losses that need the whole signal take the weight on a mesh
as on one rank.

The weight is the mdct target's kind: the hearing-threshold mask (values in
[0.8, 1.0]) with a few rows at 0.  Tolerances are those of
tests/test_torch_train.py (states a few steps on, in the forward's f32
tier) and tests/test_torch_shard.py (E's loss and gradients, fits on a
mesh): the weight adds one product per row, rounded the same way in both
packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from inraudio_tpu.models import SirenSnakeTanhConfig as JaxConfig
from inraudio_tpu.models import build_model as jax_build_model
from inraudio_tpu.ops import pallas_siren_step as jstep
from inraudio_tpu.parallel import mesh as jmesh
from inraudio_tpu.train import loop as jloop
from inraudio_tpu_torch.models import SirenSnakeTanhConfig, build_model
from inraudio_tpu_torch.ops import siren_fused as sf
from inraudio_tpu_torch.ops import siren_step as ss
from inraudio_tpu_torch.ops import siren_train as st
from inraudio_tpu_torch.parallel import Mesh, normalise_weight, shard_rows
from inraudio_tpu_torch.parallel import shard_problem_arrays
from inraudio_tpu_torch.train import loop as tloop
from inraudio_tpu_torch.tree import tree_leaves, tree_map
from test_torch_cuda import run_thread_ranks

torch.set_num_threads(1)

N = 600
MLP = dict(in_features=2, hidden_features=32, first_omega_0=300.0,
           num_sine=1, num_snake=1)
LOSS_RTOL = 1e-5
GRAD_RTOL = 2e-5
P_RTOL, P_ATOL = 3e-5, 3e-6
MU_RTOL, MU_ATOL = 1e-3, 1e-6
PARAM_ATOL, PARAM_RTOL = 2e-5, 1e-4


@pytest.fixture
def inherit_grad_tier(monkeypatch):
    """The backward products in the forward's f32 tier (the JAX kernels
    read the env var while tracing, so drop their caches)."""
    monkeypatch.setenv("INRAUDIO_GRAD_PRECISION", "inherit")
    jax.clear_caches()
    yield
    jax.clear_caches()


def _problem(n=N, seed=0):
    """A (freq, time)-like 2-D grid, a target on it, and the
    hearing-threshold-like weight (0.8..1.0, a few rows 0)."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n)))
    g = np.stack(np.meshgrid(np.linspace(-1, 1, side),
                             np.linspace(-1, 1, side), indexing="ij"),
                 -1).reshape(-1, 2)[:n].astype(np.float32)
    y = (0.6 * np.sin(3 * g[:, :1]) * np.cos(2 * g[:, 1:])
         + 0.05 * rng.standard_normal((n, 1))).astype(np.float32)
    w = rng.uniform(0.8, 1.0, n).astype(np.float32)
    w[::37] = 0.0
    return g, y, w[:, None]


def _models(fused=True):
    jm = jax_build_model("mlp", JaxConfig(**MLP), fused=fused,
                         interpret=True, approx_sin=fused)
    tm = build_model("mlp", SirenSnakeTanhConfig(**MLP), fused=fused,
                     approx_sin=fused)
    return jm, tm


def _states(jm, tc_kw, seed=3):
    js = jloop.init_train_state(jm, jax.random.PRNGKey(seed),
                                jloop.TrainConfig(**tc_kw))
    return js, tloop.train_state_from_jax(jax.tree.map(np.asarray, js))


def _close_trees(jtree, ttree, atol, rtol):
    for a, b in zip(jax.tree.leaves(jtree), tree_leaves(ttree)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a, np.float32),
                                   atol=atol, rtol=rtol)


def test_normalise_weight_is_the_jax_fit_s():
    """Mean 1 over the rows, on the host, as JAX ``fit`` (loop.py:334-337)
    normalises before it pads."""
    _, _, w = _problem()
    ref = w.reshape(-1)
    ref = (ref * (len(ref) / max(float(np.sum(ref)), 1e-12)))[:, None]
    out = normalise_weight(w)
    assert out.dtype == np.float32 and out.shape == (N, 1)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(normalise_weight(w[:, 0]), ref)


def test_weighted_plain_step_matches_jax_step_kernel(inherit_grad_tier):
    """Three steps of D's plain version with a weight against the JAX
    whole-step kernel's weighted branch (interpret mode), one window, from
    one state."""
    jm, tm = _models()
    kw = dict(grad_clip_norm=1.0, plateau_patience=1, plateau_factor=0.5)
    js, ts = _states(jm, kw)
    x, y, w = _problem()
    wn = normalise_weight(w)
    jtc, ttc = jloop.TrainConfig(**kw), tloop.TrainConfig(**kw)
    jcfg = jm.fused_step_ctx["cfg"]
    block = jloop.fused_step_plan(jm, jtc, N, has_weight=True)
    cp, tp, n_valid = jstep.pad_step_inputs(x, y, block)
    wp = np.zeros((cp.shape[0], 1), np.float32)
    wp[:N] = wn
    fstep = jax.jit(jstep.make_fused_mse_train_step(
        jcfg, jtc, n_valid, block, approx_sin=True, interpret=True))
    carry = jstep.flat_state_from_train_state(js, jcfg)
    jl = []
    for i in range(3):
        carry, (loss, lr) = fstep(carry, jnp.asarray(cp), jnp.asarray(tp),
                                  jnp.asarray(wp))
        jl.append((float(loss), float(lr)))
    jfinal = jstep.train_state_from_flat(carry, jcfg)

    tcfg = tm.config
    step = ss.make_fused_mse_train_step(tcfg, ttc, N, approx_sin=True,
                                        step_call=ss.step_plain)
    fs = ss.flat_state_from_train_state(tree_map(lambda t: t[None], ts),
                                        tcfg)
    c, t = torch.from_numpy(x), torch.from_numpy(y[:, 0][None])
    wt = torch.from_numpy(wn[:, 0][None])
    tl = []
    for _ in range(3):
        fs, (loss, lr) = step(fs, c, t, wt)
        tl.append((float(loss[0]), float(lr[0])))
    final = tree_map(lambda v: v[0], ss.train_state_from_flat(fs, tcfg))
    for (a, alr), (b, blr) in zip(jl, tl):
        np.testing.assert_allclose(b, a, rtol=LOSS_RTOL)
        assert alr == blr
    for group in ("params", "best_params"):
        _close_trees(getattr(jfinal, group), getattr(final, group), P_ATOL,
                     P_RTOL)
    _close_trees(jfinal.opt.mu, final.opt.mu, MU_ATOL, MU_RTOL)
    assert int(final.best_iter) == int(jfinal.best_iter)


def test_all_ones_weight_is_the_unweighted_step():
    """l = (err err) w and g = err (w 2/n): a weight of ones multiplies by
    1.0f, so the weighted plain step gives the unweighted one's bits (the
    kernels hold the same order: tests/test_torch_cuda.py on the card)."""
    _, tm = _models()
    x, y, _ = _problem()
    tcfg, tc = tm.config, tloop.TrainConfig(grad_clip_norm=1.0)
    state = tloop.init_train_state(tm, torch.Generator().manual_seed(1), tc,
                                   windows=1)
    step = ss.make_fused_mse_train_step(tcfg, tc, N, approx_sin=True,
                                        step_call=ss.step_plain)
    c, t = torch.from_numpy(x), torch.from_numpy(y[:, 0][None])
    a = b = ss.flat_state_from_train_state(state, tcfg)
    b = type(a)(*(v.clone() for v in a))
    for _ in range(2):
        a, (la, _) = step(a, c, t)
        b, (lb, _) = step(b, c, t, torch.ones_like(t))
    assert torch.equal(la, lb)
    assert all(torch.equal(p, q) for p, q in zip(a, b))


@pytest.mark.parametrize("shard", ["middle", "tail", "empty"])
def test_weighted_grad_plain_matches_jax_grad_kernel(inherit_grad_tier,
                                                     shard):
    """E's plain version with the shard's weight against
    ``fused_mse_grad_call(wgt_p=)`` on one of four shards of the JAX fit's
    layout (the weight normalised over the clip, then padded with 0)."""
    jm, tm = _models()
    js, ts = _states(jm, {})
    x, y, w = _problem()
    wn = normalise_weight(w)
    jtc = jloop.TrainConfig()
    jcfg, tcfg = jm.fused_step_ctx["cfg"], tm.config
    block = jloop.fused_step_plan(jm, jtc, -(-N // 4), has_weight=True)
    cp, tp, n_valid = jstep.pad_step_inputs(x, y, block * 4)
    wp = np.zeros((cp.shape[0], 1), np.float32)
    wp[:N] = wn
    idx = {"middle": 1, "tail": 2, "empty": 3}[shard]
    mesh = Mesh(None, idx, 4, torch.device("cpu"))
    sh = shard_rows(mesh, N, block)
    sl = slice(sh.start, sh.start + sh.rows)
    gscal = np.zeros((1, 128), np.float32)
    gscal[0, 0] = sh.valid
    jflat = jstep.flat_state_from_train_state(js, jcfg).params
    jloss, jgrads = jstep.fused_mse_grad_call(
        list(jflat), jnp.asarray(cp[sl]), jnp.asarray(tp[sl]),
        jnp.asarray(gscal), jcfg, block, n_valid, 2, interpret=True,
        approx_sin=True, wgt_p=jnp.asarray(wp[sl]))
    jtree = jstep.unflatten_params(jgrads, jcfg)

    # the port's shard of the weight: shard_problem_arrays, as fit lays it
    cs, ts_, ws, _ = shard_problem_arrays(mesh, x, y, block, weight=w)
    np.testing.assert_array_equal(ws.numpy(), wp[sl])
    flat = st.flatten_params(tree_map(lambda v: v[None], ts.params), tcfg)
    plan = sf.stack_plan(tcfg, approx_sin=True)
    buf = ss.fused_mse_grad_call(
        flat, cs, ts_.reshape(1, -1), torch.tensor([sh.valid],
                                                   dtype=torch.int32),
        N, tcfg, plan, st.grad_dot_mode(), weight=ws.reshape(1, -1))
    P = flat.shape[1]
    if shard == "empty":
        assert not buf.any() and float(jloss) == 0.0
        return
    np.testing.assert_allclose(float(buf[P]), float(jloss), rtol=LOSS_RTOL)
    for a, g in zip(jax.tree.leaves(jtree),
                    tree_leaves(st.unflatten_params(buf[:P][None], tcfg))):
        a = np.asarray(a, np.float32)
        np.testing.assert_allclose(g[0].numpy(), a, rtol=0,
                                   atol=GRAD_RTOL * float(np.abs(a).max()))


def _jax_fit(jm, x, y, w, kw, js, devices):
    return jloop.fit(jm, x, y, jloop.TrainConfig(**kw), state=js, weight=w,
                     mesh=jmesh.make_mesh(jax.devices()[:devices]))


def _assert_fit_close(jres, tres):
    np.testing.assert_allclose(tres.loss_history, jres.loss_history,
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(tres.lr_history, jres.lr_history, rtol=1e-6)
    assert tres.best_iter == jres.best_iter
    _close_trees(jres.state.params, tres.state.params, PARAM_ATOL, PARAM_RTOL)


@pytest.mark.parametrize("fused,mode", [(True, "mse"), (False, "mse"),
                                        (False, "mae")],
                         ids=["kernel_d", "autograd_mse", "autograd_mae"])
def test_weighted_fit_matches_jax_on_one_rank(inherit_grad_tier, fused, mode,
                                              monkeypatch):
    """``fit(weight=)`` on one rank against the JAX ``fit(weight=)`` on one
    device; a fused mlp's weighted mse fit runs D (its plain version) with
    the weight, never the autograd step."""
    jm, tm = _models(fused)
    kw = dict(total_steps=8, scan_chunk=4, grad_clip_norm=1.0,
              loss_mode=mode)
    js, ts = _states(jm, kw)
    x, y, w = _problem()
    calls = []
    plain = ss.step_plain
    monkeypatch.setattr(ss, "step_plain", lambda *a, **k: (
        calls.append((a[16] if len(a) > 16 else k.get("weight"))
                     is not None), plain(*a, **k))[1])
    jres = _jax_fit(jm, x, y, w, kw, js, 1)
    tres = tloop.fit(tm, x, y, tloop.TrainConfig(**kw), state=ts, weight=w,
                     device="cpu")
    assert calls == ([True] * 8 if fused else [])
    _assert_fit_close(jres, tres)


@pytest.mark.parametrize("fused,mode", [(True, "mse"), (False, "mae")],
                         ids=["kernels_e_f", "autograd_mae"])
def test_weighted_fit_matches_jax_on_two_ranks(inherit_grad_tier, fused,
                                               mode):
    """``fit(weight=)`` on two thread ranks (gloo) against the JAX fit on
    two devices: the weight normalised over the clip, split with the rows
    and 0 on padding; the ranks stay bit-equal."""
    jm, tm = _models(fused)
    kw = dict(total_steps=6, scan_chunk=3, grad_clip_norm=1.0,
              loss_mode=mode)
    js, ts = _states(jm, kw)
    x, y, w = _problem()
    jres = _jax_fit(jm, x, y, w, kw, js, 2)
    tc = tloop.TrainConfig(**kw)
    res = run_thread_ranks(2, lambda m: tloop.fit(tm, x, y, tc, state=ts,
                                                  weight=w, mesh=m),
                           device="cpu", timeout_s=60.0)
    for a, b in zip(tree_leaves(res[0].state), tree_leaves(res[1].state)):
        assert torch.equal(a, b)
    _assert_fit_close(jres, res[0])
    one = tloop.fit(tm, x, y, tc, state=ts, weight=w, device="cpu")
    np.testing.assert_allclose(res[0].loss_history, one.loss_history,
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("kw", [dict(loss_mode="snr"), dict(alpha=0.5)],
                         ids=["snr", "alpha"])
def test_whole_signal_losses_refuse_a_mesh(kw):
    """The losses that need the whole signal no longer refuse a mesh: the
    weighted fit on two thread ranks (each gathers the whole clip's
    prediction for the loss) gives the one-rank fit's first loss, and its
    later losses to the loss zoo's bound for the STFT term (Adam moves
    every parameter by about lr whatever its gradient's rounding)."""
    _, tm = _models(False)
    x, y, w = _problem(1200)  # longer than the STFT term's reflect padding
    tc = tloop.TrainConfig(total_steps=3, scan_chunk=3, **kw)
    res = run_thread_ranks(2, lambda m: tloop.fit(tm, x, y, tc, weight=w,
                                                  mesh=m),
                           device="cpu", timeout_s=60.0)
    one = tloop.fit(tm, x, y, tc, weight=w, device="cpu")
    for a, b in zip(tree_leaves(res[0].state), tree_leaves(res[1].state)):
        assert torch.equal(a, b)
    np.testing.assert_allclose(res[0].loss_history[0], one.loss_history[0],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(res[0].loss_history, one.loss_history,
                               rtol=1e-3 if "alpha" in kw else LOSS_RTOL)


def test_weight_shards_sum_to_the_clip():
    """The shards' weights are the clip's normalised weight, split, with
    0 on the padded rows."""
    x, y, w = _problem(1001)
    wn = normalise_weight(w)
    parts = [shard_problem_arrays(Mesh(None, r, 3, torch.device("cpu")), x,
                                  y, 64, weight=w) for r in range(3)]
    got = np.concatenate([p[2].numpy() for p in parts])
    np.testing.assert_array_equal(got[:1001], wn)
    assert not got[1001:].any()
    assert all(p[2].shape == (p[3].rows, 1) for p in parts)
    _, _, none, _ = shard_problem_arrays(Mesh(None, 0, 3,
                                              torch.device("cpu")), x, y, 64)
    assert none is None


def test_sharded_jax_step_takes_the_weight_as_the_port():
    """The JAX sharded step under shard_map with the weight (its fit's
    wrapper, loop.py:356-362) against the port's sharded step on two
    ranks, one step from one state."""
    jm, tm = _models()
    js, ts = _states(jm, {})
    x, y, w = _problem()
    wn = normalise_weight(w)
    jtc, ttc = jloop.TrainConfig(), tloop.TrainConfig()
    jcfg, tcfg = jm.fused_step_ctx["cfg"], tm.config
    block = jloop.fused_step_plan(jm, jtc, -(-N // 2), has_weight=True)
    cp, tp, n_valid = jstep.pad_step_inputs(x, y, block * 2)
    wp = np.zeros((cp.shape[0], 1), np.float32)
    wp[:N] = wn
    mesh = jmesh.make_mesh(jax.devices()[:2])
    sstep = jstep.make_sharded_fused_mse_train_step(
        jcfg, jtc, n_valid, block, cp.shape[0] // 2, approx_sin=True,
        interpret=True)
    sm = jax.jit(jax.shard_map(sstep, mesh=mesh,
                               in_specs=(JP(), JP("data"), JP("data"),
                                         JP("data")),
                               out_specs=(JP(), (JP(), JP())),
                               check_vma=False))
    put = lambda a: jax.device_put(jnp.asarray(a),  # noqa: E731
                                   jmesh.coord_sharding(mesh))
    carry, (jloss, _) = sm(jstep.flat_state_from_train_state(js, jcfg),
                           put(cp), put(tp), put(wp))

    def rank(m):
        cs, ts_, ws, sh = shard_problem_arrays(m, x, y, block, weight=w)
        step = ss.make_sharded_fused_mse_train_step(
            tcfg, ttc, N, m, torch.tensor([sh.valid], dtype=torch.int32),
            approx_sin=True)
        fs = ss.flat_state_from_train_state(tree_map(lambda t: t[None], ts),
                                            tcfg)
        return step(fs, cs, ts_.reshape(1, -1), ws.reshape(1, -1))

    res = run_thread_ranks(2, rank, device="cpu", timeout_s=60.0)
    np.testing.assert_allclose(float(res[0][1][0][0]), float(jloss),
                               rtol=LOSS_RTOL)
    final = tree_map(lambda v: v[0], ss.train_state_from_flat(res[0][0],
                                                              tcfg))
    _close_trees(jstep.train_state_from_flat(carry, jcfg).params,
                 final.params, PARAM_ATOL, PARAM_RTOL)
