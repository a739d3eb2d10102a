"""The runner's RFF mlp slice held against the JAX package on the CPU: the
RFF layer 0 of the stack forward (``_rff_features_in_kernel``), of the
backward (kernel C) and of the whole step (kernel D), each through its
plain version in the port and its Pallas kernel in interpret mode in the
JAX package; the fused RFF model's ``fit``; the runner and the ``fit`` CLI
with ``--num-freq``; and the grad kernels' row-slice plan.  Inputs come
from numpy with a seed; parameters and B cross as numpy arrays.

The two packages round 2 pi B differently on their unfused paths
(``rff_apply`` rounds 2 pi (x @ B^T), the kernels x . (2 pi B^T)), so the
fused RFF model is compared with the JAX package's fused RFF path, never
with its XLA ``rff_apply``."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inraudio_tpu.experiments import runner as jrunner
from inraudio_tpu.models import SirenSnakeTanhConfig as JaxConfig
from inraudio_tpu.models import build_model as jax_build_model
from inraudio_tpu.ops import pallas_siren as jps
from inraudio_tpu.ops.pallas_siren_train import \
    fused_siren_train_apply as jax_train_apply
from inraudio_tpu.parallel.mesh import make_mesh
from inraudio_tpu.train import loop as jloop
from inraudio_tpu_torch.__main__ import main as port_main
from inraudio_tpu_torch.data import write_wav
from inraudio_tpu_torch.models import (SirenSnakeTanhConfig, build_model,
                                       params_from_jax)
from inraudio_tpu_torch.ops import siren_fused as sf
from inraudio_tpu_torch.ops import siren_step as ss
from inraudio_tpu_torch.ops import siren_train as st
from inraudio_tpu_torch.train import checkpoint as tckpt
from inraudio_tpu_torch.train import loop as tloop
from inraudio_tpu_torch.tree import tree_leaves

torch.set_num_threads(1)

TIERS = [kw for _, _, kw in jps._DECODE_TIERS] + [dict(approx_sin=False)]
TIER_IDS = ["bf16-deg7", "mixed-bf16x2-deg7", "deg9", "deg11", "exact"]

# forward, f32-class tiers: both packages evaluate the same f32 expressions;
# the 2F-deep layer-0 product and the hidden products sum in other orders
# (XLA's dot vs torch.matmul), ~1e-7 relative, times omega0 = 30 through
# layer 0's sine
F32_ATOL = 2e-5
# bf16-class tiers: a value within one f32 ulp of a bf16 rounding boundary
# can round the other way under the other summation order (the decode
# tiers' rule, tests/test_torch_ops.py); the max loosely, the bulk tightly
BF16_MAX_ATOL = 1e-3
BF16_BULK_ATOL, BF16_BULK_SHARE = 5e-6, 0.95
# gradients in the forward's f32 tier (INRAUDIO_GRAD_PRECISION=inherit),
# relative to the largest: only summation orders differ
GRAD_RTOL = 2e-5
# a population a few whole steps on, in units of an Adam step (lr).  Adam
# divides each gradient by its own magnitude, so the summation-order noise
# of the 2F-deep layer-0 sums (times omega0 = 300 through its sine) moves
# small-gradient elements' updates; later gradients follow the slightly
# different parameters; an element whose gradient cancels to ~eps can move
# by most of a step (tests/test_torch_cuda.py bounds it at 1 lr in the f32
# tiers), and its moments follow.  Measured on the CPU: h=256, 2 steps,
# 0.2% of the parameters beyond 0.01 lr, the worst 0.87 lr; 3 of 16,384 mu
# elements beyond 1e-3 of the largest, the worst 1.04e-3.  The moments'
# bounds are the card tests' (tests/test_torch_cuda.py).
STEP_MAX_LR, STEP_BULK_LR, STEP_BULK_SHARE = 1.0, 0.01, 0.99
MU_MAX_RTOL, MU_BULK_RTOL, MU_BULK_SHARE = 5e-2, 1e-3, 0.99


def _is_bf16_tier(kw):
    return kw.get("compute_dtype") == "bfloat16" or kw.get("mixed_matmul")


def _jax_kw(kw):
    kw = dict(kw)
    if kw.get("compute_dtype") == "bfloat16":
        kw["compute_dtype"] = jnp.bfloat16
    return kw


def _assert_tier_close(out, ref, kw):
    err = np.abs(np.asarray(out, np.float32) - np.asarray(ref, np.float32))
    if _is_bf16_tier(kw):
        assert err.max() <= BF16_MAX_ATOL, err.max()
        assert np.mean(err <= BF16_BULK_ATOL) >= BF16_BULK_SHARE, \
            np.mean(err <= BF16_BULK_ATOL)
    else:
        assert err.max() <= F32_ATOL, err.max()


@pytest.fixture
def inherit_grad_tier(monkeypatch):
    """The backward products in the forward's f32 tier.  The JAX kernels
    read the env var while tracing, so drop their caches."""
    monkeypatch.setenv("INRAUDIO_GRAD_PRECISION", "inherit")
    jax.clear_caches()
    yield
    jax.clear_caches()


def _rff_setup(f, d, h=64, n=300, seed=0, omega=30.0, k=None, **cfg_kw):
    """(JAX cfg, port cfg, JAX params, port params, B (f, d) numpy, coords
    (n, d) numpy) of an RFF mlp, params drawn by the JAX package."""
    kw = dict(in_features=2 * f, hidden_features=h, first_omega_0=omega,
              num_sine=1, num_snake=1, **cfg_kw)
    jcfg, tcfg = JaxConfig(**kw), SirenSnakeTanhConfig(**kw)
    init = jax_build_model("mlp", jcfg).init
    if k is None:
        jp = init(jax.random.PRNGKey(seed))
    else:
        jp = jax.vmap(init)(jax.random.split(jax.random.PRNGKey(seed), k))
    rng = np.random.default_rng(seed)
    b = (10.0 * rng.standard_normal((f, d))).astype(np.float32)
    coords = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp)), b, \
        coords


def test_prep_rff_bt_matches_jax():
    b = np.random.default_rng(1).normal(0, 10, (37, 3)).astype(np.float32)
    ref = np.asarray(jps._prep_rff_bt(jnp.asarray(b)))[:3]
    np.testing.assert_array_equal(sf._prep_rff_bt(torch.from_numpy(b)).numpy(),
                                  ref)


@pytest.mark.parametrize("kw", TIERS, ids=TIER_IDS)
@pytest.mark.parametrize("f,d", [(64, 1), (128, 1), (64, 2)])
def test_rff_forward_matches_jax_kernel(f, d, kw):
    """tests/test_pallas.py:71-87's shapes, in every decode tier."""
    jcfg, tcfg, jp, tp, b, coords = _rff_setup(f, d)
    ref = jps.fused_siren_apply(jp, jcfg, jnp.asarray(coords), block_rows=128,
                                interpret=True, rff_b=jnp.asarray(b),
                                **_jax_kw(kw))
    out = sf.fused_siren_apply(tp, tcfg, torch.from_numpy(coords),
                               rff_b=torch.from_numpy(b), **kw)
    assert out.shape == (len(coords), 1)
    _assert_tier_close(out.numpy(), ref, kw)


def test_rff_forward_h256_matches_jax_kernel():
    kw = dict(approx_sin=True, sin_poly_degree=11)
    jcfg, tcfg, jp, tp, b, coords = _rff_setup(32, 1, h=256, n=200)
    ref = jps.fused_siren_apply(jp, jcfg, jnp.asarray(coords), block_rows=128,
                                interpret=True, rff_b=jnp.asarray(b), **kw)
    out = sf.fused_siren_apply(tp, tcfg, torch.from_numpy(coords),
                               rff_b=torch.from_numpy(b), **kw)
    _assert_tier_close(out.numpy(), ref, kw)


def test_rff_layer0_is_the_jax_fold():
    """Layer 0's features and pre-activation: the same f32 multiply-adds
    as ``_rff_features_in_kernel``, and the tiered product within the
    summation-order noise of a 2F-deep sum (a few f32 ulps)."""
    b = np.random.default_rng(2).normal(0, 10, (48, 2)).astype(np.float32)
    x = np.random.default_rng(3).uniform(-1, 1, (100, 2)).astype(np.float32)
    bt = jps._prep_rff_bt(jnp.asarray(b))
    jc, js = jps._rff_features_in_kernel(jnp.asarray(x), bt, 2,
                                         jps._fast_sin, jps._fast_cos)
    tc, ts = sf.rff_features_plain(torch.from_numpy(x),
                                   sf._prep_rff_bt(torch.from_numpy(b)), 11)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=0)
    w = np.random.default_rng(4).uniform(-0.02, 0.02, (96, 64)).astype(
        np.float32)
    dims = (((1,), (0,)), ((), ()))
    ref = (jps._kernel_dot(jc, jnp.asarray(w[:48]), dims, jnp.float32,
                           "bf16x3")
           + jps._kernel_dot(js, jnp.asarray(w[48:]), dims, jnp.float32,
                             "bf16x3"))
    out = sf.rff_pre_plain((tc, ts), torch.from_numpy(w), "bf16x3")
    scale = float(np.abs(np.asarray(ref)).max())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-6 * scale)


@pytest.mark.parametrize("h,f", [(32, 16), (256, 16)])
def test_rff_backward_matches_jax_grad(inherit_grad_tier, h, f):
    """C's plain version against jax.grad of the JAX custom-VJP fused apply
    with the encoding folded in (tests/test_pallas_train.py:59-75)."""
    jcfg, tcfg, jp, tp, b, coords = _rff_setup(f, 1, h=h, n=260, seed=5,
                                               omega=300.0)
    cot = np.random.default_rng(6).standard_normal((260, 1)).astype(
        np.float32)

    def loss(p):
        out = jax_train_apply(p, jcfg, jnp.asarray(coords), block_rows=128,
                              interpret=True, approx_sin=True,
                              rff_b=jnp.asarray(b))
        return jnp.sum(out * cot)

    ref = jax.grad(loss)(jp)
    leaves = [v.requires_grad_(True) for v in tree_leaves(tp)]
    out = st.fused_siren_train_apply(tp, tcfg, torch.from_numpy(coords),
                                     approx_sin=True,
                                     rff_b=torch.from_numpy(b))
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), leaves)
    for a, g in zip(jax.tree.leaves(ref), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(a), rtol=0,
                                   atol=GRAD_RTOL * float(np.abs(a).max()))


@pytest.mark.parametrize("h,steps", [(32, 5), (256, 2)])
def test_rff_plain_step_matches_jax_fused_step(inherit_grad_tier, h, steps):
    """D's plain version with the RFF layer 0 against the JAX whole-step
    kernel in interpret mode (tests/test_pallas_step.py:178-183), on a
    2-window population."""
    f, k, n = 16, 2, 256
    kw = dict(in_features=2 * f, hidden_features=h, first_omega_0=300.0,
              num_sine=1, num_snake=1)
    b = (3.0 * np.random.default_rng(7).standard_normal((f, 1))).astype(
        np.float32)
    jm = jax_build_model("mlp", JaxConfig(**kw), fused=True, interpret=True,
                         approx_sin=True, rff_b=jnp.asarray(b))
    tm = build_model("mlp", SirenSnakeTanhConfig(**kw), fused=True,
                     approx_sin=True, rff_b=torch.from_numpy(b))
    jtc = jloop.TrainConfig(grad_clip_norm=1.0)
    coords = np.linspace(-1, 1, n, dtype=np.float32)[:, None]
    targets = (0.7 * np.sin(2 * np.pi * np.array([3.0, 5.0])[:, None]
                            * coords[None, :, 0]))[..., None].astype(
                                np.float32)
    js = jax.vmap(lambda kk: jloop.init_train_state(jm, kk, jtc))(
        jax.random.split(jax.random.PRNGKey(8), k))
    block = jloop.fused_step_plan(jm, jtc, n)
    assert block is not None  # the JAX package's D takes this model
    vstep, to_flat, from_flat, _, pad = jloop.make_vmapped_fused_step(
        jm, jtc, coords, block)
    state = tloop.train_state_from_jax(jax.tree.map(np.asarray, js))
    fs, tp, jloss = to_flat(js), jnp.asarray(pad(targets, k)), []
    for _ in range(steps):
        fs, (loss, _) = vstep(fs, tp)
        jloss.append(np.asarray(loss))
    ttc = tloop.TrainConfig(grad_clip_norm=1.0)
    assert tloop.fused_step_plan(tm, ttc, n) == 8192 // h
    tstep, tto, tfrom, prep = tloop.make_vmapped_fused_step(
        tm, ttc, torch.from_numpy(coords))
    tfs, tt = tto(state), prep(targets)
    for jl in jloss:
        tfs, (loss, _) = tstep(tfs, tt)
        np.testing.assert_allclose(loss.numpy(), jl, rtol=1e-5)
    js, ts = from_flat(fs), tfrom(tfs)
    lr = jtc.learning_rate
    for group in ("params", "best_params"):
        err = np.concatenate([
            np.abs(b.numpy() - np.asarray(a)).ravel() for a, b in zip(
                jax.tree.leaves(getattr(js, group)),
                tree_leaves(getattr(ts, group)))])
        assert err.max() <= STEP_MAX_LR * lr, (group, err.max())
        assert np.mean(err <= STEP_BULK_LR * lr) >= STEP_BULK_SHARE
    for a, b in zip(jax.tree.leaves(js.opt.mu), tree_leaves(ts.opt.mu)):
        a = np.asarray(a)
        err, scale = np.abs(b.numpy() - a), np.abs(a).max()
        assert err.max() <= MU_MAX_RTOL * scale, err.max() / scale
        assert np.mean(err <= MU_BULK_RTOL * scale) >= MU_BULK_SHARE
    np.testing.assert_array_equal(np.asarray(js.opt.step), ts.opt.step.numpy())
    np.testing.assert_array_equal(np.asarray(js.opt.lr), ts.opt.lr.numpy())


def test_fused_rff_fit_matches_jax_fit(inherit_grad_tier):
    """``fit`` of the fused RFF mlp (kernel D's plain version, one window)
    against the JAX fit's single-device fused branch from one state."""
    f = 8
    kw = dict(in_features=2 * f, hidden_features=32, first_omega_0=300.0,
              num_sine=1, num_snake=1)
    b = (3.0 * np.random.default_rng(9).standard_normal((f, 1))).astype(
        np.float32)
    jm = jax_build_model("mlp", JaxConfig(**kw), fused=True, interpret=True,
                         approx_sin=True, rff_b=jnp.asarray(b))
    tm = build_model("mlp", SirenSnakeTanhConfig(**kw), fused=True,
                     approx_sin=True, rff_b=torch.from_numpy(b))
    assert tm.name == "siren_snake_tanh_fused_rff"
    x = np.linspace(-1, 1, 400, dtype=np.float32).reshape(-1, 1)
    y = (0.6 * np.sin(2 * np.pi * 3 * x)).astype(np.float32)
    cfg = dict(total_steps=10, scan_chunk=5, grad_clip_norm=1.0)
    js = jloop.init_train_state(jm, jax.random.PRNGKey(3),
                                jloop.TrainConfig(**cfg))
    ts = tloop.train_state_from_jax(jax.tree.map(np.asarray, js))
    jres = jloop.fit(jm, x, y, jloop.TrainConfig(**cfg), state=js,
                     mesh=make_mesh(jax.devices()[:1]))
    tres = tloop.fit(tm, x, y, tloop.TrainConfig(**cfg), state=ts,
                     device="cpu")
    np.testing.assert_allclose(tres.loss_history, jres.loss_history,
                               rtol=1e-5)
    assert tres.best_iter == jres.best_iter
    for a, p in zip(jax.tree.leaves(jres.state.params),
                    tree_leaves(tres.state.params)):
        np.testing.assert_allclose(p.numpy(), np.asarray(a), atol=2e-5,
                                   rtol=1e-4)


def test_runner_cli_fit_rff_mlp(tmp_path, capsys):
    """``fit --arch mlp --fused --num-freq 4``: the mlp owns the encoding
    (layer 0's w is (2F, h)), and parameters.json has the JAX schema."""
    fs = 4000
    t = np.arange(int(0.2 * fs)) / fs
    sig = (0.5 * np.sin(2 * np.pi * 30 * t)).astype(np.float32)
    wav = str(tmp_path / "in.wav")
    write_wav(wav, fs, sig)
    before = ss.SIREN_STEP.launches
    assert port_main(["fit", "--device", "cpu", "--arch", "mlp", "--fused",
                      "--num-freq", "4", "--hidden", "32", "--omega", "60",
                      "--total-steps", "6", "--filename", wav,
                      "--duration", "0.2", "--experiment-path",
                      str(tmp_path), "--tag", "port"]) == 0
    assert ss.SIREN_STEP.launches == before  # the CPU runs the plain step
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with np.load(out["ckpt"]) as ck:
        assert ck["leaf_00001"].shape == (8, 32)  # layer 0 w: (2F, h)
    jrunner.train(str(tmp_path), "jax", filename=wav, duration=0.2,
                  arch="mlp", num_freq=4, hidden=32, omega=60.0,
                  total_steps=6, make_plots=False)
    with open(tmp_path / "port" / "parameters.json") as f:
        trec = json.load(f)
    with open(tmp_path / "jax" / "parameters.json") as f:
        jrec = json.load(f)
    assert list(trec) == list(jrec)
    assert trec["num_freq"] == 4 and trec["arch"] == "mlp"
    assert np.isfinite(trec["SNR"])
    assert tckpt.checkpoint_extra(out["ckpt"])["arch"] == "mlp"
    assert os.path.exists(tmp_path / "port" / "output.wav")


# ---------------------------------------------------------------------------
# The grad kernels' row slices
# ---------------------------------------------------------------------------

class _RecordingLibrary:
    """Stands in for csrc/siren_train.cu's library: records each launch's
    window count, row slices and buffer pointers."""

    def __init__(self):
        self.calls = []

    def siren_grad(self, coords, params, partial, loss_part, pre, tgt, cot,
                   offs, ints, omegas, n_layers, k, n, d, h, h_real, P, gmode,
                   inv_n,
                   two_inv_n, bt, n_freq, fdeg, slices, limit, wgt, stream):
        self.calls.append(("grad", k, slices, n_freq, loss_part, bt))
        return 0

    def siren_reduce(self, partial, grads, sq_part, loss_part, loss_out, k,
                     slices, P, stream):
        self.calls.append(("reduce", k, slices, grads))
        return 0


def test_row_slices_bound_a_long_window():
    """A window of more row tiles than MAX_SLICES goes through MAX_SLICES
    slices: the slab count, and with it the grad scratch, stops growing
    with the clip.  Shorter windows keep one tile per slice (the codec's
    8- and 173-tile windows as before)."""
    assert [st.row_slices(t) for t in (8, 173, 264, 265, 9632)] == \
        [8, 173, 264, 264, 264]
    f, h = 256, 256
    cfg = SirenSnakeTanhConfig(in_features=2 * f, hidden_features=h)
    plan = sf.stack_plan(cfg, approx_sin=True, rff=True)
    layout = st.flat_layout(cfg)
    per_slice = 4 * (layout.size + len(plan.kinds) * st.TILE_FLOATS)
    for n in (308_207, 10 * 308_207):
        g = st.GradLaunch(1, n, 1, h, -(-n // st.tile_rows(h)), layout, plan)
        assert g.slices == st.MAX_SLICES
        assert st.window_group(g) == 1
        assert g.slices * per_slice <= st.SCRATCH_BYTES
    # the unsliced scratch of this window: one slab per 32-row tile
    assert 9632 * per_slice > 15 * st.SCRATCH_BYTES


def test_grad_reduce_passes_slices_and_rff(monkeypatch):
    """The FMA route's (highest tier) launches' pointers and counts for a
    sliced RFF window: partial and pre are sized by slices, loss_part is
    (k * slices), and the grad launch gets B's pointer and F."""
    f, k, n = 4, 3, 3000
    cfg = SirenSnakeTanhConfig(in_features=2 * f, hidden_features=32,
                               num_sine=1, num_snake=1)
    plan = sf.stack_plan(cfg, approx_sin=True, rff=True)
    flat = st.flatten_params(build_model("mlp", cfg).init(
        torch.Generator().manual_seed(0), windows=k), cfg)
    coords = torch.linspace(-1, 1, n)[:, None]
    bt = sf._prep_rff_bt(torch.ones(f, 1))
    monkeypatch.setattr(st, "MAX_SLICES", 5)
    g = st.validate_grad_launch(flat, cfg, plan, coords, bt)
    assert (g.tiles, g.slices) == (12, 5)
    per_window = 4 * g.slices * (g.layout.size + len(plan.kinds)
                                 * st.TILE_FLOATS)
    monkeypatch.setattr(st, "SCRATCH_BYTES", 2 * per_window)
    assert st.window_group(g) == 2
    lib = _RecordingLibrary()
    grads, sq_part, loss_part = st.grad_reduce(
        lib, g, coords, flat, 0, targets=torch.zeros(k, n), gmode="highest")
    assert loss_part.shape == (k * 5,)
    expect = []
    for w0, kn in ((0, 2), (2, 1)):
        expect += [("grad", kn, 5, f, loss_part.data_ptr() + 4 * w0 * 5,
                    bt.data_ptr()),
                   ("reduce", kn, 5,
                    grads.data_ptr() + 4 * w0 * g.layout.size)]
    assert lib.calls == expect
    # a raw model's launch gets no B
    raw = SirenSnakeTanhConfig(hidden_features=32, num_sine=1, num_snake=1)
    rflat = st.flatten_params(build_model("mlp", raw).init(
        torch.Generator().manual_seed(0), windows=1), raw)
    rg = st.validate_grad_launch(rflat, raw, sf.stack_plan(raw), coords)
    lib = _RecordingLibrary()
    st.grad_reduce(lib, rg, coords, rflat, 0, targets=torch.zeros(1, n),
                   gmode="highest")
    assert lib.calls[0][3] == 0 and lib.calls[0][5] == 0


def test_rff_gates_and_refusals():
    f = 8
    cfg = SirenSnakeTanhConfig(in_features=2 * f, hidden_features=256,
                               first_omega_0=30.0)
    b = torch.ones(f, 1)
    assert ss.step_supported(cfg, 100, rff_b=b)
    assert not ss.step_supported(cfg, 100)  # 16 raw columns: no
    assert not ss.step_supported(cfg, 100, rff_b=torch.ones(f, 9))
    assert ss.step_block_rows(cfg, 100, rff_b=b) == 32
    model = build_model("mlp", cfg, fused=True, rff_b=b)
    assert model.apply_stacked is None and model.decode_apply_stacked is None
    assert model.fused_step_ctx["rff_b"] is b
    p = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="raw coordinates"):
        sf.fused_siren_apply_stacked(
            {"layers": [{k: v[None] for k, v in q.items()}
                         for q in p["layers"]]}, cfg, torch.zeros(4, 1))
    with pytest.raises(ValueError, match=r"2\*F"):
        sf.fused_siren_apply(p, cfg, torch.zeros(4, 1), rff_b=torch.ones(3, 1))
    with pytest.raises(ValueError, match="pass rff_b"):
        sf.fused_siren_apply(p, cfg, torch.zeros(4, 16))
    with pytest.raises(ValueError, match="rff plan"):
        sf.stack_forward_plain(p, sf.stack_plan(cfg), torch.zeros(4, 1),
                               sf._prep_rff_bt(b))
    unfused = build_model("mlp", cfg, rff_b=b)
    assert unfused.name == "siren_snake_tanh_rff"
    x = torch.linspace(-1, 1, 50)[:, None]
    # the unfused RFF model is rff_apply + the exact apply; the fused one
    # agrees with it to the exact tier's f32 noise
    np.testing.assert_allclose(
        model.decode_apply(p, x, 500.0).numpy(), unfused.apply(p, x).numpy(),
        atol=1e-4)
