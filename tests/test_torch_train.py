"""The port's training slice held against the JAX package on the CPU: the
plain versions of kernels C (backward) and D (whole step), the autograd
step, the multi-INR fit and encode.  The JAX kernels run in interpret mode,
as tests/test_pallas_step.py runs them; both packages start from the same
state, carried across as numpy arrays."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inraudio_tpu import codec as jcodec
from inraudio_tpu.models import SirenSnakeTanhConfig as JaxConfig
from inraudio_tpu.models import build_model as jax_build_model
from inraudio_tpu.ops.pallas_siren_train import \
    fused_siren_train_apply as jax_train_apply
from inraudio_tpu.train import loop as jloop
from inraudio_tpu.train import multi_inr as jmulti
from inraudio_tpu_torch import codec as tcodec
from inraudio_tpu_torch.__main__ import main as port_main
from inraudio_tpu_torch.data import read_wav, write_wav
from inraudio_tpu_torch.models import (SirenSnakeTanhConfig, build_model,
                                       params_from_jax)
from inraudio_tpu_torch.ops import siren_fused as sf
from inraudio_tpu_torch.ops import siren_step as ss
from inraudio_tpu_torch.ops import siren_train as st
from inraudio_tpu_torch.train import loop as tloop
from inraudio_tpu_torch.train import multi_inr as tmulti
from inraudio_tpu_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)

# h=32, one sine and one snake layer, as the training tests of the JAX
# package use small stacks
CFG = dict(hidden_features=32, first_omega_0=300.0, num_sine=1, num_snake=1)
N, K = 300, 2

# tests/test_pallas_step.py:70-82: the fused step against f32 autodiff
P_RTOL, P_ATOL = 3e-5, 3e-6
MU_RTOL, MU_ATOL = 1e-3, 1e-6


@pytest.fixture
def inherit_grad_tier(monkeypatch):
    """Exactness A/Bs: the backward products in the forward's f32 tier.
    The JAX kernels read the env var while tracing, so drop their caches."""
    monkeypatch.setenv("INRAUDIO_GRAD_PRECISION", "inherit")
    jax.clear_caches()
    yield
    jax.clear_caches()


def _problem(n=N, k=K):
    coords = np.linspace(-1, 1, n, dtype=np.float32).reshape(-1, 1)
    t = np.sin(2 * np.pi * np.array([3.0, 5.0, 7.0])[:k, None]
               * coords[None, :, 0])
    return coords, (0.8 * t).astype(np.float32)[..., None]


def _models(approx_sin=False, **cfg_kw):
    jm = jax_build_model("mlp", JaxConfig(**{**CFG, **cfg_kw}), fused=True,
                         interpret=True, approx_sin=approx_sin)
    tm = build_model("mlp", SirenSnakeTanhConfig(**{**CFG, **cfg_kw}),
                     fused=True, approx_sin=approx_sin)
    return jm, tm


def _jax_population(jm, tc, k=K, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), k)
    return jax.vmap(lambda kk: jloop.init_train_state(jm, kk, tc))(keys)


def _well_conditioned(first):
    """Per-leaf masks of the elements whose Adam updates are stable, from
    the reference state after its FIRST step (mu = 0.1 g there).

    Adam's first step divides each gradient by its own magnitude plus
    eps = 1e-8.  Where the gradient cancels to within ~10 eps of zero, a
    summation-order difference of ~1e-10 between the packages moves that
    update by up to ~lr / 4, and the offset stays in the parameter
    (measured: one element of 4,300, |g| = 1.2e-8).  Those elements are
    held to the gradient check through mu instead; there may be at most
    0.5% of them."""
    masks = [np.abs(np.asarray(m, np.float64)) / 0.1 >= 1e-7
             for m in jax.tree.leaves(first.opt.mu)]
    total = sum(m.size for m in masks)
    assert sum(int((~m).sum()) for m in masks) <= 5e-3 * total
    return masks


def _assert_state_close(js, ts, first=None, p_rtol=P_RTOL, p_atol=P_ATOL):
    masks = (_well_conditioned(first) if first is not None else
             [np.ones(np.shape(a), bool) for a in jax.tree.leaves(js.params)])
    for group in ("params", "best_params"):
        for a, b, m in zip(jax.tree.leaves(getattr(js, group)),
                           tree_leaves(getattr(ts, group)), masks):
            np.testing.assert_allclose(np.asarray(a)[m], b.numpy()[m],
                                       rtol=p_rtol, atol=p_atol)
    for a, b in zip(jax.tree.leaves(js.opt.mu), tree_leaves(ts.opt.mu)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=MU_RTOL,
                                   atol=MU_ATOL)
    np.testing.assert_array_equal(np.asarray(js.opt.step),
                                  ts.opt.step.numpy())
    np.testing.assert_array_equal(np.asarray(js.best_iter),
                                  ts.best_iter.numpy())
    np.testing.assert_array_equal(np.asarray(js.opt.lr), ts.opt.lr.numpy())


def _port_fused_run(tm, tc, jstate, coords, targets, steps):
    """The port's population step (plain D on the CPU) from a JAX state."""
    state = tloop.train_state_from_jax(jax.tree.map(np.asarray, jstate))
    c = torch.from_numpy(coords)
    assert tloop.fused_step_plan(tm, tc, len(coords)) is not None
    vstep, to_flat, from_flat, prep = tloop.make_vmapped_fused_step(tm, tc, c)
    fs, t, hist = to_flat(state), prep(targets), []
    for _ in range(steps):
        fs, (loss, lr) = vstep(fs, t)
        hist.append((loss.numpy().copy(), lr.numpy().copy()))
    return from_flat(fs), hist


def test_plain_step_matches_jax_fused_step(inherit_grad_tier):
    # D's plain version against the JAX whole-step kernel (interpret mode)
    jm, tm = _models(approx_sin=True)
    tc = jloop.TrainConfig(grad_clip_norm=1.0, plateau_patience=1,
                           plateau_factor=0.5)
    coords, targets = _problem()
    js = _jax_population(jm, tc)
    block = jloop.fused_step_plan(jm, tc, N)
    vstep, to_flat, from_flat, _, pad = jloop.make_vmapped_fused_step(
        jm, tc, coords, block)
    fs, tp, jhist = to_flat(js), jnp.asarray(pad(targets, K)), []
    for i in range(3):
        fs, (loss, lr) = vstep(fs, tp)
        jhist.append((np.asarray(loss), np.asarray(lr)))
        first = from_flat(fs) if i == 0 else first
    ts, thist = _port_fused_run(
        tm, tloop.TrainConfig(grad_clip_norm=1.0, plateau_patience=1,
                              plateau_factor=0.5), js, coords, targets, 3)
    for (jl, jlr), (tl, tlr) in zip(jhist, thist):
        np.testing.assert_allclose(tl, jl, rtol=1e-6)
        np.testing.assert_array_equal(tlr, jlr)  # plateau decisions equal
    _assert_state_close(from_flat(fs), ts, first)


def test_plain_step_matches_jax_autodiff_step(inherit_grad_tier):
    # D's plain version against the JAX two-kernel autograd step (fused
    # forward + kernel C in interpret mode), vmapped over the windows
    jm, tm = _models()
    tc = jloop.TrainConfig(grad_clip_norm=1.0, plateau_patience=2)
    coords, targets = _problem()
    js = _jax_population(jm, tc, seed=1)
    step = jax.jit(jax.vmap(jloop.make_train_step(jm, tc),
                            in_axes=(0, None, 0)))
    s, jhist = js, []
    for i in range(5):
        s, (loss, lr) = step(s, jnp.asarray(coords), jnp.asarray(targets))
        jhist.append((np.asarray(loss), np.asarray(lr)))
        first = s if i == 0 else first
    ts, thist = _port_fused_run(
        tm, tloop.TrainConfig(grad_clip_norm=1.0, plateau_patience=2), js,
        coords, targets, 5)
    for (jl, jlr), (tl, tlr) in zip(jhist, thist):
        np.testing.assert_allclose(tl, jl, rtol=1e-6)
        np.testing.assert_array_equal(tlr, jlr)
    _assert_state_close(s, ts, first)


def test_plain_step_default_grad_tier():
    # the default bf16x2 grad tier: x_in and gpre are rounded to bf16, so an
    # operand within an f32 ulp of a rounding boundary can round the other
    # way when the packages sum in another order; bound the max loosely and
    # the bulk tightly (the decode tiers' rule, tests/test_torch_ops.py)
    jax.clear_caches()
    jm, tm = _models(approx_sin=True)
    tc = jloop.TrainConfig(grad_clip_norm=1.0)
    coords, targets = _problem()
    js = _jax_population(jm, tc, seed=2)
    block = jloop.fused_step_plan(jm, tc, N)
    vstep, to_flat, from_flat, _, pad = jloop.make_vmapped_fused_step(
        jm, tc, coords, block)
    fs, tp = to_flat(js), jnp.asarray(pad(targets, K))
    for _ in range(2):
        fs, _ = vstep(fs, tp)
    ts, _ = _port_fused_run(tm, tloop.TrainConfig(grad_clip_norm=1.0), js,
                            coords, targets, 2)
    ref = np.concatenate([np.asarray(a).ravel() for a in
                          jax.tree.leaves(from_flat(fs).params)])
    out = np.concatenate([b.numpy().ravel() for b in tree_leaves(ts.params)])
    err = np.abs(out - ref)
    assert err.max() <= 2e-5, err.max()
    assert np.mean(err <= 1e-6) >= 0.95, np.mean(err <= 1e-6)


def test_plain_backward_matches_jax_grad(inherit_grad_tier):
    # C's plain version against jax.grad of the custom-VJP fused apply
    jcfg = JaxConfig(**CFG)
    params = jax.vmap(jax_build_model("mlp", jcfg).init)(
        jax.random.split(jax.random.PRNGKey(4), K))
    coords, _ = _problem()
    cot = np.random.default_rng(4).standard_normal((K, N, 1)).astype(
        np.float32)

    def f(p):
        out = jax.vmap(lambda q: jax_train_apply(
            q, jcfg, jnp.asarray(coords), block_rows=128, interpret=True,
            approx_sin=True))(p)
        return jnp.sum(out * cot)

    ref = jax.grad(f)(params)
    tp = params_from_jax(jax.tree.map(np.asarray, params))
    leaves = [v.requires_grad_(True) for v in tree_leaves(tp)]
    out = st.fused_siren_train_apply(tp, SirenSnakeTanhConfig(**CFG),
                                     torch.from_numpy(coords),
                                     approx_sin=True)
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), leaves)
    for a, b in zip(jax.tree.leaves(ref), grads):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-5,
                                   atol=2e-5 * float(np.abs(a).max()))


def test_autograd_step_matches_jax(inherit_grad_tier):
    # the port's make_train_step (kernel C's plain version as the backward)
    # against the JAX make_train_step, per window
    jm, tm = _models(approx_sin=True)
    tc = jloop.TrainConfig(grad_clip_norm=1.0, plateau_patience=2)
    coords, targets = _problem()
    js = _jax_population(jm, tc, seed=3)
    jstep = jax.jit(jax.vmap(jloop.make_train_step(jm, tc),
                             in_axes=(0, None, 0)))
    tstep = tloop.make_train_step(tm, tloop.TrainConfig(grad_clip_norm=1.0,
                                                        plateau_patience=2))
    s = js
    t = tloop.train_state_from_jax(jax.tree.map(np.asarray, js))
    for _ in range(3):
        s, (jl, _) = jstep(s, jnp.asarray(coords), jnp.asarray(targets))
        t, (tl, _) = tstep(t, torch.from_numpy(coords),
                           torch.from_numpy(targets))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6)
    _assert_state_close(s, t)


def test_train_state_crosses_both_ways():
    jm, _ = _models()
    tc = jloop.TrainConfig()
    js = jax.tree.map(np.asarray, _jax_population(jm, tc, seed=5))
    ts = tloop.train_state_from_jax(js)
    assert ts.opt.step.dtype == torch.int32 and ts.opt.lr.shape == (K,)
    back = tloop.train_state_to_numpy(ts)
    ja, tb = jax.tree.leaves(js), jax.tree.leaves(
        jloop.TrainState(*back))
    assert len(ja) == len(tb)
    for a, b in zip(ja, tb):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # and through the kernel layout and back
    flat = ss.flat_state_from_train_state(ts, SirenSnakeTanhConfig(**CFG))
    again = ss.train_state_from_flat(flat, SirenSnakeTanhConfig(**CFG))
    for a, b in zip(tree_leaves(ts.params), tree_leaves(again.params)):
        assert torch.equal(a, b)


def test_multi_inr_fit_matches_jax(inherit_grad_tier):
    fs = 4000
    t = np.arange(600) / fs
    sig = (0.7 * np.sin(2 * np.pi * 90 * t)).astype(np.float32)
    mc = jmulti.MultiINRConfig(chunk_seconds=0.06, overlap_fraction=0.25)
    tc = jloop.TrainConfig(total_steps=4, grad_clip_norm=1.0, scan_chunk=3)
    jm, tm = _models(approx_sin=True)
    jres = jmulti.multi_inr_fit(jm, sig, fs, mc, tc,
                                key=jax.random.PRNGKey(7))
    k = jres.num_chunks
    # the JAX init, patched into the port's model (the JAX fit pads its
    # population to a multiple of the 8 test devices and draws one key per
    # padded window)
    keys = jax.random.split(jax.random.PRNGKey(7), k + (-k) % 8)[:k]
    init = params_from_jax(jax.tree.map(
        np.asarray, jax.vmap(jm.init)(keys)))
    tm = dataclasses.replace(
        tm, init=lambda g, device, windows=None: tree_map(torch.clone, init))
    tres = tmulti.multi_inr_fit(
        tm, sig, fs, tmulti.MultiINRConfig(chunk_seconds=0.06,
                                           overlap_fraction=0.25),
        tloop.TrainConfig(total_steps=4, grad_clip_norm=1.0, scan_chunk=3),
        device="cpu")
    assert (tres.chunk_length, tres.hop, tres.num_chunks) == \
        (jres.chunk_length, jres.hop, jres.num_chunks)
    np.testing.assert_array_equal(tres.chunk_scales, jres.chunk_scales)
    np.testing.assert_allclose(tres.loss_history, jres.loss_history,
                               rtol=1e-5)
    first = tmulti.multi_inr_fit(
        tm, sig, fs, tmulti.MultiINRConfig(chunk_seconds=0.06,
                                           overlap_fraction=0.25),
        tloop.TrainConfig(total_steps=1, grad_clip_norm=1.0),
        device="cpu").states
    _assert_state_close(jax.tree.map(lambda x: np.asarray(x)[:k],
                                     jres.states), tres.states, first)
    jrec = jmulti.multi_inr_decode(jm, jres)
    trec = tmulti.multi_inr_decode(tm, tres)
    np.testing.assert_allclose(trec, jrec, atol=1e-5)
    part = tmulti.multi_inr_decode_range(tm, tres, 100, 350)
    np.testing.assert_allclose(part, trec[100:350], atol=1e-7)


def test_port_encode_decodes_in_jax_and_back(tmp_path):
    fs = 4000
    t = np.arange(int(0.2 * fs)) / fs
    sig = (0.6 * np.sin(2 * np.pi * 180.0 * t)
           + 0.2 * np.sin(2 * np.pi * 410.0 * t)).astype(np.float32)
    cfg = tcodec.CodecConfig(chunk_seconds=0.05, hidden_features=32,
                             first_omega_0=200.0, total_steps=30,
                             learning_rate=1e-3, quantize="int8")
    tp = tcodec.encode(sig, fs, cfg, device="cpu")
    meta = tp["meta"]
    assert meta["trained_forward"] == "exact" and meta["side_quantized"]
    path = tcodec.save_inr(str(tmp_path / "port.inra"), tp)
    jp = jcodec.load_inr(path)
    _, ref = jcodec.decode(jp, fused=False)
    _, out = tcodec.decode(tcodec.load_inr(path), "cpu")
    np.testing.assert_allclose(out, ref, atol=3e-5, rtol=0)
    # the port's fit is a real fit: its header SNR and the decode agree
    snr = 10 * np.log10(np.mean(sig ** 2) / np.mean((out - sig) ** 2))
    assert abs(snr - meta["fit_snr_db"]) < 6.0, (snr, meta["fit_snr_db"])
    # and back: the JAX package re-saves what it loaded, the port reads it
    jpath = jcodec.save_inr(str(tmp_path / "jax.npz"), jp)
    _, back = tcodec.decode(tcodec.load_inr(jpath), "cpu")
    np.testing.assert_array_equal(back, out)
    stats = tcodec.compression_stats(tp, path)
    assert stats == pytest.approx(jcodec.compression_stats(jp, path))


def test_fused_encode_with_refit_and_cli(tmp_path, capsys):
    # the fused route end to end on the CPU (plain versions of D, and of C
    # through the refit), through the CLI
    fs = 4000
    t = np.arange(int(0.15 * fs)) / fs
    sig = (0.5 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)
    wav = str(tmp_path / "in.wav")
    write_wav(wav, fs, sig)
    out = str(tmp_path / "enc.inra")
    before = (st.SIREN_BWD.launches, ss.SIREN_STEP.launches)
    assert port_main(["encode", "--input", wav, "--output", out, "--device",
                      "cpu", "--fused", "--chunk-s", "0.05", "--hidden", "32",
                      "--omega", "200", "--learning-rate", "1e-3",
                      "--total-steps", "20", "--quantize", "int8",
                      "--refit-steps", "3"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # the CPU runs the plain versions: no kernel launched
    assert (st.SIREN_BWD.launches, ss.SIREN_STEP.launches) == before
    for key in ("file_bits_per_sample", "snr_db", "encode_s", "audio_s",
                "bits_per_sample", "ratio_vs_pcm16", "peak_host_rss_mb"):
        assert key in rec
    payload = tcodec.load_inr(out)
    assert payload["meta"]["trained_forward"] == "fused_approx"
    _, dec = tcodec.decode(payload, "cpu")
    snr = 10 * np.log10(np.mean(sig ** 2) / np.mean((dec - sig) ** 2))
    assert abs(snr - rec["snr_db"]) < 1e-3 and snr > 5.0
    assert read_wav(wav)[1].shape == sig.shape


def test_refit_matches_jax(inherit_grad_tier):
    # quantization-aware refit: Adam on the float32 leaves around frozen
    # int8 weights, through the fused apply (kernel C's plain version)
    jm, tm = _models(approx_sin=True)
    coords, targets = _problem(n=128, k=3)
    params = jax.vmap(jm.init)(jax.random.split(jax.random.PRNGKey(8), 3))
    ref = jcodec.quantization_aware_refit(jm, params, "int8", targets,
                                          coords, steps=4, lr=1e-3,
                                          max_chunks_per_batch=2)
    out = tcodec.quantization_aware_refit(
        tm, params_from_jax(jax.tree.map(np.asarray, params)), "int8",
        targets, coords, steps=4, lr=1e-3, max_chunks_per_batch=2)
    jl, tl = jax.tree.leaves(ref), tree_leaves(out)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b.numpy())  # frozen codes
        else:
            np.testing.assert_allclose(b.to(torch.float32).numpy(),
                                       a.astype(np.float32), rtol=1e-4,
                                       atol=1e-6)


def test_step_gates_and_width_error(inherit_grad_tier):
    jm, tm = _models()
    tc = tloop.TrainConfig()
    assert tloop.fused_step_plan(tm, tc, 512) == 8192 // 32
    assert ss.step_block_rows(SirenSnakeTanhConfig(hidden_features=128),
                              512) == 64
    assert tloop.fused_step_plan(build_model(
        "mlp", SirenSnakeTanhConfig(**CFG)), tc, 512) is None
    # the other losses run autograd; a window population trains each
    # window on its own mae, as the JAX package's vmapped step does
    for other in (dict(loss_mode="mae"), dict(alpha=0.5)):
        assert tloop.fused_step_plan(tm, tloop.TrainConfig(**other),
                                     512) is None
    mae_kw = dict(loss_mode="mae", grad_clip_norm=1.0)
    coords, targets = _problem()
    js = _jax_population(jm, jloop.TrainConfig(**mae_kw), seed=2)
    jmae = jax.jit(jax.vmap(jloop.make_train_step(
        jm, jloop.TrainConfig(**mae_kw)), in_axes=(0, None, 0)))
    mae = tloop.make_train_step(tm, tloop.TrainConfig(**mae_kw))
    state = tloop.train_state_from_jax(jax.tree.map(np.asarray, js))
    for _ in range(2):
        js, (jl, _) = jmae(js, jnp.asarray(coords), jnp.asarray(targets))
        state, (loss, _) = mae(state, torch.from_numpy(coords),
                               torch.from_numpy(targets))
        assert loss.shape == (K,)
        np.testing.assert_allclose(loss.numpy(), np.asarray(jl), rtol=1e-6)
    _assert_state_close(js, state)
    assert not ss.step_supported(SirenSnakeTanhConfig(out_features=2,
                                                      hidden_features=32))
    # the int8 rate points use h=36..48: a fused fit there runs padded to
    # the next kernel width, h=64 (128-row tiles); wider than 256 raises
    odd = build_model("mlp", SirenSnakeTanhConfig(hidden_features=48),
                      fused=True)
    assert tloop.fused_step_plan(odd, tc, 512) == 8192 // 64
    wide = build_model("mlp", SirenSnakeTanhConfig(hidden_features=320),
                       fused=True)
    with pytest.raises(ValueError, match="hidden widths 1..256"):
        tloop.fused_step_plan(wide, tc, 512)
    # h=256 is a kernel width: 32-row tiles
    assert ss.step_block_rows(SirenSnakeTanhConfig(hidden_features=256),
                              512) == 32
    cfg = tcodec.CodecConfig(hidden_features=320, fused=True, total_steps=1,
                             chunk_seconds=0.01)
    with pytest.raises(ValueError, match="hidden widths"):
        tcodec.encode(np.zeros(200, np.float32), 4000, cfg, device="cpu")


def test_flat_layout_round_trips():
    cfg = SirenSnakeTanhConfig(**CFG, num_tanh=1, in_features=2)
    params = build_model("mlp", cfg).init(torch.Generator().manual_seed(0),
                                          windows=3)
    flat = st.flatten_params(params, cfg)
    layout = st.flat_layout(cfg)
    assert flat.shape == (3, layout.size) and layout.size % 4 == 0
    assert all(off % 4 == 0 for _, _, off, _ in layout.leaves)
    back = st.unflatten_params(flat, cfg)
    for a, b in zip(tree_leaves(params), tree_leaves(back)):
        assert torch.equal(a, b)
    # what no leaf covers is zero
    covered = torch.zeros(layout.size, dtype=torch.bool)
    for _, _, off, shape in layout.leaves:
        covered[off:off + int(np.prod(shape))] = True
    assert torch.all(flat[:, ~covered] == 0)
    assert [shape for _, _, _, shape in layout.leaves] == [
        tuple(l.shape[1:]) for li in range(len(cfg.layer_kinds))
        for l in (params["layers"][li][k] for k in ("w", "b", "snake_a")
                  if k in params["layers"][li])]


class _RecordingLibrary:
    """Stands in for csrc/siren_train.cu's library: records each launch's
    window count and the pointers it was given."""

    def __init__(self):
        self.calls = []

    def siren_grad(self, coords, params, partial, loss_part, pre, tgt, cot,
                   *rest):
        self.calls.append(("grad", rest[4], params, loss_part, tgt))
        return 0

    def siren_reduce(self, partial, grads, sq_part, loss_part, loss_out, k,
                     tiles, P, stream):
        self.calls.append(("reduce", k, grads, sq_part))
        return 0


def test_grad_reduce_launches_window_groups(monkeypatch):
    # the FMA route's (highest tier) scratch is tiles * (P + 8192 L) floats
    # per window: a population goes through grad + reduce in groups that
    # fit SCRATCH_BYTES, each launch offset to its group's first window
    # (tests/test_torch_grad_plan.py holds the tensor-core route's)
    cfg = SirenSnakeTanhConfig(**CFG)
    plan = sf.stack_plan(cfg, approx_sin=True)
    k, n = 7, 300
    flat = st.flatten_params(build_model("mlp", cfg).init(
        torch.Generator().manual_seed(0), windows=k), cfg)
    coords = torch.linspace(-1, 1, n)[:, None]
    targets = torch.zeros(k, n)
    g = st.validate_grad_launch(flat, cfg, plan, coords)
    per_window = 4 * g.tiles * (g.layout.size + len(plan.kinds)
                                * st.TILE_FLOATS)
    assert st.window_group(g) == k
    monkeypatch.setattr(st, "SCRATCH_BYTES", 3 * per_window + 1)
    assert st.window_group(g) == 3
    lib = _RecordingLibrary()
    grads, sq_part, loss_part = st.grad_reduce(lib, g, coords, flat, 0,
                                               targets=targets,
                                               gmode="highest")
    assert grads.shape == (k, g.layout.size)
    assert g.slices == g.tiles  # a short window: one tile per slice
    assert loss_part.shape == (k * g.slices,)
    expect = []
    for w0, kn in ((0, 3), (3, 3), (6, 1)):
        expect += [("grad", kn, flat.data_ptr() + 4 * w0 * g.layout.size,
                    loss_part.data_ptr() + 4 * w0 * g.slices,
                    targets.data_ptr() + 4 * w0 * n),
                   ("reduce", kn, grads.data_ptr() + 4 * w0 * g.layout.size,
                    sq_part.data_ptr() + 4 * w0 * sq_part.shape[1])]
    assert lib.calls == expect
    # at the codec default's 11,025-row windows (h=128) a group holds the
    # same number of windows whatever the population: the scratch does not
    # grow with the clip
    monkeypatch.undo()
    wide = SirenSnakeTanhConfig(hidden_features=128, first_omega_0=1800.0)
    wplan = sf.stack_plan(wide, approx_sin=True)
    groups = {st.window_group(st.GradLaunch(kk, 11025, 1, 128,
                                            -(-11025 // 64),
                                            st.flat_layout(wide), wplan))
              for kk in (31, 500, 5000)}
    assert len(groups) == 1 and 1 <= groups.pop() < 31


def test_kernel_routes_raise_off_the_card():
    # CUDA requests never fall back to the plain versions
    cfg = SirenSnakeTanhConfig(**CFG)
    params = build_model("mlp", cfg).init(torch.Generator().manual_seed(0),
                                          windows=2)
    meta = tree_map(lambda v: v.to("meta"), params)
    with pytest.raises(ValueError, match="no fused"):
        st.fused_siren_train_apply(meta, cfg, torch.zeros(8, 1,
                                                          device="meta"))
    flat = st.flatten_params(params, cfg)
    if not torch.cuda.is_available():
        plan = sf.stack_plan(cfg)
        with pytest.raises(RuntimeError):
            st.SIREN_BWD(params, cfg, plan, "bf16x2", torch.zeros(8, 1),
                         torch.zeros(2, 8, 1))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcodec.encode(np.zeros(400, np.float32), 4000,
                          tcodec.CodecConfig(fused=True), device="cuda")
    with pytest.raises(ValueError, match="float32"):
        ss.SIREN_STEP(flat.double(), flat, flat, flat, torch.zeros(8, 1),
                      torch.zeros(2, 8), *[torch.zeros(2)] * 4, cfg,
                      sf.stack_plan(cfg), "bf16x2", 1.0)
