"""Hidden widths between the kernel widths (the codec's rate points use
h = 36, 40 and 48): the port's SIREN kernels run such a model zero-padded to
the next kernel width, with the model's own width passed to the training
kernels so that every padded unit outputs exactly 0.  Held here on the CPU,
through the kernels' plain versions, against the unpadded model and against
the JAX package (its Pallas kernels in interpret mode).  Also the packaging
of the CUDA sources: the wheel ships them, and the kernels build into a
per-user cache when the package directory is read-only."""

import dataclasses
import glob
import os
import shutil
import subprocess
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inraudio_tpu import codec as jcodec
from inraudio_tpu.models import SirenSnakeTanhConfig as JaxConfig
from inraudio_tpu.models import build_model as jax_build_model
from inraudio_tpu.ops import pallas_siren as jps
from inraudio_tpu.train.multi_inr import stitch_chunks as jax_stitch
from inraudio_tpu_torch import codec as tcodec
from inraudio_tpu_torch.models import (SirenSnakeTanhConfig, build_model,
                                       params_from_jax)
from inraudio_tpu_torch.ops import _nvcc
from inraudio_tpu_torch.ops import siren_fused as sf
from inraudio_tpu_torch.ops import siren_step as ss
from inraudio_tpu_torch.ops import siren_train as st
from inraudio_tpu_torch.train import loop as tloop
from inraudio_tpu_torch.tree import tree_leaves, tree_map, tree_unflatten

from test_torch_codec import FS, LENGTH, jax_payload
from test_torch_cuda import padded_slots

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one sine and two snake layers: a snake unit feeds a snake unit, where the
# padded units' polynomial cos(0) != 1 shows
CFG = dict(hidden_features=48, first_omega_0=300.0, num_sine=1, num_snake=2)
N, K, STEPS = 200, 2, 5
# the padded and the unpadded plain step differ only in the order of the
# hidden products' sums (zero terms added): the bound of the plain step's
# parity tests against the JAX step (tests/test_torch_train.py)
P_RTOL, P_ATOL = 3e-5, 3e-6


@pytest.fixture
def inherit_grad_tier(monkeypatch):
    """Exact A/Bs against the JAX kernels: the backward products in the
    forward's f32 tier (the JAX kernels read the env var while tracing)."""
    monkeypatch.setenv("INRAUDIO_GRAD_PRECISION", "inherit")
    jax.clear_caches()
    yield
    jax.clear_caches()


def _problem(n=N, k=K):
    coords = torch.linspace(-1, 1, n)[:, None]
    t = torch.sin(2 * np.pi * torch.tensor([3.0, 5.0])[:k, None]
                  * coords[None, :, 0])
    return coords, 0.8 * t


def _state(cfg, tc):
    m = build_model("mlp", cfg, fused=True, approx_sin=True)
    s = tloop.init_train_state(m, torch.Generator().manual_seed(0), tc,
                               "cpu")
    return tree_map(lambda t: torch.stack([t] * K), s)


def _padded_steps(cfg, tc, state, coords, targets, mask=True):
    """``STEPS`` plain steps of D on the state padded to the kernel width,
    through the port's step; ``mask=False`` runs them with the plan's width
    set to the kernel width, so the padded units are not held at 0."""
    step_call = ss.fused_mse_step_call
    if not mask:
        def step_call(*a, **kw):
            plan = dataclasses.replace(a[11], width=64)
            return ss.step_plain(*a[:11], plan, *a[12:], **kw)
    step = ss.make_fused_mse_train_step(cfg, tc, coords.shape[0],
                                        approx_sin=True, step_call=step_call)
    fs = ss.flat_state_from_train_state(tree_map(torch.clone, state), cfg)
    losses = []
    for _ in range(STEPS):
        fs, (loss, _) = step(fs, coords, targets)
        losses.append(loss)
    return fs, torch.stack(losses)


def _unpadded_steps(cfg, tc, state, coords, targets):
    """The same steps on the unpadded model: D's plain arithmetic (forward
    with saved pres, backward sweep, clip + Adam + best) on leaves of the
    model's own width, concatenated into one vector per state group."""
    plan = sf.stack_plan(cfg, approx_sin=True)
    gmode = st.grad_dot_mode()
    vec = lambda t: torch.cat([v.reshape(K, -1) for v in tree_leaves(t)], 1)

    def tree(v):
        out, off = [], 0
        for leaf in tree_leaves(state.params):
            n = leaf[0].numel()
            out.append(v[:, off:off + n].reshape(leaf.shape))
            off += n
        return tree_unflatten(state.params, out)

    p, mu, nu, best = (vec(t).clone() for t in (
        state.params, state.opt.mu, state.opt.nu, state.best_params))
    lr, best_loss = state.opt.lr.clone(), state.best_loss.clone()
    n = coords.shape[0]
    losses = []
    for t in range(1, STEPS + 1):
        params = tree(p)
        out, saved = st.fwd_pres_plain(params, plan, coords)
        err = out[..., 0] - targets
        loss = torch.sum(err * err, dim=1) * (1.0 / n)
        grads = st.bwd_sweep_plain((err * (2.0 / n)).unsqueeze(-1), saved,
                                   params, plan, gmode)
        tf = torch.full((K,), float(t))
        ss.adam_epilogue_plain(p, mu, nu, best, vec(grads), lr,
                               1.0 - 0.9 ** tf, 1.0 - 0.999 ** tf, loss,
                               best_loss, tc.grad_clip_norm)
        best_loss = torch.where(loss < best_loss, loss, best_loss)
        losses.append(loss)
    return tree(p), tree(mu), tree(nu), tree(best), torch.stack(losses)


@pytest.mark.parametrize("h", [36, 40, 48])
def test_pad_then_unpad_is_bit_identical(h):
    cfg = SirenSnakeTanhConfig(**{**CFG, "hidden_features": h})
    params = build_model("mlp", cfg).init(torch.Generator().manual_seed(h),
                                          windows=3)
    width = sf.kernel_width(h)
    assert width == (64 if h > 32 else 32)
    padded = sf.pad_params(params, width)
    for li, layer in enumerate(padded["layers"]):
        for key, v in layer.items():
            real = params["layers"][li][key]
            assert v.shape[0] == 3 and all(s in (width, 1)
                                           for s in v.shape[1:])
            if key == "snake_a":
                assert torch.all(v[:, h:] == 1.0)
            elif real.shape != v.shape:
                assert torch.count_nonzero(v) == torch.count_nonzero(real)
    back = sf.unpad_params(padded, h)
    for a, b in zip(tree_leaves(params), tree_leaves(back)):
        assert a.shape == b.shape and torch.equal(a, b)
    # and through the flat train state, once per fit each way
    tc = tloop.TrainConfig()
    state = tree_map(lambda t: torch.stack([t] * 3), tloop.init_train_state(
        build_model("mlp", cfg, fused=True), torch.Generator(), tc, "cpu"))
    state = state._replace(params=params, best_params=params)
    fs = ss.flat_state_from_train_state(state, cfg)
    assert fs.params.shape == (3, st.flat_layout(cfg).size)
    again = ss.train_state_from_flat(fs, cfg)
    for a, b in zip(tree_leaves(state), tree_leaves(again)):
        assert a.shape == b.shape and torch.equal(a, b)
    # a kernel width is left as it is
    assert sf.pad_params(padded, width)["layers"][1]["w"] is \
        padded["layers"][1]["w"]


def test_padded_plain_step_matches_the_unpadded_model():
    cfg = SirenSnakeTanhConfig(**CFG)
    tc = tloop.TrainConfig(grad_clip_norm=1.0)
    coords, targets = _problem()
    state = _state(cfg, tc)
    fs, losses = _padded_steps(cfg, tc, state, coords, targets)
    padded, a_slots = padded_slots(cfg)
    assert st.flat_layout(cfg).h == 64 and padded.any() and a_slots.any()
    # every padded slot of params and best stays exactly 0 (snake a
    # exactly 1), of mu and nu exactly 0: their gradients are exact zeros
    for group in (fs.params, fs.best_params):
        assert torch.all(group[:, padded & ~a_slots] == 0)
        assert torch.all(group[:, a_slots] == 1.0)
    for group in (fs.mu, fs.nu):
        assert torch.all(group[:, padded] == 0)
    ref_p, ref_mu, ref_nu, ref_best, ref_losses = _unpadded_steps(
        cfg, tc, state, coords, targets)
    torch.testing.assert_close(losses, ref_losses, rtol=1e-6, atol=0)
    out = ss.train_state_from_flat(fs, cfg)
    for group, ref in ((out.params, ref_p), (out.best_params, ref_best)):
        for a, b in zip(tree_leaves(group), tree_leaves(ref)):
            torch.testing.assert_close(a, b, rtol=P_RTOL, atol=P_ATOL)
    for a, b in zip(tree_leaves(out.opt.mu), tree_leaves(ref_mu)):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-6)


def test_padding_without_the_width_mask_leaks():
    # the snake finding: zero weights alone do not keep padded units out.
    # A padded snake unit has pre = 0, and the kernels' polynomial cos(0)
    # is not 1, so its activation is not 0 and the next layer's dW rows
    # for it are not 0; Adam turns them into steps of about lr
    assert float(sf._fast_cos(torch.zeros(1), 7)) != 1.0
    snake0 = {deg: float(0.5 * (1.0 - sf._fast_cos(torch.zeros(1), deg)))
              for deg in (7, 9, 11)}
    assert all(v != 0.0 for v in snake0.values()), snake0
    cfg = SirenSnakeTanhConfig(**CFG)
    tc = tloop.TrainConfig(grad_clip_norm=1.0)
    coords, targets = _problem()
    fs, _ = _padded_steps(cfg, tc, _state(cfg, tc), coords, targets,
                          mask=False)
    padded, _ = padded_slots(cfg)
    assert torch.count_nonzero(fs.mu[:, padded]) > 0
    assert torch.count_nonzero(fs.params[:, padded]
                               - fs.best_params[:, padded]) > 0 or \
        torch.abs(fs.params[:, padded]).max() > 0


def _fixed_init_models(h, jparams):
    """Both packages' fused builders, their init replaced by one fixed
    window's parameters (the packages' PRNGs differ); the JAX kernels in
    interpret mode, as its tests run them on the CPU."""
    tparams = params_from_jax(jparams)

    def jbuild(arch, cfg, **kw):
        m = jax_build_model(arch, cfg, interpret=True, **kw)
        return dataclasses.replace(m, init=lambda key: jax.tree.map(
            jnp.asarray, jparams))

    def tbuild(arch, cfg, **kw):
        m = build_model(arch, cfg, **kw)

        def init(generator, device="cpu", windows=None):
            return tree_map(lambda t: (t if windows is None else torch.stack(
                [t] * windows)).to(device).clone(), tparams)
        return dataclasses.replace(m, init=init)
    return jbuild, tbuild


def test_fused_encode_h48_matches_jax(monkeypatch, inherit_grad_tier):
    # the port's encode(fused=True) at the rate points' h = 48 (plain D on
    # the CPU, padded to 64) against the JAX package's fused encode (the
    # Pallas step kernel in interpret mode, any width), from one init:
    # fit SNRs within 0.02 dB, best params as below, decoded clips within
    # 3e-5 (the trained-payload tolerance of tests/test_torch_decode.py)
    fs = 4000
    t = np.arange(600) / fs
    sig = (0.6 * np.sin(2 * np.pi * 90 * t)
           + 0.2 * np.sin(2 * np.pi * 230 * t)).astype(np.float32)
    cfg = dict(chunk_seconds=0.06, hidden_features=48, first_omega_0=200.0,
               total_steps=4, learning_rate=1e-3, fused=True, quantize=None)
    jparams = jax.tree.map(np.asarray, jax_build_model(
        "mlp", JaxConfig(hidden_features=48, first_omega_0=200.0)).init(
        jax.random.PRNGKey(3)))
    jbuild, tbuild = _fixed_init_models(48, jparams)
    monkeypatch.setattr(jcodec, "build_model", jbuild)
    monkeypatch.setattr(tcodec, "build_model", tbuild)
    jp = jcodec.encode(sig, fs, jcodec.CodecConfig(**cfg))
    tp = tcodec.encode(sig, fs, tcodec.CodecConfig(**cfg), device="cpu")
    assert tp["meta"]["trained_forward"] == "fused_approx"
    assert tp["meta"]["num_chunks"] == jp["meta"]["num_chunks"] >= 2
    np.testing.assert_allclose(tp["meta"]["fit_snr_db"],
                               jp["meta"]["fit_snr_db"], atol=0.02)
    # the best params: Adam divides by sqrt(v), so an entry whose gradient
    # is near 0 moves by ~lr on either package's rounding (the reason for
    # tests/test_torch_train.py's _well_conditioned masks): the bulk within
    # the step parity bound, every entry within 1e-4 (lr / 10)
    ref = np.concatenate([np.asarray(a).ravel()
                          for a in jax.tree.leaves(jp["params"])])
    out = np.concatenate([b.numpy().ravel()
                          for b in tree_leaves(tp["params"])])
    assert out.shape == ref.shape
    err = np.abs(out - ref)
    assert err.max() <= 1e-4, err.max()
    assert np.mean(err <= P_ATOL + P_RTOL * np.abs(ref)) >= 0.999
    _, ref = jcodec.decode(jp, fused=False)
    _, out = tcodec.decode(tp, "cpu", fused=False)
    np.testing.assert_allclose(out, ref, atol=3e-5, rtol=0)


def test_fused_encode_refit_at_the_rate_point_widths():
    # the int8 rate points' h = 36 and 40 with a refit (C's plain version,
    # padded once per refit) and the float16 h = 48 point, end to end
    fs = 4000
    t = np.arange(int(0.12 * fs)) / fs
    sig = (0.5 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)
    for h, quant, refit in ((36, "int8", 3), (40, "int8", 3),
                            (48, "float16", 0)):
        cfg = tcodec.CodecConfig(chunk_seconds=0.05, hidden_features=h,
                                 first_omega_0=200.0, total_steps=10,
                                 learning_rate=1e-3, fused=True,
                                 quantize=quant, refit_steps=refit)
        p = tcodec.encode(sig, fs, cfg, device="cpu")
        assert p["meta"]["model"]["hidden_features"] == h
        assert p["params"]["layers"][1]["b"].shape[-1] == h
        _, dec = tcodec.decode(p, "cpu", fused=True)
        assert dec.shape == sig.shape and np.isfinite(dec).all()
    # wider than the widest kernel width still raises
    with pytest.raises(ValueError, match="hidden widths"):
        st.check_kernel_width(SirenSnakeTanhConfig(hidden_features=257))


def _jax_fused_pipeline(jp):
    """The JAX package's fused decode by hand (its auto route is TPU-only):
    the stacked kernel in interpret mode at the header's tier, then the
    per-window scale and the crossfade stitch."""
    meta = jp["meta"]
    params = jcodec.dequantize_inr_params(jp["params"])
    cfg = jcodec._model_cfg_from_meta(meta)
    kw = jps.auto_decode_kwargs(jcodec._routing_fit_snr(meta),
                                first_omega_0=cfg.first_omega_0)
    coords = jnp.asarray(jcodec._decode_grid(meta["chunk_length"], 1))
    outs = np.asarray(jps.fused_siren_apply_stacked(
        params, cfg, coords, chunks_per_step=8, interpret=True, **kw))
    outs = outs[:, :, 0] * jp["scales"][:, None]
    return kw, jax_stitch(outs, meta["hop"], meta["signal_length"])


@pytest.mark.parametrize("h", [36, 40, 48])
def test_jax_fused_payload_at_odd_width_decodes(tmp_path, h):
    # a JAX-written fused_approx payload at a rate point's width decodes in
    # the port (deg-9 tier: max-abs 1e-5, as the kernel-width payloads of
    # tests/test_torch_decode.py), and its parameters padded to the kernel
    # width, as the card's stack kernel runs them, give the same output
    jp = jax_payload(quantize="float16", trained_forward="fused_approx",
                     fit_snr_db=60.0, h=h)
    path = jcodec.save_inr(str(tmp_path / "p.inra"), jp)
    kw, ref = _jax_fused_pipeline(jcodec.load_inr(path))
    tp = tcodec.load_inr(path)
    _, out = tcodec.decode(tp, "cpu", fused=True)
    assert out.shape == ref.shape == (LENGTH,)
    assert np.abs(out - ref).max() <= 1e-5
    meta = tp["meta"]
    cfg = tcodec._model_cfg_from_meta(meta)
    params = tcodec.dequantize_inr_params(tp["params"], "cpu")
    plan = sf.stack_plan(cfg, **kw)
    coords = torch.from_numpy(tcodec._decode_grid(meta["chunk_length"], 1))
    a = sf.stack_forward_plain(params, plan, coords)
    b = sf.stack_forward_plain(sf.pad_params(params, sf.kernel_width(h)),
                               plan, coords)
    torch.testing.assert_close(b, a, rtol=0, atol=1e-6)


def test_build_root_falls_back_to_the_user_cache(monkeypatch, tmp_path):
    # from a checkout the kernels build beside their sources; where the
    # package directory is not writable, into the per-user cache
    assert _nvcc.build_root() == _nvcc.CSRC / "build"
    lib = _nvcc.library_path("kan", ["kan.cu"])
    assert lib.parent.parent == _nvcc.CSRC / "build"
    monkeypatch.setattr(_nvcc, "_writable", lambda path: False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    cached = _nvcc.library_path("kan", ["kan.cu"])
    assert cached.parent.parent == tmp_path / "xdg" / "inraudio_tpu_torch"
    assert cached.parent.name == lib.parent.name  # same sources, same hash
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert _nvcc.build_root() == (tmp_path / "home" / ".cache"
                                  / "inraudio_tpu_torch")


def test_wheel_ships_the_cuda_sources(tmp_path):
    # a wheel built offline from a copy of the tree lists csrc/*.cu, *.cuh
    src = tmp_path / "src"
    src.mkdir()
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(os.path.join(REPO, name), src / name)
    ignore = shutil.ignore_patterns("build", "__pycache__", "*.pyc")
    for pkg in ("inraudio_tpu", "inraudio_tpu_torch"):
        shutil.copytree(os.path.join(REPO, pkg), src / pkg, ignore=ignore)
    proc = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", str(src), "--no-deps",
         "--no-build-isolation", "--no-index", "-q", "-w",
         str(tmp_path / "dist")], capture_output=True, text=True,
        timeout=240, cwd=tmp_path)
    if proc.returncode != 0 and "setuptools" in proc.stderr:
        pytest.skip(f"setuptools cannot build offline: {proc.stderr[-300:]}")
    assert proc.returncode == 0, proc.stderr[-2000:]
    (wheel,) = glob.glob(str(tmp_path / "dist" / "*.whl"))
    names = set(zipfile.ZipFile(wheel).namelist())
    want = {f"inraudio_tpu_torch/csrc/{os.path.basename(p)}"
            for p in glob.glob(str(_nvcc.CSRC / "*.cu*"))}
    assert want and want <= names, sorted(want - names)
    assert {"inraudio_tpu_torch/csrc/kan.cu",
            "inraudio_tpu_torch/csrc/siren_common.cuh"} <= names
