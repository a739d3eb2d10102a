"""The port's shared-backbone modulated model and its fit held against the
JAX package on the CPU: ``per_last_axis`` quantization bit for bit,
``modulated_apply`` with parameters copied from the JAX init, and
``modulated_fit`` from the same backbone and zero modulations, on one rank
and on two thread ranks (``run_thread_ranks`` of tests/test_torch_cuda.py)
against one.  Inputs come from numpy with a seed.

Tolerances: the forward is true f32 on both sides, matmul order and libm
sin differ by ~1e-7 (EXACT_ATOL, tests/test_torch_decode.py).  A fit's
states after 10 steps carry the two packages' summation orders through
Adam (P_RTOL / P_ATOL and the loss histories' LOSS_RTOL, as
tests/test_torch_train.py bounds the multi-INR fit)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inraudio_tpu.models import quantize as jquant
from inraudio_tpu.models.modulated import mod_dim as jax_mod_dim
from inraudio_tpu.models.modulated import modulated_apply as jax_apply
from inraudio_tpu.models.modulated import modulated_init as jax_init
from inraudio_tpu.models.siren import SirenSnakeTanhConfig as JaxConfig
from inraudio_tpu.train import TrainConfig as JaxTrainConfig
from inraudio_tpu.train.modulated import modulated_fit as jax_fit
from inraudio_tpu_torch.models import (SirenSnakeTanhConfig, params_from_jax,
                                       quantize_params)
from inraudio_tpu_torch.models.modulated import (mod_dim, modulated_apply,
                                                 modulated_init)
from inraudio_tpu_torch.train.loop import TrainConfig
from inraudio_tpu_torch.train.modulated import modulated_fit
from inraudio_tpu_torch.tree import tree_leaves
from test_torch_cuda import run_thread_ranks

torch.set_num_threads(1)

EXACT_ATOL = 1e-5
P_RTOL, P_ATOL = 3e-5, 3e-6
LOSS_RTOL = 1e-5
CFG = dict(hidden_features=16, num_sine=1, num_snake=1, first_omega_0=200.0)
N, K = 64, 4
RANK_TIMEOUT_S = 60.0


def _cfgs(**kw):
    return JaxConfig(**{**CFG, **kw}), SirenSnakeTanhConfig(**{**CFG, **kw})


def _problem(k=K, n=N, seed=0):
    rng = np.random.default_rng(seed)
    coords = np.linspace(-1, 1, n, dtype=np.float32)[:, None]
    f = rng.uniform(1.0, 4.0, (k, 1))
    ph = rng.uniform(0, np.pi, (k, 1))
    t = 0.8 * np.sin(2 * np.pi * f * coords[None, :, 0] + ph)
    return coords, t.astype(np.float32)[..., None]


def _jax_backbone(jcfg, k=K, film=False, seed=1):
    p = jax_init(jax.random.PRNGKey(seed), jcfg, k, film_scale=film)
    return jax.tree.map(np.asarray, p["shared"])


@pytest.mark.parametrize("mode", ["int8", "int16"])
@pytest.mark.parametrize("shape", [(7, 12), (3, 5, 6)])
def test_per_last_axis_matches_jax(mode, shape):
    x = (np.random.default_rng(2).standard_normal(shape) * 0.3
         ).astype(np.float32)
    x[..., 0] = 0.0  # a zero column keeps the 1e-12 floor
    j = jax.tree.map(np.asarray, jquant.quantize_params(
        jnp.asarray(x), mode, per_last_axis=True))
    t = quantize_params(torch.from_numpy(x), mode, per_last_axis=True)
    assert t["scale"].shape == (1,) * (len(shape) - 1) + shape[-1:]
    np.testing.assert_array_equal(t["q"].numpy(), j["q"])
    np.testing.assert_array_equal(t["scale"].numpy(), j["scale"])


@pytest.mark.parametrize("film", [False, True], ids=["shift", "film"])
def test_modulated_apply_matches_jax(film):
    jcfg, tcfg = _cfgs()
    assert mod_dim(tcfg, film) == jax_mod_dim(jcfg, film)
    shared = _jax_backbone(jcfg, film=film)
    coords, _ = _problem()
    mods = (0.3 * np.random.default_rng(3).standard_normal(
        (K, jax_mod_dim(jcfg, film)))).astype(np.float32)
    ref = np.stack([np.asarray(jax_apply(shared, jcfg, coords, m,
                                         film_scale=film)) for m in mods])
    ts = params_from_jax(shared)
    out = modulated_apply(ts, tcfg, torch.from_numpy(coords),
                          torch.from_numpy(mods), film_scale=film)
    assert out.shape == ref.shape == (K, N, 1)
    np.testing.assert_allclose(out.numpy(), ref, atol=EXACT_ATOL, rtol=0)
    # one modulation vector gives that window alone
    one = modulated_apply(ts, tcfg, torch.from_numpy(coords),
                          torch.from_numpy(mods[2]), film_scale=film)
    np.testing.assert_allclose(one.numpy(), out[2].numpy(), atol=1e-7)


def test_modulated_init_zero_mods_are_the_backbone():
    _, tcfg = _cfgs()
    g = torch.Generator().manual_seed(0)
    p = modulated_init(g, tcfg, 3, film_scale=True)
    assert p["mods"].shape == (3, 2 * mod_dim(tcfg))
    assert not p["mods"].any()
    coords = torch.linspace(-1, 1, 50)[:, None]
    a = modulated_apply(p["shared"], tcfg, coords, p["mods"][0],
                        film_scale=True)
    b = modulated_apply(p["shared"], tcfg, coords,
                        torch.zeros(mod_dim(tcfg)))
    assert torch.equal(a, b)


def _fit_pair(mult, clip=1.0, steps=10, **extra):
    jcfg, tcfg = _cfgs()
    coords, targets = _problem()
    shared = _jax_backbone(jcfg)
    kw = dict(total_steps=steps, learning_rate=2e-3, grad_clip_norm=clip,
              scan_chunk=4, plateau_patience=3)
    if "frozen_shared" not in extra:
        extra["init_shared"] = shared
    jres = jax_fit(jcfg, targets, coords, JaxTrainConfig(**kw),
                   mods_lr_mult=mult, **extra)
    tres = modulated_fit(tcfg, targets, coords, TrainConfig(**kw),
                         device="cpu", mods_lr_mult=mult,
                         **{k: (v if k == "frozen_mods" else
                                params_from_jax(v))
                            for k, v in extra.items()})
    return jres, tres


@pytest.mark.parametrize("clip", [1.0, 0.05])
@pytest.mark.parametrize("mult", [1.0, 5.0])
def test_modulated_fit_matches_jax(mult, clip):
    jres, tres = _fit_pair(mult, clip)
    np.testing.assert_allclose(tres.loss_history, jres.loss_history,
                               rtol=LOSS_RTOL)
    assert tres.loss_history[-1] < tres.loss_history[0]
    for a, b in zip(jax.tree.leaves(jres.shared), tree_leaves(tres.shared)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=P_RTOL,
                                   atol=P_ATOL)
    np.testing.assert_allclose(tres.mods.numpy(), np.asarray(jres.mods),
                               rtol=P_RTOL, atol=P_ATOL)


@pytest.mark.parametrize("frozen", ["shared", "mods"])
def test_modulated_fit_frozen_modes_match_jax(frozen):
    jcfg, _ = _cfgs()
    if frozen == "shared":
        extra = dict(frozen_shared=_jax_backbone(jcfg, seed=4))
    else:
        extra = dict(frozen_mods=(0.2 * np.random.default_rng(5)
                                  .standard_normal((K, jax_mod_dim(jcfg)))
                                  ).astype(np.float32))
    jres, tres = _fit_pair(1.0, **extra)
    if frozen == "mods":
        np.testing.assert_array_equal(tres.mods.numpy(), extra["frozen_mods"])
    np.testing.assert_allclose(tres.loss_history, jres.loss_history,
                               rtol=LOSS_RTOL)
    for a, b in zip(jax.tree.leaves(jres.shared), tree_leaves(tres.shared)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=P_RTOL,
                                   atol=P_ATOL)
    np.testing.assert_allclose(tres.mods.numpy(), np.asarray(jres.mods),
                               rtol=P_RTOL, atol=P_ATOL)


def test_modulated_fit_validations():
    _, tcfg = _cfgs()
    coords, t = _problem(k=2, n=16)
    base = modulated_fit(tcfg, t, coords, TrainConfig(total_steps=2),
                         device="cpu")
    cases = [
        (dict(frozen_shared=base.shared, init_shared=base.shared),
         "init_shared"),
        (dict(frozen_shared=base.shared, mods_lr_mult=2.0), "mods_lr_mult"),
        (dict(frozen_mods=base.mods, mods_lr_mult=2.0), "mods_lr_mult"),
        (dict(frozen_mods=base.mods, frozen_shared=base.shared),
         "nothing to train"),
    ]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            modulated_fit(tcfg, t, coords, TrainConfig(total_steps=2),
                          device="cpu", **kw)
    with pytest.raises(ValueError, match="loss_mode"):
        modulated_fit(tcfg, t, coords,
                      TrainConfig(total_steps=2, loss_mode="mae"),
                      device="cpu")


def test_modulated_fit_rounds_do_not_change_the_result():
    _, tcfg = _cfgs()
    coords, t = _problem()
    runs = [modulated_fit(tcfg, t, coords,
                          TrainConfig(total_steps=7, grad_clip_norm=1.0,
                                      scan_chunk=chunk),
                          generator=torch.Generator().manual_seed(3),
                          device="cpu", mods_lr_mult=3.0)
            for chunk in (2, 500)]
    np.testing.assert_array_equal(runs[0].loss_history, runs[1].loss_history)
    for a, b in zip(tree_leaves(runs[0].shared), tree_leaves(runs[1].shared)):
        assert torch.equal(a, b)
    assert torch.equal(runs[0].mods, runs[1].mods)


@pytest.mark.parametrize("mode", ["joint", "frozen_mods"])
def test_modulated_fit_on_two_ranks_matches_one(mode):
    """The window-split fit: every rank returns the whole result, the same
    as one rank's up to the all-reduce's summation order."""
    _, tcfg = _cfgs()
    coords, t = _problem()
    extra = {}
    if mode == "frozen_mods":
        extra["frozen_mods"] = (0.2 * np.random.default_rng(6)
                                .standard_normal((K, mod_dim(tcfg)))
                                ).astype(np.float32)
    else:
        extra["mods_lr_mult"] = 5.0
    tc = TrainConfig(total_steps=10, learning_rate=2e-3, grad_clip_norm=0.05,
                     scan_chunk=4, plateau_patience=3)

    def run(mesh=None):
        return modulated_fit(tcfg, t, coords, tc,
                             generator=torch.Generator().manual_seed(2),
                             device=None if mesh else "cpu", mesh=mesh,
                             **extra)

    one = run()
    ranks = run_thread_ranks(2, run, device="cpu", timeout_s=RANK_TIMEOUT_S)
    for r in ranks:
        np.testing.assert_allclose(r.loss_history, one.loss_history,
                                   rtol=LOSS_RTOL)
        np.testing.assert_array_equal(r.loss_history, ranks[0].loss_history)
        for a, b in zip(tree_leaves(r.shared), tree_leaves(one.shared)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=P_RTOL,
                                       atol=P_ATOL)
        np.testing.assert_allclose(r.mods.numpy(), one.mods.numpy(),
                                   rtol=P_RTOL, atol=P_ATOL)
    for a, b in zip(tree_leaves(ranks[0].shared), tree_leaves(
            ranks[1].shared)):
        assert torch.equal(a, b)
    # a window count that does not divide by the ranks raises
    with pytest.raises(ValueError, match="do not shard"):
        run_thread_ranks(3, run, device="cpu", timeout_s=RANK_TIMEOUT_S)
