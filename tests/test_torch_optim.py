"""The port's optimizer state (inraudio_tpu_torch/train/optim.py) held
against the JAX package's, with a leading window axis: JAX vmaps its
per-model functions over the windows, the port takes (k, ...) tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inraudio_tpu.train import optim as jopt
from inraudio_tpu_torch.train import optim as topt
from inraudio_tpu_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)

K, STEPS = 3, 20


def _tree(rng, scale=1.0):
    return {"layers": [{"w": rng.standard_normal((K, 4, 5)) * scale,
                        "b": rng.standard_normal((K, 5)) * scale},
                       {"w": rng.standard_normal((K, 5, 1)) * scale,
                        "b": rng.standard_normal((K, 1)) * scale,
                        "snake_a": rng.standard_normal((K, 1)) * scale}]}


def _f32(tree):
    return tree_map(lambda a: np.asarray(a, np.float32), tree)


def test_adam_clip_plateau_match_jax_per_window():
    rng = np.random.default_rng(0)
    params = _f32(_tree(rng))
    # window 1's gradients are 50x larger: its clip must not touch the others
    grads = [_f32(tree_map(lambda a, i=i: a * np.array([1, 50, 1])[
        (slice(None),) + (None,) * (a.ndim - 1)], _tree(rng, 0.3)))
        for i in range(STEPS)]
    # losses that improve, stall and improve again, per window
    losses = np.float32(1.0) / (1.0 + np.arange(STEPS, dtype=np.float32))
    losses = np.stack([losses, np.minimum(losses, 0.2), losses * 0 + 0.5],
                      axis=1).astype(np.float32)
    acfg = jopt.AdamConfig(lr=1e-3)
    pcfg = jopt.PlateauConfig(factor=0.5, patience=2, min_lr=2e-4)

    def jax_step(p, st, pl, g, loss):
        g = jopt.clip_by_global_norm(g, 1.0)
        p, st = jopt.adam_update(st, g, p, acfg)
        pl, lr = jopt.plateau_update(pl, loss, st.lr, pcfg)
        return p, st._replace(lr=lr), pl

    jp = jax.tree.map(jnp.asarray, params)
    jst = jax.vmap(lambda p: jopt.adam_init(p, acfg))(jp)
    jpl = jax.vmap(lambda _: jopt.plateau_init())(jnp.arange(K))
    vstep = jax.jit(jax.vmap(jax_step))

    tp = tree_map(torch.from_numpy, params)
    tst = topt.adam_init(tp, topt.AdamConfig(lr=1e-3), windows=K)
    tpl = topt.plateau_init(K)
    tcfg = topt.PlateauConfig(factor=0.5, patience=2, min_lr=2e-4)
    jlr, tlr = [], []
    for i in range(STEPS):
        jp, jst, jpl = vstep(jp, jst, jpl, jax.tree.map(jnp.asarray, grads[i]),
                             jnp.asarray(losses[i]))
        g = topt.clip_by_global_norm(tree_map(torch.from_numpy, grads[i]),
                                     1.0, windows=True)
        tp, tst = topt.adam_update(tst, g, tp, topt.AdamConfig(lr=1e-3))
        tpl, lr = topt.plateau_update(tpl, torch.from_numpy(losses[i]),
                                      tst.lr, tcfg)
        tst = tst._replace(lr=lr)
        jlr.append(np.asarray(jst.lr))
        tlr.append(tst.lr.numpy())
    # the plateau decisions and lr values are exactly equal, per window
    np.testing.assert_array_equal(np.stack(jlr), np.stack(tlr))
    # window 0 keeps improving; the stalled windows' lr decayed
    assert len(set(np.stack(tlr)[:, 0])) == 1
    assert len(set(np.stack(tlr)[:, 1])) > 1 and np.stack(tlr)[-1, 2] == 2e-4
    np.testing.assert_array_equal(np.asarray(jpl.num_bad),
                                  tpl.num_bad.numpy())
    np.testing.assert_array_equal(np.asarray(jpl.best), tpl.best.numpy())
    np.testing.assert_array_equal(np.asarray(jst.step), tst.step.numpy())
    # f32 elementwise arithmetic in the same order; pow may differ by an ulp
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=2e-6,
                                   atol=1e-8)
    for a, b in zip(jax.tree.leaves(jst.nu), tree_leaves(tst.nu)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-5,
                                   atol=1e-12)


@pytest.mark.parametrize("windows", [False, True])
def test_clip_by_global_norm(windows):
    rng = np.random.default_rng(1)
    g = _f32(_tree(rng, 3.0))
    out = topt.clip_by_global_norm(tree_map(torch.from_numpy, g), 2.0,
                                   windows=windows)
    if windows:
        ref = jax.vmap(lambda t: jopt.clip_by_global_norm(t, 2.0))(g)
        norms = np.sqrt(sum(np.sum(l.numpy().reshape(K, -1) ** 2, axis=1)
                            for l in tree_leaves(out)))
        np.testing.assert_allclose(norms, 2.0, rtol=1e-5)
    else:
        ref = jopt.clip_by_global_norm(g, 2.0)
    for a, b in zip(jax.tree.leaves(ref), tree_leaves(out)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6)


def test_scalar_state_matches_jax():
    # the refit's optimizer: one state over a stacked tree, scalar step/lr
    rng = np.random.default_rng(2)
    params = _f32(_tree(rng))
    acfg = jopt.AdamConfig(lr=1e-4)
    jst = jopt.adam_init(params, acfg)
    tst = topt.adam_init(tree_map(torch.from_numpy, params),
                         topt.AdamConfig(lr=1e-4))
    assert tst.step.shape == () and tst.lr.shape == ()
    jp, tp = params, tree_map(torch.from_numpy, params)
    for _ in range(5):
        g = _f32(_tree(rng, 0.1))
        jp, jst = jopt.adam_update(jst, g, jp, acfg)
        tp, tst = topt.adam_update(tst, tree_map(torch.from_numpy, g), tp,
                                   topt.AdamConfig(lr=1e-4))
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=2e-6,
                                   atol=1e-8)
