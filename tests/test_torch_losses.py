"""The port's loss zoo (``inraudio_tpu_torch.train.losses``) held against
the JAX package's on the CPU: ``mix_loss`` in every loss mode, with and
without a per-row weight (some rows at 0, as padding), at alpha 0 and 0.5,
with the single- and the multi-resolution STFT term; the value and its
gradient with respect to the prediction (autograd against ``jax.grad``).

Tolerances: the value to VALUE_RTOL; the gradient to GRAD_RTOL of its
largest element.  Both packages compute in float32 and differ in the
summation order of the DFT products and the reductions (~1e-7 relative
each).  The log-magnitude term's gradient is 1 / |X| per bin, so the DFT's
absolute rounding (~1e-7 of the largest magnitude) is a relative error of
~1e-4 in bins 1000 times below the peak: measured, the STFT loss's
gradient agrees to 1.6e-6 of its largest element without the log term and
to 3.0e-4 with it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inraudio_tpu.train import losses as jlosses
from inraudio_tpu_torch.train import losses as tlosses

torch.set_num_threads(1)

N = 3000
VALUE_RTOL = 2e-5
GRAD_RTOL = 1e-3


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(N) / 8000.0
    target = (0.7 * np.sin(2 * np.pi * 440 * t)
              + 0.05 * rng.standard_normal(N)).astype(np.float32)[:, None]
    pred = (target + 0.1 * rng.standard_normal((N, 1))).astype(np.float32)
    w = rng.uniform(0.8, 1.0, N).astype(np.float32)
    w[-200:] = 0.0  # padded rows
    w = (w * (N / w.sum())).astype(np.float32)[:, None]
    return pred, target, w


@pytest.mark.parametrize("multi", [False, True], ids=["single", "mrstft"])
@pytest.mark.parametrize("alpha", [0.0, 0.5])
@pytest.mark.parametrize("weighted", [False, True], ids=["none", "weight"])
@pytest.mark.parametrize("mode", ["mse", "mae", "snr"])
def test_mix_loss_value_and_gradient_match_jax(mode, weighted, alpha, multi):
    pred, target, w = _inputs()
    weight = w if weighted else None
    kw = dict(loss_mode=mode, alpha=alpha, multi_resolution=multi)

    def jf(p):
        return jlosses.mix_loss(p, jnp.asarray(target),
                                weight=None if weight is None
                                else jnp.asarray(weight), **kw)

    jval, jgrad = jax.value_and_grad(jf)(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    tval = tlosses.mix_loss(p, torch.from_numpy(target),
                            weight=None if weight is None
                            else torch.from_numpy(weight), **kw)
    (tgrad,) = torch.autograd.grad(tval, [p])
    np.testing.assert_allclose(tval.item(), float(jval), rtol=VALUE_RTOL)
    jgrad = np.asarray(jgrad)
    assert np.isfinite(tgrad.numpy()).all()
    np.testing.assert_allclose(tgrad.numpy(), jgrad, rtol=0,
                               atol=GRAD_RTOL * float(np.abs(jgrad).max()))
    if weighted:  # rows with weight 0 take no gradient
        assert not tgrad[-200:].any()


@pytest.mark.parametrize("fn", ["mse", "mae", "snr_loss", "weighted_mse",
                                "stft_loss", "multi_resolution_stft_loss"])
def test_each_loss_matches_jax(fn):
    pred, target, w = _inputs(seed=1)
    args = (pred, target) + ((w,) if fn == "weighted_mse" else ())
    jv = getattr(jlosses, fn)(*(jnp.asarray(a) for a in args))
    tv = getattr(tlosses, fn)(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(float(tv), float(jv), rtol=VALUE_RTOL)


def test_loss_tables_match_jax():
    assert tlosses.MRSTFT_RESOLUTIONS == jlosses.MRSTFT_RESOLUTIONS
    assert sorted(tlosses.BASE_LOSSES) == sorted(jlosses.BASE_LOSSES)
    assert tlosses.EPS == jlosses.EPS
