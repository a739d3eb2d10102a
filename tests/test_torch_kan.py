"""The port's KAN held against the JAX package on the CPU: ``models/kan.py``
(bases, layer and stack applies, curve2coeff, the grid refresh, the
regularisation loss, the init's distributions) and the plain versions of
kernels G and H against the JAX package's fused KAN, which runs in
interpret mode as tests/test_pallas_kan.py runs it.  Parameters are drawn
by the JAX package and carried across as numpy arrays; inputs are made
with numpy from a seed."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inraudio_tpu.models import KANConfig as JaxKANConfig
from inraudio_tpu.models import build_model as jax_build_model
from inraudio_tpu.models import kan as jkan
from inraudio_tpu.ops.pallas_kan import fused_kan_apply as jax_fused_kan_apply
from inraudio_tpu_torch.models import KANConfig, build_model, params_from_jax
from inraudio_tpu_torch.models import kan as tkan
from inraudio_tpu_torch.ops import kan_fused as kf
from inraudio_tpu_torch.tree import tree_leaves, tree_unflatten

torch.set_num_threads(1)

# the configs of tests/test_pallas_kan.py:14-20 at narrow widths
CONFIGS = [dict(layers_hidden=(1, 32, 32, 1)),
           dict(layers_hidden=(2, 16, 1)),
           dict(layers_hidden=(1, 16, 16, 16, 1)),
           dict(layers_hidden=(1, 16, 3)),
           dict(layers_hidden=(1, 16, 1), grid_size=8, spline_order=2)]
IDS = ["x".join(map(str, c["layers_hidden"]))
       + f"-g{c.get('grid_size', 5)}o{c.get('spline_order', 3)}"
       for c in CONFIGS]
# tests/test_pallas_kan.py:35 (forward) and :75 (gradients)
ATOL, RTOL = 2e-5, 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4


def _pair(cfg_kw, seed=17):
    """(JAX config, port config, JAX params, the same params in torch)."""
    jcfg, tcfg = JaxKANConfig(**cfg_kw), KANConfig(**cfg_kw)
    jp = jax_build_model("kan", jcfg).init(jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _coords(n, d, seed=0, lo=-1.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, (n, d)).astype(np.float32)


def _close(a, b, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(b, np.float64),
                               np.asarray(a, np.float64), atol=atol,
                               rtol=rtol)


# ---------------------------------------------------------------------------
# models/kan.py against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg_kw", CONFIGS, ids=IDS)
def test_kan_applies_match_jax(cfg_kw):
    jcfg, tcfg, jp, tp = _pair(cfg_kw)
    x = _coords(777, cfg_kw["layers_hidden"][0], lo=-1.1, hi=1.1)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    order = tcfg.spline_order
    _close(jkan.b_splines(xj, jp["layers"][0]["grid"], order),
           tkan.b_splines(xt, tp["layers"][0]["grid"], order))
    _close(jkan.kan_linear_apply(jp["layers"][0], jcfg, xj),
           tkan.kan_linear_apply(tp["layers"][0], tcfg, xt))
    _close(jkan.kan_apply(jp, jcfg, xj), tkan.kan_apply(tp, tcfg, xt))


@pytest.mark.parametrize("rows", [50, 6], ids=["full-rank", "underdetermined"])
def test_curve2coeff_matches_jax_lstsq(rows):
    """jnp.linalg.lstsq's SVD min-norm solve: a full-rank system of 50
    random samples, and the init's system, 6 rows (the interior knots) for
    8 coefficients."""
    cfg = KANConfig()
    grid = tkan._make_grid(cfg, 3)
    if rows == 6:
        x = grid.T[cfg.spline_order:-cfg.spline_order].numpy().copy()
    else:
        x = _coords(rows, 3, seed=1, lo=-0.95, hi=0.95)
    y = np.random.default_rng(2).standard_normal((rows, 3, 4)).astype(
        np.float32)
    ref = jkan.curve2coeff(jnp.asarray(x), jnp.asarray(y),
                           jnp.asarray(grid.numpy()), cfg.spline_order)
    out = tkan.curve2coeff(torch.from_numpy(x), torch.from_numpy(y), grid,
                           cfg.spline_order)
    assert out.shape == (4, 3, cfg.grid_size + cfg.spline_order)
    # singular vectors of two LAPACK routines: the solutions agree to a few
    # f32 ulps of the system's condition
    _close(ref, out, atol=2e-4, rtol=2e-4)
    # and both interpolate the samples equally well
    a = tkan.b_splines(torch.from_numpy(x), grid, cfg.spline_order)
    fit_t = torch.einsum("bic,oic->bio", a, out).numpy()
    fit_j = np.einsum("bic,oic->bio", a.numpy(), np.asarray(ref))
    _close(fit_j, fit_t, atol=2e-5, rtol=1e-4)


def test_grid_update_matches_jax():
    cfg_kw = dict(layers_hidden=(1, 8, 8, 1))
    jcfg, tcfg, jp, tp = _pair(cfg_kw)
    x = _coords(300, 1, seed=3, lo=-0.8, hi=0.6)
    jl = jkan.kan_linear_update_grid(jp["layers"][1], jcfg,
                                     jnp.asarray(_coords(300, 8, seed=4)))
    tl = tkan.kan_linear_update_grid(tp["layers"][1], tcfg,
                                     torch.from_numpy(_coords(300, 8, seed=4)))
    for key in ("grid", "spline_w", "base_w", "spline_scaler"):
        _close(jl[key], tl[key], atol=1e-5, rtol=1e-4)
    jn = jkan.kan_update_grid(jp, jcfg, jnp.asarray(x))
    tn = tkan.kan_update_grid(tp, tcfg, torch.from_numpy(x))
    for a, b in zip(jax.tree_util.tree_leaves(jn), tree_leaves(tn)):
        _close(a, b, atol=1e-5, rtol=1e-4)
    xe = jnp.asarray(_coords(200, 1, seed=5, lo=-0.8, hi=0.6))
    _close(jkan.kan_apply(jn, jcfg, xe),
           tkan.kan_apply(tn, tcfg, torch.from_numpy(np.array(xe))))


def test_regularization_loss_matches_jax():
    _, _, jp, tp = _pair(dict(layers_hidden=(1, 16, 16, 1)))
    _close(jkan.kan_regularization_loss(jp, 0.7, 1.3),
           tkan.kan_regularization_loss(tp, 0.7, 1.3), atol=1e-6, rtol=1e-6)


def test_init_distributions():
    """The two packages draw different numbers: hold the port's init to
    the bounds of its distributions and to the JAX package's grid."""
    cfg = KANConfig(layers_hidden=(1, 64, 64, 1))
    params = build_model("kan", cfg).init(torch.Generator().manual_seed(0))
    jcfg = JaxKANConfig(layers_hidden=(1, 64, 64, 1))
    jp = jax_build_model("kan", jcfg).init(jax.random.PRNGKey(0))
    for p, q, (i, o) in zip(params["layers"], jp["layers"],
                            [(1, 64), (64, 64), (64, 1)]):
        np.testing.assert_array_equal(p["grid"].numpy(),
                                      np.asarray(q["grid"]))
        assert p["base_w"].shape == (o, i)
        assert p["spline_w"].shape == (o, i, cfg.grid_size + cfg.spline_order)
        bound = math.sqrt(2.0 / (1.0 + 5.0)) * math.sqrt(3.0 / i)
        for key in ("base_w", "spline_scaler"):
            v = p[key]
            assert float(v.abs().max()) <= bound
            if v.numel() >= 64:  # a uniform's spread, not a constant
                assert float(v.std()) > 0.4 * bound / math.sqrt(3.0)
        # spline_w interpolates noise of |amplitude| <= scale_noise / 2 /
        # grid_size at the interior knots
        interior = p["grid"].T[cfg.spline_order:-cfg.spline_order]
        a = tkan.b_splines(interior, p["grid"], cfg.spline_order)
        curve = torch.einsum("bic,oic->bio", a, p["spline_w"])
        limit = cfg.scale_noise / cfg.grid_size / 2
        assert float(curve.abs().max()) <= limit * (1 + 1e-4)
        assert float(curve.abs().max()) > 0.2 * limit


# ---------------------------------------------------------------------------
# The plain versions of G and H against the JAX package's fused KAN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg_kw", CONFIGS, ids=IDS)
def test_fused_forward_matches_jax(cfg_kw):
    jcfg, tcfg, jp, tp = _pair(cfg_kw)
    x = _coords(777, cfg_kw["layers_hidden"][0])
    ref = jax_fused_kan_apply(jp, jcfg, jnp.asarray(x), block_rows=256,
                              interpret=True)
    out = kf.fused_kan_apply(tp, tcfg, torch.from_numpy(x))
    assert out.shape == ref.shape
    _close(ref, out.detach())


def test_fused_forward_rows_not_a_tile_multiple():
    jcfg, tcfg, jp, tp = _pair(dict(layers_hidden=(1, 16, 1)))
    for n in (1, 7, 255, 1000):
        x = np.linspace(-0.9, 0.9, n, dtype=np.float32).reshape(-1, 1)
        ref = jax_fused_kan_apply(jp, jcfg, jnp.asarray(x), block_rows=256,
                                  interpret=True)
        _close(ref, kf.fused_kan_apply(tp, tcfg, torch.from_numpy(x)))


def _grads_pair(cfg_kw, n=300, seed=6):
    jcfg, tcfg, jp, tp = _pair(cfg_kw)
    d, out = cfg_kw["layers_hidden"][0], cfg_kw["layers_hidden"][-1]
    x = _coords(n, d, seed=seed, lo=-0.9, hi=0.9)
    t = (np.sin(3.0 * x[:, :1]) * np.ones((1, out))).astype(np.float32)

    def loss_jax(p):
        o = jax_fused_kan_apply(p, jcfg, jnp.asarray(x), block_rows=128,
                                interpret=True)
        return jnp.mean((o - jnp.asarray(t)) ** 2)

    lj, gj = jax.value_and_grad(loss_jax)(jp)
    leaves = [v.detach().clone().requires_grad_(True)
              for v in tree_leaves(tp)]
    params = tree_unflatten(tp, leaves)
    lt = torch.mean((kf.fused_kan_apply(params, tcfg, torch.from_numpy(x))
                     - torch.from_numpy(t)) ** 2)
    gt = torch.autograd.grad(lt, leaves)
    return lj, gj, lt, gt


@pytest.mark.parametrize("cfg_kw", [
    dict(layers_hidden=(1, 32, 1)),
    dict(layers_hidden=(1, 16, 16, 1)),
    dict(layers_hidden=(2, 32, 3), grid_size=6, spline_order=2),
], ids=["1x32x1", "1x16x16x1", "2x32x3-g6o2"])
def test_fused_gradients_match_jax(cfg_kw):
    """H's plain version through the port's autograd Function against
    jax.grad of the JAX fused apply (its Pallas backward): every leaf,
    including spline_w and spline_scaler through the flatten, and the
    grid's zero gradient.  The (2, 32, 3) grid 6 / order 2 case takes the
    derivative recursion at k = 2."""
    lj, gj, lt, gt = _grads_pair(cfg_kw)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    paths = jax.tree_util.tree_leaves_with_path(gj)
    assert len(paths) == len(gt)
    for (path, a), b in zip(paths, gt):
        np.testing.assert_allclose(
            b.numpy(), np.asarray(a), atol=GRAD_ATOL, rtol=GRAD_RTOL,
            err_msg=f"grad mismatch at {jax.tree_util.keystr(path)}")
        if "grid" in jax.tree_util.keystr(path):
            assert not b.any()


def test_fused_model_trains_through_the_port_loop():
    """build_model('kan', fused=True) through make_train_step: G and H's
    plain versions carry a fit of a low sine."""
    from inraudio_tpu_torch.train import loop as tloop
    model = build_model("kan", KANConfig(layers_hidden=(1, 16, 16, 1)),
                        fused=True)
    x = np.linspace(-1, 1, 256, dtype=np.float32).reshape(-1, 1)
    y = np.sin(2 * np.pi * 2 * x).astype(np.float32)
    res = tloop.fit(model, x, y, tloop.TrainConfig(
        total_steps=80, scan_chunk=40, learning_rate=1e-2), device="cpu")
    assert res.loss_history[-1] < 0.5 * res.loss_history[0]


# (din, dout, J, rows): the runner KAN's and the RFF recipe's layers over
# the clip, and the layers of the card tests' KANs
PLAN_SHAPES = [(1, 256, 9, 308_207), (256, 256, 9, 308_207),
               (256, 1, 9, 308_207), (512, 128, 9, 308_207),
               (128, 128, 9, 308_207), (2, 32, 9, 300), (32, 3, 9, 300),
               (16, 1, 11, 7), (1, 16, 16, 1), (16, 16, 9, 3001),
               (32, 32, 9, 3001), (2, 16, 9, 3001), (16, 3, 11, 3001),
               (32, 3, 10, 3001), (1, 32, 9, 3001), (32, 1, 9, 3001),
               (64, 320, 9, 3001), (1, 320, 9, 3001), (320, 320, 9, 3001),
               (320, 1, 9, 3001)]


@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=["x".join(map(str, s)) for s in PLAN_SHAPES])
def test_forward_plan_fits_the_kernels(shape):
    """G's plan for one layer in every tier: the route by (dout, tier), the
    shared memory within a CTA's, and every input feature, output column
    and row covered by the chunks, column tiles and row tiles launched."""
    din, dout, J, n = shape
    for mode in ("bf16x3", "bf16x2", "bf16", "highest"):
        plan = kf.fwd_plan(din, dout, J, mode)
        assert plan.route == kf.layer_route(dout, mode)
        if mode == "highest":
            assert plan.route == "fma"
        else:
            assert plan.route == ("tc" if dout >= 8 else "narrow")
        assert 1 <= plan.fc <= din
        if plan.route == "tc":
            assert plan.tile in (64, 128, 256) and plan.tm == 64
            assert plan.tile >= min(dout, 256)
            # at most two (row, feature) pairs of a chunk a thread
            assert plan.tm * plan.fc <= 2 * 256
            assert kf.fwd_tc_smem(plan.tile, plan.fc, J) <= kf._SMEM_MAX
            col_tiles = -(-dout // plan.tile)
            # the chunks' K, each padded to whole k16 steps
            chunks = [min(plan.fc, din - f0) for f0 in range(0, din,
                                                             plan.fc)]
            assert sum(chunks) == din
            assert kf._fc_steps(din, plan.fc, J) == sum(
                -(-c * J // 16) for c in chunks)
        elif plan.route == "narrow":
            assert plan.tile in (1, 2, 4, 8) and dout <= plan.tile
            assert plan.tm == 256 and plan.fc == min(din, 32)
            assert kf.fwd_narrow_smem(plan.tile, J) <= kf._SMEM_MAX
            col_tiles = 1
        else:
            assert plan.tile in (1, 2, 4, 8, 16, 32)
            assert plan.tm == 1024 // plan.tile
            tn = 8 * plan.tile
            assert tn >= min(dout, 256)
            kcp = kf._round4(plan.fc * J)
            assert 4 * (2 * plan.tm * kf._ld(kcp) + 2 * kcp * tn
                        + plan.fc * kf._KNOT_STRIDE) <= kf._SMEM_MAX
            col_tiles = -(-dout // tn)
        # every output column: the column tiles, each of plan.tile columns
        # (fma: 8 a group) or every output held (narrow)
        width = {"tc": plan.tile, "narrow": plan.tile,
                 "fma": 8 * plan.tile}[plan.route]
        assert col_tiles * width >= dout > (col_tiles - 1) * width
        row_tiles = -(-n // plan.tm)
        assert row_tiles * plan.tm >= n > (row_tiles - 1) * plan.tm


def test_plans_fit_the_kernels(monkeypatch):
    """The launch plans stay within a CTA's shared memory and cover every
    feature, output column and row, at the runner shape and the narrow
    test shapes, for H's tensor-core, narrow and FMA routes; the dW slice
    count depends on the shapes alone (never on the scratch budget)."""
    shapes = PLAN_SHAPES
    routes = set()
    for din, dout, J, n in shapes:
        for mode in ("bf16x3", "bf16x2", "bf16", "highest"):
            plan = kf.dw_plan(n, din, dout, J, mode)
            routes.add(plan.route)
            assert plan.route == kf.layer_route(dout, mode)
            if plan.route == "tc":
                assert plan.tile in (32, 64, 128, 256) and plan.rc == 32
                assert plan.tile >= min(dout, 256) and plan.fck * J <= 64
                assert plan.rows_per_slice % 32 == 0
                fused = kf.dx_fused(dout, mode)
                assert fused == (dout <= 256)
                # the fused pass (builder warps) with dx, dW alone without
                assert (kf.bwd_ws_smem(plan.tile, plan.fck) if fused else
                        kf.bwd_tc_smem(plan.tile, plan.fck)) <= kf._SMEM_MAX
            elif plan.route == "narrow":
                assert plan.tile in (1, 2, 4, 8) and dout <= plan.tile
                # as many features a CTA as its bins, knot rows and W's
                # planes hold, up to 32
                assert plan.rc == 8 and 1 <= plan.fck <= min(32, din)
                assert kf.narrow_bins_smem(plan.tile, J,
                                           plan.fck) <= kf._SMEM_MAX
                assert plan.fck == min(32, din) or kf.narrow_bins_smem(
                    plan.tile, J, plan.fck + 1) > kf._SMEM_MAX
            else:
                assert plan.fck * J <= 1024 // plan.tile
                assert plan.rc % 4 == 0
            assert plan.slices * plan.rows_per_slice >= n
            assert (plan.slices - 1) * plan.rows_per_slice < n
            assert 1 <= kf.dw_group(plan, dout, din * J) <= plan.slices
            if kf.dx_fused(dout, mode):
                routes.add("dx in the " + plan.route + " pass")
            else:
                xp = kf.dx_plan(din, dout, J, mode)
                routes.add("dx-" + xp.route)
                # the bf16 tiers' dx of dout > 256 on the tensor cores, the
                # highest tier's on the FMA kernel
                assert (xp.route == "tc") == (mode != "highest")
                if xp.route == "tc":
                    assert xp.tm in (64, 32) and xp.fc * J <= xp.inner <= 128
                    assert xp.inner % (8 * (8 // (xp.tm // 16))) == 0
                    assert kf.dx_tc_smem(xp.tm, dout, xp.inner,
                                         xp.fc) <= kf._SMEM_MAX
                else:
                    assert xp.fc * J <= 256 and xp.inner % 4 == 0
                    assert xp.inner >= 4
    assert routes == {"tc", "narrow", "fma", "dx in the tc pass",
                      "dx in the narrow pass", "dx-tc", "dx-fma"}
    # the runner shape: layer 1 on tensor cores with all 256 columns in one
    # tile (bases once per row), the head narrow, in G as in H, and both dx
    # in their dW pass
    assert kf.fwd_plan(256, 256, 9) == kf.FwdPlan("tc", 256, 8, 64)
    assert kf.fwd_plan(1, 256, 9).tile == 256
    assert kf.fwd_plan(256, 1, 9) == kf.FwdPlan("narrow", 1, 32, 256)
    assert kf.fwd_plan(256, 256, 9, "highest").route == "fma"
    # the wide build's G at the runner's grid 5 / order 3 (knot rows of 12
    # floats there) takes the default build's plan: the same tile, chunk
    # and padding, so the two builds sum every output alike
    for din, dout in ((256, 256), (1, 256), (256, 1)):
        assert kf.fwd_plan(din, dout, 9, "bf16x3", 12, wide=True) == \
            kf.fwd_plan(din, dout, 9, "bf16x3", 12)
    assert kf.dw_plan(308_207, 256, 256, 9).tile == 256
    assert kf.dw_plan(308_207, 256, 1, 9).route == "narrow"
    assert kf.dx_fused(256, "bf16x3") and kf.dx_fused(1, "bf16x3")
    assert not kf.dx_fused(512, "bf16x3") and not kf.dx_fused(256,
                                                             "highest")
    # the slice count is the shapes', whatever the scratch budget
    before = [kf.dw_plan(n, din, dout, J) for din, dout, J, n in shapes]
    monkeypatch.setattr(kf, "SCRATCH_BYTES", 4096)
    assert [kf.dw_plan(n, din, dout, J)
            for din, dout, J, n in shapes] == before
    # grid extension's configs take the wide library: grid 20 / order 3
    # (27 knots) and grid 5 / order 5 (16 knots); past orders 1..8 or 128
    # knots a feature the kernels refuse
    kf.check_kernel_config(3, 27)
    kf.check_kernel_config(5, 16)
    with pytest.raises(ValueError, match="spline_order"):
        kf.check_kernel_config(9, 28)
    with pytest.raises(ValueError, match="spline_order"):
        kf.check_kernel_config(3, 129)
