"""The KAN at the grid sizes and spline orders of the wide library of
``csrc/kan.cu`` (grid extension to 20 and 100 knots' worth of intervals,
orders 1 and 5..8), held against the JAX package on the CPU: the plain
versions of kernels G and H through the port's autograd Function against
the JAX package's ``kan_apply`` and ``jax.grad`` of it (the plain reference
the Pallas kernels are tested against; interpret-mode Pallas at these
widths is the slow tier), including a grid refreshed by ``update_grid``;
and the launch plans of both libraries, on a library that records every
launch instead of running it.

Tolerances: tests/test_torch_kan.py's (ATOL / RTOL on outputs, GRAD_ATOL /
GRAD_RTOL on gradients), with the products in the highest tier so that
both packages compute true f32 products (the bf16 tiers are the card
tests' business)."""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inraudio_tpu.models import KANConfig as JaxKANConfig
from inraudio_tpu.models import kan as jkan
from inraudio_tpu_torch.models import (KANConfig, build_model,
                                       params_from_jax, params_to_numpy)
from inraudio_tpu_torch.models import kan as tkan
from inraudio_tpu_torch.ops import kan_fused as kf
from inraudio_tpu_torch.tree import tree_leaves, tree_unflatten

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4

# (grid_size, spline_order): grid extension's sizes, orders 1 and 5..8, and
# the bound's corner
ORDERS = [(20, 3), (5, 5), (100, 3), (5, 8), (3, 1), (100, 8)]
ORDER_IDS = [f"g{g}o{o}" for g, o in ORDERS]


@pytest.fixture
def highest(monkeypatch):
    monkeypatch.setenv("INRAUDIO_F32_PRECISION", "highest")


def _pair(grid_size, order, layers=(1, 8, 6, 1), seed=5):
    """(JAX config, port config, JAX params, port params): the port draws
    the init (the JAX init's eager least-squares solves take seconds a
    config) and the parameters cross as numpy arrays."""
    kw = dict(layers_hidden=layers, grid_size=grid_size, spline_order=order)
    jcfg, tcfg = JaxKANConfig(**kw), KANConfig(**kw)
    tp = build_model("kan", tcfg).init(torch.Generator().manual_seed(seed))
    jp = jax.tree.map(jnp.asarray, params_to_numpy(tp))
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _xy(n=400, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.05, 1.05, (n, 1)).astype(np.float32)
    return x, np.sin(3.0 * x).astype(np.float32)


def _close(a, b, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(b, np.float64),
                               np.asarray(a, np.float64), atol=atol,
                               rtol=rtol)


def _check_forward_and_grads(jcfg, tcfg, jp, tp, x, t):
    xj, tj = jnp.asarray(x), jnp.asarray(t)

    def jloss(p):
        return jnp.mean((jkan.kan_apply(p, jcfg, xj) - tj) ** 2)

    lj, gj = jax.jit(jax.value_and_grad(jloss))(jp)
    leaves = [v.detach().clone().requires_grad_(True)
              for v in tree_leaves(tp)]
    params = tree_unflatten(tp, leaves)
    out = kf.fused_kan_apply(params, tcfg, torch.from_numpy(x))
    _close(jax.jit(lambda p: jkan.kan_apply(p, jcfg, xj))(jp), out.detach())
    lt = torch.mean((out - torch.from_numpy(t)) ** 2)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    gt = torch.autograd.grad(lt, leaves)
    paths = jax.tree_util.tree_leaves_with_path(gj)
    assert len(paths) == len(gt)
    for (path, a), b in zip(paths, gt):
        key = jax.tree_util.keystr(path)
        if "grid" in key:
            assert not b.any()
            continue
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=key)


@pytest.mark.parametrize("grid_size,order", ORDERS, ids=ORDER_IDS)
def test_plain_kan_matches_jax_at_every_order(highest, grid_size, order):
    """G's and H's plain versions (the kernels' references on the card)
    against ``kan_apply`` and ``jax.grad`` of its MSE, every leaf, at the
    wide library's grid sizes and orders."""
    kf.check_kernel_config(order, grid_size + 2 * order + 1)
    jcfg, tcfg, jp, tp = _pair(grid_size, order)
    x, t = _xy()
    _check_forward_and_grads(jcfg, tcfg, jp, tp, x, t)


def test_plain_kan_after_a_grid_refresh_matches_jax(highest):
    """After ``update_grid`` the knots are the data's, non-uniform (the
    wide kernels search them for the interval), and the applies and
    gradients still agree."""
    jcfg, tcfg, jp, tp = _pair(20, 3)
    x, t = _xy(300, seed=1)
    xr = np.linspace(-0.7, 0.9, 200, dtype=np.float32)[:, None] ** 3
    # the port's refresh (tests/test_torch_kan.py holds it to the JAX one)
    tp = tkan.kan_update_grid(tp, tcfg, torch.from_numpy(xr))
    jp = jax.tree.map(jnp.asarray, params_to_numpy(tp))
    knots = np.asarray(jp["layers"][0]["grid"])[0]
    steps = np.diff(knots)
    assert (steps >= 0).all() and steps.max() > 1.5 * steps.min()
    _check_forward_and_grads(jcfg, tcfg, jp, tp, x, t)


def test_bases_match_jax_at_order_8():
    """The Cox-de-Boor bases themselves at order 8 over 100 intervals,
    the plain recursion of both packages (the wide kernels' reference),
    and the partition of unity on the grid range."""
    _, tcfg, jp, tp = _pair(100, 8, layers=(2, 3))
    x = np.random.default_rng(2).uniform(-1, 1, (500, 2)).astype(np.float32)
    grid = jp["layers"][0]["grid"]
    ref = jax.jit(lambda v: jkan.b_splines(v, grid, 8))(jnp.asarray(x))
    out = tkan.b_splines(torch.from_numpy(x), tp["layers"][0]["grid"], 8)
    assert out.shape == (500, 2, 108)
    _close(ref, out, atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(out.sum(-1).numpy(), 1.0, atol=1e-5)


# ---------------------------------------------------------------------------
# Launch plans
# ---------------------------------------------------------------------------

# (din, dout): the runner KAN's layers, the card tests' and wider ones,
# past the tensor-core dx's bound too
WIDE_SHAPES = [(1, 256), (256, 256), (256, 1), (1, 16), (16, 1), (64, 64),
               (320, 320), (2, 3), (512, 128), (64, 5), (2, 1200)]


@pytest.mark.parametrize("grid_size,order",
                         ORDERS + [(125, 1), (111, 8), (9, 4), (10, 3)],
                         ids=ORDER_IDS + ["g125o1", "g111o8", "g9o4",
                                          "g10o3"])
def test_wide_plans_fit_the_kernels(grid_size, order):
    """Every plan of G and H stays within a CTA's shared memory and within
    what the C launchers check, at every layer shape and tier: the
    default build's tensor-core G's column tile shrinks to fit one
    feature's chunk, the wide build's keeps the least power of two >= dout
    in 64..256 (its W streams in k16 blocks), H's
    tensor-core K tiles cut through a feature past J = 64 (then dx runs on
    the tensor-core dx kernel in the bf16 tiers, as it does past 256
    outputs, and on the FMA kernel in the highest tier or past the
    tensor-core dx's bound), the narrow H's bins fit at every number of
    outputs held in either library, the FMA dW's K tile holds a whole feature.  The
    library follows the config: the default one up to order 4 and 16
    degree-0 bases."""
    nk = grid_size + 2 * order + 1
    J = nk - order
    kf.check_kernel_config(order, nk)
    wide = kf.is_wide(order, nk)
    assert wide == (order > 4 or nk - 1 > 16)
    assert kf.kan_library(order, nk) is (kf.KAN_WIDE_LIBRARY if wide
                                         else kf.KAN_LIBRARY)
    ks = kf.knot_stride(order, nk)
    assert ks == (nk if wide else 20) and ks >= nk
    for din, dout in WIDE_SHAPES:
        for mode in ("bf16x3", "bf16x2", "bf16", "highest"):
            fp = kf.fwd_plan(din, dout, J, mode, ks, wide)
            if fp.route == "tc" and wide:
                assert fp.tile == min(256, max(64, 1 << (dout - 1)
                                               .bit_length()))
                assert 1 <= fp.fc <= min(8, din)
                assert kf._round16(fp.fc * J) <= 512
                assert kf.fwd_ws_smem(fp.tile, fp.fc, J, ks) <= kf._SMEM_MAX
            elif fp.route == "tc":
                assert fp.tile in (64, 128, 256) and 1 <= fp.fc <= 8
                assert kf.fwd_tc_smem(fp.tile, fp.fc, J, ks) <= kf._SMEM_MAX
            elif fp.route == "narrow":
                assert dout <= fp.tile and 1 <= fp.fc <= 32
                assert kf.fwd_narrow_smem(fp.tile, J, fp.fc,
                                          ks) <= kf._SMEM_MAX
            else:
                tm, tn, kcp = 1024 // fp.tile, 8 * fp.tile, kf._round4(
                    fp.fc * J)
                assert 4 * (2 * tm * kf._ld(kcp) + 2 * kcp * tn
                            + fp.fc * ks) <= kf._SMEM_MAX
            dp = kf.dw_plan(50_000, din, dout, J, mode, ks, wide)
            fused = kf.dx_fused(dout, mode, J)
            if dp.route == "tc":
                assert 1 <= dp.ktile <= 64
                touch = (dp.ktile // J if dp.ktile % J == 0
                         else (dp.ktile - 1) // J + 2)
                assert dp.fck >= min(din, touch)
                assert (dp.ktile == dp.fck * J) == (J <= 64)
                assert fused == (dout <= 256 and J <= 64)
                # the fused pass (builder warps) with dx, dW alone without
                assert (kf.bwd_ws_smem(dp.tile, dp.fck, ks) if fused else
                        kf.bwd_tc_smem(dp.tile, dp.fck, ks)) <= kf._SMEM_MAX
            elif dp.route == "narrow":
                assert fused and dp.rc == 8
                # the slices of 32-feature tiles x blocks of 16 values,
                # whatever the features a CTA
                tiles = -(-din // 32) * -(-J // 16)
                aim = max(1, min(-(-1056 // tiles), -(-50_000 // 8)))
                assert dp.rows_per_slice == -(-(-(-50_000 // aim)) // 8) * 8
                # one grid, its CTAs' bins within shared memory in either
                # library: as many features as fit, up to 32
                assert 1 <= dp.fck <= min(32, din)
                assert kf.narrow_bins_smem(dp.tile, J, dp.fck,
                                           ks) <= kf._SMEM_MAX
                assert dp.fck == min(32, din) or kf.narrow_bins_smem(
                    dp.tile, J, dp.fck + 1, ks) > kf._SMEM_MAX
            else:
                assert 1 <= dp.fck and dp.fck * J <= 1024 // dp.tile
            assert dp.slices * dp.rows_per_slice >= 50_000
            if not fused:
                xp = kf.dx_plan(din, dout, J, mode, ks)
                if xp.route == "tc":
                    assert mode != "highest" and xp.tm in (64, 32)
                    assert 1 <= xp.fc and xp.fc * J <= xp.inner <= 128
                    assert xp.inner % (8 * (8 // (xp.tm // 16))) == 0
                    assert kf.dx_tc_smem(xp.tm, dout, xp.inner, xp.fc,
                                         ks) <= kf._SMEM_MAX
                else:
                    # the highest tier, or a dout whose g tile leaves no
                    # room at 32 rows
                    assert mode == "highest" or kf.dx_tc_smem(
                        32, dout, -(-J // 32) * 32, 1, ks) > kf._SMEM_MAX
                    assert 1 <= xp.fc and xp.fc * J <= 256
                    assert xp.inner % 4 == 0
                # the bf16 tiers' dx is on the tensor cores up to dout
                # 672 at every J
                assert (xp.route == "tc") == (mode != "highest") or \
                    dout > 672
    # the narrow H's bins at every number of outputs held
    for dout in (1, 2, 3, 4, 5, 7):
        dp = kf.dw_plan(50_000, 256, dout, J, "bf16x3", ks, wide)
        assert dp.route == "narrow" and dp.tile in (1, 2, 4, 8)
        assert kf.narrow_bins_smem(dp.tile, J, dp.fck, ks) <= kf._SMEM_MAX


def _kan_cu_fwd_ws_smem():
    """kan.cu's fwd_ws_smem as a Python function: its return expression
    (products and sums of its constants and round16) evaluated over the
    constants' values as the source states them."""
    src = (pathlib.Path(kf.__file__).parents[1] / "csrc" / "kan.cu"
           ).read_text()
    env = {"round16": kf._round16}
    for name in ("kFwTM", "kFwsBufs", "kFwsStages", "kFwsSlots",
                 "kFwsBuildWarps"):
        expr = re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
        env[name] = eval(expr, dict(env))
    body = re.search(r"constexpr int fwd_ws_smem\(int tn, int fc, int J, "
                     r"int ks\) \{\s*return (.*?);\s*\}", src, re.S).group(1)
    expr = compile(f"({body})", "kan.cu fwd_ws_smem", "eval")
    return lambda tn, fc, J, ks: eval(expr, dict(env, tn=tn, fc=fc, J=J,
                                                 ks=ks))


def test_wide_forward_plan_keeps_one_column_tile():
    """The wide build's tensor-core G at every grid size up to 100 and
    order up to 8: a 256-column tile at 256 outputs (the least power of
    two >= dout in 64..256 at others), shared memory within 232,448 bytes
    counted by kan.cu's own formula, at most 8 features and 512 K values a
    chunk; where the default build takes the config (order <= 4, at most
    16 degree-0 bases), the default build's chunk, so that both sum each
    output over the same k16 blocks in one order."""
    cu_smem = _kan_cu_fwd_ws_smem()
    for tn, fc, J, ks in ((256, 8, 24, 27), (256, 2, 104, 107),
                          (64, 3, 104, 107), (128, 5, 11, 16),
                          (256, 1, 127, 128)):
        assert cu_smem(tn, fc, J, ks) == kf.fwd_ws_smem(tn, fc, J, ks)
    for grid_size in range(1, 101):
        for order in range(1, 9):
            nk = grid_size + 2 * order + 1
            J = nk - order
            default = order <= 4 and nk - 1 <= 16
            for din, dout in ((1, 256), (256, 256), (64, 8), (24, 320),
                              (3, 64)):
                fp = kf.fwd_plan(din, dout, J, "bf16x3", nk, wide=True)
                assert fp.route == "tc" and fp.tm == 64
                assert fp.tile == (256 if dout >= 256 else 64)
                assert 1 <= fp.fc <= min(8, din)
                assert kf._round16(fp.fc * J) <= 512
                assert cu_smem(fp.tile, fp.fc, J, nk) <= kf._SMEM_MAX
                if default:
                    dp = kf.fwd_plan(din, dout, J, "bf16x3")
                    assert (fp.tile, fp.fc, kf._fc_steps(din, fp.fc, J)) == (
                        dp.tile, dp.fc, kf._fc_steps(din, dp.fc, J))


def test_kernel_config_bound():
    """Orders 1..8 and up to 128 knots a feature; past that the kernels
    raise with the bound in the message."""
    for order, nk in ((3, 27), (5, 16), (3, 107), (8, 22), (8, 117),
                      (1, 128), (4, 16)):
        kf.check_kernel_config(order, nk)
    for order, nk in ((9, 30), (0, 10), (3, 129), (3, 4)):
        with pytest.raises(ValueError, match="spline_order 1..8"):
            kf.check_kernel_config(order, nk)


class _RecordingLibrary:
    """Records each C entry's arguments and returns 0 (success)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("kan_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("mode", ["bf16x3", "highest"])
@pytest.mark.parametrize("grid_size,order,dims", [
    (100, 3, (1, 256, 256, 1)), (20, 3, (1, 256, 256, 1)),
    (5, 8, (1, 64, 3)), (5, 3, (1, 256, 256, 1)), (5, 3, (1, 320, 320, 1)),
    (100, 3, (1, 64, 5))],
    ids=["g100o3", "g20o3", "g5o8", "g5o3", "g5o3-320", "g100o3-no8"])
def test_layer_launches_follow_the_plans(grid_size, order, dims, mode):
    """Each layer's G and H launches on a recording library: the plan's
    tiles, chunks and K tiles reach the C entries, the knot count and
    order pass as given.  In the bf16 tier a layer whose dW pass cannot
    form dx (J > 64, or dout > 256) launches no dx in that pass and runs
    the tensor-core dx after it on the same planes (g's and W's bf16
    planes, ldg wide), never the FMA dx; the narrow H launches one grid a
    slice group, with the plan's features a CTA and no block dimension
    over J.  The highest tier keeps the FMA dW and dx."""
    nk = grid_size + 2 * order + 1
    J = nk - order
    code = {"bf16x3": 3, "highest": 0}[mode]
    lib = _RecordingLibrary()
    n = 3000
    for li, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        x = torch.zeros((n, din))
        grid = torch.zeros((din, nk))
        w_t = torch.zeros((dout, din * J))
        s = kf._layer_shape(x, grid, w_t, order, li)
        assert s.ks == kf.knot_stride(order, nk)
        assert s.wide == kf.is_wide(order, nk)
        lib.calls.clear()
        kf.layer_forward(lib, x, grid, w_t, s, order, mode, 0)
        fp = kf.fwd_plan(din, dout, J, mode, s.ks, s.wide)
        name, args = lib.calls[-1]
        if fp.route == "tc":
            assert name == "kan_forward_tc"
            assert args[6:14] == (n, din, dout, nk, order, code, fp.tile,
                                  fp.fc)
        else:
            assert name == {"narrow": "kan_forward_narrow",
                            "fma": "kan_forward"}[fp.route]
            assert args[5:13] == (n, din, dout, nk, order, code, fp.tile,
                                  fp.fc)
        lib.calls.clear()
        g = torch.zeros((n, dout))
        kf.layer_backward(lib, x, grid, g, w_t, s, order, mode, 0,
                          need_dx=li > 0)
        dp = kf.dw_plan(n, din, dout, J, mode, s.ks, s.wide)
        names = [c[0] for c in lib.calls]
        groups = -(-dp.slices // kf.dw_group(dp, dout, din * J))
        fused = kf.dx_fused(dout, mode, J)
        xp = kf.dx_plan(din, dout, J, mode, s.ks)
        assert names.count("kan_reduce") == groups
        if dp.route == "tc":
            bwd = [a for nm, a in lib.calls if nm == "kan_bwd_tc"]
            assert len(bwd) == groups and all(
                a[9:18] == (n, din, dout, nk, order, code, dp.tile, dp.fck,
                            dp.ktile) for a in bwd)
            assert all((a[8] != 0) == (fused and li > 0) for a in bwd)
            assert fused == (J <= 64 and dout <= 256)
            assert "kan_dx" not in names
            dxtc = [a for nm, a in lib.calls if nm == "kan_dx_tc"]
            if li > 0 and not fused:
                assert xp.route == "tc" and len(dxtc) == 1
                a = dxtc[0]
                ldg = -(-dout // dp.tile) * dp.tile
                assert a[6] == ldg and a[8:17] == (
                    n, din, dout, nk, order, code, xp.tm, xp.fc, xp.inner)
                # W's bf16 planes split once, (K, ldg) like g's
                split = [b for nm, b in lib.calls if nm == "kan_split"]
                assert len(split) == 1 and split[0][7:10] == (ldg, dout,
                                                              din * J)
            else:
                assert not dxtc
        elif dp.route == "narrow":
            assert fused and "kan_dx" not in names
            assert "kan_dx_tc" not in names
            bwd = [a for nm, a in lib.calls if nm == "kan_bwd_narrow"]
            assert len(bwd) == groups and all(
                a[7:15] == (n, din, dout, nk, order, code, dp.tile, dp.fck)
                for a in bwd)
            assert kf.narrow_bins_smem(dp.tile, J, dp.fck,
                                       s.ks) <= kf._SMEM_MAX
        else:
            assert mode == "highest" and "kan_dx_tc" not in names
            assert names.count("kan_dw") == groups
            assert names.count("kan_dx") == (li > 0)
            if li > 0:
                a = next(a for nm, a in lib.calls if nm == "kan_dx")
                assert xp.route == "fma"
                assert a[6:14] == (n, din, dout, nk, order, code, xp.fc,
                                   xp.inner)


# (din, dout, grid_size, order, tier, dx wanted, H's dW kernel): the fused
# pass with builder warps (ws) for a layer whose tensor-core pass forms dx:
# the runner's layer 1 in each bf16 tier, the wide build's J <= 64 configs
# (grid 20 / order 3, grid 5 / order 5, grid 5 / order 8), 8 outputs; the
# one-role pass (tc, dW alone) for J > 64, for a layer with no dx wanted
# (the runner's layer 0) and past 256 outputs; the FMA kernel in the
# highest tier; the narrow head
BWD_PASSES = [(256, 256, 5, 3, "bf16x3", True, "ws"),
              (256, 256, 5, 3, "bf16x2", True, "ws"),
              (256, 256, 5, 3, "bf16", True, "ws"),
              (256, 256, 20, 3, "bf16x3", True, "ws"),
              (256, 256, 5, 5, "bf16x3", True, "ws"),
              (256, 256, 5, 8, "bf16x3", True, "ws"),
              (64, 8, 5, 3, "bf16x3", True, "ws"),
              (256, 256, 100, 3, "bf16x3", True, "tc"),
              (1, 256, 5, 3, "bf16x3", False, "tc"),
              (256, 320, 5, 3, "bf16x3", True, "tc"),
              (256, 256, 5, 3, "highest", True, "fma"),
              (256, 1, 5, 3, "bf16x3", True, "narrow")]


@pytest.mark.parametrize(
    "din,dout,grid_size,order,mode,need_dx,expect", BWD_PASSES,
    ids=[f"{di}x{do}-g{g}o{o}-{m}-{'dx' if x else 'nodx'}"
         for di, do, g, o, m, x, _ in BWD_PASSES])
def test_backward_pass_follows_the_shape(din, dout, grid_size, order, mode,
                                         need_dx, expect):
    """H's dW kernel is picked from the layer's shapes and tier alone
    (``bwd_pass``): on a recording library the fused pass is the one whose
    launches carry dx, and each dW launch counts one on
    ``kan_bwd.launches.<pass>``, no other pass's counter moving."""
    from inraudio_tpu_torch.utils.observability import counter
    nk = grid_size + 2 * order + 1
    J = nk - order
    n = 3000
    x, g = torch.zeros((n, din)), torch.zeros((n, dout))
    grid, w_t = torch.zeros((din, nk)), torch.zeros((dout, din * J))
    s = kf._layer_shape(x, grid, w_t, order, 1)
    plan = kf.dw_plan(n, din, dout, J, mode, s.ks, s.wide)
    fused = need_dx and kf.dx_fused(dout, mode, J)
    assert kf.bwd_pass(plan, fused) == expect
    passes = ("ws", "tc", "narrow", "fma")
    before = {p: counter(f"kan_bwd.launches.{p}").value for p in passes}
    lib = _RecordingLibrary()
    kf.layer_backward(lib, x, grid, g, w_t, s, order, mode, 0,
                      need_dx=need_dx)
    groups = -(-plan.slices // kf.dw_group(plan, dout, din * J))
    moved = {p: counter(f"kan_bwd.launches.{p}").value - before[p]
             for p in passes}
    assert moved == {p: groups if p == expect else 0 for p in passes}
    if plan.route == "tc":
        bwd = [a for nm, a in lib.calls if nm == "kan_bwd_tc"]
        assert len(bwd) == groups
        assert all((a[8] != 0) == (expect == "ws") for a in bwd)


def _kan_cu_bwd_ws_smem():
    """kan.cu's bwd_ws_smem as a Python function: its return expression
    over its constants' values as the source states them."""
    src = (pathlib.Path(kf.__file__).parents[1] / "csrc" / "kan.cu"
           ).read_text()
    env = {}
    for name in ("kTcTK", "kTcRC", "kTcAP", "kTcGxP", "kWsStages",
                 "kWsBufs"):
        expr = re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
        env[name] = eval(expr, dict(env))
    body = re.search(r"constexpr int bwd_ws_smem\(int tn, int fck, int ks\)"
                     r" \{\s*return (.*?);\s*\}", src, re.S).group(1)
    expr = compile(f"({body})", "kan.cu bwd_ws_smem", "eval")
    return lambda tn, fck, ks: eval(expr, dict(env, tn=tn, fck=fck, ks=ks))


def test_fused_pass_shared_memory_fits():
    """The fused pass's shared memory, counted by kan.cu's own formula and
    by its Python mirror alike, stays within a block's 232,448 bytes at
    every shape the plan sends to it: each grid size up to 100 and order up
    to 8 with J <= 64, in either library, at each column tile; and its
    (row, feature) slots within what the kernel holds (32 rows x 32
    features)."""
    cu_smem = _kan_cu_bwd_ws_smem()
    seen = 0
    for grid_size in range(1, 101):
        for order in range(1, 9):
            nk = grid_size + 2 * order + 1
            J = nk - order
            if J > 64 or nk > 128:
                continue
            ks = kf.knot_stride(order, nk)
            wide = kf.is_wide(order, nk)
            for din, dout in ((256, 256), (256, 8), (3, 100), (64, 33)):
                plan = kf.dw_plan(50_000, din, dout, J, "bf16x3", ks, wide)
                if kf.bwd_pass(plan, kf.dx_fused(dout, "bf16x3", J)) != "ws":
                    continue
                seen += 1
                assert plan.ktile == plan.fck * J <= 64
                assert 32 * plan.fck <= 32 * 32
                smem = kf.bwd_ws_smem(plan.tile, plan.fck, ks)
                assert smem == cu_smem(plan.tile, plan.fck, ks)
                assert smem <= kf._SMEM_MAX
    assert seen > 1000
    # the runner's layer 1: 7 features a K tile, 256 columns
    assert kf.bwd_ws_smem(256, 7, 20) == cu_smem(256, 7, 20) == 207_600


def _kan_cu_narrow_smem():
    """kan.cu's narrow_bins_smem as a Python function: its return
    expression and narrow_bin_stride's (C's ``a ? b : c`` read as Python's
    conditional, its int division as //) over the constants' values as the
    source states them."""
    src = (pathlib.Path(kf.__file__).parents[1] / "csrc" / "kan.cu"
           ).read_text()
    env = {"kThreads": 256, "round32": lambda v: (v + 31) // 32 * 32}
    m = re.search(r"constexpr int kNwF = (\d+), kNwRG = ([^;]+);", src)
    env["kNwF"] = int(m.group(1))
    env["kNwRG"] = eval(m.group(2).replace("/", "//"), dict(env))
    cond, yes, no = re.search(
        r"constexpr int narrow_bin_stride\(int fck\) \{\s*return "
        r"(.*?) \? (.*?) : (.*?);\s*\}", src, re.S).groups()
    stride = compile(f"({yes}) if ({cond}) else ({no})", "kan.cu stride",
                     "eval")
    env["narrow_bin_stride"] = lambda fck: eval(stride, dict(env, fck=fck))
    body = re.search(r"constexpr int narrow_bins_smem\(int no, int J, "
                     r"int fck,\s*int ks\) \{\s*return (.*?);\s*\}",
                     src, re.S).group(1)
    expr = compile(f"({body})", "kan.cu narrow_bins_smem", "eval")
    return lambda no, J, fck, ks: eval(expr, dict(env, no=no, J=J, fck=fck,
                                                  ks=ks))


def test_narrow_pass_shared_memory_fits():
    """The narrow H's shared memory, counted by kan.cu's own formula and by
    its Python mirror alike, stays within a block's 232,448 bytes at every
    plan of a narrow layer: each grid size up to 100 and order up to 8, in
    either library, at every number of outputs held; the runner's head
    keeps 32 features a CTA."""
    cu_smem = _kan_cu_narrow_smem()
    seen = 0
    for grid_size in range(1, 101):
        for order in range(1, 9):
            nk = grid_size + 2 * order + 1
            if nk > 128:
                continue
            J, ks = nk - order, kf.knot_stride(order, nk)
            wide = kf.is_wide(order, nk)
            for din, dout in ((256, 1), (256, 2), (256, 3), (256, 7), (3, 5)):
                plan = kf.dw_plan(50_000, din, dout, J, "bf16x3", ks, wide)
                assert plan.route == "narrow"
                seen += 1
                smem = kf.narrow_bins_smem(plan.tile, J, plan.fck, ks)
                assert smem == cu_smem(plan.tile, J, plan.fck, ks)
                assert smem <= kf._SMEM_MAX and 1 <= plan.fck <= min(32, din)
    assert seen > 3000
    assert kf.dw_plan(441_000, 256, 1, 9).fck == 32
    assert kf.narrow_bins_smem(1, 9, 32, 20) == cu_smem(1, 9, 32, 20) == 23_296


@pytest.mark.parametrize("grid_size,order", [(100, 3), (5, 8)],
                         ids=["g100o3", "g5o8"])
def test_plain_layer_dx_matches_jax_grad(highest, grid_size, order):
    """The plain backward of one wide KAN layer, the reference the card
    tests hold kernel H to (the tensor-core dx past J = 64 among them):
    dx and dW^T for a random cotangent g against ``jax.grad`` of
    sum(kan_linear_apply(x) * g) with respect to x and to the layer's
    weights, the points a little past the grid range.  Tolerance: 1e-4 of
    the largest |value| (the card tests' KAN_GRAD_RTOL rule), as each dx
    sums J terms of derivatives that scale with the grid size."""
    din, dout = 6, 12
    jcfg, tcfg, jp, tp = _pair(grid_size, order, layers=(din, dout), seed=7)
    rng = np.random.default_rng(3)
    x = rng.uniform(-1.1, 1.1, (500, din)).astype(np.float32)
    g = rng.standard_normal((500, dout)).astype(np.float32)
    jl = jp["layers"][0]

    def dot(p, xv):
        return jnp.sum(jkan.kan_linear_apply(p, jcfg, xv) * jnp.asarray(g))

    jdx = jax.jit(jax.grad(dot, argnums=1))(jl, jnp.asarray(x))
    jgrads = jax.jit(jax.grad(dot))(jl, jnp.asarray(x))
    grid_t, w_t = kf.flatten_kan_params(tp)
    dw_t, dx = kf.kan_layer_backward_plain(
        torch.from_numpy(x), grid_t, w_t.detach(), torch.from_numpy(g),
        order, kf.kan_dot_mode(), need_dx=True)
    J = grid_t.shape[1] - order
    assert dx.shape == (500, din) and dw_t.shape == (dout, din * J)

    def close(ref, out):
        ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
        assert np.abs(out - ref).max() <= GRAD_RTOL * np.abs(ref).max()

    close(jdx, dx.numpy())
    # dW^T's columns: the base weight, then the scaled spline weights
    dw = dw_t.numpy().reshape(dout, din, J)
    close(jgrads["base_w"], dw[..., 0])
    scaler = np.asarray(jl["spline_scaler"])
    close(jgrads["spline_w"], dw[..., 1:] * scaler[..., None])
