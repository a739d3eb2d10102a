"""The Python side of the grad kernels' tensor-core route
(``ops/siren_train.py``: ``tc_route``, ``tc_plan``, ``tc_passes``,
``tc_traffic`` and the launches of ``grad_reduce``), on the CPU.

The kernels themselves run only on a card (tests/test_torch_cuda.py); here a
recording library stands in for csrc/siren_train.cu and the plans are held
at the shapes chip_smoke.py runs: the runner mlp (h = 256 over a 7 s clip,
raw and RFF), the headline encode and the codec default."""

import dataclasses

import pytest
import torch

from inraudio_tpu_torch.models import SirenSnakeTanhConfig, build_model
from inraudio_tpu_torch.ops import siren_fused as sf
from inraudio_tpu_torch.ops import siren_train as st
from inraudio_tpu_torch.utils.observability import counter

CLIP = 308_207  # 7 s at 44.1 kHz


def launch(k, n, h, f=0, gmode="bf16x2"):
    """A GradLaunch of k windows of n rows at width h (2 sine + 2 snake
    layers), raw or with an RFF layer 0 of f frequencies."""
    cfg = SirenSnakeTanhConfig(in_features=2 * f if f else 1,
                               hidden_features=h)
    plan = sf.stack_plan(cfg, approx_sin=True, rff=f > 0)
    bt = torch.zeros(1, f) if f else None
    return st.GradLaunch(k, n, 1, h, -(-n // st.tile_rows(h)),
                         st.flat_layout(cfg), plan, bt)


SHAPES = {  # name: (k, n, h, f), slices, rows a unit's planes hold
    "runner": ((1, CLIP, 256, 0), 264, 37 * 32),
    "runner_rff": ((1, CLIP, 256, 256), 264, 37 * 32),
    "e_shard": ((1, 154_112, 256, 0), 264, 19 * 32),
    "headline": ((669, 512, 128, 0), 2, 4 * 64),
    "codec_default": ((31, 11_025, 128, 0), 44, 4 * 64),
}


def test_tc_route_takes_the_bf16_tiers_only():
    cfg = SirenSnakeTanhConfig(hidden_features=64)
    bf16 = sf.stack_plan(cfg, approx_sin=True, f32_mode="bf16x3")
    exact = sf.stack_plan(cfg, approx_sin=True, f32_mode="highest")
    for gmode in st.TC_MODES:
        assert st.tc_route(bf16, gmode)
        assert not st.tc_route(exact, gmode)
    assert not st.tc_route(bf16, "highest")
    # an RFF layer 0's product counts; a raw layer 0 (exact f32) does not
    rff = SirenSnakeTanhConfig(in_features=8, hidden_features=64)
    plan = sf.stack_plan(rff, approx_sin=True, rff=True, f32_mode="bf16x2")
    assert st.tc_route(plan, "bf16")
    plan = dataclasses.replace(plan, modes=("highest",) + plan.modes[1:])
    assert not st.tc_route(plan, "bf16")


@pytest.mark.parametrize("name", list(SHAPES))
def test_plans_at_the_served_shapes(name):
    (k, n, h, f), slices, rows_cap = SHAPES[name]
    g = launch(k, n, h, f)
    tp = st.tc_plan(g, "bf16x2")
    assert (tp.slices, tp.chunks, tp.rows_cap) == (slices, 1, rows_cap)
    # every slice's tiles fit one chunk, and the planes of a unit hold them
    assert -(-g.tiles // tp.slices) * st.tile_rows(h) <= tp.rows_cap
    planes = st.tc_unit_planes(len(g.plan.kinds), "bf16x2", f > 0)
    assert planes == 4 * 3 + (2 if f else 0)
    assert tp.unit_elems == planes * tp.rows_cap * h
    # the h x h layers' W, each also transposed, and an RFF W0
    assert tp.wq == 8 * h * h + 2 * f * h
    assert tp.group == (2 if h >= 128 else 1) == st.sweep_group(h)
    group, pass_ = tp.scratch_bytes(g.layout.size, len(g.plan.kinds))
    assert group <= st.SCRATCH_BYTES and pass_ <= st.PLANE_BYTES
    assert 1 <= tp.windows <= k and 1 <= tp.units <= tp.windows * tp.slices


def test_runner_passes_fill_the_card_in_two_waves():
    # the raw runner's 264 units fit one pass; the RFF runner's planes take
    # two passes of 132 units (one CTA an SM of the H100's 132)
    for f, passes in ((0, [(0, 264)]), (256, [(0, 132), (132, 132)])):
        tp = st.tc_plan(launch(1, CLIP, 256, f), "bf16x2")
        assert st.tc_passes(tp.slices, tp.units) == passes
    # the headline's 669 windows of 2 slices: one group, one pass
    tp = st.tc_plan(launch(669, 512, 128), "bf16x2")
    assert tp.windows == 669 and tp.units == 669 * 2


def test_tc_passes_cover_every_unit_once_in_order():
    for units, per in ((1, 1), (264, 264), (264, 203), (1338, 500), (7, 3)):
        passes = st.tc_passes(units, per)
        assert all(nu <= per for _, nu in passes)
        assert [u for u0, nu in passes for u in range(u0, u0 + nu)] == \
            list(range(units))
        sizes = [nu for _, nu in passes]
        assert max(sizes) - min(sizes) <= max(sizes) - 1 and \
            sizes[:-1] == [sizes[0]] * (len(sizes) - 1)


@pytest.mark.parametrize("name", ["runner", "runner_rff", "headline",
                                  "codec_default"])
def test_slices_and_chunks_depend_on_the_shapes_only(name, monkeypatch):
    (k, n, h, f), _, _ = SHAPES[name]
    g = launch(k, n, h, f)
    ref = st.tc_plan(g, "bf16x2")
    for scratch, planes in ((1, 1), (1 << 20, 1 << 24), (1 << 40, 1 << 40)):
        monkeypatch.setattr(st, "SCRATCH_BYTES", scratch)
        monkeypatch.setattr(st, "PLANE_BYTES", planes)
        tp = st.tc_plan(g, "bf16x2")
        assert (tp.slices, tp.chunk_tiles, tp.chunks, tp.rows_cap,
                tp.unit_elems) == (ref.slices, ref.chunk_tiles, ref.chunks,
                                   ref.rows_cap, ref.unit_elems)
        assert tp.windows >= 1 and tp.units >= 1


def test_a_long_window_goes_through_row_chunks():
    """Ten clips in one window at h = 256: still MAX_SLICES slices, now of
    365 tiles each, in three chunks of at most CHUNK_TILES tiles, so the
    planes a unit holds stay bounded whatever the length."""
    g = launch(1, 10 * CLIP, 256)
    tp = st.tc_plan(g, "bf16x2")
    assert tp.slices == st.MAX_SLICES
    assert -(-g.tiles // tp.slices) == 365
    assert tp.chunks == 3 and tp.rows_cap == st.CHUNK_TILES * 32
    assert tp.scratch_bytes(g.layout.size, 6)[1] <= st.PLANE_BYTES


@pytest.mark.parametrize("name", ["runner", "headline", "codec_default"])
def test_window_groups_stay_within_the_scratch_budget(name):
    (k, n, h, f), _, _ = SHAPES[name]
    g = launch(k, n, h, f)
    per_window = 4 * g.slices * (g.layout.size + len(g.plan.kinds)
                                 * st.TILE_FLOATS)
    assert st.window_group(g) * per_window <= st.SCRATCH_BYTES
    tp = st.tc_plan(g, "bf16x2")
    assert tp.scratch_bytes(g.layout.size, 6)[0] <= st.SCRATCH_BYTES


@pytest.mark.parametrize("f", [0, 256])
def test_runner_slab_traffic_falls_at_least_four_fold(f):
    t = st.tc_traffic(launch(1, CLIP, 256, f), "bf16x2")
    assert t["fma_slabs"] >= 4 * (t["planes"] + t["slabs"])
    # about 3.8 GB of planes and 0.56 GB (raw) / 0.83 GB (RFF) of slabs,
    # against 20 / 30 GB of per-tile slab traffic
    assert 3.7e9 < t["planes"] < 4.5e9
    assert t["slabs"] < 1e9 and t["fma_slabs"] > 19e9


class _RecordingLibrary:
    """Stands in for csrc/siren_train.cu's tensor-core entry points:
    records each launch and the pointers it was given."""

    def __init__(self):
        self.calls = []

    def siren_wsplit(self, params, whi, wlo, offs, ints, omegas, n_layers, k,
                     h, P, n_freq, stream):
        self.calls.append(("wsplit", k, params))
        return 0

    def siren_sweep(self, coords, params, whi, wlo, partial, loss_part, pre,
                    planes, tgt, cot, offs, ints, omegas, n_layers, n, d, h,
                    h_real, P, gmode, inv_n, two_inv_n, bt, n_freq, fdeg,
                    slices, u0, units, chunk, chunk_tiles, rows_cap,
                    unit_elems, group, limit, wgt, stream):
        self.calls.append(("sweep", chunk, u0, units, params, loss_part, tgt,
                           cot, limit, bt, n_freq, inv_n, slices, gmode,
                           h_real, group))
        return 0

    def siren_dw(self, coords, partial, planes, offs, ints, omegas, n_layers,
                 n, d, h, P, gmode, bt, n_freq, fdeg, slices, u0, units,
                 chunk, chunk_tiles, rows_cap, unit_elems, stream):
        self.calls.append(("dw", chunk, u0, units, slices, bt, n_freq))
        return 0

    def siren_reduce(self, partial, grads, sq_part, loss_part, loss_out, k,
                     slices, P, stream):
        self.calls.append(("reduce", k, slices, grads, loss_part, loss_out))
        return 0


def test_grad_reduce_runs_groups_chunks_and_passes(monkeypatch):
    """A population of 3 windows of 40 row tiles (h = 32), with budgets
    that hold two windows a group and 7 units a pass and chunks of 4 tiles:
    per group the weight split, then per chunk each pass's sweep and dW,
    then the reduce over the group's slices, each launch offset to its
    group's first window."""
    cfg = SirenSnakeTanhConfig(hidden_features=32, first_omega_0=300.0)
    plan = sf.stack_plan(cfg, approx_sin=True)
    k, n = 3, 40 * 256
    flat = st.flatten_params(build_model("mlp", cfg).init(
        torch.Generator().manual_seed(0), windows=k), cfg)
    coords = torch.linspace(-1, 1, n)[:, None]
    targets = torch.zeros(k, n)
    g = st.validate_grad_launch(flat, cfg, plan, coords)
    monkeypatch.setattr(st, "MAX_SLICES", 5)
    monkeypatch.setattr(st, "CHUNK_TILES", 4)
    tp = st.tc_plan(g, "bf16x2")
    assert (tp.slices, tp.chunks, tp.rows_cap) == (5, 2, 4 * 256)
    group, _ = tp.scratch_bytes(g.layout.size, len(plan.kinds))
    monkeypatch.setattr(st, "SCRATCH_BYTES", 2 * group // tp.windows)
    per_unit = 2 * tp.unit_elems + 4 * len(plan.kinds) * st.TILE_FLOATS
    monkeypatch.setattr(st, "PLANE_BYTES", 7 * per_unit)
    tp = st.tc_plan(g, "bf16x2")
    assert (tp.windows, tp.units) == (2, 7)
    lib = _RecordingLibrary()
    sweeps = counter("sweep.launches.g1").value
    grads, sq_part, loss_part = st.grad_reduce(lib, g, coords, flat, 0,
                                               targets=targets,
                                               gmode="bf16x2")
    # each sweep launch counted under its row tiles a CTA (one at h = 32)
    assert counter("sweep.launches.g1").value == sweeps + 6
    assert grads.shape == (k, g.layout.size)
    assert loss_part.shape == (k * 5,)
    P = g.layout.size
    expect = []
    for w0, kn, passes in ((0, 2, [(0, 5), (5, 5)]), (2, 1, [(0, 5)])):
        expect.append(("wsplit", kn, flat.data_ptr() + 4 * w0 * P))
        for chunk in range(2):
            for u0, nu in passes:
                expect += [("sweep", chunk, u0, nu,
                            flat.data_ptr() + 4 * w0 * P,
                            loss_part.data_ptr() + 4 * w0 * 5,
                            targets.data_ptr() + 4 * w0 * n, 0, 0, 0, 0,
                            1.0 / n, 5, 2, 32, 1),
                           ("dw", chunk, u0, nu, 5, 0, 0)]
        expect.append(("reduce", kn, 5, grads.data_ptr() + 4 * w0 * P, 0, 0))
    assert lib.calls == expect


def _small_budgets(monkeypatch, g, windows, units):
    """Slices of 8 tiles in chunks of 4, and budgets that hold ``windows``
    windows a launch group and ``units`` units a pass."""
    monkeypatch.setattr(st, "MAX_SLICES", 5)
    monkeypatch.setattr(st, "CHUNK_TILES", 4)
    tp = st.tc_plan(g, "bf16x2")
    group, _ = tp.scratch_bytes(g.layout.size, len(g.plan.kinds))
    monkeypatch.setattr(st, "SCRATCH_BYTES", windows * group // tp.windows)
    per_unit = 2 * tp.unit_elems + 4 * len(g.plan.kinds) * st.TILE_FLOATS
    monkeypatch.setattr(st, "PLANE_BYTES", units * per_unit)
    tp = st.tc_plan(g, "bf16x2")
    assert (tp.slices, tp.chunks, tp.windows, tp.units) == (5, 2, windows,
                                                           units)


@pytest.mark.parametrize("kernel", ["C_rff", "E"])
def test_grad_reduce_passes_rff_cotangent_and_row_limit(kernel, monkeypatch):
    """The wiring the default route's other callers rely on, at h = 32 over
    40 row tiles a window: C on an RFF model (8 frequencies) hands each
    sweep its group's rows of the cotangent and the sweep and dW kernels
    B's pointer and F; E (one window) hands the sweep its device row limit
    and the whole clip's 1 / n_valid, and the reduce E's views of the
    packed [grads | loss] buffer."""
    f = 8 if kernel == "C_rff" else 0
    k = 3 if kernel == "C_rff" else 1
    n = 40 * 256
    cfg = SirenSnakeTanhConfig(in_features=2 * f if f else 1,
                               hidden_features=32, first_omega_0=300.0)
    plan = sf.stack_plan(cfg, approx_sin=True, rff=f > 0)
    flat = st.flatten_params(build_model("mlp", cfg).init(
        torch.Generator().manual_seed(0), windows=k), cfg)
    coords = torch.linspace(-1, 1, n)[:, None]
    bt = torch.randn(1, f) if f else None
    g = st.validate_grad_launch(flat, cfg, plan, coords, bt)
    P = g.layout.size
    lib = _RecordingLibrary()
    if kernel == "C_rff":
        _small_budgets(monkeypatch, g, 2, 7)
        groups = ((0, 2, [(0, 5), (5, 5)]), (2, 1, [(0, 5)]))
        cot = torch.randn(k, n)
        grads, _, loss_part = st.grad_reduce(lib, g, coords, flat, 0,
                                             cot=cot, gmode="bf16x2")
        tgt, lim, inv_n, loss_out = 0, 0, 1.0 / n, 0
    else:
        _small_budgets(monkeypatch, g, 1, 3)
        groups = ((0, 1, [(0, 3), (3, 2)]),)
        targets = torch.zeros(k, n)
        limit = torch.tensor([5000], dtype=torch.int32)
        buf = torch.zeros(P + 4)
        _, _, loss_part = st.grad_reduce(
            lib, g, coords, flat, 0, targets=targets, gmode="bf16x2",
            limit=limit, n_valid=3 * n, grads=buf[:P].view(1, P),
            loss_out=buf[P:P + 1])
        grads, cot = buf, None
        tgt, lim, inv_n = targets.data_ptr(), limit.data_ptr(), 1.0 / (3 * n)
        loss_out = buf.data_ptr() + 4 * P
    bt_ptr = 0 if bt is None else bt.data_ptr()
    expect = []
    for w0, kn, passes in groups:
        expect.append(("wsplit", kn, flat.data_ptr() + 4 * w0 * P))
        for chunk in range(2):
            for u0, nu in passes:
                expect += [("sweep", chunk, u0, nu,
                            flat.data_ptr() + 4 * w0 * P,
                            loss_part.data_ptr() + 4 * w0 * 5,
                            tgt, 0 if cot is None
                            else cot.data_ptr() + 4 * w0 * n,
                            lim, bt_ptr, f, inv_n, 5, 2, 32, 1),
                           ("dw", chunk, u0, nu, 5, bt_ptr, f)]
        expect.append(("reduce", kn, 5, grads.data_ptr() + 4 * w0 * P,
                       loss_part.data_ptr() if loss_out else 0, loss_out))
    assert lib.calls == expect


def test_extra_defines_build_a_library_of_their_own():
    """A build with extra -D flags goes into a directory of its own; with
    none it is the route's library."""
    from inraudio_tpu_torch.ops import _nvcc
    route = _nvcc.library_path("siren_train", ["siren_train.cu"])
    assert _nvcc.library_path("siren_train", ["siren_train.cu"], ()) == route
    variants = {v: _nvcc.library_path("siren_train", ["siren_train.cu"],
                                      (f"-DVARIANT={v}",)) for v in (0, 1)}
    assert len({route, *variants.values()}) == 3
    assert st.TRAIN_LIBRARY.defines == ()
