"""The Python side of the stack kernel's two routes (``ops/siren_fused.py``:
``stack_launch``, ``tc_plane_elems`` and the wrapper's launch), on the CPU.

The kernels run only on a card (tests/test_torch_cuda.py); here a recording
library stands in for csrc/siren_stack.cu.  The plans are held for every
decode tier the codec's gate picks, the mixed and highest tiers, RFF plans,
every width the kernels take (36, 40 and 48 run padded to 64), ragged row
counts, and the window count."""

import contextlib

import pytest
import torch

from inraudio_tpu_torch.models import SirenSnakeTanhConfig, build_model
from inraudio_tpu_torch.ops import siren_fused as sf

torch.set_num_threads(1)

MAX_SMEM = 232448  # bytes of shared memory a block may use on an H100
CLIP = 308_207     # 7 s at 44.1 kHz
# the decode tiers of the codec's gate (chip_smoke.TIER_FITS's names), the
# mixed tier at its f32 default, and the highest tier
TIERS = {"bf16-deg7": sf._DECODE_TIERS[0][2],
         "mixed-bf16x2-deg7": sf._DECODE_TIERS[1][2],
         "deg9": sf._DECODE_TIERS[2][2], "deg11": sf._DECODE_TIERS[3][2],
         "exact": dict(approx_sin=False),
         "mixed-bf16x3": dict(mixed_matmul=True, f32_mode="bf16x3"),
         "highest": dict(approx_sin=True, f32_mode="highest"),
         "mixed-highest": dict(mixed_matmul=True, f32_mode="highest")}
ROUTES = {name: "fma" if "highest" in name else "tc" for name in TIERS}


def plan_of(h=128, rff=False, **kw):
    cfg = SirenSnakeTanhConfig(in_features=16 if rff else 1,
                               hidden_features=h)
    return sf.stack_plan(cfg, rff=rff, **kw)


@pytest.mark.parametrize("rff", [False, True], ids=["raw", "rff"])
@pytest.mark.parametrize("tier", list(TIERS))
def test_route_follows_the_tier(tier, rff):
    plan = plan_of(rff=rff, **TIERS[tier])
    assert sf.stack_launch(plan, 128, 512).route == ROUTES[tier]


def test_an_rff_layer_0_in_highest_keeps_the_fma_route():
    plan = plan_of(rff=True, approx_sin=True)
    assert sf.stack_launch(plan, 64, 100).route == "tc"
    modes = ("highest",) + plan.modes[1:]
    fma = sf.StackPlan(plan.kinds, plan.omegas, modes, plan.degrees,
                       plan.width, plan.feature_degree)
    assert sf.stack_launch(fma, 64, 100).route == "fma"
    # a raw layer 0 is exact f32 on both routes: its mode does not count
    assert plan_of(approx_sin=True).modes[0] is None


@pytest.mark.parametrize("h", [32, 64, 128, 256, 36, 40, 48])
def test_every_width_has_a_plan_within_shared_memory(h):
    width = sf.kernel_width(h)
    assert width == (64 if h in (36, 40, 48) else h)
    for tier in TIERS:
        for n in (1, 300, 512, CLIP):
            s = sf.stack_launch(plan_of(width, **TIERS[tier]), width, n)
            assert s.route == ROUTES[tier]
            assert s.smem <= MAX_SMEM, (h, tier, n, s)
            assert s.slab == (width if width <= 128 else 64)
            if s.route == "tc":
                assert s.rows % sf._TC_PASS_ROWS[width] == 0
                assert s.rows <= sf._TC_MAX_ROWS[width]
            else:
                assert s.rows == 8192 // width


@pytest.mark.parametrize("n", [1, 63, 64, 65, 255, 300, 512, 1000, 11_025,
                               22_050, CLIP])
def test_rows_cover_ragged_n(n):
    for h in sf._KERNEL_WIDTHS:
        s = sf.stack_launch(plan_of(h, approx_sin=True), h, n)
        tiles = -(-n // s.rows)
        assert tiles * s.rows >= n > (tiles - 1) * s.rows
        # no pass of a CTA lies wholly past n
        assert s.rows - n < sf._TC_PASS_ROWS[h]


def test_headline_and_runner_tiles():
    # the headline decode: 669 windows x 2 CTAs of 256 rows (1,338 CTAs);
    # the runner mlp at h = 256: 4,816 CTAs of 64 rows
    head = sf.stack_launch(plan_of(128, approx_sin=True), 128, 512)
    assert (head.route, head.rows, 512 // head.rows * 669) == ("tc", 256,
                                                               1338)
    runner = sf.stack_launch(plan_of(256, approx_sin=True), 256, CLIP)
    assert (runner.rows, -(-CLIP // runner.rows)) == (64, 4816)


class RecordingLibrary:
    """Stands in for the built siren_stack library: records each entry's
    call and returns 0 (launch accepted)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("siren_stack_forward"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def recording(monkeypatch):
    lib = RecordingLibrary()
    monkeypatch.setattr(sf.SIREN_STACK, "_lib", lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: Stream())
    return lib


def _population(h, k):
    cfg = SirenSnakeTanhConfig(hidden_features=h)
    return cfg, build_model("mlp", cfg).init(torch.Generator().manual_seed(0),
                                             "cpu", windows=k)


@pytest.mark.parametrize("h", [32, 48, 128, 256])
def test_the_plan_is_independent_of_k(recording, h):
    coords = torch.linspace(-1, 1, 700)[:, None]
    rows = []
    for k in (1, 4):
        cfg, params = _population(h, k)
        plan = sf.stack_plan(cfg, approx_sin=True)
        before = sf.SIREN_STACK.launches
        sf.SIREN_STACK(params, plan, coords)
        assert sf.SIREN_STACK.launches == before + 1
        name, args = recording.calls[-1]
        assert name == "siren_stack_forward_tc"
        # ..., planes, plane_elems, rows, stream
        width = sf.kernel_width(h)
        assert args[-3] == sf.tc_plane_elems(plan, width, k, 0) == (
            k * 2 * width * 4 * width)
        rows.append(args[-2])
    assert rows[0] == rows[1] == sf.stack_launch(plan, width, 700).rows


def test_the_wrapper_takes_each_route(recording):
    cfg, params = _population(64, 2)
    coords = torch.linspace(-1, 1, 100)[:, None]
    for kw, entry in ((dict(approx_sin=True), "siren_stack_forward_tc"),
                      (dict(compute_dtype="bfloat16"),
                       "siren_stack_forward_tc"),
                      (dict(approx_sin=True, f32_mode="highest"),
                       "siren_stack_forward")):
        sf.SIREN_STACK(params, sf.stack_plan(cfg, **kw), coords)
        assert recording.calls[-1][0] == entry
    # an RFF model's planes hold W0's 2F rows too
    f = 37
    rff = SirenSnakeTanhConfig(in_features=2 * f, hidden_features=64)
    p = build_model("mlp", rff).init(torch.Generator().manual_seed(0), "cpu",
                                     windows=1)
    bt = torch.rand(1, f)
    plan = sf.stack_plan(rff, approx_sin=True, rff=True)
    sf.SIREN_STACK(p, plan, coords, bt)
    name, args = recording.calls[-1]
    assert name == "siren_stack_forward_tc"
    assert args[-3] == 2 * 64 * (2 * f + 4 * 64)
