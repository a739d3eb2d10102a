"""The optimizer epilogue's Python side (``ops/siren_step.py``: ``adam_spans``,
``adam_global_grid``, ``launch_adam`` and the ``SIREN_STEP`` /
``SIREN_ADAM`` wrappers), on the CPU, and the multi-window plain version
against the JAX package.

The kernels run only on a card (tests/test_torch_cuda.py); here the launch
plans are held against the kernels' index expressions (csrc/siren_train.cu:
``siren_adam_kernel``, ``siren_adam_global_kernel``), and a recording
library stands in for the built one.  The parity test feeds numpy inputs
from a seed to ``adam_epilogue_plain`` on k = 3 windows and to the JAX
``fused_adam_call`` (interpret mode) window by window.  Tolerance: the
same elementwise arithmetic; XLA may contract a product and a sum into one
fused multiply-add, and the norms sum in another order, so the outputs
agree to ADAM_RTOL of each leaf's largest element (tests/test_torch_shard.py's
bound for F)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inraudio_tpu.models import SirenSnakeTanhConfig as JaxConfig
from inraudio_tpu.models import build_model as jax_build_model
from inraudio_tpu.ops import pallas_siren as jps
from inraudio_tpu.ops import pallas_siren_step as jstep
from inraudio_tpu_torch.models import SirenSnakeTanhConfig, build_model
from inraudio_tpu_torch.ops import siren_fused as sf
from inraudio_tpu_torch.ops import siren_step as ss
from inraudio_tpu_torch.ops import siren_train as st
from inraudio_tpu_torch.tree import tree_leaves
from test_torch_grad_plan import _RecordingLibrary

torch.set_num_threads(1)

ADAM_RTOL = 1e-6
THREADS = 256  # csrc/siren_common.cuh, kThreads
HEADLINE_P, RUNNER_P, RUNNER_RFF_P = 66_692, 264_452, 395_268


def d_float4s(k: int, P: int):
    """Every (window, float4) that D's Adam pass updates, one entry per
    update, from the kernel's index expressions: CTA b is window b // spans,
    span b % spans; thread t of it takes the float4s span * 1024 + t + j *
    256, j < ADAM_VEC, below P / 4."""
    spans = ss.adam_spans(P)
    q = P // 4
    out = []
    for b in range(k * spans):
        win, span = divmod(b, spans)
        for t in range(THREADS):
            for j in range(ss.ADAM_VEC):
                f = span * (ss.ADAM_SPAN_FLOATS // 4) + t + j * THREADS
                if f < q:
                    out.append((win, f))
    return out


@pytest.mark.parametrize("k,P", [(1, 4), (2, 4092), (3, 4096), (2, 4100),
                                 (3, 13_700), (2, HEADLINE_P)])
def test_d_pass_covers_every_float4_once(k, P):
    got = d_float4s(k, P)
    assert len(got) == len(set(got)) == k * P // 4
    assert set(got) == {(w, f) for w in range(k) for f in range(P // 4)}


def test_d_plan_at_the_served_shapes():
    """A span is whole chunks; the headline's 669 windows take 17 spans
    each (16 full, the last 1,156 floats)."""
    assert ss.ADAM_SPAN_FLOATS == 4096
    assert ss.ADAM_SPAN_FLOATS % st.CHUNK_FLOATS == 0
    assert ss.adam_spans(HEADLINE_P) == 17
    assert HEADLINE_P - 16 * ss.ADAM_SPAN_FLOATS == 1156
    assert ss.adam_spans(RUNNER_P) == 65


def f_chunks(P: int, grid: int):
    """{CTA: its chunks} of F: b, b + grid, ... below the chunk count."""
    chunks = -(-P // st.CHUNK_FLOATS)
    return {b: list(range(b, chunks, grid)) for b in range(grid)}


@pytest.mark.parametrize("P,cap", [(4, 1), (1024, 8), (1028, 8),
                                   (RUNNER_P, 1056), (RUNNER_P, 100),
                                   (RUNNER_RFF_P, 264), (RUNNER_RFF_P, 1)])
def test_f_grid_covers_every_chunk_and_float4_once(P, cap):
    grid = ss.adam_global_grid(P, cap)
    chunks = -(-P // st.CHUNK_FLOATS)
    assert grid == min(cap, chunks) and grid >= 1
    owned = f_chunks(P, grid)
    flat = [c for cs in owned.values() for c in cs]
    assert sorted(flat) == list(range(chunks))
    # both halves: thread t of chunk c takes floats c * 1024 + 4t .. + 3
    # (the sum of squares) and the float4 c * 256 + t (the update), so
    # chunk boundaries stay at CHUNK_FLOATS
    floats, float4s = [], []
    for cs in owned.values():
        for c in cs:
            for t in range(THREADS):
                e = c * st.CHUNK_FLOATS + 4 * t
                if e < P:
                    floats += range(e, e + 4)
                f = c * (st.CHUNK_FLOATS // 4) + t
                if f < P // 4:
                    float4s.append(f)
    assert sorted(floats) == list(range(P))
    assert sorted(float4s) == list(range(P // 4))


def test_f_grid_rejects_a_card_without_room():
    with pytest.raises(ValueError, match="positive"):
        ss.adam_global_grid(RUNNER_P, 0)


class _EpilogueLibrary(_RecordingLibrary):
    """The recording library with the epilogue's entries: records each
    call's arguments; F's grid cap is ``cap``."""

    def __init__(self, cap: int):
        super().__init__()
        self.cap = cap

    def siren_adam(self, *args):
        self.calls.append(("adam", args))
        return 0

    def siren_adam_global_cap(self):
        self.calls.append(("cap",))
        return self.cap

    def siren_adam_global(self, *args):
        self.calls.append(("adam_global", args))
        return 0


@pytest.fixture
def recording(monkeypatch):
    lib = _EpilogueLibrary(cap=100)
    monkeypatch.setattr(ss, "TRAIN_LIBRARY", lambda: lib)
    monkeypatch.setattr(ss, "_GRID_CAP", {})
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())

    class Stream:
        cuda_stream = 7

    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: Stream())
    return lib


@pytest.mark.parametrize("track_best", [True, False])
def test_siren_step_hands_the_epilogue_the_reduce_outputs(recording,
                                                          track_best):
    """D: after the grad route's launches, one siren_adam call with the
    reduce's outputs, the state's pointers, the span count of adam_spans,
    the clip and the stream; ``launches`` up by one."""
    cfg = SirenSnakeTanhConfig(hidden_features=32, first_omega_0=300.0)
    plan = sf.stack_plan(cfg, approx_sin=True)
    k, n = 3, 700
    flat = st.flatten_params(build_model("mlp", cfg).init(
        torch.Generator().manual_seed(0), windows=k), cfg)
    P = flat.shape[1]
    mu, nu, best = (torch.zeros(k, P) for _ in range(3))
    lr, c1, c2, best_loss = (torch.full((k,), v) for v in (1e-3, 0.1, 1e-3,
                                                           1.0))
    coords = torch.linspace(-1, 1, n)[:, None]
    before = ss.SIREN_STEP.launches
    loss = ss.SIREN_STEP(flat, mu, nu, best if track_best else None, coords,
                         torch.zeros(k, n), lr, c1, c2, best_loss, cfg, plan,
                         "bf16x2", 1.0)
    assert ss.SIREN_STEP.launches == before + 1
    assert loss.shape == (k,)
    reduce = [c for c in recording.calls if c[0] == "reduce"]
    assert [c[0] for c in recording.calls[-2:]] == ["reduce", "adam"]
    _, _, slices, grads_ptr, _, _ = reduce[-1]
    args = recording.calls[-1][1]
    assert args[0] == grads_ptr
    assert args[3:8] == (flat.data_ptr(), mu.data_ptr(), nu.data_ptr(),
                         best.data_ptr() if track_best else 0,
                         loss.data_ptr())
    assert args[9:13] == (lr.data_ptr(), c1.data_ptr(), c2.data_ptr(),
                          best_loss.data_ptr())
    assert args[13:] == (k, slices, P, ss.adam_spans(P), 1.0, 7)


def test_siren_adam_launches_one_cooperative_entry(recording):
    """F: one siren_adam_global call a SIREN_ADAM call, with the grid of
    adam_global_grid under the card's cap (read once a device), and the
    same chunk scratch on every call of one (device, stream, P)."""
    P = RUNNER_P
    params, mu, nu, best = (torch.zeros(1, P) for _ in range(4))
    buf = torch.zeros(P + 4)
    lr, c1, c2, best_loss = (torch.full((1,), v) for v in (1e-3, 0.1, 1e-3,
                                                           1.0))
    sq_ptrs = []
    for clip in (0.0, 1.0, 1.0):
        before = ss.SIREN_ADAM.launches
        n_calls = len(recording.calls)
        loss = ss.SIREN_ADAM(params, mu, nu, best, buf, lr, c1, c2,
                             best_loss, clip)
        assert ss.SIREN_ADAM.launches == before + 1
        new = [c for c in recording.calls[n_calls:] if c[0] != "cap"]
        assert [c[0] for c in new] == ["adam_global"]
        args = new[0][1]
        assert args[0] == buf.data_ptr()
        assert args[2:7] == (params.data_ptr(), mu.data_ptr(), nu.data_ptr(),
                             best.data_ptr(), loss.data_ptr())
        assert args[7:11] == (lr.data_ptr(), c1.data_ptr(), c2.data_ptr(),
                              best_loss.data_ptr())
        assert args[11:] == (P, 100, clip, 7)
        sq_ptrs.append(args[1])
    assert [c[0] for c in recording.calls].count("cap") == 1
    assert len(set(sq_ptrs)) == 1
    scratch = ss.SIREN_ADAM.scratch(buf.device, 7, P)
    assert scratch.data_ptr() == sq_ptrs[0]
    assert scratch.shape == (-(-P // st.CHUNK_FLOATS),)
    assert ss.SIREN_ADAM.scratch(buf.device, 8, P) is not scratch
    assert ss.SIREN_ADAM.scratch(buf.device, 7, P + 4) is not scratch


def test_siren_adam_raises_when_the_card_cannot_launch_it(recording):
    recording.cap = -720  # cudaErrorCooperativeLaunchTooLarge
    P = 1024
    params, mu, nu = (torch.zeros(1, P) for _ in range(3))
    one = torch.ones(1)
    before = ss.SIREN_ADAM.launches
    with pytest.raises(RuntimeError, match="cooperatively"):
        ss.SIREN_ADAM(params, mu, nu, None, torch.zeros(P + 4), one, one,
                      one, one, 0.0)
    assert ss.SIREN_ADAM.launches == before


# ---------------------------------------------------------------------------
# The multi-window plain version against the JAX kernel, window by window
# ---------------------------------------------------------------------------

MLP = dict(hidden_features=32, first_omega_0=300.0, num_sine=1, num_snake=1)


@pytest.mark.parametrize("clip", [0.0, 1.0])
@pytest.mark.parametrize("track_best", [True, False])
def test_multi_window_plain_matches_jax_adam_kernel(clip, track_best):
    """``adam_epilogue_plain`` on k = 3 windows with their own lr, c1, c2,
    loss and best_loss (windows 0 and 2 improve, 1 does not; at clip 1.0
    window 0's norm is above it and the others below) against the JAX
    ``fused_adam_call`` on each window alone."""
    k = 3
    jcfg, tcfg = JaxConfig(**MLP), SirenSnakeTanhConfig(**MLP)
    shapes = jax.tree.map(np.shape, jax_build_model("mlp", jcfg).init(
        jax.random.PRNGKey(1)))
    rng = np.random.default_rng(7)
    g_scales = (0.3, 1e-3, 3e-3)
    trees = [[jax.tree.map(
        lambda s: (scale * rng.standard_normal(s)).astype(np.float32),
        shapes, is_leaf=lambda x: isinstance(x, tuple))
        for scale in (0.3, 1e-3, 1e-3, 0.3, g_scales[w])]  # p mu nu best g
        for w in range(k)]
    for w in range(k):
        trees[w][2] = jax.tree.map(np.square, trees[w][2])
    lr = np.float32([1e-3, 2e-3, 5e-4])
    c1 = np.float32([0.1, 0.19, 0.271])
    c2 = np.float32([1e-3, 1.999e-3, 2.997e-3])
    loss = np.float32([0.2, 0.7, 0.05])
    best_loss = np.float32([0.25, 0.6, 0.1])

    def to_port(i):
        return st.flatten_params(
            {"layers": [{key: torch.from_numpy(np.stack(
                [trees[w][i]["layers"][li][key] for w in range(k)]))
                for key in layer}
                for li, layer in enumerate(trees[0][i]["layers"])]}, tcfg)

    p, mu, nu, best, g = (to_port(i) for i in range(5))
    best0 = best.clone()
    norms = g.square().sum(1).sqrt()
    assert norms[0] > 1.0 > norms[2] > norms[1]
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    ss.adam_epilogue_plain(p, mu, nu, best if track_best else None, g,
                           t(lr), t(c1), t(c2), t(loss), t(best_loss), clip)
    for w in range(k):
        jflat = [jps._flatten_params(jax.tree.map(jnp.asarray, tr), jcfg)
                 for tr in trees[w]]
        scal = np.zeros((1, 128), np.float32)
        scal[0, :5] = (lr[w], c1[w], c2[w], best_loss[w], loss[w])
        out = jstep.fused_adam_call(
            jflat[0], jflat[1], jflat[2], jflat[4], jnp.asarray(scal), clip,
            flat_best=jflat[3] if track_best else None, interpret=True)
        groups = [p, mu, nu] + ([best] if track_best else [])
        for jg, tg in zip(out, groups):
            for a, b in zip(
                    jax.tree.leaves(jstep.unflatten_params(list(jg), jcfg)),
                    tree_leaves(st.unflatten_params(tg[w:w + 1], tcfg))):
                a = np.asarray(a, np.float32)
                np.testing.assert_allclose(
                    b[0].numpy(), a, rtol=0,
                    atol=ADAM_RTOL * float(np.abs(a).max()))
    if track_best:
        assert torch.equal(best[1], best0[1])
        assert not torch.equal(best[0], best0[0])
    else:
        assert torch.equal(best, best0)
