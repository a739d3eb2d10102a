"""The port's ``modulated_fit`` held against the benchmark's plain reference,
``benchmark/reference/modulated_siren.py``, on the CPU at a small size (4
windows of 64 rows, h = 64), from one seeded backbone handed in through
``init_shared``: each step's loss, the best snapshot and the parameters after
3 steps, with and without ``film_scale`` and at ``mods_lr_mult`` 1 and 5.
Also: the reference's gradient in blocks of windows against its unblocked
one, and ``modulated_fit``'s spans and counter under a recording profiler.

Tolerances.  Both sides are float32 with ``torch.sin``; they differ in
Snake's form (the port's double-angle, the reference's sin^2), in the order
of Adam's divisions and in summation order, each a few ulp, which omega0
500 amplifies.  Over 3 backbone seeds and the four cases the losses read
1.1e-7 to 1.2e-6 apart: LOSS_RTOL is 1e-5.  Adam's first steps move a
parameter by about lr whatever its gradient's size, so each leaf's change
(and each window's modulation row) is held by the norm of the difference
over the larger of the reference's norm and the median leaf's (window's),
as ``check.leaf_gaps`` reads it: 1.5e-5 to 1.7e-4 read, CHANGE_RTOL 2e-3.
The reference with TF32 products, the nearest precision below the
configuration's, read 7.3e-4 to 4.0e-3 and 0.27 to 0.44 (layer 0's product
at omega0 500 loses ~0.1 rad of its pre-activation): it must break one of
them, and the tests check that it does."""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.check import leaf_gaps
from benchmark.clip import window_problem
from benchmark.reference import modulated_siren as ref
from benchmark.reference.common import leaves, tree_like
from inraudio_tpu_torch.models.siren import SirenSnakeTanhConfig
from inraudio_tpu_torch.train.loop import TrainConfig
from inraudio_tpu_torch.train.modulated import modulated_fit
from inraudio_tpu_torch.utils import observability as obs

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
CHANGE_RTOL = 2e-3
STEPS = 3
K, N = 4, 64
CPU = torch.device("cpu")
CFG = dict(in_features=1, hidden_features=64, out_features=1, num_sine=2,
           num_snake=2, num_tanh=0, first_linear=False, last_linear=True,
           first_omega_0=500.0, hidden_omega_0=30.0, a_initial=0.5,
           learning_rate=1e-3, min_learning_rate=1e-6, plateau_factor=0.8,
           plateau_patience=200, grad_clip_norm=1.0)
MODEL_KEYS = ("in_features", "hidden_features", "out_features", "num_sine",
              "num_snake", "num_tanh", "first_linear", "last_linear",
              "first_omega_0", "hidden_omega_0", "a_initial")
TRAIN_KEYS = ("learning_rate", "min_learning_rate", "plateau_factor",
              "plateau_patience", "grad_clip_norm")


def _problem(seed=7):
    """4 windows of 64 rows cut from a seeded clip and peak-normalised, as
    the benchmark's cell cuts its 60 s clip (a hop of 58)."""
    rng = np.random.default_rng(seed)
    t = np.arange(K * N) / 2000.0
    clip = (np.sin(2 * np.pi * 31.0 * t) + 0.3 * rng.standard_normal(K * N)
            ).astype(np.float32)
    coords, targets, _ = window_problem(clip, 1000, N / 1000, 0.1)
    return coords, targets[:K]


def _cfg(film, mult):
    return {**CFG, "film_scale": film, "mods_lr_mult": mult}


def _tree0(cfg, seed=3):
    gen = torch.Generator(device=CPU)
    gen.manual_seed(seed)
    return ref.init(cfg, gen, CPU, K)


def _fit(cfg, coords, targets, tree0, track_best):
    model_cfg = SirenSnakeTanhConfig(**{k: cfg[k] for k in MODEL_KEYS})
    tc = TrainConfig(total_steps=STEPS, track_best=track_best,
                     **{k: cfg[k] for k in TRAIN_KEYS})
    init = {"layers": [{k: v.clone() for k, v in layer.items()}
                       for layer in tree0["shared"]["layers"]]}
    return modulated_fit(model_cfg, targets, coords, tc, device="cpu",
                         film_scale=cfg["film_scale"],
                         mods_lr_mult=cfg["mods_lr_mult"], init_shared=init)


def _change_gaps(shared, mods, want_shared, want_mods, tree0):
    """{leaf or window: the norm of (change - wanted change) over the larger
    of its wanted change's norm and the median leaf's or window's} from the
    initial state ``tree0`` (``check.leaf_gaps`` with ``diff``)."""
    old = dict(leaves(tree0["shared"]))
    names = list(shared)
    change = lambda tree: {n: tree[n] - old[n] for n in names}  # noqa: E731
    rows = lambda m: {w: m[w] - tree0["mods"][w] for w in range(K)}  # noqa
    return {**leaf_gaps(change(shared), change(want_shared), names, True),
            **leaf_gaps(rows(mods), rows(want_mods), list(range(K)), True)}


def _within(loss, shared, mods, want, tree0, key=""):
    """Whether (loss, shared, mods) agree with the reference's ``want`` (its
    best snapshot with ``key`` "best_"): the largest loss gap and change
    gap, and the verdict."""
    loss_gap = float(np.max(np.abs(np.asarray(loss, np.float64)
                                   - np.asarray(want["loss"]))
                            / np.asarray(want["loss"])))
    change = max(_change_gaps(shared, mods, want[key + "shared"],
                              want[key + "mods"], tree0).values())
    return loss_gap, change, loss_gap <= LOSS_RTOL and change <= CHANGE_RTOL


@pytest.mark.parametrize("mult", [1.0, 5.0], ids=["mult1", "mult5"])
@pytest.mark.parametrize("film", [False, True], ids=["shift", "film"])
def test_fit_follows_the_reference(film, mult):
    cfg = _cfg(film, mult)
    coords, targets = _problem()
    tree0 = _tree0(cfg)
    c, t = torch.from_numpy(coords), torch.from_numpy(targets)
    want = ref.train(tree0, c, t, cfg, STEPS, 3)
    for track_best, key in ((True, "best_"), (False, "")):
        res = _fit(cfg, coords, targets, tree0, track_best)
        assert res.mods.shape == (K, ref.mod_dim(cfg))
        loss_gap, change, ok = _within(
            res.loss_history, dict(leaves(res.shared)), res.mods, want,
            tree0, key)
        assert ok, (track_best, loss_gap, change)
    # the control: TF32 products in the reference break the tolerances
    control = ref.train(tree0, c, t, cfg, STEPS, 3, tf32=True)
    _, _, ok = _within(control["loss"], control["shared"], control["mods"],
                       want, tree0)
    assert not ok


@pytest.mark.parametrize("film", [False, True], ids=["shift", "film"])
@pytest.mark.parametrize("block", [1, 3, 4])
def test_blocked_gradient_is_the_unblocked_one(block, film):
    """The loss and gradient over blocks of windows against one autograd
    pass over every window: a window's modulation gradient bit for bit, the
    backbone's (summed across blocks) to a few ulp of its norm."""
    cfg = _cfg(film, 5.0)
    coords, targets = _problem()
    tree0 = _tree0(cfg)
    # modulations away from zero, so that every term of the forward counts
    gen = torch.Generator().manual_seed(11)
    mods = 0.1 * torch.randn(tree0["mods"].shape, generator=gen)
    c, t = torch.from_numpy(coords), torch.from_numpy(targets)
    loss, _, grads, mod_grads = ref.loss_and_grads(tree0["shared"], mods,
                                                   cfg, c, t, block)

    named = leaves(tree0["shared"])
    live = {n: v.clone().requires_grad_(True) for n, v in named}
    m = mods.clone().requires_grad_(True)
    whole = torch.sum(torch.square(
        ref.forward(tree_like(tree0["shared"], live), m, cfg, c) - t)) \
        / t.numel()
    got = torch.autograd.grad(whole, list(live.values()) + [m])
    assert math.isclose(loss, float(whole.detach()), rel_tol=1e-6)
    torch.testing.assert_close(mod_grads, got[-1], rtol=0, atol=0)
    for (n, _), g in zip(named, got):
        scale = float(torch.linalg.vector_norm(g))
        assert float(torch.linalg.vector_norm(grads[n] - g)) <= 1e-6 * scale, n


def test_spans_nest_and_the_counter_adds_window_steps():
    cfg = _cfg(False, 5.0)
    coords, targets = _problem()
    tree0 = _tree0(cfg)
    with obs.span("inr.off"):  # no profiler: the next recorded span
        pass                   # empties the store
    before = obs.counters().get("modfit.window_steps", 0)
    model_cfg = SirenSnakeTanhConfig(**{k: cfg[k] for k in MODEL_KEYS})
    tc = TrainConfig(total_steps=4, scan_chunk=2,
                     **{k: cfg[k] for k in TRAIN_KEYS})
    with profile(activities=[ProfilerActivity.CPU]):
        modulated_fit(model_cfg, targets, coords, tc, device="cpu",
                      mods_lr_mult=5.0, init_shared=tree0["shared"])
    assert obs.counters()["modfit.window_steps"] - before == K * 4

    records = obs.spans()
    by_id = {r.id: r for r in records}
    (root,) = [r for r in records if r.parent is None]
    assert root.name == "inr.modfit"
    assert {k: root.attrs[k] for k in ("steps", "windows", "rows")} == {
        "steps": 4, "windows": K, "rows": K * N}
    assert root.attrs["counters"]["modfit.window_steps"] == K * 4
    parent = lambda r: by_id[r.parent].name  # noqa: E731
    kids = sorted((r.name, r.attrs.get("steps")) for r in records
                  if r.parent == root.id)
    assert kids == [("inr.modfit.epilogue", None),
                    ("inr.modfit.prologue", None),
                    ("inr.modfit.round", 2), ("inr.modfit.round", 2)]
    syncs = [r for r in records if r.name == "inr.modfit.sync"]
    assert sorted(parent(r) for r in syncs) == ["inr.modfit.epilogue",
                                                "inr.modfit.prologue"]
    assert len(records) == 7
    for r in records:
        if r.parent is not None:
            up = by_id[r.parent]
            assert up.start_ns <= r.start_ns and r.end_ns <= up.end_ns
