"""The precision schedule held against the JAX package on the CPU: the
cheap tier of ``schedule_tiers`` through kernel D's plain version
(``step_plain``) and kernel E's (``grad_plain``) against the JAX
``make_fused_mse_train_step(tier=)`` / ``fused_mse_grad_call`` with the
same tier, both Pallas kernels in interpret mode, raw and RFF; the tier
plumbing of the port's builders; and ``fit``'s escalation rule (the JAX
fit's, loop.py:413-420,441) on one rank, on two thread ranks, and its
absence on the routes that do not go through D or E.

Tolerances.  The cheap tier rounds each hidden layer's input to bf16 in the
forward (bf16x2) and both backward operands in one bf16 pass; the two
packages sum the f32 products in other orders (XLA's dot against
torch.matmul), so a value within an f32 ulp of a bf16 rounding boundary can
round the other way and move its row's activations by 2^-8 of that value.
So the first step's loss agrees to LOSS_RTOL, and its gradients (mu = 0.1 g
after one step, or E's buffer) are held to the bf16 tiers' rule of the
decode tests, the max loosely (GRAD_MAX_RTOL of the largest) and the bulk
tightly (GRAD_BULK_SHARE of the elements within GRAD_BULK_RTOL), and in
the L2 norm (GRAD_L2_RTOL of the reference's).  Measured on the CPU at
h = 64 (omega0 = 300), D (two windows of 300 rows) raw / RFF, E (a
300-row shard) raw / RFF: max 1.5e-3 / 4.1e-4 / 2.2e-4 / 3.7e-4, within
1e-5 71% / 77% / 96% / 88%, L2 9.9e-4 / 5.3e-4 / 4.0e-4 / 4.5e-4.  The
negative control, the port's full tier against the JAX cheap tier, must
exceed the L2 bound: 4.7e-3 / 4.0e-2 / 3.1e-3 / 4.0e-2.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inraudio_tpu.models import SirenSnakeTanhConfig as JaxConfig
from inraudio_tpu.models import build_model as jax_build_model
from inraudio_tpu.ops import pallas_siren as jps
from inraudio_tpu.ops import pallas_siren_step as jstep
from inraudio_tpu.train import loop as jloop
from inraudio_tpu_torch.models import (KANConfig, SirenSnakeTanhConfig,
                                       build_model)
from inraudio_tpu_torch.ops import siren_fused as sf
from inraudio_tpu_torch.ops import siren_step as ss
from inraudio_tpu_torch.ops import siren_train as st
from inraudio_tpu_torch.parallel import Mesh, shard_rows
from inraudio_tpu_torch.train import loop as tloop
from inraudio_tpu_torch.tree import tree_leaves
from test_torch_cuda import run_thread_ranks

torch.set_num_threads(1)

H, K, N = 64, 2, 300
LOSS_RTOL = 1e-5
GRAD_MAX_RTOL, GRAD_BULK_RTOL, GRAD_BULK_SHARE = 5e-3, 1e-5, 0.6
GRAD_L2_RTOL = 2e-3
CHEAP = dict(f32_mode="bf16x2", grad_mode="bf16", sin_degree=7)


def _models(f):
    """(JAX model, port model, B or None) of the fused mlp at h = H, raw
    (f = 0) or with an RFF layer 0 of f frequencies."""
    kw = dict(in_features=2 * f if f else 1, hidden_features=H,
              first_omega_0=300.0, num_sine=1, num_snake=1)
    b = (None if not f else (3.0 * np.random.default_rng(7).standard_normal(
        (f, 1))).astype(np.float32))
    jm = jax_build_model("mlp", JaxConfig(**kw), fused=True, interpret=True,
                         approx_sin=True,
                         rff_b=None if b is None else jnp.asarray(b))
    tm = build_model("mlp", SirenSnakeTanhConfig(**kw), fused=True,
                     approx_sin=True,
                     rff_b=None if b is None else torch.from_numpy(b))
    return jm, tm, b


def _problem(n=N, k=K):
    coords = np.linspace(-1, 1, n, dtype=np.float32)[:, None]
    t = 0.7 * np.sin(2 * np.pi * np.array([3.0, 5.0])[:k, None]
                     * coords[None, :, 0])
    return coords, t[..., None].astype(np.float32)


def _grad_gaps(out: np.ndarray, ref: np.ndarray) -> tuple[float, float,
                                                         float]:
    """(max |out - ref| / max |ref|, share of elements within
    GRAD_BULK_RTOL of max |ref|, |out - ref|_2 / |ref|_2)."""
    err = np.abs(out - ref) / float(np.abs(ref).max())
    return (float(err.max()), float(np.mean(err <= GRAD_BULK_RTOL)),
            float(np.linalg.norm(out - ref) / np.linalg.norm(ref)))


def _assert_cheap_gaps(gaps) -> None:
    """The cheap tier within the tolerances; the full tier (the negative
    control) beyond the L2 bound, so the tier reached the plain
    version."""
    (gmax, share, l2), lrel = gaps["cheap"]
    assert lrel <= LOSS_RTOL, gaps
    assert gmax <= GRAD_MAX_RTOL and share >= GRAD_BULK_SHARE, gaps
    assert l2 <= GRAD_L2_RTOL, gaps
    assert gaps["full"][0][2] > GRAD_L2_RTOL, gaps


def test_schedule_tiers_are_the_jax_package_s():
    assert tloop.schedule_tiers() == jloop.schedule_tiers()
    assert tloop.schedule_tiers()[0] == CHEAP
    c = tloop.TrainConfig()
    assert (c.precision_schedule, c.schedule_db) == (False, 45.0)
    j = jloop.TrainConfig()
    assert (j.precision_schedule, j.schedule_db) == (False, 45.0)


def test_tier_plan_reads_the_tier_and_the_environment(monkeypatch):
    """Each key sets its part of the plan; a missing key keeps the
    environment's tier (degree 11); grad_mode None is the f32 tier, as the
    JAX kernels' ``mode=None``; the degree reaches layer 0 and an RFF
    model's features; unknown keys raise."""
    monkeypatch.setenv("INRAUDIO_F32_PRECISION", "bf16x3")
    monkeypatch.setenv("INRAUDIO_GRAD_PRECISION", "bf16x2")
    cfg = SirenSnakeTanhConfig(hidden_features=32, in_features=8)
    plan, g = ss.tier_plan(cfg, True, True, CHEAP)
    assert g == "bf16"
    assert plan.modes == ("bf16x2",) * len(cfg.layer_kinds)
    assert set(plan.degrees) == {7} and plan.feature_degree == 7
    plan, g = ss.tier_plan(cfg, True, False, None)
    assert g == "bf16x2"
    assert plan.modes[1:] == ("bf16x3",) * (len(cfg.layer_kinds) - 1)
    assert plan.modes[0] is None and set(plan.degrees) == {11}
    assert ss.tier_plan(cfg, True, False, dict(grad_mode=None))[1] == "bf16x3"
    assert ss.tier_plan(cfg, True, False,
                        dict(grad_mode="highest"))[1] == "highest"
    assert set(ss.tier_plan(cfg, False, False, CHEAP)[0].degrees) == {0}
    with pytest.raises(ValueError, match="unknown tier keys"):
        ss.tier_plan(cfg, True, False, dict(sin_deg=7))


@pytest.mark.parametrize("f", [0, 16], ids=["raw", "rff"])
def test_cheap_plain_step_matches_jax_cheap_step_kernel(f):
    """One step of D's plain version on the cheap tier against the JAX
    whole-step kernel with ``tier=schedule_tiers()[0]`` (interpret mode),
    from one 2-window state: the loss, and the gradients through mu; the
    port's full-tier step is the negative control."""
    jax.clear_caches()
    jm, tm, _ = _models(f)
    jtc = jloop.TrainConfig(grad_clip_norm=1.0)
    coords, targets = _problem()
    js = jax.vmap(lambda kk: jloop.init_train_state(jm, kk, jtc))(
        jax.random.split(jax.random.PRNGKey(8), K))
    block = jloop.fused_step_plan(jm, jtc, N)
    vstep, to_flat, from_flat, _, pad = jloop.make_vmapped_fused_step(
        jm, jtc, coords, block, tier=jloop.schedule_tiers()[0])
    fs, (jl, _) = vstep(to_flat(js), jnp.asarray(pad(targets, K)))
    jmu = np.concatenate([np.asarray(x).ravel() for x in
                          jax.tree.leaves(from_flat(fs).opt.mu)])
    gaps = {}
    for name, tier in (("cheap", tloop.schedule_tiers()[0]), ("full", None)):
        state = tloop.train_state_from_jax(jax.tree.map(np.asarray, js))
        tstep, tto, tfrom, prep = tloop.make_vmapped_fused_step(
            tm, tloop.TrainConfig(grad_clip_norm=1.0),
            torch.from_numpy(coords), tier=tier)
        tfs, (tl, _) = tstep(tto(state), prep(targets))
        tmu = np.concatenate([x.numpy().ravel() for x in
                              tree_leaves(tfrom(tfs).opt.mu)])
        gaps[name] = (_grad_gaps(tmu, jmu),
                      float(np.max(np.abs(tl.numpy() - np.asarray(jl))
                                   / np.asarray(jl))))
    _assert_cheap_gaps(gaps)


@pytest.mark.parametrize("f", [0, 8], ids=["raw", "rff"])
def test_cheap_grad_plain_matches_jax_cheap_grad_kernel(f):
    """E's plain version on the cheap tier against ``fused_mse_grad_call``
    with the cheap tier's f32_mode / grad_mode / sin_degree, on the tail
    shard of a 2-shard layout of 600 rows."""
    jax.clear_caches()
    jm, tm, b = _models(f)
    js = jloop.init_train_state(jm, jax.random.PRNGKey(3),
                                jloop.TrainConfig())
    ts = tloop.train_state_from_jax(jax.tree.map(np.asarray, js))
    n = 600
    x = np.linspace(-1, 1, n, dtype=np.float32).reshape(-1, 1)
    y = (0.6 * np.sin(2 * np.pi * 3 * x)).astype(np.float32)
    jcfg, tcfg = jm.fused_step_ctx["cfg"], tm.config
    block = jloop.fused_step_plan(jm, jloop.TrainConfig(), -(-n // 2))
    cp, tp, n_valid = jstep.pad_step_inputs(x, y, block * 2)
    sh = shard_rows(Mesh(None, 1, 2, torch.device("cpu")), n, block)
    sl = slice(sh.start, sh.start + sh.rows)
    gscal = np.zeros((1, 128), np.float32)
    gscal[0, 0] = sh.valid
    jflat = jstep.flat_state_from_train_state(js, jcfg, rff=f > 0).params
    jloss, jgrads = jstep.fused_mse_grad_call(
        list(jflat), jnp.asarray(cp[sl]), jnp.asarray(tp[sl]),
        jnp.asarray(gscal), jcfg, block, n_valid, 1, interpret=True,
        approx_sin=True, bt=None if b is None else jps._prep_rff_bt(
            jnp.asarray(b)), **CHEAP)
    ref = np.concatenate([np.asarray(a, np.float32).ravel() for a in
                          jax.tree.leaves(jstep.unflatten_params(jgrads,
                                                                 jcfg))])
    flat = st.flatten_params(
        {"layers": [{k: v[None] for k, v in p.items()}
                    for p in ts.params["layers"]]}, tcfg)
    bt = None if b is None else sf._prep_rff_bt(torch.from_numpy(b))
    gaps = {}
    for name, tier in (("cheap", CHEAP), ("full", None)):
        plan, gmode = ss.tier_plan(tcfg, True, f > 0, tier)
        buf = ss.fused_mse_grad_call(
            flat, torch.from_numpy(np.ascontiguousarray(cp[sl, :1])),
            torch.from_numpy(np.ascontiguousarray(tp[sl, 0][None])),
            torch.tensor([sh.valid], dtype=torch.int32), n, tcfg, plan,
            gmode, bt)
        P = flat.shape[1]
        out = np.concatenate([g[0].numpy().ravel() for g in tree_leaves(
            st.unflatten_params(buf[:P][None], tcfg))])
        gaps[name] = (_grad_gaps(out, ref),
                      abs(float(buf[P]) - float(jloss)) / float(jloss))
    _assert_cheap_gaps(gaps)


# ---------------------------------------------------------------------------
# fit's schedule
# ---------------------------------------------------------------------------

def _tier_of(plan, gmode) -> str:
    return "cheap" if set(plan.degrees[1:]) == {7} and gmode == "bf16" \
        else "full"


def _recording_model(fused_kw=None, script=None):
    """The fused raw mlp (h = 32) with its step call wrapped: each call
    appends its tier to ``calls``; ``script`` (a list), when given,
    replaces the returned losses call by call."""
    tm = build_model("mlp", SirenSnakeTanhConfig(
        hidden_features=32, first_omega_0=300.0, num_sine=1, num_snake=1,
        **(fused_kw or {})), fused=True, approx_sin=True)
    calls = []
    inner = tm.fused_step_ctx["step"]

    def step(*args, **kw):
        plan, gmode = args[11], args[12]
        calls.append(_tier_of(plan, gmode))
        loss = inner(*args, **kw)
        if script is not None:
            loss = torch.full_like(loss, script[len(calls) - 1])
        return loss

    tm.fused_step_ctx["step"] = step
    return tm, calls


def _jax_rule_rounds(round_losses, targets, db) -> int:
    """The JAX fit's escalation (loop.py:415-420,440-441): the index of the
    first round that runs on the full tier (len(rounds) when none)."""
    power = float(np.mean(np.asarray(targets, np.float32) ** 2))
    thr = power / 10.0 ** (db / 10.0)
    for r, last in enumerate(round_losses):
        if float(last) < thr:
            return r + 1
    return len(round_losses)


def _fit_problem():
    x = np.linspace(-1, 1, 400, dtype=np.float32).reshape(-1, 1)
    return x, (0.6 * np.sin(2 * np.pi * 2 * x)).astype(np.float32)


def test_fit_escalates_by_the_jax_rule():
    """A plain-step fit with the schedule: rounds run cheap until the first
    round whose last loss is under the schedule_db floor, full after it;
    schedule_db is set from an unscheduled fit's losses so that the switch
    falls mid-fit."""
    x, y = _fit_problem()
    chunk, rounds = 5, 6
    tc = tloop.TrainConfig(total_steps=chunk * rounds, scan_chunk=chunk,
                           learning_rate=3e-3)
    ref = tloop.fit(build_model("mlp", SirenSnakeTanhConfig(
        hidden_features=32, first_omega_0=300.0, num_sine=1, num_snake=1),
        fused=True, approx_sin=True), x, y, tc, device="cpu")
    # a floor between the losses at the ends of rounds 2 and 4
    power = float(np.mean(y ** 2))
    hist = ref.loss_history
    mid = np.sqrt(float(hist[2 * chunk - 1]) * float(hist[4 * chunk - 1]))
    db = 10.0 * np.log10(power / mid)
    tm, calls = _recording_model()
    res = tloop.fit(tm, x, y, tloop.TrainConfig(
        total_steps=chunk * rounds, scan_chunk=chunk, learning_rate=3e-3,
        precision_schedule=True, schedule_db=float(db)), device="cpu")
    first_full = _jax_rule_rounds(res.loss_history[chunk - 1::chunk], y, db)
    assert 0 < first_full < rounds
    assert calls == (["cheap"] * chunk * first_full
                     + ["full"] * chunk * (rounds - first_full)), calls
    # unscheduled, every step is full
    tm, calls = _recording_model()
    tloop.fit(tm, x, y, tc, device="cpu")
    assert calls == ["full"] * chunk * rounds


def test_escalation_is_never_undone():
    """Scripted losses: under the floor at the end of round 1, above it
    after; the fit stays on the full tier from round 2 on."""
    x, y = _fit_problem()
    chunk, rounds = 3, 4
    power = float(np.mean(y ** 2))
    thr = power / 10.0 ** (45.0 / 10.0)
    script = [10 * thr] * (chunk * rounds)
    script[2 * chunk - 1] = 0.5 * thr
    tm, calls = _recording_model(script=script)
    tloop.fit(tm, x, y, tloop.TrainConfig(
        total_steps=chunk * rounds, scan_chunk=chunk,
        precision_schedule=True), device="cpu")
    assert calls == ["cheap"] * 2 * chunk + ["full"] * 2 * chunk


@pytest.mark.parametrize("route", ["kan", "mae", "unfused"])
def test_schedule_is_a_no_op_off_the_fused_step(route):
    """A KAN fit, an mae fit of the fused mlp (autograd over B and C) and
    an unfused mlp fit give the same bits with and without the schedule."""
    x, y = _fit_problem()
    if route == "kan":
        model = build_model("kan", KANConfig(layers_hidden=(1, 8, 8, 1)))
    else:
        model = build_model("mlp", SirenSnakeTanhConfig(
            hidden_features=32, first_omega_0=300.0, num_sine=1,
            num_snake=1), fused=route == "mae", approx_sin=route == "mae")
    kw = dict(total_steps=6, scan_chunk=2, schedule_db=300.0,
              loss_mode="mae" if route == "mae" else "mse")
    a, b = (tloop.fit(model, x, y, tloop.TrainConfig(precision_schedule=s,
                                                     **kw), device="cpu")
            for s in (False, True))
    np.testing.assert_array_equal(a.loss_history, b.loss_history)
    for p, q in zip(tree_leaves(a.state), tree_leaves(b.state)):
        assert torch.equal(p, q)


def test_two_rank_fit_escalates_at_one_round(monkeypatch):
    """E + F on two thread ranks (gloo): both ranks read the all-reduced
    loss, so both switch to the full tier at the round the JAX rule gives
    on that loss history; the ranks' states stay bit-equal."""
    x, y = _fit_problem()
    chunk, rounds = 4, 5
    tm = build_model("mlp", SirenSnakeTanhConfig(
        hidden_features=32, first_omega_0=300.0, num_sine=1, num_snake=1),
        fused=True, approx_sin=True)
    ref = tloop.fit(tm, x, y, tloop.TrainConfig(
        total_steps=chunk * rounds, scan_chunk=chunk, learning_rate=3e-3),
        device="cpu")
    hist = ref.loss_history
    mid = np.sqrt(float(hist[chunk - 1]) * float(hist[3 * chunk - 1]))
    db = float(10.0 * np.log10(float(np.mean(y ** 2)) / mid))
    calls: dict[int, list] = {}
    inner = ss.fused_mse_grad_call

    def grad_call(params, coords, targets, limit, n_valid, cfg, plan, gmode,
                  bt=None, weight=None):
        calls.setdefault(threading.get_ident(), []).append(
            _tier_of(plan, gmode))
        return inner(params, coords, targets, limit, n_valid, cfg, plan,
                     gmode, bt, weight)

    monkeypatch.setattr(ss, "fused_mse_grad_call", grad_call)
    tc = tloop.TrainConfig(total_steps=chunk * rounds, scan_chunk=chunk,
                           learning_rate=3e-3, precision_schedule=True,
                           schedule_db=db)
    res = run_thread_ranks(2, lambda m: tloop.fit(tm, x, y, tc, mesh=m),
                           device="cpu", timeout_s=60.0)
    first_full = _jax_rule_rounds(res[0].loss_history[chunk - 1::chunk], y,
                                  db)
    assert 0 < first_full < rounds
    want = (["cheap"] * chunk * first_full
            + ["full"] * chunk * (rounds - first_full))
    assert len(calls) == 2 and all(c == want for c in calls.values()), calls
    np.testing.assert_array_equal(res[0].loss_history, res[1].loss_history)
    for p, q in zip(tree_leaves(res[0].state), tree_leaves(res[1].state)):
        assert torch.equal(p, q)


@pytest.mark.parametrize("f", [0, 16], ids=["raw", "rff"])
def test_tier_switch_keeps_the_carry(f):
    """Plain D: two cheap steps, then a full step on the same carry, equal
    bit for bit to a full step freshly built and run on a copy of that
    carry; the cheap tier differs from the full one."""
    _, tm, b = _models(f)
    coords, targets = _problem()
    tc = tloop.TrainConfig(grad_clip_norm=1.0)
    state = tloop.init_train_state(tm, torch.Generator().manual_seed(0), tc,
                                   "cpu", windows=K)
    c = torch.from_numpy(coords)
    t = torch.from_numpy(targets[..., 0])
    bt = None if b is None else torch.from_numpy(b)
    build = lambda tier: ss.make_fused_mse_train_step(  # noqa: E731
        tm.config, tc, N, approx_sin=True, rff_b=bt, tier=tier)
    cheap, full = build(CHEAP), build(None)
    fs = ss.flat_state_from_train_state(state, tm.config)
    for _ in range(2):
        fs, _ = cheap(fs, c, t)
    clone = lambda s: type(s)(*(x.clone() for x in s))  # noqa: E731
    other, (lc, _) = cheap(clone(fs), c, t)
    fresh, (lf, _) = build(None)(clone(fs), c, t)
    fs, (ls, _) = full(fs, c, t)
    assert torch.equal(ls, lf)
    assert all(torch.equal(p, q) for p, q in zip(fs, fresh))
    assert not torch.equal(lc, ls) and not torch.equal(other.mu, fs.mu)
