"""The optimizer epilogue's time on one card, for one tree of the
repository, so that two trees can be compared in one call:

    python3 inraudio_tpu_torch/ops/adam_ab.py PARENT
    python3 inraudio_tpu_torch/ops/adam_ab.py .
    python3 inraudio_tpu_torch/ops/adam_ab.py .
    python3 inraudio_tpu_torch/ops/adam_ab.py PARENT

It imports ``inraudio_tpu_torch`` from the tree at ROOT (a parent commit
unpacked beside the checkout with ``git archive``, or the checkout) and the
timing helpers from this checkout's ``chip_smoke.py``, and prints one
``adam_ab {...}`` JSON line, CUDA events throughout:

- ``d_step_ms``: kernel D's whole step (``SIREN_STEP``) at the headline
  shape (669 windows of 512 rows, h = 128, clip 1.0; chip_smoke.py's
  synthetic clip and initial state), mean of 10 after a warm-up;
- ``d_epilogue_ms``: D's epilogue alone on one reduce's output at that
  shape (the tree's ``launch_adam``, or, in a tree without it, the older
  ``siren_adam`` entry), mean of 20;
- ``d_epilogue_runner_ms``: D's epilogue on one runner-sized window (k =
  1, P = 264,452, 264 loss slices, random grads), device time hot
  (``chip_smoke.device_ms``);
- ``f_ms``: F's device time on one runner-sized model (P = 264,452, the
  loss below best_loss, so best is written) from F_ITERS raw entry
  launches queued behind a sleep (``chip_smoke.device_ms``), hot and with
  the L2 flushed between launches, at clip 0 and 1.0; ``f_host_ms``:
  ``SIREN_ADAM``'s host time a call; ``floor_ms``: an empty kernel
  (``torch.cuda._sleep(0)``, one thread) timed the same two ways, the part
  of those times that any launch pays.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))


def main(root: str) -> int:
    sys.path.insert(0, os.path.abspath(root))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "..", "..", "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np
    import torch

    from inraudio_tpu_torch.ops import siren_step as ss
    from inraudio_tpu_torch.ops import siren_train as st
    from inraudio_tpu_torch.ops.siren_fused import stack_plan
    from inraudio_tpu_torch.train.loop import init_train_state

    dev = torch.device("cuda")
    lib = st.TRAIN_LIBRARY()
    stream = torch.cuda.current_stream().cuda_stream
    out = {"root": root}
    cfg, model, tc, coords, targets = cs.train_population(
        np, torch, dev, cs.synth_clip(np), "headline", cs.SHAPES["headline"])
    k, n = targets.shape
    state = ss.flat_state_from_train_state(init_train_state(
        model, torch.Generator().manual_seed(cs.SEED), tc, dev, windows=k),
        cfg)
    step = ss.make_fused_mse_train_step(cfg, tc, n, approx_sin=True)
    out["d_step_ms"] = cs.cuda_ms(torch, lambda: step(state, coords,
                                                      targets), 10)
    plan = stack_plan(cfg, approx_sin=True)
    g = st.validate_grad_launch(state.params, cfg, plan, coords)
    grads, sq_part, loss_part = st.grad_reduce(
        lib, g, coords, state.params, stream, targets=targets,
        gmode=st.grad_dot_mode())
    tf = (state.step + 1).to(torch.float32)
    c1, c2 = 1.0 - 0.9 ** tf, 1.0 - 0.999 ** tf
    loss, scale = (torch.empty((k,), device=dev) for _ in range(2))

    def epilogue_of(grads, sq_part, loss_part, s, loss, scale, c1, c2,
                    clip):
        """D's epilogue of the tree on state s, as a call."""
        k, P = s.params.shape
        if hasattr(ss, "launch_adam"):
            return lambda: ss.launch_adam(
                lib, grads, sq_part, loss_part, s.params, s.mu, s.nu,
                s.best_params, loss, scale, s.lr, c1, c2, s.best_loss, clip,
                stream)

        def call():
            rc = lib.siren_adam(
                grads.data_ptr(), sq_part.data_ptr(), loss_part.data_ptr(),
                s.params.data_ptr(), s.mu.data_ptr(), s.nu.data_ptr(),
                s.best_params.data_ptr(), loss.data_ptr(), s.lr.data_ptr(),
                c1.data_ptr(), c2.data_ptr(), s.best_loss.data_ptr(), k,
                loss_part.shape[0] // k, P, float(clip), stream)
            assert rc == 0, rc
        return call

    out["d_epilogue_ms"] = cs.cuda_ms(torch, epilogue_of(
        grads, sq_part, loss_part, state, loss, scale, c1, c2,
        tc.grad_clip_norm), 20)
    out["d_improved"] = int((loss < state.best_loss).sum())
    del state, grads, sq_part, loss_part
    # one runner-sized window: 264 slices, random grads reduced once
    P, slices = 264_452, 264
    gen = torch.Generator(dev).manual_seed(5)
    vec = lambda v: torch.full((1,), v, device=dev)  # noqa: E731
    p, mu, nu, best = (torch.randn(1, P, device=dev, generator=gen)
                       for _ in range(4))
    one = SimpleNamespace(params=p, mu=mu, nu=nu.abs(), best_params=best,
                          lr=vec(1e-3), best_loss=vec(10.0))
    grads = 1e-3 * torch.randn(1, P, device=dev, generator=gen)
    sq_part = torch.empty(1, -(-P // st.CHUNK_FLOATS), device=dev)
    rc = lib.siren_reduce(grads.data_ptr(), grads.data_ptr(),
                          sq_part.data_ptr(), 0, 0, 1, 1, P, stream)
    assert rc == 0, rc
    loss_part = torch.rand(slices, device=dev, generator=gen) / slices
    loss, scale = (torch.empty((1,), device=dev) for _ in range(2))
    out["d_epilogue_runner_ms"] = cs.device_ms(torch, epilogue_of(
        grads, sq_part, loss_part, one, loss, scale, vec(0.19),
        vec(1.999e-3), 1.0), cs.F_ITERS)[0]
    del one, grads

    P = 264_452
    gen = torch.Generator(dev).manual_seed(3)
    p, mu, nu, best = (torch.randn(1, P, device=dev, generator=gen)
                       for _ in range(4))
    nu = nu.abs()
    buf = torch.zeros(P + 4, device=dev)
    buf[:P] = torch.randn(P, device=dev, generator=gen) * 1e-2
    buf[P] = 0.5
    lr, c1, c2, best_loss = vec(1e-3), vec(0.19), vec(1.999e-3), vec(1.0)
    floss = torch.empty((1,), device=dev)
    fsq = torch.empty((-(-P // st.CHUNK_FLOATS),), device=dev)
    flush_buf = torch.empty(cs.FLUSH_BYTES // 4, device=dev)
    flush = lambda: flush_buf.add_(1.0)  # noqa: E731
    out["f_ms"] = {}
    for clip in (0.0, 1.0):
        if hasattr(ss, "adam_global_args"):
            args = ss.adam_global_args(lib, p, mu, nu, best, buf, lr, c1, c2,
                                       best_loss, floss, fsq, clip, stream)
        else:
            args = (buf.data_ptr(), fsq.data_ptr(), p.data_ptr(),
                    mu.data_ptr(), nu.data_ptr(), best.data_ptr(),
                    floss.data_ptr(), lr.data_ptr(), c1.data_ptr(),
                    c2.data_ptr(), best_loss.data_ptr(), P, clip, stream)

        def raw(args=args):
            if lib.siren_adam_global(*args) != 0:
                raise RuntimeError("siren_adam_global launch failed")

        for label, fl in (("hot", None), ("flushed", flush)):
            out["f_ms"][f"clip{clip}_{label}"] = cs.device_ms(
                torch, raw, cs.F_ITERS, fl)[0]
    out["floor_ms"] = {label: cs.device_ms(
        torch, lambda: torch.cuda._sleep(0), cs.F_ITERS, fl)[0]
        for label, fl in (("hot", None), ("flushed", flush))}
    out["f_host_ms"] = cs.host_ms(torch, lambda: ss.SIREN_ADAM(
        p, mu, nu, best, buf, lr, c1, c2, best_loss, 0.0), cs.F_ITERS)
    print("adam_ab " + json.dumps(out))
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1]))
