"""A/B of the SIREN grad route's sweep numerics on one card: which of its
h x h products run as fp32 FMAs in the reference's k order and which on
``mma.sync`` (``SIREN_SWEEP_SEQ`` in csrc/siren_train.cu: 2, the route,
the forward's every term and the dgrad's hi.hi as FMAs; 1, only the hi.hi
of both; 0, none).

    python3 inraudio_tpu_torch/ops/sweep_ab.py [SEQ ...]   (default 2 1 0)

Builds csrc/siren_train.cu once for each value other than the route's
(one nvcc each, all started together) and, for each, with that build in
place of the route's:

- times the grad accumulation's kernels apart (CUDA events, chip_smoke.py's
  ``tc_split_ms``) at the runner mlp's shapes (h = 256 over the 7 s clip,
  raw and with 256 RFF frequencies) and the headline encode's (669 windows
  of 512 rows, h = 128), in the default bf16x2 grad tier;
- runs the card tests that hold the bf16-tier C, D and E against their
  plain versions (``tests/test_torch_cuda.py``) and lists those that fail;
- runs chip_smoke.py's phases 5-7 (D and C against their plain versions at
  the headline, the served encode and the kernel against plain-step fit
  gates beside their 1-ulp controls, the headline timings) and says whether
  they passed.

For the route (2) it also times the runner's grad accumulation with a
pass's planes held to PLANE_BYTES of 2 GiB, 1 GiB and 512 MiB.  Prints the
phases' own lines and one ``sweep_ab {...}`` JSON line a value.
"""

from __future__ import annotations

import json
import os
import sys
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

CARD_TESTS = ("(backward_kernel_matches_plain or step_kernel_matches_plain "
              "or grad_kernel_matches_plain) and not highest")


def _card_tests(pytest) -> list[str]:
    """The failing node ids of CARD_TESTS against the installed build."""
    failed = []

    class Record:
        def pytest_runtest_logreport(self, report):
            if report.failed:
                failed.append(report.nodeid)

    pytest.main([os.path.join(ROOT, "tests", "test_torch_cuda.py"), "-q",
                 "-p", "no:cacheprovider", "-k", CARD_TESTS],
                plugins=[Record()])
    return failed


def _split(torch, cs, st, g, coords, flat, targets):
    split = cs.tc_split_ms(torch, st, g, coords, flat, 10, targets=targets,
                           gmode="bf16x2")
    return {name: round(ms, 3) for name, ms in split.items()}


def main(argv: list[str]) -> int:
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import pytest
    import torch

    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import chip_smoke as cs
    from inraudio_tpu_torch import codec
    from inraudio_tpu_torch.data import waveform_fitting, write_wav
    from inraudio_tpu_torch.ops import siren_fused as sf
    from inraudio_tpu_torch.ops import siren_step as ss
    from inraudio_tpu_torch.ops import siren_train as st
    from inraudio_tpu_torch.ops._nvcc import build_library
    from inraudio_tpu_torch.train import loop as tloop

    seqs = [int(a) for a in argv] or [2, 1, 0]
    cs.log(f"nvidia-smi: {cs.nvidia_smi()}")
    libs = {seq: st._TrainLibrary(() if seq == 2 else
                                  (f"-DSIREN_SWEEP_SEQ={seq}",))
            for seq in seqs}
    with ThreadPoolExecutor(len(seqs) + 1) as pool:
        builds = [pool.submit(lib) for lib in libs.values()]
        builds.append(pool.submit(build_library, "siren_stack",
                                  ["siren_stack.cu"]))
        for b in builds:
            b.result()
    dev = torch.device("cuda")
    os.makedirs(cs.WORK, exist_ok=True)
    clip = cs.synth_clip(np)
    wav = os.path.join(cs.WORK, "sweep_ab_clip.wav")
    write_wav(wav, cs.FS, clip)
    problem = waveform_fitting(wav, 7.0)
    coords = torch.from_numpy(problem.coords).to(dev)
    targets = torch.from_numpy(problem.targets[:, 0]).to(dev)[None]
    runner = {}
    for name, rb in cs.runner_shapes(torch, dev).items():
        model = cs.runner_model(rb)
        cfg = model.config
        bt = None if rb is None else sf._prep_rff_bt(rb)
        state = tloop.init_train_state(
            model, torch.Generator().manual_seed(cs.SEED), tloop.TrainConfig(),
            dev, windows=1)
        flat = ss.flat_state_from_train_state(state, cfg).params
        plan = sf.stack_plan(cfg, approx_sin=True, rff=rb is not None)
        runner[name] = st.validate_grad_launch(flat, cfg, plan, coords, bt), \
            flat
    hl = cs.SHAPES["headline"]
    hcfg, hmodel, htc, hcoords, htargets = cs.train_population(
        np, torch, dev, clip, "headline", hl)
    hstate = tloop.init_train_state(hmodel,
                                    torch.Generator().manual_seed(cs.SEED),
                                    htc, dev, windows=htargets.shape[0])
    hflat = ss.flat_state_from_train_state(hstate, hcfg).params
    hg = st.validate_grad_launch(hflat, hcfg, sf.stack_plan(
        hcfg, approx_sin=True), hcoords)

    for seq, lib in libs.items():
        st.TRAIN_LIBRARY._lib = lib()
        row = {"seq": seq, "times_ms": {}}
        for name, (g, flat) in runner.items():
            row["times_ms"][name] = _split(torch, cs, st, g, coords, flat,
                                           targets)
        row["times_ms"]["headline"] = _split(torch, cs, st, hg, hcoords,
                                             hflat, htargets)
        if seq == 2:
            plane_bytes = st.PLANE_BYTES
            row["plane_bytes_ms"] = {}
            for budget in (2 << 30, 1 << 30, 1 << 29):
                st.PLANE_BYTES = budget
                for name, (g, flat) in runner.items():
                    tp = st.tc_plan(g, "bf16x2")
                    ms = sum(_split(torch, cs, st, g, coords, flat,
                                    targets).values())
                    row["plane_bytes_ms"][f"{name} {budget >> 20} MiB, "
                                          f"{tp.units} units a pass"] = \
                        round(ms, 3)
            st.PLANE_BYTES = plane_bytes
        row["card_tests_failed"] = _card_tests(pytest)
        try:
            cs.train_phases(np, torch, dev, clip, codec, ss, st, sf)
            row["phases_5_7"] = "passed"
        except AssertionError as e:
            traceback.print_exc()
            row["phases_5_7"] = f"FAILED: {e}"
        torch.cuda.synchronize()
        cs.log("sweep_ab " + json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
